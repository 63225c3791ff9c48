"""The ``fused_step`` kernel's plain version against the JAX oracle
(``repro.kernels.ref.fused_step_ref``) and the Pallas kernel in interpret
mode, the port's ``ipgc._fused_rows`` (which hands the kernel the shard's
ELL tile and rows to gather itself) against ``repro``'s on the gathered
tiles, and the port's partitioning (``graphs/partition.py``) against
``repro``'s. All state is int32/bool, so every comparison is exact;
``first`` is compared where ``has`` is true (the reference's jnp path
gives argmax 0 for an exhausted window, the kernels -1)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ipgc as jipgc
from repro.graphs import get_dataset as jget
from repro.graphs.partition import prepare_partition as jprepare_partition
from repro.graphs.partition import shard_bounds as jshard_bounds
from repro.kernels import ref
from repro.kernels.fused_step import fused_step_pallas
from repro_torch.core import ipgc as tipgc
from repro_torch.graphs import get_dataset as tget
from repro_torch.graphs.partition import (balance_permutation,
                                          prepare_partition, shard_bounds)
from repro_torch.kernels import ops
from repro_torch.kernels.fused_step import (fused_step_plain,
                                            fused_step_rows_plain)

from _gather_cases import gather_case, gathered

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

W = 64
_ref = jax.jit(ref.fused_step_ref, static_argnums=9)


def _case(r, k, *, hub: bool, exhausted: bool = False, seed: int = 0):
    """numpy operands shaped as the distributed fused steps feed
    ``_fused_rows``: colors in [-2, 40) against window bases 0, W, 2W."""
    rng = np.random.default_rng(seed)
    nc = rng.integers(-2, 40, size=(r, k)).astype(np.int32)
    npr = rng.integers(-1, 100, size=(r, k)).astype(np.int32)
    nid = rng.integers(0, r + 1, size=(r, k)).astype(np.int32)
    base = (rng.integers(0, 3, size=r) * W).astype(np.int32)
    cu = rng.integers(-2, 40, size=r).astype(np.int32)
    pu = rng.integers(0, 100, size=r).astype(np.int32)
    ids = np.arange(r, dtype=np.int32)
    pending = (rng.random(r) < 0.85) & (cu >= 0)
    extra = rng.random((r, W)) < 0.2
    if exhausted:
        # every slot of every odd row's window is forbidden
        extra[1::2] = True
    return (nc, npr, nid, base, cu, pu, ids, pending,
            extra if hub or exhausted else None)


def _masked(first, has):
    return np.where(has, first, -1)


@pytest.mark.parametrize("exhausted", [False, True])
@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("r,k", [(1, 1), (33, 8), (100, 24)])
def test_fused_step_plain_matches_ref(r, k, hub, exhausted):
    case = _case(r, k, hub=hub, exhausted=exhausted, seed=r * 13 + k)
    extra = case[8]
    jargs = [jnp.asarray(a) for a in case[:8]] + [
        jnp.asarray(extra if extra is not None else np.zeros((r, W), bool))]
    want_l, want_f = _ref(*jargs, W)
    got_l, got_f = fused_step_plain(
        *[None if a is None else torch.from_numpy(a) for a in case], W)
    assert got_l.dtype == torch.bool and got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    # the oracle and the plain version both give -1 for a full window
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    if exhausted:
        assert (got_f.numpy()[1::2] == -1).all()


@pytest.mark.parametrize("r,k", [(1, 1), (33, 8), (100, 24)])
def test_fused_step_plain_matches_pallas_interpret(r, k):
    case = _case(r, k, hub=True, exhausted=r > 1, seed=r + k)
    got_l, got_f = fused_step_plain(*[torch.from_numpy(a) for a in case], W)
    want_l, want_f = fused_step_pallas(*[jnp.asarray(a) for a in case], W,
                                       interpret=True)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


_STEP = ("colors", "priority", "ell", "rows", "base", "cu", "pu", "ids",
         "pending", "hub_forb", "hub_lose", "hub_slot")


def _step_args(c):
    return [None if c[k] is None else torch.from_numpy(np.asarray(c[k]))
            for k in _STEP]


def test_ops_fused_step_runs_the_plain_version_on_cpu():
    """On CPU tensors ``ops.fused_step`` (the gathering signature) runs
    the plain twin and launches nothing."""
    c = gather_case(50, 50, 8, sparse=True, hub=True, window=W)
    case = _step_args(c)
    before = ops.KERNEL_LAUNCHES["fused_step"]
    got = ops.fused_step(*case, W)
    want = fused_step_rows_plain(*case, W)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert ops.KERNEL_LAUNCHES["fused_step"] == before


def _step_case(hub: bool, exhausted: bool, sparse: bool):
    """Operands of ``_fused_rows`` from ``gather_case``: an exhausted case
    has a one-color window (a neighbour colored at the base fills it) and
    hub rows whose whole window is forbidden; otherwise no window fills."""
    c = gather_case(5 + 2 * hub + sparse, 64, 16, sparse=sparse, hub=hub,
                    window=1 if exhausted else W, lo=5)
    if hub and not exhausted:
        rng = np.random.default_rng(3)
        c["hub_forb"][:-1] = rng.random(c["hub_forb"][:-1].shape) < 0.2
    return c


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("exhausted", [False, True])
@pytest.mark.parametrize("hub", [False, True])
def test_fused_rows_matches_reference(hub, exhausted, sparse):
    """``(lose, has, where(has, first, -1))`` of the port's ``_fused_rows``
    (the kernel gathers the rows of the ELL tile and reads the hub tables
    at their slots) equal ``repro``'s jnp branch on the gathered tiles
    with the hub lose flag ORed in, as the reference's distributed steps
    do; one logical ``fused`` pass per call."""
    c = _step_case(hub, exhausted, sparse)
    w = c["window"]
    g = gathered(c)
    pend = c["pending"] & g["ok"]
    jl, jf, jh = jipgc._fused_rows(
        None, *[None if a is None else jnp.asarray(a) for a in (
            g["nc"], g["npr"], g["nbr"], c["base"], c["cu"], c["pu"],
            c["ids"], pend, g["extra"])], w, "jnp")
    jl = np.asarray(jl)
    if hub:
        jl = jl | (g["hl"] & pend)
    t = {k: None if v is None else torch.from_numpy(np.asarray(v))
         for k, v in c.items() if isinstance(v, np.ndarray) or v is None}
    ig = types.SimpleNamespace(priority=t["priority"], ell_idx=t["ell"],
                               hub_slot=t["hub_slot"])
    tables = (t["hub_forb"], t["hub_lose"]) if hub else None
    with tipgc.LAUNCH_COUNTS.scope() as lc:
        tl, tf, th = tipgc._fused_rows(ig, t["colors"], t["rows"], t["base"],
                                       t["cu"], t["pu"], t["ids"],
                                       t["pending"], tables, w)
        assert lc.as_dict() == {"mex": 0, "conflict": 0, "compact": 0,
                                "fused": 1}
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(_masked(tf.numpy(), th.numpy()),
                                  _masked(np.asarray(jf), np.asarray(jh)))
    assert exhausted == (not th.numpy().all())


# --- partitioning -----------------------------------------------------------

GRAPHS = ["europe_osm_s", "kron_g500-logn21_s", "hollywood-2009_s"]


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("n_shards", [1, 2, 8])
@pytest.mark.parametrize("name", GRAPHS)
def test_prepare_partition_matches_reference(name, n_shards, balance):
    jg = jget(name, scale=0.01, layout="ell-tail")
    tg = tget(name, scale=0.01, layout="ell-tail")
    jg2, jrel = jprepare_partition(jg, n_shards, balance=balance)
    tg2, trel = prepare_partition(tg, n_shards, balance=balance)
    np.testing.assert_array_equal(trel, jrel)
    assert trel.dtype == jrel.dtype
    assert (tg2.name, tg2.n_nodes, tg2.n_edges, tg2.ell_width) == \
        (jg2.name, jg2.n_nodes, jg2.n_edges, jg2.ell_width)
    assert tg2.layout.kind == jg2.layout.kind
    assert tg2.n_nodes % (8 * n_shards) == 0
    for field in ("row_ptr", "col_idx", "degrees", "ell_idx", "tail_src",
                  "tail_dst", "priority"):
        a = np.asarray(getattr(tg2.arrays, field))
        b = np.asarray(getattr(jg2.arrays, field))
        np.testing.assert_array_equal(a, b, err_msg=field)
        assert a.dtype == b.dtype, field


def test_partition_pads_sizes_not_divisible_by_8s():
    """europe at scale 0.01 has 4000 nodes: 4000 % 64 != 0, so eight
    shards of ceil(500 / 8) * 8 = 504 pad it with 32 isolated nodes, as
    ``repro`` does."""
    tg = tget("europe_osm_s", scale=0.01, layout="ell-tail")
    assert tg.n_nodes % 64
    tg2, rel = prepare_partition(tg, 8)
    assert tg2.n_nodes == 4032 and len(rel) == 4032
    assert sorted(rel) == list(range(4032))
    assert (np.asarray(tg2.arrays.degrees)[rel[4000:]] == 0).all()
    np.testing.assert_array_equal(shard_bounds(tg.n_nodes, 8),
                                  jshard_bounds(tg.n_nodes, 8))


def test_balance_permutation_spreads_hubs():
    tg = tget("kron_g500-logn21_s", scale=0.01, layout="ell-tail")
    perm = balance_permutation(tg, 4)
    assert sorted(perm.tolist()) == list(range(tg.n_nodes))
    deg = np.asarray(tg.arrays.degrees)[perm].reshape(4, -1).sum(axis=1)
    assert deg.max() - deg.min() <= np.asarray(tg.arrays.degrees).max()
