"""The gathering signatures of the ``conflict``, ``fused_compact`` and
``fused_step`` kernels: their plain twins (``conflict_rows_plain``,
``fused_compact_rows_plain``, ``fused_step_rows_plain``, which
``kernels.ops`` runs on CPU tensors) against the pre-gathered plain
versions and ``repro``'s oracles on the same numpy inputs; and the ELL
left-packing (no real entry after a padding entry) that lets the kernels
stop each row at its first padding entry. All state is int32/bool, so
every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import dataset_names
from repro.graphs.layout import LAYOUT_KINDS
from repro.kernels import ref
from repro_torch.core import distributed as dist
from repro_torch.core import ipgc
from repro_torch.graphs import get_dataset as tget
from repro_torch.graphs.partition import prepare_partition
from repro_torch.kernels import ops
from repro_torch.kernels.conflict import conflict_plain, conflict_rows_plain
from repro_torch.kernels.fused_compact import (fused_compact_plain,
                                               fused_compact_rows_plain)
from repro_torch.kernels.fused_step import (fused_step_plain,
                                            fused_step_rows_plain)

from _gather_cases import gather_case, gathered

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

_conflict_ref = jax.jit(ref.conflict_ref)
_fused_ref = jax.jit(ref.fused_compact_ref,
                     static_argnames=("window", "capacity", "n_sentinel"))
_step_ref = jax.jit(ref.fused_step_ref, static_argnums=9)
_OUTS = ("new_c", "new_base", "still", "items", "count")


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _conflict_args(c):
    return (_t(c["colors"]), _t(c["priority"]), _t(c["ell"]), _t(c["rows"]),
            _t(c["cu"]), _t(c["pu"]), _t(c["ids"]), _t(c["newly"]))


def _fused_args(c):
    return (_t(c["colors"]), _t(c["priority"]), _t(c["ell"]), _t(c["rows"]),
            _t(c["base"]), _t(c["cu"]), _t(c["pu"]), _t(c["ids"]),
            _t(c["active"]), _t(c["pending"]), _t(c["hub_forb"]),
            _t(c["hub_lose"]), _t(c["hub_slot"]))


SHAPES = [(0, 8), (1, 8), (7, 8), (40, 16), (100, 40), (257, 128)]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rg,k", SHAPES)
def test_conflict_rows_plain_matches_ref(rg, k, sparse):
    c = gather_case(rg * 13 + k + sparse, rg, k, sparse=sparse, hub=False,
                    lo=5)
    g = gathered(c)
    got = conflict_rows_plain(*_conflict_args(c))
    keep = c["newly"] & g["ok"]
    if len(keep):
        want = np.asarray(_conflict_ref(_j(g["nc"]), _j(g["npr"]),
                                        _j(g["nbr"]), _j(c["cu"]),
                                        _j(c["pu"]), _j(c["ids"]))) & keep
    else:
        want = np.zeros(0, bool)
    _eq(got, want)
    pre = conflict_plain(_t(g["nc"]), _t(g["npr"]), _t(g["nbr"]),
                         _t(c["cu"]), _t(c["pu"]), _t(c["ids"]))
    _eq(got, pre & _t(keep))
    # the wrapper runs the plain twin on CPU tensors
    _eq(ops.conflict(*_conflict_args(c)), got)
    assert got.dtype == torch.bool and got.shape == (len(keep),)


def _assert_fused(c, capacity: int):
    g = gathered(c)
    w = c["window"]
    got = fused_compact_rows_plain(*_fused_args(c), w, capacity=capacity,
                                   n_sentinel=c["n"])
    act, pend = c["active"] & g["ok"], c["pending"] & g["ok"]
    pre = fused_compact_plain(
        _t(g["nc"]), _t(g["npr"]), _t(g["nbr"]), _t(c["base"]),
        _t(c["cu"]), _t(c["pu"]), _t(c["ids"]), _t(act), _t(pend),
        _t(g["extra"]), _t(g["hl"]), w, capacity=capacity,
        n_sentinel=c["n"])
    for a, b, name in zip(got, pre, _OUTS):
        _eq(a, b, name)
    if len(act):
        want = _fused_ref(_j(g["nc"]), _j(g["npr"]), _j(g["nbr"]),
                          _j(c["base"]), _j(c["cu"]), _j(c["pu"]),
                          _j(c["ids"]), _j(act), _j(pend), _j(g["extra"]),
                          _j(g["hl"]), window=w, capacity=capacity,
                          n_sentinel=c["n"])
        for a, b, name in zip(got, want, _OUTS):
            _eq(a, b, name)
    via_ops = ops.fused_compact(*_fused_args(c), w, capacity=capacity,
                                n_sentinel=c["n"])
    for a, b, name in zip(via_ops, got, _OUTS):
        _eq(a, b, name)
    return got


@pytest.mark.parametrize("window", [1, 32, 256])
@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rg,k", SHAPES)
def test_fused_compact_rows_plain_matches_ref(rg, k, sparse, hub, window):
    c = gather_case(rg * 7 + k + 3 * sparse + hub + window, rg, k,
                    sparse=sparse, hub=hub, window=window, lo=3)
    r = len(c["cu"])
    _assert_fused(c, max(r, 1))


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_fused_compact_rows_truncating_capacity(sparse, hub):
    """count may exceed capacity: the first ``capacity`` survivors in
    ascending row order, and the full count."""
    c = gather_case(91 + sparse + 2 * hub, 120, 16, sparse=sparse, hub=hub)
    c["cu"] = np.where(c["ids"] < c["n"], -1, c["cu"]).astype(np.int32)
    c["pending"] = c["active"] & (c["cu"] >= 0)
    items, count = _assert_fused(c, 17)[3:]
    assert int(count) > 17 and items.shape == (17,)


def test_fused_compact_rows_never_read_the_non_hub_row():
    """The kernel reads a hub table row only where the hub slot is below
    n_hub; the twin equally ignores what row n_hub holds."""
    c = gather_case(5, 60, 8, sparse=True, hub=True, window=32)
    want = _assert_fused(c, 70)
    c["hub_forb"] = c["hub_forb"].copy()
    c["hub_lose"] = c["hub_lose"].copy()
    c["hub_forb"][-1] = True
    c["hub_lose"][-1] = True
    got = fused_compact_rows_plain(*_fused_args(c), 32, capacity=70,
                                   n_sentinel=c["n"])
    for a, b, name in zip(got, want, _OUTS):
        _eq(a, b, name)


def _step_args(c):
    return (_t(c["colors"]), _t(c["priority"]), _t(c["ell"]), _t(c["rows"]),
            _t(c["base"]), _t(c["cu"]), _t(c["pu"]), _t(c["ids"]),
            _t(c["pending"]), _t(c["hub_forb"]), _t(c["hub_lose"]),
            _t(c["hub_slot"]))


def _assert_step(c):
    """``fused_step_rows_plain`` against ``fused_step_plain`` on the
    gathered tiles and against ``repro``'s oracle, each with the hub lose
    flag of the pending rows ORed in, and ``ops.fused_step`` on CPU
    tensors against the twin."""
    g = gathered(c)
    w = c["window"]
    pend = c["pending"] & g["ok"]
    got = fused_step_rows_plain(*_step_args(c), w)
    lose, first = fused_step_plain(
        _t(g["nc"]), _t(g["npr"]), _t(g["nbr"]), _t(c["base"]), _t(c["cu"]),
        _t(c["pu"]), _t(c["ids"]), _t(pend), _t(g["extra"]), w)
    if g["hl"] is not None:
        lose = lose | _t(g["hl"] & pend)
    _eq(got[0], lose, "lose")
    _eq(got[1], first, "first")
    if len(pend):
        extra = (g["extra"] if g["extra"] is not None
                 else np.zeros((len(pend), w), bool))
        want_l, want_f = _step_ref(
            _j(g["nc"]), _j(g["npr"]), _j(g["nbr"]), _j(c["base"]),
            _j(c["cu"]), _j(c["pu"]), _j(c["ids"]), _j(pend), _j(extra), w)
        want_l = np.asarray(want_l)
        if g["hl"] is not None:
            want_l = want_l | (g["hl"] & pend)
        _eq(got[0], want_l, "lose vs ref")
        _eq(got[1], want_f, "first vs ref")
    for a, b in zip(ops.fused_step(*_step_args(c), w), got):
        _eq(a, b, "ops")
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert got[0].shape == got[1].shape == (len(pend),)
    return got


STEP_SHAPES = SHAPES + [(50, 3), (30, 13)]


@pytest.mark.parametrize("window", [1, 32, 256])
@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rg,k", STEP_SHAPES)
def test_fused_step_rows_plain_matches_ref(rg, k, sparse, hub, window):
    """Rows None and sparse rows with pads >= Rg, Rg = 0, hub and no-hub,
    K % 4 == 0 and not; hub rows with an all-forbidden window (every third
    hub) and one-color windows give exhausted rows (first = -1)."""
    c = gather_case(rg * 11 + k + 5 * sparse + hub + window, rg, k,
                    sparse=sparse, hub=hub, window=window, lo=7)
    lose, first = _assert_step(c)
    extra = gathered(c)["extra"]
    if extra is not None:
        assert (first.numpy()[extra.all(axis=1)] == -1).all()


def test_fused_step_rows_never_read_the_non_hub_row():
    """The kernel reads a hub table row only where the hub slot is below
    n_hub; the twin equally ignores what row n_hub holds."""
    c = gather_case(6, 60, 8, sparse=True, hub=True, window=32)
    want = _assert_step(c)
    c["hub_forb"] = c["hub_forb"].copy()
    c["hub_lose"] = c["hub_lose"].copy()
    c["hub_forb"][-1] = True
    c["hub_lose"][-1] = True
    for a, b in zip(fused_step_rows_plain(*_step_args(c), 32), want):
        _eq(a, b)


def test_sentinel_rows_are_empty():
    """A row >= Rg is neither active nor pending and loses nothing, even
    when its own flags say otherwise."""
    c = gather_case(8, 30, 8, sparse=True, hub=True)
    bad = c["rows"] >= c["rg"]
    assert bad.any()
    c["active"] = c["active"] | bad
    c["newly"] = c["newly"] | bad
    c["cu"] = np.where(bad, -1, c["cu"]).astype(np.int32)
    lose = conflict_rows_plain(*_conflict_args(c))
    assert not lose[_t(bad)].any()
    new_c, new_b, still, _, _ = fused_compact_rows_plain(
        *_fused_args(c), 32, capacity=40, n_sentinel=c["n"])
    assert not still[_t(bad)].any()
    _eq(new_c[_t(bad)], c["cu"][bad])
    _eq(new_b[_t(bad)], c["base"][bad])
    # fused_step: an empty row loses nothing and its window is all free
    c["pending"] = c["pending"] | bad
    lose, first = fused_step_rows_plain(*_step_args(c), 32)
    assert not lose[_t(bad)].any()
    assert (first[_t(bad)] == 0).all()


# --- the left-packing the kernels rely on ------------------------------------

def _left_packed(ell: np.ndarray, pad: int) -> bool:
    """No real entry after a padding entry in any row."""
    is_pad = np.asarray(ell) == pad
    return bool(np.array_equal(is_pad, np.maximum.accumulate(is_pad,
                                                             axis=1)))


@pytest.mark.parametrize("layout", LAYOUT_KINDS)
@pytest.mark.parametrize("name", dataset_names())
def test_ell_rows_are_left_packed(name, layout):
    g = tget(name, scale=0.02, layout=layout)
    ig = ipgc.prepare(g, device="cpu")
    assert _left_packed(ig.ell_idx.numpy(), g.n_nodes)
    # and each real entry is the row's next CSR neighbour
    deg = np.minimum(np.asarray(g.arrays.degrees), g.ell_width)
    real = (ig.ell_idx.numpy() != g.n_nodes).sum(axis=1)
    if layout == "hub-split":
        assert np.all(real <= deg)
    else:
        _eq(real, deg)


@pytest.mark.parametrize("s_count", [2, 4])
@pytest.mark.parametrize("name,layout", [("kron_g500-logn21_s", "ell-tail"),
                                         ("europe_osm_s", "auto"),
                                         ("circuit5M_s", "hub-split"),
                                         ("rgg_n_2_24_s0_s", "pure-ell")])
def test_shard_ell_blocks_are_left_packed(name, layout, s_count):
    g = tget(name, scale=0.02, layout=layout)
    g2, _ = prepare_partition(g, s_count)
    ig = ipgc.prepare(g2, device="cpu")
    shards = dist.shard_graph(ig, ("cpu",) * s_count)
    assert len(shards) == s_count
    for sh in shards:
        assert _left_packed(sh.ig.ell_idx.numpy(), g2.n_nodes)
