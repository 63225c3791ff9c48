"""The port's distributed steps (``core/distributed.py``, ``algos/jpl.py``)
against ``repro``'s shard_map steps on a one-device mesh, one dense and one
sparse step of each family from the same mid-run state, at 1 and 4 shards
on the CPU; the exchange-count invariant; and the errors of what the
distributed Pipe refuses. Exact: all state is int32/bool."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import jpl as jjpl
from repro.core import distributed as jdist
from repro.core import ipgc as jipgc
from repro.core import worklist as jwl
from repro.graphs import get_dataset as jget
from repro.graphs.partition import prepare_partition as jprepare_partition
from repro.obs.report import dense_exchange_bytes as jdense_exchange_bytes
import repro_torch
from repro_torch.algos import Algorithm, get_algorithm
from repro_torch.algos.ipgc_algo import IPGC
from repro_torch.core import distributed as tdist
from repro_torch.core import ipgc as tipgc
from repro_torch.core.policy import FixedH, exchange_threshold, make_policy
from repro_torch.core.worklist import Worklist, bucket_capacities, pick_bucket
from repro_torch.exec import ExecutionSpec, Session, spec_for
from repro_torch.graphs import get_dataset as tget
from repro_torch.obs.report import dense_exchange_bytes

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

WINDOW = 32
FAMILIES = ("two-phase", "fused", "jpl")


def _prepared(name):
    """``repro``'s prepared graph of a 4-shard partition and the port's
    copy of its arrays on the CPU."""
    jg2, _ = jprepare_partition(jget(name, scale=0.02, layout="ell-tail"), 4)
    jig = jipgc.prepare(jg2)
    arrays = {f.name: np.asarray(getattr(jig, f.name))
              for f in dataclasses.fields(jig)
              if getattr(jig, f.name) is not None
              and not isinstance(getattr(jig, f.name), (int, str))}
    tig = tipgc.from_numpy(arrays, layout_kind=jig.layout_kind, device="cpu")
    return jig, tig


def _jax_steps(family, jig):
    mesh = jax.make_mesh((1,), ("data",))
    if family == "jpl":
        return jjpl.make_jpl_dist_steps(jig, mesh, ("data",))
    fused = family == "fused"
    return (jdist.make_dist_dense_step(jig, mesh, ("data",), window=WINDOW,
                                       fused=fused),
            jdist.make_dist_sparse_step(jig, mesh, ("data",), window=WINDOW,
                                        fused=fused))


def _port_steps(family, tig, mesh):
    if family == "jpl":
        return get_algorithm("jpl").make_dist_steps(tig, mesh, window=WINDOW,
                                                    fused=False)
    return IPGC().make_dist_steps(tig, mesh, window=WINDOW,
                                  fused=family == "fused")


def _mid_run_state(family, jig):
    """Two dense host steps into a run (``repro``'s own steps)."""
    n = jig.n_nodes
    colors, wl = jipgc.init_colors(n), jwl.full_worklist(n)
    if family == "jpl":
        aux = jnp.zeros((), jnp.int32)
        for _ in range(2):
            colors, aux, wl = jjpl.jpl_dense_step(jig, colors, aux, wl)
    else:
        aux = jnp.zeros((n,), jnp.int32)
        dense = (jipgc.fused_dense_step if family == "fused"
                 else jipgc.dense_step)
        for _ in range(2):
            colors, aux, wl = dense(jig, colors, aux, wl, window=WINDOW)
    return colors, aux, wl


def _blocks(mask, n, s_count, cap):
    """Per-shard worklist blocks of a mask: each shard's set ids, ascending,
    padded with n to ``cap`` — what a step must emit."""
    blk = n // s_count
    out = []
    for s in range(s_count):
        ids = s * blk + np.flatnonzero(mask[s * blk:(s + 1) * blk])
        items = np.full(cap, n, np.int32)
        items[:len(ids)] = ids
        out.append((mask[s * blk:(s + 1) * blk], items, len(ids)))
    return out


def _port_state(colors, aux, mask, s_count, cap):
    n = mask.shape[0]
    blk = n // s_count
    c = torch.from_numpy(np.array(colors))
    a = torch.from_numpy(np.array(aux))
    auxs = (tuple(a[s * blk:(s + 1) * blk] for s in range(s_count))
            if a.dim() else (a,) * s_count)
    blocks = tuple(Worklist(mask=torch.from_numpy(m.copy()),
                            items=torch.from_numpy(it),
                            count=torch.tensor(k, dtype=torch.int32))
                   for m, it, k in _blocks(mask, n, s_count, cap))
    count = torch.tensor(int(mask.sum()), dtype=torch.int32)
    return (c,) * s_count, auxs, tdist.ShardedWorklist(blocks, count)


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("phase", ["dense", "sparse"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "europe_osm_s"])
def test_dist_step_matches_reference(name, family, phase, force):
    jig, tig = _prepared(name)
    n = jig.n_nodes
    assert (jig.n_hub > 0) == (name == "kron_g500-logn21_s")
    colors, aux, wl = _mid_run_state(family, jig)
    mask = np.asarray(wl.mask)
    count = int(wl.count)
    idx = 0 if phase == "dense" else 1
    # the reference: repro's step on a one-device mesh (traced fresh, so
    # its trace-time counters count this step)
    if phase == "sparse":
        cap1 = pick_bucket(bucket_capacities(n, ratio=2), count)
        wl = jwl.resize_items(wl, cap1, n)
    with jipgc.forced_hub(force), jipgc.LAUNCH_COUNTS.scope() as jlc, \
            jdist.EXCHANGE_COUNTS.scope() as jec:
        want = _jax_steps(family, jig)[idx](colors, aux, wl)
        want_launches = jlc.as_dict()
        want_exchanges = jec["color_psum"]
    want_c, want_aux, want_wl = np.asarray(want[0]), np.asarray(want[1]), \
        want[2]
    want_mask = np.asarray(want_wl.mask)
    for s_count in (1, 4):
        mesh = (torch.device("cpu"),) * s_count
        blk = n // s_count
        cap = (blk if phase == "dense" else
               pick_bucket(bucket_capacities(blk, ratio=2), min(count, blk)))
        state = _port_state(colors, aux, mask, s_count, cap)
        dense_fn, sparse_fn = _port_steps(family, tig, mesh)
        step = (dense_fn, sparse_fn)[idx]
        with tipgc.forced_hub(force), tipgc.LAUNCH_COUNTS.scope() as lc, \
                tdist.EXCHANGE_COUNTS.scope() as ec:
            got_c, got_aux, got_wl = step(*state)
            launches = lc.as_dict()
            exchanges = ec["color_psum"]
        for c in got_c:
            np.testing.assert_array_equal(c.numpy(), want_c)
        got_aux = (torch.cat(got_aux) if got_aux[0].dim()
                   else got_aux[0]).numpy()
        np.testing.assert_array_equal(got_aux, want_aux)
        got_mask = torch.cat([b.mask for b in got_wl.blocks]).numpy()
        np.testing.assert_array_equal(got_mask, want_mask)
        assert int(got_wl.count) == int(want_wl.count)
        for b, (_, items, k) in zip(got_wl.blocks,
                                    _blocks(want_mask, n, s_count, cap)):
            np.testing.assert_array_equal(b.items.numpy(), items)
            assert int(b.count) == k and b.items.dtype == torch.int32
        if s_count == 1:
            np.testing.assert_array_equal(
                got_wl.blocks[0].items.numpy(), np.asarray(want_wl.items))
        # counted when the step runs: one exchange per collective, one
        # logical pass per shard
        assert exchanges == want_exchanges == step.exchanges_per_iter
        assert launches == {k: v * s_count for k, v in
                            want_launches.items()}


@pytest.mark.parametrize("s_count", [1, 4])
@pytest.mark.parametrize("algo,fused,per_iter", [
    ("ipgc", True, 1), ("ipgc", False, 2), ("spec-greedy", None, 1),
    ("jpl", None, 1)])
def test_exchange_count_invariant(algo, fused, per_iter, s_count):
    """One exchange per fused iteration (and JPL round), two per two-phase
    iteration, counted when the exchanges run; the byte ledger follows."""
    g = tget("kron_g500-logn21_s", scale=0.02, layout="ell-tail")
    with tdist.EXCHANGE_COUNTS.scope() as ec:
        r = repro_torch.color_distributed(g, devices=["cpu"] * s_count,
                                          algo=algo, fused=fused)
        assert ec["color_psum"] == per_iter * r.iterations > 0
    n2 = Session("cpu").partition(g, s_count)[0].n_nodes
    assert r.exchange_trace == "d" * r.iterations
    assert r.exchange_bytes == [per_iter * 4 * (n2 + 1)] * r.iterations
    assert r.host_dispatches == r.iterations
    repro_torch.verify_coloring(g, r.colors)


def test_dist_entry_points_agree():
    """``color(mode="dist-hybrid")``, ``color_distributed`` and
    ``Session.run(ExecutionSpec(regime="dist"))`` run the same Pipe; the
    partition is built once per (graph, shard count) and shared by every
    algorithm."""
    g = tget("hollywood-2009_s", scale=0.02, layout="ell-tail")
    a = repro_torch.color(g, mode="dist-hybrid", device="cpu", n_shards=2)
    b = repro_torch.color_distributed(g, devices=["cpu", "cpu"])
    sess = Session("cpu")
    c = sess.run(ExecutionSpec(regime="dist", n_shards=2), g)
    d = sess.run(ExecutionSpec(regime="dist", algo="jpl"), g,
                 devices=["cpu"] * 2)
    for r in (b, c):
        np.testing.assert_array_equal(r.colors, a.colors)
        assert (r.iterations, r.mode_trace, r.counts) == \
            (a.iterations, a.mode_trace, a.counts)
    repro_torch.verify_coloring(g, d.colors)
    partitions = [k for k in sess.cache if k[0] == "partition"]
    assert len(partitions) == 1
    assert sess.partition(g, 2)[0] is sess.partition(g, 2)[0]


def test_host_regime_counts_its_dispatches():
    g = tget("europe_osm_s", scale=0.01, layout="pure-ell")
    r = repro_torch.color(g, device="cpu")
    assert r.host_dispatches == r.iterations > 0
    assert (r.exchange_trace, r.exchange_bytes) == ("", [])


def test_resolve_mesh_on_cpu(monkeypatch):
    cpu = torch.device("cpu")
    assert tdist.resolve_mesh(None, ["cpu"] * 3) == (cpu,) * 3
    assert tdist.resolve_mesh(4, None, "cpu") == (cpu,) * 4
    assert tdist.resolve_mesh(None, None, "cpu") == (cpu,)
    with pytest.raises(ValueError, match="disagrees"):
        tdist.resolve_mesh(2, ["cpu"] * 3)
    with pytest.raises(ValueError, match=">= 1"):
        tdist.resolve_mesh(0, None, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.resolve_mesh(None, None, None)
    g = tget("europe_osm_s", scale=0.01, layout="pure-ell")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.color_distributed(g, n_shards=2)


@pytest.mark.parametrize("exchange", ["boundary", "auto"])
def test_boundary_exchange_is_not_ported(exchange):
    """Once refused, the boundary exchange now runs through every entry
    point (``tests/test_torch_boundary.py`` holds it against the
    reference); the step constructors need the partition's boundary sets,
    and an unknown exchange is still refused."""
    g = tget("europe_osm_s", scale=0.01, layout="pure-ell")
    dense = repro_torch.color_distributed(g, devices=["cpu"])
    r = repro_torch.color_distributed(g, devices=["cpu"], exchange=exchange)
    np.testing.assert_array_equal(r.colors, dense.colors)
    assert set(r.exchange_trace) <= {"b", "d", "m"}
    ig = repro_torch.prepare(g, device="cpu")
    with pytest.raises(ValueError, match="BoundaryInfo"):
        tdist.make_dist_dense_step(ig, (torch.device("cpu"),),
                                   exchange=exchange)
    with pytest.raises(ValueError, match="BoundaryInfo"):
        get_algorithm("jpl").make_dist_steps(ig, (torch.device("cpu"),),
                                             window=128, fused=False,
                                             exchange=exchange)
    with pytest.raises(ValueError, match="unknown exchange"):
        ExecutionSpec(regime="dist", exchange="packed")
    with pytest.raises(ValueError, match="unknown exchange"):
        tdist.check_exchange("packed")


@dataclasses.dataclass(frozen=True)
class _Unsafe(Algorithm):
    name: str = "unsafe-test"
    shard_safe: bool = False
    shard_unsafe_reason: str = "its worklist is global"


def test_what_the_dist_pipe_refuses():
    g = tget("europe_osm_s", scale=0.01, layout="pure-ell")
    with pytest.raises(ValueError, match="its worklist is global"):
        repro_torch.color_distributed(g, devices=["cpu"], algo=_Unsafe())
    with pytest.raises(NotImplementedError, match="not shard-safe"):
        _Unsafe().make_dist_steps(None, None, window=128, fused=True)
    with pytest.raises(NotImplementedError, match="csr-segment"):
        repro_torch.color_distributed(g, devices=["cpu"],
                                      layout="csr-segment")
    ig = repro_torch.prepare(g, device="cpu")
    with pytest.raises(TypeError, match="host Graph"):
        repro_torch.color_distributed(ig, devices=["cpu"])
    with pytest.raises(ValueError, match="equal blocks"):
        tdist.shard_graph(ig, (torch.device("cpu"),) * 3)


def test_dist_policy_spec_and_bytes():
    assert make_policy("dist-hybrid", 0.5) == FixedH(0.5)
    assert make_policy("dist-topology")(1, 10)
    assert exchange_threshold(100, 4, "dense") == -1
    assert exchange_threshold(100, 4, "boundary") == 101
    assert exchange_threshold(100, 4, "auto") == 12
    assert dense_exchange_bytes(10) == 44 == jdense_exchange_bytes(10)
    spec = spec_for(mode="dist-hybrid", n_shards=4)
    assert (spec.regime, spec.n_shards, spec.exchange, spec.balance) == \
        ("dist", 4, "dense", True)
