"""The boundary exchange of the port's distributed Pipe (``exchange=
"boundary"|"auto"``, DESIGN.md §13) against ``repro``'s
(``tests/test_boundary.py``): the partition's ghost and boundary sets and
capacity ladder equal the reference's; at S=1 every coloring and exchange
knob equals ``repro.core.color_distributed`` field for field, exchange
trace and bytes included; an overflowing buffer falls back to the dense
swap bit-identically without touching the sentinel slot; the byte
formulas and the runtime exchange counts agree; and (in a subprocess with
four simulated devices) the reference's exchange ledger at S=4."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.graphs import build_graph as jbuild_graph
from repro.graphs import get_dataset as jget
from repro.graphs import partition as jpartition
from repro.obs import report as jreport
import repro_torch
from repro_torch.core import distributed as tdist
from repro_torch.core import ipgc as tipgc
from repro_torch.core.worklist import full_worklist
from repro_torch.graphs import build_graph as tbuild_graph
from repro_torch.graphs import get_dataset as tget
from repro_torch.graphs import partition as tpartition
from repro_torch.obs import report as treport

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: (algo, fused) of the distributed colorings
ALGOS = [("ipgc", True), ("ipgc", False), ("spec-greedy", None),
         ("jpl", None)]
EXCHANGES = ["dense", "boundary", "auto"]


def _random_graphs(seed: int, n: int, m: int):
    """The same random multigraph in ``repro`` and in the port."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return (jbuild_graph(src, dst, n, name=f"rb{seed}", ell_cap=8),
            tbuild_graph(src, dst, n, name=f"rb{seed}", ell_cap=8))


def _same_info(got, want):
    assert (got.n_nodes, got.n_shards, got.block, got.counts,
            got.max_boundary, got.capacities) == \
        (want.n_nodes, want.n_shards, want.block, want.counts,
         want.max_boundary, want.capacities)
    np.testing.assert_array_equal(got.is_boundary, want.is_boundary)
    assert got.is_boundary.dtype == want.is_boundary.dtype


def _check_ghost_contract(g, n_shards: int):
    """Symmetry and completeness of the port's ghost and boundary sets
    against a direct recount of the cross edges."""
    n = g.n_nodes
    blk = n // n_shards
    info = tpartition.boundary_info(g, n_shards)
    src = np.repeat(np.arange(n), np.asarray(g.arrays.degrees))
    dst = np.asarray(g.arrays.col_idx)
    cross = (src // blk) != (dst // blk)
    ghosts = [set(tpartition.ghost_ids(g, n_shards, s).tolist())
              for s in range(n_shards)]
    for u, v in zip(src[cross], dst[cross]):
        assert v in ghosts[u // blk]
        assert info.is_boundary[u] and info.is_boundary[v]
    assert set().union(*ghosts) == set(np.flatnonzero(info.is_boundary))
    owner = np.arange(n) // blk
    for s in range(n_shards):
        assert info.counts[s] == int(
            np.count_nonzero(info.is_boundary & (owner == s)))


@pytest.mark.parametrize("seed,n_shards", [(0, 2), (1, 4), (2, 8)])
def test_ghost_sets_match_reference(seed, n_shards):
    jg, tg = _random_graphs(seed, 64 * n_shards, 600)
    _same_info(tpartition.boundary_info(tg, n_shards),
               jpartition.boundary_info(jg, n_shards))
    for s in range(n_shards):
        got = tpartition.ghost_ids(tg, n_shards, s)
        np.testing.assert_array_equal(got,
                                      jpartition.ghost_ids(jg, n_shards, s))
    _check_ghost_contract(tg, n_shards)


def test_ghost_sets_after_uneven_partition():
    jg0, tg0 = _random_graphs(3, 203, 900)          # 203 % 4 != 0
    jg, _ = jpartition.prepare_partition(jg0, 4)
    tg, _ = tpartition.prepare_partition(tg0, 4)
    assert tg.n_nodes % 4 == 0 and tg.n_nodes >= 203
    info = tpartition.boundary_info(tg, 4)
    _same_info(info, jpartition.boundary_info(jg, 4))
    _check_ghost_contract(tg, 4)
    # the padding isolates join no edges, so they are never boundary
    assert not info.is_boundary[np.asarray(tg.arrays.degrees) == 0].any()


def test_boundary_info_rejects_undivisible():
    _, tg = _random_graphs(4, 10, 40)
    with pytest.raises(ValueError, match="equal blocks"):
        tpartition.boundary_info(tg, 4)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_capacity_ladder_matches_reference(n_shards):
    jg, tg = _random_graphs(5, 64 * n_shards, 2000)
    info = tpartition.boundary_info(tg, n_shards)
    _same_info(info, jpartition.boundary_info(jg, n_shards))
    caps = info.capacities
    assert caps == tuple(sorted(set(caps), reverse=True))
    assert caps[0] <= tg.n_nodes // n_shards and caps[-1] == 8
    assert all(c % 8 == 0 for c in caps)
    for args in ((256, 100, 10_000, 2), (1, 0, 16, 8), (4096, 5000, 9000, 3),
                 (64, 63, 100, 1)):
        assert tpartition.boundary_capacities(*args) == \
            jpartition.boundary_capacities(*args)
    assert tpartition.boundary_capacities(256, 100, 10_000, 2)[0] == 104


def test_break_even_matches_reference():
    for n, s in ((10_000, 2), (10_000, 8), (16, 8), (0, 1), (99, 0)):
        assert tpartition.exchange_break_even(n, s) == \
            jpartition.exchange_break_even(n, s)
    assert tpartition.exchange_break_even(10_000, 2) > \
        tpartition.exchange_break_even(10_000, 8)


# ---------------------------------------------------------------------------
# whole colorings at S=1 against repro's color_distributed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("algo,fused", ALGOS)
def test_single_shard_matches_reference(algo, fused, exchange):
    jg = jget("kron_g500-logn21_s", scale=0.01, layout="ell-tail")
    tg = tget("kron_g500-logn21_s", scale=0.01, layout="ell-tail")
    got = repro_torch.color(tg, mode="dist-hybrid", algo=algo, fused=fused,
                            devices=["cpu"], exchange=exchange)
    want = jcore.color_distributed(jg, n_shards=1, algo=algo, fused=fused,
                                   exchange=exchange)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert (got.n_colors, got.iterations, got.mode_trace, got.counts,
            got.host_dispatches) == \
        (want.n_colors, want.iterations, want.mode_trace, want.counts,
         want.host_dispatches)
    assert got.exchange_trace == want.exchange_trace
    assert got.exchange_bytes == [int(b) for b in want.exchange_bytes]
    assert len(got.exchange_trace) == got.iterations
    repro_torch.verify_coloring(tg, got.colors)


# ---------------------------------------------------------------------------
# the publish itself
# ---------------------------------------------------------------------------

def _overflow_setup():
    _, tg0 = _random_graphs(6, 300, 2400)
    tg, _ = tpartition.prepare_partition(tg0, 1)
    ig = tipgc.prepare(tg, device="cpu")
    return tg, ig


def test_overflow_falls_back_to_dense_swap_deterministically():
    """bcap=8 is too small for the first dense sweeps of a 300-node random
    graph: the publish takes the dense swap, bit-identically to the host
    step, every time; the sentinel slot n of every view stays PAD_COLOR."""
    tg, _ = _overflow_setup()
    for s_count in (1, 2):
        g2, _ = tpartition.prepare_partition(tg, s_count)
        ig2 = tipgc.prepare(g2, device="cpu")
        n2 = ig2.n_nodes
        info = tpartition.boundary_info(g2, s_count)
        mesh = (CPU,) * s_count
        step = tdist.make_dist_dense_step(
            ig2, mesh, window=64, fused=True, exchange="boundary",
            boundary=info, thresh=n2 + 1)
        outs = []
        for _ in range(2):                            # determinism
            views, base, wl = tdist.shard_state(
                mesh, tipgc.init_colors(n2, CPU),
                torch.zeros(n2, dtype=torch.int32), full_worklist(n2, CPU))
            views = tdist.shard_views(views)
            cr = tipgc.init_colors(n2, CPU)
            br = torch.zeros(n2, dtype=torch.int32)
            wr = full_worklist(n2, CPU)
            ref_step = tipgc.step_fns(True)[0]
            marks = []
            for _i in range(3):
                views, base, wl, xs = step(views, base, wl, bcap=8)
                cr, br, wr = ref_step(ig2, cr, br, wr, window=64)
                np.testing.assert_array_equal(
                    tdist.views_to_colors(views, s_count, n2),
                    cr[:n2].numpy())
                assert int(wl.count) == int(wr.count)
                for v in views:
                    assert int(v[n2]) == tipgc.PAD_COLOR
                marks.append(tuple(xs.tolist()))
            outs.append((tdist.views_to_colors(views, s_count, n2), marks))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert outs[0][1] == outs[1][1]
        if s_count > 1:       # the first sweep overflows: a dense swap
            assert outs[0][1][0][0] == 0 and outs[0][1][0][1] > 8


def test_pad_ids_never_reach_the_sentinel():
    """A sparse publish whose items carry pad lanes (id n) writes nothing
    at slot n; the shards keep views of their own."""
    tg, ig = _overflow_setup()
    g2, _ = tpartition.prepare_partition(tg, 2)
    ig2 = tipgc.prepare(g2, device="cpu")
    n = ig2.n_nodes
    info = tpartition.boundary_info(g2, 2)
    mesh = (CPU, CPU)
    sparse = tdist.make_dist_sparse_step(
        ig2, mesh, window=64, fused=False, exchange="boundary",
        boundary=info, thresh=n + 1)
    views, base, wl = tdist.shard_state(
        mesh, tipgc.init_colors(n, CPU), torch.zeros(n, dtype=torch.int32),
        full_worklist(n, CPU))
    views = tdist.shard_views(views)
    assert views[0].data_ptr() != views[1].data_ptr()
    wl = tdist.resize_worklist(wl, n // 2 + 16, n)      # pad lanes
    assert (wl.blocks[0].items == n).sum() == 16
    for _ in range(2):
        views, base, wl, xs = sparse(views, base, wl, bcap=info.capacities[0])
        for v in views:
            assert int(v[n]) == tipgc.PAD_COLOR
        assert views[0].data_ptr() != views[1].data_ptr()


def test_runtime_exchange_counts_and_byte_formulas():
    """Each publish of a boundary step counts a ``boundary_pack`` AND a
    ``dense_swap`` (it computes both), never a ``color_psum``; the byte
    formulas equal the reference's."""
    tg, ig = _overflow_setup()
    n = ig.n_nodes
    info = tpartition.boundary_info(tg, 1)
    bcap = info.capacities[0]
    mesh = (CPU,)
    for fused, publishes in ((True, 1), (False, 2)):
        for make in (tdist.make_dist_dense_step, tdist.make_dist_sparse_step):
            step = make(ig, mesh, window=64, fused=fused,
                        exchange="boundary", boundary=info, thresh=n + 1)
            assert step.exchanges_per_iter == publishes
            views, base, wl = tdist.shard_state(
                mesh, tipgc.init_colors(n, CPU),
                torch.zeros(n, dtype=torch.int32), full_worklist(n, CPU))
            with tdist.EXCHANGE_COUNTS.scope() as ec:
                step(tdist.shard_views(views), base, wl, bcap=bcap)
                assert ec.as_dict() == {"color_psum": 0,
                                        "boundary_pack": publishes,
                                        "dense_swap": publishes}
    for f in ("dense_exchange_bytes", "dense_swap_bytes"):
        assert getattr(treport, f)(n) == getattr(jreport, f)(n)
    assert treport.packed_exchange_bytes(bcap, 8) == \
        jreport.packed_exchange_bytes(bcap, 8) == 64 * bcap
    with pytest.raises(ValueError, match="BoundaryInfo"):
        tdist.make_dist_dense_step(ig, mesh, exchange="auto")


def test_report_traffic_win_visible():
    """On europe the auto path moves fewer ledger bytes than the dense
    exchange once the worklist thins, with packed iterations in its
    trace; the two reports equal the reference's ledgers."""
    tg = tget("europe_osm_s", scale=0.02)
    jg = jget("europe_osm_s", scale=0.02)
    reps = {}
    for ex in ("dense", "auto"):
        reps[ex] = repro_torch.color(tg, mode="dist-hybrid", devices=["cpu"],
                                     exchange=ex, trace=True)
        want = jcore.color(jg, mode="dist-hybrid", n_shards=1, exchange=ex,
                           trace=True)
        assert reps[ex].exchanges == want.exchanges
    np.testing.assert_array_equal(reps["dense"].colors, reps["auto"].colors)
    xd, xa = reps["dense"].exchanges, reps["auto"].exchanges
    assert xd["exchange"] == "dense" and xa["exchange"] == "auto"
    assert sum(xa["bytes_per_iter"]) < sum(xd["bytes_per_iter"])
    assert "b" in xa["trace"]


def test_cache_key_holds_the_exchange():
    """A dense-built step never serves a boundary run on one session."""
    from repro_torch.exec import ExecutionSpec, Session
    tg = tget("kron_g500-logn21_s", scale=0.01, layout="ell-tail")
    s = Session("cpu")
    runs = {ex: s.run(ExecutionSpec(regime="dist", exchange=ex), tg,
                      devices=["cpu"] * 2)
            for ex in ("dense", "boundary", "dense", "auto")}
    assert runs["dense"].exchange_trace == "d" * runs["dense"].iterations
    assert set(runs["boundary"].exchange_trace) <= {"b", "d", "m"}
    assert "b" in runs["boundary"].exchange_trace
    for r in runs.values():
        np.testing.assert_array_equal(r.colors, runs["dense"].colors)
    keys = [k for k in s.cache if k[0] == "dist"]
    assert sorted(k[-1] for k in keys) == ["auto", "boundary", "dense"]


# ---------------------------------------------------------------------------
# the reference's ledger at S=4 (subprocess: four simulated devices)
# ---------------------------------------------------------------------------

_REF_S4 = """
import json
import repro.core as jcore
from repro.graphs import get_dataset
g = get_dataset("kron_g500-logn21_s", scale=0.01, layout="ell-tail")
out = {}
for fused in (True, False):
    for ex in ("boundary", "auto"):
        r = jcore.color_distributed(g, n_shards=4, fused=fused, exchange=ex)
        out[f"{fused}-{ex}"] = [r.exchange_trace,
                                [int(b) for b in r.exchange_bytes],
                                r.iterations, r.mode_trace,
                                r.colors.tolist()]
print("REF_S4", json.dumps(out))
"""


def test_four_shard_ledger_matches_reference_subprocess():
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, "-c", _REF_S4],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines()
                if x.startswith("REF_S4 "))
    want = json.loads(line[len("REF_S4 "):])
    tg = tget("kron_g500-logn21_s", scale=0.01, layout="ell-tail")
    for key, (xtrace, xbytes, iters, trace, colors) in want.items():
        fused = key.startswith("True")
        r = repro_torch.color_distributed(tg, devices=["cpu"] * 4,
                                          fused=fused,
                                          exchange=key.split("-")[1])
        assert (r.exchange_trace, r.exchange_bytes, r.iterations,
                r.mode_trace) == (xtrace, xbytes, iters, trace), key
        np.testing.assert_array_equal(r.colors, np.asarray(colors))
        assert "b" in r.exchange_trace
