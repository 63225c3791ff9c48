"""The port's CUDA kernels on the card: each against its plain version
(the row kernels at every ``tile_rows`` too), the tile tuner, and
colorings (host loop, outlined regime, distributed Pipe with the dense
and the boundary exchange, traced runs, lane batching and the stream
service, trips keyed by tile) and BFS on the card against the same runs
on the CPU; the LM serving path's default device; the LM training path
(a step card = CPU, an exact resume under deterministic algorithms, the
default device); the GNN and DLRM models (a smoke step of each family, the
sampler and ``RecsysPipeline`` card = CPU, the default device); the step
builders' cases (``launch/steps.py``: each family's case at smoke size
card = CPU, the coloring case's kernels, the default device); the int8
decode's ``q8_dot`` against its plain twin (exactly, also where the int32
sums wrap), and the attention products on bf16 operands against their
float32 path (values and a ``flash_attention`` gradient).
Needs a
CUDA device and nvcc; skips without a device. Imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.bfs import bfs, bfs_reference
from repro_torch.kernels import _build, ops
from repro_torch.kernels.compact import TILE, compact_plain
from repro_torch.kernels.conflict import conflict_rows_plain
from repro_torch.kernels.frontier import frontier_probe_plain
from repro_torch.kernels.fused_compact import fused_compact_rows_plain
from repro_torch.kernels.fused_step import fused_step_rows_plain
from repro_torch.kernels.jpl_prio import Hash, Table, jpl_extrema_rows_plain
from repro_torch.kernels.mex_window import mex_window_rows_plain

import _case_check
from _gather_cases import gather_case, jpl_prio_table

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)


def _gather_args(c, names, dev):
    return [_t(c[name], dev) for name in names]


def _cpu(ts):
    return [None if a is None else a.cpu() for a in ts]


def _source_cpu(src):
    return type(src)(*(x.cpu() for x in src))


_CONFLICT = ("colors", "priority", "ell", "rows", "cu", "pu", "ids", "newly")
_FUSED = ("colors", "priority", "ell", "rows", "base", "cu", "pu", "ids",
          "active", "pending", "hub_forb", "hub_lose", "hub_slot")
_MEX = ("colors", "ell", "rows", "base", "active", "hub_forb", "hub_slot")


def _jpl_sources(c, dev, seed, rnd=3):
    return (Table(_t(jpl_prio_table(c, seed), dev)),
            Hash(_t(c["colors"], dev),
                 torch.tensor(rnd, dtype=torch.int32, device=dev)))


@pytest.mark.parametrize("r,k,w", [(1, 1, 32), (7, 8, 128), (257, 40, 256),
                                   (3000, 128, 64), (100, 3, 200)])
@pytest.mark.parametrize("hub", [False, True])
def test_row_kernels_match_plain(dev, r, k, w, hub):
    """mex_window against its plain twin, rows None and sparse, one launch
    a call."""
    for sparse in (False, True):
        c = gather_case(r + k + w + hub + sparse, r, k, sparse=sparse,
                        hub=hub, window=w, lo=2)
        m = _gather_args(c, _MEX, dev)
        before = _build.KERNEL_LAUNCHES["mex_window"]
        assert torch.equal(ops.mex_window(*m, w).cpu(),
                           mex_window_rows_plain(*_cpu(m), w))
        assert _build.KERNEL_LAUNCHES["mex_window"] == before + 1


@pytest.mark.parametrize("rg,k", [(0, 8), (1, 8), (7, 8), (40, 16),
                                  (100, 40), (257, 128), (3000, 128),
                                  (100, 3), (50, 12)])
@pytest.mark.parametrize("w", [1, 32, 256])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("hub", [False, True])
def test_gather_kernels_match_plain(dev, rg, k, w, sparse, hub):
    """mex_window, conflict, fused_compact and jpl_extrema (both
    sources), which gather the neighbours themselves, against their plain
    twins: rows None or sparse with sentinels, hub and no-hub, rows of
    length 0, < K and K, R = 0, truncating capacities, and an unaligned
    ELL tile (the one-entry loads)."""
    c = gather_case(rg * 5 + k + w + 2 * sparse + hub, rg, k, sparse=sparse,
                    hub=hub, window=w, lo=3)
    r = len(c["cu"])
    cases = [_gather_args(c, _CONFLICT, dev)]
    if rg > 1 and k % 4 == 0:
        ell = _t(c["ell"], dev).reshape(-1)
        shifted = torch.empty(ell.numel() + 1, dtype=ell.dtype, device=dev)
        shifted[1:] = ell
        cases.append(list(cases[0]))
        cases[1][2] = shifted[1:].view(rg, k)
    for args in cases:
        before = _build.KERNEL_LAUNCHES["conflict"]
        assert torch.equal(ops.conflict(*args).cpu(),
                           conflict_rows_plain(*_cpu(args)))
        assert _build.KERNEL_LAUNCHES["conflict"] == before + (r > 0)
        fargs = _gather_args(c, _FUSED, dev)
        fargs[2] = args[2]
        for cap in (max(r, 1), max(r // 3, 1), r + 5):
            before = _build.KERNEL_LAUNCHES["fused_compact"]
            got = ops.fused_compact(*fargs, w, capacity=cap,
                                    n_sentinel=c["n"])
            want = fused_compact_rows_plain(*_cpu(fargs), w, capacity=cap,
                                            n_sentinel=c["n"])
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
            assert _build.KERNEL_LAUNCHES["fused_compact"] == \
                before + (2 if r else 1)
        margs = _gather_args(c, _MEX, dev)
        margs[1] = args[2]
        before = _build.KERNEL_LAUNCHES["mex_window"]
        assert torch.equal(ops.mex_window(*margs, w).cpu(),
                           mex_window_rows_plain(*_cpu(margs), w))
        assert _build.KERNEL_LAUNCHES["mex_window"] == before + (r > 0)
        for src in _jpl_sources(c, dev, rg + k + w):
            jargs = (args[2], args[3], src)
            before = _build.KERNEL_LAUNCHES["jpl_prio"]
            got = ops.jpl_extrema(*jargs)
            want = jpl_extrema_rows_plain(args[2].cpu(), _cpu([args[3]])[0],
                                          _source_cpu(src))
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
            assert _build.KERNEL_LAUNCHES["jpl_prio"] == before + (r > 0)


@pytest.mark.parametrize("n", [1, 2047, 2049, 100_003])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_matches_plain(dev, n, density):
    rng = np.random.default_rng(n)
    mask = _t(rng.random(n) < density, dev)
    values = _t(rng.integers(0, 10**6, size=n).astype(np.int32), dev)
    before = _build.KERNEL_LAUNCHES["compact"]
    for cap in (n, max(n // 2, 1), n + 7):
        got, want = ops.compact(mask, cap, n), compact_plain(mask, cap, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = ops.compact(mask, n, n, values)
    want = compact_plain(mask, n, n, values)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.KERNEL_LAUNCHES["compact"] == before + 4


@pytest.mark.parametrize("density", [1 / 1024, 0.5])
def test_compact_many_tiles_repeats_bit_equal(dev, density):
    """Over 10^4 scan tiles (far more than are resident at once) the
    one-pass look-back gives the plain version's items and count on every
    one of 20 repeats."""
    n = 10_000 * TILE + 123
    rng = np.random.default_rng(11)
    mask = _t(rng.random(n) < density, dev)
    want = compact_plain(mask, n, n)
    for _ in range(20):
        got = ops.compact(mask, n, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrappers_reject_bad_operands(dev):
    colors = torch.zeros(9, dtype=torch.int32, device=dev)
    ell = torch.full((4, 8), 8, dtype=torch.int32, device=dev)
    base = torch.zeros(4, dtype=torch.int32, device=dev)
    active = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="windows of 1..256"):
        ops.mex_window(colors, ell, None, base, active, None, None, 512)
    with pytest.raises(TypeError, match="int32"):
        ops.mex_window(colors.long(), ell, None, base, active, None, None, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mex_window(colors, ell.t().contiguous().t(), None, base, active,
                       None, None, 32)
    with pytest.raises(ValueError, match="together"):
        ops.mex_window(colors, ell, None, base, active,
                       torch.zeros((1, 32), dtype=torch.bool, device=dev),
                       None, 32)
    with pytest.raises(TypeError, match="int32"):
        ops.jpl_extrema(ell, None, Hash(colors, torch.zeros(
            (), dtype=torch.int64, device=dev)))
    with pytest.raises(TypeError, match="Table or a Hash"):
        ops.jpl_extrema(ell, None, colors)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name,layout", [("kron_g500-logn21_s", "ell-tail"),
                                         ("europe_osm_s", "auto"),
                                         ("circuit5M_s", "csr-segment")])
def test_card_coloring_equals_cpu(dev, name, layout, fused):
    g = repro_torch.get_dataset(name, scale=0.05, layout=layout)
    a = repro_torch.color(g, fused=fused)
    b = repro_torch.color(g, fused=fused, device="cpu")
    np.testing.assert_array_equal(a.colors, b.colors)
    assert (a.iterations, a.mode_trace, a.counts) == \
        (b.iterations, b.mode_trace, b.counts)
    repro_torch.verify_coloring(g, a.colors)


def test_prepared_graph_runs_on_its_device(dev):
    g = repro_torch.get_dataset("europe_osm_s", scale=0.05, layout="auto")
    ig = repro_torch.prepare(g)
    assert ig.device.type == "cuda"
    window = repro_torch.core.engine.adaptive_window(g)
    a = repro_torch.color(ig, window=window, fused=True)
    b = repro_torch.color(g, fused=True)
    np.testing.assert_array_equal(a.colors, b.colors)


@pytest.mark.parametrize("r,k", [(0, 8), (1, 1), (1, 128), (7, 3),
                                 (257, 40), (3000, 128), (100, 5)])
@pytest.mark.parametrize("inactive", [0.3, 1.0])
def test_jpl_extrema_matches_plain(dev, r, k, inactive):
    """Both sources, rows None and sparse, every neighbour inactive or a
    share of them, at rounds 0, 1, 7 and 9999; one launch a call (none for
    R = 0); an unaligned ELL tile takes the one-entry loads."""
    for sparse in (False, True):
        c = gather_case(r * 3 + k + sparse, r, k, sparse=sparse, hub=False)
        rng = np.random.default_rng(r + k)
        off = rng.random(c["n"] + 1) < inactive
        c["colors"] = np.where(off, 5, -1).astype(np.int32)
        c["colors"][c["n"]] = -2
        ell = _t(c["ell"], dev)
        rows = _t(c["rows"], dev)
        ells = [ell]
        if r > 1 and k % 4 == 0:
            flat = torch.empty(ell.numel() + 1, dtype=ell.dtype, device=dev)
            flat[1:] = ell.reshape(-1)
            ells.append(flat[1:].view(r, k))
        for rnd in (0, 1, 7, 9999):
            prio = np.where(off, -1, jpl_prio_table(c, rnd)).astype(np.int32)
            prio[c["n"]] = -1
            for src in (Table(_t(prio, dev)),
                        Hash(_t(c["colors"], dev),
                             torch.tensor(rnd, dtype=torch.int32,
                                          device=dev))):
                for e in ells:
                    before = _build.KERNEL_LAUNCHES["jpl_prio"]
                    got = ops.jpl_extrema(e, rows, src)
                    want = jpl_extrema_rows_plain(
                        e.cpu(), None if rows is None else rows.cpu(),
                        _source_cpu(src))
                    assert all(torch.equal(a.cpu(), b)
                               for a, b in zip(got, want))
                    n_rows = r if rows is None else rows.shape[0]
                    assert _build.KERNEL_LAUNCHES["jpl_prio"] == \
                        before + (n_rows > 0)


@pytest.mark.parametrize("r,k", [(0, 8), (1, 1), (1, 128), (7, 3),
                                 (257, 40), (3000, 128), (100, 12)])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5])
def test_frontier_probe_matches_plain(dev, r, k, density):
    rng = np.random.default_rng(r + k)
    nbr = _t(rng.random((r, k)) < density, dev)
    for unvisited in (_t(rng.random(r) < 0.6, dev),
                      torch.ones(r, dtype=torch.bool, device=dev)):
        assert torch.equal(ops.frontier_probe(nbr, unvisited),
                           frontier_probe_plain(nbr, unvisited))
    if r > 1:      # an unaligned tile takes the one-byte loads
        y = nbr.reshape(-1)[1:][:(r - 1) * k].reshape(r - 1, k)
        u = torch.ones(r - 1, dtype=torch.bool, device=dev)
        assert torch.equal(ops.frontier_probe(y, u),
                           frontier_probe_plain(y, u))


@pytest.mark.parametrize("algo", ["jpl", "spec-greedy"])
def test_card_algorithm_equals_cpu(dev, algo):
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=1,
                                layout="ell-tail", ell_cap=128)
    a = repro_torch.color(g, algo=algo)
    b = repro_torch.color(g, algo=algo, device="cpu")
    np.testing.assert_array_equal(a.colors, b.colors)
    assert (a.n_colors, a.iterations, a.mode_trace, a.counts) == \
        (b.n_colors, b.iterations, b.mode_trace, b.counts)
    repro_torch.verify_coloring(g, a.colors)


@pytest.mark.parametrize("mode", ["hybrid", "topdown", "bottomup"])
def test_card_bfs_equals_cpu(dev, mode):
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=1,
                                layout="ell-tail", ell_cap=128)
    a = bfs(g, 0, mode=mode)
    b = bfs(g, 0, mode=mode, device="cpu")
    np.testing.assert_array_equal(a.dist, b.dist)
    assert (a.levels, a.mode_trace) == (b.levels, b.mode_trace)
    np.testing.assert_array_equal(a.dist, bfs_reference(g, 0))


_STEP = ("colors", "priority", "ell", "rows", "base", "cu", "pu", "ids",
         "pending", "hub_forb", "hub_lose", "hub_slot")


@pytest.mark.parametrize("rg,k", [(0, 8), (1, 1), (7, 8), (257, 40),
                                  (3000, 128), (100, 3), (50, 12)])
@pytest.mark.parametrize("w", [1, 32, 200, 256])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("hub", [False, True])
def test_fused_step_matches_plain(dev, rg, k, w, sparse, hub):
    """fused_step, which gathers the neighbours itself, against its plain
    twin: rows None or sparse with sentinels, hub slots and no-hub, rows of
    length 0, < K and K, R = 0, exhausted windows, and an unaligned ELL
    tile (the one-entry loads)."""
    c = gather_case(rg * 7 + k + w + 2 * sparse + hub, rg, k, sparse=sparse,
                    hub=hub, window=w, lo=3)
    r = len(c["cu"])
    cases = [_gather_args(c, _STEP, dev)]
    if rg > 1 and k % 4 == 0:
        ell = _t(c["ell"], dev).reshape(-1)
        shifted = torch.empty(ell.numel() + 1, dtype=ell.dtype, device=dev)
        shifted[1:] = ell
        cases.append(list(cases[0]))
        cases[1][2] = shifted[1:].view(rg, k)
    for args in cases:
        before = _build.KERNEL_LAUNCHES["fused_step"]
        got = ops.fused_step(*args, w)
        want = fused_step_rows_plain(*_cpu(args), w)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        # zero rows launch nothing
        assert _build.KERNEL_LAUNCHES["fused_step"] == before + (r > 0)


@pytest.mark.parametrize("algo,fused", [("ipgc", True), ("ipgc", False),
                                        ("spec-greedy", None),
                                        ("jpl", None)])
def test_card_dist_coloring_equals_cpu(dev, algo, fused):
    """Four shards on one card equal four CPU shards and the host engine
    on the partitioned graph; fused runs launch ``fused_step``."""
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.05,
                                layout="ell-tail", ell_cap=128)
    before = _build.KERNEL_LAUNCHES["fused_step"]
    a = repro_torch.color_distributed(g, devices=[dev] * 4, algo=algo,
                                      fused=fused)
    launched = _build.KERNEL_LAUNCHES["fused_step"] - before
    b = repro_torch.color_distributed(g, devices=["cpu"] * 4, algo=algo,
                                      fused=fused)
    g2, relabel = repro_torch.exec.default_session(dev).partition(g, 4)
    h = repro_torch.color(g2, algo=algo,
                          fused=True if fused is None else fused)
    for r in (b, h):
        np.testing.assert_array_equal(
            a.colors, r.colors if r is b else r.colors[relabel[:g.n_nodes]])
        assert (a.iterations, a.mode_trace, a.counts) == \
            (r.iterations, r.mode_trace, r.counts)
    repro_torch.verify_coloring(g, a.colors)
    assert (launched > 0) == (algo != "jpl" and fused is not False)


def _outlined_runners(session, g):
    """The chunk runners ``session`` keeps in ``g``'s prep entries."""
    return [r for key, entry in session.cache.items()
            if key[0] == "prep" and entry[0] is g for r in entry[3].values()]


#: (algo, fused, kernels its trips must launch) of the outlined colorings
OUTLINED = [("ipgc", False, ("mex_window", "conflict", "compact")),
            ("ipgc", True, ("fused_compact",)),
            ("jpl", None, ("jpl_prio", "compact")),
            ("spec-greedy", None, ("fused_compact",))]


@pytest.mark.parametrize("algo,fused,kernels", OUTLINED)
def test_card_outlined_equals_host_loop_and_cpu(dev, algo, fused, kernels):
    """The outlined regime on the card: equal to the card's host loop and
    to the outlined regime on the CPU; a second run replays the captured
    trips, captures nothing, and gives the same result; the launches of
    its trips come from replays, not from the wrappers."""
    from repro_torch.exec import ExecutionSpec, Session, chunk
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=1,
                                layout="ell-tail", ell_cap=128)
    s = Session(dev)
    spec = ExecutionSpec(regime="outlined", algo=algo, fused=fused)
    with chunk.CHUNK_COUNTS.scope() as counts:
        a = s.run(spec, g)
        graphs = counts["graphs"]
        assert graphs > 0 and counts["reads"] == a.iterations
        wrapped = _build.KERNEL_LAUNCHES.as_dict()
        with chunk.REPLAYED_LAUNCHES.scope() as replayed:
            b = s.run(spec, g)
            assert all(replayed[k] > 0 for k in kernels)
        assert counts["graphs"] == graphs
        assert _build.KERNEL_LAUNCHES.as_dict() == wrapped
    h = s.run(dataclasses.replace(spec, regime="host"), g)
    c = repro_torch.color(g, algo=algo, fused=fused, outline=True,
                          device="cpu")
    for r in (b, c):
        np.testing.assert_array_equal(a.colors, r.colors)
        assert (a.n_colors, a.iterations, a.mode_trace, a.counts,
                a.host_dispatches) == (r.n_colors, r.iterations,
                                       r.mode_trace, r.counts,
                                       r.host_dispatches)
    np.testing.assert_array_equal(a.colors, h.colors)
    assert (a.n_colors, a.iterations, a.mode_trace) == \
        (h.n_colors, h.iterations, h.mode_trace)
    repro_torch.verify_coloring(g, a.colors)


def test_card_outlined_replay_is_sync_free(dev):
    """Every captured trip replays with CUDA's sync debug mode at
    "error"."""
    from repro_torch.exec import ExecutionSpec, Session
    g = repro_torch.get_dataset("europe_osm_s", scale=0.5, layout="auto")
    s = Session(dev)
    for algo, fused in (("ipgc", False), ("ipgc", True), ("jpl", None)):
        s.run(ExecutionSpec(regime="outlined", algo=algo, fused=fused), g)
    trips = [t for r in _outlined_runners(s, g) for t in r.trips.values()]
    assert len(trips) >= 3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for trip in trips:
            trip.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_card_color_outlined_equals_cpu(dev):
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.5,
                                layout="ell-tail", ell_cap=128)
    a = repro_torch.color_outlined(g)
    b = repro_torch.color_outlined(g, device="cpu")
    np.testing.assert_array_equal(a.colors, b.colors)
    assert (a.iterations, a.mode_trace, a.host_dispatches) == \
        (b.iterations, b.mode_trace, b.host_dispatches)


# ---------------------------------------------------------------------------
# lane batching and the stream service on the card
# ---------------------------------------------------------------------------

def _batch_graphs():
    return [repro_torch.get_dataset(n, scale=s, layout="ell-tail",
                                    ell_cap=128)
            for n, s in (("kron_g500-logn21_s", 0.5), ("europe_osm_s", 0.02),
                         ("hollywood-2009_s", 0.05), ("europe_osm_s", 0.005),
                         ("europe_osm_s", 0.004))]


def _lane_groups(session):
    """The lane groups ``session`` keeps in its run_batch entries."""
    return [entry[1] for key, entry in session.cache.items()
            if key[0] == "stack"]


@pytest.mark.parametrize("algo,fused,kernels", OUTLINED)
def test_card_run_batch_equals_cpu_and_solo(dev, algo, fused, kernels):
    """run_batch on the card: every lane equal to the CPU's run_batch in
    every field and to the card's solo run; the cold call captures one
    trip per lane group, the warm call captures nothing and replays; the
    kernels' launches come from the replays."""
    from repro_torch.exec import ExecutionSpec, Session, chunk
    graphs = _batch_graphs()
    s = Session(dev)
    spec = ExecutionSpec(regime="host", algo=algo, fused=fused)
    with chunk.CHUNK_COUNTS.scope() as counts:
        a = s.run_batch(spec, graphs)
        captured = counts["graphs"]
        assert captured == len(_lane_groups(s)) > 0
        with chunk.REPLAYED_LAUNCHES.scope() as replayed:
            b = s.run_batch(spec, graphs)
            assert all(replayed[k] > 0 for k in kernels)
        assert counts["graphs"] == captured
    c = Session("cpu").run_batch(spec, graphs)
    for g, ra, rb, rc in zip(graphs, a, b, c):
        for r in (rb, rc):
            np.testing.assert_array_equal(ra.colors, r.colors)
            assert (ra.n_colors, ra.iterations, ra.mode_trace, ra.counts) \
                == (r.n_colors, r.iterations, r.mode_trace, r.counts)
        solo = s.run(spec, g)
        np.testing.assert_array_equal(ra.colors, solo.colors)
        assert (ra.n_colors, ra.iterations, ra.mode_trace) == \
            (solo.n_colors, solo.iterations, solo.mode_trace)
        repro_torch.verify_coloring(g, ra.colors)


def test_card_lane_replays_are_sync_free(dev):
    """Every captured lane-group trip replays with CUDA's sync debug mode
    at "error" (after the runs: drained lanes make it a no-op)."""
    from repro_torch.exec import ExecutionSpec, Session
    s = Session(dev)
    for algo, fused in (("ipgc", False), ("ipgc", True), ("jpl", None)):
        s.run_batch(ExecutionSpec(regime="host", algo=algo, fused=fused),
                    _batch_graphs())
    trips = [t for st in _lane_groups(s) for t in st.trips.values()]
    assert len(trips) >= 3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for trip in trips:
            trip.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("algo", ["ipgc", "jpl", "spec-greedy"])
def test_card_stream_equals_cpu(dev, algo):
    """A ManualClock stream on the card equals the same stream on the CPU
    in every ticket and in stats(); lanes refill mid-stream, so lanes at
    different rounds (JPL: different round counters) share one trip."""
    from repro_torch.exec import ExecutionSpec, Session
    from repro_torch.serve import ManualClock, StreamConfig
    graphs = _batch_graphs()
    runs = []
    for device in (dev, "cpu"):
        stream = Session(device).stream(
            ExecutionSpec(regime="host", algo=algo, window=64),
            StreamConfig(lanes=2, chunk=3, clock=ManualClock(tick=0.25)))
        tickets = [stream.submit(g) for g in graphs + graphs[1:4]]
        stream.drain()
        stats = stream.stats()
        stats.pop("dispatch_seconds")
        runs.append((tickets, stats))
    (ta, sa), (tb, sb) = runs
    assert sa == sb
    assert any(tk.admit_round > 1 for tk in ta)
    fields = ("status", "reason", "admit_round", "drain_round", "chunks",
              "enqueue_s", "admit_s", "drain_s")
    for a, b in zip(ta, tb):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
        np.testing.assert_array_equal(a.result.colors, b.result.colors)
        assert (a.result.iterations, a.result.mode_trace) == \
            (b.result.iterations, b.result.mode_trace)


def test_card_failing_capture_raises(dev):
    """A trip that synchronises cannot be captured: the capture error
    reaches the caller, and nothing runs eagerly in its place."""
    from repro_torch.algos import get_algorithm
    from repro_torch.core import ipgc
    from repro_torch.exec import batch
    alg = get_algorithm("ipgc")
    g = repro_torch.get_dataset("europe_osm_s", scale=0.005,
                                layout="ell-tail", ell_cap=128)
    ig = ipgc.prepare(g, device=dev)
    sc = batch.shape_class_for([ig], 2048, 64, "ell-tail")
    st = batch.fresh_lane_state(sc, alg, 2, dev)
    st.admit(1, ig, 0, 100)
    dense = alg.lane_step(False)

    def syncing(ig_, colors, aux, wl, **kw):
        if int(wl.mask.sum()) < 0:          # a host read: no capture
            raise AssertionError
        return dense(ig_, colors, aux, wl, **kw)

    before = st.buf.colors.clone()
    with pytest.raises(RuntimeError):
        st.run(1, step=syncing, window=64, force_hub=False)
    torch.cuda.synchronize()
    assert torch.equal(st.buf.colors, before)
    assert st.host[:, 1].tolist() == [ig.n_nodes, 0, 0, 0]


def test_card_capture_refused_before_it_starts(dev, monkeypatch):
    """A trip whose reckoned intermediates are more than the card has free
    is refused with LaneMemoryError before its warm-up and capture: no
    graph is captured and the state is untouched. With room, the same
    group runs."""
    from repro_torch.algos import get_algorithm
    from repro_torch.core import ipgc
    from repro_torch.exec import batch
    alg = get_algorithm("ipgc")
    g = repro_torch.get_dataset("europe_osm_s", scale=0.005,
                                layout="ell-tail", ell_cap=128)
    ig = ipgc.prepare(g, device=dev)
    sc = batch.shape_class_for([ig], 2048, 64, "ell-tail")
    st = batch.fresh_lane_state(sc, alg, 2, dev)
    st.admit(1, ig, 0, 100)
    step = alg.lane_step(False)
    before = st.buf.colors.clone()
    monkeypatch.setattr(batch, "_free_bytes", lambda device: 1024)
    with pytest.raises(batch.LaneMemoryError, match="the trip of a lane "
                       r"group of 2 x .* \(trip "):
        st.run(1, step=step, window=64, force_hub=False)
    assert not st.trips
    torch.cuda.synchronize()
    assert torch.equal(st.buf.colors, before)
    monkeypatch.undo()
    assert st.run(1, step=step, window=64, force_hub=False) == 1
    assert len(st.trips) == 1


@pytest.mark.parametrize("exchange", ["boundary", "auto"])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("algo,fused", [("ipgc", True), ("ipgc", False),
                                        ("jpl", None)])
def test_card_boundary_exchange_equals_cpu(dev, algo, fused, n_shards,
                                           exchange):
    """The boundary exchange on S shards of one card equals S CPU shards
    in every field but the times (exchange trace and bytes included) and
    the dense exchange on the card in colors, iterations and mode trace;
    its steps replay without a host sync."""
    from repro_torch.algos import get_algorithm
    from repro_torch.core import distributed as dist
    from repro_torch.core.policy import exchange_threshold
    from repro_torch.graphs.partition import boundary_info
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.05,
                                layout="ell-tail", ell_cap=128)
    kw = dict(algo=algo, fused=fused, exchange=exchange)
    a = repro_torch.color_distributed(g, devices=[dev] * n_shards, **kw)
    b = repro_torch.color_distributed(g, devices=["cpu"] * n_shards, **kw)
    d = repro_torch.color_distributed(g, devices=[dev] * n_shards,
                                      algo=algo, fused=fused)
    np.testing.assert_array_equal(a.colors, b.colors)
    np.testing.assert_array_equal(a.colors, d.colors)
    assert (a.iterations, a.mode_trace, a.counts, a.exchange_trace,
            a.exchange_bytes) == (b.iterations, b.mode_trace, b.counts,
                                  b.exchange_trace, b.exchange_bytes)
    assert (a.iterations, a.mode_trace) == (d.iterations, d.mode_trace)
    # one dense and one sparse step under sync debug "error"
    alg = get_algorithm(algo)
    g2, _ = repro_torch.exec.default_session(dev).partition(g, n_shards)
    ig = repro_torch.prepare(g2, device=dev)
    mesh = (dev,) * n_shards
    info = boundary_info(g2, n_shards)
    dense, sparse = alg.make_dist_steps(
        ig, mesh, window=128, fused=alg.resolve_fused(fused, default=True),
        exchange=exchange, boundary=info,
        thresh=exchange_threshold(ig.n_nodes, n_shards, exchange))
    colors, aux, wl = dist.shard_state(mesh, *alg.init_state(ig))
    colors = dist.shard_views(colors)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in (dense, sparse):
            colors, aux, wl, xs = step(colors, aux, wl,
                                       bcap=info.capacities[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert xs.device.type == "cuda" and xs.shape == (2,)
    for v in colors:
        assert int(v[ig.n_nodes]) == repro_torch.core.ipgc.PAD_COLOR


@pytest.mark.parametrize("spec_kw", [
    dict(regime="host"), dict(regime="outlined", fused=True),
    dict(regime="dist", n_shards=4, exchange="auto")],
    ids=["host", "outlined", "dist"])
def test_card_traced_run_launches_what_untraced_launches(dev, spec_kw):
    """A traced run on the card launches the kernels an untraced run
    launches (its work profile's launches are scoped away) and equals it;
    its report's profile equals the CPU's."""
    from repro_torch.exec import ExecutionSpec, Session
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.05,
                                layout="ell-tail", ell_cap=128)
    spec = ExecutionSpec(**spec_kw)
    s = Session(dev)
    s.run(spec, g)                             # builds, captures
    runs = []
    for trace in (None, True, None):
        with _build.KERNEL_LAUNCHES.scope() as kl:
            r = s.run(spec, g, trace=trace)
            runs.append((r, kl.as_dict()))
    (plain, want), (rep, got), (_, again) = runs
    assert got == want == again
    np.testing.assert_array_equal(rep.colors, plain.colors)
    assert (rep.iterations, rep.mode_trace) == \
        (plain.iterations, plain.mode_trace)
    cpu = Session("cpu").run(spec, g, trace=True)
    assert (rep.launches, rep.gathers, rep.exchanges) == \
        (cpu.launches, cpu.gathers, cpu.exchanges)


@pytest.mark.parametrize("fused", [False, True], ids=["two-phase", "fused"])
def test_card_profiled_run_spans_have_device_times(dev, fused):
    """Under torch's profiler a host-loop run on the card hands back its
    spans (``ColoringResult.spans``), every one of them device-timed and
    in order, and colors as the untraced run does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.exec import ExecutionSpec, Session
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.05,
                                layout="ell-tail", ell_cap=128)
    spec = ExecutionSpec(regime="host", fused=fused)
    s = Session(dev)
    plain = s.run(spec, g)
    assert plain.spans is None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        r = s.run(spec, g)
    spans = list(r.spans.walk())
    assert {"session.iter", "session.count", "ipgc.hub", "ipgc.state",
            "ipgc.compact"} <= {sp.name for sp in spans}
    for sp in spans:
        assert sp.device_start is not None and sp.device_end is not None
        assert sp.device_end >= sp.device_start >= 0
    iters = r.spans.find("session.iter")
    assert len(iters) == r.iterations
    assert all(a.device_end <= b.device_start
               for a, b in zip(iters, iters[1:]))
    np.testing.assert_array_equal(r.colors, plain.colors)
    assert (r.iterations, r.mode_trace) == (plain.iterations,
                                           plain.mode_trace)


def test_card_outlined_capture_records_no_event(dev, monkeypatch):
    """A traced outlined run on a fresh session captures its trips; no
    span records a CUDA event while a stream is captured, the spans
    opened in a capture carry no device time, and the chunks' do."""
    from repro_torch.exec import ExecutionSpec, Session, chunk
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.05,
                                layout="ell-tail", ell_cap=128)
    spec = ExecutionSpec(regime="outlined", fused=True)
    real = torch.cuda.Event.record
    recorded = []

    def record(ev, stream=None):
        assert not torch.cuda.is_current_stream_capturing()
        recorded.append(1)
        return real(ev, stream)

    monkeypatch.setattr(torch.cuda.Event, "record", record)
    with chunk.CHUNK_COUNTS.scope() as counts:
        rep = Session(dev).run(spec, g, trace=True)
        assert counts["graphs"] > 0
    assert recorded
    chunks = rep.trace.find("session.chunk")
    assert chunks and all(sp.device_seconds is not None for sp in chunks)
    assert any(sp.device_seconds is None
               for sp in rep.trace.find("ipgc.compact"))
    plain = Session(dev).run(spec, g)
    np.testing.assert_array_equal(rep.colors, plain.colors)
    assert rep.mode_trace == plain.mode_trace


# --- the tile tuner and tile_rows --------------------------------------------

#: tiles of the row kernels: the tuner's candidates, one that is not a
#: power of two, one block of a single row, and tiles past the 1024 cap
_TILES = (1, 8, 32, 100, 128, 1024, 4096)


@pytest.mark.parametrize("tile", _TILES)
@pytest.mark.parametrize("rg,k,w", [(1, 1, 32), (257, 40, 128),
                                    (3000, 128, 256), (100, 3, 200)])
@pytest.mark.parametrize("sparse,hub", [(False, False), (True, True)])
def test_row_kernels_match_plain_at_every_tile(dev, tile, rg, k, w, sparse,
                                               hub):
    """The five row kernels the reference tiles give their plain twin's
    result at every ``tile_rows`` (``csrc/rows.cuh``: blocks of 32..1024
    threads), launching once each."""
    c = gather_case(rg + k + w + tile, rg, k, sparse=sparse, hub=hub,
                    window=w, lo=3)
    r = len(c["cu"])
    m = _gather_args(c, _MEX, dev)
    assert torch.equal(ops.mex_window(*m, w, tile).cpu(),
                       mex_window_rows_plain(*_cpu(m), w))
    for src in _jpl_sources(c, dev, tile + rg):
        a = (m[1], m[2], src)
        want = jpl_extrema_rows_plain(*_cpu(a[:2]), _source_cpu(src))
        assert all(torch.equal(x.cpu(), y) for x, y in
                   zip(ops.jpl_extrema(*a, tile), want))
    args = _gather_args(c, _CONFLICT, dev)
    assert torch.equal(ops.conflict(*args, tile).cpu(),
                       conflict_rows_plain(*_cpu(args)))
    fargs = _gather_args(c, _FUSED, dev)
    got = ops.fused_compact(*fargs, w, capacity=r, n_sentinel=c["n"],
                            tile_rows=tile)
    want = fused_compact_rows_plain(*_cpu(fargs), w, capacity=r,
                                    n_sentinel=c["n"])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    sargs = fargs[:8] + fargs[9:]
    got = ops.fused_step(*sargs, w, tile)
    want = fused_step_rows_plain(*_cpu(sargs), w)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_card_tuner_sweeps_and_persists(dev, tmp_path, monkeypatch):
    """The tuner on the card: ``cuda-sm90`` keys, every candidate timed
    on the kernel (each call some hundred microseconds), a memo hit, then
    the file read by a fresh memo; the sweep's launches are scoped away."""
    from repro_torch.kernels import tune
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "tune.json"))
    tune.clear_memo()
    try:
        with _build.KERNEL_LAUNCHES.scope() as kl:
            cfg = tune.get_tile_config("ell-tail", device=dev)
            assert not any(kl.as_dict().values())
        assert set(cfg.micros) == {"8", "32", "128"}
        assert all(v > 50 for v in cfg.micros.values())
        assert cfg.tile_rows in tune.CANDIDATES
        assert tune.get_tile_config("ell-tail", device=dev) is cfg
        tune.clear_memo()
        assert tune.get_tile_config("ell-tail", device=dev) == cfg
        key = tune.tune_key(tune.backend_name(dev), "ell-tail")
        assert key.startswith("cuda-sm")
        import json
        data = json.loads((tmp_path / "tune.json").read_text())
        assert data["entries"][key]["tile_rows"] == cfg.tile_rows
        assert tune.resolve_tile_rows("auto", "ell-tail", dev) == \
            cfg.tile_rows
        assert tune.resolve_tile_rows("auto", "csr-segment", dev) is None
    finally:
        tune.clear_memo()


def test_card_trips_are_keyed_by_tile(dev):
    """An outlined run and a run_batch at two tiles on one session: each
    tile captures its own trips, never replays the other's, and every run
    equals the default one."""
    from repro_torch.exec import ExecutionSpec, Session, chunk
    g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.25,
                                layout="ell-tail", ell_cap=128)
    s = Session(dev)
    base = s.run(ExecutionSpec(regime="host", fused=False, tile_rows=None),
                 g)
    for regime in ("outlined", "batch"):
        graphs = 0
        for tile in (8, 32, 8):
            spec = ExecutionSpec(regime="outlined" if regime == "outlined"
                                 else "host", fused=False, tile_rows=tile)
            with chunk.CHUNK_COUNTS.scope() as counts:
                r = (s.run(spec, g) if regime == "outlined"
                     else s.run_batch(spec, [g])[0])
                captured = counts["graphs"]
            graphs += captured
            np.testing.assert_array_equal(r.colors, base.colors)
            assert (r.iterations, r.mode_trace) == (base.iterations,
                                                    base.mode_trace)
            if tile == 32:
                assert captured > 0              # not the 8-tile trips
                first = graphs
        assert graphs == first                   # the second 8: replays
    tiles = {key[2] for r in _outlined_runners(s, g) for key in r.trips}
    assert tiles == {8, 32}
    lanes = {key[3] for st in _lane_groups(s) for key in st.trips}
    assert lanes == {8, 32}


# --- the LM serving path -------------------------------------------------------

def test_card_serve_defaults_to_the_card():
    """``serve`` without a device runs on the card; at a smoke config in
    fp32 (TF32 off) its prefill and first decode step equal the CPU's
    on the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    cfg = get_arch("qwen3-moe-30b-a3b").make_smoke()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        card = serve(cfg, batch=2, prompt_len=8, gen=3,
                     params={k: ({kk: vv.cuda() for kk, vv in v.items()}
                                 if isinstance(v, dict) else v.cuda())
                             for k, v in params.items()})
        assert card.tokens.device.type == "cuda"
        cpu_logits, cache = tfm.prefill(params, card.prompts.cpu(), cfg,
                                        max_len=11)
        np.testing.assert_allclose(card.prefill_logits.cpu().numpy(),
                                   cpu_logits.numpy(), rtol=1e-4, atol=1e-4)
        step, _ = tfm.decode_step(params, card.tokens[:, :1].cpu(), cache,
                                  cfg)
        np.testing.assert_allclose(card.step_logits.cpu().numpy(),
                                   step.numpy(), rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --- the LM training path ------------------------------------------------------

def _smoke_params(arch, seed=0):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    cfg = get_arch(arch).make_smoke()
    params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    return cfg, params


@pytest.mark.parametrize("arch,compress", [("qwen3-moe-30b-a3b", False),
                                           ("gemma-7b", False),
                                           ("gemma-7b", True)])
def test_card_train_step_equals_cpu(dev, arch, compress):
    """One ``build_step`` step on the card and on the CPU from the same
    weights, state and batch, fp32 with TF32 off, within
    ``tests/_train_check.py``'s tolerances."""
    from _train_check import step_gaps, to_device
    from repro_torch.data.pipelines import TokenPipeline
    from repro_torch.launch.train import build_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.compression import compress_init
    cfg, params = _smoke_params(arch)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    batch = TokenPipeline(cfg.vocab, 16, 4).batch_at(0, "cpu")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for where in ("cpu", dev):
            p = to_device(params, where)
            b = {k: v.to(where) for k, v in batch.items()}
            if compress:
                p, o, _, m = build_step(cfg, opt_cfg, compress=True,
                                        mesh=[where])(
                    p, adamw_init(p), [compress_init(p)], b)
            else:
                p, o, m = build_step(cfg, opt_cfg)(p, adamw_init(p), b)
            out[str(where)] = (p, o, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert out[str(dev)][2]["loss"].device.type == "cuda"
    step_gaps(out[str(dev)], out["cpu"], wd=opt_cfg.weight_decay,
              compressed=compress)


def test_card_train_resume_is_exact(dev, tmp_path, monkeypatch):
    """Under deterministic algorithms, 4 steps straight equal 2, a
    checkpoint, a restore into fresh state and 2 more: the same losses
    and parameters."""
    from _train_check import to_device
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves
    cfg, params = _smoke_params("minitron-4b", 1)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=4)
    kw = dict(batch=4, seq_len=16, log=lambda s: None)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        straight = train(cfg, opt_cfg, params=to_device(params, dev), **kw)
        first = train(cfg, opt_cfg, steps=2, ckpt_dir=str(tmp_path),
                      params=to_device(params, dev), **kw)
        second = train(cfg, opt_cfg, ckpt_dir=str(tmp_path),
                       params=to_device(params, dev), **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert second.start == 2 and len(straight.step_ms) == 4
    assert torch.equal(torch.cat([first.losses, second.losses]),
                       straight.losses)
    for a, b in zip(tree_leaves(second.params), tree_leaves(straight.params)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_card_train_defaults_to_the_card():
    """``train`` and ``TokenPipeline.batch_at`` without a device run on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch
    from repro_torch.data.pipelines import TokenPipeline
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves
    cfg = get_arch("gemma-7b").make_smoke()
    r = train(cfg, AdamWConfig(total_steps=2), batch=2, seq_len=8,
              log=lambda s: None)
    assert all(p.device.type == "cuda" for p in tree_leaves(r.params))
    assert r.init_s is not None and len(r.step_ms) == 2
    assert TokenPipeline(10, 4, 2).batch_at(0)["tokens"].device.type == \
        "cuda"


# --- the GNN and DLRM models --------------------------------------------------

@pytest.mark.parametrize("arch", ["equiformer-v2", "egnn", "schnet",
                                  "graphsage-reddit", "dlrm-rm2"])
def test_card_gnn_step_equals_cpu(dev, arch):
    """One smoke train step of each GNN/DLRM family on the card and on
    the CPU from the same params and batch, fp32 with TF32 off, within the
    CPU parity tests' tolerances (``tests/_gnn_steps.py``)."""
    from _gnn_steps import step_card_vs_cpu
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        step_card_vs_cpu(arch, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_card_sampler_and_pipeline_equal_cpu(dev):
    """``sample_blocks``, ``blocks_to_graphbatch`` and
    ``RecsysPipeline.batch_at`` on the card equal the CPU bit for bit;
    ``forward_full_owner`` at four shards on the card equals
    ``forward_full``."""
    from _gnn_steps import owner_card, pipeline_card_vs_cpu, \
        sampler_card_vs_cpu
    sampler_card_vs_cpu(dev)
    pipeline_card_vs_cpu(dev)
    owner_card(dev)


def test_card_gnn_defaults_to_the_card():
    """The GNN/DLRM entry points without a device run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch
    from repro_torch.data.pipelines import RecsysPipeline, prng_key
    from repro_torch.models import dlrm
    from repro_torch.models.gnn import schnet
    from repro_torch.models.gnn.common import random_graph_batch
    p, _ = schnet.init_params(get_arch("schnet").make_smoke())
    b = random_graph_batch(prng_key(0), 8, 16, 2, coords=True)
    assert schnet.forward(p, b, get_arch("schnet").make_smoke()).is_cuda
    p, _ = dlrm.init_params(get_arch("dlrm-rm2").make_smoke())
    assert p["tables"].is_cuda
    assert RecsysPipeline(3, 2, 10, 4).batch_at(0)["sparse"].is_cuda


# --- the step builders' cases (launch/steps.py) -------------------------------

@pytest.mark.parametrize("spec", _case_check.CASES,
                         ids=[_case_check.case_id(c)
                              for c in _case_check.CASES])
def test_card_case_equals_cpu(dev, spec):
    """Each family's case function at smoke size on the card = the CPU
    (``tests/_case_check.py``'s tolerances; the coloring step exactly)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _case_check.card_vs_cpu(spec, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_card_ipgc_case_runs_the_kernels(dev):
    """``ipgc_case``'s step drawn on the card launches ``mex_window``,
    ``conflict`` and ``compact``, and equals the same step through their
    plain twins there."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps
    shape = ShapeSpec("s", "coloring", dict(n_nodes=65536, ell_width=32))
    case = steps.case_for(steps.smoke_arch("paper-ipgc"), shape)
    assert case.args[0].ell_idx.device.type == "cuda"
    _build.KERNEL_LAUNCHES.reset()
    got = case.fn(*case.args)
    counts = _build.KERNEL_LAUNCHES.as_dict()
    assert all(counts[k] > 0 for k in ("mex_window", "conflict", "compact"))
    with _case_check.plain_kernels():
        want = case.fn(*case.args)
    assert _case_check.coloring_equal(got, want)


def test_card_cases_default_to_the_card(dev):
    from repro_torch.launch import steps
    case = steps.build_case("dlrm-rm2", "serve_p99")
    assert case.args[1].device.type == "cuda"
    assert case.fn(*case.args).shape == (512,)


# --- the int8 decode's kernel and the bf16 attention products -----------------

#: (B, S, Hk, G, D): smoke shapes, full-width heads (Minitron, Qwen3,
#: Gemma, Nemotron), G past the kernel's 16 rows a pass, a tail of S
Q8_SHAPES = ((2, 9, 2, 4, 8), (1, 4099, 8, 3, 128), (8, 96, 4, 8, 128),
             (1, 1000, 16, 1, 256), (1, 777, 8, 12, 192), (3, 77, 2, 20, 32))


@pytest.mark.parametrize("shape", Q8_SHAPES)
@pytest.mark.parametrize("fill", [None, 127])
def test_q8_dot_matches_plain(dev, shape, fill):
    """Exactly, random and at the int8 extremes; one scores launch and one
    values launch a pass of 16 query rows."""
    from repro_torch.kernels import q8_dot
    b, s, hk, g, d = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape))

    def rnd(*sh):
        if fill is not None:
            return torch.full(sh, fill, dtype=torch.int8, device=dev)
        return torch.randint(-127, 128, sh, generator=gen, device=dev,
                             dtype=torch.int16).to(torch.int8)

    qq, k, pq, v = rnd(b, hk, g, d), rnd(b, s, hk, d), rnd(b, hk, g, s), \
        rnd(b, s, hk, d)
    before = _build.KERNEL_LAUNCHES["q8_dot"]
    got = (ops.q8_scores(qq, k), ops.q8_values(pq, v))
    assert _build.KERNEL_LAUNCHES["q8_dot"] - before == 1 + -(-g // 16)
    assert torch.equal(got[0], q8_dot.scores_plain(qq, k))
    assert torch.equal(got[1], q8_dot.values_plain(pq, v))


def test_q8_values_wrap_as_the_plain_twin(dev):
    """127 * 127 * 140,000 passes 2^31: the int32 sums wrap alike."""
    from repro_torch.kernels import q8_dot
    s = 140_000
    pq = torch.full((1, 8, 3, s), 127, dtype=torch.int8, device=dev)
    v = torch.full((1, s, 8, 128), -127, dtype=torch.int8, device=dev)
    got = ops.q8_values(pq, v)
    assert torch.equal(got, q8_dot.values_plain(pq, v))
    assert int(got[0, 0, 0, 0]) == (-127 * 127 * s + 2**31) % 2**32 - 2**31


#: a bf16 product against its float32 twin: the products of two bf16
#: values are exact in float32 and only the order of the sums differs, but
#: the float32 path keeps the float32 probabilities where the card's casts
#: them to bf16 (the reference's ``p.astype(v.dtype)``), 2^-9 relative a
#: term; outputs are compared in bf16, one more rounding. About twice the
#: largest reading of these comparisons on an H100 80GB HBM3 at 700 W: the
#: least rtol = atol that passes was 7.8e-4 / 2.4e-3 (decode, b = 1 / 3)
#: and 2.6e-3 / 3.0e-3 (flash)
ATTN_BF16_TOL = dict(rtol=6e-3, atol=6e-3)
#: the gradients' relative RMS against the float32 path's: about twice the
#: readings there, 3.0e-3, 3.1e-3 and 2.3e-3 (q, k, v)
ATTN_GRAD_REL = 6e-3


@pytest.mark.parametrize("b", [1, 3])
def test_attention_bf16_products_match_float32(dev, b):
    from repro_torch.models import attention as tatt
    gen = torch.Generator(device=dev).manual_seed(b)
    q, k, v = (torch.randn(sh, generator=gen, device=dev)
               for sh in ((b, 256, 8, 64), (b, 256, 2, 64), (b, 256, 2, 64)))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    q32, k32, v32 = qb.float(), kb.float(), vb.float()
    cl = torch.tensor([256, 100, 7][:b], device=dev)
    torch.testing.assert_close(
        tatt.decode_attention(qb[:, :1], kb, vb, cl).float(),
        tatt.decode_attention(q32[:, :1], k32, v32, cl), **ATTN_BF16_TOL)
    kw = dict(q_chunk=64, k_chunk=128)
    torch.testing.assert_close(
        tatt.flash_attention(qb, kb, vb, **kw).float(),
        tatt.flash_attention(q32, k32, v32, **kw), **ATTN_BF16_TOL)


def test_flash_attention_bf16_gradient(dev):
    """The gradient through the bf16 products (``_MixedBmm``, recomputed
    under the checkpoints): finite, bf16, within ``ATTN_GRAD_REL`` of the
    float32 path's."""
    from repro_torch.models import attention as tatt
    gen = torch.Generator(device=dev).manual_seed(0)
    base = [torch.randn(sh, generator=gen, device=dev).bfloat16()
            for sh in ((2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64))]
    grads = {}
    for dt in (torch.bfloat16, torch.float32):
        leaves = [t.to(dt).requires_grad_() for t in base]
        o = tatt.flash_attention(*leaves, q_chunk=64, k_chunk=128)
        grads[dt] = torch.autograd.grad(o.float().pow(2).sum(), leaves)
    for a, w in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        assert float((a.float() - w).norm() / w.norm()) <= ATTN_GRAD_REL


# --- the hub side-channel's kernels --------------------------------------------

#: the hub cases: the kron tail (sorted), the same tail shuffled, two padded
#: batch lanes, the forced side-channel of a hubless graph (T = 8, all
#: invalid, n_hub = 0) and one hub of degree > 100,000
HUB_CASES = ("kron", "unsorted", "padded", "forced", "big_hub")
_HUB: dict = {}


def _hub_operands(case):
    """(tail_src, tail_dst, tail_valid, hub_slot, priority, n_hub) on the
    CPU."""
    from repro_torch.core import ipgc
    if case in _HUB:
        return _HUB[case]
    kron = dict(scale=1, layout="ell-tail", ell_cap=128)
    if case in ("kron", "unsorted"):
        ig = ipgc.prepare(repro_torch.get_dataset(
            "kron_g500-logn21_s", **kron), device="cpu")
    elif case == "padded":
        parts = [ipgc.prepare(repro_torch.get_dataset(
            "kron_g500-logn21_s", scale=0.25, layout=lay), device="cpu")
            for lay in ("ell-tail", "hub-split")]
        ig = ipgc.padded_graph(
            max(p.n_nodes for p in parts) + 3,
            max(p.ell_width for p in parts),
            max(p.tail_src.shape[0] for p in parts) + 5,
            max(p.n_hub for p in parts) + 1, lanes=2, device="cpu")
        for lane, p in enumerate(parts):
            ipgc.pad_into(p, ig, lane, 2)
    elif case == "forced":
        ig = ipgc.prepare(repro_torch.get_dataset(
            "europe_osm_s", scale=0.02, layout="pure-ell"), device="cpu")
    if case != "big_hub":
        ops_ = (ig.tail_src, ig.tail_dst, ig.tail_valid, ig.hub_slot,
                ig.priority, ig.n_hub)
        if case == "unsorted":
            perm = torch.randperm(ig.tail_src.shape[0],
                                  generator=torch.Generator().manual_seed(1))
            ops_ = tuple(t[perm] for t in ops_[:3]) + ops_[3:]
    else:
        n, hub, deg = 200_003, 7, 150_001
        gen = torch.Generator().manual_seed(2)
        dst = torch.randperm(n - 1, generator=gen)[:deg]
        dst = torch.sort(dst + (dst >= hub).long()).values.int()
        pad = 6
        src = torch.full((deg + pad,), hub, dtype=torch.int32)
        src[deg:] = n - 1
        dst = torch.cat([dst, torch.full((pad,), n, dtype=torch.int32)])
        valid = torch.arange(deg + pad) < deg
        hub_slot = torch.ones(n, dtype=torch.int32)
        hub_slot[hub] = 0
        prio = torch.randint(0, 1 << 20, (n + 1,), generator=gen,
                             dtype=torch.int32)
        prio[n] = -1
        ops_ = (src, dst, valid, hub_slot, prio, 1)
    _HUB[case] = ops_
    return ops_


def _hub_state(n, window, gate, seed):
    gen = torch.Generator().manual_seed(seed)
    colors = torch.randint(-1, 3 * window, (n + 1,), generator=gen,
                           dtype=torch.int32)
    colors[n] = -2
    base = torch.randint(0, 2 * window, (n,), generator=gen,
                         dtype=torch.int32)
    if gate == "on":
        on = torch.ones(n, dtype=torch.bool)
    elif gate == "off":
        on = torch.zeros(n, dtype=torch.bool)
    else:
        on = torch.rand(n, generator=gen) < 0.5
    return colors, base, on


@pytest.mark.parametrize("gate", ["on", "off", "random"])
@pytest.mark.parametrize("window", [1, 256])
@pytest.mark.parametrize("case", HUB_CASES)
def test_hub_kernels_match_plain(dev, case, window, gate):
    """Both hub kernels equal their plain twins byte for byte, and count
    the entries their gate lets through as the twins do; one launch each
    (none for an empty tail)."""
    from repro_torch.kernels.hub import hub_forbidden_plain, hub_lose_plain
    src, dst, valid, hub_slot, prio, n_hub = _hub_operands(case)
    n = hub_slot.shape[0]
    colors, base, on = _hub_state(n, window, gate, seed=window)
    tail = (src, dst, valid, hub_slot)
    card = [t.to(dev) for t in (*tail, colors, base, on, prio)]
    seen = [torch.zeros(1, dtype=torch.int64, device=d)
            for d in (dev, "cpu")]
    before = _build.KERNEL_LAUNCHES["hub"]
    got = ops.hub_forbidden(*card[:7], window, n_hub, seen[0])
    want = hub_forbidden_plain(*tail, colors, base, on, window, n_hub,
                               seen[1])
    assert torch.equal(got.cpu(), want)
    assert int(seen[0]) == int(seen[1])
    seen[0].zero_()
    seen[1].zero_()
    got = ops.hub_lose(*card[:5], card[7], card[6], n_hub, seen[0])
    want = hub_lose_plain(*tail, colors, prio, on, n_hub, seen[1])
    assert torch.equal(got.cpu(), want)
    assert int(seen[0]) == int(seen[1])
    assert _build.KERNEL_LAUNCHES["hub"] == before + 2
    if gate == "on" and case != "forced":
        assert bool(ops.hub_forbidden(*card[:7], window, n_hub).any())


def test_hub_kernels_replay_in_a_cuda_graph(dev):
    """Both kernels captured (no counter) and replayed on new colors and
    gates equal their plain twins."""
    from repro_torch.kernels.hub import hub_forbidden_plain, hub_lose_plain
    src, dst, valid, hub_slot, prio, n_hub = _hub_operands("kron")
    n, window = hub_slot.shape[0], 32
    tail = (src, dst, valid, hub_slot)
    card = [t.to(dev) for t in tail]
    colors, base, on = (t.to(dev) for t in _hub_state(n, window, "on", 0))
    prio_d = prio.to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.hub_forbidden(*card, colors, base, on, window, n_hub)
        ops.hub_lose(*card, colors, prio_d, on, n_hub)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        forb = ops.hub_forbidden(*card, colors, base, on, window, n_hub)
        lose = ops.hub_lose(*card, colors, prio_d, on, n_hub)
    for seed, gate in ((3, "random"), (4, "on"), (5, "off")):
        c, b, g = _hub_state(n, window, gate, seed)
        colors.copy_(c)
        base.copy_(b)
        on.copy_(g)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(forb.cpu(), hub_forbidden_plain(
            *tail, c, b, g, window, n_hub))
        assert torch.equal(lose.cpu(), hub_lose_plain(
            *tail, c, prio, g, n_hub))


def test_hub_wrappers_reject_bad_operands(dev):
    src = torch.zeros(8, dtype=torch.int32, device=dev)
    dst = torch.full((8,), 4, dtype=torch.int32, device=dev)
    valid = torch.zeros(8, dtype=torch.bool, device=dev)
    slot = torch.zeros(4, dtype=torch.int32, device=dev)
    colors = torch.zeros(5, dtype=torch.int32, device=dev)
    base = torch.zeros(4, dtype=torch.int32, device=dev)
    gate = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="windows of 1..256"):
        ops.hub_forbidden(src, dst, valid, slot, colors, base, gate, 512, 0)
    with pytest.raises(TypeError, match="int32"):
        ops.hub_forbidden(src.long(), dst, valid, slot, colors, base, gate,
                          32, 0)
    with pytest.raises(ValueError, match="shape"):
        ops.hub_lose(src, dst, valid, slot, colors, colors, gate[:3], 0)
    with pytest.raises(ValueError, match="on cuda"):
        ops.hub_lose(src, dst, valid, slot.cpu(), colors, colors, gate, 0)
    with pytest.raises(TypeError, match="int64"):
        ops.hub_lose(src, dst, valid, slot, colors, colors, gate, 0,
                     torch.zeros(1, dtype=torch.int32, device=dev))
    # the kernels' 4-entry loads need whole (aligned) tail arrays
    wide = torch.zeros(9, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="tail_src: expected a 16-byte"):
        ops.hub_forbidden(wide[1:], dst, valid, slot, colors, base, gate, 32,
                          0)
    with pytest.raises(ValueError, match="tail_dst: expected a 16-byte"):
        ops.hub_lose(src, wide[1:], valid, slot, colors, colors, gate, 0)
    flags = torch.zeros(9, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="tail_valid: expected a 4-byte"):
        ops.hub_lose(src, dst, flags[1:], slot, colors, colors, gate, 0)
