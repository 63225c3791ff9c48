"""The port's CUDA kernels on the card: each against its plain version
(the row kernels at every ``tile_rows`` too), the tile tuner, and
colorings (host loop, outlined regime, distributed Pipe with the dense
and the boundary exchange, traced runs, lane batching and the stream
service, trips keyed by tile) and BFS on the card against the same runs
on the CPU; the LM serving path's default device.
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
from repro_torch.kernels.jpl_prio import jpl_extrema_plain
from repro_torch.kernels.mex_window import mex_window_plain

from _gather_cases import gather_case

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


@pytest.mark.parametrize("r,k,w", [(1, 1, 32), (7, 8, 128), (257, 40, 256),
                                   (3000, 128, 64), (100, 3, 200)])
@pytest.mark.parametrize("hub", [False, True])
def test_row_kernels_match_plain(dev, r, k, w, hub):
    rng = np.random.default_rng(r + k + w + hub)
    nc = rng.integers(-2, 300, size=(r, k)).astype(np.int32)
    base = (rng.integers(0, 4, size=r) * w).astype(np.int32)
    extra = (rng.random((r, w)) < 0.25) if hub else None
    m = [_t(a, dev) for a in (nc, base, extra)]
    assert torch.equal(ops.mex_window(*m, w), mex_window_plain(*m, w))


def _gather_args(c, names, dev):
    return [_t(c[name], dev) for name in names]


def _cpu(ts):
    return [None if a is None else a.cpu() for a in ts]


_CONFLICT = ("colors", "priority", "ell", "rows", "cu", "pu", "ids", "newly")
_FUSED = ("colors", "priority", "ell", "rows", "base", "cu", "pu", "ids",
          "active", "pending", "hub_forb", "hub_lose", "hub_slot")


@pytest.mark.parametrize("rg,k", [(0, 8), (1, 8), (7, 8), (40, 16),
                                  (100, 40), (257, 128), (3000, 128),
                                  (100, 3), (50, 12)])
@pytest.mark.parametrize("w", [1, 32, 256])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("hub", [False, True])
def test_gather_kernels_match_plain(dev, rg, k, w, sparse, hub):
    """conflict and fused_compact, which gather the neighbours themselves,
    against their plain twins: rows None or sparse with sentinels, hub and
    no-hub, rows of length 0, < K and K, R = 0, truncating capacities, and
    an unaligned ELL tile (the one-entry loads)."""
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
    nc = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    base = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="windows of 1..256"):
        ops.mex_window(nc, base, None, 512)
    with pytest.raises(TypeError, match="int32"):
        ops.mex_window(nc.long(), base, None, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mex_window(nc.t().contiguous().t(), base, None, 32)


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
    rng = np.random.default_rng(r * 3 + k)
    npr = rng.integers(0, 2**31 - 1, size=(r, k)).astype(np.int32)
    npr = np.where(rng.random((r, k)) < inactive, -1, npr).astype(np.int32)
    x = _t(npr, dev)
    before = _build.KERNEL_LAUNCHES["jpl_prio"]
    got, want = ops.jpl_extrema(x), jpl_extrema_plain(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.KERNEL_LAUNCHES["jpl_prio"] == before + 1
    # a tile that is not 16-byte aligned takes the one-entry loads
    if r > 1 and k % 4 == 0:
        y = x.reshape(-1)[1:].reshape(-1)[:(r - 1) * k].reshape(r - 1, k)
        got, want = ops.jpl_extrema(y), jpl_extrema_plain(y)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


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
    rng = np.random.default_rng(tile + rg)
    nc = rng.integers(-2, 300, size=(r, k)).astype(np.int32)
    base = (rng.integers(0, 4, size=r) * w).astype(np.int32)
    extra = (rng.random((r, w)) < 0.25) if hub else None
    m = [_t(a, dev) for a in (nc, base, extra)]
    assert torch.equal(ops.mex_window(*m, w, tile), mex_window_plain(*m, w))
    npr = _t(np.where(rng.random((r, k)) < 0.3, -1, nc), dev)
    assert all(torch.equal(a, b) for a, b in
               zip(ops.jpl_extrema(npr, tile), jpl_extrema_plain(npr)))
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
