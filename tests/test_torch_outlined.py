"""The outlined regime's contracts on the CPU (``tests/test_outlined.py``'s
counterparts; its Pallas cases have none, the port has no ``impl`` knob):
the policies' device thresholds and the chunk bounds against ``repro``,
the degenerate graphs, the outline toggle, ``color(outline=True)``, the
dispatch bound, the auto policy, the chunk's counters and the device
rule."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro.core import policy as jpolicy
from repro.core.worklist import chunk_lower_bounds as j_chunk_lower_bounds
from repro_torch.algos import get_algorithm
from repro_torch.core import engine, policy
from repro_torch.core.worklist import bucket_capacities, chunk_lower_bounds
from repro_torch.exec import ExecutionSpec, Session, spec_for
from repro_torch.exec import chunk
from repro_torch.graphs import build_graph, get_dataset

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return {n: get_dataset(n, scale=0.02) for n in
            ("europe_osm_s", "kron_g500-logn21_s", "hollywood-2009_s")}


def _knee(count, n):
    """A plain monotone callable: dense above a third of the nodes."""
    return 3 * count > n


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 2**21])
def test_device_thresholds_match_reference(n):
    pairs = [(policy.FixedH(0.6), jpolicy.FixedH(0.6)),
             (policy.FixedH(0.0), jpolicy.FixedH(0.0)),
             (policy.AlwaysDense(), jpolicy.AlwaysDense()),
             (policy.AlwaysSparse(), jpolicy.AlwaysSparse()),
             (policy.AutoTuned(0.45), jpolicy.AutoTuned(0.45)),
             (policy.AutoTuned(0.6, 2e-3, 1e-8),
              jpolicy.AutoTuned(0.6, 2e-3, 1e-8)),
             (policy.AutoTuned(0.6, 2e-3, 1e-3),
              jpolicy.AutoTuned(0.6, 2e-3, 1e-3)),
             (_knee, _knee), (lambda c, m: True, lambda c, m: True),
             (lambda c, m: False, lambda c, m: False)]
    for mine, theirs in pairs:
        t = policy.device_threshold(mine, n)
        assert t == jpolicy.device_threshold(theirs, n)
        if hasattr(mine, "threshold"):
            assert mine.threshold(n) == theirs.threshold(n) == t
        # the device form decides like the policy on every count <= n
        if not isinstance(mine, policy.AutoTuned):
            for count in {0, 1, n // 3, n // 3 + 1, n}:
                if count <= n:
                    assert (count > t) == bool(mine(count, n))


@pytest.mark.parametrize("ratio", [2, 4])
@pytest.mark.parametrize("n", [1, 8, 1024, 1025, 100_000, 2**21])
def test_chunk_lower_bounds_match_reference(n, ratio):
    caps = bucket_capacities(n, ratio=ratio)
    assert chunk_lower_bounds(caps) == j_chunk_lower_bounds(caps)
    assert chunk_lower_bounds(caps)[-1] == 0


def test_observe_chunk_matches_reference():
    mine, theirs = policy.AutoTuned(0.5), jpolicy.AutoTuned(0.5)
    for nd, ns, mean, secs in [(3, 0, 900.0, 0.03), (1, 4, 300.5, 0.02),
                               (0, 0, 10.0, 1.0), (2, 2, 0.4, 0.01),
                               (0, 7, 55.0, 0.07)]:
        mine.observe_chunk(nd, ns, mean, secs)
        theirs.observe_chunk(nd, ns, mean, secs)
        assert (mine.dense_cost, mine.sparse_unit) == \
            (theirs.dense_cost, theirs.sparse_unit)
        assert mine.threshold(5000) == theirs.threshold(5000)


def test_outlined_edge_cases():
    one = build_graph(np.array([0]), np.array([0]), 1, name="one")
    empty = build_graph(np.array([3]), np.array([3]), 8, name="empty")
    r = repro_torch.color_outlined_hybrid(one, device="cpu")
    assert repro_torch.coloring_stats(one, r.colors) == {
        "conflicts": 0, "uncolored": 0, "n_colors": 1}
    r = repro_torch.color_outlined_hybrid(empty, device="cpu")
    v = repro_torch.coloring_stats(empty, r.colors)
    assert v["conflicts"] == 0 and v["uncolored"] == 0 and v["n_colors"] == 1
    for g in (one, empty):
        np.testing.assert_array_equal(
            repro_torch.color_outlined_hybrid(g, device="cpu").colors,
            repro_torch.color(g, mode="hybrid", fused=True, outline=False,
                              device="cpu").colors)
    # the reference agrees on the degenerate graphs
    from repro.graphs import build_graph as jbuild
    for src, n in (([0], 1), ([3], 8)):
        jg = jbuild(np.array(src), np.array(src), n, name="g")
        tg = build_graph(np.array(src), np.array(src), n, name="g")
        want = jcore.color_outlined_hybrid(jg, impl="jnp")
        got = repro_torch.color_outlined_hybrid(tg, device="cpu")
        np.testing.assert_array_equal(got.colors, want.colors)
        assert (got.iterations, got.mode_trace, got.counts,
                got.host_dispatches) == (want.iterations, want.mode_trace,
                                         want.counts, want.host_dispatches)


def test_set_outline_default_toggles_after_import(graphs):
    """``outlined`` takes effect at once on ``color(outline=None)``,
    nests, and leaks nothing past its block."""
    g = graphs["europe_osm_s"]
    baseline = engine.outline_default()
    with repro_torch.outlined(True):
        assert engine.outline_default() is True
        assert spec_for().regime == "outlined"
        r_on = repro_torch.color(g, mode="hybrid", device="cpu")
        assert r_on.host_dispatches < r_on.iterations
        with repro_torch.outlined(False):
            assert engine.outline_default() is False
            assert spec_for().regime == "host"
            r_off = repro_torch.color(g, mode="hybrid", device="cpu")
            assert r_off.host_dispatches == r_off.iterations
        assert engine.outline_default() is True
    np.testing.assert_array_equal(r_on.colors, r_off.colors)
    assert engine.outline_default() is baseline
    repro_torch.set_outline_default(True)
    try:
        assert spec_for(outline=None).regime == "outlined"
        assert spec_for(outline=False).regime == "host"
        assert spec_for(mode="dist-hybrid").regime == "dist"
    finally:
        repro_torch.set_outline_default(None)
    assert engine.outline_default() is baseline


def test_outline_env_flag_is_read_at_import():
    code = ("import repro_torch as rt; "
            "from repro_torch.core import engine; "
            "print(engine.outline_default(), "
            "rt.exec.spec_for().regime)")
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    env = dict(os.environ, REPRO_OUTLINE_HYBRID="1", PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["True", "outlined"]


def test_outline_flag_on_color(graphs):
    """``color(outline=True)`` is the outlined regime with its CPU family
    (two-phase) for ``fused=None``."""
    g = graphs["kron_g500-logn21_s"]
    r_flag = repro_torch.color(g, mode="hybrid", outline=True, device="cpu")
    r_direct = repro_torch.color_outlined_hybrid(g, fused=False,
                                                 device="cpu")
    np.testing.assert_array_equal(r_flag.colors, r_direct.colors)
    assert (r_flag.host_dispatches, r_flag.counts, r_flag.mode_trace) == \
        (r_direct.host_dispatches, r_direct.counts, r_direct.mode_trace)


@pytest.mark.parametrize("ratio", [2, 4])
def test_outlined_dispatch_bound(ratio):
    """At most len(caps) + 1 host dispatches, one per iteration for the
    host loop; a graph big enough for several buckets."""
    g = get_dataset("kron_g500-logn21_s", scale=0.1)
    r = repro_torch.color_outlined_hybrid(g, bucket_ratio=ratio,
                                          device="cpu")
    caps = bucket_capacities(g.n_nodes, ratio=ratio)
    assert len(caps) > 2
    assert r.host_dispatches == len(r.counts) <= len(caps) + 1
    r_host = repro_torch.color(g, mode="hybrid", fused=False, outline=False,
                               bucket_ratio=ratio, device="cpu")
    assert r_host.host_dispatches == r_host.iterations
    assert r.host_dispatches < r_host.host_dispatches
    assert r.iterations == r_host.iterations


def test_outlined_hybrid_auto_policy(graphs):
    for g in graphs.values():
        r = repro_torch.color_outlined_hybrid(g, mode="hybrid-auto",
                                              device="cpu", collect_tti=True)
        repro_torch.verify_coloring(g, r.colors)
        assert len(r.tti) == len(r.counts) == r.host_dispatches


def test_chunk_reads_the_counters_once_per_trip(graphs):
    g = graphs["hollywood-2009_s"]
    with chunk.CHUNK_COUNTS.scope() as c:
        r = repro_torch.color_outlined_hybrid(g, algo="jpl", device="cpu")
        assert c["chunks"] == r.host_dispatches
        assert c["reads"] == r.iterations
        assert c["graphs"] == 0          # no CUDA graph on the CPU


def test_chunk_runner_state_and_branches(graphs):
    """One chunk per branch on the runner's static buffers: the counters
    count the trips of each kind, and a chunk stops at its low bound."""
    g = graphs["kron_g500-logn21_s"]
    alg = get_algorithm("ipgc")
    ig = repro_torch.prepare(g, device="cpu")
    n = ig.n_nodes
    runner = chunk.ChunkRunner(ig, alg, fused=False, window=32,
                               force_hub=False, capacity=n)
    runner.reset()
    c = runner.run(n, branch="dense", thresh=-1, low=n // 2, max_iter=100,
                   count=n, it=0)
    assert c.nd >= 1 and c.ns == 0 and c.it == c.nd and c.count <= n // 2
    d = runner.run(n, branch="cond", thresh=c.count, low=0, max_iter=c.it + 3,
                   count=c.count, it=c.it)
    assert d.nd == 0 and d.ns + c.it == d.it <= c.it + 3
    assert runner.state.ctr.tolist() == [d.count, d.nd, d.it, d.ns]
    with pytest.raises(ValueError, match="branch"):
        runner.run(n, branch="both", thresh=0, low=0, max_iter=1,
                   count=1, it=0)


def test_session_reuses_outlined_runners(graphs):
    g = graphs["europe_osm_s"]
    s = Session("cpu")
    a = s.run(ExecutionSpec(regime="outlined"), g)
    (entry,) = s.cache.values()
    runners = dict(entry[3])
    b = s.run(ExecutionSpec(regime="outlined"), g)
    assert entry[3] == runners and len(runners) == 1
    np.testing.assert_array_equal(a.colors, b.colors)
    # a prepared graph keeps its runners in an entry of their own
    ig = repro_torch.prepare(g, device="cpu")
    spec = ExecutionSpec(regime="outlined", window=engine.adaptive_window(g))
    c = s.run(spec, ig)
    s.run(spec, ig)
    assert s.stats.misses == 2
    np.testing.assert_array_equal(c.colors, a.colors)


def test_outlined_needs_cuda_by_default(monkeypatch, graphs):
    """No silent CPU run: the outlined regime's default device is the
    card, as the host loop's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graphs["europe_osm_s"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.color(g, outline=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.color_outlined_hybrid(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.color_outlined(g)
