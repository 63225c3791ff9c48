"""Traced runs of the port (``Session.run(trace=)``, ``color(trace=)``)
against ``repro``'s (``tests/test_obs.py``): on the same graph the port's
``RunReport`` equals the reference's in every deterministic field — the
result's fields, the per-iteration launch, gather and exchange profiles
with their totals, the dist exchange ledger and the cache run delta —
in the host, outlined and dist regimes; a traced run's colors, counter
deltas and device reads equal an untraced run's; the spans never
synchronize with the device; and the report's pure helpers equal the
reference's. Timing is excluded: it is measured, not computed."""
import json

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.obs.report as jreport
from repro.exec import ExecutionSpec as JSpec
from repro.exec import Session as JSession
from repro.graphs import get_dataset as jget
import repro_torch
import repro_torch.obs.report as treport
from repro_torch.core import distributed as tdist
from repro_torch.core import ipgc
from repro_torch.core.policy import measure_launches
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.graphs import get_dataset as tget
from repro_torch.kernels._build import KERNEL_LAUNCHES
from repro_torch.obs import RunReport, Trace

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

#: (algo, fused) of every step family
FAMILIES = [("ipgc", True), ("ipgc", False), ("spec-greedy", None),
            ("jpl", None)]
FIELDS = ("regime", "algo", "graph", "n_nodes", "n_colors", "iterations",
          "mode_trace", "host_dispatches", "counts", "launches", "gathers",
          "exchanges")
_GRAPHS: dict = {}


def _graphs(name="kron_g500-logn21_s", scale=0.01, layout="ell-tail"):
    key = (name, scale, layout)
    if key not in _GRAPHS:
        _GRAPHS[key] = (jget(name, scale=scale, layout=layout),
                        tget(name, scale=scale, layout=layout))
    return _GRAPHS[key]


def _same_report(got, want, *, partition_lookups: int = 0):
    """Field for field; the port's dist regime also looks its partition up
    in the session cache (``Session.partition``), the reference has no
    such entry."""
    assert isinstance(got, RunReport)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.colors, want.colors)
    delta = dict(want.cache["run_delta"])
    delta["hits"] += partition_lookups
    assert got.cache["run_delta"] == delta
    assert set(got.timing) == set(want.timing)
    assert set(got.to_json()) == set(want.to_json())
    json.dumps(got.to_json(include_chrome=True))


def _runs(spec_kw):
    """An untraced then a traced run on a fresh session of each side:
    ``(port session, port untraced, port report, reference report)``."""
    jg, tg = _graphs()
    js, ts = JSession(), Session("cpu")
    jspec, tspec = JSpec(**spec_kw), ExecutionSpec(**spec_kw)
    js.run(jspec, jg)
    tplain = ts.run(tspec, tg)
    want = js.run(jspec, jg, trace=True)
    got = ts.run(tspec, tg, trace=True)
    return ts, tplain, got, want


@pytest.mark.parametrize("algo,fused", FAMILIES)
@pytest.mark.parametrize("regime", ["host", "outlined"])
def test_local_report_matches_reference(regime, algo, fused):
    s, plain, got, want = _runs(dict(regime=regime, window=64, algo=algo,
                                     fused=fused))
    _same_report(got, want)
    # the result passthrough equals the untraced run
    np.testing.assert_array_equal(got.colors, plain.colors)
    assert (got.mode_trace, got.iterations, got.counts) == \
        (plain.mode_trace, plain.iterations, plain.counts)
    # the cache section IS the session's CacheStats snapshot
    assert {k: got.cache[k] for k in ("hits", "misses", "evictions",
                                      "hit_rate")} == s.stats.as_dict()
    t = got.timing
    assert t["dispatches"] == got.host_dispatches
    assert t["dispatch_seconds"] <= t["total_seconds"] + 1e-9
    assert t["compile_proxy_seconds"] >= 0
    # one span per host dispatch
    span = "session.iter" if regime == "host" else "session.chunk"
    assert len(got.trace.find(span)) == got.host_dispatches
    assert len(got.trace.find("session.prepare")) == 1
    assert len(got.trace.find("obs.profile")) == 1
    (root,) = got.trace.spans
    assert root.name == "session.run" and root.attrs["regime"] == regime


def test_host_launches_equal_measure_launches():
    _, _, got, _ = _runs(dict(regime="host", window=64))
    _, tg = _graphs()
    ig = ipgc.prepare(tg, device="cpu")
    state = (ipgc.init_colors(ig.n_nodes, "cpu"),
             torch.zeros(ig.n_nodes, dtype=torch.int32),
             repro_torch.core.worklist.full_worklist(ig.n_nodes, "cpu"))
    for mode, step in (("dense", ipgc.dense_step),
                       ("sparse", ipgc.sparse_step)):
        assert got.launches["per_iter"][mode] == measure_launches(
            step, ig, *state, window=64, force_hub=None)
    nd, ns = got.mode_trace.count("D"), got.mode_trace.count("S")
    assert got.launches["total"]["mex"] == nd + ns
    assert got.gathers["total"]["neighbor_colors"] == 2 * (nd + ns)
    spans = got.trace.find("session.iter")
    assert [sp.attrs["mode"] for sp in spans] == list(got.mode_trace)
    assert [sp.attrs["count"] for sp in spans] == got.counts


@pytest.mark.parametrize("exchange", ["dense", "boundary", "auto"])
@pytest.mark.parametrize("algo,fused", FAMILIES)
def test_dist_report_matches_reference(algo, fused, exchange):
    spec = dict(regime="dist", mode="dist-hybrid", window=32, n_shards=1,
                algo=algo, fused=fused, exchange=exchange)
    _, plain, got, want = _runs(spec)
    _same_report(got, want, partition_lookups=1)
    np.testing.assert_array_equal(got.colors, plain.colors)
    x = got.exchanges
    epi = 2 if fused is False else 1
    if exchange == "dense":
        assert x["per_iter"] == {"dense": {"color_psum": epi},
                                 "sparse": {"color_psum": epi}}
        assert x["trace"] == "d" * got.iterations
    else:
        both = {"boundary_pack": epi, "dense_swap": epi}
        assert x["per_iter"] == {"dense": both, "sparse": both}
    assert x["total"] == epi * got.iterations
    assert x["total_bytes"] == sum(x["bytes_per_iter"])
    assert len(got.trace.find("session.iter")) == got.iterations


def test_outlined_report_and_engine_entry_points():
    jg, tg = _graphs()
    rep = repro_torch.color(tg, window=64, outline=True, trace=True,
                            device="cpu")
    assert rep.regime == "outlined"
    assert rep.host_dispatches == rep.timing["dispatches"]
    assert len(rep.trace.find("session.chunk")) == rep.host_dispatches
    plain = repro_torch.color(tg, window=64, outline=True, device="cpu")
    np.testing.assert_array_equal(rep.colors, plain.colors)
    assert rep.mode_trace == plain.mode_trace
    want = jcore.color(jg, window=64, outline=True, trace=True)
    for f in FIELDS:
        assert getattr(rep, f) == getattr(want, f), f
    rep2 = repro_torch.color_outlined_hybrid(tg, window=64, trace=True,
                                             device="cpu")
    np.testing.assert_array_equal(rep2.colors, rep.colors)
    assert [sp.attrs["branch"] for sp in rep2.trace.find("session.chunk")] \
        == [sp.attrs["branch"] for sp in rep.trace.find("session.chunk")]
    # dist through color(mode="dist-hybrid"): the exchange section
    rep3 = repro_torch.color(tg, mode="dist-hybrid", devices=["cpu"] * 2,
                             exchange="auto", trace=True)
    assert rep3.regime == "dist" and rep3.exchanges["exchange"] == "auto"
    assert rep3.exchanges["trace"] == rep3.result.exchange_trace


def _counted(fn):
    """The deltas of every counter group over ``fn()``."""
    groups = (ipgc.LAUNCH_COUNTS, ipgc.GATHER_COUNTS, tdist.EXCHANGE_COUNTS,
              KERNEL_LAUNCHES)
    with ipgc.LAUNCH_COUNTS.scope(), ipgc.GATHER_COUNTS.scope(), \
            tdist.EXCHANGE_COUNTS.scope(), KERNEL_LAUNCHES.scope():
        r = fn()
        return r, [g.as_dict() for g in groups]


@pytest.mark.parametrize("spec_kw", [
    dict(regime="host", window=64),
    dict(regime="outlined", window=64, fused=True),
    dict(regime="dist", n_shards=2, exchange="boundary", fused=False)],
    ids=["host", "outlined", "dist"])
def test_traced_run_equals_untraced_run(spec_kw, monkeypatch):
    """Colors, counters and device reads: a traced run (its profile
    included: the profile's counts are scoped away) adds nothing, and no
    span synchronizes with the device."""
    _, tg = _graphs()
    s = Session("cpu")
    spec = ExecutionSpec(**spec_kw)
    s.run(spec, tg)                                    # warm the cache
    plain, want = _counted(lambda: s.run(spec, tg))

    def no_sync(*a, **k):
        raise AssertionError("a span synchronized with the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    reads = []
    for name in ("tolist", "item", "__int__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, _r=real: reads.append(1) or _r(t))
    rep, got = _counted(lambda: s.run(spec, tg, trace=True))
    n_traced = len(reads)
    reads.clear()
    plain2, _ = _counted(lambda: s.run(spec, tg))
    assert got == want
    assert n_traced == len(reads) > 0
    np.testing.assert_array_equal(rep.colors, plain.colors)
    assert (rep.mode_trace, rep.iterations) == \
        (plain.mode_trace, plain.iterations)
    np.testing.assert_array_equal(plain2.colors, plain.colors)


def test_evictions_under_pin_with_tracing():
    graphs = [tget("rgg_n_2_24_s0_s", scale=0.005, seed=i) for i in range(4)]
    s = Session("cpu", max_entries=2)
    spec = ExecutionSpec(regime="host", window=64)
    with s.pin():
        reports = [s.run(spec, x, trace=True) for x in graphs]
        assert len(s.cache) > 2
        assert s.stats.evictions == 0
    assert len(s.cache) <= 2
    assert s.stats.evictions > 0
    rep = s.run(spec, graphs[0], trace=True)
    assert {k: rep.cache[k] for k in ("hits", "misses", "evictions",
                                      "hit_rate")} == s.stats.as_dict()
    assert rep.cache["run_delta"]["evictions"] >= 0
    for r in reports:
        assert isinstance(r, RunReport) and r.n_colors > 0
    s.stats.reset()
    assert s.stats.as_dict() == {"hits": 0, "misses": 0, "evictions": 0,
                                 "hit_rate": 0.0}


def test_injected_trace_collects_spans():
    """A ``Trace`` passed in is appended to, run after run."""
    _, tg = _graphs()
    tr = Trace()
    s = Session("cpu")
    a = s.run(ExecutionSpec(regime="host", window=64), tg, trace=tr)
    b = s.run(ExecutionSpec(regime="outlined", window=64), tg, trace=tr)
    assert a.trace is b.trace is tr
    assert [sp.attrs["regime"] for sp in tr.spans] == ["host", "outlined"]
    assert all(sp.seconds >= 0 for sp in tr.walk())


def test_report_helpers_match_reference():
    per_iter = {"dense": {"mex": 1, "conflict": 1},
                "sparse": {"mex": 1, "compact": 2}}
    for trace in ("", "D", "DDSS", "SSSD"):
        assert treport.totals_from_trace(trace, per_iter) == \
            jreport.totals_from_trace(trace, per_iter)
    for n in (0, 7, 2_097_152):
        for f in ("dense_exchange_bytes", "dense_swap_bytes"):
            assert getattr(treport, f)(n) == getattr(jreport, f)(n)
    assert treport.packed_exchange_bytes(64, 4) == \
        jreport.packed_exchange_bytes(64, 4)
    cases = [
        dict(per_iter={"dense": {"color_psum": 1},
                       "sparse": {"color_psum": 1}},
             n_global=100, mode_trace="DDS"),
        dict(per_iter={"dense": {"boundary_pack": 2, "dense_swap": 2},
                       "sparse": {"boundary_pack": 2, "dense_swap": 2}},
             n_global=100, mode_trace="DSS", exchange="auto", n_shards=4,
             exchange_trace="dmb", exchange_bytes=[800, 600, 128]),
    ]
    for kw in cases:
        kw = dict(kw)
        args = (kw.pop("per_iter"), kw.pop("n_global"), kw.pop("mode_trace"))
        assert treport.exchange_section(*args, **kw) == \
            jreport.exchange_section(*args, **kw)
