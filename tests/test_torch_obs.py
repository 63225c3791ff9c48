"""The port's telemetry (``repro_torch/obs``) against ``repro.obs``: the
same observations give the same histograms, registries, traces and run
reports; the stream service's instruments and spans under a
``ManualClock`` equal the reference's exactly (``tests/test_obs.py``'s
stream and batch contracts)."""
import json
import math

import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from _torch_stream import PORT, REF, both, stats

SIDES = [pytest.param(jobs, id="repro"), pytest.param(tobs, id="port")]

#: observations that hit every bucket kind: on an edge, just past one,
#: below the first, in the overflow bucket, negative (the slack ladder)
VALUES = [1e-6, 1.0000001e-6, 3e-4, 0.25, 0.5, 2.0, 2.0, 31.9, 32.0, 33.0,
          1e3, 0.0, -0.3, 5e-5]


@pytest.mark.parametrize("edges", ["LATENCY_EDGES", "DEPTH_EDGES",
                                   "SLACK_EDGES", (1.0, 2.0, 4.0)])
def test_histogram_matches_reference(edges):
    ladder = getattr(jobs.metrics, edges) if isinstance(edges, str) else edges
    want, got = jobs.Histogram("h", ladder), tobs.Histogram("h", ladder)
    for h in (want, got):
        assert h.summary() == {"count": 0} and h.percentile(50) is None
    for v in VALUES:
        assert got.bucket_index(v) == want.bucket_index(v)
        want.observe(v)
        got.observe(v)
    assert got.as_dict() == want.as_dict()
    for p in (0, 1, 50, 90, 99, 100):
        assert got.percentile(p) == want.percentile(p)
    assert got.mean == want.mean
    got.reset()
    want.reset()
    assert got.as_dict() == want.as_dict()


def test_histogram_validation_and_ladders():
    assert tobs.LATENCY_EDGES == jobs.LATENCY_EDGES
    assert tobs.DEPTH_EDGES == jobs.DEPTH_EDGES
    assert tobs.SLACK_EDGES == jobs.metrics.SLACK_EDGES
    assert tobs.exp_edges(1e-3, 1.0, factor=4.0) == \
        jobs.exp_edges(1e-3, 1.0, factor=4.0)
    for obs in (jobs, tobs):
        with pytest.raises(ValueError, match="increasing"):
            obs.Histogram("bad", (2.0, 1.0))
        with pytest.raises(ValueError, match="bucket edge"):
            obs.Histogram("bad", ())
        with pytest.raises(ValueError, match="lo > 0"):
            obs.exp_edges(0.0, 1.0)


@pytest.mark.parametrize("obs", SIDES)
def test_registry_get_or_create_and_kind_conflicts(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("c")
    assert reg.counter("c") is c
    c.inc()
    c.inc(4)
    reg.gauge("g").set(7)
    reg.histogram("h", (1.0, 2.0)).observe(1.5)
    grp = reg.group("grp", keys=("a", "b"))
    grp["a"] += 2
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("c")
    with pytest.raises(KeyError, match="unknown counter"):
        grp["z"] = 1
    with pytest.raises(ValueError, match="already registered"):
        reg.register("c", obs.Counter("c"))
    assert reg.names() == ("c", "g", "h", "grp")
    assert reg.get("nope") is None


def test_registry_snapshots_match_reference():
    def fill(obs):
        reg = obs.MetricsRegistry()
        reg.counter("c").inc(3)
        reg.gauge("g").set(2.5)
        for v in VALUES:
            reg.histogram("lat").observe(abs(v))
        reg.histogram("depth", obs.DEPTH_EDGES).observe(3)
        reg.group("out", keys=("done", "failed"))["done"] += 1
        return reg

    want, got = fill(jobs), fill(tobs)
    assert got.as_dict() == want.as_dict()
    got.reset()
    want.reset()
    assert got.as_dict() == want.as_dict()


def _spans(obs, clock):
    tr = obs.Trace(clock=clock)
    with obs.tracing(tr):
        with obs.maybe_span("outer", k=1):
            with obs.maybe_span("inner"):
                pass
            with tr.span("inner", depth=2):
                pass
    assert obs.current_trace() is None
    return tr


def test_trace_matches_reference_under_manual_clock():
    want = _spans(jobs, REF.Clock(start=5.0, tick=0.5))
    got = _spans(tobs, PORT.Clock(start=5.0, tick=0.5))
    assert got.to_chrome() == want.to_chrome()
    assert [sp.seconds for sp in got.walk()] == \
        [sp.seconds for sp in want.walk()]
    assert len(got.find("inner")) == 2
    (outer,) = got.spans
    assert outer.seconds == 2.5 and outer.attrs == {"k": 1}
    with tobs.maybe_span("off") as sp:        # tracing off: shared no-op
        assert sp is None


@pytest.mark.parametrize("obs", SIDES)
def test_run_report_schema(obs):
    rep = obs.RunReport(regime="stream", algo="ipgc", graph="<x>",
                        host_dispatches=3, timing={"total_seconds": 1.5},
                        extra={"stream": {"done": 2}})
    out = rep.to_json()
    json.dumps(out)
    assert out["regime"] == "stream" and rep.total_seconds == 1.5
    assert rep.colors is None and rep.tti == []
    assert set(out) == set(jobs.RunReport().to_json())


# ---------------------------------------------------------------------------
# the stream's instruments and spans under a ManualClock
# ---------------------------------------------------------------------------

def _traced_stream(side, obs, *, lanes, chunk, count):
    clk = side.Clock(start=0.0, tick=0.25)
    tr = obs.Trace(clock=clk)
    stream = side.session().stream(
        side.Spec(regime="host", window=64),
        side.Config(lanes=lanes, chunk=chunk, clock=clk, trace=tr))
    graphs = [side.graph("rgg_n_2_24_s0_s", 0.005, seed=i)
              for i in range(count)]
    tickets = [stream.submit(g) for g in graphs]
    stream.drain()
    return tickets, stream, tr


def test_stream_histograms_and_spans_match_reference():
    (jt, js, jtr), (tt, ts, ttr) = (
        _traced_stream(REF, jobs, lanes=2, chunk=4, count=4),
        _traced_stream(PORT, tobs, lanes=2, chunk=4, count=4))
    assert ts.metrics.as_dict() == js.metrics.as_dict()
    assert ttr.to_chrome() == jtr.to_chrome()
    assert stats(ts) == stats(js)
    m = ts.metrics
    hq, hs, ht = (m.get("stream.queue_seconds"),
                  m.get("stream.service_seconds"),
                  m.get("stream.total_seconds"))
    assert hq.count == hs.count == ht.count == 4
    assert math.isclose(ht.sum, hq.sum + hs.sum)
    assert m.get("stream.queue_depth").count == ts.round
    assert len(ttr.find("stream.pump")) == ts.round
    assert len(ttr.find("stream.dispatch")) == ts.dispatches
    rep, want = ts.report().to_json(), js.report().to_json()
    for out in (rep, want):
        out["timing"] = {k: v for k, v in out["timing"].items()
                         if k == "dispatches"}
        out["extra"]["stream"].pop("dispatch_seconds")
    assert rep == want
    assert [tk.total_seconds for tk in tt] == [tk.total_seconds for tk in jt]


def test_stream_queue_depth_values_match_reference():
    (_, js, _), (_, ts, _) = (
        _traced_stream(REF, jobs, lanes=1, chunk=10_000, count=3),
        _traced_stream(PORT, tobs, lanes=1, chunk=10_000, count=3))
    hd = ts.metrics.get("stream.queue_depth")
    assert hd.as_dict() == js.metrics.get("stream.queue_depth").as_dict()
    # pump 1 sees 3 queued, pump 2 sees 2, pump 3 sees 1
    assert hd.count == 3 and (hd.min, hd.max) == (1.0, 3.0)
    assert hd.counts[1] == hd.counts[2] == hd.counts[3] == 1


def test_batch_report_cache_section():
    want, got = both(lambda side: side.session().run_batch(
        side.Spec(regime="host", window=64),
        [side.graph("rgg_n_2_24_s0_s", 0.005, seed=i) for i in range(2)],
        trace=True))
    # the port keeps no compiled-program entries, so the counts differ
    assert set(got.cache) == set(want.cache)
    assert got.cache["run_delta"] == {"hits": got.cache["hits"],
                                      "misses": got.cache["misses"],
                                      "evictions": 0}
    assert got.trace.find("batch.run")[0].attrs == {"graphs": 2}
    assert [sp.attrs for sp in got.trace.find("batch.dispatch")] == \
        [sp.attrs for sp in want.trace.find("batch.dispatch")]
