"""The port's spans inside a coloring (``obs/trace.py``, ``exec/session.py``,
``core/ipgc.py``) on the CPU: off they cost the shared null context and
open no profiler range; under torch's profiler a run emits every span of
the schema, only those, and hands them back on ``ColoringResult.spans``;
spans change no result; the ambient trace is per thread; the benchmark's
three span readers (``bench/metrics``) on hand-built traces; the device
track of ``Trace.to_chrome``. No test asserts a timing."""
import importlib.util
import re
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch.core import ipgc
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.obs import RunReport, Span, Trace
from repro_torch.obs import trace as obs_trace

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: the spans the table of the schema names for a host-loop coloring
TABLE = {"session.iter", "session.count", "session.readback", "ipgc.hub",
         "ipgc.state", "ipgc.assign", "ipgc.resolve", "ipgc.compact"}
_GRAPHS: dict = {}


def _graph(name):
    """A registry graph: kron with 31 hubs, europe with none."""
    if name not in _GRAPHS:
        kw = (dict(scale=0.02, layout="ell-tail", ell_cap=128)
              if name.startswith("kron") else dict(scale=0.05))
        _GRAPHS[name] = repro_torch.get_dataset(name, **kw)
    return _GRAPHS[name]


def _documented() -> set:
    """The span names that ``obs/trace.py``'s docstring, the schema,
    lists: ``  a.b / c.d — ...`` lines."""
    names = set()
    for m in re.finditer(r"^  ([\w.]+(?: / [\w.]+)*) \u2014",
                         obs_trace.__doc__, re.M):
        names.update(m.group(1).split(" / "))
    return names


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.key for e in prof.key_averages()}


def _same(a, b):
    np.testing.assert_array_equal(a.colors, b.colors)
    assert (a.n_colors, a.iterations, a.mode_trace, a.counts) == \
        (b.n_colors, b.iterations, b.mode_trace, b.counts)


def test_off_is_the_shared_null_context(monkeypatch):
    """With no trace installed and no profiler recording, every site is
    the shared null context: no range, no CUDA event, no span."""
    def boom(*a, **k):
        raise AssertionError("spans are off")

    monkeypatch.setattr(obs_trace, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert obs_trace.maybe_span("x", k=1) is obs_trace._NULL
    assert obs_trace.step_span("ipgc.hub", part="lose") is obs_trace._NULL
    with obs_trace.tracing(Trace()):
        # a trace outside its run scope takes no step span
        assert obs_trace.step_span("ipgc.state") is obs_trace._NULL
    s = Session("cpu")
    for fused in (False, True):
        r = s.run(ExecutionSpec(regime="host", fused=fused),
                  _graph("kron_g500-logn21_s"))
        assert r.spans is None and r.iterations > 0


@pytest.mark.parametrize("name,force", [("kron_g500-logn21_s", False),
                                        ("europe_osm_s", True)],
                         ids=["hubs", "forced_hub"])
def test_profiled_run_emits_the_documented_spans(name, force):
    """Under a CPU profiler a two-phase run on a graph with hubs (or with
    the side-channel forced) emits every span of the table, as spans and
    as profiler ranges, and only names the schema documents; the
    ``ipgc.*`` spans never nest in one another."""
    g = _graph(name)
    with ipgc.forced_hub(force):
        r, keys = _profiled(lambda: Session("cpu").run(
            ExecutionSpec(regime="host", fused=False), g))
    names = {sp.name for sp in r.spans.walk()}
    assert TABLE <= names
    assert TABLE <= keys
    assert names <= _documented()
    assert {sp.attrs["part"] for sp in r.spans.find("ipgc.hub")} == \
        {"forbidden", "lose"}
    for sp in r.spans.walk():
        if sp.name.startswith("ipgc."):
            assert not any(c.name.startswith("ipgc.")
                           for c in list(sp.walk())[1:])
    # on the CPU the spans carry no device time
    assert all(sp.device_seconds is None for sp in r.spans.walk())


def test_result_spans_hold_one_iter_per_iteration():
    g = _graph("kron_g500-logn21_s")
    s = Session("cpu")
    spec = ExecutionSpec(regime="host")
    r, _ = _profiled(lambda: s.run(spec, g))
    iters = r.spans.find("session.iter")
    assert len(iters) == r.iterations
    assert [sp.attrs["mode"] for sp in iters] == list(r.mode_trace)
    assert [sp.attrs["count"] for sp in iters] == r.counts
    for sp in iters:
        assert [c.name for c in sp.children].count("session.count") == 1
    assert len(r.spans.find("session.readback")) == 1
    assert s.run(spec, g).spans is None
    rep = s.run(spec, g, trace=True)
    assert rep.result.spans is rep.trace
    assert len(rep.trace.find("session.iter")) == rep.iterations


@pytest.mark.parametrize("fused", [False, True], ids=["two-phase", "fused"])
@pytest.mark.parametrize("regime", ["host", "outlined"])
def test_spans_change_no_result(regime, fused):
    """Colors, iterations and mode trace: equal with spans off, under the
    profiler and in a traced run, for both step families."""
    g = _graph("kron_g500-logn21_s")
    s = Session("cpu")
    spec = ExecutionSpec(regime=regime, fused=fused)
    off = s.run(spec, g)
    on, _ = _profiled(lambda: s.run(spec, g))
    rep = s.run(spec, g, trace=True)
    for r in (on, rep.result):
        _same(r, off)
    assert on.spans.find("ipgc.compact") and on.spans.find("ipgc.hub")


def test_ambient_trace_is_per_thread():
    """A trace installed on one thread is not seen on another, and two
    threads' traces take only their own spans."""
    mine = Trace()
    barrier = threading.Barrier(2, timeout=30)
    seen, theirs = {}, Trace()

    def other():
        seen["ambient"] = obs_trace.current_trace()
        barrier.wait()
        with obs_trace.tracing(theirs):
            for _ in range(50):
                with obs_trace.maybe_span("other.span"):
                    pass
        barrier.wait()
        seen["run"] = Session("cpu").run(ExecutionSpec(regime="host"),
                                         _graph("kron_g500-logn21_s"))

    t = threading.Thread(target=other)
    with obs_trace.tracing(mine):
        t.start()
        barrier.wait()
        for _ in range(50):
            with obs_trace.maybe_span("mine.span"):
                pass
        barrier.wait()
        t.join(timeout=120)
    assert not t.is_alive()
    assert seen["ambient"] is None
    assert {sp.name for sp in mine.walk()} == {"mine.span"}
    assert {sp.name for sp in theirs.walk()} == {"other.span"}
    assert seen["run"].spans is None
    assert obs_trace.current_trace() is None


# ---------------------------------------------------------------------------
# the benchmark's span readers on hand-built traces
# ---------------------------------------------------------------------------

def _reader(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(trace):
    return types.SimpleNamespace(
        results=[types.SimpleNamespace(spans=trace)])


def _span(name, dev=None, children=(), **attrs):
    a, b = dev if dev is not None else (None, None)
    return Span(name=name, start=0.0, end=1.0, attrs=attrs,
                children=list(children), device_start=a, device_end=b)


def _iteration(i, start, count_at, end):
    """One ``session.iter`` with an assign, a hub and a state span, and
    its ``session.count``; device seconds exact in binary."""
    return _span("session.iter", (start, end), [
        _span("ipgc.hub", (start, start + 0.25), part="forbidden"),
        _span("ipgc.assign", (start + 0.25, start + 0.375)),
        _span("ipgc.state", (start + 0.375, start + 0.5)),
        _span("ipgc.hub", (start + 0.5, start + 0.625), part="lose"),
        _span("session.count", (count_at, end))], mode="S", count=3 - i)


def _hand_trace():
    tr = Trace()
    tr.spans = [_iteration(0, 0.0, 0.75, 0.875),
                _iteration(1, 1.0, 1.75, 2.0),
                _iteration(2, 2.5, 3.25, 3.5),
                _span("session.readback", (3.5, 4.0))]
    return tr


def test_span_readers_sum_device_times():
    ctx = _ctx(_hand_trace())
    assert _reader("steps.hub_ms")(ctx) == 1e3 * 3 * (0.25 + 0.125)
    assert _reader("steps.state_ms")(ctx) == 1e3 * 3 * 0.125
    # (1.0 - 0.75) + (2.5 - 1.75): count start to the next iteration
    assert _reader("pipe.turnaround_ms")(ctx) == 1e3 * (0.25 + 0.75)


def test_span_readers_find_nothing_without_device_times():
    cpu = Trace()
    cpu.spans = [_span("session.iter", children=[
        _span("ipgc.hub", part="lose"), _span("ipgc.state"),
        _span("session.count")])]
    for name in ("steps.hub_ms", "steps.state_ms", "pipe.turnaround_ms"):
        read = _reader(name)
        assert read(_ctx(cpu)) is None
        assert read(_ctx(None)) is None
        # a program whose results carry no spans at all
        assert read(types.SimpleNamespace(
            results=[types.SimpleNamespace()])) is None
        assert read(types.SimpleNamespace(results=[])) is None


def test_to_chrome_writes_device_spans_on_their_own_track():
    tr = _hand_trace()
    tr.device_origin_host = 0.5
    out = tr.to_chrome()["traceEvents"]
    host = [e for e in out if e["tid"] == 0]
    device = [e for e in out if e["tid"] == 1]
    assert len(host) == len(device) == len(list(tr.walk()))
    first = device[0]
    assert first["name"] == "session.iter"
    assert first["ts"] == 0.5e6 + 0.0 and first["dur"] == 0.875e6
    assert first["args"]["device_origin_us"] == 0.5e6
    assert first["args"]["mode"] == "S"
    rep = RunReport(regime="host", trace=tr)
    assert rep.to_json(include_chrome=True)["chrome_trace"] == \
        tr.to_chrome()
    # a host-only trace has no device track
    assert all(e["tid"] == 0 for e in Trace().to_chrome()["traceEvents"])
