"""The hub side-channel (``kernels/hub.py``, ``core/ipgc.py``) on the CPU:
the gated plain tables against ``repro``'s ``_hub_forbidden`` and
``_hub_lose`` on every layout with hubs, on padded batch lanes and on the
forced side-channel of a hubless graph; the invariant the kernels' slot
lookup rests on; the four ELL steps with their gate against an all-True
one; the ``ipgc.hub`` spans' ``entries``/``visited`` and their reader; the
two kernels' byte rules. Exact: all state is int32/bool."""
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import ipgc as jipgc
from repro.graphs import get_dataset as jget
from repro_torch.core import ipgc as tipgc
from repro_torch.core import worklist as twl
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.kernels import ops
from repro_torch.obs import Trace
from repro_torch.obs import trace as obs_trace

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KRON = "kron_g500-logn21_s"
#: case -> the registry graphs (name, get_dataset keywords) it is built of
GRAPHS = {
    "ell-tail": [(KRON, dict(layout="ell-tail", ell_cap=16))],
    "hub-split": [(KRON, dict(layout="hub-split"))],
    # two lanes of one flattened block-diagonal graph (exec/batch.py)
    "lanes": [(KRON, dict(layout="ell-tail", ell_cap=16)),
              (KRON, dict(layout="hub-split"))],
    # a hubless graph: T = 8 invalid entries, n_hub = 0
    "forced": [("europe_osm_s", dict(layout="pure-ell"))],
}
GATES = ("on", "off", "random")
_PREPARED: dict = {}


def _prepared(name, kw):
    """``repro``'s prepared graph and the port's, from the same arrays."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _PREPARED:
        jig = jipgc.prepare(jget(name, scale=0.02, **kw))
        arrays = {f: np.asarray(getattr(jig, f))
                  for f in tipgc.ARRAY_FIELDS}
        _PREPARED[key] = (jig, tipgc.from_numpy(
            arrays, layout_kind=jig.layout_kind, device="cpu"))
    return _PREPARED[key]


def _lanes(parts):
    """The port's graphs of ``parts`` padded into the lanes of one
    flattened graph (``pad_into``), and ``repro``'s graph over the same
    arrays."""
    n_pad = max(t.n_nodes for _, t in parts) + 5
    k_pad = max(t.ell_width for _, t in parts)
    t_pad = max(t.tail_src.shape[0] for _, t in parts) + 7
    nh_pad = max(t.n_hub for _, t in parts) + 2
    dst = tipgc.padded_graph(n_pad, k_pad, t_pad, nh_pad, lanes=len(parts),
                             device="cpu")
    for lane, (_, t) in enumerate(parts):
        tipgc.pad_into(t, dst, lane, len(parts))
    jig = dataclasses.replace(
        parts[0][0], n_nodes=dst.n_nodes, ell_width=dst.ell_width,
        n_hub=dst.n_hub, **{f: jnp.asarray(getattr(dst, f).numpy())
                            for f in tipgc.ARRAY_FIELDS})
    return jig, dst


def _case(case):
    parts = [_prepared(name, kw) for name, kw in GRAPHS[case]]
    return _lanes(parts) if case == "lanes" else parts[0]


def _state(n, window, seed):
    """Colors int32[N+1] (pad slot PAD_COLOR) with many in and near the
    window of random bases int32[N]."""
    rng = np.random.default_rng(seed)
    colors = rng.integers(-1, 3 * window, n + 1).astype(np.int32)
    colors[n] = tipgc.PAD_COLOR
    base = rng.integers(0, 2 * window, n).astype(np.int32)
    return colors, base


def _gate(kind, size, seed):
    if kind == "on":
        return np.ones(size, bool)
    if kind == "off":
        return np.zeros(size, bool)
    return np.random.default_rng(seed).random(size) < 0.5


def _in_span(call):
    """``call(sp)`` inside an open ``ipgc.hub`` span of a trace: its result
    and the span's ``visited``, the entries the call's gate let through."""
    tr = Trace()
    with obs_trace.tracing(tr), tr.run_scope():
        with obs_trace.step_span("ipgc.hub", part="test") as sp:
            got = call(sp)
    return got, tr.find("ipgc.hub")[0].attrs["visited"]


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("window", [1, 32, 128, 256])
@pytest.mark.parametrize("case", list(GRAPHS))
def test_gated_tables_match_reference(case, window, gate):
    """The forbidden table equals ``repro``'s on every hub row whose gate
    is on and is False elsewhere; the lose flags, gated by the flags the
    reference's predicate holds, equal ``repro``'s. The ``ipgc.hub``
    span handed in counts the entries each gate let through (``visited``)."""
    jig, tig = _case(case)
    n, nh = tig.n_nodes, tig.n_hub
    colors, base = _state(n, window, seed=window)
    on = _gate(gate, n, seed=7 * window)
    flags = np.concatenate([_gate(gate, n, seed=11 * window), [False]])
    src = tig.tail_src.numpy()

    want = np.asarray(jipgc._hub_forbidden(jig, jnp.asarray(colors),
                                           jnp.asarray(base), window))
    got, visited = _in_span(lambda sp: tipgc._hub_forbidden(
        tig, torch.from_numpy(colors), torch.from_numpy(base), window,
        torch.from_numpy(on), span=sp))
    rows_on = np.zeros(nh + 1, bool)
    rows_on[:nh] = on[tig.hub_ids.numpy()[:nh]]
    np.testing.assert_array_equal(got.numpy(), want & rows_on[:, None])
    assert int(visited) == int(on[src].sum())
    if gate == "on" and case != "forced":
        assert want.any()

    want = np.asarray(jipgc._hub_lose(jig, jnp.asarray(colors),
                                      jnp.asarray(flags)))
    got, visited = _in_span(lambda sp: tipgc._hub_lose(
        tig, torch.from_numpy(colors), torch.from_numpy(flags), span=sp))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (nh + 1,) and not got[nh]
    assert int(visited) == int(flags[src].sum())


@pytest.mark.parametrize("case", list(GRAPHS) + ["kron-0.25"])
def test_hub_slot_of_source_is_tail_slot(case):
    """The kernels take an entry's slot from ``hub_slot[tail_src]``: it is
    the entry's ``tail_slot`` wherever the entry is valid, on prepared
    graphs and on padded lanes (whose padding entries differ)."""
    if case == "kron-0.25":
        tig = tipgc.prepare(jget(KRON, scale=0.25, layout="ell-tail",
                                 ell_cap=128), device="cpu")
    else:
        tig = _case(case)[1]
    valid = tig.tail_valid
    assert torch.equal(tig.hub_slot[tig.tail_src][valid],
                       tig.tail_slot[valid])
    if case != "forced":
        assert bool(valid.any())


def _run_in(step, ig, dense_steps, sparse, window=32):
    """``step`` on the state ``dense_steps`` two-phase dense steps into a
    run (resized to its capacity bucket for a sparse step)."""
    n = ig.n_nodes
    colors = tipgc.init_colors(n, "cpu")
    base = torch.zeros(n, dtype=torch.int32)
    wl = twl.full_worklist(n, "cpu")
    for _ in range(dense_steps):
        colors, base, wl = tipgc.dense_step(ig, colors, base, wl,
                                            window=window)
    if sparse:
        caps = twl.bucket_capacities(n, ratio=2)
        wl = twl.resize_items(wl, twl.pick_bucket(caps, int(wl.count)), n)
    return step(ig, colors, base, wl, window=window)


STEPS = {("two-phase", "dense"): tipgc.dense_step,
         ("two-phase", "sparse"): tipgc.sparse_step,
         ("fused", "dense"): tipgc.fused_dense_step,
         ("fused", "sparse"): tipgc.fused_sparse_step}


@pytest.mark.parametrize("dense_steps", [1, 3])
@pytest.mark.parametrize("family,phase", list(STEPS))
def test_step_gate_equals_all_true_gate(family, phase, dense_steps,
                                        monkeypatch):
    """Each ELL step with its gate (the worklist's active rows) gives the
    state an all-True gate (the full table) gives."""
    ig = _prepared(KRON, dict(layout="ell-tail", ell_cap=16))[1]
    step = STEPS[family, phase]
    sparse = phase == "sparse"
    gated = _run_in(step, ig, dense_steps, sparse)
    orig = ops.hub_forbidden
    gates = []

    def all_true(*args):
        args = list(args)
        gates.append(args[6])
        args[6] = torch.ones_like(args[6])
        return orig(*args)

    monkeypatch.setattr(ops, "hub_forbidden", all_true)
    full = _run_in(step, ig, dense_steps, sparse)
    assert gates and not bool(gates[-1].all())
    for a, b in zip(gated[:2], full[:2]):
        assert torch.equal(a, b)
    for f in ("mask", "items", "count"):
        assert torch.equal(getattr(gated[2], f), getattr(full[2], f))


def _reader(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("fused", [False, True], ids=["two-phase", "fused"])
def test_hub_spans_count_the_entries_their_gates_let_through(fused):
    """A traced run's ``ipgc.hub`` spans carry the tail's length and the
    entries their gate let through: all of them in the first forbidden
    pass (every row active), fewer later; the benchmark's
    ``steps.hub_visit_pct`` reads their share."""
    g = repro_torch.get_dataset(KRON, scale=0.02, layout="ell-tail",
                                ell_cap=16)
    rep = Session("cpu").run(ExecutionSpec(regime="host", fused=fused), g,
                             trace=True)
    spans = rep.trace.find("ipgc.hub")
    t = int(tipgc.prepare(g, device="cpu").tail_src.shape[0])
    assert len(spans) == 2 * rep.iterations
    assert all(sp.attrs["entries"] == t for sp in spans)
    assert all(0 <= sp.attrs["visited"] <= t for sp in spans)
    assert spans[0].attrs == {"part": "forbidden", "entries": t,
                              "visited": t}
    assert spans[-2].attrs["visited"] < t
    visited = sum(sp.attrs["visited"] for sp in spans)
    ctx = type("Ctx", (), {"results": [rep.result]})
    assert _reader("steps.hub_visit_pct")(ctx) == \
        100.0 * visited / (t * len(spans))


def test_visit_reader_finds_nothing_without_counters():
    """A program whose spans carry no counter (or no spans) reads None."""
    from repro_torch.obs import Span
    read = _reader("steps.hub_visit_pct")
    tr = Trace()
    tr.spans = [Span(name="ipgc.hub", start=0.0, end=1.0,
                     attrs={"part": "lose"})]
    ctx = type("Ctx", (), {"results": [type("R", (), {"spans": tr})]})
    assert read(ctx) is None
    assert read(type("Ctx", (), {"results": []})) is None


def test_span_counter_resolves_into_attrs():
    """``span_counter`` is None while spans are off; on, the trace reads
    the counter into the span's attrs at its first read."""
    assert obs_trace.span_counter(None, "visited", "cpu") is None
    tr = Trace()
    with obs_trace.tracing(tr), tr.run_scope():
        with obs_trace.step_span("ipgc.hub", part="lose") as sp:
            c = obs_trace.span_counter(sp, "visited", "cpu")
            c += 5
    assert sp.attrs == {"part": "lose"}
    assert tr.find("ipgc.hub")[0].attrs == {"part": "lose", "visited": 5}


# --- the byte rules (bench/kernels) -----------------------------------------

def _tiny():
    """A 6-node tail: sources 1 (slot 0) and 4 (slot 1), an invalid
    padding entry, unsorted."""
    src = torch.tensor([4, 1, 1, 4, 1, 0], dtype=torch.int32)
    dst = torch.tensor([2, 0, 3, 5, 4, 6], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, True, False])
    hub_slot = torch.tensor([2, 0, 2, 2, 1, 2], dtype=torch.int32)
    colors = torch.tensor([0, 1, 1, -1, 1, 3, -2], dtype=torch.int32)
    prio = torch.tensor([5, 3, 9, 1, 7, 3, -1], dtype=torch.int32)
    return src, dst, valid, hub_slot, colors, prio


def _record(kernel, call):
    from bench import catalog, tracing
    rule = catalog.kernel_rules(ROOT)[kernel]
    rec = tracing.Recorder({kernel: rule})
    with rec.installed():
        out = call()
    return rec.bytes[kernel], out


@pytest.mark.parametrize("gate", GATES)
def test_hub_rules_count_what_the_gate_lets_through(gate):
    """Both rules against a count made entry by entry: 4 bytes a source
    id, 1 a distinct source's gate; past the gate the entry's destination
    and valid flag, its destination's color (lose: where the source is
    colored; its priority where the colors are equal), each live source's
    base or color and priority and slot, its table row or flag."""
    src, dst, valid, hub_slot, colors, prio = _tiny()
    window, n_hub = 4, 2
    on = torch.from_numpy(_gate(gate, 6, seed=3))
    base = torch.zeros(6, dtype=torch.int32)
    got, _ = _record("hub_forbidden_kernel", lambda: ops.hub_forbidden(
        src, dst, valid, hub_slot, colors, base, on, window, n_hub))
    live = {int(s) for s in src if on[s]}
    want = 4 * 6 + len(set(src.tolist()))
    want += sum(5 + 4 * bool(valid[e]) for e in range(6) if on[src[e]])
    want += 8 * len(live) + window * sum(hub_slot[s] < n_hub for s in live)
    assert got == want

    got, _ = _record("hub_lose_kernel", lambda: ops.hub_lose(
        src, dst, valid, hub_slot, colors, prio, on, n_hub))
    want = 4 * 6 + len(set(src.tolist()))
    want += 12 * len(live) + sum(hub_slot[s] < n_hub for s in live)
    for e in range(6):
        s, d = int(src[e]), int(dst[e])
        if not on[s]:
            continue
        want += 5
        if valid[e] and colors[s] >= 0:
            want += 4 + 4 * bool(colors[d] == colors[s])
    assert got == want
