"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result line.

Set-up (``setup_s``, from the process's start to the first timed call):
the configuration's generator draws the edge list on the device from the
seed; it goes to the host and through the port's ``build_graph``, as a
user's edge list would; ``Session._prepare`` moves the graph to the
device (``core/ipgc.py::prepare``); one untimed coloring warms every
shape the cell uses (and, in a fresh checkout, builds the kernels and
runs the tile tuner, whose results the program keeps under ``build/``);
the allocator's cached blocks are then released.

The window: one client colors the warm graph back to back through
``Session.run`` (the traffic file's entry and spec) until ``--seconds``
have passed, each call returning its colors on the host as the API does;
it ends with a ``torch.cuda.synchronize()``. ``color_s`` is the window's
seconds over the colorings completed in it. ``peak_gib`` is the
allocator's peak over the window, with the prepared graph resident: it is
reset after the warm-up, whose one-time tile sweep in a fresh checkout
would otherwise set it in that run alone; set-up's own peak is printed on
the ``setup`` line.

Correctness: once the window has closed, the peak has been read and the
program's state is freed, the plain reference colors the same edge list
on the device, and every coloring the window returned (or a sample drawn
from the seed, ``compare_sample`` in the cell's file) is compared with it
node for node, with its iteration count.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import random
import sys
import time

import numpy as np
import torch

from bench import catalog, tracing

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def forbidden_modules(names) -> list:
    """The names among ``names`` whose top-level name (before the first
    dot) is one of ``FORBIDDEN``, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def note(tag: str, **fields) -> None:
    """An earlier line of the run's output."""
    print(f"{tag} {json.dumps(fields)}", flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Sample:
    """A uniform sample of at most ``k`` of the window's colorings, drawn
    from the seed (reservoir sampling), always with the last."""

    def __init__(self, k: int, seed: int):
        self.k = max(int(k), 1)
        self.rng = random.Random(seed)
        self.kept: list = []
        self.seen = 0
        self.last = None

    def offer(self, item) -> None:
        self.seen += 1
        self.last = item
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item

    def items(self) -> list:
        out = list(self.kept)
        if self.last is not None and all(x is not self.last for x in out):
            out.append(self.last)
        return out


@dataclasses.dataclass
class Context:
    """What the per-layer metrics' readers read."""

    setup: dict                  # seconds of each set-up step
    results: list                # the profiled colorings' ColoringResults
    trace: "tracing.Reduced | None"
    kernel_bytes: "int | None"   # the port's kernels' bytes, one coloring
    reference_bytes: int         # the algorithm's bytes, one coloring
    hbm_bytes_per_s: "float | None"


def make_graph(cell: catalog.Cell, seed: int, device):
    """Draw the edge list and build the port's graph from it. Returns
    ``(graph, (src, dst, n) on the host, seconds by step)``."""
    from repro_torch.graphs.csr import build_graph, degree_stats

    cfg = cell.config
    t0 = time.perf_counter()
    src, dst, n = cell.generator().generate(cfg["params"], seed, device)
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    t1 = time.perf_counter()
    g = build_graph(src_h, dst_h, n, name=cell.config_name, **cfg["build"])
    t2 = time.perf_counter()
    st = degree_stats(g)
    note("graph", generator=cfg["generator"], nodes=int(n),
         edges_drawn=int(src_h.shape[0]), edges=int(g.n_edges),
         layout=st["layout"], ell_width=st["ell_width"],
         tail_entries=st["tail_entries"], d_max=st["d_max"],
         d_median=st["d_median"])
    return g, (src_h, dst_h, int(n)), {"gen_s": t1 - t0, "build_s": t2 - t1}


def judge(kept: list, ref_colors: torch.Tensor, ref_iterations: int) -> dict:
    """Every kept coloring against the reference's: the colorings whose
    colors or iteration count differ, and the most nodes any of them
    colors otherwise. Both limits are 0: the coloring is exact."""
    wrong = worst = 0
    for r in kept:
        got = torch.from_numpy(np.ascontiguousarray(r.colors)).to(
            ref_colors.device, torch.int64)
        differ = (int((got != ref_colors).sum())
                  if got.shape == ref_colors.shape else ref_colors.numel())
        worst = max(worst, differ)
        wrong += int(differ > 0 or r.iterations != ref_iterations)
    return {"wrong_colorings": {"value": wrong, "limit": 0},
            "nodes_differ": {"value": worst, "limit": 0}}


def reference_check(cell, edges, kept, device):
    """Color the edge list with the plain reference and judge ``kept``.
    Returns ``(checks, reference coloring)``; raises where the reference's
    own coloring is not a proper, complete one."""
    ref = cell.reference()
    src_h, dst_h, n = edges
    s, d = ref.normalize(torch.from_numpy(src_h).to(device),
                         torch.from_numpy(dst_h).to(device), n)
    rc = ref.ipgc(s, d, n)
    bad = ref.conflicts(s, d, rc.colors) + int((rc.colors < 0).sum())
    if bad or rc.iterations >= ref.MAX_ITER:
        raise RuntimeError(f"the reference's own coloring is not proper and "
                           f"complete ({bad} faults, {rc.iterations} "
                           "iterations)")
    return judge(kept, rc.colors, rc.iterations), rc


def run_cell(cell: catalog.Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: "float | None" = None,
             spec_overrides: "dict | None" = None) -> dict:
    """One run of ``cell``; returns the result line's object. ``device``
    is where the program and the reference run (the CPU only in tests);
    ``spec_overrides`` changes the traffic's spec (the control)."""
    from repro_torch.exec import Session, spec_for

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    traffic, settings = cell.traffic, cell.settings
    if traffic.get("entry") != "Session.run" or traffic.get("clients") != 1:
        raise ValueError(f"traffic {traffic!r}: this harness drives one "
                         "closed-loop client through Session.run")
    t_init = time.perf_counter()
    g, edges, setup = make_graph(cell, seed, dev)
    spec = spec_for(**{**traffic.get("spec", {}), **(spec_overrides or {})})
    sess = Session(dev)
    t0 = time.perf_counter()
    sess._prepare(spec, g, spec.resolved_algo())
    _sync(dev)
    t1 = time.perf_counter()
    for _ in range(int(traffic.get("warmup", 1))):
        sess.run(spec, g)
    _sync(dev)
    if on_card:
        # the window starts from an allocator holding only the prepared
        # graph, whether or not this run's warm-up swept the tile tuner
        gc.collect()
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    setup.update(start_s=t_init - t_start, prepare_s=t1 - t0,
                 warmup_s=t2 - t1)
    if on_card:
        setup["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    sample = Sample(settings.get("compare_sample", 1 << 30), seed)
    count = 0
    each = []
    w0 = time.perf_counter()
    t = w0
    while True:
        r = sess.run(spec, g)
        count += 1
        sample.offer(r)
        t, t_prev = time.perf_counter(), t
        each.append(t - t_prev)
        if t - w0 >= seconds:
            break
    _sync(dev)
    w1 = time.perf_counter()
    setup_s = w0 - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    note("setup", setup_s=setup_s, **setup)
    note("window", seconds=w1 - w0, colorings=count,
         each_s=dict(zip(("min", "p25", "p50", "p75", "max"),
                         np.quantile(each, [0, .25, .5, .75, 1]).tolist())),
         iterations=r.iterations, mode_trace=r.mode_trace,
         n_colors=r.n_colors, peak_bytes=peak)

    traced = traced_stretch(cell, sess, spec, g, dev) if trace else None
    kept = sample.items()
    del sess, g, r, sample
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, rc = reference_check(cell, edges, kept, dev)
    note("reference", iterations=rc.iterations, window=rc.window,
         bytes_needed=rc.bytes_needed, compared=len(kept))

    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else dev.type),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": count,
           "failed": checks["wrong_colorings"]["value"]}
    if trace:
        red = traced["reduced"]
        out["metrics"] = per_layer(cell, Context(
            setup=setup, results=traced["results"], trace=red,
            kernel_bytes=traced["kernel_bytes"],
            reference_bytes=rc.bytes_needed,
            hbm_bytes_per_s=catalog.peak_bytes_per_s(device_info["kind"],
                                                     cell.root)))
        device_info.update(busy_s=red.busy_s, window_s=red.window_s)
        out["device"] = device_info
        out["breakdown"] = {"device_ops": red.device_ops,
                            "idle_gaps": red.idle_gaps}
    else:
        values = {"setup_s": setup_s, "color_s": (w1 - w0) / count,
                  "peak_gib": peak / GIB}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = device_info
    out["checks"] = checks
    return out


def traced_stretch(cell, sess, spec, g, dev) -> dict:
    """Kernel bytes of one recorded coloring, then the profiled colorings
    (``tracing``)."""
    from repro_torch.kernels import _build

    rules = catalog.kernel_rules(cell.root)
    rec = tracing.Recorder(rules)
    with rec.installed():
        sess.run(spec, g)
    _sync(dev)
    launches0 = dict(_build.KERNEL_LAUNCHES.as_dict())
    events, results = tracing.profile(lambda: sess.run(spec, g),
                                      int(cell.settings["profile_colorings"]))
    launches1 = _build.KERNEL_LAUNCHES.as_dict()
    reduced = tracing.reduce(
        events, tracing.kernel_matcher(tracing.port_kernel_names(
            _build.CSRC)), set(rules))
    note("traced", recorded_calls=dict(rec.calls),
         recorded_bytes=dict(rec.bytes),
         profiled_launches={k: launches1[k] - launches0.get(k, 0)
                            for k in launches1},
         trace_launches=reduced.launches, colorings=reduced.colorings,
         kernel_s=reduced.kernel_s, readback_s=reduced.readback_s,
         other_s=reduced.other_s,
         busy_s=reduced.busy_s, window_s=reduced.window_s,
         span_s=reduced.span_s)
    return {"results": results, "reduced": reduced,
            "kernel_bytes": sum(rec.bytes.values())}


def per_layer(cell, ctx: Context) -> dict:
    """The cell's per-layer metrics that their readers find; a reader that
    finds nothing returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = catalog.metric_reader(m["name"], cell.root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def report(out: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
