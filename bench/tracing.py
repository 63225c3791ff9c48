"""The traced stretch of a ``--trace 1`` run.

Two passes over the warm graph, after the measured window:

1. One coloring with the kernel entry points that ``bench/kernels`` names
   wrapped from outside the program (``Recorder``): each call's bytes are
   counted from the rows it was handed, by the kernel's rule. Counting
   reads the operands on the device, so this coloring is not profiled.
2. A few colorings under ``torch.profiler`` (CPU and CUDA activities),
   each inside a ``bench.coloring`` range. The chrome trace is reduced to
   device seconds in the port's kernels, in copies from the device to
   the host (the colors handed back, the Pipe's reads of a count), and in
   every other device operation (the steps' PyTorch ops, with their
   device-side copies and fills), the device's busy time, the span of its
   work, the operations that took most time and the idle gaps by what the
   host was doing (``reduce``).

The port's kernels are told apart by name: the ``__global__`` functions
of the program's CUDA sources. A port kernel in the trace without a rule
in ``bench/kernels`` fails the run.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import inspect
import json
import os
import re
import tempfile
from pathlib import Path

import torch

MARK = "bench.coloring"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: the profiler's name of a copy from the device to the host
_DTOH = "DtoH"
_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")
#: rows a chunk when a rule gathers neighbours, to bound its memory
_CHUNK = 1 << 16


def port_kernel_names(csrc: Path) -> set:
    """The ``__global__`` function names in the CUDA sources under
    ``csrc``."""
    names = set()
    for path in sorted(Path(csrc).glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return names


def kernel_matcher(names):
    """A function from a trace's kernel name to the port kernel it is, or
    None."""
    if not names:
        return lambda name: None
    pat = re.compile(r"(?:^|[\s:])(" + "|".join(
        re.escape(n) for n in sorted(names, key=len, reverse=True))
        + r")\s*[<(]")

    def match(name: str):
        m = pat.search(name)
        return m.group(1) if m else None
    return match


# --------------------------------------------------------------------------
# kernel bytes, counted from the rows each call was handed
# --------------------------------------------------------------------------

class Call:
    """One recorded call: its arguments by name (defaults applied) and the
    helpers the rules share."""

    def __init__(self, args: dict, recorder: "Recorder"):
        self.args = args
        self._rec = recorder

    @staticmethod
    def handed(ell: torch.Tensor, rows: "torch.Tensor | None"):
        """The graph rows a row kernel was handed, int64, and which of the
        handed rows they are (None: all; a row id >= the tile's row count
        is padding and reads nothing)."""
        rg = ell.shape[0]
        if rows is None:
            return torch.arange(rg, device=ell.device), None
        ok = rows < rg
        return rows[ok].long(), ok

    def row_entries(self, ell: torch.Tensor, pad: int) -> torch.Tensor:
        """int64[Rg]: each row's real ELL entries (not ``pad``), cached
        per tile."""
        key = (ell.data_ptr(), tuple(ell.shape), pad)
        got = self._rec.entries.get(key)
        if got is None:
            got = (ell != pad).sum(dim=1, dtype=torch.int64)
            self._rec.entries[key] = got
        return got

    @staticmethod
    def same_color_neighbours(ell, rows, colors, own, pad) -> int:
        """Real neighbours of ``rows`` whose color equals the row's own
        color ``own``."""
        total = 0
        for i in range(0, rows.numel(), _CHUNK):
            nb = ell[rows[i:i + _CHUNK]]
            hit = (nb != pad) & (colors[nb] == own[i:i + _CHUNK, None])
            total += int(hit.sum())
        return total


class Recorder:
    """Counts the bytes of every call of the entry points named by
    ``rules`` (kernel name -> rule module with ``ENTRY``, ``"module:fn"``,
    and ``bytes_of(call, out)``) while ``installed``."""

    def __init__(self, rules: dict):
        self.rules = rules
        self.bytes: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self.entries: dict = {}

    @contextlib.contextmanager
    def installed(self):
        patched = []
        by_entry = {}
        for kernel, rule in sorted(self.rules.items()):
            by_entry.setdefault(rule.ENTRY, (kernel, rule))
        try:
            for entry, (kernel, rule) in by_entry.items():
                mod_name, fn_name = entry.split(":")
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, fn_name)
                setattr(mod, fn_name, self._wrap(kernel, rule, orig))
                patched.append((mod, fn_name, orig))
            yield self
        finally:
            for mod, fn_name, orig in reversed(patched):
                setattr(mod, fn_name, orig)
            self.entries.clear()

    def _wrap(self, kernel, rule, orig):
        sig = inspect.signature(orig)

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            self.bytes[kernel] += int(rule.bytes_of(
                Call(dict(bound.arguments), self), out))
            self.calls[kernel] += 1
            return out
        return wrapper


# --------------------------------------------------------------------------
# the profiled stretch
# --------------------------------------------------------------------------

def profile(run_once, colorings: int):
    """Run ``run_once`` ``colorings`` times under ``torch.profiler``; returns
    ``(chrome trace events, results)``. The trace goes through a temporary
    file in ``TMPDIR``, removed at once."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    results = []
    with torch_profile(activities=acts) as prof:
        for _ in range(colorings):
            with record_function(MARK):
                results.append(run_once())
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return events, results


@dataclasses.dataclass
class Reduced:
    """What the profiled stretch shows, in seconds over all its
    colorings."""

    colorings: int
    window_s: float          # first ``bench.coloring`` start to last end
    busy_s: float            # union of device operations in the window
    span_s: float            # first device operation's start to last end
    kernel_s: float          # device time in the port's kernels
    readback_s: float        # device time in copies from device to host
    other_s: float           # device time in every other operation
    launches: dict           # port kernel -> launches in the window
    device_ops: list         # [[name, seconds], ...], most time first
    idle_gaps: list          # [[what the host did, seconds], ...]


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name.strip()[:width]


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label_gaps(gaps, host):
    """For each gap, the innermost host event of the traced thread running
    at its midpoint (``MARK`` alone: Python between operations)."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    labels = [None] * len(gaps)
    stack, j = [], 0
    for i in order:
        t = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(host) and host[j][0] <= t:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        name = stack[-1][2] if stack else MARK
        labels[i] = "python between operations" if name == MARK else name
    return labels


def _top(pairs, n=10):
    acc = collections.Counter()
    for name, sec in pairs:
        acc[name] += sec
    return [[k, v] for k, v in acc.most_common(n)]


def reduce(events, match, rule_names) -> Reduced:
    """Reduce a chrome trace of ``profile`` (times in microseconds).
    ``match`` maps a kernel name to the port kernel it is (or None);
    a port kernel without a name in ``rule_names`` raises."""
    marks = [e for e in events if e.get("name") == MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {MARK!r} range")
    w0 = min(float(e["ts"]) for e in marks)
    w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in marks)
    tid = marks[0].get("tid")
    dev, host = [], []
    for e in events:
        cat = e.get("cat")
        if "ts" not in e or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e.get("name", ""), cat))
        elif cat in HOST_CATS and e.get("tid") == tid:
            host.append((a, b, e.get("name", "")))
    kernel_us = readback_us = other_us = 0.0
    launches: collections.Counter = collections.Counter()
    for a, b, name, cat in dev:
        k = match(name) if cat == "kernel" else None
        if k is not None:
            kernel_us += b - a
            launches[k] += 1
        elif cat == "gpu_memcpy" and _DTOH in name:
            readback_us += b - a
        else:
            other_us += b - a
    missing = sorted(set(launches) - set(rule_names))
    if missing:
        raise RuntimeError(
            f"port kernels {missing} ran in the traced window but have no "
            "byte rule in bench/kernels: add bench/kernels/<kernel>.py")
    busy = _merge((a, b) for a, b, _, _ in dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    labels = _label_gaps(gaps, host)
    us = 1e-6
    return Reduced(
        colorings=len(marks), window_s=(w1 - w0) * us,
        busy_s=sum(b - a for a, b in busy) * us,
        span_s=((busy[-1][1] - busy[0][0]) * us) if busy else 0.0,
        kernel_s=kernel_us * us, readback_s=readback_us * us,
        other_s=other_us * us,
        launches=dict(launches),
        device_ops=_top((short_name(n), (b - a) * us) for a, b, n, _ in dev),
        idle_gaps=_top((lab, (b - a) * us)
                       for lab, (a, b) in zip(labels, gaps)))
