"""Metrics primitives (``repro/obs/metrics.py``).

The engine counts what it launches and gathers in named counter families
(``CounterGroup``): ``core.ipgc.LAUNCH_COUNTS`` (logical passes per step),
``core.ipgc.GATHER_COUNTS`` (neighbour-color gathers per step) and
``kernels.ops.KERNEL_LAUNCHES`` (CUDA kernel launches per wrapper). The
port runs eagerly, so every counter moves when the code runs, not when it
is traced.

The stream service keeps its own instruments in a ``MetricsRegistry``: a
``Counter`` (monotone count), a ``Gauge`` (last value) and a fixed-bucket
``Histogram``, which answers p50/p90/p99 from bucket upper edges without
storing samples. All of it is host-side Python.
"""
from __future__ import annotations

import bisect
import contextlib
import math


class Counter:
    """A monotone count."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"value": self.value}

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """A last-value sample (queue depth, resident lanes, ...)."""

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        self.value = v

    def as_dict(self) -> dict:
        return {"value": self.value}

    def reset(self) -> None:
        self.value = None


def exp_edges(lo: float, hi: float, *, factor: float = 2.0
              ) -> tuple[float, ...]:
    """Geometric bucket ladder: ``lo, lo*f, ... >= hi`` (inclusive)."""
    if lo <= 0 or factor <= 1:
        raise ValueError(f"need lo > 0 and factor > 1, got {lo}, {factor}")
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * factor)
    return tuple(edges)


#: default latency ladder: 1 µs .. ~34 s in powers of two (26 buckets)
LATENCY_EDGES = exp_edges(1e-6, 32.0)
#: queue-depth / small-int ladder
DEPTH_EDGES = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)
#: signed seconds ladder for deadline slack (negative = deadline missed;
#: values below the first edge land in bucket 0, so deep misses are
#: counted, not dropped)
SLACK_EDGES = (-8.0, -4.0, -2.0, -1.0, -0.5, -0.25, -0.1, -0.01, 0.0,
               0.01, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


class Histogram:
    """Fixed-bucket distribution: percentiles without stored samples.

    ``edges`` are inclusive UPPER bucket bounds in increasing order; an
    observation lands in the first bucket whose edge is >= the value,
    or the overflow bucket past the last edge. ``percentile(p)`` walks
    the cumulative counts to the bucket holding the ceil(p/100 * count)
    ranked sample and returns that bucket's upper edge (the overflow
    bucket reports the exact observed max) — an upper bound, exact
    whenever every sample in the bucket sits on the edge (the
    ManualClock tests) and otherwise within one bucket width.
    """

    def __init__(self, name: str, edges=LATENCY_EDGES):
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"edges must be strictly increasing: {edges}")
        if not edges:
            raise ValueError("need at least one bucket edge")
        self.name = name
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def bucket_index(self, v: float) -> int:
        """Index of the bucket ``v`` lands in (len(edges) = overflow)."""
        return bisect.bisect_left(self.edges, v)

    def observe(self, v) -> None:
        v = float(v)
        self.counts[self.bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, p: float) -> float | None:
        """Upper-edge estimate of the p-th percentile (see class doc)."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(self.count * p / 100.0))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.max if i == len(self.edges) \
                    else min(self.edges[i], self.max)
        return self.max   # unreachable: seen == count >= rank

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}

    def as_dict(self) -> dict:
        return {**self.summary(), "edges": list(self.edges),
                "counts": list(self.counts)}

    def reset(self) -> None:
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class CounterGroup:
    """A named family of integer counters with a fixed key set.

    Supports ``group[k] += 1``, ``dict(group)``-style reads through
    ``as_dict``, ``in`` and iteration. ``scope()`` zeroes every counter
    for the duration of a block and restores the outer values on exit,
    so one measurement can never leak into another. Scopes nest.
    """

    def __init__(self, name: str, keys):
        self.name = name
        self._v = dict.fromkeys(keys, 0)

    def __getitem__(self, k):
        return self._v[k]

    def __setitem__(self, k, v) -> None:
        if k not in self._v:
            raise KeyError(
                f"unknown counter {k!r} in group {self.name!r}; "
                f"schema: {tuple(self._v)}")
        self._v[k] = v

    def __contains__(self, k) -> bool:
        return k in self._v

    def __iter__(self):
        return iter(self._v)

    def __len__(self) -> int:
        return len(self._v)

    def items(self):
        return self._v.items()

    def __repr__(self) -> str:
        return f"CounterGroup({self.name!r}, {self._v})"

    def as_dict(self) -> dict:
        return dict(self._v)

    def reset(self) -> None:
        for k in self._v:
            self._v[k] = 0

    @contextlib.contextmanager
    def scope(self):
        """Zero the group for the block; restore outer values on exit."""
        saved = dict(self._v)
        self.reset()
        try:
            yield self
        finally:
            self._v.update(saved)


class MetricsRegistry:
    """Name -> instrument store with get-or-create accessors."""

    def __init__(self):
        self._m: dict[str, object] = {}

    def _get_or_create(self, name: str, cls, factory):
        m = self._m.get(name)
        if m is None:
            m = self._m[name] = factory()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, edges=LATENCY_EDGES) -> Histogram:
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(name, edges))

    def group(self, name: str, keys=()) -> CounterGroup:
        return self._get_or_create(name, CounterGroup,
                                   lambda: CounterGroup(name, keys))

    def register(self, name: str, metric) -> object:
        if name in self._m and self._m[name] is not metric:
            raise ValueError(f"metric {name!r} already registered")
        self._m[name] = metric
        return metric

    def get(self, name: str):
        return self._m.get(name)

    def names(self) -> tuple:
        return tuple(self._m)

    def as_dict(self) -> dict:
        return {name: m.as_dict() for name, m in self._m.items()}

    def reset(self) -> None:
        for m in self._m.values():
            m.reset()
