"""Run reports (``repro/obs/report.py``): ``RunReport``, the structured
record of a run, and the byte accounting of the distributed Pipe.

``Session.run_batch(trace=)`` and ``StreamSession.report()`` return a
``RunReport``; a traced ``Session.run`` (with its launch, gather and
exchange profiles, ``totals_from_trace`` and ``exchange_section``) is not
ported yet (ROADMAP Queue A item 7). ``to_json()`` emits the JSON-safe
schema (the colors array and the live trace excluded).
"""
from __future__ import annotations

import dataclasses
import json


def dense_exchange_bytes(n_global: int) -> int:
    """Per-shard bytes of ONE ``color_psum``: the summed delta is an
    ``int32[n_global + 1]`` (the +1 is the gather-sentinel slot),
    independent of the edge count."""
    return 4 * (n_global + 1)


@dataclasses.dataclass
class RunReport:
    """Everything one run did, in one place. See module docstring."""

    #: dispatch regime ("host" / "outlined" / "dist" / "batch" /
    #: "stream" — the latter two are service-level aggregates)
    regime: str = ""
    algo: str = ""
    graph: str = ""
    n_nodes: int = 0
    n_colors: int = 0
    iterations: int = 0
    mode_trace: str = ""
    host_dispatches: int = 0
    #: live worklist size entering each host dispatch
    counts: list = dataclasses.field(default_factory=list)
    #: total / dispatch / first / best / compile proxy / host overhead
    timing: dict = dataclasses.field(default_factory=dict)
    #: {"per_iter": {"dense": {...}, "sparse": {...}}, "total": {...}}
    launches: dict = dataclasses.field(default_factory=dict)
    #: same shape, counting mutable-color ELL gathers
    gathers: dict = dataclasses.field(default_factory=dict)
    #: dist only (None elsewhere): see ``exchange_section``
    exchanges: "dict | None" = None
    #: owning session's CacheStats snapshot + this run's delta
    cache: dict = dataclasses.field(default_factory=dict)
    #: the wrapped ColoringResult (None for service-level reports)
    result: object = None
    #: the live Trace, when the run was traced
    trace: object = None
    #: regime-specific additions (stream counters, batch lane stats...)
    extra: dict = dataclasses.field(default_factory=dict)

    # -- ColoringResult passthroughs -----------------------------------------

    @property
    def colors(self):
        return getattr(self.result, "colors", None)

    @property
    def tti(self):
        return getattr(self.result, "tti", [])

    @property
    def total_seconds(self) -> float:
        return self.timing.get("total_seconds", 0.0)

    # -- export --------------------------------------------------------------

    def to_json(self, *, include_chrome: bool = False) -> dict:
        """The JSON-safe report schema (DESIGN.md §12). Excludes the
        colors array and the live trace object; ``include_chrome``
        embeds the Chrome-trace export under ``"chrome_trace"``."""
        out = {
            "regime": self.regime, "algo": self.algo, "graph": self.graph,
            "n_nodes": int(self.n_nodes), "n_colors": int(self.n_colors),
            "iterations": int(self.iterations),
            "mode_trace": self.mode_trace,
            "host_dispatches": int(self.host_dispatches),
            "counts": [int(c) for c in self.counts],
            "timing": dict(self.timing),
            "launches": self.launches, "gathers": self.gathers,
            "exchanges": self.exchanges, "cache": dict(self.cache),
            "extra": self.extra,
        }
        if include_chrome and self.trace is not None:
            out["chrome_trace"] = self.trace.to_chrome()
        json.dumps(out)   # loud schema guarantee: always serialisable
        return out
