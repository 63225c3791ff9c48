"""Run reports (``repro/obs/report.py``): ``RunReport``, the structured
record of a run, and the byte accounting of the distributed Pipe.

A traced ``Session.run`` (``trace=True`` or an ``obs.Trace``) returns a
``RunReport``: the run's ``ColoringResult`` under ``.result``, its spans,
the per-iteration launch, gather and exchange profiles of its steps with
their whole-run totals (``totals_from_trace``), the dist regime's
exchange ledger (``exchange_section``), a compile-vs-execute time split
and a cache snapshot. ``Session.run_batch(trace=)`` and
``StreamSession.report()`` return service-level reports. ``to_json()``
emits the JSON-safe schema (the colors array and the live trace
excluded).

Pure Python: it imports nothing of the engine.
"""
from __future__ import annotations

import dataclasses
import json


def totals_from_trace(mode_trace: str, per_iter: dict) -> dict:
    """Whole-run totals from the D/S trace x per-iteration profiles.

    ``per_iter`` maps ``"dense"``/``"sparse"`` -> {kind: count per
    iteration}; the result sums each kind over the actual iteration mix.
    """
    nd = mode_trace.count("D")
    ns = mode_trace.count("S")
    dense = per_iter.get("dense", {}) or {}
    sparse = per_iter.get("sparse", {}) or {}
    keys = sorted(set(dense) | set(sparse))
    return {k: nd * dense.get(k, 0) + ns * sparse.get(k, 0) for k in keys}


def dense_exchange_bytes(n_global: int) -> int:
    """Per-shard bytes of ONE ``color_psum``: the summed delta is an
    ``int32[n_global + 1]`` (the +1 is the gather-sentinel slot),
    independent of the edge count."""
    return 4 * (n_global + 1)


def dense_swap_bytes(n_global: int) -> int:
    """Per-shard bytes of ONE ``dense_swap`` fallback: the all-gather of
    the disjoint owned ``int32`` blocks reassembles exactly ``n_global``
    slots (no sentinel: slot n stays local)."""
    return 4 * n_global


def packed_exchange_bytes(bcap: int, n_shards: int) -> int:
    """Per-shard bytes of ONE ``boundary_pack`` exchange at capacity
    ``bcap``: the (id, color) planes, ``int32[bcap]`` each, of every
    shard land on every shard."""
    return 8 * bcap * n_shards


def exchange_section(per_iter: dict, n_global: int, mode_trace: str, *,
                     exchange: str = "dense", n_shards: int = 1,
                     exchange_trace: str = "",
                     exchange_bytes=()) -> dict:
    """The distributed regime's communication accounting, path-aware
    (DESIGN.md §13).

    ``per_iter`` maps ``"dense"``/``"sparse"`` -> the exchange-kind counts
    of one step (``color_psum`` on the dense exchange path;
    ``boundary_pack`` AND ``dense_swap`` on the boundary paths, whose
    publish computes both and selects one on the device); which one each
    iteration took is the ``exchange_trace``/``exchange_bytes`` ledger the
    host loop recorded.
    """
    bytes_per_iter = [int(b) for b in exchange_bytes]
    if exchange == "dense" and not bytes_per_iter:
        payload = dense_exchange_bytes(n_global)
        bytes_per_iter = [per_iter.get(
            "dense" if m == "D" else "sparse", {}).get("color_psum", 0)
            * payload for m in mode_trace]

    # executed exchanges: each publish takes exactly ONE of its paths, so
    # count publishes (color_psum on the dense path, boundary_pack ==
    # dense_swap == publish sites on the boundary paths)
    def _epi(m):
        d = per_iter.get("dense" if m == "D" else "sparse", {})
        return d.get("color_psum", 0) or d.get("boundary_pack", 0)

    total = sum(_epi(m) for m in mode_trace)
    return {
        "exchange": exchange,
        "per_iter": per_iter,
        "payload_bytes": {
            "color_psum": dense_exchange_bytes(n_global),
            "dense_swap": dense_swap_bytes(n_global),
            "packed_per_slot": 8 * n_shards,   # x bcap = boundary_pack
        },
        "trace": exchange_trace,
        "bytes_per_iter": bytes_per_iter,
        "total_bytes": sum(bytes_per_iter),
        "total": total,
    }


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
