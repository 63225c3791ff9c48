"""``ExecutionSpec`` — the frozen description of HOW a coloring runs
(``repro/exec/spec.py``).

The host regime (the per-iteration host loop), the outlined regime (one
chunk per capacity bucket) and the distributed regime (the sharded Pipe,
dense exchange) are ported. Lane batching is named here so that asking
for it fails with the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses

REGIMES = ("host", "outlined", "dist")

#: regimes of the reference the port does not run yet -> ROADMAP item
NOT_PORTED = {
    "batch": "lane batching is not ported yet (ROADMAP Queue A item 6)",
}


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """Static execution configuration of a coloring run."""

    #: dispatch regime: "host", "outlined" or "dist"
    regime: str = "host"
    #: policy mode ("hybrid" / "topology" / "data" / "hybrid-auto"; a
    #: "dist-" prefix is accepted and stripped by make_policy)
    mode: str = "hybrid"
    #: registry name or frozen Algorithm instance
    algo: "str | object" = "ipgc"
    #: engine-level LayoutPlan override (kind string / LayoutPlan / None)
    layout: "str | object | None" = None
    h: float = 0.6
    window: "int | str" = "auto"
    bucket_ratio: int = 2
    max_iter: int = 10_000
    priority: str = "hash"
    #: step family; None resolves per regime (host two-phase, outlined per
    #: device type, dist fused)
    fused: "bool | None" = None
    #: dist regime only: shard count (None = one per visible CUDA device)
    n_shards: "int | None" = None
    #: dist regime only: degree-balance the partition
    balance: bool = True
    #: dist regime only: cross-shard color publication path; only
    #: "dense" (the additive psum of the full vector) is ported
    exchange: str = "dense"

    def __post_init__(self):
        if self.regime not in REGIMES:
            raise ValueError(
                f"unknown regime {self.regime!r}; valid: {REGIMES}")
        if self.exchange not in ("dense", "boundary", "auto"):
            raise ValueError(
                f"unknown exchange {self.exchange!r}; valid: "
                "('dense', 'boundary', 'auto')")

    def resolved_algo(self):
        from repro_torch.algos import get_algorithm
        return get_algorithm(self.algo)


def spec_for(*, mode: str = "hybrid", algo: "str | object" = "ipgc",
             h: float = 0.6, window: "int | str" = "auto",
             bucket_ratio: int = 2, max_iter: int = 10_000,
             priority: str = "hash", fused: "bool | None" = None,
             outline: "bool | None" = None,
             layout: "str | object | None" = None,
             n_shards: "int | None" = None, balance: bool = True,
             exchange: str = "dense") -> ExecutionSpec:
    """Map the ``engine.color`` keyword surface onto a spec:
    ``mode="dist-*"`` selects the distributed regime, then ``outline``
    (None consults ``engine.outline_default()``) the outlined one, else
    the host loop."""
    if mode.startswith("dist-"):
        regime = "dist"
    else:
        if outline is None:
            from repro_torch.core.engine import outline_default
            outline = outline_default()
        regime = "outlined" if outline else "host"
    return ExecutionSpec(regime=regime, mode=mode, algo=algo, layout=layout,
                         h=h, window=window, bucket_ratio=bucket_ratio,
                         max_iter=max_iter, priority=priority, fused=fused,
                         n_shards=n_shards, balance=balance,
                         exchange=exchange)
