"""``ExecutionSpec`` — the frozen description of HOW a coloring runs
(``repro/exec/spec.py``).

The host regime (the per-iteration host loop), the outlined regime (one
chunk per capacity bucket) and the distributed regime (the sharded Pipe,
dense or boundary exchange) run a spec on one graph; lane batching (``run_batch``, the
stream service) replays the host regime on many graphs at once and checks
its spec with ``validate_batchable``. The port has no ``impl`` or
``tile_rows`` knob: on a CUDA device the steps always run its kernels.
"""
from __future__ import annotations

import dataclasses

REGIMES = ("host", "outlined", "dist")

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

    def validate_batchable(self):
        """Check this spec can run lane-batched — the admission contract
        shared by ``Session.run_batch`` and the stream service
        (``exec/batch.py``, ``serve/stream.py``). Returns the resolved
        algorithm. Lane batching replays the host regime per lane, with
        the D/S trace rebuilt from per-lane counts against a monotone
        policy threshold."""
        alg = self.resolved_algo()
        if self.regime != "host":
            raise ValueError(
                f"lane-batched execution replays host-regime semantics "
                f"(fused default, window/policy resolution) and would "
                f"silently ignore the {self.regime!r} regime's knobs; "
                "pass a spec with regime='host'")
        if not alg.batch_safe:
            raise ValueError(
                f"algorithm {alg.name!r} is not batch-safe: "
                f"{alg.batch_unsafe_reason or 'no declared batch contract'}")
        if self.mode.startswith("dist-") or self.mode == "hybrid-auto":
            raise ValueError(
                f"lane-batched execution cannot replay mode {self.mode!r} "
                "per lane: the batched Pipe needs a monotone per-lane "
                "count threshold (hybrid / topology / data)")
        return alg

    def static_key(self) -> tuple:
        """The spec half of a session cache key: every field, the
        algorithm as its resolved (frozen, hashable) instance."""
        return (self.regime, self.mode, self.resolved_algo(), self.layout,
                self.h, self.window, self.bucket_ratio, self.max_iter,
                self.priority, self.fused, self.n_shards, self.balance,
                self.exchange)


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
