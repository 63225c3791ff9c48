"""Hybrid switching policies (``repro/core/policy.py``).

The paper: pick topology-driven when the worklist size is > H * |V| (H
tuned empirically, ~0.6 on a Quadro P5000). The paper's fixed-H policy,
the two degenerate policies (the baselines), and an auto-tuned policy that
estimates the crossover from timed iterations.

Every built-in policy also has a device-side form, an int32 count
threshold ``t`` with ``count > t`` meaning dense: the outlined regime
fixes it for a whole chunk, so the policy is not called inside one.
``device_threshold`` derives it for any monotone callable by bisection,
and ``AutoTuned`` refreshes it between chunks through ``observe_chunk``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

# A policy maps (count, n_nodes) -> True for dense (topology) mode.
Policy = Callable[[int, int], bool]


@dataclasses.dataclass(frozen=True)
class FixedH:
    """The paper's policy: dense while count > h * n."""

    h: float = 0.6

    def __call__(self, count: int, n: int) -> bool:
        return count > self.h * n

    def threshold(self, n: int) -> int:
        # count is integral, so count > h*n  <=>  count > floor(h*n)
        return int(self.h * n)


@dataclasses.dataclass(frozen=True)
class AlwaysDense:
    def __call__(self, count: int, n: int) -> bool:
        return True

    def threshold(self, n: int) -> int:
        return -1


@dataclasses.dataclass(frozen=True)
class AlwaysSparse:
    def __call__(self, count: int, n: int) -> bool:
        return False

    def threshold(self, n: int) -> int:
        return n  # count <= n always, so count > n is never true


def device_threshold(pol: Policy, n: int) -> int:
    """Int threshold t with ``pol(count, n) == (count > t)`` for monotone
    policies. Built-ins answer directly; other callables are bisected."""
    thr = getattr(pol, "threshold", None)
    if thr is not None:
        return int(thr(n))
    lo, hi = 0, n + 1          # invariant: pol flips somewhere in (lo, hi]
    if pol(lo, n):
        return -1
    if not pol(hi - 1, n) and not pol(hi, n):
        return n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if pol(mid, n):
            hi = mid
        else:
            lo = mid
    return lo


@dataclasses.dataclass
class AutoTuned:
    """Estimate H from per-mode cost models fitted online.

    Model: dense iteration cost ~ a_d (constant in count); sparse
    iteration cost ~ b_s * count. Once both modes have a timed sample,
    go sparse as soon as the predicted sparse cost undercuts the dense
    cost; until then follow the paper's fixed-H prior.
    """

    prior_h: float = 0.6
    dense_cost: "float | None" = None
    sparse_unit: "float | None" = None  # seconds per worklist slot

    def __call__(self, count: int, n: int) -> bool:
        if self.dense_cost is None or self.sparse_unit is None:
            return count > self.prior_h * n
        return self.sparse_unit * count > self.dense_cost

    def threshold(self, n: int) -> int:
        if self.dense_cost is None or self.sparse_unit is None:
            return int(self.prior_h * n)
        return min(n, int(self.dense_cost / max(self.sparse_unit, 1e-12)))

    def observe(self, dense: bool, count: int, n: int,
                seconds: float) -> None:
        if dense:
            self.dense_cost = seconds if self.dense_cost is None else (
                0.7 * self.dense_cost + 0.3 * seconds)
        else:
            unit = seconds / max(count, 1)
            self.sparse_unit = unit if self.sparse_unit is None else (
                0.7 * self.sparse_unit + 0.3 * unit)

    def observe_chunk(self, dense_iters: int, sparse_iters: int,
                      mean_count: float, seconds: float) -> None:
        """The outlined regime's hook: one timing covers a whole chunk, so
        the per-iteration cost goes to the chunk's majority mode (coarse,
        but the estimate only steers the next chunk's threshold)."""
        iters = dense_iters + sparse_iters
        if iters == 0:
            return
        per_iter = seconds / iters
        if dense_iters >= sparse_iters:
            self.observe(True, int(mean_count), 0, per_iter)
        else:
            self.observe(False, int(max(mean_count, 1)), 0, per_iter)


def make_policy(mode: str, h: float = 0.6) -> Policy:
    # "dist-hybrid" etc. select the distributed Pipe at the dispatch layer;
    # the switching policy is the same, fed the global count (DESIGN.md §6)
    if mode.startswith("dist-"):
        mode = mode[len("dist-"):]
    if mode == "hybrid":
        return FixedH(h)
    if mode == "hybrid-auto":
        return AutoTuned(prior_h=h)
    if mode in ("topology", "dense"):
        return AlwaysDense()
    if mode in ("data", "sparse", "plain"):
        return AlwaysSparse()
    raise ValueError(f"unknown mode {mode!r}")


def exchange_threshold(n: int, n_shards: int, exchange: str) -> int:
    """Changed-boundary-count threshold of the distributed packed publish
    (DESIGN.md §13): ``"boundary"`` packs whenever the buffer fits
    (``n + 1``), ``"auto"`` below the byte break-even ``(n+1) / (2S)``;
    ``"dense"`` never consults one and gets -1."""
    if exchange == "dense":
        return -1
    if exchange == "boundary":
        return n + 1
    if exchange == "auto":
        return max(8, (n + 1) // (2 * max(n_shards, 1)))
    raise ValueError(f"unknown exchange {exchange!r}; valid: "
                     "('dense', 'boundary', 'auto')")


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
