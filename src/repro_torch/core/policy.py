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

The stream service's two scheduling policies live here too: a chunk
policy (how many trips a lane group runs per dispatch) and an admission
policy (which queued request gets a free lane).
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


def fixed_h(h: float = 0.6) -> Policy:
    return FixedH(h)


def always_dense() -> Policy:
    return AlwaysDense()


def always_sparse() -> Policy:
    return AlwaysSparse()


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


def measure_launches(step_impl, ig, colors, aux, wl, **step_kw) -> dict:
    """Kernel-launch accounting for ONE step (DESIGN.md §10): the
    ``ipgc.LAUNCH_COUNTS`` delta of one run of ``step_impl(ig, colors,
    aux, wl, **step_kw)`` on clones of the state (the caller's tensors are
    never touched).

    The dict maps pass kind -> launches per iteration (``fused`` /
    ``mex`` / ``conflict`` / ``compact``); a one-launch fused iteration
    is ``{"fused": 1}`` with every other kind 0. The reference traces the
    step abstractly; the port counts when the step runs, so the step runs
    once, inside ``LAUNCH_COUNTS.scope()`` and
    ``kernels._build.KERNEL_LAUNCHES.scope()``: the caller's counts of
    both groups are restored afterwards, so a measurement never shows in
    surrounding accounting, nor surrounding accounting in it.
    """
    from repro_torch.core import ipgc
    from repro_torch.kernels._build import KERNEL_LAUNCHES

    state = (colors.clone(), aux.clone(),
             dataclasses.replace(wl, mask=wl.mask.clone(),
                                 items=wl.items.clone(),
                                 count=wl.count.clone()))
    with ipgc.LAUNCH_COUNTS.scope() as lc, KERNEL_LAUNCHES.scope():
        step_impl(ig, *state, **step_kw)
        return lc.as_dict()


# ---------------------------------------------------------------------------
# chunk-size policies — the REFILL cadence of the streaming service
# ---------------------------------------------------------------------------
#
# The hybrid H policy above decides dense-vs-sparse per iteration; a chunk
# policy decides how many iterations a streamed lane group runs per device
# dispatch before the scheduler may harvest drained lanes and refill them
# from the queue (serve/stream.py, DESIGN.md §11). Chunk size is a pure
# performance knob: per-request results are bit-identical for any cadence
# (chunk boundaries only partition the trips of independent lanes), so
# these policies trade dispatch overhead (large chunks) against
# lane idle time between a drain and its refill (small chunks).


@dataclasses.dataclass
class FixedChunk:
    """Constant refill cadence: every dispatch runs ``iters`` iterations."""

    iters: int = 8

    def __call__(self) -> int:
        return max(int(self.iters), 1)

    def observe_round(self, drained: int, resident: int, trips: int) -> None:
        pass


@dataclasses.dataclass
class AdaptiveChunk:
    """Drain-rate-steered refill cadence.

    A chunk that drained nobody paid a scheduling round for nothing —
    double the cadence (up to ``max_iters``); a chunk that drained half
    or more of its resident lanes left them idle for up to ``iters``
    trips each — halve it (down to ``min_iters``). Deterministic given
    the observed round history, so a replayed request stream makes the
    same cadence decisions.
    """

    min_iters: int = 2
    max_iters: int = 64
    iters: int = 8

    def __call__(self) -> int:
        return max(int(self.iters), 1)

    def observe_round(self, drained: int, resident: int, trips: int) -> None:
        if resident <= 0:
            return
        if drained == 0:
            self.iters = min(self.iters * 2, self.max_iters)
        elif 2 * drained >= resident:
            self.iters = max(self.iters // 2, self.min_iters)


def make_chunk_policy(chunk) -> "FixedChunk | AdaptiveChunk":
    """Resolve a ``StreamConfig.chunk`` knob: an int pins a fixed cadence,
    ``"auto"`` adapts from drain rates, a policy object passes through."""
    if isinstance(chunk, bool):
        raise TypeError(f"chunk must be an int, 'auto' or a policy, got {chunk!r}")
    if isinstance(chunk, int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        return FixedChunk(chunk)
    if chunk == "auto":
        return AdaptiveChunk()
    if callable(chunk) and hasattr(chunk, "observe_round"):
        return chunk
    raise TypeError(
        f"chunk must be an int, 'auto' or a chunk policy object with "
        f"__call__ + observe_round, got {chunk!r}")


# ---------------------------------------------------------------------------
# admission policies — WHO gets the next free lane of the streaming service
# ---------------------------------------------------------------------------
#
# The chunk policies above decide WHEN the scheduler may refill; an
# admission policy decides WHO gets a freed lane (serve/stream.py,
# DESIGN.md §14). It is the serving-side analogue of Chen et al.'s
# priority functions (arXiv 1606.06025): choosing *what* to schedule
# next matters as much as raw step speed. Policies are duck-typed over
# the stream's Ticket objects (``seq`` / ``priority`` / ``deadline_at``
# fields) so this module never imports the serving layer.
#
# Protocol (two methods, both pure w.r.t. scheduler state):
#
#   order(queued, clock)      -> the admission-scan order (a permutation
#                                of ``queued``; the stream validates).
#                                ``clock`` is the service's injectable
#                                timestamp source — call it only if the
#                                decision needs "now", so clock-counting
#                                tests see zero extra reads under FIFO.
#   hopeless(ticket, clock, estimate) -> a reason string to shed the
#                                ticket *instead of admitting it*, or
#                                None. ``estimate`` is the service-time
#                                forecast for the ticket's lane group
#                                (the p90 of the per-rung service-time
#                                histogram in ``obs/metrics.py``), or None
#                                while that rung has no observations.
#
# Admission order never changes per-request results (bit-identity holds
# for any order); it changes who waits — and, under deadlines, who is
# worth admitting at all.


@dataclasses.dataclass(frozen=True)
class FIFOAdmission:
    """Arrival order: oldest ticket first."""

    def order(self, queued, clock) -> list:
        return list(queued)

    def hopeless(self, ticket, clock, estimate) -> "str | None":
        return None


@dataclasses.dataclass(frozen=True)
class PriorityAdmission:
    """Priority classes: higher ``Ticket.priority`` first, FIFO within a
    class (``seq`` tiebreak keeps the sort stable and deterministic)."""

    def order(self, queued, clock) -> list:
        return sorted(queued, key=lambda t: (-t.priority, t.seq))

    def hopeless(self, ticket, clock, estimate) -> "str | None":
        return None


@dataclasses.dataclass(frozen=True)
class EDFAdmission:
    """Earliest-deadline-first with shed-on-hopeless.

    Tickets with deadlines are admitted soonest-deadline-first;
    deadline-less tickets follow in FIFO order. A ticket whose deadline
    cannot be met even if admitted *right now* — ``now + estimate >
    deadline - slack``, with ``estimate`` the observed per-rung service
    time — is shed with a reason instead of occupying a lane that a
    feasible request could use. With no observations yet (``estimate is
    None``) nothing is shed: the policy never guesses.
    """

    #: safety margin subtracted from the deadline before the feasibility
    #: comparison (seconds on the service clock)
    slack: float = 0.0
    #: False = order by deadline but never shed
    shed_hopeless: bool = True

    def order(self, queued, clock) -> list:
        return sorted(
            queued,
            key=lambda t: (t.deadline_at if t.deadline_at is not None
                           else float("inf"), t.seq))

    def hopeless(self, ticket, clock, estimate) -> "str | None":
        if (not self.shed_hopeless or ticket.deadline_at is None
                or estimate is None):
            return None
        now = clock()
        if now + estimate > ticket.deadline_at - self.slack:
            return (f"deadline hopeless: now={now:.6g} + estimated "
                    f"service {estimate:.6g}s exceeds deadline "
                    f"{ticket.deadline_at:.6g}"
                    + (f" - slack {self.slack:.6g}" if self.slack else ""))
        return None


def make_admission_policy(admission
                          ) -> "FIFOAdmission | PriorityAdmission | object":
    """Resolve a ``StreamConfig.admission`` knob: ``"fifo"`` /
    ``"priority"`` / ``"edf"`` name a built-in, a policy object with
    ``order`` + ``hopeless`` passes through."""
    if isinstance(admission, str):
        try:
            return {"fifo": FIFOAdmission, "priority": PriorityAdmission,
                    "edf": EDFAdmission}[admission]()
        except KeyError:
            raise ValueError(
                f"unknown admission policy {admission!r}; valid: "
                "'fifo', 'priority', 'edf' (or a policy object)") from None
    if callable(getattr(admission, "order", None)) and \
            callable(getattr(admission, "hopeless", None)):
        return admission
    raise TypeError(
        "admission must be 'fifo', 'priority', 'edf' or a policy object "
        f"with order + hopeless methods, got {admission!r}")
