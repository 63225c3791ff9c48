"""Injectable clocks for the streaming service's latency accounting.

``StreamSession`` stamps every request at enqueue, admit and drain
through one ``clock()`` callable (``time.perf_counter`` by default).
Tests inject a ``ManualClock`` so the accounting identities — monotone
timestamps, queue wait + service time == total latency — are checked
against exact values instead of wall-clock noise.
"""
from __future__ import annotations


class ManualClock:
    """A deterministic clock advanced explicitly (or by a fixed tick).

    ``tick`` > 0 auto-advances on every read, so consecutive stamps are
    strictly increasing without any test bookkeeping; ``advance`` models
    time passing between scheduler events. Never goes backwards —
    ``advance`` rejects negative steps, preserving the monotonicity the
    latency identities rely on.
    """

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        if tick < 0:
            raise ValueError(f"tick must be >= 0, got {tick}")
        self.now = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.now
        self.now += self.tick
        return t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance by {dt}: clock is monotone")
        self.now += float(dt)
