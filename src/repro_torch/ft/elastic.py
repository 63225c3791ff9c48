"""Elastic scaling + straggler mitigation (``repro/ft/elastic.py``, which
is jax-free; copied, as the port imports nothing of ``repro``).

Failure model (multi-pod TPU): a host (and its chips) drops out; the job
restarts on the surviving hosts with a smaller mesh, restoring from the
latest complete checkpoint. Because

  * checkpoints are mesh-agnostic (full arrays, reshard-on-restore), and
  * the data pipeline is a pure function of (seed, step),

an elastic restart is: pick new mesh -> ``restore_checkpoint(...,
device=new)`` -> continue at ``step+1``. The helpers here pick the new
mesh shape and rebalance work.

Straggler mitigation is data-reweighting: hosts report a step-time EMA;
``rebalance_batch`` shrinks the slow hosts' microbatch share (the global
batch is preserved by growing fast hosts' share), which is the standard
synchronous-SGD mitigation that needs no async machinery.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def plan_mesh(n_chips: int, *, model_parallel: int, pods: int = 1
              ) -> tuple[int, ...]:
    """Largest (pod, data, model) grid fitting n_chips with the requested
    TP degree. Drops stragglers to the biggest full data-parallel row."""
    per_pod = n_chips // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError("not enough chips for the TP degree")
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


def survivors_mesh(old_shape: tuple, failed_hosts: list[int],
                   chips_per_host: int = 4) -> tuple:
    """New mesh shape after dropping failed hosts (keep TP degree, shrink
    the data axis; a pod that loses its last data row is dropped)."""
    *lead, model = old_shape
    n_old = int(np.prod(old_shape))
    n_left = n_old - len(failed_hosts) * chips_per_host
    if len(lead) == 2:                       # (pod, data, model)
        pods = lead[0]
        data = max(n_left // (pods * model), 1)
        return (pods, data, model)
    data = max(n_left // model, 1)
    return (data, model)


@dataclasses.dataclass
class StragglerMonitor:
    """Per-host step-time EMAs -> batch share rebalancing."""

    n_hosts: int
    alpha: float = 0.2
    tolerance: float = 1.3      # hosts slower than 1.3x median get shrunk

    def __post_init__(self):
        self.ema = np.zeros(self.n_hosts)

    def observe(self, host: int, seconds: float) -> None:
        e = self.ema[host]
        self.ema[host] = seconds if e == 0 else \
            (1 - self.alpha) * e + self.alpha * seconds

    def stragglers(self) -> list[int]:
        med = np.median(self.ema[self.ema > 0]) if (self.ema > 0).any() else 0
        if med == 0:
            return []
        return [h for h in range(self.n_hosts)
                if self.ema[h] > self.tolerance * med]

    def rebalance_batch(self, global_batch: int, granule: int = 1
                        ) -> list[int]:
        """Per-host microbatch sizes ∝ 1/step-time (granule-rounded),
        preserving the global batch."""
        if not (self.ema > 0).all():
            base = global_batch // self.n_hosts
            return [base] * self.n_hosts
        speed = 1.0 / self.ema
        share = speed / speed.sum() * global_batch
        sizes = np.maximum((share // granule) * granule, granule).astype(int)
        # fix rounding drift onto the fastest host
        sizes[int(np.argmax(speed))] += global_batch - sizes.sum()
        return sizes.tolist()
