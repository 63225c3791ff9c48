"""``ipgc`` — the paper's engine behind the Algorithm protocol: pure
delegation to ``core/ipgc.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.algos.base import Algorithm, init_ipgc_state
from repro_torch.core import ipgc


@dataclasses.dataclass(frozen=True)
class IPGC(Algorithm):
    name: str = "ipgc"
    default_priority: str = "hash"

    def init_state(self, ig):
        return init_ipgc_state(ig)

    def step_fns(self, fused: bool):
        return ipgc.step_fns(fused)
