"""``ipgc`` — the paper's engine behind the Algorithm protocol: pure
delegation to ``core/ipgc.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.algos.base import Algorithm, init_ipgc_state
from repro_torch.core import ipgc


@dataclasses.dataclass(frozen=True)
class IPGC(Algorithm):
    name: str = "ipgc"
    shard_safe: bool = True
    batch_safe: bool = True
    default_priority: str = "hash"

    def init_state(self, ig):
        return init_ipgc_state(ig)

    def step_fns(self, fused: bool):
        return ipgc.step_fns(fused)

    def make_dist_steps(self, ig, mesh, *, window: int, fused: bool,
                        exchange: str = "dense", boundary=None,
                        thresh: "int | None" = None,
                        tile_rows: "int | None" = None):
        from repro_torch.core.distributed import (make_dist_dense_step,
                                                  make_dist_sparse_step)
        kw = dict(window=window, fused=fused, exchange=exchange,
                  boundary=boundary, thresh=thresh, tile_rows=tile_rows)
        return (make_dist_dense_step(ig, mesh, **kw),
                make_dist_sparse_step(ig, mesh, **kw))
