"""``spec-greedy`` — speculative first-fit coloring with iterated conflict
repair (Rokos et al.; the port of ``repro/algos/spec_greedy.py``).

Every worklist vertex speculatively takes the first free color of its
window against its neighbours' snapshot colors; conflicts are detected and
repaired in the next sweep, fused with that sweep's re-assignment — the
fused IPGC steps (``ipgc.fused_dense_step`` / ``fused_sparse_step``, the
``fused_compact`` kernel on a CUDA device), which this algorithm reuses.
``resolve_fused`` pins the fused family whatever the caller asks for:
deferred detect-and-repair is the algorithm. Repaired vertices re-run
first-fit against an advancing window base, so the palette can carry
gaps; ``finalize`` compacts it and reports the distinct count.
"""
from __future__ import annotations

import dataclasses

from repro_torch.algos.base import Algorithm, _compact_palette, init_ipgc_state
from repro_torch.core import ipgc


@dataclasses.dataclass(frozen=True)
class SpecGreedy(Algorithm):
    name: str = "spec-greedy"
    #: the distributed fused steps equal the local fused steps (DESIGN.md
    #: §6), so the declaration holds by construction
    shard_safe: bool = True
    batch_safe: bool = True

    def init_state(self, ig):
        return init_ipgc_state(ig)

    def step_fns(self, fused: bool):
        return ipgc.step_fns(True)

    def resolve_fused(self, fused, *, default):
        return True                       # deferred repair IS the algorithm

    def make_dist_steps(self, ig, mesh, *, window: int, fused: bool,
                        exchange: str = "dense", boundary=None,
                        thresh: "int | None" = None,
                        tile_rows: "int | None" = None):
        from repro_torch.core.distributed import (make_dist_dense_step,
                                                  make_dist_sparse_step)
        kw = dict(window=window, fused=True, exchange=exchange,
                  boundary=boundary, thresh=thresh, tile_rows=tile_rows)
        return (make_dist_dense_step(ig, mesh, **kw),
                make_dist_sparse_step(ig, mesh, **kw))

    def finalize(self, colors):
        return _compact_palette(colors)
