"""``jpl`` — Luby-style random-priority independent-set coloring as a
worklist algorithm (Jones–Plassmann–Luby; the port of
``repro/algos/jpl.py``).

Each round r draws a fresh random priority per *active* node (a uint32
mixer of (node id, r)); nodes beating every active neighbour take color
2r, nodes strictly below every active neighbour take 2r+1 (the two-sided
trick: two color classes per round). There is no resolve phase, so a
round's assignments are final. Both phases maintain the persistent dual
worklist (active = still uncolored), so the hybrid Pipe drives JPL exactly
like IPGC. The round counter is the algorithm's ``aux`` state, a 0-d int32
tensor on the graph's device.

Per-phase communication profile (as in the reference):

  * dense round: no gather of the mutable colors array — neighbour
    activity is read from the priority vector, which encodes it;
  * sparse round: exactly one ELL-shaped colors gather (activity of
    neighbours outside the worklist is only knowable from colors).

The row-wise priority extrema go through ``kernels.ops.jpl_extrema``: the
``jpl_prio`` CUDA kernel on a CUDA device, which gathers each row's
neighbour priorities itself (from the dense round's priority table, or
hashed where the colors say a neighbour is uncolored), its plain version
on the CPU.
Like the IPGC steps, the rounds are shape-static and read nothing back.

The palette has per-round gaps (a round may confirm only one of its two
classes), so ``finalize`` compacts it to dense 0..k-1 labels.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.algos.base import Algorithm, _compact_palette
from repro_torch.core import ipgc
from repro_torch.core.worklist import (Worklist, compact_items, compact_mask,
                                       full_worklist)
from repro_torch.kernels import ops
from repro_torch.kernels.jpl_prio import LARGE, Hash, Table, round_hash

NO_COLOR = ipgc.NO_COLOR


def _hub_extrema_raw(nh: int, tail_slot: torch.Tensor, tpr: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_hub+1,) per-hub-slot tail-priority extrema; row n_hub is the
    neutral row non-hub nodes gather (max -1 / min LARGE)."""
    slot = tail_slot.to(torch.int64)
    hmax = torch.full((nh + 1,), -1, dtype=torch.int32, device=tpr.device)
    hmax.scatter_reduce_(0, slot, tpr, "amax", include_self=True)
    hmin = torch.full((nh + 1,), LARGE, dtype=torch.int32, device=tpr.device)
    hmin.scatter_reduce_(0, slot, torch.where(tpr >= 0, tpr, LARGE), "amin",
                         include_self=True)
    return hmax, hmin


def _hub_extrema(ig: ipgc.IPGCGraph, tpr: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    return _hub_extrema_raw(ig.n_hub, ig.tail_slot, tpr)


def _decide(pend, pr, nbr_max, nbr_min, rnd, cu):
    """Two-sided independent-set membership -> new colors + newly flags."""
    is_max = pend & (pr > nbr_max)
    is_min = pend & (pr < nbr_min) & ~is_max
    newly = is_max | is_min
    new_c = torch.where(is_max, 2 * rnd,
                        torch.where(is_min, 2 * rnd + 1, cu))
    return new_c, newly


def _jpl_dense(ig: ipgc.IPGCGraph, colors: torch.Tensor, ids: torch.Tensor,
               rnd: torch.Tensor, wl: Worklist, force_hub: "bool | None",
               tile_rows: "int | None" = None
               ) -> tuple[torch.Tensor, Worklist]:
    """A topology-driven JPL round over all N rows: row ``u`` draws
    ``round_hash(ids[u], rnd)`` and takes colors ``2 rnd`` / ``2 rnd + 1``
    (``rnd`` a 0-d round, or one round per row)."""
    n = ig.n_nodes
    active = wl.mask
    cu = colors[:n]
    pend = active & (cu == NO_COLOR)
    pr = torch.where(pend, round_hash(ids, rnd), -1)
    pr_ext = torch.cat([pr, pr.new_full((1,), -1)])

    # the neighbours' priorities, gathered from pr_ext inside the kernel
    nbr_max, nbr_min = ops.jpl_extrema(ig.ell_idx, None, Table(pr_ext),
                                       tile_rows=tile_rows)
    if ipgc._has_hubs(ig, force_hub):
        tpr = torch.where(ig.tail_valid, pr_ext[ig.tail_dst], -1)
        hmax, hmin = _hub_extrema(ig, tpr)
        slot = ig.hub_slot.clamp(max=ig.n_hub)
        nbr_max = torch.maximum(nbr_max, hmax[slot])
        nbr_min = torch.minimum(nbr_min, hmin[slot])

    new_c, newly = _decide(pend, pr, nbr_max, nbr_min, rnd, cu)
    colors2 = torch.cat([new_c, colors[n:]])

    still = active & ~newly
    items, count = compact_mask(still, wl.capacity, n)
    return colors2, Worklist(mask=still, items=items, count=count)


def jpl_dense_step(ig: ipgc.IPGCGraph, colors: torch.Tensor,
                   rnd: torch.Tensor, wl: Worklist, *, window: int = 128,
                   force_hub: "bool | None" = None,
                   tile_rows: "int | None" = None
                   ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    """One topology-driven JPL round over all N rows (``window`` is part of
    the protocol signature; JPL has no mex window and ignores it)."""
    ids = torch.arange(ig.n_nodes, dtype=torch.int32, device=colors.device)
    colors2, wl2 = _jpl_dense(ig, colors, ids, rnd, wl, force_hub, tile_rows)
    return colors2, rnd + 1, wl2


def jpl_lane_dense_step(ig: ipgc.IPGCGraph, colors: torch.Tensor,
                        rnd: torch.Tensor, wl: Worklist, *, window: int = 128,
                        force_hub: "bool | None" = None,
                        tile_rows: "int | None" = None
                        ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    """``jpl_dense_step`` on each lane of a flattened lane group
    (``exec/batch.py``): ``rnd`` holds one round per lane (lanes admitted
    in different rounds of a stream carry different rounds), and each row
    hashes its lane-local id ``u - l * n_pad`` with its own lane's round,
    as the lane's graph alone would."""
    b = rnd.shape[0]
    n_pad = ig.n_nodes // b
    ids = torch.arange(ig.n_nodes, dtype=torch.int32, device=colors.device)
    ids.remainder_(n_pad)
    rows_rnd = rnd[:, None].expand(b, n_pad).reshape(-1)
    colors2, wl2 = _jpl_dense(ig, colors, ids, rows_rnd, wl, force_hub,
                              tile_rows)
    return colors2, rnd + 1, wl2


def jpl_sparse_step(ig: ipgc.IPGCGraph, colors: torch.Tensor,
                    rnd: torch.Tensor, wl: Worklist, *, window: int = 128,
                    force_hub: "bool | None" = None,
                    tile_rows: "int | None" = None
                    ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    """One data-driven JPL round over the gathered C-item worklist.

    Neighbour activity is read from the colors vector here (a neighbour
    that left the worklist long ago is invisible to the items block) —
    the one colors gather of the sparse round. Invalid items all write
    slot N, with the identical values ``colors[N]`` and False, so the
    order of those duplicate writes cannot change the result.
    """
    n = ig.n_nodes
    items = wl.items
    valid = items < n
    safe = torch.where(valid, items, 0)
    ids = torch.where(valid, items, n)

    cu = colors[ids]                       # pad -> PAD_COLOR
    pend = valid & (cu == NO_COLOR)
    pr = torch.where(pend, round_hash(items, rnd), -1)

    # the one colors gather, inside the kernel (invalid items: empty rows)
    ipgc._count_kernel_gather()
    nbr_max, nbr_min = ops.jpl_extrema(ig.ell_idx, items, Hash(colors, rnd),
                                       tile_rows=tile_rows)
    if ipgc._has_hubs(ig, force_hub):
        tc = colors[ig.tail_dst]
        tpr = torch.where(ig.tail_valid & (tc == NO_COLOR),
                          round_hash(ig.tail_dst, rnd), -1)
        hmax, hmin = _hub_extrema(ig, tpr)
        slot = ig.hub_slot[safe].clamp(max=ig.n_hub)
        nbr_max = torch.maximum(nbr_max, torch.where(valid, hmax[slot], -1))
        nbr_min = torch.minimum(nbr_min,
                                torch.where(valid, hmin[slot], LARGE))

    new_c, newly = _decide(pend, pr, nbr_max, nbr_min, rnd, cu)
    colors2 = ipgc._set_rows(colors, ids, torch.where(valid, new_c, cu))

    still = pend & ~newly
    new_items, count = compact_items(items, still, n)
    mask = ipgc._set_rows_drop(wl.mask, ids, still)
    return colors2, rnd + 1, Worklist(mask=mask, items=new_items, count=count)


# ---------------------------------------------------------------------------
# distributed JPL rounds
# ---------------------------------------------------------------------------
#
# Shard-safety rests on two facts (DESIGN.md §§7+13):
#   * priorities are owner-computable: ``round_hash(global id, round)``
#     needs no exchange — any shard derives a ghost's priority locally;
#   * neighbour activity is readable from colors: JPL never uncolors, so
#     the persistent-worklist invariant specialises to
#     ``mask == (colors == NO_COLOR)`` in every round, making
#     ``where(colors[nbr] == NO_COLOR, round_hash(nbr, r), -1)`` exactly
#     the host step's ``pr_ext[nbr]`` (the sentinel slot N holds PAD_COLOR,
#     so pad lanes read -1).
# A round is single-phase, so each distributed round makes exactly ONE
# color exchange (the additive one, or a packed boundary publish), and the
# round counter stays a replicated scalar.


def make_jpl_dist_steps(ig: ipgc.IPGCGraph, mesh, *,
                        exchange: str = "dense", boundary=None,
                        thresh: "int | None" = None,
                        tile_rows: "int | None" = None):
    """(dense_round, sparse_round) over the mesh, equal to
    ``jpl_dense_step``/``jpl_sparse_step`` on the partitioned graph; the
    state is ``core.distributed.shard_state``'s. ``exchange``,
    ``boundary`` and ``thresh`` as in
    ``core.distributed.make_dist_dense_step``: with the boundary exchange
    the colors are per-shard views and a round takes ``bcap`` and returns
    ``xstats`` too."""
    from repro_torch.core import distributed as dist

    shards = dist.shard_graph(ig, mesh)
    n, nh = ig.n_nodes, ig.n_hub
    publisher = dist._Publisher(mesh, shards, n, exchange, boundary, thresh)

    def nbr_extrema(sig, colors, rnd, r=None):
        """The extrema of all the shard's rows (``r`` None) or of its sparse
        rows ``r``, whose pad lanes get the neutral hub extrema."""
        # the kernel gathers the rows' neighbours and hashes the uncolored
        rows = None if r is None else r.rows
        nbr_max, nbr_min = ops.jpl_extrema(sig.ell_idx, rows,
                                           Hash(colors, rnd),
                                           tile_rows=tile_rows)
        if nh > 0:
            tc = colors[sig.tail_dst]
            tpr = torch.where(sig.tail_valid & (tc == NO_COLOR),
                              round_hash(sig.tail_dst, rnd), -1)
            hmax, hmin = _hub_extrema(sig, tpr)
            if r is None:
                hmax, hmin = hmax[sig.hub_slot], hmin[sig.hub_slot]
            else:
                slot = sig.hub_slot[r.local]
                hmax = torch.where(r.valid, hmax[slot], -1)
                hmin = torch.where(r.valid, hmin[slot], LARGE)
            nbr_max = torch.maximum(nbr_max, hmax)
            nbr_min = torch.minimum(nbr_min, hmin)
        return nbr_max, nbr_min

    def dense_local(sh, colors, rnd, mask_l):
        cu = colors[sh.lo:sh.hi]
        pend = mask_l & (cu == NO_COLOR)
        pr = torch.where(pend, round_hash(sh.row_ids, rnd), -1)
        nbr_max, nbr_min = nbr_extrema(sh.ig, colors, rnd)
        new_c, newly = _decide(pend, pr, nbr_max, nbr_min, rnd, cu)
        return dist._Writes(None, cu, new_c), mask_l & ~newly

    def sparse_local(sh, colors, rnd, items_l):
        r = dist._sparse_rows(sh, colors, items_l)
        pend = r.valid & (r.cu == NO_COLOR)
        pr = torch.where(pend, round_hash(r.ids, rnd), -1)
        nbr_max, nbr_min = nbr_extrema(sh.ig, colors, rnd, r)
        new_c, newly = _decide(pend, pr, nbr_max, nbr_min, rnd, r.cu)
        writes = dist._Writes(r.ids, r.cu, torch.where(r.valid, new_c, r.cu))
        return writes, r, pend & ~newly

    def dense_round(colors, rnd, wl, pub):
        writes, still = zip(*(
            dense_local(sh, c, rd, b.mask)
            for sh, c, rd, b in zip(shards, colors, rnd, wl.blocks)))
        colors_out = pub(colors, writes)
        blocks = []
        for sh, st in zip(shards, still):
            items, count = compact_items(sh.row_ids, st, n)
            blocks.append(Worklist(mask=st, items=items, count=count))
        return (colors_out, tuple(rd + 1 for rd in rnd),
                dist._worklist(mesh, blocks))

    def sparse_round(colors, rnd, wl, pub):
        writes, rows, still = zip(*(
            sparse_local(sh, c, rd, b.items)
            for sh, c, rd, b in zip(shards, colors, rnd, wl.blocks)))
        colors_out = pub(colors, writes)
        blocks = []
        for sh, b, r, st in zip(shards, wl.blocks, rows, still):
            items, count = compact_items(b.items, st, n)
            mask = ipgc._set_rows_drop(
                b.mask, torch.where(r.valid, r.local, sh.hi - sh.lo), st)
            blocks.append(Worklist(mask=mask, items=items, count=count))
        return (colors_out, tuple(rd + 1 for rd in rnd),
                dist._worklist(mesh, blocks))

    # a JPL round is single-phase: one exchange
    return publisher.bind(dense_round, 1), publisher.bind(sparse_round, 1)


@dataclasses.dataclass(frozen=True)
class JPL(Algorithm):
    name: str = "jpl"
    #: shard-safe: a round's priorities are owner-computable and neighbour
    #: activity is readable from the exchanged colors (see
    #: ``make_jpl_dist_steps``)
    shard_safe: bool = True
    #: a round hashes lane-local ids with its lane's round
    #: (``jpl_lane_dense_step``), so a lane equals the graph alone
    batch_safe: bool = True
    uses_window: bool = False

    def init_state(self, ig):
        n = ig.n_nodes
        return (ipgc.init_colors(n, ig.device),
                torch.zeros((), dtype=torch.int32, device=ig.device),
                full_worklist(n, ig.device))

    def step_fns(self, fused: bool):
        # a JPL round is already single-phase; fused == two-phase here
        return jpl_dense_step, jpl_sparse_step

    def lane_step(self, fused: bool):
        return jpl_lane_dense_step

    def resolve_fused(self, fused, *, default):
        return False                      # single step family

    def make_dist_steps(self, ig, mesh, *, window: int, fused: bool,
                        exchange: str = "dense", boundary=None,
                        thresh: "int | None" = None,
                        tile_rows: "int | None" = None):
        # window and fused are protocol arguments JPL ignores (no mex
        # window, one step family), as in the host steps
        return make_jpl_dist_steps(ig, mesh, exchange=exchange,
                                   boundary=boundary, thresh=thresh,
                                   tile_rows=tile_rows)

    def finalize(self, colors):
        return _compact_palette(colors)

    def check_invariants(self, result, g=None):
        super().check_invariants(result, g)
        # each round confirms at most two color classes
        if result.n_colors > 2 * max(result.iterations, 1):
            raise AssertionError(f"jpl: {result.n_colors} colors from "
                                 f"{result.iterations} rounds")
