"""IPGC — Iterative Parallel Graph Coloring (Deveci et al. 2016), the
algorithm the paper hybridizes; the port of ``repro/core/ipgc.py``.

Two speculative steps per iteration (paper §II-C):
  1. assign: every *active* (uncolored) node takes the mex of its
     neighbours' colors over a sliding color window ``[base, base+W)``
     (a node whose window is exhausted stays active with an advanced base).
  2. resolve: if an edge's endpoints were assigned the same color, exactly
     one endpoint (the one losing a static hash-priority tie-break) is
     uncolored and stays in the worklist.

Every step exists in two phases — *dense* (topology-driven, all N rows,
reads the active mask) and *sparse* (data-driven, the C rows of the
compacted worklist) — and in two families: two-phase (``dense_step``,
``sparse_step``: assign, then resolve on a second gather) and fused
(``fused_dense_step``, ``fused_sparse_step``: resolve of the previous
round and assign of this one on one gather, DESIGN.md §5). All four keep
the full dual worklist.

The row-wise work goes through ``kernels.ops``: on a CUDA device the
hand-written kernels (``mex_window``, ``conflict``, ``compact``,
``fused_compact``, and ``fused_step`` for the distributed steps of
``core/distributed.py``), on the CPU their plain PyTorch versions. Hub tails
(degree > ELL width) fold in through a per-hub forbidden/conflict
side-channel of PyTorch scatters, and the csr-segment layout runs edge-wise
scatters (``kernels/csr_segment.py``).

Every step is shape-static and reads nothing back to the host, so the
Pipe's ``count`` read is the only synchronisation per iteration. The steps
never write to their inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core.worklist import Worklist, compact_items, compact_mask
from repro_torch.device import resolve_device
from repro_torch.graphs import csr
from repro_torch.graphs.csr import Graph
from repro_torch.kernels import csr_segment as kcsr
from repro_torch.kernels import ops
from repro_torch.kernels.csr_segment import flags_at
from repro_torch.obs.metrics import default_registry

NO_COLOR = int(csr.NO_COLOR)
PAD_COLOR = int(csr.PAD_COLOR)

#: the array fields of ``IPGCGraph`` that ``from_numpy`` takes
ARRAY_FIELDS = ("ell_idx", "degrees", "priority", "tail_src", "tail_dst",
                "tail_valid", "tail_slot", "hub_slot", "hub_ids")


@dataclasses.dataclass(frozen=True)
class IPGCGraph:
    """Device-side graph prepared for the coloring engine.

    ``layout_kind`` is the execution-layout dispatch axis (the
    ``LayoutPlan.kind`` the graph was prepared under, DESIGN.md §8): the
    ELL kinds (pure-ell / ell-tail / hub-split) run the ELL row steps,
    ``csr-segment`` runs the edge-wise variants (``edge_src``/``edge_dst``
    populated). Sentinel slots as in the reference: ``ell_idx`` pads to N,
    ``priority[N] = -1``, and colors carry ``colors[N] = PAD_COLOR``.
    """

    n_nodes: int
    ell_width: int
    n_hub: int
    ell_idx: torch.Tensor        # i32[N, K], pad = N
    degrees: torch.Tensor        # i32[N]
    priority: torch.Tensor       # i32[N+1], pad = -1
    tail_src: torch.Tensor       # i32[T] clipped to [0, N-1]
    tail_dst: torch.Tensor       # i32[T], pad = N
    tail_valid: torch.Tensor     # bool[T]
    tail_slot: torch.Tensor      # i32[T] hub slot of tail_src
    hub_slot: torch.Tensor       # i32[N], n_hub for non-hub nodes
    hub_ids: torch.Tensor        # i32[max(n_hub,1)]
    layout_kind: str = "ell-tail"
    edge_src: "torch.Tensor | None" = None   # i32[Ep] clipped, pad -> 0
    edge_dst: "torch.Tensor | None" = None   # i32[Ep], pad = N

    @property
    def device(self) -> torch.device:
        return self.ell_idx.device


def from_numpy(arrays: dict, *, layout_kind: str, device) -> IPGCGraph:
    """Build an ``IPGCGraph`` from host arrays (the ``ARRAY_FIELDS``, plus
    ``edge_src``/``edge_dst`` for csr-segment) — the hand-off from a graph
    prepared elsewhere, e.g. by ``repro.core.ipgc.prepare`` through
    ``np.asarray``. The static sizes follow from the arrays: ``n_hub`` is
    the number of rows whose degree exceeds the ELL width."""
    device = resolve_device(device)

    def put(a):
        a = np.asarray(a)
        if a.dtype != np.bool_:
            a = a.astype(np.int32, copy=False)
        return torch.tensor(a, device=device)   # a copy, never a view

    deg = np.asarray(arrays["degrees"])
    ell = np.asarray(arrays["ell_idx"])
    edges = {}
    if layout_kind == "csr-segment":
        edges = {"edge_src": put(arrays["edge_src"]),
                 "edge_dst": put(arrays["edge_dst"])}
    return IPGCGraph(
        n_nodes=int(deg.shape[0]), ell_width=int(ell.shape[1]),
        n_hub=int(np.count_nonzero(deg > ell.shape[1])),
        **{f: put(arrays[f]) for f in ARRAY_FIELDS},
        layout_kind=layout_kind, **edges)


def prepare(g: Graph, *, priority: str = "hash", plan=None,
            device=None) -> IPGCGraph:
    """priority="hash" (paper engine) or "id" (Kokkos-VB-style tie-break).

    ``plan`` is the ``LayoutPlan`` to execute under (None reads the plan
    the graph was assembled with; ell-tail when it has none). ``device``
    defaults to the CUDA device (see ``repro_torch.device``).
    """
    device = resolve_device(device)
    a = g.arrays
    n = g.n_nodes
    if plan is None:
        plan = getattr(g, "layout", None)
    kind = getattr(plan, "kind", None) or "ell-tail"
    deg = np.asarray(a.degrees)
    # hub rows == rows with tail entries: degree above the ELL width
    hub_ids = np.nonzero(deg > a.ell_width)[0].astype(np.int32)
    n_hub = len(hub_ids)
    hub_slot = np.full(n, n_hub, dtype=np.int32)
    hub_slot[hub_ids] = np.arange(n_hub, dtype=np.int32)
    tail_src = np.asarray(a.tail_src)
    tail_src_safe = np.minimum(tail_src, n - 1)
    pr = (np.asarray(a.priority) if priority == "hash"
          else np.arange(n, dtype=np.int32))
    arrays = dict(
        ell_idx=a.ell_idx, degrees=deg,
        priority=np.concatenate([pr, np.full(1, -1, np.int32)]),
        tail_src=tail_src_safe, tail_dst=a.tail_dst,
        tail_valid=tail_src < n, tail_slot=hub_slot[tail_src_safe],
        hub_slot=hub_slot,
        hub_ids=hub_ids if n_hub else np.zeros(1, np.int32))
    if kind == "csr-segment":
        e = int(np.asarray(a.row_ptr)[-1])
        ep = max(-(-max(e, 1) // 8) * 8, 8)
        es = np.zeros(ep, dtype=np.int32)           # pad lanes inert (ec<0)
        ed = np.full(ep, n, dtype=np.int32)
        es[:e] = np.repeat(np.arange(n, dtype=np.int32), deg)
        ed[:e] = np.asarray(a.col_idx)
        arrays.update(edge_src=es, edge_dst=ed)
    return from_numpy(arrays, layout_kind=kind, device=device)


def padded_graph(n_pad: int, k_pad: int, t_pad: int, nh_pad: int, *,
                 lanes: int = 1, layout_kind: str = "ell-tail",
                 device=None) -> IPGCGraph:
    """Uninitialised arrays of ``lanes`` equal blocks of one shape class
    (``exec/batch.py``'s flattened lane group; one block for
    ``pad_prepared``), to be filled by ``pad_into``. The sentinel row of
    ``priority`` is set."""
    n, t, nh = lanes * n_pad, lanes * t_pad, lanes * nh_pad

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    return IPGCGraph(
        n_nodes=n, ell_width=k_pad, n_hub=nh, ell_idx=empty(n, k_pad),
        degrees=empty(n),
        priority=torch.full((n + 1,), -1, dtype=torch.int32, device=device),
        tail_src=empty(t), tail_dst=empty(t),
        tail_valid=empty(t, dtype=torch.bool), tail_slot=empty(t),
        hub_slot=empty(n),
        hub_ids=torch.zeros(max(nh, 1), dtype=torch.int32, device=device),
        layout_kind=layout_kind)


def _offset_(x: torch.Tensor, old: int, new: int, off: int) -> None:
    """In place: ``x + off``, except entries equal to ``old``, which become
    ``new``."""
    hit = x == old
    x.add_(off).masked_fill_(hit, new)


def pad_into(ig: "IPGCGraph | None", dst: IPGCGraph, lane: int,
             lanes: int) -> None:
    """Write ``ig``, padded to the shape class of ``dst``'s blocks, into
    block ``lane`` of ``dst`` (``lanes`` equal blocks of ``n_pad`` rows,
    ``t_pad`` tail entries and ``nh_pad`` hub slots), in place: its node
    ids offset by ``lane * n_pad``, its hub slots by ``lane * nh_pad``,
    its sentinel ``n`` mapped to ``dst``'s sentinel and its "not a hub"
    slot to ``dst``'s neutral row. ``ig`` None writes an all-padding
    block. The padding is inert by construction:

      * pad nodes (rows ``n..n_pad``) have no ELL entries, degree 0 and
        priority -1; they are nobody's neighbour and never enter the
        worklist, so their colors stay ``PAD_COLOR`` forever;
      * every padding entry of ``ell_idx``/``tail_dst`` is the sentinel
        (so a padded row still ends at its first padding entry);
      * extra tail entries are ``tail_valid=False``; extra hub slots have
        no tail edges, so their forbidden/conflict rows are all-False;
      * non-hub rows and extra tail entries point at the neutral row.
    """
    n_pad, nh_pad = dst.n_nodes // lanes, dst.n_hub // lanes
    t_pad = dst.tail_src.shape[0] // lanes
    sentinel, neutral = dst.n_nodes, dst.n_hub
    off, hoff = lane * n_pad, lane * nh_pad
    rows = slice(off, off + n_pad)
    tails = slice(lane * t_pad, (lane + 1) * t_pad)
    ell, deg = dst.ell_idx[rows], dst.degrees[rows]
    prio, hub_slot = dst.priority[rows], dst.hub_slot[rows]
    tail_src, tail_dst = dst.tail_src[tails], dst.tail_dst[tails]
    tail_valid, tail_slot = dst.tail_valid[tails], dst.tail_slot[tails]
    ell.fill_(sentinel)
    deg.zero_()
    prio.fill_(-1)
    hub_slot.fill_(neutral)
    tail_src.fill_(off)                  # clipped rows, never valid
    tail_dst.fill_(sentinel)
    tail_valid.zero_()
    tail_slot.fill_(neutral)
    dst.hub_ids[hoff:hoff + nh_pad].fill_(off)
    if ig is None:
        return
    n, k, nh = ig.n_nodes, ig.ell_width, ig.n_hub
    t = ig.tail_src.shape[0]
    assert ig.layout_kind != "csr-segment", \
        "csr-segment graphs have no batch padding (edge arrays)"
    assert n_pad >= n and dst.ell_width >= k and t_pad >= t \
        and nh_pad >= nh
    ell[:n, :k] = ig.ell_idx
    _offset_(ell[:n, :k], n, sentinel, off)
    deg[:n] = ig.degrees
    prio[:n] = ig.priority[:n]
    tail_src[:t] = ig.tail_src
    tail_src[:t] += off
    tail_dst[:t] = ig.tail_dst
    _offset_(tail_dst[:t], n, sentinel, off)
    tail_valid[:t] = ig.tail_valid
    tail_slot[:t] = ig.tail_slot
    _offset_(tail_slot[:t], nh, neutral, hoff)
    hub_slot[:n] = ig.hub_slot
    _offset_(hub_slot[:n], nh, neutral, hoff)
    if nh_pad:
        dst.hub_ids[hoff:hoff + nh] = ig.hub_ids[:nh] + off


def pad_prepared(ig: IPGCGraph, n_pad: int, k_pad: int, t_pad: int,
                 nh_pad: int) -> IPGCGraph:
    """Embed a prepared graph into a larger static shape class — the
    batch-execution contract (DESIGN.md §9): ``pad_into`` one block. The
    padding is inert (see ``pad_into``), so coloring the padded graph
    (pad rows ``PAD_COLOR`` and outside the worklist) equals coloring the
    original, row for row."""
    dst = padded_graph(n_pad, k_pad, t_pad, nh_pad,
                       layout_kind=ig.layout_kind, device=ig.device)
    pad_into(ig, dst, 0, 1)
    return dst


def init_colors(n_nodes: int, device) -> torch.Tensor:
    """int32[N+1]; slot N is the gather sentinel (PAD_COLOR)."""
    c = torch.full((n_nodes + 1,), NO_COLOR, dtype=torch.int32,
                   device=device)
    c[n_nodes:].fill_(PAD_COLOR)
    return c


def state_from_numpy(colors, base, mask, items, count, device
                     ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    """``(colors, base, Worklist)`` from host arrays — the hand-off of a
    mid-run engine state, e.g. one taken from ``repro`` through
    ``np.asarray``."""
    device = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return (put(colors, np.int32), put(base, np.int32),
            Worklist(mask=put(mask, np.bool_), items=put(items, np.int32),
                     count=put(count, np.int32)))


# --- hub side-channel forcing ------------------------------------------------

_force_hub = False


def force_hub_enabled() -> bool:
    return _force_hub


@contextlib.contextmanager
def forced_hub(value: bool):
    """Run the hub side-channel unconditionally inside the block (A/B of
    the hub path on graphs without hubs); restores the previous setting."""
    global _force_hub
    prev = _force_hub
    _force_hub = bool(value)
    try:
        yield
    finally:
        _force_hub = prev


def _has_hubs(ig: IPGCGraph, force_hub: "bool | None") -> bool:
    if force_hub is None:
        force_hub = force_hub_enabled()
    return ig.n_hub > 0 or force_hub


# --- accounting ----------------------------------------------------------------
# Counted when a step runs. GATHER_COUNTS: ELL- or edge-shaped gathers of
# the mutable colors array (the fused steps make one per iteration, the
# two-phase steps two; the row kernels make theirs inside the kernel,
# counted at the call). LAUNCH_COUNTS: logical device passes per step —
# mex/conflict/compact for the three passes of a two-phase step, fused for
# a one-pass fused step (DESIGN.md §10). The CUDA launches behind them are
# counted per kernel in ``kernels.ops.KERNEL_LAUNCHES``.
GATHER_COUNTS = default_registry().group("ipgc.gathers",
                                         ("neighbor_colors",))
LAUNCH_COUNTS = default_registry().group(
    "ipgc.launches", ("mex", "conflict", "compact", "fused"))


def _gather_neighbor_colors(colors: torch.Tensor,
                            rows: torch.Tensor) -> torch.Tensor:
    GATHER_COUNTS["neighbor_colors"] += 1
    return colors[rows]


def _count_kernel_gather() -> None:
    """Count the neighbour-color gather that ``mex_window``, ``conflict``,
    ``fused_compact`` and ``jpl_extrema`` make inside the kernel: still
    the algorithm's gather, at the reference's call sites."""
    GATHER_COUNTS["neighbor_colors"] += 1


def _set_rows(x: torch.Tensor, rows: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with ``x[rows] = values`` (rows in range)."""
    out = x.clone()
    out.index_put_((rows,), values)
    return out


def _set_rows_drop(x: torch.Tensor, rows: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with ``x[rows] = values`` where row ``len(x)`` is
    dropped (JAX's ``.at[rows].set(values, mode="drop")`` for the one
    out-of-range row the steps use)."""
    ext = torch.cat([x, x.new_zeros(1)])
    ext.index_put_((rows,), values)
    return ext[:-1]


# ---------------------------------------------------------------------------
# hub side-channel
# ---------------------------------------------------------------------------

def _hub_forbidden(ig: IPGCGraph, colors: torch.Tensor, base: torch.Tensor,
                   window: int) -> torch.Tensor:
    """(n_hub+1, W) forbidden bitmap from COO-tail edges; row n_hub is a
    guaranteed-False row that non-hub nodes gather."""
    nh = ig.n_hub
    tc = colors[ig.tail_dst]               # PAD_COLOR for padded entries
    rel = tc - base[ig.tail_src]
    ok = ig.tail_valid & (tc >= 0) & (rel >= 0) & (rel < window)
    flat = torch.where(ok, ig.tail_slot.to(torch.int64) * window + rel,
                       (nh + 1) * window)
    return flags_at((nh + 1) * window + 1, flat)[:-1].view(nh + 1, window)


def _hub_lose(ig: IPGCGraph, colors: torch.Tensor,
              newly_full: torch.Tensor) -> torch.Tensor:
    """(n_hub+1,) conflict flags for hub rows from COO-tail edges."""
    nh = ig.n_hub
    cu = colors[ig.tail_src]
    cv = colors[ig.tail_dst]
    pu = ig.priority[ig.tail_src]
    pv = ig.priority[ig.tail_dst]
    lose = (ig.tail_valid & (cu >= 0) & (cu == cv) & newly_full[ig.tail_src]
            & ((pv > pu) | ((pv == pu) & (ig.tail_dst > ig.tail_src))))
    return flags_at(nh + 2, torch.where(lose, ig.tail_slot, nh + 1))[:nh + 1]


# ---------------------------------------------------------------------------
# row helpers
# ---------------------------------------------------------------------------

def _mex_from_forbidden(forb: torch.Tensor, active: torch.Tensor,
                        base_rows: torch.Tensor, colors_rows: torch.Tensor,
                        window: int):
    """Pick the first free color in the window; advance the base when it
    is exhausted (the csr-segment assign, whose bitmap is a scatter)."""
    free = (~forb) & active[:, None]
    has = free.any(dim=1)
    first = free.to(torch.uint8).argmax(dim=1).to(torch.int32)
    new_colors = torch.where(active & has, base_rows + first, colors_rows)
    new_base = torch.where(active & ~has, base_rows + window, base_rows)
    return new_colors, new_base, active & has


def _mex_rows(ig: IPGCGraph, colors: torch.Tensor,
              rows: "torch.Tensor | None", base_rows: torch.Tensor,
              active: torch.Tensor, colors_rows: torch.Tensor,
              hub_forb: "torch.Tensor | None", window: int,
              tile_rows: "int | None" = None):
    """Row-wise windowed mex: the ``mex_window`` kernel, which gathers the
    neighbours of ``ig.ell_idx[rows]`` itself (``rows`` None is every ELL
    row, a row >= the ELL's row count is empty) and reads ``hub_forb`` (the
    ``_hub_forbidden`` table, or None) at each row's hub slot; then the
    new-color/base selection of the active rows."""
    LAUNCH_COUNTS["mex"] += 1
    hub_slot = None if hub_forb is None else ig.hub_slot
    first = ops.mex_window(colors, ig.ell_idx, rows, base_rows, active,
                           hub_forb, hub_slot, window, tile_rows=tile_rows)
    has = first >= 0                      # only active rows have a first
    new_colors = torch.where(has, base_rows + first, colors_rows)
    new_base = torch.where(active & ~has, base_rows + window, base_rows)
    return new_colors, new_base, has


def _lose_rows(ig: IPGCGraph, rows: "torch.Tensor | None",
               row_ids: torch.Tensor, colors: torch.Tensor,
               newly: torch.Tensor, tile_rows: "int | None" = None
               ) -> torch.Tensor:
    """Row u loses iff it conflicts (the ``conflict`` kernel, which
    gathers the neighbours of ``ig.ell_idx[rows]`` itself; ``rows`` None is
    every ELL row, a row >= the ELL's row count is empty). Only
    newly-colored rows can conflict (mex excluded all surviving older
    colors), and the kernel checks no other."""
    LAUNCH_COUNTS["conflict"] += 1
    _count_kernel_gather()
    cu = colors[row_ids]
    pu = ig.priority[row_ids]
    return ops.conflict(colors, ig.priority, ig.ell_idx, rows, cu, pu,
                        row_ids, newly, tile_rows=tile_rows)


def _fused_compact_rows(ig: IPGCGraph, colors, rows, base_rows, cu, pu,
                        ids, active, pending, hub_tables, window: int,
                        capacity: int, tile_rows: "int | None" = None):
    """One pass (DESIGN.md §10): resolve + windowed mex + new-color/base
    selection + compacted worklist emission, the neighbours of
    ``ig.ell_idx[rows]`` gathered inside the ``fused_compact`` kernel
    (``rows`` None is every ELL row, a row >= the ELL's row count is
    empty). ``ids`` is the emitted value, so the dense caller passes row
    iota (emission == ``compact_mask``) and the sparse caller its items
    block (emission == ``compact_items``). ``hub_tables`` is None or the
    ``(_hub_forbidden, _hub_lose)`` tables, which the kernel reads at each
    row's hub slot. Returns ``(new_colors, new_base, still, items,
    count)``."""
    LAUNCH_COUNTS["fused"] += 1
    _count_kernel_gather()
    hub_forb, hub_lose = hub_tables or (None, None)
    hub_slot = None if hub_tables is None else ig.hub_slot
    return ops.fused_compact(colors, ig.priority, ig.ell_idx, rows,
                             base_rows, cu, pu, ids, active, pending,
                             hub_forb, hub_lose, hub_slot, window,
                             capacity=capacity, n_sentinel=ig.n_nodes,
                             tile_rows=tile_rows)


def _fused_rows(ig: IPGCGraph, colors, rows, base_rows, cu, pu, ids,
                pending, hub_tables, window: int,
                tile_rows: "int | None" = None):
    """Resolve + windowed mex without emission: ``(lose, first, has)``,
    the neighbours of ``ig.ell_idx[rows]`` gathered inside the
    ``fused_step`` kernel (``rows`` None is every ELL row, a row >= the
    ELL's row count is empty). ``hub_tables`` is None or the
    ``(_hub_forbidden, _hub_lose)`` tables, which the kernel reads at each
    row's hub slot; the hub lose flag of the pending rows is ORed into
    ``lose``. The distributed fused steps use it: their emission follows
    the cross-shard exchange, so it cannot fold into the row pass.
    ``first`` is -1 where ``has`` is False; callers read it only where
    ``has`` is True."""
    LAUNCH_COUNTS["fused"] += 1
    hub_forb, hub_lose = hub_tables or (None, None)
    hub_slot = None if hub_tables is None else ig.hub_slot
    lose, first = ops.fused_step(colors, ig.priority, ig.ell_idx, rows,
                                 base_rows, cu, pu, ids, pending, hub_forb,
                                 hub_lose, hub_slot, window,
                                 tile_rows=tile_rows)
    return lose, first, first >= 0


# ---------------------------------------------------------------------------
# csr-segment step variants — edge-wise scatters over the full edge set
# ---------------------------------------------------------------------------
# The forbidden bitmap and conflict flags cover all N rows, so the dense
# and sparse forms share the core and differ only in how the worklist is
# re-emitted: the dense form compacts the mask, the data-driven form
# filters its items block in O(C).

def _csr_two_phase_core(ig: IPGCGraph, colors, base, active, *,
                        window: int):
    n = ig.n_nodes
    es, ed = ig.edge_src, ig.edge_dst
    ec = _gather_neighbor_colors(colors, ed)             # gather 1
    forb = kcsr.edge_forbidden(es, ec, base[es], n, window)
    new_c, new_base, newly = _mex_from_forbidden(
        forb, active, base, colors[:n], window)
    colors2 = torch.cat([new_c, colors[n:]])
    cv = _gather_neighbor_colors(colors2, ed)            # gather 2
    lose = kcsr.edge_conflict(es, ed, colors2[es], cv, ig.priority[es],
                              ig.priority[ed], n) & newly
    colors3 = torch.cat([torch.where(lose, NO_COLOR, new_c), colors[n:]])
    return colors3, new_base, lose | (active & ~newly)


def _csr_fused_core(ig: IPGCGraph, colors, base, active, *, window: int):
    n = ig.n_nodes
    es, ed = ig.edge_src, ig.edge_dst
    cu = colors[:n]
    pending = active & (cu >= 0)
    ec = _gather_neighbor_colors(colors, ed)             # the one gather
    lose, forb = kcsr.edge_fused(es, ed, cu[es], ec, ig.priority[es],
                                 ig.priority[ed], base[es], n, window)
    lose = lose & pending
    free = ~forb
    has = free.any(dim=1)
    first = free.to(torch.uint8).argmax(dim=1).to(torch.int32)
    need = lose | (active & (cu < 0))
    new_c = torch.where(need & has, base + first,
                        torch.where(lose, NO_COLOR, cu))
    new_base = torch.where(need & ~has, base + window, base)
    return torch.cat([new_c, colors[n:]]), new_base, need


def _csr_step(ig: IPGCGraph, colors, base, wl: Worklist, *, window: int,
              fused: bool, sparse: bool):
    if fused:
        LAUNCH_COUNTS["fused"] += 1
        core = _csr_fused_core
    else:
        LAUNCH_COUNTS["mex"] += 1
        LAUNCH_COUNTS["conflict"] += 1
        LAUNCH_COUNTS["compact"] += 1
        core = _csr_two_phase_core
    n = ig.n_nodes
    colors2, base2, still = core(ig, colors, base, wl.mask, window=window)
    if sparse:
        # O(C) maintenance: filter the items block against the
        # row-complete ``still`` flags (mask and items describe one set)
        items = wl.items
        keep = (items < n) & still[items.clamp(max=n - 1)]
        new_items, count = compact_items(items, keep, n)
    else:
        new_items, count = compact_mask(still, wl.capacity, n)
    return colors2, base2, Worklist(mask=still, items=new_items, count=count)


# ---------------------------------------------------------------------------
# dense (topology-driven) step — sweeps all N rows, maintains the worklist
# ---------------------------------------------------------------------------

def dense_step(ig: IPGCGraph, colors: torch.Tensor, base: torch.Tensor,
               wl: Worklist, *, window: int = 128,
               force_hub: "bool | None" = None,
               tile_rows: "int | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    if ig.layout_kind == "csr-segment":
        return _csr_step(ig, colors, base, wl, window=window, fused=False,
                         sparse=False)
    n = ig.n_nodes
    active = wl.mask
    row_ids = torch.arange(n, dtype=torch.int32, device=colors.device)
    has_hubs = _has_hubs(ig, force_hub)

    # --- assign (speculative windowed mex, gathering in the kernel) ---
    _count_kernel_gather()
    hub_forb = _hub_forbidden(ig, colors, base, window) if has_hubs else None
    new_c, new_base, newly = _mex_rows(ig, colors, None, base, active,
                                       colors[:n], hub_forb, window,
                                       tile_rows)
    colors2 = torch.cat([new_c, colors[n:]])

    # --- resolve (uncolor exactly one endpoint per conflict edge) ---
    lose = _lose_rows(ig, None, row_ids, colors2, newly, tile_rows)
    if has_hubs:
        newly_full = torch.cat([newly, newly.new_zeros(1)])
        lose = lose | _hub_lose(ig, colors2, newly_full)[ig.hub_slot]
    colors3 = torch.cat([torch.where(lose, NO_COLOR, new_c), colors[n:]])

    # --- maintain the worklist (also in dense mode: the paper's point) ---
    still = lose | (active & ~newly)
    LAUNCH_COUNTS["compact"] += 1
    items, count = compact_mask(still, wl.capacity, n)
    return colors3, new_base, Worklist(mask=still, items=items, count=count)


# ---------------------------------------------------------------------------
# sparse (data-driven) step — the C worklist rows, O(C*K + T + n_hub*W)
# ---------------------------------------------------------------------------

def sparse_step(ig: IPGCGraph, colors: torch.Tensor, base: torch.Tensor,
                wl: Worklist, *, window: int = 128,
                force_hub: "bool | None" = None,
                tile_rows: "int | None" = None
                ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    if ig.layout_kind == "csr-segment":
        return _csr_step(ig, colors, base, wl, window=window, fused=False,
                         sparse=True)
    n = ig.n_nodes
    items = wl.items
    valid = items < n
    safe = torch.where(valid, items, 0)
    target = torch.where(valid, items, n)        # invalid lanes -> slot n

    # --- assign ---
    has_hubs = _has_hubs(ig, force_hub)
    _count_kernel_gather()        # the items' neighbours, in the kernel
    base_rows = base[safe]
    hub_forb = _hub_forbidden(ig, colors, base, window) if has_hubs else None
    new_c, new_base_rows, newly = _mex_rows(ig, colors, items, base_rows,
                                            valid, colors[safe], hub_forb,
                                            window, tile_rows)
    colors2 = _set_rows(colors, target, torch.where(valid, new_c, PAD_COLOR))
    colors2[n:].fill_(PAD_COLOR)
    base2 = _set_rows_drop(base, target, new_base_rows)

    # --- resolve ---
    lose = _lose_rows(ig, items, target, colors2, newly, tile_rows)
    if has_hubs:
        newly_full = _set_rows(torch.zeros(n + 1, dtype=torch.bool,
                                           device=colors.device),
                               torch.where(newly, items, n), newly)
        hub_l = _hub_lose(ig, colors2, newly_full)
        lose = lose | (hub_l[ig.hub_slot[safe]] & valid)
    colors3 = _set_rows(colors2, torch.where(lose, items, n),
                        torch.full_like(items, NO_COLOR))
    colors3[n:].fill_(PAD_COLOR)

    # --- maintain the worklist in O(C) ---
    still = lose | (valid & ~newly)
    LAUNCH_COUNTS["compact"] += 1
    new_items, count = compact_items(items, still, n)
    mask = _set_rows_drop(wl.mask, target, still)
    return colors3, base2, Worklist(mask=mask, items=new_items, count=count)


# ---------------------------------------------------------------------------
# fused assign+resolve steps — ONE neighbour-color gather per iteration
# ---------------------------------------------------------------------------
# Per active row u (active = in the worklist = not yet *confirmed*):
#   pending(u) := active(u) and colors[u] >= 0   (speculated last step)
#   1. resolve: u loses iff pending and some neighbour holds the same color
#      with a higher (priority, id).
#   2. assign: rows that lost or were still uncolored re-run the windowed
#      mex over the SAME gathered tile (a neighbour that lost this step
#      keeps its doomed color forbidden: a safe over-approximation).
#   3. worklist: confirmed rows (pending and did not lose) leave.

def fused_dense_step(ig: IPGCGraph, colors: torch.Tensor, base: torch.Tensor,
                     wl: Worklist, *, window: int = 128,
                     force_hub: "bool | None" = None,
                     tile_rows: "int | None" = None
                     ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    if ig.layout_kind == "csr-segment":
        return _csr_step(ig, colors, base, wl, window=window, fused=True,
                         sparse=False)
    n = ig.n_nodes
    active = wl.mask
    row_ids = torch.arange(n, dtype=torch.int32, device=colors.device)
    cu = colors[:n]
    pu = ig.priority[:n]
    pending = active & (cu >= 0)
    hub_tables = None
    if _has_hubs(ig, force_hub):
        pending_full = torch.cat([pending, pending.new_zeros(1)])
        hub_tables = (_hub_forbidden(ig, colors, base, window),
                      _hub_lose(ig, colors, pending_full))
    # the one gather, inside the kernel
    new_c, new_base, still, items, count = _fused_compact_rows(
        ig, colors, None, base, cu, pu, row_ids, active, pending,
        hub_tables, window, wl.capacity, tile_rows)
    colors2 = torch.cat([new_c, colors[n:]])
    return colors2, new_base, Worklist(mask=still, items=items, count=count)


def fused_sparse_step(ig: IPGCGraph, colors: torch.Tensor, base: torch.Tensor,
                      wl: Worklist, *, window: int = 128,
                      force_hub: "bool | None" = None,
                      tile_rows: "int | None" = None
                      ) -> tuple[torch.Tensor, torch.Tensor, Worklist]:
    if ig.layout_kind == "csr-segment":
        return _csr_step(ig, colors, base, wl, window=window, fused=True,
                         sparse=True)
    n = ig.n_nodes
    items = wl.items
    valid = items < n
    safe = torch.where(valid, items, 0)
    ids = torch.where(valid, items, n)

    cu = torch.where(valid, colors[safe], PAD_COLOR)
    pu = ig.priority[ids]
    base_rows = base[safe]
    pending = valid & (cu >= 0)
    hub_tables = None
    if _has_hubs(ig, force_hub):
        pending_full = _set_rows(torch.zeros(n + 1, dtype=torch.bool,
                                             device=colors.device),
                                 torch.where(pending, items, n), pending)
        hub_tables = (_hub_forbidden(ig, colors, base, window),
                      _hub_lose(ig, colors, pending_full))

    # the one gather, inside the kernel
    new_c, new_base_rows, still, new_items, count = _fused_compact_rows(
        ig, colors, items, base_rows, cu, pu, ids, valid, pending,
        hub_tables, window, items.shape[0], tile_rows)

    colors2 = _set_rows(colors, ids, torch.where(valid, new_c, PAD_COLOR))
    colors2[n:].fill_(PAD_COLOR)
    base2 = _set_rows_drop(base, ids, new_base_rows)
    mask = _set_rows_drop(wl.mask, ids, still)
    return colors2, base2, Worklist(mask=mask, items=new_items, count=count)


def step_fns(fused: bool):
    """(dense, sparse) step pair for the requested family."""
    return ((fused_dense_step, fused_sparse_step) if fused
            else (dense_step, sparse_step))
