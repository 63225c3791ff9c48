"""Distributed hybrid coloring engine (the port of
``repro/core/distributed.py``).

Owner-computes partitioning of the paper's Pipe, both phases, so the
persistent-worklist invariant (DESIGN.md §1) holds across shard
boundaries:

  * each shard owns a contiguous node block (``graphs.partition.
    prepare_partition`` pads to equal, 8-aligned blocks and balances total
    degree across them, so no shard owns all hubs);
  * the ONLY cross-shard value is the color vector, published by the
    additive all-gather: each shard sums in its disjoint owner-block delta
    (int32[N+1]), and the sum lands on every shard's replica. The fused
    steps (the default) make exactly ONE such exchange per
    iteration — 4(N+1) bytes per shard, independent of the edge count —
    and the two-phase steps exactly TWO (speculate, then undo), counted
    in ``EXCHANGE_COUNTS`` when they run;
  * worklist state stays shard-local in both phases: the dense sweep reads
    its block of ``mask`` and re-emits its block of ``items``; the sparse
    step gathers and O(C)-filters only its own items block, sliced down a
    per-shard capacity ladder at bucket boundaries. The hybrid switch
    needs one global count, the sum of the shards' counts, read once per
    iteration by the host loop (``exec/session.py::_run_dist``).

The port keeps the reference's single-controller shape: one host loop
drives every shard. The mesh is a tuple of devices, one per shard, and a
device may carry several shards (four shards on one card are the
counterpart of a four-device mesh). Each step runs its local stage on
every shard, then the collective as explicit tensor ops across the shards'
tensors, then the next stage: the fused step splits once (stage, exchange,
emission), the two-phase step twice. Shards on one device share one color
replica, so no stage writes colors in place: every update goes through the
exchange, which returns new tensors. The additive sum of int32 deltas is
exact in any order.

The fused steps equal ``ipgc.fused_*_step`` on the partitioned graph, so
``color_distributed`` reproduces ``engine.color(g2, fused=True)``'s
colors, iterations and mode trace for fixed-H policies on any shard
count (DESIGN.md §6).

``exchange="boundary"|"auto"`` (DESIGN.md §13) replaces the additive
exchange with a packed publish of only the *changed boundary* vertices
(``_publish_packed``). The color state becomes one view per shard
(``shard_views``: correct at owned and ghost ids, possibly stale
elsewhere, never shared between shards), and each publish picks on the
device between the packed buffers and a dense swap of the owner blocks,
so correctness never depends on the buffer capacity and the host reads
nothing to decide. Every combination equals the dense exchange.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ipgc
from repro_torch.core.worklist import Worklist, compact_items, resize_block
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.metrics import default_registry

NO_COLOR = ipgc.NO_COLOR

#: color-vector exchanges, counted when one runs (one per collective,
#: whatever the shard count): ``color_psum`` is the additive all-gather of
#: the dense exchange; a packed publish of the boundary exchange counts
#: ``boundary_pack`` AND ``dense_swap``, since it computes both and selects
#: one on the device (the reference's trace-time count of both branches)
EXCHANGE_COUNTS = default_registry().group(
    "dist.exchanges", ("color_psum", "boundary_pack", "dense_swap"))

EXCHANGES = ("dense", "boundary", "auto")


def check_exchange(exchange: str) -> None:
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}; valid: "
                         f"{EXCHANGES}")


# ---------------------------------------------------------------------------
# the mesh and the sharded state
# ---------------------------------------------------------------------------

def resolve_mesh(n_shards: "int | None" = None, devices=None,
                 default=None) -> tuple[torch.device, ...]:
    """The shard mesh: a tuple with one device per shard.

    ``devices`` gives it explicitly (a device may repeat: several shards on
    one card). Otherwise the shards go to the ``default`` device's kind: on
    CUDA, ``n_shards=None`` is one shard per visible CUDA device (the
    counterpart of ``jax.device_count()``) and a given count is dealt
    round-robin over the visible devices; on the CPU every shard runs on
    the CPU, one shard when ``n_shards`` is None.
    """
    if devices is not None:
        mesh = tuple(resolve_device(d) for d in devices)
        if not mesh:
            raise ValueError("devices: the mesh needs at least one device")
        if n_shards is not None and n_shards != len(mesh):
            raise ValueError(f"n_shards={n_shards} disagrees with the "
                             f"{len(mesh)} devices given")
        return mesh
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    default = resolve_device(default)
    if default.type == "cuda":
        visible = torch.cuda.device_count()
        s = visible if n_shards is None else n_shards
        return tuple(torch.device("cuda", i % visible) for i in range(s))
    return (default,) * (1 if n_shards is None else n_shards)


@dataclasses.dataclass(frozen=True)
class ShardedWorklist:
    """The persistent worklist over the shards: each block holds its
    shard's ``mask`` block, ``items`` block (global ids, padded with N)
    and local count; ``count`` is the global count (their sum, a 0-d int32
    on the mesh's first device) that the host loop reads."""

    blocks: tuple
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        """The per-shard items capacity."""
        return self.blocks[0].capacity


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard's view of the partitioned graph: ``ig`` holds the block's
    ELL rows, degrees and hub slots, and replicas of the priority and tail
    arrays, on the shard's device; ``lo``/``hi`` bound the owned ids."""

    ig: ipgc.IPGCGraph
    lo: int
    hi: int
    row_ids: torch.Tensor        # int32[hi - lo], the owned global ids

    @property
    def device(self) -> torch.device:
        return self.row_ids.device


_REPLICATED = ("priority", "tail_src", "tail_dst", "tail_valid", "tail_slot",
               "hub_ids")


def _per_device(mesh, make):
    """``make(device)`` once per distinct device of the mesh, by shard."""
    made = {}
    for d in mesh:
        if d not in made:
            made[d] = make(d)
    return tuple(made[d] for d in mesh)


def shard_graph(ig: ipgc.IPGCGraph, mesh) -> tuple[Shard, ...]:
    """Cut a prepared, partitioned graph (``n_nodes % len(mesh) == 0``)
    into per-shard views. On the graph's own device the block arrays are
    views, not copies."""
    n, s_count = ig.n_nodes, len(mesh)
    if n % s_count:
        raise ValueError(f"the graph's {n} nodes do not split into "
                         f"{s_count} equal blocks; run prepare_partition")
    blk = n // s_count
    reps = _per_device(mesh, lambda d: {f: getattr(ig, f).to(d)
                                        for f in _REPLICATED})
    shards = []
    for s, (d, rep) in enumerate(zip(mesh, reps)):
        lo, hi = s * blk, (s + 1) * blk
        local = dataclasses.replace(
            ig, ell_idx=ig.ell_idx[lo:hi].to(d),
            degrees=ig.degrees[lo:hi].to(d),
            hub_slot=ig.hub_slot[lo:hi].to(d), **rep)
        shards.append(Shard(ig=local, lo=lo, hi=hi, row_ids=torch.arange(
            lo, hi, dtype=torch.int32, device=d)))
    return tuple(shards)


def shard_state(mesh, colors: torch.Tensor, aux: torch.Tensor,
                wl: Worklist):
    """Split a whole-graph engine state ``(colors, aux, wl)`` over the
    mesh: colors are replicated (one replica per device), a per-node
    ``aux`` (IPGC's window bases, int32[N]) and the worklist are cut into
    owner blocks, a scalar ``aux`` (JPL's round counter) is replicated.
    The items are cut into equal blocks, which for a full worklist are the
    shards' own ids."""
    n, s_count = wl.mask.shape[0], len(mesh)
    blk, cap = n // s_count, wl.capacity // s_count
    colors_r = _per_device(mesh, colors.to)
    if aux.dim() == 1:
        aux_r = tuple(aux[s * blk:(s + 1) * blk].to(d)
                      for s, d in enumerate(mesh))
    else:
        aux_r = _per_device(mesh, aux.to)
    blocks = []
    for s, d in enumerate(mesh):
        items = wl.items[s * cap:(s + 1) * cap].to(d)
        blocks.append(Worklist(mask=wl.mask[s * blk:(s + 1) * blk].to(d),
                               items=items,
                               count=(items < n).sum(dtype=torch.int32)))
    return colors_r, aux_r, _worklist(mesh, blocks)


def shard_views(colors) -> tuple:
    """The per-shard color views of the boundary exchange: one
    ``int32[N+1]`` tensor per shard, also where shards share a device
    (``shard_state`` hands them one replica)."""
    return tuple(c.clone() for c in colors)


def views_to_colors(views, n_shards: int, n: int) -> np.ndarray:
    """The true int32[n] color vector of per-shard views (a sequence of S
    ``int32[n+1]`` tensors or arrays): the views agree only at owned and
    ghost ids, so it is each shard's OWN block of its OWN view."""
    block = n // n_shards
    out = []
    for s in range(n_shards):
        v = views[s][s * block:(s + 1) * block]
        out.append(v.cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v))
    return np.concatenate(out)


def resize_worklist(wl: ShardedWorklist, capacity: int,
                    n_nodes: int) -> ShardedWorklist:
    """Shard-local bucket change: every shard slices (or pads) its own
    already-compacted items block. Valid whenever ``capacity`` bounds
    every shard's live count; the host loop picks
    ``pick_bucket(caps, min(global count, block))``."""
    return ShardedWorklist(
        blocks=tuple(dataclasses.replace(
            b, items=resize_block(b.items, capacity, n_nodes))
            for b in wl.blocks),
        count=wl.count)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _psum(mesh, parts) -> tuple:
    """The all-reduce: the sum of the shards' tensors on every shard's
    device (computed once per distinct device)."""
    def total(d):
        acc = None
        for p in parts:
            q = p.to(d)
            acc = q if acc is None else acc + q
        return acc
    return _per_device(mesh, total)


def _exchange_colors(mesh, colors, deltas) -> tuple:
    """Additive all-gather: the shards hold disjoint owner-block updates as
    dense int32[N+1] deltas against the replicated vector, so their sum IS
    the gather. Shards that share a replica get one result."""
    EXCHANGE_COUNTS["color_psum"] += 1
    out, done = [], {}
    for c, t in zip(colors, _psum(mesh, deltas)):
        key = (id(c), id(t))
        if key not in done:
            done[key] = c + t
        out.append(done[key])
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class _Writes:
    """One shard's color writes of a publish: ``vals`` replace ``old`` at
    the global ``ids`` (None: the shard's owned rows, in order; a pad lane
    carries id N and ``vals == old``)."""

    ids: "torch.Tensor | None"
    old: torch.Tensor
    vals: torch.Tensor


def _delta(sh: "Shard", w: _Writes, n: int) -> torch.Tensor:
    """The additive exchange's int32[N+1] delta of one shard's writes."""
    d = w.vals - w.old
    if w.ids is None:
        return _padded(sh, d, n + 1)
    return ipgc._set_rows(
        torch.zeros(n + 1, dtype=torch.int32, device=sh.device), w.ids, d)


def _all_gather(mesh, parts) -> tuple:
    """The concatenation of the shards' tensors on every shard's device
    (computed once per distinct device)."""
    return _per_device(mesh, lambda d: torch.cat([p.to(d) for p in parts]))


def _publish_packed(mesh, shards, views, writes, isb, *, n: int, bcap: int,
                    thresh: int):
    """Publish the shards' owned color writes into their color views
    (``repro/core/distributed.py::_publish_packed``).

    Own writes always land locally (pad ids are dropped, so slot ``n``,
    the ``PAD_COLOR`` sentinel, is never written). Cross-shard publication
    then picks ON THE DEVICE between:
      * packed: every shard's *changed boundary* ``(id, color)`` pairs,
        ordered-compacted (the ``compact`` kernel) into ``int32[bcap]``
        buffers padded with id ``n+1``, concatenated over the shards and
        scattered into every view (pad ids dropped);
      * dense swap: every view takes the concatenation of each shard's
        owned block of its own view — the fallback when some shard's
        changed-boundary count overflows ``bcap`` or the total exceeds
        ``thresh``.
    The predicate is computed from all the shards' counts on every
    device, so every shard takes the same path. Both are computed and one
    is selected by ``torch.where``: no host read decides anything.

    ``isb`` holds per shard its ``is_boundary`` block and the whole
    ``bool[n+1]`` vector (slot ``n`` False) on its device. Returns
    ``(views', packed, biggest)``: ``packed`` a 0-d bool, ``biggest`` the
    largest per-shard changed-boundary count (0-d int32), both on the
    mesh's first device.
    """
    EXCHANGE_COUNTS["boundary_pack"] += 1
    EXCHANGE_COUNTS["dense_swap"] += 1
    own_views, owned, cbs, pids, pvals = [], [], [], [], []
    for sh, v, w, (isb_blk, isb_full) in zip(shards, views, writes, isb):
        if w.ids is None:
            ids, flags = sh.row_ids, isb_blk
            v = torch.cat([v[:sh.lo], w.vals, v[sh.hi:]])
        else:
            ids, flags = w.ids, isb_full[w.ids]       # pad id n: False
            v = ipgc._set_rows_drop(v, torch.where(ids < n, ids, n + 1),
                                    w.vals)
        changed = flags & (w.vals != w.old)
        m = ids.shape[0]
        pos, _ = ops.compact(changed, bcap, m)
        pids.append(torch.cat([ids, ids.new_full((1,), n + 1)])[pos])
        pvals.append(torch.cat([w.vals, w.vals.new_zeros(1)])[pos])
        cbs.append(changed.sum(dtype=torch.int32).view(1))
        own_views.append(v)
        owned.append(v[sh.lo:sh.hi])

    def gate(d):
        c = torch.cat([x.to(d) for x in cbs])
        return (c.max() <= bcap) & (c.sum() <= thresh), c.max()

    use, biggest = zip(*_per_device(mesh, gate))
    all_ids, all_vals = _all_gather(mesh, pids), _all_gather(mesh, pvals)
    swap = _all_gather(mesh, owned)
    out = []
    for v, u, ai, av, sw in zip(own_views, use, all_ids, all_vals, swap):
        packed = ipgc._set_rows_drop(v, torch.where(u, ai, n + 1), av)
        out.append(torch.cat([torch.where(u, packed[:n], sw), v[n:]]))
    return tuple(out), use[0], biggest[0]


class _Publisher:
    """The cross-shard publish of a step's color writes: the additive
    exchange (``exchange="dense"``), or the packed publish into per-shard
    views. ``bind`` makes the step of a local program ``run(colors, aux,
    wl, pub)``, which calls ``pub(colors, writes)`` once per exchange: the
    dense step is ``step(colors, aux, wl) -> (colors, aux, wl)``, the
    boundary step ``step(views, aux, wl, *, bcap) -> (views, aux, wl,
    xstats)`` with ``xstats`` the int32[2] ``[publishes that went packed,
    largest changed-boundary count]`` on the mesh's first device."""

    def __init__(self, mesh, shards, n: int, exchange: str, boundary,
                 thresh: "int | None"):
        check_exchange(exchange)
        self.mesh, self.shards, self.n = mesh, shards, n
        self.boundary = exchange != "dense"
        if self.boundary:
            if boundary is None or thresh is None:
                raise ValueError(f"exchange={exchange!r} needs the "
                                 "partition's BoundaryInfo and a threshold")
            flags = torch.from_numpy(np.append(
                np.asarray(boundary.is_boundary, dtype=bool), False))
            full = _per_device(mesh, flags.to)
            self.isb = tuple((f[sh.lo:sh.hi], f)
                             for f, sh in zip(full, shards))
            self.thresh = int(thresh)

    def dense(self, colors, writes) -> tuple:
        return _exchange_colors(self.mesh, colors, [
            _delta(sh, w, self.n) for sh, w in zip(self.shards, writes)])

    def bind(self, run, per_iter: int):
        if not self.boundary:
            def step(colors, aux, wl):
                return run(colors, aux, wl, self.dense)
        else:
            def step(views, aux, wl, *, bcap: int):
                stats = []

                def pub(v, writes):
                    v, packed, biggest = _publish_packed(
                        self.mesh, self.shards, v, writes, self.isb,
                        n=self.n, bcap=bcap, thresh=self.thresh)
                    stats.append((packed, biggest))
                    return v

                out = run(views, aux, wl, pub)
                npk = torch.stack([p for p, _ in stats]).sum(
                    dtype=torch.int32)
                mx = torch.stack([b for _, b in stats]).max()
                return (*out, torch.stack([npk, mx]).to(torch.int32))
        step.exchanges_per_iter = per_iter
        return step


def _worklist(mesh, blocks) -> ShardedWorklist:
    """Wrap the shards' worklist blocks with the global count: the sum of
    the local counts, on the mesh's first device."""
    d0 = mesh[0]
    count = torch.stack([b.count.to(d0) for b in blocks]).sum(
        dtype=torch.int32)
    return ShardedWorklist(blocks=tuple(blocks), count=count)


def _padded(sh: Shard, block: torch.Tensor, size: int) -> torch.Tensor:
    """A zero vector of length ``size`` with the shard's block written in
    at its owned rows (with ``size`` N+1: the shard's exchange delta)."""
    full = torch.zeros(size, dtype=block.dtype, device=sh.device)
    full[sh.lo:sh.hi] = block
    return full


# ---------------------------------------------------------------------------
# dense (topology-driven) distributed step
# ---------------------------------------------------------------------------

def _dense_fused_local(sh: Shard, colors, base_l, active, window: int,
                       tile_rows: "int | None"):
    ig = sh.ig
    n = ig.n_nodes
    cu = colors[sh.lo:sh.hi]
    pu = ig.priority[sh.lo:sh.hi]
    pending = active & (cu >= 0)
    hub_tables = None
    if ig.n_hub > 0:
        base_pad = _padded(sh, base_l, n)
        # only owned hub slots are read, and their tail_src rows are owned
        # too — the shard's own pending flags suffice (no exchange)
        pending_full = _padded(sh, pending, n + 1)
        hub_tables = (ipgc._hub_forbidden(ig, colors, base_pad, window),
                      ipgc._hub_lose(ig, colors, pending_full))
    # the kernel gathers the shard's neighbours itself (rows None: all)
    lose, first, has = ipgc._fused_rows(ig, colors, None, base_l, cu, pu,
                                        sh.row_ids, pending, hub_tables,
                                        window, tile_rows)
    need = lose | (active & (cu < 0))
    new_c = torch.where(need & has, base_l + first,
                        torch.where(lose, NO_COLOR, cu))
    new_base = torch.where(need & ~has, base_l + window, base_l)
    # ONE exchange publishes the speculated colors AND the uncolorings
    return _Writes(None, cu, new_c), new_base, need


def _dense_assign_local(sh: Shard, colors, base_l, active, window: int,
                        tile_rows: "int | None"):
    ig = sh.ig
    n = ig.n_nodes
    hub_forb = None
    if ig.n_hub > 0:
        base_pad = _padded(sh, base_l, n)
        hub_forb = ipgc._hub_forbidden(ig, colors, base_pad, window)
    cu = colors[sh.lo:sh.hi]
    # the kernel gathers the shard's neighbours itself (rows None: all)
    new_c, new_base, newly = ipgc._mex_rows(ig, colors, None, base_l, active,
                                            cu, hub_forb, window, tile_rows)
    # exchange 1 publishes the speculative colors of the owned rows
    return _Writes(None, cu, torch.where(active, new_c, cu)), new_base, newly


def _dense_resolve_local(sh: Shard, colors2, active, newly,
                         tile_rows: "int | None"):
    ig = sh.ig
    n = ig.n_nodes
    lose = ipgc._lose_rows(ig, None, sh.row_ids, colors2, newly, tile_rows)
    if ig.n_hub > 0:
        # a local scatter: owned slots only read owned tail_src rows
        newly_g = _padded(sh, newly, n + 1)
        lose = lose | ipgc._hub_lose(ig, colors2, newly_g)[ig.hub_slot]
    c2 = colors2[sh.lo:sh.hi]
    # exchange 2 uncolors the losers (their writes were in colors2)
    undo = _Writes(None, c2, torch.where(lose, NO_COLOR, c2))
    return undo, lose | (active & ~newly)


def make_dist_dense_step(ig: ipgc.IPGCGraph, mesh, *, window: int = 128,
                         fused: bool = False, exchange: str = "dense",
                         boundary=None, thresh: "int | None" = None,
                         tile_rows: "int | None" = None):
    """Build the dense distributed step over the mesh.

    ``ig`` is the prepared, partitioned graph. Returns
    ``step(colors, base, wl) -> (colors, base, wl)`` over the sharded
    state of ``shard_state``: per-shard color replicas and base blocks,
    and a ``ShardedWorklist``.

    ``fused=False`` is the two-phase step (equal to ``ipgc.dense_step``,
    two color exchanges per iteration); ``fused=True`` pipelines the
    resolve of the last round with this round's assign (equal to
    ``ipgc.fused_dense_step``, one exchange).

    ``exchange != "dense"``: the colors are per-shard views
    (``shard_views``) published through ``_publish_packed``, and the step
    is ``step(views, base, wl, *, bcap) -> (views, base, wl, xstats)``
    (see ``_Publisher``). ``boundary`` is the partition's
    ``graphs.partition.BoundaryInfo``, ``thresh`` the changed-count
    threshold of ``policy.exchange_threshold``. ``tile_rows`` is the row
    kernels' rows a block (None: their default block).
    """
    shards = shard_graph(ig, mesh)
    n = ig.n_nodes
    publisher = _Publisher(mesh, shards, n, exchange, boundary, thresh)

    def run(colors, base, wl: ShardedWorklist, pub):
        masks = [b.mask for b in wl.blocks]
        if fused:
            writes, new_base, still = zip(*(
                _dense_fused_local(sh, c, b, m, window, tile_rows)
                for sh, c, b, m in zip(shards, colors, base, masks)))
            colors_out = pub(colors, writes)
        else:
            writes, new_base, newly = zip(*(
                _dense_assign_local(sh, c, b, m, window, tile_rows)
                for sh, c, b, m in zip(shards, colors, base, masks)))
            colors2 = pub(colors, writes)
            undos, still = zip(*(
                _dense_resolve_local(sh, c, m, nw, tile_rows)
                for sh, c, m, nw in zip(shards, colors2, masks, newly)))
            colors_out = pub(colors2, undos)
        # the owned rows still active, as global ids (pad N), through the
        # compact kernel
        blocks = []
        for sh, st in zip(shards, still):
            items, count = compact_items(sh.row_ids, st, n)
            blocks.append(Worklist(mask=st, items=items, count=count))
        return colors_out, tuple(new_base), _worklist(mesh, blocks)

    return publisher.bind(run, 1 if fused else 2)


# ---------------------------------------------------------------------------
# sparse (data-driven) distributed step — shard-local items/count
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SparseRows:
    """One shard's gathered worklist rows."""

    valid: torch.Tensor       # bool[C]
    local: torch.Tensor       # int64[C] block-local row (pad lanes -> 0)
    rows: torch.Tensor        # int32[C] block-local row (pad lanes -> blk)
    ids: torch.Tensor         # int32[C] global ids, pad N
    cu: torch.Tensor          # int32[C] current colors (pad PAD_COLOR)
    base_rows: "torch.Tensor | None"   # int32[C] window bases


def _sparse_rows(sh: Shard, colors, items_l, base_l=None) -> _SparseRows:
    """Gather the shard's worklist rows; with ``base_l`` also their window
    bases. The row kernels gather the rows' neighbours and hub rows
    themselves from ``rows``."""
    ig = sh.ig
    n = ig.n_nodes
    blk = sh.hi - sh.lo
    valid = items_l < n
    # this shard only ever holds ids of its own block; the clip guards the
    # pad lanes
    local = torch.where(valid, items_l - sh.lo, 0).clamp(0, blk - 1).long()
    ids = torch.where(valid, items_l, n)
    return _SparseRows(valid=valid, local=local,
                       rows=torch.where(valid, local, blk).to(torch.int32),
                       ids=ids, cu=colors[ids],
                       base_rows=None if base_l is None else base_l[local])


def _sparse_fused_local(sh: Shard, colors, base_l, items_l, window: int,
                        tile_rows: "int | None"):
    ig = sh.ig
    n = ig.n_nodes
    r = _sparse_rows(sh, colors, items_l, base_l)
    pu = ig.priority[r.ids]
    pending = r.valid & (r.cu >= 0)
    hub_tables = None
    if ig.n_hub > 0:
        base_pad = _padded(sh, base_l, n)
        pending_full = ipgc._set_rows(
            torch.zeros(n + 1, dtype=torch.bool, device=sh.device),
            torch.where(pending, items_l, n), pending)
        hub_tables = (ipgc._hub_forbidden(ig, colors, base_pad, window),
                      ipgc._hub_lose(ig, colors, pending_full))
    # the kernel gathers the items' neighbours itself (pad lanes: row blk)
    lose, first, has = ipgc._fused_rows(ig, colors, r.rows, r.base_rows,
                                        r.cu, pu, r.ids, pending, hub_tables,
                                        window, tile_rows)
    need = lose | (r.valid & (r.cu < 0))
    new_c = torch.where(need & has, r.base_rows + first,
                        torch.where(lose, NO_COLOR, r.cu))
    new_base_rows = torch.where(need & ~has, r.base_rows + window,
                                r.base_rows)
    # ONE exchange (pad lanes write their own color back)
    writes = _Writes(r.ids, r.cu, torch.where(r.valid, new_c, r.cu))
    return writes, r, new_base_rows, need


def _sparse_assign_local(sh: Shard, colors, base_l, items_l, window: int,
                         tile_rows: "int | None"):
    ig = sh.ig
    r = _sparse_rows(sh, colors, items_l, base_l)
    hub_forb = None
    if ig.n_hub > 0:
        base_pad = _padded(sh, base_l, ig.n_nodes)
        hub_forb = ipgc._hub_forbidden(ig, colors, base_pad, window)
    # the kernel gathers the items' neighbours itself (pad lanes: row blk)
    new_c, new_base_rows, newly = ipgc._mex_rows(ig, colors, r.rows,
                                                 r.base_rows, r.valid, r.cu,
                                                 hub_forb, window, tile_rows)
    writes = _Writes(r.ids, r.cu, torch.where(r.valid, new_c, r.cu))
    return writes, r, new_base_rows, newly


def _sparse_resolve_local(sh: Shard, colors2, items_l, r: _SparseRows,
                          newly, tile_rows: "int | None"):
    ig = sh.ig
    n = ig.n_nodes
    # the shard's ELL rows of the items, pad lanes past its block
    lose = ipgc._lose_rows(ig, r.rows, r.ids, colors2, newly, tile_rows)
    if ig.n_hub > 0:
        newly_full = ipgc._set_rows(
            torch.zeros(n + 1, dtype=torch.bool, device=sh.device),
            torch.where(newly, items_l, n), newly)
        hub_l = ipgc._hub_lose(ig, colors2, newly_full)
        lose = lose | (hub_l[ig.hub_slot[r.local]] & r.valid)
    c2 = colors2[r.ids]
    undo = _Writes(r.ids, c2, torch.where(lose, NO_COLOR, c2))
    return undo, lose | (r.valid & ~newly)


def _sparse_maintain(sh: Shard, block: Worklist, base_l, r: _SparseRows,
                     new_base_rows, still):
    """O(C), shard-local: filter the items block, write the mask and base
    rows back (pad lanes go to the dropped row ``blk``)."""
    n = sh.ig.n_nodes
    blk = sh.hi - sh.lo
    items, count = compact_items(block.items, still, n)
    rows = torch.where(r.valid, r.local, blk)
    mask = ipgc._set_rows_drop(block.mask, rows, still)
    base = ipgc._set_rows_drop(base_l, rows, new_base_rows)
    return Worklist(mask=mask, items=items, count=count), base


def make_dist_sparse_step(ig: ipgc.IPGCGraph, mesh, *, window: int = 128,
                          fused: bool = False, exchange: str = "dense",
                          boundary=None, thresh: "int | None" = None,
                          tile_rows: "int | None" = None):
    """Build the data-driven distributed step over shard-local worklists.

    Each shard gathers only its own compacted items block (global ids it
    owns, padded with N), so per-iteration cost tracks the shard's share
    of the active set, not its block size. The color exchange is the same
    as the dense step's; the worklist filter and the ``mask`` write-back
    stay O(C) and shard-local. ``exchange``, ``boundary``, ``thresh`` and
    ``tile_rows`` as in ``make_dist_dense_step``.
    """
    shards = shard_graph(ig, mesh)
    publisher = _Publisher(mesh, shards, ig.n_nodes, exchange, boundary,
                           thresh)

    def run(colors, base, wl: ShardedWorklist, pub):
        items = [b.items for b in wl.blocks]
        if fused:
            writes, rows, new_base_rows, still = zip(*(
                _sparse_fused_local(sh, c, b, it, window, tile_rows)
                for sh, c, b, it in zip(shards, colors, base, items)))
            colors_out = pub(colors, writes)
        else:
            writes, rows, new_base_rows, newly = zip(*(
                _sparse_assign_local(sh, c, b, it, window, tile_rows)
                for sh, c, b, it in zip(shards, colors, base, items)))
            colors2 = pub(colors, writes)
            undos, still = zip(*(
                _sparse_resolve_local(sh, c, it, r, nw, tile_rows)
                for sh, c, it, r, nw in zip(shards, colors2, items, rows,
                                            newly)))
            colors_out = pub(colors2, undos)
        blocks, bases = zip(*(
            _sparse_maintain(sh, blk, b, r, nb, st)
            for sh, blk, b, r, nb, st in zip(shards, wl.blocks, base, rows,
                                             new_base_rows, still)))
        return colors_out, bases, _worklist(mesh, blocks)

    return publisher.bind(run, 1 if fused else 2)


def color_distributed(g, *, n_shards: "int | None" = None, devices=None,
                      device=None, mode: str = "hybrid",
                      algo: "str | object" = "ipgc", h: float = 0.6,
                      window: "int | str" = "auto", bucket_ratio: int = 2,
                      max_iter: int = 10_000, priority: str = "hash",
                      policy=None, collect_tti: bool = False,
                      fused: "bool | None" = True, balance: bool = True,
                      layout: "str | object | None" = None,
                      exchange: str = "dense", session=None,
                      steps_cache: "dict | None" = None):
    """Sharded hybrid Pipe: the host loop over the distributed
    steps (``Session.run`` with ``ExecutionSpec(regime="dist")``).

    The graph is padded and degree-balanced into equal owner blocks
    (``prepare_partition``); the loop then runs the host Pipe's control
    flow — policy on the global count, per-shard capacity ladder with
    slices at bucket boundaries — over the distributed steps. With the
    default ``fused=True`` the result matches
    ``engine.color(g2, fused=True)`` on the partitioned graph for fixed-H
    policies (colors, iterations, mode trace) on any shard count. Colors
    come back in ``g``'s original labeling.

    The mesh: ``devices`` (one per shard), else ``n_shards`` shards on the
    kind of ``device`` (see ``resolve_mesh``; ``device=None`` is CUDA).
    ``algo`` must name a shard-safe algorithm. ``session`` defaults to the
    process-default session of the mesh's first device. ``steps_cache``
    (the reference's compile-cache argument): the dict becomes the backing
    store of a session of its own, so passing the same dict across calls
    reuses the partitioned graph and the steps; not with ``session``.
    ``exchange``: the cross-shard color publication (DESIGN.md §13) —
    ``"dense"`` (the additive exchange of int32[N+1]), ``"boundary"``
    (packed changed-boundary buffers whenever they fit) or ``"auto"``
    (packed only below the byte break-even threshold); all three give the
    same coloring.
    """
    from repro_torch.exec import ExecutionSpec, Session, default_session
    spec = ExecutionSpec(
        regime="dist", mode=mode, algo=algo, layout=layout, h=h,
        window=window, bucket_ratio=bucket_ratio, max_iter=max_iter,
        priority=priority, fused=fused, n_shards=n_shards, balance=balance,
        exchange=exchange)
    if device is None and devices is not None:
        device = list(devices)[0]
    if steps_cache is not None:
        if session is not None:
            raise ValueError("pass steps_cache or session, not both")
        session = Session(device, cache=steps_cache)
    elif session is None:
        session = default_session(device)
    return session.run(spec, g, policy=policy, collect_tti=collect_tti,
                       devices=devices)
