"""Batched multi-graph coloring — many graphs, one trip at a time
(``repro/exec/batch.py``).

The serving workload (DESIGN.md §9): graphs are padded into *shape-class
buckets* and a bucket's lanes run the dense-form step together until
every lane drains.

Shape-class bucketing, as in the reference:

  * The node ladder is ``worklist.bucket_capacities(max_n,
    ratio=spec.bucket_ratio)``: each graph lands in the smallest rung that
    holds it (``pick_bucket``).
  * Within a rung, lanes share every static step argument: graphs are
    sub-grouped by (resolved window, layout kind), and the bucket's ELL
    width / tail length / hub count are the member maxima rounded up
    (multiples of 8 for the ELL width, powers of two for tail and hub
    slots); ``ipgc.pad_prepared`` keeps the padding inert. The lane count
    is a power of two, filled with inert lanes.

The reference vmaps the step over the lanes. The port's kernels are raw
launches, so it lays a lane group out as ONE block-diagonal graph
(``LaneState``, written lane by lane by ``ipgc.pad_into``, so no padded
copy of a lane is kept): lane ``l``'s row ``r`` is flat row
``l * n_pad + r``, and
every lane's padding points at the one flat sentinel ``N = b * n_pad``
(so the row kernels still end a row at its first padding entry); tail
entries are offset per lane, and lane ``l``'s hub slot ``h`` is flat slot
``l * nh_pad + h``, with every "not a hub" at the one neutral row
``b * nh_pad``. The state is flat too — colors ``int32[N+1]``, mask
``bool[N]``, the aux with ``n_pad`` (IPGC bases) or one (JPL round)
entries per lane — and a lane's view is a reshape, ``x[:N].view(b,
n_pad)``. The steps and kernels run unchanged on the flattened graph: a
row sees only its own lane's neighbours, and an id compared with an id of
the same lane keeps its order under the offset (JPL, which hashes ids by
value, has its own lane round: ``Algorithm.lane_step``).

One trip (``LaneState._trip``): per lane, ``alive = count > 0 and iters <
max_iter`` and ``dense = alive and count > threshold`` from the previous
trip's counters; the dense step on the flattened graph; lanes that are not
alive keep their old state (``_freeze_inert``); per-lane counts
``mask.view(b, n_pad).sum(1)``; ``iters``, ``nd`` and ``ns`` counted. On a
CUDA device the trip is captured once per lane group as a CUDA graph
(``exec/chunk.py``'s ``capture_trip``) and a chunk replays it while a lane
is alive and the chunk's trip budget lasts, reading the ``(4, b)``
counters once per replay; on the CPU the trip runs eagerly. Admission
writes a lane's graph and fresh state into its slices of the buffers, so
the addresses, and the capture, stay; a shape-class growth or a lane-width
change makes new buffers, captured anew.

Bit-identity contract (tests/test_torch_batch.py): every lane's colors,
iteration count and mode trace equal ``Session.run`` on that graph alone
in the host regime — the padding is inert, the dense and sparse forms of a
batch-safe algorithm give the same state for the same active set (so the
batched Pipe always runs the dense form and rebuilds the D/S trace from
the per-lane counts against the per-lane threshold, exact for monotone
policies), and drained lanes are no-ops.

Memory: a lane group's bytes are reckoned before they are allocated
(``group_bytes``) and held against the device's free memory:
``run_batch`` checks all the new groups of a call before it builds the
first, a ``LaneState`` its graph and state, and a trip its intermediates
before the warm-up and capture. A shortfall raises ``LaneMemoryError``,
naming the bytes, instead of failing inside an allocation or a capture.

Restrictions (validated loudly): monotone policy modes only, ELL-family
layouts only (csr-segment edge arrays are not lane-stacked), and a
``batch_safe`` algorithm.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.algos.jpl import jpl_lane_dense_step
from repro_torch.core import ipgc
from repro_torch.core.engine import ColoringResult
from repro_torch.core.policy import Timer, device_threshold, make_policy
from repro_torch.core.worklist import (Worklist, bucket_capacities,
                                       pick_bucket, stacked_worklist)
from repro_torch.exec.chunk import (CHUNK_COUNTS, TripState, capture_trip,
                                    replay)
from repro_torch.exec.spec import ExecutionSpec
from repro_torch.graphs.csr import Graph
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """Static signature of one batch bucket."""

    n_pad: int
    k_pad: int
    t_pad: int
    nh_pad: int
    window: int
    kind: str


def _pow2(x: int, floor: int = 1) -> int:
    p = floor
    while p < x:
        p *= 2
    return p


def _round8(x: int) -> int:
    return max(-(-x // 8) * 8, 8)


def shape_class_for(igs, n_cap: int, window: int, kind: str) -> ShapeClass:
    """The ShapeClass covering every member of one bucket rung: ELL width /
    tail length / hub count are the member maxima rounded up (x8 for the
    ELL width, powers of two for tail and hub slots)."""
    return ShapeClass(
        n_pad=n_cap,
        k_pad=_round8(max(ig.ell_width for ig in igs)),
        t_pad=_pow2(max(ig.tail_src.shape[0] for ig in igs), floor=8),
        nh_pad=(0 if all(ig.n_hub == 0 for ig in igs)
                else _pow2(max(ig.n_hub for ig in igs))),
        window=window, kind=kind)


def grow_shape_class(sc: ShapeClass, ig) -> ShapeClass:
    """Sticky growth for streamed lane groups (``serve/stream.py``): widen
    the pads to also cover ``ig``, never shrink. The lanes' state depends
    only on ``n_pad``, so growth re-pads the graph arrays alone."""
    assert ig.n_nodes <= sc.n_pad, "graph exceeds the group's node rung"
    return ShapeClass(
        n_pad=sc.n_pad,
        k_pad=max(sc.k_pad, _round8(ig.ell_width)),
        t_pad=max(sc.t_pad, _pow2(ig.tail_src.shape[0], floor=8)),
        nh_pad=(sc.nh_pad if ig.n_hub == 0
                else max(sc.nh_pad, _pow2(ig.n_hub))),
        window=sc.window, kind=sc.kind)


def lane_colors(real_n: int, n_pad: int, device) -> torch.Tensor:
    """Per-lane initial colors ``int32[n_pad+1]``: real slots uncolored,
    pad slots (and the sentinel) ``PAD_COLOR``, so pad nodes can never
    look active or conflicting."""
    ar = torch.arange(n_pad + 1, device=device)
    return torch.where(ar < real_n, ipgc.NO_COLOR,
                       ipgc.PAD_COLOR).to(torch.int32)


def empty_lane(sc: ShapeClass, device) -> ipgc.IPGCGraph:
    """An all-padding member of the shape class (its count is 0, so every
    step is a no-op on it), as zero-stride views: it holds no memory, and
    nothing writes to it."""
    def full(shape, value, dtype=torch.int32):
        return torch.full((1,) * len(shape), value, dtype=dtype,
                          device=device).expand(shape)

    return ipgc.IPGCGraph(
        n_nodes=sc.n_pad, ell_width=sc.k_pad, n_hub=sc.nh_pad,
        ell_idx=full((sc.n_pad, sc.k_pad), sc.n_pad),
        degrees=full((sc.n_pad,), 0), priority=full((sc.n_pad + 1,), -1),
        tail_src=full((sc.t_pad,), 0), tail_dst=full((sc.t_pad,), sc.n_pad),
        tail_valid=full((sc.t_pad,), False, torch.bool),
        tail_slot=full((sc.t_pad,), sc.nh_pad),
        hub_slot=full((sc.n_pad,), sc.nh_pad),
        hub_ids=full((max(sc.nh_pad, 1),), 0), layout_kind=sc.kind)


# ---------------------------------------------------------------------------
# the flattened lane group
# ---------------------------------------------------------------------------

#: the rows of a lane group's ``TripState.ctr``: count, nd, it, ns per lane
#: (the order of ``exec/chunk.py``'s counters); of its ``lim``: threshold,
#: max_iter. Its ``items`` (int32[N]) is the dense step's emission capacity,
#: and its flat ``aux`` has one row of the ``(b, -1)`` view a lane.
COUNT, ND, IT, NS = range(4)
THRESH, MAX_ITER = range(2)


def _inert_buffers(aux0: torch.Tensor, b: int, n_pad: int,
                   device) -> TripState:
    """The state of ``b`` inert lanes: PAD-only colors, a fresh lane's aux
    ``aux0``, empty masks and zero counters (count 0: never alive)."""
    n = b * n_pad
    return TripState(
        colors=torch.full((n + 1,), ipgc.PAD_COLOR, dtype=torch.int32,
                          device=device),
        aux=aux0.repeat(b),
        mask=torch.zeros(n, dtype=torch.bool, device=device),
        items=torch.empty(n, dtype=torch.int32, device=device),
        ctr=torch.zeros((4, b), dtype=torch.int32, device=device),
        lim=torch.zeros((2, b), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# memory: a lane group's bytes, reckoned before they are allocated
# ---------------------------------------------------------------------------

#: a dense trip's intermediates beyond its (N, K) tile, reckoned per row
#: (ids, new colors and bases, masks, the emission) and per tail entry
#: (the hub side-channel's passes)
TRIP_ROW_BYTES = 64
TRIP_TAIL_BYTES = 32


class LaneMemoryError(MemoryError):
    """A lane group would need more device memory than is free."""


def aux_lane_bytes(sc: ShapeClass, alg) -> int:
    """Bytes of one lane's aux (IPGC bases, JPL round), from the shapes
    alone (on the meta device)."""
    aux = alg.init_state(empty_lane(sc, "meta"))[1]
    return aux.numel() * aux.element_size()


def trip_bytes(sc: ShapeClass, b: int, step) -> int:
    """The intermediates of one dense trip of ``b`` lanes under ``step``,
    which its capture pool keeps: for the two-phase step (colors, with its
    (N, W) hub rows) and the JPL round (priorities), the gathered (N, K)
    int32 tile and the int64 copy of ``ell_idx`` that PyTorch's gather
    makes of its index, 12 bytes an entry (the pools measured on an H100
    match it, ``PERF.md``); ``TRIP_ROW_BYTES`` a row and
    ``TRIP_TAIL_BYTES`` a tail entry for the rest. The fused steps gather
    inside their kernel."""
    n = b * sc.n_pad
    tile = 0
    if step is ipgc.dense_step:
        tile = 12 * n * sc.k_pad + n * sc.window
    elif step is jpl_lane_dense_step:
        tile = 12 * n * sc.k_pad
    return tile + TRIP_ROW_BYTES * n + TRIP_TAIL_BYTES * b * sc.t_pad


def group_bytes(sc: ShapeClass, b: int, alg, step=None) -> dict:
    """A lane group's device bytes: ``graph`` and ``state`` exactly as
    ``LaneState`` allocates them (their sum is its ``nbytes``), and, given
    the ``step`` it runs, ``trip`` as ``trip_bytes`` reckons it."""
    n, t = b * sc.n_pad, b * sc.t_pad
    graph = (4 * n * sc.k_pad + 4 * n + 4 * (n + 1) + 13 * t + 4 * n
             + 4 * max(b * sc.nh_pad, 1))
    state = (4 * (n + 1) + b * aux_lane_bytes(sc, alg) + n + 4 * n
             + 16 * b + 8 * b)
    need = dict(graph=graph, state=state)
    if step is not None:
        need["trip"] = trip_bytes(sc, b, step)
    return need


def _free_bytes(device: torch.device) -> "int | None":
    """The device memory free for new allocations, after this process's
    allocator has returned what it holds unused; None off CUDA (the host's
    memory is not reckoned)."""
    if device.type != "cuda":
        return None
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(device)[0]


def ensure_fits(need: dict, device: torch.device, what: str) -> None:
    """Raise ``LaneMemoryError`` when the bytes of ``need`` (by part) are
    more than the device has free."""
    free = _free_bytes(device)
    total = sum(need.values())
    if free is None or total <= free:
        return
    parts = ", ".join(f"{k} {v / 2**30:.2f}" for k, v in need.items())
    raise LaneMemoryError(
        f"{what} needs {total / 2**30:.2f} GiB on {device} ({parts}), and "
        f"{free / 2**30:.2f} GiB are free: batch fewer or smaller graphs, "
        "or build them at a narrower ELL width (ell_cap)")


def _freeze_inert(alive: torch.Tensor, new: torch.Tensor,
                  old: torch.Tensor) -> torch.Tensor:
    """Per-lane select on the ``(b, -1)`` views: lanes that are not alive
    keep their old state. For a drained lane this is a no-op (an all-False
    active mask makes the step itself inert); it makes a lane at its
    ``max_iter`` cap stop evolving, as the solo host loop stops
    dispatching there, so lanes admitted in different rounds carry
    different iteration counts through one trip."""
    b = alive.shape[0]
    return torch.where(alive[:, None], new.view(b, -1), old.view(b, -1))


class LaneState:
    """One lane group: the flattened graph of its ``b`` lanes (``lanes[l]``
    the prepared graph of lane ``l``, None for an inert lane; each written
    into its block by ``ipgc.pad_into``, so no padded copy is kept), its
    state buffers, a host copy of the ``(4, b)`` counters as of the last
    read, and, on a CUDA device, its captured trips.

    A lane's values never depend on the other lanes, so ``widen_lanes``
    (appending inert lanes) and ``take_lanes`` (dropping or reordering
    lanes) carry every kept lane's state verbatim into new buffers. The
    group owns all of its device state, so evicting a session cache entry
    never touches a live stream."""

    def __init__(self, sc: ShapeClass, lanes: list, alg, device,
                 buffers: "TripState | None" = None):
        self.sc = sc
        self.lanes = list(lanes)
        self.alg = alg
        self.b = b = len(self.lanes)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if not self.cuda and self.device.type != "cpu":
            raise ValueError(f"no lane group for tensors on {self.device}")
        # the trip's bytes are reckoned before its capture
        need = group_bytes(sc, b, alg)
        if buffers is not None:
            del need["state"]
        ensure_fits(need, self.device, f"a lane group of {b} x {sc}")
        self.ig = ipgc.padded_graph(sc.n_pad, sc.k_pad, sc.t_pad, sc.nh_pad,
                                    lanes=b, layout_kind=sc.kind,
                                    device=self.device)
        for lane, ig in enumerate(self.lanes):
            ipgc.pad_into(ig, self.ig, lane, b)
        #: a fresh lane's aux (it depends on the shape class alone)
        self.aux0 = alg.init_state(empty_lane(sc, self.device))[1].reshape(-1)
        self.buf = buffers or _inert_buffers(self.aux0, b, sc.n_pad,
                                             self.device)
        self.host = np.array(self.buf.ctr.tolist(), dtype=np.int64)
        self.max_iter = np.array(self.buf.lim[MAX_ITER].tolist(),
                                 dtype=np.int64)
        self.trips: dict = {}
        self.pool = self.stream = None
        if self.cuda:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    @property
    def nbytes(self) -> int:
        """Device bytes the group owns: the flattened graph and the state
        (a trip's intermediates, in the capture pool, come on top)."""
        arrays = [getattr(self.ig, f) for f in ipgc.ARRAY_FIELDS]
        arrays += self.buf.tensors()
        return sum(a.numel() * a.element_size() for a in arrays)

    def alive(self) -> np.ndarray:
        """Per-lane ``count > 0 and iters < max_iter`` as of the last
        read."""
        return (self.host[COUNT] > 0) & (self.host[IT] < self.max_iter)

    def release(self) -> None:
        """Free the captured trips and the flattened graph (the group is
        being replaced by new buffers)."""
        self.trips.clear()
        self.ig = None

    # -- admission -----------------------------------------------------------

    def reset_lane(self, lane: int, real_n: int, thresh: int,
                   max_iter: int) -> None:
        """Load a fresh run into a lane's state slices: its first
        ``real_n`` nodes uncolored and active, the rest ``PAD_COLOR``,
        counters zero and ``count = real_n``."""
        n_pad = self.sc.n_pad
        rows = slice(lane * n_pad, (lane + 1) * n_pad)
        self.buf.colors[rows] = lane_colors(real_n, n_pad,
                                            self.device)[:n_pad]
        self.buf.aux.view(self.b, -1)[lane] = self.aux0
        self.buf.mask[rows] = stacked_worklist([real_n], n_pad,
                                               self.device).mask[0]
        ctr = [real_n, 0, 0, 0]
        self.buf.ctr[:, lane] = torch.tensor(ctr, dtype=torch.int32)
        self.buf.lim[:, lane] = torch.tensor([thresh, max_iter],
                                             dtype=torch.int32)
        self.host[:, lane] = ctr
        self.max_iter[lane] = max_iter

    def admit(self, lane: int, ig: ipgc.IPGCGraph, thresh: int,
              max_iter: int) -> None:
        """Put a prepared graph in ``lane``: its arrays, padded, into the
        lane's block of the flattened graph, and a fresh run into its
        state. The buffers keep their addresses, so the captured trip
        stays valid."""
        self.lanes[lane] = ig
        ipgc.pad_into(ig, self.ig, lane, self.b)
        self.reset_lane(lane, ig.n_nodes, thresh, max_iter)

    def harvest_colors(self, lane: int, real_n: int) -> np.ndarray:
        """Host copy of lane ``lane``'s first ``real_n`` colors."""
        start = lane * self.sc.n_pad
        return self.buf.colors[start:start + real_n].cpu().numpy().copy()

    # -- trips ---------------------------------------------------------------

    def _trip(self, buf: TripState, step, window: int, force_hub: bool,
              tile_rows: "int | None") -> None:
        """One batched trip on the buffers ``buf`` (see the module doc)."""
        b, n = self.b, self.ig.n_nodes
        ctr, lim = buf.ctr, buf.lim
        alive = (ctr[COUNT] > 0) & (ctr[IT] < lim[MAX_ITER])
        dense = alive & (ctr[COUNT] > lim[THRESH])
        # the dense steps read the mask and the items' capacity only
        colors, aux, wl = step(self.ig, buf.colors, buf.aux,
                               Worklist(mask=buf.mask, items=buf.items,
                                        count=ctr[COUNT]),
                               window=window, force_hub=force_hub,
                               tile_rows=tile_rows)
        mask = _freeze_inert(alive, wl.mask, buf.mask)
        buf.colors[:n].view(b, -1).copy_(
            _freeze_inert(alive, colors[:n], buf.colors[:n]))
        buf.aux.view(b, -1).copy_(_freeze_inert(alive, aux, buf.aux))
        buf.mask.view(b, -1).copy_(mask)
        ctr[COUNT].copy_(mask.sum(1, dtype=torch.int32))
        ctr[ND].add_(dense.to(torch.int32))
        ctr[IT].add_(alive.to(torch.int32))
        ctr[NS].add_((alive & ~dense).to(torch.int32))

    def run(self, chunk: int, *, step, window: int, force_hub: bool,
            tile_rows: "int | None" = None) -> int:
        """One chunk: trips while a lane is alive and fewer than ``chunk``
        have run, one counter read after each. Returns the trips run. The
        captured trips are keyed by the step and its static arguments,
        ``tile_rows`` (the row kernels' rows a block) among them."""
        CHUNK_COUNTS["chunks"] += 1
        trips = 0
        while trips < chunk and self.alive().any():
            if self.cuda:
                key = (step, window, force_hub, tile_rows)
                trip = self.trips.get(key)
                if trip is None:
                    ensure_fits(dict(trip=trip_bytes(self.sc, self.b, step)),
                                self.device,
                                f"the trip of a lane group of {self.b} x "
                                f"{self.sc}")
                    trip = self.trips[key] = capture_trip(
                        lambda s: self._trip(s, step, window, force_hub,
                                             tile_rows),
                        self.buf, pool=self.pool, stream=self.stream)
                replay(trip)
            else:
                self._trip(self.buf, step, window, force_hub, tile_rows)
            trips += 1
            self.host = np.array(self.buf.ctr.tolist(), dtype=np.int64)
            CHUNK_COUNTS["reads"] += 1
        return trips


def fresh_lane_state(sc: ShapeClass, alg, b: int, device) -> LaneState:
    """``b`` inert lanes of shape class ``sc``: PAD-only colors, drained
    worklists and zeroed counters — the template a stream group fills on
    admission."""
    return LaneState(sc, [None] * b, alg, device)


def _relaid(st: LaneState, lanes: list, rows: list, extra: int
            ) -> LaneState:
    """A new group of ``lanes`` whose state is ``st``'s lanes ``rows`` (in
    that order) followed by ``extra`` inert lanes. ``st`` is released
    before the new graph is made, so the two graphs and captures never
    coexist."""
    buf, b_old, n_pad = st.buf, st.b, st.sc.n_pad
    idx = torch.tensor(rows, dtype=torch.int64, device=st.device)
    fill = (_inert_buffers(st.aux0, extra, n_pad, st.device) if extra
            else None)

    def lay(name, width):
        """The kept lanes' blocks of buffer ``name`` (``width`` entries a
        lane), then the inert ones."""
        parts = [getattr(buf, name)[:b_old * width].view(b_old, width)[idx]]
        if fill is not None:
            parts.append(getattr(fill, name)[:extra * width].view(extra,
                                                                  width))
        return torch.cat(parts).reshape(-1)

    def cols(name):
        parts = [getattr(buf, name)[:, idx]]
        if fill is not None:
            parts.append(getattr(fill, name))
        return torch.cat(parts, dim=1)

    out = TripState(
        colors=torch.cat([lay("colors", n_pad), buf.colors[-1:]]),
        aux=lay("aux", buf.aux.numel() // b_old),
        mask=lay("mask", n_pad),
        items=torch.empty(len(lanes) * n_pad, dtype=torch.int32,
                          device=st.device),
        ctr=cols("ctr"), lim=cols("lim"))
    st.release()
    return LaneState(st.sc, lanes, st.alg, st.device, buffers=out)


def widen_lanes(st: LaneState, b_new: int) -> LaneState:
    """Grow the lane axis to ``b_new`` by appending inert lanes; the
    resident lanes' values are carried verbatim (``st`` is released)."""
    extra = b_new - st.b
    if extra < 0:
        raise ValueError(f"widen_lanes cannot shrink {st.b} -> {b_new}")
    if extra == 0:
        return st
    return _relaid(st, st.lanes + [None] * extra, list(range(st.b)), extra)


def take_lanes(st: LaneState, idx) -> LaneState:
    """Compact (or reorder) the lane axis to ``idx`` — shrink-on-idle
    retires inert lanes by selecting only the resident ones; each kept
    lane's values are carried verbatim (``st`` is released)."""
    idx = [int(i) for i in idx]
    return _relaid(st, [st.lanes[i] for i in idx], idx, 0)


def regraph(st: LaneState, sc: ShapeClass) -> LaneState:
    """The group under a grown shape class: the lanes re-padded to ``sc``,
    the state carried as it is (it depends on ``n_pad`` alone, which
    growth keeps; ``st`` is released)."""
    assert sc.n_pad == st.sc.n_pad
    st.release()
    return LaneState(sc, st.lanes, st.alg, st.device, buffers=st.buf)


# ---------------------------------------------------------------------------
# the batched Pipe
# ---------------------------------------------------------------------------

def _validate(spec: ExecutionSpec, graphs):
    alg = spec.validate_batchable()
    for g in graphs:
        if not isinstance(g, Graph):
            raise TypeError(
                "run_batch needs host Graph objects (it pads and stacks "
                f"prepared arrays); got {type(g).__name__}")
    return alg


def run_batch(session, spec: ExecutionSpec, graphs,
              *, map_to_original: bool = False) -> list[ColoringResult]:
    """Color ``graphs`` under ``spec``; results in input order.

    ``map_to_original=True`` maps each lane's colors back through its
    graph's ``Permutation`` (no-op for unreordered graphs)."""
    graphs = list(graphs)
    alg = _validate(spec, graphs)
    if not graphs:
        return []
    with session.pin():
        return _run_batch_pinned(session, spec, alg, graphs,
                                 map_to_original=map_to_original)


def _run_batch_pinned(session, spec, alg, graphs, *, map_to_original):
    fused = alg.resolve_fused(spec.fused, default=False)  # host-loop default
    step = alg.lane_step(fused)
    force_hub = ipgc.force_hub_enabled()
    tile_rows = spec.explicit_tile_rows()
    pol = make_policy(spec.mode, spec.h)

    prepared = [session._prepare(spec, g, alg)[:2] for g in graphs]
    for ig, _ in prepared:
        if ig.layout_kind == "csr-segment":
            raise NotImplementedError(
                "run_batch has no csr-segment lanes (per-graph edge "
                "arrays are not lane-stacked); pass layout='ell-tail' to "
                "batch this graph's ELL+tail arrays")

    # ---- shape-class bucketing (node ladder = worklist.bucket_capacities)
    caps = bucket_capacities(max(ig.n_nodes for ig, _ in prepared),
                             ratio=spec.bucket_ratio)
    groups: dict[tuple, list[int]] = {}
    for i, (ig, window) in enumerate(prepared):
        gk = (pick_bucket(caps, ig.n_nodes), window, ig.layout_kind)
        groups.setdefault(gk, []).append(i)

    # ---- the lane groups (cached: an identical batch replays its trips)
    plan = []
    for (n_cap, window, kind), idxs in sorted(groups.items(),
                                              key=lambda kv: kv[1][0]):
        sc = shape_class_for([prepared[i][0] for i in idxs], n_cap, window,
                             kind)
        b_pad = _pow2(len(idxs))
        stack_key = ("stack", sc, alg, spec.priority, spec.layout,
                     spec.window,
                     tuple(session.graph_key(graphs[i]) for i in idxs),
                     b_pad)
        plan.append((window, kind, idxs, sc, b_pad, stack_key))
    # every new group's bytes, before the first is allocated
    built = [key for *_, key in plan if key not in session.cache]
    need = dict(graph=0, state=0, trip=0)
    for *_, sc, b_pad, stack_key in plan:
        if stack_key in built:
            for k, v in group_bytes(sc, b_pad, alg, step).items():
                need[k] += v
    ensure_fits(need, session.device, f"run_batch of {len(graphs)} graphs")

    results: list[ColoringResult | None] = [None] * len(graphs)
    try:
        for window, kind, idxs, sc, b_pad, stack_key in plan:

            def build_stack():
                lanes = [prepared[i][0] for i in idxs]
                lanes += [None] * (b_pad - len(idxs))
                return ([graphs[i] for i in idxs],
                        LaneState(sc, lanes, alg, session.device))

            _, st = session.cached(stack_key, build_stack)

            real_ns = [prepared[i][0].n_nodes for i in idxs]
            real_ns += [0] * (b_pad - len(idxs))
            for lane, rn in enumerate(real_ns):
                thresh = device_threshold(pol, rn) if rn else 0
                st.reset_lane(lane, rn, thresh, spec.max_iter)

            with obs_trace.maybe_span("batch.dispatch", lanes=len(idxs),
                                      b_pad=b_pad, n_pad=sc.n_pad,
                                      window=window, kind=kind), \
                    Timer() as t:
                st.run(spec.max_iter, step=step, window=window,
                       force_hub=force_hub, tile_rows=tile_rows)
            counts_left = st.host[COUNT][:len(idxs)]
            if int(counts_left.sum()) != 0:
                raise RuntimeError(
                    f"batch bucket {sc} hit max_iter={spec.max_iter} with "
                    f"undrained lanes (counts {counts_left})")

            for lane, i in enumerate(idxs):
                g = graphs[i]
                rn = prepared[i][0].n_nodes
                final, n_colors = alg.finalize(st.harvest_colors(lane, rn))
                if (map_to_original
                        and getattr(g, "perm", None) is not None):
                    final = g.perm.colors_to_original(final)
                nd, ns = int(st.host[ND][lane]), int(st.host[NS][lane])
                results[i] = ColoringResult(
                    colors=final, n_colors=n_colors,
                    iterations=int(st.host[IT][lane]),
                    mode_trace="D" * nd + "S" * ns,
                    counts=[rn], tti=[t.seconds], total_seconds=t.seconds,
                    host_dispatches=1)
    except LaneMemoryError:
        # a refused call leaves none of its lane groups behind
        for key in built:
            session.cache.pop(key, None)
        raise
    return results
