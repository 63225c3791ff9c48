"""Per-device op costs of a step, counted as it runs (the port's
``repro/launch/hlocost.py``).

The reference compiles a step for a TPU pod and reads the partitioned HLO
text: FLOPs of every ``dot``, HBM bytes at every instruction boundary,
collective volumes, each multiplied by its loop's trip count. PyTorch has
no lowered program to read, so this module counts the ATen ops that run:
``OpCost`` is a ``TorchDispatchMode`` that sees every op of a step (on the
``meta`` device, where nothing is allocated, or on real tensors), and is
named after what it reads, ops rather than HLO.

* FLOPs: ``torch.utils.flop_counter``'s registered formulas (the matmul
  family, convolution, SDPA), the reference's "every dot", kept by the
  type they run in (``flops_by_dtype``), which sets the peak rate
  ``launch/roofline.py`` prices them at.
* Bytes: each ATen op is one instruction boundary, which is what eager
  execution on the card does. View and metadata ops and ``empty`` are
  free (the reference's ``_SKIP_MEMORY_OPS``); gather-type reads count
  twice their output, scatter-type writes twice their update (its
  slicing, gather, dynamic-update-slice and scatter rules); every other
  op its operands' bytes plus its outputs'. Ops whose outputs all lie on
  the host are host work, and a host tensor's copy to the device is the
  reference's HLO constant: neither is counted.
* Peak live bytes: the arguments' bytes, then each new output storage
  adds its bytes and each freed one takes them away (the counterpart of
  XLA's ``memory_analysis``).
* Kernels: ``kernels/ops.py``'s wrappers report each call through
  ``obs.opcost_hooks.kernel_call``: its operands' and outputs' bytes, the
  reference's rule for a custom call; the ATen ops inside a call are not
  counted.
* Shards. On a ``launch.mesh.DeviceMesh`` every cost is kept per mesh
  entry. The mesh forms enter ``obs.opcost_hooks.shard(coords)`` where
  they loop over shards; an op inside counts on the entries at those
  coordinates. Its outputs carry the coordinates, so that an op outside every context (the
  gradient pass, which autograd runs after the forward's loops, a
  recomputed checkpoint) counts where its operands came from. An op with
  no coordinates at all counts on the shard whose ops consume its result,
  or on every entry (each device repeats it in SPMD) when several shards
  or none do. An op whose operands come from different shards is the
  sum a collective makes (free here; the collective is recorded where the
  model makes it, or added by ``add_grad_sync``), and a ``cat``/``stack``
  of such operands is the join that places the shards' results on one
  device: free, and what is done to its result is spread evenly over
  those shards. ``meta`` has no device index, so shards are told apart by
  these contexts and never by device. The per-device cost is the largest
  entry's.
* Collectives: ``obs.opcost_hooks.collective`` at the mesh forms' call
  sites, in the reference's five kinds with its per-device volume rules
  (``dryrun.py::collective_bytes``), and the collective the gradient pass
  makes for it. On one controller the gradients of a parameter that
  several data shards use are summed inside autograd, so no transfer
  appears: ``add_grad_sync`` adds the all-reduce a multi-process run
  makes for each such leaf over the axes that replicate it.

The reference multiplies a ``while`` body by its trip count; the port's
counterpart is ``extrapolate`` (used by ``launch/dryrun.py``): the layer
stack is counted at two depths and each count extended linearly to the
config's depth.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.obs import opcost_hooks as hooks

aten = torch.ops.aten

#: the reference's collective kinds
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: free ops besides views: metadata, allocation, host reads
_FREE = {aten.detach.default, aten.alias.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.empty.memory_format,
         aten.empty_strided.default, aten.empty_like.default,
         aten.new_empty.default, aten.new_empty_strided.default,
         aten._local_scalar_dense.default, aten.sym_size.int,
         aten.sym_stride.int, aten.sym_numel.default,
         aten.sym_storage_offset.default, aten.is_nonzero.default,
         aten.equal.default, aten.resize_.default}
#: gather-type reads: twice the output
_GATHER = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
           aten.embedding.default, aten.take_along_dim.default}
#: scatter-type writes: twice the update (its argument position)
_SCATTER = {aten.index_put.default: 2, aten.index_put_.default: 2,
            aten._index_put_impl_.default: 2,
            aten.scatter.src: 3, aten.scatter_.src: 3,
            aten.scatter.value: 2, aten.scatter_.value: 2,
            aten.scatter_add.default: 3, aten.scatter_add_.default: 3,
            aten.scatter_reduce.two: 3, aten.scatter_reduce_.two: 3,
            aten.index_add.default: 3, aten.index_add_.default: 3,
            aten.index_copy.default: 3, aten.index_copy_.default: 3,
            aten.slice_scatter.default: 1, aten.select_scatter.default: 1,
            aten.diagonal_scatter.default: 1,
            aten.slice_backward.default: 0, aten.select_backward.default: 0,
            aten.embedding_dense_backward.default: 0}
#: in-place writes that do not read ``self``
_WRITE = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
          aten.zero_.default}
#: copies that bring a host tensor to the device: free, as the
#: reference's HLO constants are
_UPLOAD = {aten._to_copy.default, aten.copy_.default}
#: the sums that add a shard's part to a cross-shard sum
_ACCUMULATE = {aten.add.Tensor, aten.add_.Tensor}
#: the joins of a one-controller mesh form
_JOIN = {aten.cat.default, aten.stack.default}
#: overloads whose FLOP formula takes only their leading arguments (the
#: ``out_dtype`` after a bf16 product's operands)
_FLOP_ARGS = {aten.bmm.dtype: 2}

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_of(ins: list) -> str:
    """The type an op's FLOPs run in, e.g. ``"bfloat16"``: its widest
    floating operand's (a product of mixed types runs in the wider; the
    index and seed tensors of an attention op are no operands of its
    products), its widest operand's where none is floating."""
    fl = [t for t in ins if t.is_floating_point()] or ins
    t = max(fl, key=lambda t: t.element_size())
    return str(t.dtype).removeprefix("torch.")


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results, appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            if isinstance(y, torch.Tensor):
                out.append(y)
            elif isinstance(y, (list, tuple, dict)):
                _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _arg_tensors(x, out: list) -> list:
    """Every tensor of a step's arguments: ``_tensors`` that also walks
    dataclasses (``IPGCGraph``) and the pieces of placed expert weights."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _arg_tensors(getattr(x, f.name), out)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _arg_tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _arg_tensors(y, out)
    elif isinstance(x, torch.Tensor):
        out.append(x)
    return out


class _Deferred:
    """The cost of ops that ran with no coordinates, waiting for the
    shard whose ops consume their result (``_NONE``: none yet)."""

    __slots__ = ("flops", "bytes", "tag", "into")

    def __init__(self):
        self.flops: dict = {}         # {operand dtype name: FLOPs}
        self.bytes = 0.0
        self.tag = _NONE
        self.into = None

    def root(self) -> "_Deferred":
        d = self
        while d.into is not None:
            d = d.into
        return d


_NONE = object()
_EVERY = ((), (), ())                  # no coordinates, spread or sum


class OpCost(TorchDispatchMode):
    """Counts a step's ops per mesh entry (one entry without a mesh).

    ``with OpCost(mesh, arg_bytes=...) as c: step(*args)``, then
    ``c.result()``. ``arg_bytes`` is the bytes each device holds of the
    arguments, where peak live bytes start; ``args`` (the step's
    arguments) are registered so that their storages are not counted
    again. ``watch`` names parameter leaves for ``add_grad_sync``."""

    def __init__(self, mesh=None, *, args=(), arg_bytes: int = 0,
                 on_cpu: bool = False):
        super().__init__()
        self.mesh = mesh
        self.on_cpu = on_cpu
        if mesh is None:
            self.axis_names, shape = (), ()
        else:
            self.axis_names = tuple(mesh.axis_names)
            shape = tuple(mesh.shape[a] for a in self.axis_names)
        self.shape = shape
        self.n = math.prod(shape)
        self._grid = np.indices(shape).reshape(len(shape), -1) if shape \
            else np.zeros((0, 1), dtype=int)
        self.flops = np.zeros(self.n)
        self.flops_dt: dict = {}    # dtype name -> FLOPs per entry
        self.bytes = np.zeros(self.n)
        self.live = np.full(self.n, float(arg_bytes))
        self.peak = self.live.copy()
        self.arg_bytes = int(arg_bytes)
        self.coll = {k: {"bytes": np.zeros(self.n), "count": np.zeros(self.n),
                         "axes": set(), "by_axes": {}} for k in COLLECTIVES}
        self.kernels: dict = {}
        self.n_ops = 0
        self.context: tuple = ()    # the shard context: ((axis, index),)
        self._opaque = 0
        self._weights: dict = {}
        self._store: dict = {}      # id(storage) -> [nbytes, tag, deferred]
        self._refs: dict = {}
        self._deferred: list = []
        self._leaves: dict = {}     # id(storage) -> leaf name
        self.leaf_tags: dict = {}
        self._own_sync: set = set()  # leaves whose reads record their sums
        self._fast: dict = {}
        for t in _arg_tensors(args, []):
            self._adopt(t)

    # -- tags ---------------------------------------------------------------

    def _coords_tag(self, coords: dict) -> tuple:
        out = []
        for a, v in coords.items():
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} is not in the mesh's "
                                 f"{self.axis_names}")
            out.append((self.axis_names.index(a), int(v)))
        return tuple(sorted(out))

    @contextlib.contextmanager
    def shard(self, coords: dict):
        if self.mesh is None:
            yield
            return
        prev = self.context
        merged = dict(prev)
        merged.update(self._coords_tag(coords))
        self.context = tuple(sorted(merged.items()))
        try:
            yield
        finally:
            self.context = prev

    @contextlib.contextmanager
    def restore(self, ctx: tuple):
        """The shard context ``ctx`` (a saved ``_ctx``) for a block."""
        prev, self.context = self.context, ctx
        try:
            yield
        finally:
            self.context = prev

    def _weight(self, tag) -> np.ndarray:
        """Each entry's share of a cost made under ``tag``: 1 on the
        entries at its coordinates, over the spread axes' size."""
        w = self._weights.get(tag[:2])
        if w is None:
            coords, spread = tag[0], tag[1]
            w = np.ones(self.n)
            for ax, v in coords:
                w = w * (self._grid[ax] == v)
            for ax in spread:
                w = w / self.shape[ax]
            self._weights[tag[:2]] = w
        return w

    def _tag_of(self, func, keys: list) -> "tuple[tuple, bool]":
        """(tag, free): the op's tag (coordinates, spread axes, summed
        axes) from the context and its operands' storages, and whether it
        is a cross-shard sum or join (free). A summed axis is one a tensor
        is a cross-shard sum over: adding a shard's part to it is that sum
        too; any other op reads it as the replicated value it is."""
        ctx = dict(self.context)
        merged = dict(ctx)
        conflict = set()
        spread = set()
        summed = set()
        for k in keys:
            st = self._store.get(k)
            if st is None:
                continue
            coords, sp, sm = st[1]
            spread.update(sp)
            summed.update(sm)
            for ax, v in coords:
                if ax in ctx:
                    continue
                have = merged.get(ax)
                if have is None:
                    if ax not in conflict:
                        merged[ax] = v
                elif have != v:
                    conflict.add(ax)
        if func in _ACCUMULATE:
            conflict.update(ax for ax in summed
                            if ax in merged and ax not in ctx)
        for ax in conflict:
            merged.pop(ax, None)
        coords = tuple(sorted(merged.items()))
        if conflict:
            if func in _JOIN:
                sp = tuple(sorted(conflict | {a for a in spread
                                              if a not in merged}))
                return (coords, sp, ()), True
            return (coords, (), tuple(sorted(conflict | summed))), True
        sp = () if coords else tuple(sorted(spread))
        return (coords, sp, ()), False

    # -- storages -----------------------------------------------------------

    def _adopt(self, t: torch.Tensor) -> None:
        """An argument's storage: known, held outside the count."""
        s = t.untyped_storage()
        if id(s) not in self._store:
            self._store[id(s)] = [0.0, _EVERY, None]
            self._watch_free(s)

    def _watch_free(self, s) -> None:
        key = id(s)

        def freed(_ref, key=key, self_ref=weakref.ref(self)):
            me = self_ref()
            if me is None:
                return
            st = me._store.pop(key, None)
            me._refs.pop(key, None)
            me._leaves.pop(key, None)
            if st is not None and st[0]:
                me.live -= st[0] * me._weight(st[1])
        self._refs[key] = weakref.ref(s, freed)

    def _new_storage(self, t: torch.Tensor, tag, deferred) -> None:
        """An op's output: a storage not seen before adds its bytes to the
        live bytes of the entries its tag names (a view or an in-place
        result keeps its storage's tag)."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._store:
            return
        nbytes = float(s.nbytes()) if t.device.type != "cpu" or \
            self.on_cpu else 0.0
        self._store[key] = [nbytes, tag, deferred]
        self._watch_free(s)
        if nbytes:
            self.live += nbytes * self._weight(tag)
            np.maximum(self.peak, self.live, out=self.peak)

    def watch(self, params: dict, prefix: str = "") -> None:
        """Name the float leaves of ``params`` for ``add_grad_sync``: the
        shards that read each are recorded."""
        for k, v in params.items():
            if isinstance(v, dict):
                self.watch(v, f"{prefix}{k}.")
            elif isinstance(v, torch.Tensor) and v.is_floating_point():
                self._leaves[id(v.untyped_storage())] = f"{prefix}{k}"

    # -- counting -----------------------------------------------------------

    def _charge(self, tag, flops: dict, nbytes: float) -> None:
        """``flops``: {operand dtype name: FLOPs}."""
        w = self._weight(tag)
        for dt, f in flops.items():
            self.flops += f * w
            arr = self.flops_dt.get(dt)
            if arr is None:
                arr = self.flops_dt[dt] = np.zeros(self.n)
            arr += f * w
        if nbytes:
            self.bytes += nbytes * w

    def _resolve(self, d: _Deferred, tag) -> None:
        tag = (tag[0], tag[1], ())
        r = d.root()
        if r.tag is _NONE:
            r.tag = tag
        elif r.tag != tag:
            r.tag = _EVERY

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        ins = _tensors(args, [])
        if kwargs:           # an ``out=`` tensor is written, not read
            _tensors({k: v for k, v in kwargs.items() if k != "out"}, ins)
        outs = _tensors(out, [])
        if self._opaque:
            for t in outs:
                self._new_storage(t, (self.context, (), ()), None)
            return out
        self.n_ops += 1
        if not self.on_cpu and outs and \
                all(t.device.type == "cpu" for t in outs):
            return out                         # host work
        keys = [id(t.untyped_storage()) for t in ins]
        tag, free = self._tag_of(func, keys)
        if self._leaves and tag[0]:
            for k in keys:
                name = self._leaves.get(k)
                if name is not None:
                    self.leaf_tags.setdefault(name, set()).add(tag[0])
        flops, nbytes = {}, 0.0
        if not free:
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                f = float(fn(*args[:_FLOP_ARGS.get(func, len(args))],
                             **kwargs, out_val=out))
                if f:
                    flops[_dtype_of(ins)] = f
            nbytes = self._op_bytes(func, args, ins, keys, outs)
        deferred = None
        if not tag[0] and not tag[1] and self.n > 1 and not free:
            deferred = _Deferred()
            deferred.flops, deferred.bytes = flops, nbytes
            self._deferred.append(deferred)
        for k in keys:
            st = self._store.get(k)
            if st is None or st[2] is None:
                continue
            d = st[2].root()
            if deferred is not None:
                if d is not deferred:         # the chain's cost moves on
                    for dt, f in d.flops.items():
                        deferred.flops[dt] = deferred.flops.get(dt, 0.0) + f
                    deferred.bytes += d.bytes
                    d.flops, d.bytes = {}, 0.0
                    if d.tag is not _NONE:
                        self._resolve(deferred, d.tag)
                    d.into = deferred
            elif not free:
                self._resolve(d, tag)
        if deferred is None and not free:
            self._charge(tag, flops, nbytes)
        for t in outs:
            self._new_storage(t, tag, deferred)
        return out

    def _op_bytes(self, func, args, ins, keys, outs) -> float:
        if func in _FREE or func.is_view:
            return 0.0
        if outs and not func._schema.is_mutable and all(
                id(t.untyped_storage()) in keys for t in outs):
            return 0.0                          # a view in effect
        if func in _GATHER:
            return 2.0 * sum(_nbytes(t) for t in outs)
        pos = _SCATTER.get(func)
        if pos is not None:
            upd = args[pos] if pos < len(args) else None
            if isinstance(upd, torch.Tensor):
                return 2.0 * _nbytes(upd)
            return 2.0 * sum(_nbytes(t) for t in ins[1:2])
        if not self.on_cpu and func in _UPLOAD and any(
                t.device.type == "cpu" for t in ins):
            return 0.0                          # a host constant placed
        if func in _WRITE:
            ins = ins[1:]                       # self is written, not read
        return float(sum(_nbytes(t) for t in ins
                         if self.on_cpu or t.device.type != "cpu")
                     + sum(_nbytes(t) for t in outs))

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; a pointwise op on contiguous meta
        tensors makes its output from the shape and dtype a first call
        with the same dtypes gave (the meta kernels of pointwise ops run
        Python type promotion, ~0.1-0.5 ms an op)."""
        if kwargs or torch.Tag.pointwise not in func.tags \
                or func._schema.is_mutable:
            return func(*args, **kwargs)
        key = [func]
        shapes = []
        meta = False
        for a in args:
            if isinstance(a, torch.Tensor):
                if not a.is_contiguous():
                    return func(*args, **kwargs)
                meta = meta or a.device.type == "meta"
                key.append((a.dtype, a.dim() == 0, a.device.type))
                shapes.append(a.shape)
            elif isinstance(a, (bool, int, float)):
                key.append(type(a))
            else:
                return func(*args, **kwargs)
        if not meta:
            return func(*args, **kwargs)
        key = tuple(key)
        dtype = self._fast.get(key)
        if dtype is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor) and out.is_contiguous():
                self._fast[key] = out.dtype
            else:
                self._fast[key] = False
            return out
        if dtype is False:
            return func(*args, **kwargs)
        return torch.empty(_broadcast(shapes), dtype=dtype, device="meta")

    def kernel(self, name: str, fn, args, kw, flops: dict):
        """``kernel_call``'s count: one op of the call's operands' and
        outputs' bytes and of ``flops`` ({operand type name: FLOPs}),
        tagged like an op, the ops inside not counted."""
        ins = _tensors(list(args), [])
        tag, _ = self._tag_of(None, [id(t.untyped_storage()) for t in ins])
        self._opaque += 1
        try:
            out = fn(*args, **kw)
        finally:
            self._opaque -= 1
        outs = _tensors(out, [])
        nbytes = float(sum(_nbytes(t) for t in ins)
                       + sum(_nbytes(t) for t in outs))
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        self.n_ops += 1
        self._charge(tag, flops, nbytes)
        return out

    # -- collectives --------------------------------------------------------

    def record(self, kind: str, nbytes: int, axes) -> None:
        self.record_at(kind, nbytes, tuple(axes), self.context)

    def record_at(self, kind: str, nbytes: int, axes: tuple,
                  ctx: tuple) -> None:
        """A collective made in the shard context ``ctx``."""
        if kind not in self.coll:
            raise ValueError(f"unknown collective {kind!r}")
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} is not in the mesh's "
                                 f"{self.axis_names}")
        w = self._weight((ctx, (), ()))
        c = self.coll[kind]
        c["bytes"] += float(nbytes) * w
        c["count"] += w
        c["axes"].update(axes)
        key = ",".join(axes)
        if key not in c["by_axes"]:
            c["by_axes"][key] = np.zeros(self.n)
        c["by_axes"][key] += float(nbytes) * w

    def grad_recorded(self, t: torch.Tensor) -> None:
        """``t`` was read with its gradient pass's collective recorded
        (``hooks.collective``'s ``back``): a watched leaf read so gets no
        ``add_grad_sync``."""
        name = self._leaves.get(id(t.untyped_storage()))
        if name is not None:
            self._own_sync.add(name)

    def add_grad_sync(self, params: dict, *, split: "dict | None" = None
                      ) -> None:
        """The gradient sums a multi-process run makes and one controller
        does inside autograd: for each leaf of ``params`` that shards at
        different coordinates read (``watch``), an all-reduce of its
        gradient over the axes where they differ, less the axes
        ``split[name]`` lays the leaf out over (the expert weights: their
        FSDP part is the reduce-scatter ``collective`` records in the
        gradient pass). A leaf whose reads record their own
        (``grad_recorded``) is left out. Counted on every entry."""
        split = split or {}
        for name, t in _named_leaves(params):
            tags = self.leaf_tags.get(name)
            if not tags or len(tags) < 2 or name in self._own_sync:
                continue
            differ = set()
            first = dict(next(iter(tags)))
            for tg in tags:
                tg = dict(tg)
                for ax in set(first) | set(tg):
                    if first.get(ax) != tg.get(ax):
                        differ.add(ax)
            over = split.get(name.rsplit(".", 1)[-1], ())
            parts = [self.axis_names.index(a) for a in over]
            axes = sorted(differ - set(parts))
            if not axes:
                continue
            nbytes = _nbytes(t) / math.prod(self.shape[a] for a in parts)
            self.record_at("all-reduce", nbytes,
                           tuple(self.axis_names[a] for a in axes), ())

    # -- results ------------------------------------------------------------

    def __enter__(self):
        hooks.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            hooks.pop(self)

    def settle(self) -> None:
        """Charge the deferred costs: to the shard that consumed them, or
        to every entry."""
        for d in self._deferred:
            if d.into is None and (d.flops or d.bytes):
                self._charge(_EVERY if d.tag is _NONE else d.tag, d.flops,
                             d.bytes)
                d.flops, d.bytes = {}, 0.0
        self._deferred = []

    def result(self) -> dict:
        """The per-device counts: each the largest entry's. A collective
        kind's ``by_axes`` splits its bytes by the axes each collective
        ran over (``"data,model"``), at the entry that moves the most."""
        self.settle()
        coll = {}
        for k, v in self.coll.items():
            top = int(v["bytes"].argmax())
            coll[k] = {"bytes": float(v["bytes"].max()),
                       "count": float(v["count"].max()),
                       "axes": sorted(v["axes"]),
                       "by_axes": {a: float(b[top]) for a, b in
                                   sorted(v["by_axes"].items())}}
        total = sum(self.coll[k]["bytes"] for k in COLLECTIVES)
        top = int(self.flops.argmax())
        return {"flops": float(self.flops.max()),
                "flops_by_dtype": {dt: float(v[top])
                                   for dt, v in sorted(self.flops_dt.items())},
                "bytes": float(self.bytes.max()),
                "peak_bytes": float(self.peak.max()),
                "arg_bytes": self.arg_bytes,
                "collectives": {**coll, "total_bytes": float(total.max())},
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "n_ops": self.n_ops}


def _broadcast(shapes: list) -> tuple:
    """The broadcast of ``shapes`` (already known to broadcast)."""
    n = max(len(s) for s in shapes)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            if d != 1:
                out[i] = d
    return tuple(out)


def _named_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            yield f"{prefix}{k}", v


def count(fn, args: tuple, *, mesh=None, arg_bytes: "int | None" = None,
          params: "dict | None" = None, split: "dict | None" = None,
          on_cpu: bool = False) -> tuple:
    """Run ``fn(*args)`` under an ``OpCost``; returns (its output, the
    counts). ``arg_bytes`` defaults to the arguments' bytes; ``params``
    (with ``split``) adds the gradient sums (``add_grad_sync``);
    ``on_cpu``: the step runs on the CPU, whose ops are then counted as
    device ops."""
    if arg_bytes is None:
        arg_bytes = sum(_nbytes(t) for t in _arg_tensors(args, []))
    c = OpCost(mesh, args=args, arg_bytes=arg_bytes, on_cpu=on_cpu)
    if params is not None:
        c.watch(params)
    with c:
        out = fn(*args)
    if params is not None:
        c.add_grad_sync(params, split=split)
    return out, c.result()


def extrapolate(a: dict, b: dict, d_a: int, d_b: int, depth: int) -> dict:
    """The counts at ``depth`` layers from counts ``a`` at ``d_a`` and
    ``b`` at ``d_b`` repeated layers (``d_b - d_a`` a whole number of the
    layers' period): every number extended linearly, the reference's
    loop correction."""
    def ext(x, y):
        if isinstance(x, dict):         # a type counted at one depth only
            return {k: ext(x.get(k, 0.0), y.get(k, 0.0))
                    for k in {**x, **y}}
        if isinstance(x, (list, str)) or x is None:
            return x
        return x + (y - x) * (depth - d_a) / (d_b - d_a)
    return ext(a, b)
