"""Device meshes (``repro/launch/mesh.py``).

A ``DeviceMesh`` is a grid of ``torch.device`` entries with named axes, the
port's counterpart of a ``jax.sharding.Mesh``. The models' mesh forms
(``models/moe.py::moe_ffn``, ``models/transformer.py``,
``models/gnn/equiformer_v2.py``) run each shard on its entry's device
from one controller, as the distributed Pipe runs its shards over a
device list (``core/distributed.py``). An entry may repeat a device: the
default mesh puts every entry on the current CUDA device, so that one
card runs a mesh of any shape. The collectives become plain transfers
and sums on the controller; a multi-process backend is not part of this
module.

``place_params`` splits the MoE expert weights over the mesh once: the
experts over the model axis, their ``ff`` dimension over the FSDP axes,
each piece on its shard's device. A piece on the parameters' own device
is a view, never a copy.

The reference's TPU pod meshes (``make_production_mesh``) and its v5e
constants are not ported: the port runs on an H100.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


class DeviceMesh:
    """A grid of devices with named axes. ``shape[axis]`` is an axis'
    size, ``device(**coords)`` the device at those coordinates (an axis
    left out is at 0)."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid cannot carry the "
                             f"axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))

    def axis_size(self, axes) -> int:
        """The number of shards over ``axes`` (1 for none)."""
        return math.prod(self.shape[a] for a in axes)

    def coords(self, axes) -> list:
        """Every coordinate over ``axes`` as a dict, in the order a
        sharding over ``axes`` lays out its blocks (the first axis major)."""
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in the mesh's "
                                 f"{self.axis_names}")
        return [dict(zip(axes, c))
                for c in itertools.product(*(range(self.shape[a])
                                             for a in axes))]

    def device(self, **coords) -> torch.device:
        for a in coords:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in the mesh's "
                                 f"{self.axis_names}")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def distinct_devices(self) -> list:
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"DeviceMesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.distinct_devices()]})")


def make_mesh(shape, axis_names, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axis_names``. ``devices`` None puts every
    entry on the current CUDA device (it raises without one); one device
    (``"cpu"``, ``"cuda:0"``) puts every entry there; a sequence gives
    one device an entry, in row-major order."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        flat = [resolve_device(devices)] * n
    else:
        flat = [resolve_device(d) for d in devices]
        if len(flat) != n:
            raise ValueError(f"a {shape} mesh needs {n} devices, got "
                             f"{len(flat)}")
    grid = np.empty(n, dtype=object)
    grid[:] = flat
    return DeviceMesh(grid.reshape(shape), axis_names)


def make_local_mesh(devices=None) -> DeviceMesh:
    """A one-entry mesh with the production axis names ``("data",
    "model")``."""
    return make_mesh((1, 1), ("data", "model"), devices)


def data_shards(mesh, batch_axes: tuple) -> list:
    """The data shards of ``batch_axes`` in batch order: each one's
    coordinates and home device (its entry with every other axis at 0)."""
    return [(c, mesh.device(**c)) for c in mesh.coords(batch_axes)]


def split_batch(x: torch.Tensor, n: int) -> list:
    """``x``'s rows in ``n`` equal blocks (views), as a sharding of the
    batch axis over ``n`` shards lays them out."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{n} data shards")
    return list(x.split(x.shape[0] // n))


#: the expert weights' ``ff`` axis, counted from the end: ``we_in`` and
#: ``we_gate`` are (..., E, d, f), ``we_out`` (..., E, f, d)
EXPERT_FF_AXIS = {"we_in": -1, "we_gate": -1, "we_out": -2}


@dataclasses.dataclass(frozen=True)
class ExpertShards:
    """An expert weight split over a mesh: ``pieces[m][j]`` holds model
    shard ``m``'s experts, slice ``j`` of their ``ff`` dimension over the
    FSDP axes, on the device of the entry at those coordinates (the other
    axes at 0). Indexing the leading (layer) axis indexes every piece."""

    pieces: tuple
    ff_axis: int

    def __getitem__(self, i) -> "ExpertShards":
        return ExpertShards(tuple(tuple(p[i] for p in row)
                                  for row in self.pieces), self.ff_axis)

    def unbind(self, dim: int = 0) -> tuple:
        if dim != 0:
            raise ValueError("ExpertShards unbinds its leading axis only")
        return tuple(self[i] for i in range(self.pieces[0][0].shape[0]))


def expert_pieces(w, m: int, n_model: int, n_fsdp: int,
                  ff_axis: int) -> list:
    """Model shard ``m``'s FSDP slices of an expert weight: the placed
    pieces of an ``ExpertShards``, or views of a full (..., E, ., .)
    tensor."""
    if isinstance(w, ExpertShards):
        return list(w.pieces[m])
    e = w.shape[-3]
    if e % n_model:
        raise ValueError(f"{e} experts do not split over {n_model} model "
                         "shards")
    f = w.shape[ff_axis]
    if f % n_fsdp:
        raise ValueError(f"an expert ff of {f} does not split over "
                         f"{n_fsdp} FSDP shards")
    e_local, f_local = e // n_model, f // n_fsdp
    mine = w.narrow(w.ndim - 3, m * e_local, e_local)
    return [mine.narrow(w.ndim + ff_axis, j * f_local, f_local)
            for j in range(n_fsdp)]


def gather_experts(w, m: int, mesh: DeviceMesh, *, model_axis: str,
                   fsdp_axes: tuple, ff_axis: int,
                   device: torch.device) -> torch.Tensor:
    """The FSDP all-gather of model shard ``m``'s experts onto ``device``:
    its ``ff`` slices moved there and joined in FSDP order. With one FSDP
    shard nothing is joined, so a slice already on ``device`` comes back
    as the same view."""
    pieces = expert_pieces(w, m, mesh.shape[model_axis],
                           mesh.axis_size(fsdp_axes), ff_axis)
    if len(pieces) == 1:
        return pieces[0].to(device)
    return torch.cat([p.to(device) for p in pieces], dim=ff_axis)


def place_params(params: dict, mesh: DeviceMesh, *, model_axis: str = "model",
                 fsdp_axes: tuple = ()) -> dict:
    """The parameter tree with every expert weight (``we_in``, ``we_gate``,
    ``we_out``) split over ``mesh`` as an ``ExpertShards``: the experts over
    ``model_axis``, the ``ff`` dimension over ``fsdp_axes``, each piece on
    the device of its shard (the other axes at 0). A piece whose device is
    the weight's own is a view of it. Every other leaf is kept as it is:
    the mesh forms move it to a shard's device when they use it there.
    For serving (the pieces are made once); training passes the full
    tensors, which the mesh forms slice at each call."""
    if model_axis in fsdp_axes:
        raise ValueError(f"the model axis {model_axis!r} cannot be an FSDP "
                         "axis")
    n_model, n_fsdp = mesh.shape[model_axis], mesh.axis_size(fsdp_axes)
    fsdp = mesh.coords(fsdp_axes)

    def place(name, w):
        ff = EXPERT_FF_AXIS[name]
        return ExpertShards(tuple(
            tuple(p.to(mesh.device(**fsdp[j], **{model_axis: m}))
                  for j, p in enumerate(expert_pieces(w, m, n_model,
                                                      n_fsdp, ff)))
            for m in range(n_model)), ff)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else place(k, v) if k in EXPERT_FF_AXIS
                and torch.is_tensor(v) else v
                for k, v in tree.items()}

    return walk(params)
