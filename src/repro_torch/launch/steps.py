"""Per-(arch x shape) step builders (``repro/launch/steps.py``).

``build_case(arch_id, shape_name, mesh=None)`` returns a ``Case`` bundling

  * ``fn``    — the step function, which runs on the arguments' device,
  * ``args``  — its arguments: tensors on the ``meta`` device with the
                reference's shapes and dtypes (``abstract=True``: nothing
                allocated, the counterpart of its ``ShapeDtypeStruct``
                tree), or values drawn on ``device`` from ``seed``,
  * ``meta``  — the model FLOPs and bookkeeping of the cell,
  * ``mesh``, ``axes`` — what the step shards with, in place of the
                reference's ``in_shardings``.

Without a mesh a case runs unsharded on one device. With a
``launch.mesh.DeviceMesh`` (axes ``("data", "model")``) the LM steps
split their batch and gather their experts' ``ff`` over ``("data",)``,
as the reference's rules put ``_batch`` and ``embed`` there, and
EquiformerV2 splits its edge chunks over it; serving steps take their
experts placed by ``launch.mesh.place_params``. The reference's other
shardings are layouts only and change no value.

The LM, GNN and DLRM steps update their parameters, optimizer state and
KV cache in place (``donate`` names the arguments the reference aliases
into its outputs). ``ipgc_case`` runs ``core.ipgc.dense_step``, and with
it the ``mex_window``, ``conflict`` and ``compact`` kernels on the card.
On a mesh with a ``pod`` axis (``launch.mesh.make_production_mesh(
multi_pod=True)``) the batch and FSDP axes are ``("pod", "data")``, the
reference's ``multi_pod`` rules.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, ArchSpec, ShapeSpec, get_arch
from repro_torch.core import ipgc as ipgc_mod
from repro_torch.core.worklist import Worklist, full_worklist
from repro_torch.data.pipelines import prng_key
from repro_torch.device import resolve_device
from repro_torch.graphs.sampler import blocks_to_graphbatch, sample_blocks
from repro_torch.launch.mesh import place_params
from repro_torch.launch.train import value_and_grad as lm_value_and_grad
from repro_torch.models import common as mcommon
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.gnn import egnn as egnn_mod
from repro_torch.models.gnn import equiformer_v2 as eqv2_mod
from repro_torch.models.gnn import graphsage as sage_mod
from repro_torch.models.gnn import schnet as schnet_mod
from repro_torch.models.gnn.common import GraphBatch, _graph_id
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten

#: the mesh axis the batch, the FSDP gather and EquiformerV2's edge
#: chunks are split over when a case is given a mesh
DATA_AXES = ("data",)
#: the LM decode variants besides "base" (the reference's dry run's)
DECODE_VARIANTS = ("opt", "opt_int8", "opt_int8_half")


@dataclasses.dataclass
class Case:
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    meta: dict
    donate: tuple = ()      # args the reference aliases into its outputs
    mesh: object = None     # launch.mesh.DeviceMesh, None: one device
    #: the axes the step passes: batch_axes, fsdp_axes, edge_shard_axes
    axes: dict = dataclasses.field(default_factory=dict)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flatten_args(tree, path: tuple = ()) -> list:
    """[(path, leaf)] of a case's arguments, in ``jax.tree_util`` order
    (``tree.flatten_with_path``), dataclasses (``IPGCGraph``) walked
    field by field like NamedTuples; a leaf is a tensor or a NumPy array,
    and a field that is neither (a static size, a layout name) is none."""
    if tree is None or isinstance(tree, (int, float, str)):
        return []
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_args(tree[k], path + (f"[{k!r}]",))]
    if dataclasses.is_dataclass(tree):
        return [pl for f in dataclasses.fields(tree)
                for pl in flatten_args(getattr(tree, f.name),
                                       path + (f".{f.name}",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f in tree._fields
                for pl in flatten_args(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_args(v, path + (f"[{i}]",))]
    raise TypeError(f"no leaves for a {type(tree).__name__} at {path}")


def arg_bytes(case: Case) -> int:
    """The bytes of a case's arguments (each leaf once, on one device)."""
    return sum(x.nbytes if isinstance(x, np.ndarray)
               else x.numel() * x.element_size()
               for _, x in flatten_args(case.args))


class _Draw:
    """Where a case's arguments come from: tensors on the ``meta`` device
    (``abstract``), or values drawn on ``device`` from a generator seeded
    with ``seed``: the parameters first, then the inputs in argument
    order."""

    def __init__(self, abstract: bool, device, seed: int):
        self.abstract = abstract
        self.device = torch.device("meta") if abstract \
            else resolve_device(device)
        self.gen = None if abstract else \
            torch.Generator(device=self.device).manual_seed(seed)

    def _kw(self, dtype) -> dict:
        return dict(dtype=dtype, device=self.device)

    def empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(tuple(shape), **self._kw(dtype))

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        out = self.empty(shape, dtype)
        return out if self.abstract else out.normal_(generator=self.gen)

    def uniform(self, shape, lo: float, hi: float,
                dtype=torch.float32) -> torch.Tensor:
        out = self.empty(shape, dtype)
        return out if self.abstract else out.uniform_(lo, hi,
                                                      generator=self.gen)

    def ints(self, shape, high: int, low: int = 0,
             dtype=torch.int32) -> torch.Tensor:
        """Integers in [low, high)."""
        if self.abstract:
            return self.empty(shape, dtype)
        return torch.randint(low, high, tuple(shape), generator=self.gen,
                             **self._kw(dtype))

    def perm(self, n: int) -> torch.Tensor:
        """A permutation of range(n), int64."""
        return torch.randperm(n, generator=self.gen, device=self.device)

    def params(self, init, cfg) -> dict:
        return init(cfg, self.gen, device=self.device)[0]


def _axes(mesh) -> tuple[tuple, tuple]:
    """(batch axes, FSDP axes): the reference's ``_batch`` and ``embed``
    rules on a mesh, none without one. A mesh with a ``pod`` axis (the
    multi-pod mesh of ``launch.mesh.make_production_mesh``) splits both
    over ``("pod", "data")``, as the reference's multi-pod rules do."""
    if mesh is None:
        return (), ()
    axes = ("pod",) + DATA_AXES if "pod" in mesh.shape else DATA_AXES
    return axes, axes


def _arg_device(mesh, device):
    """Real arguments go to ``device``, or to the mesh's first entry."""
    if device is None and mesh is not None:
        return mesh.device()
    return device


def _mesh_kw(mesh, batch_axes: tuple, fsdp_axes: tuple) -> dict:
    return {} if mesh is None else dict(mesh=mesh, batch_axes=batch_axes,
                                        fsdp_axes=fsdp_axes)


def value_and_grad(loss, params: dict) -> tuple[torch.Tensor, dict]:
    """(loss(params), its gradient in ``params``' tree), detached. Marks
    the leaves of ``params`` as requiring grad."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        value = loss(params)
        grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                    materialize_grads=True)
    return value.detach(), tree_unflatten(params, list(grads))


def _update(loss_value, grads, opt, params, opt_cfg, keep_grads: bool):
    p, o, om = adamw_update(grads, opt, params, opt_cfg)
    out = {"loss": loss_value, **om}
    if keep_grads:
        out["grads"] = grads
    return p, o, out


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

# fit profiles, the reference's: gradient-accumulation factor + optimizer
# state dtype per arch (sized there for its accelerator's memory; the
# global batch per optimizer step is unchanged, bf16 m/v is the
# 8-bit-Adam-class tradeoff)
_MICROBATCHES = {"nemotron-4-340b": 8, "minitron-4b": 2}
_OPT_STATE_DTYPE = {"nemotron-4-340b": torch.bfloat16}
_GRAD_ACCUM_DTYPE = {"nemotron-4-340b": torch.bfloat16}


def lm_train_case(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
                  abstract: bool = False, device=None, seed: int = 0) -> Case:
    cfg = arch.make_config()
    batch_axes, fsdp_axes = _axes(mesh)
    kw = _mesh_kw(mesh, batch_axes, fsdp_axes)
    s, b = shape.params["seq_len"], shape.params["global_batch"]
    opt_cfg = AdamWConfig(
        state_dtype=_OPT_STATE_DTYPE.get(arch.arch_id, torch.float32),
        update_in_chunks=False)
    n_micro = _MICROBATCHES.get(arch.arch_id, 1)
    acc_dt = _GRAD_ACCUM_DTYPE.get(arch.arch_id, torch.float32)

    def step(params, opt, batch):
        if n_micro == 1:
            loss, metrics, grads = lm_value_and_grad(params, batch, cfg, **kw)
        else:
            per = batch["tokens"].shape[0] // n_micro
            acc, losses = None, []
            for i in range(n_micro):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                loss_i, _, g = lm_value_and_grad(params, mb, cfg, **kw)
                losses.append(loss_i)
                g = tree_leaves(g)
                if acc is None:     # 0 + g: the reference's first sum
                    acc = [x.to(acc_dt) for x in g]
                else:
                    for a, x in zip(acc, g):
                        a.add_(x.to(acc_dt))
                del g
            grads = tree_unflatten(params, [a / n_micro for a in acc])
            del acc
            loss = torch.stack(losses).mean()
            metrics = {"ce": loss, "aux": torch.zeros(
                (), dtype=torch.float32, device=loss.device)}
        new_p, new_o, om = adamw_update(grads, opt, params, opt_cfg)
        return new_p, new_o, {**metrics, **om, "loss": loss}

    draw = _Draw(abstract, _arg_device(mesh, device), seed)
    params = draw.params(tfm.init_params, cfg)
    opt = adamw_init(params, opt_cfg.state_dtype)
    batch = {"tokens": draw.ints((b, s), cfg.vocab),
             "labels": draw.ints((b, s), cfg.vocab)}
    tokens = b * s
    return Case(arch.arch_id, shape.name, step, (params, opt, batch),
                meta={"model_flops": 6 * cfg.n_active_params * tokens,
                      "tokens": tokens, "kind": "train"},
                donate=(0, 1), mesh=mesh,
                axes=dict(batch_axes=batch_axes, fsdp_axes=fsdp_axes))


def lm_prefill_case(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
                    abstract: bool = False, device=None,
                    seed: int = 0) -> Case:
    cfg = arch.make_config()
    batch_axes, fsdp_axes = _axes(mesh)
    kw = _mesh_kw(mesh, batch_axes, fsdp_axes)
    s, b = shape.params["seq_len"], shape.params["global_batch"]

    @torch.no_grad()
    def step(params, tokens):
        return tfm.prefill(params, tokens, cfg, **kw)

    draw = _Draw(abstract, _arg_device(mesh, device), seed)
    params = _placed(draw, draw.params(tfm.init_params, cfg), mesh,
                     fsdp_axes)
    tokens = draw.ints((b, s), cfg.vocab)
    return Case(arch.arch_id, shape.name, step, (params, tokens),
                meta={"model_flops": 2 * cfg.n_active_params * b * s,
                      "tokens": b * s, "kind": "prefill"},
                mesh=mesh, axes=dict(batch_axes=batch_axes,
                                     fsdp_axes=fsdp_axes))


def _placed(draw: _Draw, params: dict, mesh, fsdp_axes: tuple) -> dict:
    """Serving weights on a mesh: the experts placed once
    (``place_params``); abstract ones stay whole on the meta device."""
    if mesh is None or draw.abstract:
        return params
    return place_params(params, mesh, fsdp_axes=fsdp_axes)


def _kv_cache(draw: _Draw, shape: tuple, dtype, s: int) -> KVCache:
    """A (L, B, S, Hk, D) cache: random entries (int8 with positive fp16
    scales, or ``dtype``) and each row's length below S, so that a decode
    step has room to write."""
    b = shape[1]
    length = draw.ints((b,), s)
    if dtype == torch.int8:
        return KVCache(k=draw.ints(shape, 128, -127, torch.int8),
                       v=draw.ints(shape, 128, -127, torch.int8),
                       length=length,
                       k_scale=draw.uniform(shape[:-1], 1e-3, 2e-2,
                                            torch.float16),
                       v_scale=draw.uniform(shape[:-1], 1e-3, 2e-2,
                                            torch.float16))
    return KVCache(k=draw.normal(shape, dtype), v=draw.normal(shape, dtype),
                   length=length)


def lm_decode_case(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
                   variant: str = "base", abstract: bool = False,
                   device=None, seed: int = 0) -> Case:
    cfg = arch.make_config()
    batch_axes, fsdp_axes = _axes(mesh)
    s, b = shape.params["seq_len"], shape.params["global_batch"]
    kv_dtype = cfg.dtype
    if variant != "base":
        # inference sharding profile: no optimizer state at serve time, so
        # drop FSDP when bf16 params fit one model shard
        n_model = mesh.shape["model"] if mesh is not None else 1
        if cfg.n_params * 2 / n_model < 6e9:
            fsdp_axes = ()
        if "int8" in variant:
            kv_dtype = torch.int8          # halves KV reads
        if "half" in variant:
            s = s // 2                     # KV length bucketing
    n_batch_shards = mesh.axis_size(batch_axes) if mesh is not None else 1
    if b < n_batch_shards:
        batch_axes = ()                    # B=1 long-context: no DP
    kw = _mesh_kw(mesh, batch_axes, fsdp_axes)

    @torch.no_grad()
    def step(params, cache, tokens):
        return tfm.decode_step(params, tokens, cache, cfg, **kw)

    draw = _Draw(abstract, _arg_device(mesh, device), seed)
    params = _placed(draw, draw.params(tfm.init_params, cfg), mesh,
                     fsdp_axes)
    kv_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    if mesh is None:
        cache = _kv_cache(draw, kv_shape, kv_dtype, s)
    else:                   # each data shard's rows on its home device
        shards = mesh.coords(batch_axes)
        rows = (cfg.n_layers, b // len(shards)) + kv_shape[2:]
        cache = tfm.MeshKVCache(tuple(
            KVCache(*[t if t is None or draw.abstract
                      else t.to(mesh.device(**c))
                      for t in _kv_cache(draw, rows, kv_dtype, s)])
            for c in shards))
    tokens = draw.ints((b, 1), cfg.vocab)
    kv_elem_bytes = 1 if kv_dtype == torch.int8 else 2
    kv_bytes = 2 * cfg.n_layers * b * s * cfg.n_kv_heads * cfg.head_dim \
        * kv_elem_bytes
    return Case(arch.arch_id, shape.name, step, (params, cache, tokens),
                meta={"model_flops": 2 * cfg.n_active_params * b
                      + 2 * b * cfg.n_heads * cfg.head_dim * s * 2,
                      "tokens": b, "kind": "decode", "kv_bytes": kv_bytes,
                      "variant": variant},
                donate=(1,), mesh=mesh,
                axes=dict(batch_axes=batch_axes, fsdp_axes=fsdp_axes))


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

GNN_MODS = {
    "equiformer-v2": eqv2_mod,
    "egnn": egnn_mod,
    "schnet": schnet_mod,
    "graphsage-reddit": sage_mod,
}


#: the largest edge chunk a GNN step takes
EDGE_CHUNK_MAX = 262144


def _gnn_cfg(arch: ArchSpec, shape: ShapeSpec, mesh):
    cfg = arch.make_config()
    if arch.arch_id == "equiformer-v2":
        chunk = min(cfg.edge_chunk, EDGE_CHUNK_MAX)
        cfg = dataclasses.replace(cfg, edge_shard_axes=_axes(mesh)[0],
                                  edge_chunk=chunk)
    if arch.arch_id == "graphsage-reddit" and "d_feat" in shape.params:
        cfg = dataclasses.replace(cfg, d_in=shape.params["d_feat"])
    if arch.arch_id == "egnn" and "d_feat" in shape.params:
        cfg = dataclasses.replace(cfg, d_in=shape.params["d_feat"])
    return cfg


def _gnn_flops(arch_id: str, cfg, n: int, e: int) -> int:
    """Analytic MODEL_FLOPS (fwd+bwd ~ 3x fwd for train)."""
    if arch_id == "graphsage-reddit":
        per = 2 * cfg.d_in * cfg.d_hidden + 2 * cfg.d_hidden * cfg.n_classes
        return 3 * (n * per + e * cfg.d_in * 2)
    if arch_id == "schnet":
        d, r = cfg.d_hidden, cfg.n_rbf
        per_e = 2 * r * d + 2 * d * d + d
        per_n = 4 * 2 * d * d
        return 3 * cfg.n_interactions * (e * per_e + n * per_n)
    if arch_id == "egnn":
        d = cfg.d_hidden
        per_e = 2 * (2 * d + 1) * d + 2 * d * d + 2 * d * d + 2 * d
        per_n = 2 * 2 * d * d
        return 3 * cfg.n_layers * (e * per_e + n * per_n)
    if arch_id == "equiformer-v2":
        c, L, s = cfg.channels, cfg.l_max, (cfg.l_max + 1) ** 2
        wig = sum((2 * l + 1) ** 2 for l in range(L + 1))
        rot = 2 * 2 * wig * c              # rotate in + out
        so2 = 2 * ((L + 1) * c) ** 2 + 2 * sum(
            2 * ((L + 1 - m) * c) ** 2 for m in range(1, cfg.m_max + 1))
        per_n = 2 * s * c * c * 3
        return 3 * cfg.n_layers * (e * (rot + so2) + n * per_n)
    raise ValueError(arch_id)


def gnn_loss(arch_id: str, cfg, mesh=None):
    """``_gnn_loss``: GraphSAGE's cross-entropy over the nodes, the MSE of
    the per-graph outputs against ``targets`` otherwise. ``mesh`` goes to
    the forward of a config with edge shards (``cfg.edge_shard_axes``);
    any other GNN runs unsharded on a mesh."""
    mod = GNN_MODS[arch_id]
    kw = {"mesh": mesh} if mesh is not None and \
        getattr(cfg, "edge_shard_axes", ()) else {}

    def loss(params, batch, targets):
        if arch_id == "graphsage-reddit":
            logits = mod.forward_full(params, batch, cfg)
            return mcommon.cross_entropy(logits, batch.node_label)
        pred = mod.forward(params, batch, cfg, **kw)
        if arch_id == "egnn":
            pred = pred[0]
        return torch.mean((pred - targets) ** 2)
    return loss


def full_step(arch_id: str, cfg, opt_cfg, keep_grads: bool = False,
              mesh=None, loss=None):
    """The full-graph training step on a ``GraphBatch``: ``step(params,
    opt, batch, targets) -> (params, opt, metrics)``; ``keep_grads`` adds
    the gradients to the metrics; ``mesh`` goes to ``gnn_loss``, or
    ``loss(params, batch, targets)`` replaces it."""
    loss = loss or gnn_loss(arch_id, cfg, mesh)

    def step(params, opt, batch, targets):
        value, grads = value_and_grad(
            lambda p: loss(p, batch, targets), params)
        return _update(value, grads, opt, params, opt_cfg, keep_grads)
    return step


def gnn_full_case(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
                  molecule: bool = False, variant: str = "base",
                  abstract: bool = False, device=None, seed: int = 0,
                  keep_grads: bool = False) -> Case:
    """``keep_grads`` adds the gradients to the step's metrics."""
    mod = GNN_MODS[arch.arch_id]
    cfg = _gnn_cfg(arch, shape, mesh)
    batch_axes = _axes(mesh)[0]
    n_shards = mesh.axis_size(batch_axes) if mesh is not None else 1
    gran = max(1024, n_shards)
    if molecule:
        bsz = shape.params["batch"]
        n_real = shape.params["n_nodes"] * bsz
        e_real = shape.params["n_edges"] * bsz
        n_graphs = bsz
    else:
        n_real, e_real = shape.params["n_nodes"], shape.params["n_edges"]
        n_graphs = 1
    n, e = _round_up(n_real, gran), _round_up(e_real, gran)
    if arch.arch_id == "equiformer-v2" and not molecule:
        e = _round_up(e, cfg.edge_chunk)
    d_feat = shape.params.get("d_feat", 16)
    if arch.arch_id == "graphsage-reddit":
        cfg = dataclasses.replace(cfg, d_in=d_feat)
    if arch.arch_id == "egnn":
        cfg = dataclasses.replace(cfg, d_in=d_feat)
    opt_cfg = AdamWConfig()
    owner = variant != "base" and arch.arch_id == "graphsage-reddit" \
        and not molecule
    loss = None
    if owner:
        def loss(p, b_, _t):
            coords = None if mesh is None else mesh.coords(batch_axes)
            devices = [b_.node_feat.device] if mesh is None else \
                [mesh.device(**c) for c in coords]
            logits = sage_mod.forward_full_owner(p, b_, cfg, devices=devices,
                                                 coords=coords)
            return mcommon.cross_entropy(logits, b_.node_label)
    inner = full_step(arch.arch_id, cfg, opt_cfg, keep_grads, mesh, loss)

    def step(params, opt, node_feat, edge_src, edge_dst, coords, labels,
             targets):
        batch = GraphBatch(
            node_feat=node_feat, edge_src=edge_src, edge_dst=edge_dst,
            coords=coords, node_label=labels,
            graph_id=_graph_id(n, n_graphs, node_feat.device),
            n_graphs=n_graphs)
        return inner(params, opt, batch, targets)

    draw = _Draw(abstract, _arg_device(mesh, device), seed)
    params = draw.params(mod.init_params, cfg)
    opt = adamw_init(params)
    src, dst = _gnn_edges(draw, n, e, n_real, e_real, n // n_graphs
                          if molecule else None)
    args = (params, opt, draw.normal((n, d_feat)), src, dst,
            draw.normal((n, 3)),
            draw.ints((n,), getattr(cfg, "n_classes", 2)),
            draw.normal((n_graphs,)))
    return Case(arch.arch_id, shape.name, step, args,
                meta={"model_flops": _gnn_flops(arch.arch_id, cfg, n, e),
                      "tokens": n, "kind": "gnn_train"},
                mesh=mesh, axes=dict(batch_axes=batch_axes,
                                     edge_shard_axes=getattr(
                                         cfg, "edge_shard_axes", ())))


def _gnn_edges(draw: _Draw, n: int, e: int, n_real: int, e_real: int,
               block: "int | None") -> tuple:
    """(edge_src, edge_dst) int32 (E,): ``e_real`` edges between the
    ``n_real`` real nodes (within each graph's block of ``block`` nodes,
    the ``graph_id`` blocks, for a batch of molecules), then pads at N."""
    if draw.abstract:
        return draw.empty((e,), torch.int32), draw.empty((e,), torch.int32)
    src = draw.ints((e_real,), n_real)
    if block is None:
        dst = draw.ints((e_real,), n_real)
    else:
        dst = torch.clamp(src // block * block + draw.ints((e_real,), block),
                          max=n_real - 1)
    pad = torch.full((e - e_real,), n, dtype=torch.int32, device=draw.device)
    return torch.cat([src, pad]), torch.cat([dst, pad])


def minibatch_step(arch_id: str, cfg, opt_cfg, fanouts: tuple,
                   keep_grads: bool = False):
    """``gnn_minibatch_case``'s step, the blocks sampled inside it:
    ``step(params, opt, feats, coords, labels, row_ptr, col_idx, seeds,
    rng) -> (params, opt, metrics)``; ``rng`` a host threefry key
    (``data.pipelines.prng_key``)."""
    mod = GNN_MODS[arch_id]

    def step(params, opt, feats, coords, labels, row_ptr, col_idx, seeds,
             rng):
        blocks = sample_blocks(rng, row_ptr, col_idx, seeds, fanouts)

        def loss(p):
            if arch_id == "graphsage-reddit":
                logits = sage_mod.forward_sampled(p, feats, blocks, cfg)
                return mcommon.cross_entropy(logits, labels[seeds])
            batch = blocks_to_graphbatch(blocks, feats, coords, labels)
            pred = mod.forward(p, batch, cfg)
            if arch_id == "egnn":
                pred = pred[0]
            return torch.mean(pred ** 2)

        value, grads = value_and_grad(loss, params)
        return _update(value, grads, opt, params, opt_cfg, keep_grads)
    return step


def random_csr(draw: _Draw, n_pad: int, e_pad: int, n_real: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_ptr int32 (n_pad + 1,), col_idx int32 (e_pad,)): the e_pad
    entries cut among the ``n_real`` real rows at sorted uniform points
    (the pad rows empty), each entry a real node."""
    if draw.abstract:
        return (draw.empty((n_pad + 1,), torch.int32),
                draw.empty((e_pad,), torch.int32))
    cuts = torch.sort(draw.ints((n_real - 1,), e_pad + 1)).values
    row_ptr = torch.full((n_pad + 1,), e_pad, dtype=torch.int32,
                         device=draw.device)
    row_ptr[0] = 0
    row_ptr[1:n_real] = cuts
    return row_ptr, draw.ints((e_pad,), n_real)


def csr_from_edges(src: torch.Tensor, dst: torch.Tensor, n_nodes: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_ptr int32 (N + 1,), col_idx int32 (E,)) of the directed
    entries src -> dst, on their device: a stable sort by source."""
    order = torch.sort(src, stable=True).indices
    col_idx = dst[order]
    del order
    counts = torch.bincount(src, minlength=n_nodes)
    row_ptr = torch.zeros(n_nodes + 1, dtype=torch.int32, device=src.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return row_ptr, col_idx


def gnn_minibatch_case(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
                       abstract: bool = False, device=None, seed: int = 0,
                       keep_grads: bool = False) -> Case:
    mod = GNN_MODS[arch.arch_id]
    cfg = _gnn_cfg(arch, shape, mesh)
    n = shape.params["n_nodes"]
    e = 2 * shape.params["n_edges"]        # directed entries
    bsz = shape.params["batch_nodes"]
    fanout = shape.params["fanout"]
    d_feat = shape.params["d_feat"]
    if arch.arch_id == "graphsage-reddit":
        cfg = dataclasses.replace(cfg, fanouts=fanout, d_in=d_feat)
    if arch.arch_id == "egnn":
        cfg = dataclasses.replace(cfg, d_in=d_feat)
    if arch.arch_id == "equiformer-v2":
        # sampled block has ~170k edges; single chunk
        cfg = dataclasses.replace(cfg, edge_chunk=bsz * fanout[0] *
                                  (1 + fanout[1]), edge_shard_axes=())
    step = minibatch_step(arch.arch_id, cfg, AdamWConfig(), fanout,
                          keep_grads)

    draw = _Draw(abstract, _arg_device(mesh, device), seed)
    params = draw.params(mod.init_params, cfg)
    opt = adamw_init(params)
    n_pad = _round_up(n, 1024)
    e_pad = _round_up(e, 1024)
    feats, coords = draw.normal((n_pad, d_feat)), draw.normal((n_pad, 3))
    labels = draw.ints((n_pad,), getattr(cfg, "n_classes", 2))
    row_ptr, col_idx = random_csr(draw, n_pad, e_pad, n)
    args = (params, opt, feats, coords, labels, row_ptr, col_idx,
            draw.ints((bsz,), n), prng_key(seed))
    n_sampled = bsz * (1 + fanout[0] + fanout[0] * fanout[1])
    e_sampled = bsz * fanout[0] * (1 + fanout[1])
    return Case(arch.arch_id, shape.name, step, args,
                meta={"model_flops": _gnn_flops(arch.arch_id, cfg, n_sampled,
                                                e_sampled),
                      "tokens": bsz, "kind": "gnn_minibatch"},
                mesh=mesh, axes=dict(batch_axes=_axes(mesh)[0]))


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------

def dlrm_step(cfg, opt_cfg, keep_grads: bool = False):
    """``dlrm_case``'s ``rs_train`` step on a batch dict: ``step(params,
    opt, batch) -> (params, opt, metrics)``."""
    def step(params, opt, batch):
        value, grads = value_and_grad(
            lambda p: dlrm_mod.loss_fn(p, batch, cfg)[0], params)
        return _update(value, grads, opt, params, opt_cfg, keep_grads)
    return step


def dlrm_case(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
              abstract: bool = False, device=None, seed: int = 0,
              keep_grads: bool = False) -> Case:
    cfg = arch.make_config()
    kind = shape.kind
    draw = _Draw(abstract, _arg_device(mesh, device), seed)
    params = draw.params(dlrm_mod.init_params, cfg)
    n_dense_params = cfg.n_params - cfg.n_sparse * cfg.vocab_per_table \
        * cfg.embed_dim

    def sparse(b):
        return draw.ints((b, cfg.n_sparse, cfg.hot), cfg.vocab_per_table)

    if kind == "rs_train":
        b = shape.params["batch"]
        inner = dlrm_step(cfg, AdamWConfig(), keep_grads)

        def step(params, opt, dense, sparse, labels):
            return inner(params, opt, {"dense": dense, "sparse": sparse,
                                       "labels": labels})

        labels = draw.empty((b,), torch.float32) if abstract else \
            (draw.uniform((b,), 0.0, 1.0) < 0.25).float()
        args = (params, adamw_init(params), draw.normal((b, cfg.n_dense)),
                sparse(b), labels)
        flops = 6 * n_dense_params * b
    elif kind == "rs_serve":
        b = shape.params["batch"]

        @torch.no_grad()
        def step(params, dense, sparse):
            return dlrm_mod.forward(params, dense, sparse, cfg)

        args = (params, draw.normal((b, cfg.n_dense)), sparse(b))
        flops = 2 * n_dense_params * b
    else:                                   # rs_retrieval
        nc_pad = _round_up(shape.params["n_candidates"], 1024)

        @torch.no_grad()
        def step(params, dense, sparse, candidates):
            return dlrm_mod.retrieval_score(params, dense, sparse,
                                            candidates, cfg)

        args = (params, draw.normal((1, cfg.n_dense)), sparse(1),
                draw.normal((nc_pad, cfg.embed_dim)))
        flops = 2 * nc_pad * cfg.embed_dim
        b = 1
    return Case(arch.arch_id, shape.name, step, args,
                meta={"model_flops": flops, "tokens": b, "kind": kind},
                mesh=mesh, axes=dict(batch_axes=_axes(mesh)[0]))


# ---------------------------------------------------------------------------
# the paper's own engine (extra, beyond the 40 assigned cells)
# ---------------------------------------------------------------------------

def random_ipgc_graph(draw: _Draw, n: int, k: int, n_hub: int,
                      t_pad: int) -> ipgc_mod.IPGCGraph:
    """A random symmetric graph in ``ipgc.prepare``'s ell-tail layout,
    with exactly ``n_hub`` hubs and a tail of ``t_pad`` entries.

    Every row holds ``(k - 1) // 2`` pairs (p(i), p^-1(i)) of random
    permutations p. Each hub has ``k - 2 * pairs`` neighbours more in its
    ELL row and ``c`` in the tail (half the tail's room, spread evenly),
    distinct non-hubs that hold the hub in their own row; so a hub's degree
    passes ``k`` and no other row's does. Self loops and repeated
    neighbours in a row are dropped and the rows left-packed (pad ``n``);
    a tail neighbour may repeat one of its hub's permutation neighbours.
    Priorities are a random permutation, ``priority[n] = -1``."""
    if draw.abstract:
        i32 = torch.int32
        return ipgc_mod.IPGCGraph(
            n_nodes=n, ell_width=k, n_hub=n_hub,
            ell_idx=draw.empty((n, k), i32), degrees=draw.empty((n,), i32),
            priority=draw.empty((n + 1,), i32),
            tail_src=draw.empty((t_pad,), i32),
            tail_dst=draw.empty((t_pad,), i32),
            tail_valid=draw.empty((t_pad,), torch.bool),
            tail_slot=draw.empty((t_pad,), i32),
            hub_slot=draw.empty((n,), i32), hub_ids=draw.empty((n_hub,), i32))
    dev = draw.device
    pairs = (k - 1) // 2
    extra = k - 2 * pairs                  # hub neighbours in the ELL row
    c = min(t_pad // n_hub // 2, (n - n_hub) // n_hub - extra)
    if c < 2:
        raise ValueError(f"{n} nodes leave no room for {n_hub} hubs")
    order = draw.perm(n)
    hubs = torch.sort(order[:n_hub]).values
    nbrs = order[n_hub:n_hub + n_hub * (extra + c)].view(n_hub, extra + c)
    del order
    ell = torch.full((n, k), n, dtype=torch.int32, device=dev)
    ids = torch.arange(n, device=dev)
    for j in range(pairs):
        p = draw.perm(n)
        ell[:, 2 * j] = p.to(torch.int32)
        ell[p, 2 * j + 1] = ids.to(torch.int32)       # p^-1
        del p
    ell[nbrs.reshape(-1), 2 * pairs] = hubs.repeat_interleave(
        extra + c).to(torch.int32)
    ell[hubs, 2 * pairs:] = nbrs[:, :extra].to(torch.int32)
    ell[ell == ids[:, None]] = n                        # self loops
    ell = torch.sort(ell, dim=1).values
    ell[:, 1:][ell[:, 1:] == ell[:, :-1]] = n          # repeats
    ell = torch.sort(ell, dim=1).values
    hub_slot = torch.full((n,), n_hub, dtype=torch.int32, device=dev)
    hub_slot[hubs] = torch.arange(n_hub, dtype=torch.int32, device=dev)
    degrees = (ell < n).sum(1, dtype=torch.int32)
    degrees[hubs] += c
    t = n_hub * c
    tail_src = torch.full((t_pad,), n - 1, dtype=torch.int32, device=dev)
    tail_src[:t] = hubs.repeat_interleave(c).to(torch.int32)
    tail_dst = torch.full((t_pad,), n, dtype=torch.int32, device=dev)
    tail_dst[:t] = nbrs[:, extra:].reshape(-1).to(torch.int32)
    tail_valid = torch.zeros((t_pad,), dtype=torch.bool, device=dev)
    tail_valid[:t] = True
    priority = torch.cat([draw.perm(n).to(torch.int32),
                          torch.full((1,), -1, dtype=torch.int32,
                                     device=dev)])
    return ipgc_mod.IPGCGraph(
        n_nodes=n, ell_width=k, n_hub=n_hub, ell_idx=ell, degrees=degrees,
        priority=priority, tail_src=tail_src, tail_dst=tail_dst,
        tail_valid=tail_valid, tail_slot=hub_slot[tail_src.long()],
        hub_slot=hub_slot, hub_ids=hubs.to(torch.int32))


def ipgc_case(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
              abstract: bool = False, device=None, seed: int = 0) -> Case:
    """One dense step at window 128 from the first iteration's state
    (every node uncolored and on the worklist)."""
    n = shape.params["n_nodes"]
    k = shape.params["ell_width"]
    t_pad = max(n // 64, 1024)
    nh = max(n // 4096, 8)

    def step(ig, colors, base, wl):
        return ipgc_mod.dense_step(ig, colors, base, wl, window=128)

    draw = _Draw(abstract, _arg_device(mesh, device), seed)
    ig = random_ipgc_graph(draw, n, k, nh, t_pad)
    if abstract:
        colors = draw.empty((n + 1,), torch.int32)
        base = draw.empty((n,), torch.int32)
        wl = Worklist(mask=draw.empty((n,), torch.bool),
                      items=draw.empty((n,), torch.int32),
                      count=draw.empty((), torch.int32))
    else:
        colors = ipgc_mod.init_colors(n, draw.device)
        base = torch.zeros((n,), dtype=torch.int32, device=draw.device)
        wl = full_worklist(n, draw.device)
    # per-iteration work ~ O(N*K) compares + O(N*W) mex
    return Case(arch.arch_id, shape.name, step, (ig, colors, base, wl),
                meta={"model_flops": n * (k + 128) * 2, "tokens": n,
                      "kind": "coloring"},
                mesh=mesh, axes=dict(batch_axes=_axes(mesh)[0]))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def registry_cells() -> list:
    """Every (arch_id, shape_name) of the registry, the paper's engine
    last: the 40 assigned cells and its two."""
    return [(a, s) for a in ARCH_IDS + ["paper-ipgc"]
            for s in get_arch(a).shapes]


def case_for(arch: ArchSpec, shape: ShapeSpec, mesh=None, *,
             variant: str = "base", **kw) -> Case:
    """``build_case`` for a given ``ArchSpec`` and ``ShapeSpec`` (a smoke
    config, a shape of one's own); ``kw``: ``abstract``, ``device``,
    ``seed``."""
    if arch.family == "lm":
        if shape.kind == "train":
            return lm_train_case(arch, shape, mesh, **kw)
        if shape.kind == "prefill":
            return lm_prefill_case(arch, shape, mesh, **kw)
        return lm_decode_case(arch, shape, mesh, variant=variant, **kw)
    if arch.family == "gnn":
        if shape.kind == "gnn_minibatch":
            return gnn_minibatch_case(arch, shape, mesh, **kw)
        return gnn_full_case(arch, shape, mesh,
                             molecule=(shape.kind == "gnn_molecule"),
                             variant=variant, **kw)
    if arch.family == "recsys":
        return dlrm_case(arch, shape, mesh, **kw)
    if arch.family == "paper":
        return ipgc_case(arch, shape, mesh, **kw)
    raise ValueError(arch.family)


def build_case(arch_id: str, shape_name: str, mesh=None, *,
               variant: str = "base", abstract: bool = False, device=None,
               seed: int = 0) -> Case:
    """The case of a registry cell at its published config. ``abstract``:
    arguments on the ``meta`` device (nothing allocated); otherwise drawn
    on ``device`` (None: the mesh's first entry, or the CUDA device)
    from ``seed``."""
    arch = get_arch(arch_id)
    return case_for(arch, arch.shapes[shape_name], mesh, variant=variant,
                    abstract=abstract, device=device, seed=seed)


def smoke_arch(arch_id: str) -> ArchSpec:
    """The arch with its smoke config as its config."""
    arch = get_arch(arch_id)
    return dataclasses.replace(arch, make_config=arch.make_smoke)


def n_params(case: Case) -> int:
    """Parameters in the case's first argument (0 for the coloring)."""
    p = case.args[0]
    return sum(t.numel() for _, t in flatten_args(p)) if isinstance(p, dict) \
        else 0

