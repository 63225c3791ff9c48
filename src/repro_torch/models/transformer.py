"""Decoder-only LM stack, dense and MoE, covering the five LM archs
(``repro/models/transformer.py``).

* Layers are stacked along axis 0, as in the reference's parameter tree,
  and run as a plain loop over layers (the reference's ``lax.scan``).
  With ``LMConfig.remat`` and a gradient to take, each layer runs under
  ``torch.utils.checkpoint``, the reference's per-layer
  ``jax.checkpoint``.
* Attention is GQA with RoPE and flash-style chunked compute.
* MoE layers use the capacity-bucketed block of ``moe.py``.
* ``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take the
  reference's ``mesh``, ``batch_axes`` and ``fsdp_axes``: on a
  ``launch.mesh.DeviceMesh`` each data shard runs its rows of the batch on
  its home device and its MoE blocks expert-parallel over the model axis
  (``moe.moe_shard``); a shard's KV cache rows stay on its device
  (``MeshKVCache``).
* Parameter logical axes are emitted next to init, as in the reference.

``loss_fn`` is differentiable in a params dict whose float leaves require
grad; the gradients come back in the same tree, stacked leaves stacked
(``launch/train.py``). ``TransformerLM``, the inference wrapper, holds the
tree as module parameters under the reference's names and stacked
``(L, ...)`` shapes; ``params_from_numpy`` (``models/common.py``,
re-exported here) carries a tree made by the reference
(``jax.tree.map(np.asarray, params)``) across, so that both packages
compute the same function.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.common import params_from_numpy  # noqa: F401
from repro_torch.models.attention import (KVCache, apply_rope,
                                          decode_attention,
                                          decode_attention_q8,
                                          flash_attention, quantize_kv,
                                          rope_angles)
from repro_torch.launch.mesh import data_shards, split_batch
from repro_torch.models.moe import MoESettings, moe_ffn, moe_shard


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"                 # swiglu | geglu | relu2
    moe: "MoESettings | None" = None
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = True
    q_chunk: int = 512
    k_chunk: int = 1024
    embed_scale: bool = False           # gemma multiplies embeddings by sqrt(d)

    def _attn(self) -> int:
        d = self.d_model
        return d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2

    @property
    def n_params(self) -> int:
        """Total parameter count."""
        d, l = self.d_model, self.n_layers
        if self.moe:
            ff = self.moe.n_experts * d * self.moe.d_ff_expert * 3 \
                + d * self.moe.n_experts
        else:
            n_mats = 3 if common.is_gated(self.act) else 2
            ff = n_mats * d * self.d_ff
        return l * (self._attn() + ff + 2 * d) + 2 * self.vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Active (per-token) params — MoE counts only routed experts."""
        if not self.moe:
            return self.n_params
        d, l, m = self.d_model, self.n_layers, self.moe
        ff = m.top_k * d * m.d_ff_expert * 3 + d * m.n_experts
        return l * (self._attn() + ff + 2 * d) + 2 * self.vocab * d + d


# ---------------------------------------------------------------------------
# init and weights carried across
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, generator: "torch.Generator | None" = None,
                *, device=None) -> tuple[dict, dict]:
    """Returns (params, logical_axes) trees at random init on ``device``
    (None: the CUDA device; ``"meta"``: shapes only, the reference's
    ``abstract=True``). ``generator`` defaults to one seeded with 0 on
    the device. Each parameter is drawn a layer slice at a time
    (``common.ParamFactory.dense``)."""
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    f = common.ParamFactory(generator, cfg.dtype, dev)
    d, l = cfg.d_model, cfg.n_layers
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim

    layers: dict = {
        "ln1": f.zeros((l, d), ("layer", "embed_nm")),
        "ln2": f.zeros((l, d), ("layer", "embed_nm")),
        "wq": f.dense((l, d, hq), ("layer", "embed", "heads")),
        "wk": f.dense((l, d, hkv), ("layer", "embed", "kv_heads")),
        "wv": f.dense((l, d, hkv), ("layer", "embed", "kv_heads")),
        "wo": f.dense((l, hq, d), ("layer", "heads", "embed"),
                      scale=1.0 / (hq ** 0.5 * (2 * l) ** 0.5)),
    }
    if cfg.moe:
        m = cfg.moe
        layers.update(
            router=f.dense((l, d, m.n_experts), ("layer", "embed", "experts"),
                           scale=0.02),
            we_in=f.dense((l, m.n_experts, d, m.d_ff_expert),
                          ("layer", "experts", "embed_r", "expert_ff")),
            we_gate=f.dense((l, m.n_experts, d, m.d_ff_expert),
                            ("layer", "experts", "embed_r", "expert_ff")),
            we_out=f.dense((l, m.n_experts, m.d_ff_expert, d),
                           ("layer", "experts", "expert_ff", "embed_r"),
                           scale=1.0 / (m.d_ff_expert ** 0.5 * (2 * l) ** 0.5)),
        )
    else:
        layers["w_in"] = f.dense((l, d, cfg.d_ff), ("layer", "embed", "ff"))
        if common.is_gated(cfg.act):
            layers["w_gate"] = f.dense((l, d, cfg.d_ff),
                                       ("layer", "embed", "ff"))
        layers["w_out"] = f.dense((l, cfg.d_ff, d), ("layer", "ff", "embed"),
                                  scale=1.0 / (cfg.d_ff ** 0.5 * (2 * l) ** 0.5))

    tree = {
        "embed": f.dense((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "lm_head": f.dense((d, cfg.vocab), ("embed", "vocab")),
        "final_norm": f.zeros((d,), ("embed_nm",)),
        "layers": layers,
    }
    return common.split_tree(tree)


class TransformerLM(torch.nn.Module):
    """The parameter tree as module parameters: ``embed``, ``lm_head``,
    ``final_norm`` and ``layers.<name>`` with stacked ``(L, ...)`` shapes,
    as the reference names them. Serving needs no gradient, so the
    parameters are made with ``requires_grad=False``; training works on
    the functional params dict (``launch/train.py``)."""

    def __init__(self, cfg: LMConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = torch.nn.Parameter(params["embed"], requires_grad=False)
        self.lm_head = torch.nn.Parameter(params["lm_head"],
                                          requires_grad=False)
        self.final_norm = torch.nn.Parameter(params["final_norm"],
                                             requires_grad=False)
        self.layers = torch.nn.ParameterDict({
            k: torch.nn.Parameter(v, requires_grad=False)
            for k, v in params["layers"].items()})

    def params(self) -> dict:
        """The reference-shaped tree of this module's tensors."""
        return {"embed": self.embed, "lm_head": self.lm_head,
                "final_norm": self.final_norm,
                "layers": dict(self.layers.items())}

    def forward(self, tokens: torch.Tensor, *, collect_kv: bool = False):
        return forward(self.params(), tokens, self.cfg,
                       collect_kv=collect_kv)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _layers(params: dict) -> list[dict]:
    """Every layer's slice of the stacked leaves, as ``_layer`` gives it,
    from one ``unbind`` a leaf: its backward stacks the L slices'
    gradients once, where L separate slices would each write a zero-filled
    gradient of the whole stack."""
    stacks = {k: v.unbind(0) for k, v in params["layers"].items()}
    n = len(next(iter(stacks.values())))
    return [{k: t[i] for k, t in stacks.items()} for i in range(n)]


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def _attn_block(x, lp, cfg: LMConfig, cos, sin):
    b, s, _ = x.shape
    h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                        k_chunk=cfg.k_chunk)
    return x + o.reshape(b, s, -1) @ lp["wo"], (k, v)


class Shard(NamedTuple):
    """One data shard of a mesh form: the mesh, the shard's coordinates
    over the batch axes, and the FSDP axes its MoE blocks gather over."""

    mesh: Any
    coords: dict
    fsdp_axes: tuple


def _ffn_block(x, lp, cfg: LMConfig, shard: "Shard | None" = None):
    h = common.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe and shard is None:
        y, aux = moe_ffn(h, lp, cfg.moe)
    elif cfg.moe:
        y, aux = moe_shard(h, lp, cfg.moe, shard.mesh, shard.coords,
                           fsdp_axes=shard.fsdp_axes)
    else:
        up = h @ lp["w_in"]
        gate = h @ lp["w_gate"] if common.is_gated(cfg.act) else None
        y = common.activation(cfg.act, up, gate) @ lp["w_out"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _block(x, lp, cfg: LMConfig, cos, sin, shard):
    x, kv = _attn_block(x, lp, cfg, cos, sin)
    x, aux = _ffn_block(x, lp, cfg, shard)
    return x, aux, kv


def _mesh_shards(mesh, batch_axes: tuple, fsdp_axes: tuple) -> list:
    """(``Shard``, home device) of each data shard, in batch order; with
    no mesh, one shard that is the whole batch, where it lies. Axes
    without a mesh are refused: the reference's constraints need one."""
    if mesh is None:
        if batch_axes or fsdp_axes:
            raise ValueError(f"batch_axes {batch_axes} and fsdp_axes "
                             f"{fsdp_axes} shard over a mesh: pass mesh=")
        return [(None, None)]
    return [(Shard(mesh, c, tuple(fsdp_axes)), dev)
            for c, dev in data_shards(mesh, tuple(batch_axes))]


def _on(tree, dev):
    """The parameter tree on ``dev`` (no copy for a leaf already there;
    placed expert weights stay where ``place_params`` put them)."""
    if dev is None:
        return tree
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev) if torch.is_tensor(tree) else tree


def _per_shard(fn, params, tokens, shards, *rest) -> list:
    """``fn(params, tokens, *rest, shard)`` on each data shard's rows of
    ``tokens``, on its home device (the rows are views when the device is
    the tokens')."""
    return [fn(_on(params, dev), t if dev is None else t.to(dev), *rest, sh)
            for (sh, dev), t in zip(shards, split_batch(tokens, len(shards)))]


def _gather(parts, dev, dim: int = 0):
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _forward(params, tokens, cfg: LMConfig, collect_kv: bool,
             shard: "Shard | None"):
    _, s = tokens.shape
    x = _embed(params, tokens, cfg)
    cos, sin = rope_angles(torch.arange(s, device=x.device), cfg.head_dim,
                           cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled() and (x.requires_grad or any(
        torch.is_tensor(v) and v.requires_grad
        for v in params["layers"].values()))
    auxs, ks, vs = [], [], []
    for lp in _layers(params)[:cfg.n_layers]:
        args = (x, lp, cfg, cos, sin, shard)
        x, aux, (k, v) = (checkpoint(_block, *args, use_reentrant=False)
                          if remat else _block(*args))
        auxs.append(aux)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"]
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return logits, torch.stack(auxs).mean(), kvs


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
            mesh=None, batch_axes: tuple = (), fsdp_axes: tuple = (),
            collect_kv: bool = False):
    """tokens (B, S) -> logits (B, S, V). Returns (logits, aux_loss,
    kv | None), kv the per-layer keys and values stacked ``(L, B, S, Hk,
    D)`` each (for prefill). With ``cfg.remat`` and grad enabled, backward
    recomputes each layer from its saved input.

    With a ``mesh`` (``launch.mesh.DeviceMesh``), each data shard of
    ``batch_axes`` runs its block of the batch on its home device, its MoE
    blocks through ``moe.moe_shard`` (experts over the model axis, their
    ``ff`` gathered over ``fsdp_axes``); logits, aux (the data shards'
    mean) and kv come back on ``tokens``' device in batch order, and
    gradients flow back across the devices. The reference's other
    constraints (the sequence-sharded residual, ``d_ff`` and the vocab
    over the model axis) are layouts only: they change no value, and wait
    for a multi-process backend (ROADMAP Queue A item 13)."""
    shards = _mesh_shards(mesh, batch_axes, fsdp_axes)
    parts = _per_shard(_forward, params, tokens, shards, cfg, collect_kv)
    if mesh is None:
        return parts[0]
    dev = tokens.device
    logits = _gather([p[0] for p in parts], dev)
    aux = _gather([p[1][None] for p in parts], dev).mean()
    kvs = (_gather([p[2][0] for p in parts], dev, 1),
           _gather([p[2][1] for p in parts], dev, 1)) if collect_kv else None
    return logits, aux, kvs


def loss_fn(params: dict, batch: dict, cfg: LMConfig, **kw) -> tuple:
    """Token cross-entropy plus the router's aux loss; differentiable in
    the float leaves of ``params`` (``launch/train.py::build_step``).
    ``kw`` goes to ``forward`` (``mesh``, ``batch_axes``, ``fsdp_axes``)."""
    logits, aux, _ = forward(params, batch["tokens"], cfg, **kw)
    ce = common.cross_entropy(logits, batch["labels"], batch.get("mask"))
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

class MeshKVCache(NamedTuple):
    """A KV cache split over a mesh's data shards: ``shards[i]`` is data
    shard ``i``'s ``KVCache`` (its rows of the batch) on that shard's home
    device. ``k``, ``v`` and ``length`` read as the whole batch's, in
    batch order, on the first shard's device."""

    shards: tuple

    def _whole(self, name: str, dim: int) -> torch.Tensor:
        parts = [getattr(c, name) for c in self.shards]
        return _gather(parts, parts[0].device, dim)

    @property
    def k(self) -> torch.Tensor:
        return self._whole("k", 1)

    @property
    def v(self) -> torch.Tensor:
        return self._whole("v", 1)

    @property
    def length(self) -> torch.Tensor:
        return self._whole("length", 0)

    @property
    def quantized(self) -> bool:
        return self.shards[0].quantized


def _prefill(params, tokens, cfg: LMConfig, max_len, shard):
    b, s = tokens.shape
    logits, _, (k, v) = _forward(params, tokens, cfg, True, shard)
    if max_len is not None and max_len > s:
        room = KVCache.init(k.shape[0], b, max_len, k.shape[3], k.shape[4],
                            dtype=k.dtype, device=k.device)
        room.k[:, :, :s] = k
        room.v[:, :, :s] = v
        k, v = room.k, room.v
    cache = KVCache(k=k, v=v, length=torch.full((b,), s, dtype=torch.int32,
                                                device=tokens.device))
    return logits[:, -1], cache


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
            mesh=None, batch_axes: tuple = (), fsdp_axes: tuple = (),
            max_len: "int | None" = None
            ) -> "tuple[torch.Tensor, KVCache | MeshKVCache]":
    """Process the full prompt; returns (last-position logits, filled
    cache). ``max_len`` reserves decode headroom in the cache (defaults to
    the prompt length). With a ``mesh`` (``forward``'s data shards) the
    cache is a ``MeshKVCache``: each data shard's rows on its home device;
    the logits come back on ``tokens``' device in batch order."""
    shards = _mesh_shards(mesh, batch_axes, fsdp_axes)
    parts = _per_shard(_prefill, params, tokens, shards, cfg, max_len)
    if mesh is None:
        return parts[0]
    return (_gather([p[0] for p in parts], tokens.device),
            MeshKVCache(tuple(p[1] for p in parts)))


def quantize_cache(cache: "KVCache | MeshKVCache"
                   ) -> "KVCache | MeshKVCache":
    """The int8 form of a prefilled cache (per-(position, head) absmax
    scales), as the reference's serve driver re-quantizes it; a
    ``MeshKVCache`` shard by shard, each on its device."""
    if isinstance(cache, MeshKVCache):
        return MeshKVCache(tuple(quantize_cache(c) for c in cache.shards))
    kq, ks = quantize_kv(cache.k)
    vq, vs = quantize_kv(cache.v)
    return KVCache(k=kq, v=vq, length=cache.length, k_scale=ks, v_scale=vs)


def _decode(params, tokens, cache: KVCache, cfg: LMConfig, shard):
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg)
    pos = cache.length.long()                   # (B,)
    cos, sin = rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    bidx = torch.arange(b, device=x.device)
    quant = cache.quantized
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kc, vc = cache.k[i], cache.v[i]
        if quant:
            kq, ksc = quantize_kv(k[:, 0])
            vq, vsc = quantize_kv(v[:, 0])
            kc[bidx, pos] = kq
            vc[bidx, pos] = vq
            cache.k_scale[i][bidx, pos] = ksc
            cache.v_scale[i][bidx, pos] = vsc
            o = decode_attention_q8(q, kc, cache.k_scale[i], vc,
                                    cache.v_scale[i], pos + 1)
        else:
            kc[bidx, pos] = k[:, 0].to(kc.dtype)
            vc[bidx, pos] = v[:, 0].to(vc.dtype)
            o = decode_attention(q, kc, vc, pos + 1)
        x = x + o.reshape(b, 1, -1) @ lp["wo"]
        x, _ = _ffn_block(x, lp, cfg, shard)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"])[:, 0]
    return logits, cache._replace(length=cache.length + 1)


def decode_step(params: dict, tokens: torch.Tensor,
                cache: "KVCache | MeshKVCache", cfg: LMConfig, *,
                mesh=None, batch_axes: tuple = (), fsdp_axes: tuple = ()
                ) -> "tuple[torch.Tensor, KVCache | MeshKVCache]":
    """One decode step. tokens (B, 1) -> (logits (B, V), updated cache).

    The cache's tensors are written in place at each row's position (the
    reference builds new arrays): the returned cache holds the same
    tensors and the lengths plus one. With a ``mesh``, each data shard
    decodes its rows on its home device against its ``MeshKVCache`` shard;
    the logits come back on ``tokens``' device in batch order."""
    shards = _mesh_shards(mesh, batch_axes, fsdp_axes)
    if mesh is None:
        if isinstance(cache, MeshKVCache):
            raise ValueError("a MeshKVCache decodes over its mesh: pass "
                             "mesh=")
        return _decode(params, tokens, cache, cfg, None)
    if not isinstance(cache, MeshKVCache) or \
            len(cache.shards) != len(shards):
        raise ValueError("decoding on a mesh takes the MeshKVCache that "
                         "prefill made on a mesh of the same data shards")
    rows = split_batch(tokens, len(shards))
    parts = [_decode(_on(params, dev), t.to(dev), c, cfg, sh)
             for (sh, dev), t, c in zip(shards, rows, cache.shards)]
    return (_gather([p[0] for p in parts], tokens.device),
            MeshKVCache(tuple(p[1] for p in parts)))
