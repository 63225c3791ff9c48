"""Decoder-only LM stack, dense and MoE, covering the five LM archs
(``repro/models/transformer.py``).

* Layers are stacked along axis 0, as in the reference's parameter tree,
  and run as a plain loop over layers (the reference's ``lax.scan``; its
  remat and batch-sharding constraints have no meaning on one device and
  without autodiff).
* Attention is GQA with RoPE and flash-style chunked compute.
* MoE layers use the capacity-bucketed block of ``moe.py``.
* Parameter logical axes are emitted next to init, as in the reference.

``TransformerLM`` holds the tree as module parameters under the
reference's names and stacked ``(L, ...)`` shapes; ``params_from_numpy``
carries a tree made by the reference (``jax.tree.map(np.asarray,
params)``) across, so that both packages compute the same function.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.attention import (KVCache, apply_rope,
                                          decode_attention,
                                          decode_attention_q8,
                                          flash_attention, quantize_kv,
                                          rope_angles)
from repro_torch.models.moe import MoESettings, moe_ffn


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


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A torch tensor of ``a`` on ``device``; a bfloat16 array (the
    ``ml_dtypes`` type NumPy arrays of JAX's bf16 carry) goes across bit
    for bit."""
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, *, device=None) -> dict:
    """The reference's parameter tree as NumPy arrays (``jax.tree.map(
    np.asarray, params)``) -> the port's tree of tensors on ``device``
    (None: the CUDA device), same names, shapes and dtypes."""
    dev = resolve_device(device)
    return {k: params_from_numpy(v, device=dev) if isinstance(v, dict)
            else _tensor_from_numpy(np.asarray(v), dev)
            for k, v in tree.items()}


class TransformerLM(torch.nn.Module):
    """The parameter tree as module parameters: ``embed``, ``lm_head``,
    ``final_norm`` and ``layers.<name>`` with stacked ``(L, ...)`` shapes,
    as the reference names them. Serving needs no gradient, so the
    parameters are made with ``requires_grad=False``."""

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


def _ffn_block(x, lp, cfg: LMConfig, mesh=None):
    h = common.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe:
        y, aux = moe_ffn(h, lp, cfg.moe, mesh=mesh)
    else:
        up = h @ lp["w_in"]
        gate = h @ lp["w_gate"] if common.is_gated(cfg.act) else None
        y = common.activation(cfg.act, up, gate) @ lp["w_out"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
            mesh=None, collect_kv: bool = False):
    """tokens (B, S) -> logits (B, S, V). Returns (logits, aux_loss,
    kv | None), kv the per-layer keys and values stacked ``(L, B, S, Hk,
    D)`` each (for prefill)."""
    _, s = tokens.shape
    x = _embed(params, tokens, cfg)
    cos, sin = rope_angles(torch.arange(s, device=x.device), cfg.head_dim,
                           cfg.rope_theta)
    auxs, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x, (k, v) = _attn_block(x, lp, cfg, cos, sin)
        x, aux = _ffn_block(x, lp, cfg, mesh)
        auxs.append(aux)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"]
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return logits, torch.stack(auxs).mean(), kvs


def loss_fn(params: dict, batch: dict, cfg: LMConfig, **kw) -> tuple:
    """Token cross-entropy plus the router's aux loss. (Its gradient path
    comes with the training substrate.)"""
    logits, aux, _ = forward(params, batch["tokens"], cfg, **kw)
    ce = common.cross_entropy(logits, batch["labels"], batch.get("mask"))
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
            mesh=None, max_len: "int | None" = None
            ) -> tuple[torch.Tensor, KVCache]:
    """Process the full prompt; returns (last-position logits, filled
    cache). ``max_len`` reserves decode headroom in the cache (defaults to
    the prompt length)."""
    b, s = tokens.shape
    logits, _, (k, v) = forward(params, tokens, cfg, mesh=mesh,
                                collect_kv=True)
    if max_len is not None and max_len > s:
        room = KVCache.init(k.shape[0], b, max_len, k.shape[3], k.shape[4],
                            dtype=k.dtype, device=k.device)
        room.k[:, :, :s] = k
        room.v[:, :, :s] = v
        k, v = room.k, room.v
    cache = KVCache(k=k, v=v, length=torch.full((b,), s, dtype=torch.int32,
                                                device=tokens.device))
    return logits[:, -1], cache


def quantize_cache(cache: KVCache) -> KVCache:
    """The int8 form of a prefilled cache (per-(position, head) absmax
    scales), as the reference's serve driver re-quantizes it."""
    kq, ks = quantize_kv(cache.k)
    vq, vs = quantize_kv(cache.v)
    return KVCache(k=kq, v=vq, length=cache.length, k_scale=ks, v_scale=vs)


def decode_step(params: dict, tokens: torch.Tensor, cache: KVCache,
                cfg: LMConfig, *, mesh=None) -> tuple[torch.Tensor, KVCache]:
    """One decode step. tokens (B, 1) -> (logits (B, V), updated cache).

    The cache's tensors are written in place at each row's position (the
    reference builds new arrays): the returned cache holds the same
    tensors and the lengths plus one."""
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
        x, _ = _ffn_block(x, lp, cfg, mesh)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"])[:, 0]
    return logits, cache._replace(length=cache.length + 1)
