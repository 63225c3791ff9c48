"""Attention: RoPE + GQA with chunked (flash-style online-softmax)
compute, and one-token decode over a KV cache (``repro/models/attention.py``).

Shapes use the reference's named conventions: B batch, S sequence, H
q-heads, Hk kv-heads, G = H/Hk group size, D head dim; activations are
(B, S, H, D), as in the reference, at every public function.

Prefill and training use ``flash_attention``, the reference's O(S)-memory
online-softmax loop over KV chunks, as plain PyTorch ops: scores and the
running sums in fp32 (the reference's ``preferred_element_type``), the
probabilities cast to V's type before the PV product. Decode uses
one-query attention over the cache, in bf16 or int8 (``KVCache``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

_NEG_INF = float("-inf")


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., D/2) in fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, N, D); cos/sin (S, D/2) or (B, S, D/2). In fp32, then cast
    back to x's type."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.ndim == 2:                     # (S, half) — shared positions
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                                 # (B, S, half) — per-batch positions
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def _chunk_attn_block(q, k, v, carry, q_pos, k_pos, causal: bool,
                      scale: float):
    """One (q-chunk, k-chunk) online-softmax update.

    q (B, cq, Hk, G, D); k/v (B, ck, Hk, D); carry = (m, l, acc), fp32.
    """
    m, l, acc = carry
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]          # (cq, ck)
        s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))             # (B,Hk,G,cq)
    # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> safe sub
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    fin = torch.isfinite(m)
    corr = torch.exp(torch.where(fin, m - m_safe, _NEG_INF))
    corr = torch.where(fin, corr, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    k_chunk: int = 1024, scale: "float | None" = None,
                    remat_chunks: bool = True) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,Hk,D) -> (B,Sq,H,D). O(chunk^2) memory.

    The reference's chunk rules: a chunk is at most the sequence, and a
    sequence its chunk does not divide runs as one chunk. ``remat_chunks``
    (the reference's per-chunk ``jax.checkpoint``) only shapes a backward
    pass; without autodiff here it is accepted and ignored.
    """
    del remat_chunks
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    g = h // hk
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hk, g, d)
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    if sq % q_chunk:
        q_chunk = sq
    if sk % k_chunk:
        k_chunk = sk
    dev = q.device
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc = qg[:, q0:q0 + q_chunk]
        q_pos = torch.arange(q0, q0 + q_chunk, device=dev)
        carry = (torch.full((b, hk, g, q_chunk), _NEG_INF, device=dev),
                 torch.zeros((b, hk, g, q_chunk), device=dev),
                 torch.zeros((b, hk, g, q_chunk, d), device=dev))
        for k0 in range(0, sk, k_chunk):
            k_pos = torch.arange(k0, k0 + k_chunk, device=dev)
            carry = _chunk_attn_block(qc, k[:, k0:k0 + k_chunk],
                                      v[:, k0:k0 + k_chunk], carry, q_pos,
                                      k_pos, causal, scale)
        _, l, acc = carry
        out = acc / l.clamp(min=1e-30)[..., None]         # (B,Hk,G,cq,D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def _masked_softmax(s: torch.Tensor, cache_len: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis (positions) of (B, Hk, G, S) scores, the
    positions at or past each row's ``cache_len`` masked out."""
    pos = torch.arange(s.shape[-1], device=s.device)
    s = torch.where(pos[None, None, None, :]
                    < cache_len[:, None, None, None], s, _NEG_INF)
    return torch.softmax(s, dim=-1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: "float | None" = None) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q (B, 1, H, D); caches (B, S_max, Hk, D); cache_len (B,) valid lengths.
    """
    b, _, h, d = q.shape
    _, s_max, hk, _ = k_cache.shape
    g = h // hk
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    p = _masked_softmax(s, cache_len)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


class KVCache(NamedTuple):
    """Per-model KV cache, stacked over layers.

    Optionally int8-quantized (k/v int8 + per-(position, head) fp16
    absmax scales): half the bytes a decode step reads."""

    k: torch.Tensor              # (L, B, S_max, Hk, D) model dtype or int8
    v: torch.Tensor
    length: torch.Tensor         # (B,) int32 — shared across layers
    k_scale: "torch.Tensor | None" = None   # (L, B, S_max, Hk) when int8
    v_scale: "torch.Tensor | None" = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def init(n_layers: int, batch: int, s_max: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, device=None) -> "KVCache":
        """An empty cache on ``device`` (None: the CUDA device, which must
        exist; pass ``"cpu"`` for the CPU)."""
        device = resolve_device(device)
        shape = (n_layers, batch, s_max, n_kv, head_dim)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        if dtype == torch.int8:
            sshape = (n_layers, batch, s_max, n_kv)
            return KVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                length=length,
                k_scale=torch.zeros(sshape, dtype=torch.float16,
                                    device=device),
                v_scale=torch.zeros(sshape, dtype=torch.float16,
                                    device=device))
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       length=length)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 values + per-(...) fp16 absmax scale."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp(min=1e-8)[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def _int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int8 x int8 contraction, exact, as the reference's int32 dot
    gives it: the products are summed in float64 (exact below 2^53; the
    card has no int8 ``einsum``) and rounded to fp32, as the reference's
    ``int32 -> fp32`` conversion rounds."""
    return torch.einsum(eq, a.double(), b.double()).float()


def decode_attention_q8(q: torch.Tensor, k_q: torch.Tensor,
                        k_scale: torch.Tensor, v_q: torch.Tensor,
                        v_scale: torch.Tensor, cache_len: torch.Tensor, *,
                        scale: "float | None" = None) -> torch.Tensor:
    """Single-token attention over an int8 KV cache: the query and the
    attention weights are quantized to int8 too, the two contractions are
    int8 x int8 with an fp32 rescale on the small score and output
    tensors (the reference's ~1e-2 relative error, a KIVI-class trade).

    q (B,1,H,D); k_q/v_q (B,S,Hk,D) int8; scales (B,S,Hk) fp16.
    """
    b, _, h, d = q.shape
    _, s_max, hk, _ = k_q.shape
    g = h // hk
    sc = scale if scale is not None else d ** -0.5
    qq, qs = quantize_kv(q.reshape(b, hk, g, d))          # int8 query
    s_int = _int_einsum("bhgd,bshd->bhgs", qq, k_q)
    s = (s_int * qs.float()[..., None]
         * k_scale.float().permute(0, 2, 1)[:, :, None, :] * sc)
    p = _masked_softmax(s, cache_len)
    # fold v's per-position scale into p, then quantize p rows to int8
    pw = p * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    pq, ps = quantize_kv(pw)
    o = _int_einsum("bhgs,bshd->bhgd", pq, v_q) * ps.float()[..., None]
    return o.reshape(b, 1, h, d).to(q.dtype)
