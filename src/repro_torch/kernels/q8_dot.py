"""The int8 decode's int8 x int8 -> int32 products (``csrc/q8_dot.cu``).

``scores``: qq (B, Hk, G, D) int8, k_q (B, S, Hk, D) int8 ->
(B, Hk, G, S) int32, ``sum_d qq[b,h,g,d] * k_q[b,s,h,d]``; ``values``:
pq (B, Hk, G, S) int8, v_q (B, S, Hk, D) int8 -> (B, Hk, G, D) int32,
``sum_s pq[b,h,g,s] * v_q[b,s,h,d]``. The reference's
``jnp.einsum(..., preferred_element_type=jnp.int32)`` in
``repro.models.attention.decode_attention_q8``: exact, and wrapping
modulo 2^32 where the sum leaves int32, as its int32 dot does.

On ``meta`` (the dry run) each returns an int32 tensor of the output's
shape; ``flops`` gives the ``2 * B * Hk * G * S * D`` int8 FLOPs of a
call, which ``kernels/ops.py`` reports to the op counter.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: widest head the values kernel takes (its per-block sums in shared memory)
MAX_HEAD_DIM = 512


def _wrap(total: torch.Tensor) -> torch.Tensor:
    """Exact integer sums (float64, each below 2^53) -> int32 modulo 2^32."""
    return total.to(torch.int64).to(torch.int32)


def scores_plain(qq: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. The sums run in float64, where every partial
    sum of int8 products (|.| <= D * 127^2) is an exact integer, so they
    equal int64 sums; float64 products also run on the card, which has no
    integer ``einsum``."""
    return _wrap(torch.einsum("bhgd,bshd->bhgs", qq.double(), k_q.double()))


def values_plain(pq: torch.Tensor, v_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (exact as ``scores_plain``: |.| <= S * 127^2,
    below 2^53 for any cache)."""
    return _wrap(torch.einsum("bhgs,bshd->bhgd", pq.double(), v_q.double()))


def scores_meta(qq: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """The dry run's version: the output's shape and type."""
    b, hk, g, _ = qq.shape
    return torch.empty((b, hk, g, k_q.shape[1]), dtype=torch.int32,
                       device=qq.device)


def values_meta(pq: torch.Tensor, v_q: torch.Tensor) -> torch.Tensor:
    """The dry run's version: the output's shape and type."""
    b, hk, g, _ = pq.shape
    return torch.empty((b, hk, g, v_q.shape[3]), dtype=torch.int32,
                       device=pq.device)


def flops(a: torch.Tensor, cache: torch.Tensor) -> dict:
    """``{"int8": 2 * B * Hk * G * S * D}`` of either product: ``a`` the
    (B, Hk, G, .) int8 rows, ``cache`` the (B, S, Hk, D) int8 cache."""
    b, hk, g, _ = a.shape
    return {"int8": 2 * b * hk * g * cache.shape[1] * cache.shape[3]}


def _check(a: torch.Tensor, cache: torch.Tensor, what: str, rows: int
           ) -> tuple:
    """(B, S, Hk, G, D) of a call, after checking both operands."""
    b, s, hk, d = cache.shape
    g = a.shape[2]
    dev = a.device
    _build.require(cache, f"{what} cache", torch.int8, (b, s, hk, d), dev)
    _build.require(a, f"{what} rows", torch.int8, (b, hk, g, rows or s), dev)
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes a head dim that is a "
                         f"multiple of 4, at most {MAX_HEAD_DIM}; got {d}")
    return b, s, hk, g, d


_SCORES_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p)
_VALUES_ARGTYPES = _SCORES_ARGTYPES[:-1] + (ctypes.c_void_p, ctypes.c_void_p)


def scores_cuda(qq: torch.Tensor, k_q: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (one launch)."""
    qq, k_q = qq.contiguous(), k_q.contiguous()
    b, s, hk, g, d = _check(qq, k_q, "q8 scores", k_q.shape[3])
    out = torch.empty((b, hk, g, s), dtype=torch.int32, device=qq.device)
    fn = _build.function("q8_dot", "q8_scores_launch", _SCORES_ARGTYPES)
    with torch.cuda.device(qq.device):
        err = fn(qq.data_ptr(), k_q.data_ptr(), out.data_ptr(), b, s, hk, g,
                 d, torch.cuda.current_stream(qq.device).cuda_stream)
    _build.check(err, "q8 scores")
    _build.KERNEL_LAUNCHES["q8_dot"] += 1
    return out


def values_cuda(pq: torch.Tensor, v_q: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (after a memset of the output: one launch a
    pass of at most 16 query rows)."""
    pq, v_q = pq.contiguous(), v_q.contiguous()
    b, s, hk, g, d = _check(pq, v_q, "q8 values", 0)
    out = torch.empty((b, hk, g, d), dtype=torch.int32, device=pq.device)
    launches = ctypes.c_int(0)
    fn = _build.function("q8_dot", "q8_values_launch", _VALUES_ARGTYPES)
    with torch.cuda.device(pq.device):
        err = fn(pq.data_ptr(), v_q.data_ptr(), out.data_ptr(), b, s, hk, g,
                 d, ctypes.addressof(launches),
                 torch.cuda.current_stream(pq.device).cuda_stream)
    _build.KERNEL_LAUNCHES["q8_dot"] += launches.value
    _build.check(err, "q8 values")
    return out
