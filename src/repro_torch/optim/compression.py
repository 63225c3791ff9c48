"""Gradient compression for cross-replica reduction
(``repro/optim/compression.py``).

int8 row-wise-scaled quantisation with error feedback: each replica
quantises (its gradient + its error feedback) to int8 with one absmax
scale a leading-dim row, the int8 payloads are summed in int32 and the
scales averaged, and each replica keeps its quantisation residual as the
next step's error feedback.

The reference reduces over a mesh axis inside a ``shard_map``; here the
replicas are a list of gradient trees, each on its device (several may
share one), as ``core/distributed.py`` runs its shards: the single
controller sums them. A reduction across processes waits for the NCCL
backend (ROADMAP Queue A item 13).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class CompressState(NamedTuple):
    error: dict          # residual feedback, same tree as grads (fp32)


def compress_init(grads_like) -> CompressState:
    return CompressState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise (leading-dim) absmax int8 quantisation: (q int8 (R, n),
    scale fp32 (R, 1))."""
    flat = x.reshape(x.shape[0], -1) if x.ndim > 1 else x.reshape(1, -1)
    amax = flat.abs().amax(dim=1, keepdim=True)
    # a 0-dim divisor on the tensor's device: true division on the card
    # too (a host scalar divides there as a multiply by its reciprocal)
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(flat / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    return (q.float() * scale).reshape(shape)


def compressed_psum(grads: list, errs: list) -> tuple[dict, list]:
    """Quantise each replica's (grad + error feedback), sum the int8
    payloads in int32, average the scales, dequantise.

    ``grads`` holds one gradient tree a replica and ``errs`` one
    ``CompressState`` a replica (as ``compress_init`` makes it), each on
    its replica's device. Returns (the fp32 gradients averaged over the
    replicas, on the first replica's device; one new ``CompressState`` a
    replica, on its device)."""
    n = len(grads)
    if n != len(errs) or n == 0:
        raise ValueError(f"{len(grads)} gradient trees and {len(errs)} "
                         "error states: one of each a replica")
    dev = tree_leaves(grads[0])[0].device
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e.error) for e in errs]
    reduced, new_errs = [], [[] for _ in range(n)]
    for i, g0 in enumerate(flat_g[0]):
        red = s_red = None
        for r in range(n):
            g32 = flat_g[r][i].float() + flat_e[r][i]
            q, s = quantize_int8(g32)
            new_errs[r].append(g32 - dequantize_int8(q, s, g32.shape))
            q, s = q.to(dev, torch.int32), s.to(dev)
            red = q if red is None else red + q
            s_red = s if s_red is None else s_red + s
        s_red = s_red / n
        reduced.append((red.float() * s_red / n).reshape(g0.shape))
    return tree_unflatten(grads[0], reduced), \
        [CompressState(error=tree_unflatten(grads[0], e)) for e in new_errs]
