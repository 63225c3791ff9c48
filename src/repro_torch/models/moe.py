"""Mixture-of-Experts FFN (``repro/models/moe.py``).

Each token routes to its top-k experts; a capacity-bucketed dispatch — the
same static-shape compaction idiom the coloring engine uses for worklists
— puts at most ``capacity`` tokens in each expert's buffer (later tokens
are dropped, standard capacity-factor semantics), one batched product per
projection computes every expert, and the combine adds each kept token's
gated expert outputs back.

Only the single-device form is ported (``mesh=None``): the reference's
expert-parallel ``shard_map`` branch waits for the multi-card backend
(ROADMAP Queue A item 13). On the card the combine's ``index_add_`` sums
in an order that changes from run to run, so its result is held to a
float tolerance, not bit for bit; the routing (expert ids, slots and keep
flags) is exact.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    cap = math.ceil(tokens * top_k * cf / n_experts)
    return max(8, -(-cap // 8) * 8)


def router_topk(x2d: torch.Tensor, w_router: torch.Tensor, top_k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T,k) fp32, expert ids (T,k) int32, aux loss scalar).

    ``torch.topk`` returns the k largest in descending order, as
    ``jax.lax.top_k`` does; equal probabilities (which random routers do
    not give) may come in another order."""
    logits = x2d.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    e = w_router.shape[-1]
    flat = eids.reshape(-1)
    f = torch.zeros(e, dtype=torch.float32, device=x2d.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / (eids.shape[0] * top_k),
                            dtype=torch.float32, device=x2d.device))
    aux = e * torch.sum(f * probs.mean(dim=0))
    return gates, eids.to(torch.int32), aux


def dispatch(eids: torch.Tensor, *, e_offset: int, e_local: int,
             capacity: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The capacity-bucketed routing of ``expert_compute``: per (token,
    choice) pair in token order, its token, whether it is kept, and its
    buffer slot (``expert * capacity + position``, ``e_local * capacity``
    when dropped). Positions follow a cumulative count down the pairs,
    the reference's order."""
    t, k = eids.shape
    dev = eids.device
    flat_e = eids.reshape(-1).long() - e_offset                 # (T*k,)
    ok = (flat_e >= 0) & (flat_e < e_local)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    onehot = ok[:, None] & (flat_e[:, None]
                            == torch.arange(e_local, device=dev)[None, :])
    pos = torch.cumsum(onehot.to(torch.int32), dim=0) - 1       # (T*k, El)
    pos_of = torch.where(onehot, pos, 0).sum(dim=1)             # (T*k,)
    keep = ok & (pos_of < capacity)
    slot = torch.where(keep, flat_e * capacity + pos_of, e_local * capacity)
    return flat_tok, keep, slot


def expert_compute(xt: torch.Tensor, gates: torch.Tensor, eids: torch.Tensor,
                   w_in: torch.Tensor, w_gate: torch.Tensor,
                   w_out: torch.Tensor, *, e_offset: int, e_local: int,
                   capacity: int) -> torch.Tensor:
    """Capacity-bucketed dispatch -> batched expert matmul -> combine.

    xt (T, d); w_in/w_gate (El, d, f); w_out (El, f, d). Static shapes
    throughout; overflow tokens beyond ``capacity`` per expert are dropped.
    Experts are gated (SwiGLU).
    """
    t, d = xt.shape
    flat_tok, keep, slot = dispatch(eids, e_offset=e_offset,
                                    e_local=e_local, capacity=capacity)
    buf = torch.zeros((e_local * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf[slot] = xt[flat_tok]          # dropped pairs land in the cut row
    buf = buf[:-1].reshape(e_local, capacity, d)

    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    h = F.silu(h) * g
    y = torch.bmm(h, w_out).reshape(e_local * capacity, d)

    gathered = y[torch.where(keep, slot, 0)] * keep[:, None].to(y.dtype)
    scale = gates.reshape(-1)[:, None].to(y.dtype)
    return torch.zeros((t, d), dtype=y.dtype, device=y.device).index_add_(
        0, flat_tok, gathered * scale)


def moe_ffn(x: torch.Tensor, p: dict, cfg: MoESettings, *, mesh=None,
            model_axis: str = "model", batch_axes: tuple = (),
            fsdp_axes: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar)."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel MoE (a mesh) is not ported: it waits for "
            "the multi-card backend (ROADMAP Queue A item 13); pass "
            "mesh=None")
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, eids, aux = router_topk(xt, p["router"], cfg.top_k)
    capacity = _capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    out = expert_compute(xt, gates, eids, p["we_in"], p["we_gate"],
                         p["we_out"], e_offset=0, e_local=cfg.n_experts,
                         capacity=capacity)
    return out.reshape(b, s, d), aux
