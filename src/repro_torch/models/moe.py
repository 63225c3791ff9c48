"""Mixture-of-Experts FFN with expert parallelism (``repro/models/moe.py``).

Each token routes to its top-k experts; a capacity-bucketed dispatch — the
same static-shape compaction idiom the coloring engine uses for worklists
— puts at most ``capacity`` tokens in each expert's buffer (later tokens
are dropped, standard capacity-factor semantics), one batched product per
projection computes every expert, and the combine adds each kept token's
gated expert outputs back.

The mesh form (``moe_ffn(mesh=...)``, a ``launch.mesh.DeviceMesh``) is the
reference's ``shard_map`` branch run shard by shard from one controller:
the tokens split over ``batch_axes``, each data shard's capacity taken
from its own token count; on each model shard's device the router runs on
the data shard's tokens and the shard computes its ``n_experts / n_model``
experts (``e_offset = m * e_local``), their ``ff`` dimension gathered over
``fsdp_axes`` (``launch.mesh.gather_experts``); the combine sums the model
shards' outputs in model order (the reference's ``psum``) and ``aux`` is
the mean over data shards (its ``pmean``). Shards may share a device. A
multi-process backend, where the transfers become NCCL collectives, is
ROADMAP Queue A item 13.

On the card the combine's ``index_add_`` sums in an order that changes
from run to run, so its result is held to a float tolerance, not bit for
bit; the routing (expert ids, slots and keep flags) is exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import (EXPERT_FF_AXIS, data_shards,
                                     gather_experts, split_batch)
from repro_torch.obs import opcost_hooks


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
    routing = dispatch(eids, e_offset=e_offset, e_local=e_local,
                       capacity=capacity)
    return _experts(xt, gates, routing, w_in, w_gate, w_out,
                    e_local=e_local, capacity=capacity)


def _experts(xt, gates, routing, w_in, w_gate, w_out, *, e_local: int,
             capacity: int) -> torch.Tensor:
    """``expert_compute`` after its dispatch: ``routing`` is
    ``dispatch``'s (token, keep, slot) of each pair."""
    t, d = xt.shape
    flat_tok, keep, slot = routing
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


class Route(NamedTuple):
    """One model shard's routing of one data shard's tokens, on the
    shard's device: the router's output, ``dispatch``'s (token, keep, slot)
    of each pair for the shard's experts, and the sizes it used."""

    model: int
    device: torch.device
    xt: torch.Tensor
    gates: torch.Tensor
    eids: torch.Tensor
    aux: torch.Tensor
    flat_tok: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    e_offset: int
    e_local: int
    capacity: int


def shard_routes(x_l: torch.Tensor, router: torch.Tensor, cfg: MoESettings,
                 mesh, data: dict, *, model_axis: str = "model") -> list:
    """The ``Route`` of each model shard (in model order) for the tokens
    ``x_l`` (B_l, S, d) of the data shard at coordinates ``data``. The
    router runs once on each distinct device of the model shards (shards
    that share a device share its result: the same function of the same
    numbers); the capacity is that of the local token count."""
    b, s, d = x_l.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    n_model = mesh.shape[model_axis]
    e_local = e // n_model
    assert e_local * n_model == e, (e, n_model)
    capacity = _capacity(t, k, e, cfg.capacity_factor)
    routed: dict = {}
    out = []
    for m in range(n_model):
        dev = mesh.device(**data, **{model_axis: m})
        if dev not in routed:
            xt = x_l.reshape(t, d).to(dev)
            routed[dev] = (xt, *router_topk(xt, router.to(dev), k))
        xt, gates, eids, aux = routed[dev]
        e_off = m * e_local
        with opcost_hooks.shard({model_axis: m}):
            routing = dispatch(eids, e_offset=e_off, e_local=e_local,
                               capacity=capacity)
        out.append(Route(m, dev, xt, gates, eids, aux, *routing, e_off,
                         e_local, capacity))
    return out


def moe_shard(x_l: torch.Tensor, p: dict, cfg: MoESettings, mesh,
              data: dict, *, model_axis: str = "model",
              fsdp_axes: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """One data shard of the mesh form: its tokens ``x_l`` (B_l, S, d)
    through every model shard's experts (the ``ff`` slices gathered onto
    the shard's device), the outputs summed in model order on ``x_l``'s
    device. Returns (out (B_l, S, d), the data shard's aux), both on
    ``x_l``'s device. ``p``'s expert weights are full tensors or
    ``launch.mesh.place_params``' ``ExpertShards``."""
    home = x_l.device
    routes = shard_routes(x_l, p["router"], cfg, mesh, data,
                          model_axis=model_axis)
    out = None
    axis = (model_axis,)
    for r in routes:
        with opcost_hooks.shard({model_axis: r.model}):
            w = [gather_experts(p[name], r.model, mesh,
                                model_axis=model_axis, fsdp_axes=fsdp_axes,
                                ff_axis=EXPERT_FF_AXIS[name], device=r.device)
                 for name in ("we_in", "we_gate", "we_out")]
            # the op counter's record of the reference's collectives: the
            # tokens are replicated over the model axis (no transfer; the
            # gradient pass sums their gradient over it), the outputs are
            # summed over it (its psum, and the psum its gradient pass
            # makes of that sum's gradient)
            xt = opcost_hooks.collective(r.xt, None, axis, back="all-reduce")
            y = _experts(xt, r.gates, (r.flat_tok, r.keep, r.slot), *w,
                         e_local=r.e_local, capacity=r.capacity)
            y = opcost_hooks.collective(y, "all-reduce", axis,
                                        back="all-reduce").to(home)
        out = y if out is None else out + y
    # every model shard routes the same tokens: one aux a data shard, the
    # reference's pmean over the batch and model axes
    aux = opcost_hooks.collective(routes[0].aux, "all-reduce",
                                  tuple(data) + axis, back="all-reduce")
    return out.reshape(x_l.shape), aux.to(home)


def moe_ffn(x: torch.Tensor, p: dict, cfg: MoESettings, *, mesh=None,
            model_axis: str = "model", batch_axes: tuple = (),
            fsdp_axes: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar). With a ``mesh``
    (``launch.mesh.DeviceMesh``), the expert-parallel form: each data
    shard's block of the batch on its home device (``moe_shard``), the
    outputs back on ``x``'s device in batch order, ``aux`` their mean."""
    if mesh is None:
        b, s, d = x.shape
        t = b * s
        xt = x.reshape(t, d)
        gates, eids, aux = router_topk(xt, p["router"], cfg.top_k)
        capacity = _capacity(t, cfg.top_k, cfg.n_experts,
                             cfg.capacity_factor)
        out = expert_compute(xt, gates, eids, p["we_in"], p["we_gate"],
                             p["we_out"], e_offset=0, e_local=cfg.n_experts,
                             capacity=capacity)
        return out.reshape(b, s, d), aux
    shards = data_shards(mesh, batch_axes)
    outs, auxs = [], []
    for (coords, dev), x_l in zip(shards, split_batch(x, len(shards))):
        with opcost_hooks.shard(coords):
            y, aux = moe_shard(x_l.to(dev), p, cfg, mesh, coords,
                               model_axis=model_axis, fsdp_axes=fsdp_axes)
        outs.append(y.to(x.device))
        auxs.append(aux.to(x.device))
    return torch.cat(outs), torch.stack(auxs).mean()
