"""AdamW over (possibly bf16) model params (``repro/optim/adamw.py``).

The reference's arithmetic: the step math in fp32, with no fp32 master
copy, and each parameter cast back to its own dtype, so bf16 parameters
are rounded every step; m and v are stored in ``state_dtype``. The state
is a tree mirroring the params (an ``AdamWState`` NamedTuple, so a
checkpoint names its leaves as the reference's does).

The update runs as in-place tensor ops under ``torch.no_grad()``: the
params and the m and v trees are written in place and returned, and no
fp32 copy of a whole stack is made when ``update_in_chunks`` walks each
big leaf's layer axis. (``torch.optim.AdamW`` would compute bf16
parameters in bf16 and order the schedule otherwise.) The step counter,
the learning rate and the clip scale are 0-dim tensors on the params'
device: an update never reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

#: the most elements ``global_norm`` squares in fp32 at once (a block of
#: rows of a large leaf; 256 MiB)
_NORM_BLOCK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # m/v storage dtype; bf16 halves the optimizer's memory
    state_dtype: Any = torch.float32
    # walk the leading (layer-stack) axis of big leaves, so that the fp32
    # update transients are per-layer slices, not whole stacks
    update_in_chunks: bool = False


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32
    m: dict
    v: dict


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    """Zero m and v in ``state_dtype`` beside each parameter, step 0."""
    leaf = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                         device=p.device), params))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine decay to ``min_lr_ratio``; fp32, on
    the step's device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares of ``x``, a block of rows at a time (at
    most ``_NORM_BLOCK`` fp32 values); ``x`` is only read."""
    if x.ndim == 0 or x.numel() <= _NORM_BLOCK:
        return x.float().square().sum()
    rows = max(1, _NORM_BLOCK // max(x[0].numel(), 1))
    return torch.stack([b.float().square().sum()
                        for b in x.split(rows)]).sum()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.stack([_sum_squares(x)
                        for x in tree_leaves(tree)]).sum().sqrt()


def _upd(g, m, v, p, cfg: AdamWConfig, scale, lr, b1c, b2c) -> None:
    """One leaf (or layer slice) in place; two fp32 temporaries of its
    size."""
    g32 = g.to(torch.float32, copy=True).mul_(scale)   # grads stay as given
    m32 = m.float()
    v32 = v.float()
    m32.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
    v32.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
    tmp = g32                                    # g32 is no longer needed
    torch.div(v32, b2c, out=tmp).sqrt_().add_(cfg.eps)
    delta = torch.div(m32, b1c).div_(tmp)
    p32 = tmp.copy_(p)
    delta.add_(p32, alpha=cfg.weight_decay).mul_(lr)
    p.copy_(p32.sub_(delta))
    if m32.data_ptr() != m.data_ptr():
        m.copy_(m32)
    if v32.data_ptr() != v.data_ptr():
        v.copy_(v32)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig
                 ) -> tuple[dict, AdamWState, dict]:
    """One AdamW step with global-norm clipping. Writes ``params`` and
    ``state.m``/``state.v`` in place and returns them, with the new step
    and ``{"lr", "grad_norm"}`` (0-dim fp32 tensors)."""
    gn = global_norm(grads)
    scale = torch.clamp(gn.new_full((), cfg.grad_clip)
                        / torch.clamp(gn, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        if cfg.update_in_chunks and p.ndim >= 3 and p.shape[0] > 1:
            for i in range(p.shape[0]):
                _upd(g[i], m[i], v[i], p[i], cfg, scale, lr, b1c, b2c)
        else:
            _upd(g, m, v, p, cfg, scale, lr, b1c, b2c)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gn}
