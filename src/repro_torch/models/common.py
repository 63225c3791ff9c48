"""Shared model building blocks (``repro/models/common.py``).

Parameters are plain nested dicts of tensors. Every parameter has a
parallel *logical axis* annotation (a tuple of axis names) produced
alongside init, as in the reference, so the two trees never drift.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

Params = dict
Axes = dict

#: the largest fp32 temporary ``ParamFactory.dense`` draws at once
#: (elements; 256 MiB): a stacked ``(L, ...)`` parameter is drawn a layer
#: slice at a time, and a large 2-D one a block of rows at a time
_DRAW_ELEMENTS = 1 << 26


class ParamFactory:
    """Collects (init, logical-axes) pairs so init and specs never drift.

    ``generator`` is the explicit ``torch.Generator`` every draw takes, on
    ``device`` (None: the CUDA device, which must exist; pass ``"cpu"``
    for the CPU; the generator's device must be this one).
    ``device="meta"`` returns tensors without storage instead of values —
    the reference's ``abstract=True``: a 340B-parameter tree costs nothing
    to "init"."""

    def __init__(self, generator: "torch.Generator | None",
                 dtype=torch.bfloat16, device=None):
        self.generator = generator
        self.dtype = dtype
        meta = device is not None and torch.device(device).type == "meta"
        self.device = torch.device("meta") if meta else resolve_device(device)

    @property
    def abstract(self) -> bool:
        return self.device.type == "meta"

    def dense(self, shape, axes, *, scale: "float | None" = None,
              dtype=None) -> tuple[torch.Tensor, tuple]:
        """A truncated normal on (-2, 2), times ``scale`` (default
        ``1/sqrt(fan_in)``, fan_in the second-to-last dim), drawn in fp32
        and cast. Drawn a slice along dim 0 at a time (at most
        ``_DRAW_ELEMENTS`` fp32 values), so the fp32 temporary stays the
        size of one layer."""
        assert len(axes) == len(shape), (shape, axes)
        dt = dtype or self.dtype
        out = torch.empty(shape, dtype=dt, device=self.device)
        if self.abstract:
            return out, tuple(axes)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        per_row = math.prod(shape[1:]) if len(shape) > 1 else 1
        step = max(1, _DRAW_ELEMENTS // max(per_row, 1))
        for lo in range(0, shape[0], step):
            hi = min(lo + step, shape[0])
            w = torch.empty((hi - lo,) + tuple(shape[1:]),
                            dtype=torch.float32, device=self.device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.generator)
            out[lo:hi] = (w * scale).to(dt)
        return out, tuple(axes)

    def zeros(self, shape, axes, dtype=None) -> tuple[torch.Tensor, tuple]:
        return (torch.zeros(shape, dtype=dtype or self.dtype,
                            device=self.device), tuple(axes))

    def ones(self, shape, axes, dtype=None) -> tuple[torch.Tensor, tuple]:
        return (torch.ones(shape, dtype=dtype or self.dtype,
                           device=self.device), tuple(axes))


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], tuple)


def split_tree(tree_of_pairs) -> tuple[Params, Axes]:
    """Split a nested dict of (tensor, axes) leaves into (params, axes)."""
    if _is_pair(tree_of_pairs):
        return tree_of_pairs
    params, axes = {}, {}
    for k, v in tree_of_pairs.items():
        params[k], axes[k] = split_tree(v)
    return params, axes


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32, scaled by ``1 + gamma``, cast back."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def activation(name: str, x: torch.Tensor,
               gate: "torch.Tensor | None" = None) -> torch.Tensor:
    """Gated (GLU-family) or plain activations. ``gate`` is the linear half."""
    if name == "swiglu":
        return F.silu(x) * gate
    if name == "geglu":
        return F.gelu(x, approximate="tanh") * gate
    if name == "relu2":                      # nemotron squared-ReLU (ungated)
        r = F.relu(x)
        return r * r
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: "torch.Tensor | None" = None) -> torch.Tensor:
    """Mean token CE in fp32. logits (..., V), labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()
