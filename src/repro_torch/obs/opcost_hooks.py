"""The op counter's hooks: the calls the kernels' wrappers and the models'
mesh forms make for ``launch/opcost.py``'s ``OpCost``.

Each does nothing, or returns its argument, unless a counter runs. They
live here, below the kernels and the models, so that those need not
import the launcher; a counter enters ``push`` and leaves ``pop``.
"""
from __future__ import annotations

import contextlib

import torch

_STACK: list = []


def push(counter) -> None:
    _STACK.append(counter)


def pop(counter) -> None:
    _STACK.remove(counter)


def active():
    """The innermost counter running, None outside every one."""
    return _STACK[-1] if _STACK else None


def shard(coords: dict):
    """Enter one shard of a mesh form: its coordinates, e.g. ``{"data":
    3}``, nested contexts adding theirs."""
    c = active()
    return c.shard(coords) if c is not None else contextlib.nullcontext()


def collective(t: torch.Tensor, kind: "str | None", axes,
               back: "str | None" = None) -> torch.Tensor:
    """One collective of ``kind`` moving ``t``'s bytes a device over the
    mesh ``axes``, made by the current shard (nothing when ``kind`` is
    None: a tensor every shard on ``axes`` holds already); when ``t``
    takes a gradient and ``back`` is given, the gradient pass's collective
    ``back`` of the gradient's bytes is recorded for the same shard (an
    all-gather's reduce-scatter, a replicated input's all-reduce), and a
    parameter leaf read so is left to these records (``OpCost``'s
    ``add_grad_sync`` adds nothing for it). Returns ``t``."""
    c = active()
    if c is None:
        return t
    if kind is not None:
        c.record(kind, t.numel() * t.element_size(), axes)
    if back is None or not (t.requires_grad and torch.is_grad_enabled()):
        return t
    c.grad_recorded(t)
    return _Back.apply(t, c, back, tuple(axes), c.context)


class _Back(torch.autograd.Function):
    """Identity whose backward records the gradient pass's collective."""

    @staticmethod
    def forward(ctx, t, counter, kind, axes, shard_ctx):
        ctx.info = (counter, kind, axes, shard_ctx)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        counter, kind, axes, shard_ctx = ctx.info
        counter.record_at(kind, g.numel() * g.element_size(), axes,
                          shard_ctx)
        return g, None, None, None, None


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation of a
    checkpointed function, which autograd runs in the gradient pass after
    the mesh forms' loops have ended, runs in the shard context of its
    first run."""
    c = active()
    if c is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), c.restore(c.context)


def kernel_call(name: str, fn, *args, flops: "dict | None" = None, **kw):
    """``fn(*args, **kw)``, one call of a kernel wrapper: counted as one op
    of its tensor operands' and outputs' bytes when a counter runs (the
    ATen ops inside are not counted), and of ``flops`` ({operand type
    name: FLOPs}, e.g. ``{"int8": n}``) where the kernel's products are
    FLOPs the counter should price."""
    c = active()
    if c is None:
        return fn(*args, **kw)
    return c.kernel(name, fn, args, kw, flops or {})
