"""One training step on the card against the same step on the CPU, for
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` (imports torch only).

Both run ``launch/train.py::build_step`` once from the same parameters,
optimizer state and batch, in fp32 with TF32 off. Held:

* the loss and the grad norm within ``REL`` relative (``REL_COMPRESSED``
  for the grad norm of a compressed step);
* every m and v leaf within ``REL`` of the leaf's largest magnitude, plus
  one int8 quantum (1/127 of it) a compressed step may move an entry by
  where its rounding falls the other way (twice that for v, a square);
* every parameter within ``PARAM_REL`` of the leaf's largest magnitude
  (at least 1), except where the CPU's m is within noise of zero (``REL``
  of the leaf's largest, plus the quantum): there Adam's step moves an
  entry by about ±lr whichever sign the noise gave the gradient, so those
  entries are held to ``2 lr (1 + wd |p|)`` and counted (``flipped``).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

REL = 1e-4
REL_COMPRESSED = 1e-3
PARAM_REL = 1e-6
QUANTUM = 1 / 127


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def step_gaps(card: tuple, cpu: tuple, *, wd: float,
              compressed: bool = False, state_rel: float = REL) -> dict:
    """``card`` and ``cpu`` are each (params, opt, metrics) after the step.
    Returns the gaps and raises AssertionError past a tolerance.
    ``state_rel`` takes the place of ``REL`` for m and v (bf16 state can
    round an entry to its neighbouring bf16 value)."""
    (cp, co, cm), (wp, wo, wm) = card, cpu
    q = QUANTUM if compressed else 0.0
    gaps = {"loss": _rel(cm["loss"].cpu(), wm["loss"]),
            "grad_norm": _rel(cm["grad_norm"].cpu(), wm["grad_norm"]),
            "m": 0.0, "v": 0.0, "params": 0.0, "flipped": 0,
            "flip_lr": 0.0}
    lr = float(wm["lr"])
    for name, tol in (("m", state_rel + q), ("v", state_rel + 2 * q)):
        for a, b in zip(tree_leaves(getattr(co, name)),
                        tree_leaves(getattr(wo, name))):
            g = _rel(a.cpu(), b)
            gaps[name] = max(gaps[name], g)
            if not g <= tol:
                raise AssertionError(f"{name}: {g} of the leaf's largest")
    for a, b, m in zip(tree_leaves(cp), tree_leaves(wp), tree_leaves(wo.m)):
        a = a.detach().cpu().float()
        b = b.detach().float()
        gap = (a - b).abs()
        scale = max(1.0, float(b.abs().max()))
        noise = m.abs() <= (state_rel + q) * float(m.abs().max())
        near = gap[~noise]
        if near.numel():
            gaps["params"] = max(gaps["params"], float(near.max()) / scale)
        far = gap[noise]
        if far.numel():
            bound = 2 * lr * (1 + wd * b[noise].abs()) + PARAM_REL * scale
            if not bool((far <= bound).all()):
                raise AssertionError("a parameter moved past one step")
            flipped = far > PARAM_REL * scale
            gaps["flipped"] += int(flipped.sum())
            if flipped.any():
                gaps["flip_lr"] = max(gaps["flip_lr"],
                                      float(far[flipped].max()) / lr)
    limits = {"loss": REL, "grad_norm": REL_COMPRESSED if compressed else REL,
              "params": PARAM_REL}
    for k, tol in limits.items():
        if not gaps[k] <= tol:
            raise AssertionError(f"{k}: card {gaps[k]} from the CPU "
                                 f"(tolerance {tol})")
    return gaps


def to_device(tree, dev):
    """A copy of a tree of tensors on ``dev``."""
    return tree_map(lambda v: v.detach().to(dev, copy=True), tree)
