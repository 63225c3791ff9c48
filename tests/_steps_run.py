"""One smoke case of ``launch/steps.py`` against the reference's same
case function (``tests/_steps_ref.py``), for ``tests/test_torch_steps_run
*.py``: the port's case drawn on the CPU from ``_case_check.SEED`` (its
weights from the family's ``init_params``, its inputs in their consumers'
ranges), the reference's case filled with the same values leaf for leaf,
one step of each (the reference's jitted), and the port's output held
against the reference's.

Tolerances: the LM, serving and coloring cases as ``_case_check.compare``
holds the card to the CPU (``tests/_train_check.py``'s for a training
step, the coloring exactly); the GNN and DLRM training steps as
``tests/_gnn_ref.py`` holds the models (the loss 1e-5 relative, each m
and v leaf ``leaf_tol`` of its largest, v twice that, each parameter
1e-6); DLRM serving within ``SERVE_TOL``.
"""
from __future__ import annotations

import jax
import numpy as np

from _case_check import SHAPES, compare, smoke_case
from _gnn_steps import LOSS_RTOL, PARAM_TOL, leaf_tol
from _steps_ref import (fill, from_reference, one_device_mesh,
                        reference_case)


def run_pair(jsteps, spec: tuple) -> tuple:
    """(port case, port output, reference output in the port's
    structure) of one step of the smoke case ``spec``."""
    arch, key, variant = spec
    case = smoke_case(spec, "cpu")
    jcase = reference_case(jsteps, arch, SHAPES[key], variant)
    assert jcase.meta == case.meta and jcase.donate == case.donate
    with jax.set_mesh(one_device_mesh()):
        jout = jax.jit(jcase.fn)(*fill(jcase.args, case.args))
    got = case.fn(*case.args)
    return case, got, from_reference(jout, got)


def _rel(a, b) -> float:
    a, b = a.detach().float().numpy(), b.detach().float().numpy()
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def train_gaps(got: tuple, want: tuple) -> dict:
    """A GNN or DLRM training step's (params, opt, metrics) against the
    reference's."""
    (gp, go, gm), (wp, wo, wm) = got, want
    gaps = {"loss": abs(float(gm["loss"]) - float(wm["loss"]))
            / abs(float(wm["loss"]))}
    assert gaps["loss"] <= LOSS_RTOL, gaps
    assert int(go.step) == int(wo.step) == 1
    for what, mult in (("m", 1), ("v", 2)):
        for name, a in getattr(go, what).items():
            gap = _rel(a, getattr(wo, what)[name])
            gaps[what] = max(gaps.get(what, 0.0), gap)
            assert gap <= mult * leaf_tol(name), (what, name, gap)
    for name, a in gp.items():
        gap = float((a.detach() - wp[name]).abs().max())
        gaps["params"] = max(gaps.get("params", 0.0), gap)
        assert gap <= PARAM_TOL, (name, gap)
    return gaps


def check_pair(jsteps, spec: tuple) -> dict:
    case, got, want = run_pair(jsteps, spec)
    if case.meta["kind"] in ("gnn_train", "gnn_minibatch", "rs_train"):
        return train_gaps(got, want)
    return compare(case, got, want)
