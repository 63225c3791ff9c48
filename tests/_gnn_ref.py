"""The reference's side of the GNN/DLRM parity tests: its params carried
across (``params_from_numpy``), its batches as the port's tensors, one
jitted value-and-gradient + AdamW step, and the comparison of the port's
step against it.

Tolerances, ``tests/_gnn_steps.py``'s (those ``tests/test_torch_train.py``
holds the LMs to): the loss within 1e-5 relative; each gradient leaf, and
each m and v leaf after the step, within ``GRAD_TOL`` (1e-4) of the
reference's, relative to the leaf's largest magnitude (fp32 sums in
another order than XLA's; v, a square, twice that); each parameter after
the step within ``PARAM_TOL`` (1e-6) absolute: the default
``AdamWConfig``'s first step moves a parameter by at most its warmed-up
lr, 3e-6. EquiformerV2's attention query and key weights are held to
``ATTN_GRAD_TOL`` (1e-3): their gradient is a difference of nearly equal
softmax terms, and the reference's own fp32 gradient lies 2.2e-4 from the
port's fp64 one (the port's fp32 7.7e-5 from it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro_torch.models.common import params_from_numpy
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.tree import tree_leaves

from _gnn_steps import LOSS_RTOL, PARAM_TOL, leaf_tol


def to_torch_params(jp) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def to_torch(x):
    """A jax array (or a GraphBatch of them) as CPU tensors."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return GraphBatch(*[v if v is None or isinstance(v, int)
                            else to_torch(v) for v in x])
    return torch.from_numpy(np.array(x))


def jax_step(loss, params):
    """The reference's ``value_and_grad`` of ``loss(params)`` and one
    ``adamw_update`` with the default ``AdamWConfig``, jitted: (loss,
    grads, new params, new opt state) as numpy trees."""
    def step(p):
        value, grads = jax.value_and_grad(loss)(p)
        new_p, new_o, _ = jadamw_update(grads, jadamw_init(p), p,
                                        JAdamWConfig())
        return value, grads, new_p, new_o
    out = jax.jit(step)(params)
    return jax.tree.map(np.asarray, out)


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.detach().numpy() - want).max()) / scale


def assert_tree_close(got: dict, want: dict, what: str = "grad",
                      mult: float = 1.0) -> float:
    """Every leaf of ``got`` within ``mult`` times its ``leaf_tol`` of
    ``want``'s leaf, relative to its largest magnitude; the same names and
    shapes. Returns the worst."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(paths) == len(leaves)
    worst = 0.0
    for (path, a), b in zip(paths, leaves):
        assert tuple(b.shape) == a.shape, (what, path)
        err = _rel(b, a)
        assert err <= mult * leaf_tol(path[0].key), (what, path, err)
        worst = max(worst, err)
    return worst


def assert_step_matches(ref, loss, grads, params, opt) -> None:
    """The port's (loss, grads) and, after its AdamW step, params and opt
    state against ``jax_step``'s output ``ref``."""
    jl, jg, jp, jo = ref
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert_tree_close(grads, jg)
    assert_tree_close(opt.m, jo.m, what="m")
    assert_tree_close(opt.v, jo.v, what="v", mult=2.0)
    assert int(opt.step) == int(jo.step) == 1
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            tree_leaves(params)):
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0,
                                   atol=PARAM_TOL, err_msg=str(path))
