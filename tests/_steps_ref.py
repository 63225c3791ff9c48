"""The reference's ``repro.launch.steps`` for the step builders' parity
tests (``tests/test_torch_steps_*.py``).

The module imports ``repro.dist.sharding``, which the reference does not
have. ``reference_steps`` puts a stand-in for it into ``sys.modules`` for
the duration of one test (``monkeypatch.setitem``) and imports the module
afresh; the test's end takes both out again. The stand-in decides only
shardings: the mesh-axis rules (the batch and the FSDP ``embed`` axis
over ``data``, no expert ``ff`` rule) and a replicated ``NamedSharding``
for every parameter, all of which collapse on the one-device mesh the
tests build. The port carries no shardings (``steps.Case`` records its
mesh and axes instead), so nothing the tests compare depends on them.
Nothing under ``src/repro/`` changes.

``reference_case`` builds the reference's case for a smoke config and a
``ShapeSpec``, ``fill`` gives it the port's arguments leaf for leaf, and
``from_reference`` turns its outputs into the port's structure.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro_torch.launch import steps as tsteps


def _stand_in() -> dict:
    pkg = types.ModuleType("repro.dist")
    pkg.__path__ = []
    shd = types.ModuleType("repro.dist.sharding")

    def make_rules(multi_pod: bool = False) -> dict:
        return {"_batch": ("data",), "embed": ("data",), "expert_ff": None}

    def tree_shardings(axes, mesh, rules):
        return jax.tree.map(lambda _: NamedSharding(mesh, P()), axes,
                            is_leaf=lambda x: isinstance(x, tuple))

    shd.make_rules = make_rules
    shd.tree_shardings = tree_shardings
    pkg.sharding = shd
    return {"repro.dist": pkg, "repro.dist.sharding": shd}


def reference_steps(monkeypatch):
    """Yields ``repro.launch.steps``, imported with the stand-in in
    ``sys.modules``; afterwards the module is dropped again."""
    import repro.launch as launch
    for name, mod in _stand_in().items():
        monkeypatch.setitem(sys.modules, name, mod)
    sys.modules.pop("repro.launch.steps", None)
    try:
        yield importlib.import_module("repro.launch.steps")
    finally:
        sys.modules.pop("repro.launch.steps", None)
        if hasattr(launch, "steps"):
            delattr(launch, "steps")


def one_device_mesh():
    """The (1, 1) ``("data", "model")`` mesh with automatic axes (the
    reference's transformer and EquiformerV2 constrain shardings, which
    needs a mesh in context: ``jax.set_mesh``)."""
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def reference_case(jsteps, arch_id: str, shape, variant: str = "base",
                   smoke: bool = True):
    """The reference's case for ``arch_id`` (its smoke config unless
    ``smoke`` is False) at ``shape`` (a ``ShapeSpec`` of either package),
    dispatched as its ``build_case`` dispatches, on a (1, 1) mesh."""
    from repro.configs import get_arch
    arch = get_arch(arch_id)
    if smoke:
        arch = dataclasses.replace(arch, make_config=arch.make_smoke)
    mesh = one_device_mesh()
    rules = sys.modules["repro.dist.sharding"].make_rules()
    if arch.family == "lm":
        if shape.kind == "train":
            return jsteps.lm_train_case(arch, shape, mesh, rules)
        if shape.kind == "prefill":
            return jsteps.lm_prefill_case(arch, shape, mesh, rules)
        return jsteps.lm_decode_case(arch, shape, mesh, rules,
                                     variant=variant)
    if arch.family == "gnn":
        if shape.kind == "gnn_minibatch":
            return jsteps.gnn_minibatch_case(arch, shape, mesh, rules)
        return jsteps.gnn_full_case(arch, shape, mesh, rules,
                                    molecule=shape.kind == "gnn_molecule",
                                    variant=variant)
    if arch.family == "recsys":
        return jsteps.dlrm_case(arch, shape, mesh, rules)
    return jsteps.ipgc_case(arch, shape, mesh, rules)


def leaf_paths(tree) -> dict:
    """{keystr path: leaf} of a reference tree."""
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_paths(tree) -> dict:
    """{path: leaf} of a port tree, spelled as ``leaf_paths`` spells it."""
    return {"".join(p): x for p, x in tsteps.flatten_args(tree)}


def to_numpy(t) -> np.ndarray:
    """A tensor as a NumPy array; bf16 as ``jnp.bfloat16``, bit for bit."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def fill(jargs, targs):
    """The reference's argument tree ``jargs`` (abstract) with each leaf
    the port's leaf of the same path, as a jax array (the minibatch key a
    host array, as the port's)."""
    mine = port_paths(targs)

    def put(path, sds):
        x = np.array(to_numpy(mine[jax.tree_util.keystr(path)]))  # a copy
        assert x.shape == sds.shape and x.dtype == sds.dtype, path
        return x if isinstance(mine[jax.tree_util.keystr(path)],
                               np.ndarray) else jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(put, jargs)


def _to_torch(x) -> torch.Tensor:
    a = np.array(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(jout, like):
    """The reference's output ``jout`` in the structure of the port's
    output ``like`` (the same paths; a metric the port adds, the kept
    gradients, is left out)."""
    theirs = leaf_paths(jout)

    def build(t, path):
        if t is None or isinstance(t, (int, float, str)):
            return t
        if isinstance(t, torch.Tensor):
            return _to_torch(theirs["".join(path)])
        if isinstance(t, dict):
            return {k: build(v, path + (f"[{k!r}]",)) for k, v in t.items()
                    if k != "grads"}
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name), path + (f".{f.name}",))
                for f in dataclasses.fields(t)})
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f), path + (f".{f}",))
                             for f in t._fields))
        return type(t)(build(v, path + (f"[{i}]",)) for i, v in enumerate(t))

    return build(like, ())
