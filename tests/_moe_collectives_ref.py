"""The reference's side of ``tests/test_torch_dryrun.py``'s MoE collectives
test: run as a script in a subprocess that forces four host devices, it
compiles ``repro.models.moe.moe_ffn`` on a (2, 2) ``("data", "model")``
mesh for each case of ``CASES`` and writes, per case, the reference's
``repro.launch.dryrun.collective_bytes`` of the compiled HLO as JSON.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src \\
      python tests/_moe_collectives_ref.py OUT.json

The case is ``_mesh_ref``'s MoE (8 experts, top 2, x (4, 32, 16) float32)
with the batch over ``("data",)``. A training case returns the outputs
and the gradients of x and of every weight for the cotangents (2 y, 1),
the gradient pass of ``sum(y ** 2) + aux`` without the loss's own sum
over the data shards. ``collective_bytes`` reads a collective by its
first shape, and JAX issues one all-reduce for several operands (the
gradient pass's psums of the aux and of the expert weights' gradients),
so each such tuple is split into one line an operand before it is read.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (FSDP axes, with the gradient pass) of each case
CASES = tuple((fsdp, grad) for fsdp in ((), ("data",))
              for grad in (False, True))

_TUPLE = re.compile(r"^(\s*%?\S+\s*=\s*)\(([^)]*)\)\s+(all-reduce|all-gather|"
                    r"reduce-scatter|all-to-all|collective-permute)(.*)$")
_ONE = re.compile(r"[a-z]+\d*\[[\d,]*\](?:\{[\d,]*\})?")


def case_key(fsdp, grad) -> str:
    return f"{'+'.join(fsdp) or 'none'}|{'grad' if grad else 'fwd'}"


def split_tuples(hlo: str) -> str:
    """Each collective with a tuple shape as one line an operand."""
    out = []
    for line in hlo.splitlines():
        m = _TUPLE.match(line)
        if m is None:
            out.append(line)
            continue
        head, shapes, kind, rest = m.groups()
        for i, shape in enumerate(_ONE.findall(shapes)):
            out.append(f"{head.rstrip()[:-1].rstrip()}.{i} = {shape} "
                       f"{kind}{rest}")
    return "\n".join(out)


def run(out: str) -> None:
    """Run this script in a subprocess with four forced host devices; it
    writes ``out``."""
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


def _reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from _mesh_ref import MOE, MOE_X
    from repro.launch.dryrun import collective_bytes
    from repro.models import moe as jmoe

    cfg = jmoe.MoESettings(**MOE)
    e, d, f = MOE["n_experts"], MOE_X[2], MOE["d_ff_expert"]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=MOE_X).astype(np.float32))
    p = {k: jnp.asarray(rng.normal(size=s).astype(np.float32))
         for k, s in (("router", (d, e)), ("we_in", (e, d, f)),
                      ("we_gate", (e, d, f)), ("we_out", (e, f, d)))}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    res = {}
    for fsdp, grad in CASES:
        def fwd(x, p, fsdp=fsdp):
            return jmoe.moe_ffn(x, p, cfg, mesh=mesh, batch_axes=("data",),
                                fsdp_axes=fsdp)

        def train(x, p, fwd=fwd):
            (y, aux), vjp = jax.vjp(fwd, x, p)
            return y, aux, vjp((2 * y, jnp.ones_like(aux)))

        fa = fsdp or None
        shardings = (NamedSharding(mesh, P("data", None, None)), {
            "router": NamedSharding(mesh, P()),
            "we_in": NamedSharding(mesh, P("model", None, fa)),
            "we_gate": NamedSharding(mesh, P("model", None, fa)),
            "we_out": NamedSharding(mesh, P("model", fa, None))})
        with jax.set_mesh(mesh):
            hlo = jax.jit(train if grad else fwd, in_shardings=shardings
                          ).lower(x, p).compile().as_text()
        res[case_key(fsdp, grad)] = collective_bytes(split_tuples(hlo))
    with open(out, "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(REPO, "tests"))
    _reference(sys.argv[1])
