"""The reference's side of ``tests/test_torch_eqv2_collectives.py``: run as
a script in a subprocess that forces four host devices, it compiles
``repro.models.gnn.equiformer_v2`` with ``edge_shard_axes=("data",)`` on a
(2, 2) ``("data", "model")`` mesh for each case of ``CASES`` and writes,
per case, the collectives of the compiled HLO as JSON: the reference's
``repro.launch.dryrun.collective_bytes`` (``"text"``: each collective of
the text once) and ``repro.launch.hlocost.analyze`` (``"loop"``: each
times its while loop's trip count).

  XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src \\
      python tests/_eqv2_collectives_ref.py OUT.json

The case is ``_mesh_ref``'s EquiformerV2 (2 layers, 16 channels, l_max 3,
m_max 2) on 20 nodes and 80 edges in two graphs, at ``edge_chunk`` 80 (one
chunk: no loop, the two counts agree) and 40 (two chunks, a loop of two
trips); ``forward`` alone, and ``jax.value_and_grad`` of ``loss_fn``. The
tuples of a combined all-reduce are split into one line an operand
(``_moe_collectives_ref.split_tuples``) before they are read.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the graph's nodes, edges and graphs
GRAPH = (20, 80, 2)
#: (edge chunk, with the gradient pass) of each case
CASES = tuple((chunk, grad) for chunk in (80, 40) for grad in (False, True))


def case_key(chunk, grad) -> str:
    return f"{chunk}|{'grad' if grad else 'fwd'}"


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
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from _mesh_ref import GNN_CFG
    from _moe_collectives_ref import split_tuples
    from repro.launch import hlocost
    from repro.launch.dryrun import collective_bytes
    from repro.models.gnn import common as jg
    from repro.models.gnn import equiformer_v2 as jeqv2

    key = jax.random.PRNGKey(0)
    n, e, n_graphs = GRAPH
    batch = jg.random_graph_batch(key, n, e, 4, coords=True,
                                  n_graphs=n_graphs)
    targets = jnp.asarray([0.5, -1.0], jnp.float32)
    base = jeqv2.EqV2Config(**GNN_CFG)
    params, _ = jeqv2.init_params(base, key)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    res = {}
    for chunk, grad in CASES:
        cfg = dataclasses.replace(base, edge_chunk=chunk,
                                  edge_shard_axes=("data",))
        if grad:
            def fn(p, cfg=cfg):
                return jax.value_and_grad(
                    lambda q: jeqv2.loss_fn(q, batch, targets, cfg)[0])(p)
        else:
            def fn(p, cfg=cfg):
                return jeqv2.forward(p, batch, cfg)
        with jax.set_mesh(mesh):
            hlo = split_tuples(jax.jit(fn).lower(params).compile().as_text())
        loop = hlocost.analyze(hlo)["collectives"]
        res[case_key(chunk, grad)] = {
            "text": collective_bytes(hlo),
            "loop": {k: {"bytes": v["bytes"], "count": v["count"]}
                     for k, v in loop.items()}}
    with open(out, "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(REPO, "tests"))
    _reference(sys.argv[1])
