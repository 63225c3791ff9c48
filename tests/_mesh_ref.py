"""The reference's side of the mesh parity tests
(``tests/test_torch_mesh_*.py``): run as a script in a subprocess that
forces four host devices, it computes ``repro``'s mesh forms and writes
the inputs, weights and outputs into one ``.npz`` for the port to be held
against.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src \\
      python tests/_mesh_ref.py {moe,lm,gnn} OUT.npz

Meshes are ``jax.make_mesh(..., axis_types=(AxisType.Auto,) * n)``, used
under ``jax.set_mesh`` and ``jax.jit`` (the reference's transformer and
EquiformerV2 constrain shardings, which needs a mesh in context and
automatic axes). Keys: ``name/leaf`` for trees, the case's name for the
rest (``case_keys`` in the tests spell them).
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (mesh shape, fsdp axes) of the MoE cases; the batch is split over
#: ``("data",)`` in each
MOE_MESHES = ((1, 4), (2, 2), (4, 1))
MOE_FSDP = ((), ("data",))
#: the MoE case: 8 experts, top 2, a capacity factor of 1.0 and a router
#: scaled 3x, so that the capacity binds in every data shard
MOE = dict(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=1.0)
MOE_X = (4, 32, 16)
MOE_ROUTER_SCALE = 3.0

#: (arch, mesh shape) of the LM cases, ``batch_axes = fsdp_axes =
#: ("data",)``; tokens (4, 12): prefill 9, then three decode steps
LM_CASES = (("qwen3-moe-30b-a3b", (2, 2)), ("qwen3-moe-30b-a3b", (1, 4)),
            ("minitron-4b", (2, 2)))
LM_TOKENS = (4, 12)
LM_PREFILL = 9
LM_MAX_LEN = 16

#: EquiformerV2 at four edge shards over ("data",)
GNN_CHUNKS = (40, 80)
GNN_CFG = dict(n_layers=2, channels=16, l_max=3, m_max=2, n_heads=4,
               n_rbf=8)


def case_key(*parts) -> str:
    return "|".join(str(p) for p in parts)


def flat(prefix: str, tree) -> dict:
    """A nested dict of arrays as ``prefix/a/b`` keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(f"{prefix}/{k}", v))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflat(data, prefix: str) -> dict:
    """``flat``'s inverse over the keys under ``prefix``."""
    tree: dict = {}
    for key in data.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
    return tree


def run(kind: str, out: str) -> None:
    """Run this script for ``kind`` in a subprocess with four forced host
    devices; it writes ``out``."""
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                     "_mesh_ref.py"),
                        kind, out], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]


# --- the reference, in the subprocess -------------------------------------------

def _mesh(shape, names):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names))


def _moe(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe

    cfg = jmoe.MoESettings(**MOE)
    rng = np.random.default_rng(0)
    e, d, f = MOE["n_experts"], MOE_X[2], MOE["d_ff_expert"]
    x = rng.normal(size=MOE_X).astype(np.float32)
    p = dict(router=(rng.normal(size=(d, e)) * MOE_ROUTER_SCALE
                     ).astype(np.float32),
             we_in=(rng.normal(size=(e, d, f)) / d ** 0.5).astype(np.float32),
             we_gate=(rng.normal(size=(e, d, f)) / d ** 0.5
                      ).astype(np.float32),
             we_out=(rng.normal(size=(e, f, d)) / f ** 0.5
                     ).astype(np.float32))
    out["x"] = x
    out.update(flat("p", p))
    jp = jax.tree.map(jnp.asarray, p)
    y, aux = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, cfg))(x, jp)
    out[case_key("y", None)], out[case_key("aux", None)] = y, aux
    for shape in MOE_MESHES:
        mesh = _mesh(shape, ("data", "model"))
        for fsdp in MOE_FSDP:
            with jax.set_mesh(mesh):
                y, aux = jax.jit(lambda x, p: jmoe.moe_ffn(
                    x, p, cfg, mesh=mesh, batch_axes=("data",),
                    fsdp_axes=fsdp))(x, jp)
            out[case_key("y", shape, fsdp)] = y
            out[case_key("aux", shape, fsdp)] = aux
        # the router on each data shard's block, as each shard runs it
        for di, xb in enumerate(np.split(x, shape[0])):
            gates, eids, _ = jax.jit(jmoe.router_topk, static_argnums=2)(
                xb.reshape(-1, d), jp["router"], MOE["top_k"])
            out[case_key("gates", shape, di)] = gates
            out[case_key("eids", shape, di)] = eids


def _lm(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.models import transformer as jtfm

    toks = np.random.default_rng(1).integers(0, 512, LM_TOKENS).astype(
        np.int32)
    out["tokens"] = toks
    batch = {"tokens": jnp.asarray(toks),
             "labels": jnp.asarray(np.roll(toks, -1, axis=1))}
    for arch in dict(LM_CASES):
        cfg = get_arch(arch).make_smoke()
        params, _ = jtfm.init_params(cfg, jax.random.PRNGKey(0))
        out.update(flat(f"params|{arch}", params))
    for arch, shape in LM_CASES:
        cfg = get_arch(arch).make_smoke()
        params, _ = jtfm.init_params(cfg, jax.random.PRNGKey(0))
        mesh = _mesh(shape, ("data", "model"))
        kw = dict(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
        key = case_key(arch, shape)
        with jax.set_mesh(mesh):
            logits, aux, _ = jax.jit(lambda p, t: jtfm.forward(
                p, t, cfg, **kw))(params, batch["tokens"])
            out[f"{key}|logits"], out[f"{key}|aux"] = logits, aux
            (loss, parts), grads = jax.jit(jax.value_and_grad(
                lambda p, b: jtfm.loss_fn(p, b, cfg, **kw), has_aux=True))(
                    params, batch)
            out[f"{key}|loss"], out[f"{key}|ce"] = loss, parts["ce"]
            out.update(flat(f"{key}|grads", grads))
            last, cache = jax.jit(lambda p, t: jtfm.prefill(
                p, t, cfg, max_len=LM_MAX_LEN, **kw))(
                    params, batch["tokens"][:, :LM_PREFILL])
            out[f"{key}|prefill"], out[f"{key}|cache_k"] = last, cache.k
            out[f"{key}|cache_v"] = cache.v
            step = jax.jit(lambda p, t, c: jtfm.decode_step(p, t, c, cfg,
                                                            **kw))
            for i in range(LM_PREFILL, LM_TOKENS[1]):
                lg, cache = step(params, batch["tokens"][:, i:i + 1], cache)
                out[f"{key}|decode{i}"] = lg
            out[f"{key}|length"] = cache.length


def _gnn(out: dict) -> None:
    import dataclasses

    import jax
    from repro.models.gnn import common as jg
    from repro.models.gnn import equiformer_v2 as jeqv2

    key = jax.random.PRNGKey(0)
    batch = jg.random_graph_batch(key, 20, 80, 4, coords=True, n_graphs=2)
    for f in ("node_feat", "coords", "edge_src", "edge_dst", "node_label",
              "graph_id"):
        out[f"batch/{f}"] = np.asarray(getattr(batch, f))
    targets = np.asarray([0.5, -1.0], np.float32)
    out["targets"] = targets
    base = jeqv2.EqV2Config(**GNN_CFG)
    params, _ = jeqv2.init_params(base, key)
    out.update(flat("params", params))
    mesh = _mesh((4,), ("data",))
    for chunk in GNN_CHUNKS:
        cfg = dataclasses.replace(base, edge_chunk=chunk,
                                  edge_shard_axes=("data",))
        with jax.set_mesh(mesh):
            e = jax.jit(lambda p: jeqv2.forward(p, batch, cfg))(params)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jeqv2.loss_fn(p, batch, targets, cfg)[0]))(params)
        out[case_key("energy", chunk)] = e
        out[case_key("loss", chunk)] = loss
        out.update(flat(case_key("grads", chunk), grads))
        cfg1 = dataclasses.replace(base, edge_chunk=chunk)
        out[case_key("energy_unsharded", chunk)] = jax.jit(
            lambda p: jeqv2.forward(p, batch, cfg1))(params)


def main(kind: str, path: str) -> None:
    import jax
    assert jax.device_count() == 4, jax.devices()
    out: dict = {}
    {"moe": _moe, "lm": _lm, "gnn": _gnn}[kind](out)
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
