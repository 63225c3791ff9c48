"""The GNN and DLRM training steps for the tests and ``chip_smoke.py``:
``full_step``, ``minibatch_step``, ``dlrm_step``, ``gnn_loss``,
``GNN_MODS``, ``value_and_grad`` and ``csr_from_edges`` live in
``repro_torch.launch.steps`` (the port of the reference's
``launch/steps.py``) and are re-exported here under their old names; this
file keeps the card-vs-CPU tolerances and checks. Imports torch and numpy
only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipelines import RecsysPipeline, prng_key
from repro_torch.graphs.sampler import blocks_to_graphbatch, sample_blocks
from repro_torch.launch.steps import (GNN_MODS, csr_from_edges,  # noqa: F401
                                      dlrm_step, full_step, gnn_loss,
                                      minibatch_step, value_and_grad)
from repro_torch.models import dlrm
from repro_torch.models.gnn import graphsage
from repro_torch.models.gnn.common import GraphBatch, random_graph_batch
from repro_torch.optim.adamw import AdamWConfig, adamw_init


#: card = CPU for one step (fp32, TF32 off), the CPU parity tests'
#: tolerances (``tests/_gnn_ref.py``): the loss relative; each gradient,
#: m and v leaf relative to the leaf's largest magnitude (v twice: a
#: square), EquiformerV2's attention query and key leaves at
#: ``ATTN_GRAD_TOL``; each parameter absolute (the default AdamW's first
#: step moves one by at most 3e-6)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ATTN_GRAD_TOL = 1e-3
PARAM_TOL = 1e-6


def leaf_tol(name: str) -> float:
    return ATTN_GRAD_TOL if name.startswith(("attn_q_", "attn_k_")) \
        else GRAD_TOL


def card_cpu_gaps(card: tuple, cpu: tuple) -> dict:
    """``card`` and ``cpu`` are each (params, opt, metrics) of a step made
    with ``keep_grads``. Returns the largest gaps; raises AssertionError
    past a tolerance."""
    (cp, co, cm), (wp, wo, wm) = card, cpu
    gaps = {"loss": abs(float(cm["loss"]) - float(wm["loss"]))
            / max(abs(float(wm["loss"])), 1e-30),
            "grads": 0.0, "m": 0.0, "v": 0.0, "params": 0.0}
    if not gaps["loss"] <= LOSS_RTOL:
        raise AssertionError(f"loss: {gaps['loss']} relative")
    for what, a_tree, b_tree, mult in (
            ("grads", cm["grads"], wm["grads"], 1), ("m", co.m, wo.m, 1),
            ("v", co.v, wo.v, 2)):
        for name in a_tree:
            a, b = a_tree[name].detach().cpu().float(), b_tree[name].float()
            gap = float((a - b).abs().max()
                        / b.abs().max().clamp(min=1e-30))
            gaps[what] = max(gaps[what], gap)
            if not gap <= mult * leaf_tol(name):
                raise AssertionError(f"{what} {name}: {gap} of the leaf's "
                                     "largest")
    for name in wp:
        gap = float((cp[name].detach().cpu() - wp[name].detach()).abs().max())
        gaps["params"] = max(gaps["params"], gap)
        if not gap <= PARAM_TOL:
            raise AssertionError(f"param {name}: {gap}")
    return gaps


# --- card = CPU ---------------------------------------------------------------

SMOKE_ARCHS = ("equiformer-v2", "egnn", "schnet", "graphsage-reddit",
               "dlrm-rm2")


def to_device(x, dev):
    """A copy of a tensor, GraphBatch or dict of tensors on ``dev``."""
    if x is None or isinstance(x, int):
        return x
    if isinstance(x, GraphBatch):
        return GraphBatch(*[to_device(v, dev) for v in x])
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return x.detach().to(dev, copy=True)


def smoke_case(arch: str):
    """(step, params, args) of one smoke train step on the CPU, the
    gradients kept: the arch's smoke config at random init (seed 0), the
    reference tests' smoke batch (24 nodes, 96 edges, 2 graphs, threefry
    key 0) or a ``RecsysPipeline`` batch of 16, the default
    ``AdamWConfig``."""
    cfg = get_arch(arch).make_smoke()
    gen = torch.Generator().manual_seed(0)
    if arch == "dlrm-rm2":
        params = dlrm.init_params(cfg, gen, device="cpu")[0]
        batch = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.vocab_per_table,
                               16, seed=1).batch_at(0, "cpu")
        return dlrm_step(cfg, AdamWConfig(), keep_grads=True), params, \
            (batch,)
    params = GNN_MODS[arch].init_params(cfg, gen, device="cpu")[0]
    batch = random_graph_batch(prng_key(0), 24, 96, getattr(cfg, "d_in", 4),
                               coords=True,
                               n_classes=getattr(cfg, "n_classes", 5),
                               n_graphs=2, device="cpu")
    return full_step(arch, cfg, AdamWConfig(), keep_grads=True), params, \
        (batch, torch.tensor([0.5, -1.0]))


def step_card_vs_cpu(arch: str, dev) -> dict:
    """``smoke_case``'s step on ``dev`` and on the CPU from the same
    params, state and batch; ``card_cpu_gaps`` of the two. Run it with
    TF32 off."""
    step, params, args = smoke_case(arch)
    out = {}
    for where in ("cpu", dev):
        p = to_device(params, where)
        out[where] = step(p, adamw_init(p), *[to_device(a, where)
                                              for a in args])
    return card_cpu_gaps(out[dev], out["cpu"])


def eqv2_mesh_card_vs_cpu(dev, shards: int = 4) -> dict:
    """``smoke_case``'s EquiformerV2 step with ``edge_shard_axes=("data",)``
    on a (``shards``,) mesh of ``dev`` and on one of the CPU, from the same
    params, state and batch; ``card_cpu_gaps`` of the two. Run it with
    TF32 off."""
    import dataclasses

    from repro_torch.launch.mesh import make_mesh
    _, params, args = smoke_case("equiformer-v2")
    cfg = dataclasses.replace(get_arch("equiformer-v2").make_smoke(),
                              edge_shard_axes=("data",))
    out = {}
    for where in ("cpu", dev):
        step = full_step("equiformer-v2", cfg, AdamWConfig(), keep_grads=True,
                         mesh=make_mesh((shards,), ("data",), where))
        p = to_device(params, where)
        out[where] = step(p, adamw_init(p), *[to_device(a, where)
                                              for a in args])
    return card_cpu_gaps(out[dev], out["cpu"])


def sampler_card_vs_cpu(dev, n: int = 3000, e: int = 60_000,
                        fanouts: tuple = (15, 10)) -> dict:
    """``sample_blocks`` (and ``blocks_to_graphbatch``) on ``dev`` and on
    the CPU from one key over one random CSR (ten isolated nodes among
    the seeds): equal bit for bit, or AssertionError."""
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(10, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    rp, ci = csr_from_edges(src, dst, n)
    seeds = torch.from_numpy(rng.integers(0, n, 256).astype(np.int32))
    seeds[:10] = torch.arange(10, dtype=torch.int32)
    feats = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        b = sample_blocks(prng_key(5), rp.to(where), ci.to(where),
                          seeds.to(where), fanouts)
        out[where] = (b, blocks_to_graphbatch(b, feats.to(where), None,
                                              None))
    (cb, cg), (wb, wg) = out[dev], out["cpu"]
    pairs = list(zip(cb.hops + cb.masks, wb.hops + wb.masks)) + [
        (cg.node_feat, wg.node_feat), (cg.edge_src, wg.edge_src),
        (cg.edge_dst, wg.edge_dst)]
    for a, b in pairs:
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError("sample_blocks: the card differs from the "
                                 "CPU")
    return {"seeds": int(seeds.shape[0]), "fanouts": list(fanouts),
            "sampled": [int(h.numel()) for h in cb.hops],
            "isolated_masked": int((~cb.masks[0][:10]).all(1).sum())}


def pipeline_card_vs_cpu(dev, steps=(0, 1, 9)) -> dict:
    """``RecsysPipeline.batch_at`` at the smoke DLRM's sizes on ``dev``
    and on the CPU: equal bit for bit in every field."""
    cfg = get_arch("dlrm-rm2").make_smoke()
    pipe = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.vocab_per_table,
                          256, seed=2)
    for s in steps:
        a, b = pipe.batch_at(s, dev), pipe.batch_at(s, "cpu")
        if any(a[k].dtype != b[k].dtype or not torch.equal(a[k].cpu(), b[k])
               for k in b):
            raise AssertionError(f"RecsysPipeline step {s}: the card "
                                 "differs from the CPU")
    return {"steps": list(steps), "batch": 256}


def owner_card(dev, n_shards: int = 4) -> float:
    """``forward_full_owner`` with ``n_shards`` shards on ``dev`` against
    ``forward_full`` there (the smoke config, a padded batch); the max
    abs difference, AssertionError past 1e-5."""
    cfg = get_arch("graphsage-reddit").make_smoke()
    params = graphsage.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")[0]
    params = to_device(params, dev)
    b = random_graph_batch(prng_key(1), 96, 400, cfg.d_in,
                           n_classes=cfg.n_classes, device="cpu")
    pad = torch.full((16,), 96, dtype=torch.int32)
    b = to_device(b._replace(edge_src=torch.cat([b.edge_src, pad]),
                             edge_dst=torch.cat([b.edge_dst, pad])), dev)
    want = graphsage.forward_full(params, b, cfg)
    got = graphsage.forward_full_owner(params, b, cfg,
                                       devices=[dev] * n_shards)
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"forward_full_owner: {err} from forward_full")
    return err
