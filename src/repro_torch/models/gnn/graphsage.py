"""GraphSAGE (Hamilton et al. 2017) — mean aggregator
(``repro/models/gnn/graphsage.py``).

Two execution paths:
  * full-graph: edge-index gather + segment-mean over the whole graph
    (full_graph_sm / ogb_products shapes);
  * sampled minibatch: layered fan-out blocks from ``graphs.sampler``
    (minibatch_lg shape, Reddit-scale).
``forward_full_owner`` is the owner-computes full-graph forward, one
shard a device of a list (several may share one).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.graphs.sampler import SampledBlocks
from repro_torch.models import common as mcommon
from repro_torch.models.gnn import common as g
from repro_torch.obs import opcost_hooks


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    aggregator: str = "mean"
    fanouts: tuple = (25, 10)
    dtype: Any = torch.float32


def init_params(cfg: SAGEConfig, generator=None, *, device=None):
    """(params, logical axes) at random init on ``device`` (None: the
    CUDA device; ``"meta"``: shapes only)."""
    f = mcommon.init_factory(generator, cfg.dtype, device)
    p = {}
    d = cfg.d_in
    for i in range(cfg.n_layers):
        out = cfg.d_hidden if i < cfg.n_layers - 1 else cfg.n_classes
        p[f"self{i}"] = f.dense((d, out), ("gnn_in", "gnn_out"))
        p[f"nbr{i}"] = f.dense((d, out), ("gnn_in", "gnn_out"))
        p[f"b{i}"] = f.zeros((out,), ("gnn_out",))
        d = out
    return mcommon.split_tree(p)


def _layer(p, i, h_self, h_nbr_agg, last: bool):
    y = h_self @ p[f"self{i}"] + h_nbr_agg @ p[f"nbr{i}"] + p[f"b{i}"]
    if not last:
        y = F.relu(y)
        # vector_norm's gradient at a zero row is 0 (sqrt's would be NaN)
        y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1,
                                                     keepdim=True), min=1e-6)
    return y


def forward_full(params, batch: g.GraphBatch, cfg: SAGEConfig
                 ) -> torch.Tensor:
    """Full-graph forward: (N, d_in) -> (N, n_classes)."""
    n = batch.node_feat.shape[0]
    h = batch.node_feat
    src = torch.clamp(batch.edge_src, max=n)
    for i in range(cfg.n_layers):
        msg = g.with_pad_row(h)[src]
        agg = g.scatter_mean(msg, batch.edge_dst, n)
        h = _layer(params, i, h, agg, last=(i == cfg.n_layers - 1))
    return h


def forward_sampled(params, feats: torch.Tensor, blocks: SampledBlocks,
                    cfg: SAGEConfig) -> torch.Tensor:
    """Minibatch forward over layered fan-out blocks.

    feats: global (N, d_in) feature table (gathered per hop).
    Returns (B, n_classes) seed logits.
    """
    # gather raw features at each level: level 0 = seeds, level k = hop k
    levels = [feats[blocks.seeds]]
    for hop in blocks.hops:
        levels.append(feats[hop.reshape(-1)])
    # aggregate top-down: at layer i, level j is updated from level j+1
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        new_levels = []
        for j in range(cfg.n_layers - i):
            fan = cfg.fanouts[j]
            parent = levels[j]                              # (P, d)
            child = levels[j + 1].reshape(parent.shape[0], fan, -1)
            mask = blocks.masks[j].reshape(parent.shape[0], fan, 1).to(
                child.dtype)
            agg = (child * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
            new_levels.append(_layer(params, i, parent, agg, last=last))
        levels = new_levels
    return levels[0]


def forward_full_owner(params, batch: g.GraphBatch, cfg: SAGEConfig, *,
                       devices: list, coords: "list | None" = None
                       ) -> torch.Tensor:
    """Owner-computes full-graph forward, one node block a shard and one
    shard an entry of ``devices`` (several may share one device).

    The edges are pre-partitioned by their destination's block, so every
    message is summed on its owner: each layer gathers the (N, d) table
    once onto every shard (the all-gather of a multi-process run) and runs
    a local gather + segment-mean for the shard's block. A pad edge (dst =
    N) belongs to no shard. With every shard on one device it computes
    ``forward_full``. ``coords`` gives each shard's mesh coordinates for
    the op counter (``obs/opcost_hooks.py``). Returns (N, n_classes) on
    ``devices[0]``."""
    n = batch.node_feat.shape[0]
    n_shards = len(devices)
    assert n % n_shards == 0, (n, n_shards)
    blk = n // n_shards
    devs = [torch.device(d) for d in devices]

    def mine(s: int):
        return opcost_hooks.shard(coords[s]) if coords \
            else contextlib.nullcontext()

    axes = tuple(coords[0]) if coords else ()
    owner = torch.div(batch.edge_dst.long(), blk, rounding_mode="floor")
    edges, outs, ps = [], [], []
    for s, dev in enumerate(devs):
        with mine(s):
            keep = owner == s
            src = torch.clamp(batch.edge_src[keep], max=n).to(dev)
            dst_local = (batch.edge_dst[keep].long() - s * blk).to(dev)
        edges.append((src, dst_local))
        outs.append(batch.node_feat[s * blk:(s + 1) * blk].to(dev))
        ps.append({k: v.to(dev) for k, v in params.items()})
    for i in range(cfg.n_layers):
        new = []
        for s, dev in enumerate(devs):
            with mine(s):
                full = opcost_hooks.collective(
                    torch.cat([o.to(dev) for o in outs]), "all-gather", axes,
                    back="reduce-scatter")
                new.append(_layer(ps[s], i, outs[s], g.scatter_mean(
                    g.with_pad_row(full)[edges[s][0]], edges[s][1], blk),
                    last=(i == cfg.n_layers - 1)))
        outs = new
    return torch.cat([o.to(devs[0]) for o in outs])


def loss_full(params, batch: g.GraphBatch, cfg: SAGEConfig):
    logits = forward_full(params, batch, cfg)
    loss = mcommon.cross_entropy(logits, batch.node_label)
    return loss, {"ce": loss}


def loss_sampled(params, feats, blocks, labels, cfg: SAGEConfig):
    logits = forward_sampled(params, feats, blocks, cfg)
    loss = mcommon.cross_entropy(logits, labels)
    return loss, {"ce": loss}
