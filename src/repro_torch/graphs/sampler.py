"""Uniform neighbour sampler, GraphSAGE-style layered fan-out
(``repro/graphs/sampler.py``).

Static fan-out shapes, gathered from the CSR at random in-degree offsets.
The offsets are ``jax.random.randint``'s, bit for bit: their random words
depend on the key and the shape only, so they are drawn on the host
(``data.pipelines``' threefry) and sent to the CSR's device, where the
span reduction by each seed's degree runs. Nothing is read back, so a
step on the card never waits for the host on the graph.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.data import pipelines as rnd


class SampledBlocks(NamedTuple):
    """Layered minibatch: seeds[B], hop k neighbours [B * prod(f<k), f_k]."""

    seeds: torch.Tensor                 # [B]
    hops: tuple                         # hop k: [B * prod(fanouts[:k]), f_k]
    masks: tuple                        # same shapes, bool (False = padded)


def _words(key: np.ndarray, shape: tuple, dev: torch.device):
    """randint's two random words a draw (``split(key)``'s two keys), as
    int64 tensors on ``dev``."""
    w = torch.from_numpy(np.stack([rnd.random_bits(k, shape)
                                   for k in rnd.split(key)]).astype(np.int64))
    if dev.type == "cuda":
        w = w.pin_memory().to(dev, non_blocking=True)
    elif dev.type != "cpu":
        w = w.to(dev)                   # ``meta``: the shapes only
    return w[0], w[1]


def sample_one_hop(rng: np.ndarray, row_ptr: torch.Tensor,
                   col_idx: torch.Tensor, seeds: torch.Tensor, fanout: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample ``fanout`` neighbours (with replacement) per seed; a seed
    with no neighbour gets itself, masked out."""
    start = row_ptr[seeds]
    deg = row_ptr[seeds + 1] - start
    hi, lo = _words(rng, (seeds.shape[0], fanout), row_ptr.device)
    offs = rnd.randint_from_words(hi, lo, 0, torch.clamp(deg, min=1)[:, None])
    # int64: row_ptr[seeds] + offs passes 2**31 on a CSR of more than 2**31
    # entries (Reddit's 229,231,784 stay below it)
    nbrs = col_idx[start.long()[:, None] + offs]
    mask = (deg > 0)[:, None].expand(nbrs.shape)
    return torch.where(mask, nbrs, seeds[:, None].to(nbrs.dtype)), mask


def sample_blocks(rng: np.ndarray, row_ptr: torch.Tensor,
                  col_idx: torch.Tensor, seeds: torch.Tensor,
                  fanouts: tuple) -> SampledBlocks:
    """``rng`` is a threefry key (``data.pipelines.prng_key``); the CSR
    and the seeds lie on one device, where the blocks are made."""
    hops, masks = [], []
    frontier = seeds
    for f in fanouts:
        rng, sub = rnd.split(rng)
        nbrs, mask = sample_one_hop(sub, row_ptr, col_idx, frontier, f)
        hops.append(nbrs)
        masks.append(mask)
        frontier = nbrs.reshape(-1)
    return SampledBlocks(seeds=seeds, hops=tuple(hops), masks=tuple(masks))


def blocks_to_graphbatch(blocks: SampledBlocks, feat_table: torch.Tensor,
                         coord_table: "torch.Tensor | None",
                         label_table: "torch.Tensor | None"):
    """Flatten layered fan-out blocks into a local edge-list GraphBatch so
    any edge-list GNN (SchNet/EGNN/EquiformerV2) can run on a sampled
    minibatch. Local node k is the k-th entry of [seeds, hop1.flat,
    hop2.flat, ...]; edges point child -> parent (message direction)."""
    from repro_torch.models.gnn.common import GraphBatch

    levels = [blocks.seeds] + [h.reshape(-1) for h in blocks.hops]
    sizes = [lv.shape[0] for lv in levels]
    offs = [0]
    for s in sizes[:-1]:
        offs.append(offs[-1] + s)
    n_local = sum(sizes)
    nodes_global = torch.cat([lv.to(blocks.seeds.dtype) for lv in levels])
    dev = blocks.seeds.device

    srcs, dsts = [], []
    for k, hop in enumerate(blocks.hops):
        n_parent, fan = hop.shape
        parent_local = offs[k] + torch.arange(n_parent, dtype=torch.int32,
                                              device=dev)
        child_local = offs[k + 1] + torch.arange(n_parent * fan,
                                                 dtype=torch.int32,
                                                 device=dev)
        mask = blocks.masks[k].reshape(-1)
        srcs.append(torch.where(mask, child_local, n_local))
        dsts.append(torch.where(mask, parent_local.repeat_interleave(fan),
                                n_local))
    return GraphBatch(
        node_feat=feat_table[nodes_global],
        edge_src=torch.cat(srcs),
        edge_dst=torch.cat(dsts),
        coords=None if coord_table is None else coord_table[nodes_global],
        node_label=(torch.zeros((n_local,), dtype=torch.int32, device=dev)
                    if label_table is None else label_table[nodes_global]),
        graph_id=None,
        n_graphs=1,
    )
