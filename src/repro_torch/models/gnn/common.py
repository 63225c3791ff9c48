"""Shared GNN substrate (``repro/models/gnn/common.py``).

Message passing is edge-index gather -> edgewise compute -> segment sum
(``index_add``) scatter, as in the reference. Edge lists have a static
length with a sentinel (src = dst = n_nodes) for padding; the segment
ops run over ``n_nodes + 1`` segments and drop the last, the trash row.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data import pipelines as rnd
from repro_torch.device import resolve_device


class GraphBatch(NamedTuple):
    """One (possibly padded/flattened) graph for full- or mini-batch GNNs."""

    node_feat: torch.Tensor              # (N, F) float
    edge_src: torch.Tensor               # (E,) int32, pad = N
    edge_dst: torch.Tensor               # (E,) int32, pad = N
    coords: "torch.Tensor | None"        # (N, 3) for geometric models
    node_label: torch.Tensor             # (N,) int32 or (N,) float target
    graph_id: "torch.Tensor | None"      # (N,) int32 graph membership
    n_graphs: int                        # static


def with_pad_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one zero row appended (the pad sentinel's row)."""
    return torch.cat([x, torch.zeros_like(x[:1])], dim=0)


def species_of(node_feat: torch.Tensor, n_species: int) -> torch.Tensor:
    """The species index in column 0: truncated toward zero to int32,
    then a floor modulo (the reference's ``astype`` and ``%``)."""
    return node_feat[:, 0].to(torch.int32) % n_species


def _segments(values: torch.Tensor, n: int) -> torch.Tensor:
    return values.new_zeros((n + 1,) + tuple(values.shape[1:]))


def scatter_sum(values: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Edge values (E, ...) -> node sums (N, ...). Pad rows land in the
    trash segment (index n_nodes) and are dropped."""
    return segment_sums(values, dst, n_nodes)[:n_nodes]


def segment_sums(values: torch.Tensor, dst: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    """``scatter_sum`` with the trash segment kept: (N + 1, ...)."""
    return _segments(values, n_nodes).index_add(0, dst, values)


def scatter_mean(values: torch.Tensor, dst: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    s = scatter_sum(values, dst, n_nodes)
    ones = values.new_ones((values.shape[0],))
    cnt = scatter_sum(ones, dst, n_nodes)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def _segment_max(values: torch.Tensor, dst: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Per-segment max over ``n + 1`` segments; ``-inf`` where a segment
    is empty (``jax.ops.segment_max``). Ties share the gradient evenly."""
    idx = dst.long().reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(
        values)
    init = torch.full((n + 1,) + tuple(values.shape[1:]), -torch.inf,
                      dtype=values.dtype, device=values.device)
    return init.scatter_reduce(0, idx, values, "amax", include_self=True)


def scatter_max(values: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Per-node max; an empty segment's ``-inf`` becomes 0."""
    out = _segment_max(values, dst, n_nodes)[:n_nodes]
    return torch.where(torch.isfinite(out), out, 0.0)


def scatter_softmax(logits: torch.Tensor, dst: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """Edge-wise softmax normalised over incoming edges of each dst node."""
    mx = _segment_max(logits, dst, n_nodes)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(logits - mx[dst])
    den = _segments(ex, n_nodes).index_add(0, dst, ex)
    return ex / torch.clamp(den[dst], min=1e-16)


def mlp(factory, sizes, axes_prefix=("io",), name=""):
    """Init helper: dict of (w, b) pairs with logical axes."""
    layers = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers[f"{name}w{i}"] = factory.dense((a, b), ("gnn_in", "gnn_out"))
        layers[f"{name}b{i}"] = factory.zeros((b,), ("gnn_out",))
    return layers


def mlp_apply(params, x, name="", n=None, act=F.silu, last_act=False):
    i = 0
    while f"{name}w{i}" in params:
        x = x @ params[f"{name}w{i}"] + params[f"{name}b{i}"]
        has_next = f"{name}w{i+1}" in params
        if has_next or last_act:
            x = act(x)
        i += 1
    return x


def pad_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int, e_pad: int
              ) -> tuple[np.ndarray, np.ndarray]:
    e = len(src)
    assert e <= e_pad, (e, e_pad)
    s = np.full(e_pad, n_nodes, dtype=np.int32)
    d = np.full(e_pad, n_nodes, dtype=np.int32)
    s[:e], d[:e] = src, dst
    return s, d


def segment_sum_graphs(values: torch.Tensor, batch: GraphBatch
                       ) -> torch.Tensor:
    """Per-node values (N,) -> per-graph sums (n_graphs,); the whole sum
    as a (1,) tensor when the batch is one graph."""
    if batch.graph_id is None:
        return values.sum().reshape(1)
    return values.new_zeros((batch.n_graphs,)).index_add(
        0, batch.graph_id, values)


def _graph_id(n_nodes: int, n_graphs: int, device) -> "torch.Tensor | None":
    if n_graphs <= 1:
        return None
    return (torch.arange(n_nodes, dtype=torch.int64, device=device)
            * n_graphs // n_nodes).to(torch.int32)


def random_graph_batch(key, n_nodes: int, n_edges: int, d_feat: int, *,
                       coords: bool = False, n_classes: int = 40,
                       n_graphs: int = 1, dtype=torch.float32,
                       device=None) -> GraphBatch:
    """Synthetic batch for smoke tests and full-width runs.

    ``key`` is a threefry key (``data.pipelines.prng_key``): the
    reference's draws, exactly in the int fields and within
    ``pipelines.NORMAL_TOL`` in the float ones, made on the host and moved
    to ``device`` (None: the CUDA device). Or ``key`` is a
    ``torch.Generator``: the same distributions drawn on the generator's
    device (``device`` must be that one or None), for sizes where the
    host's threefry would take minutes."""
    if isinstance(key, torch.Generator):
        dev = key.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"the generator lives on {dev}, not {device}")
        kw = dict(generator=key, device=dev)
        src = torch.randint(0, n_nodes, (n_edges,), dtype=torch.int32, **kw)
        dst = torch.randint(0, n_nodes, (n_edges,), dtype=torch.int32, **kw)
        feat = torch.randn((n_nodes, d_feat), dtype=dtype, **kw)
        xyz = torch.randn((n_nodes, 3), dtype=dtype, **kw) if coords else None
        label = torch.randint(0, n_classes, (n_nodes,), dtype=torch.int32,
                              **kw)
    else:
        dev = resolve_device(device)
        k1, k2, k3, k4, k5 = rnd.split(key, 5)
        host = {"src": rnd.randint(k1, (n_edges,), 0, n_nodes),
                "dst": rnd.randint(k2, (n_edges,), 0, n_nodes),
                "feat": rnd.normal(k3, (n_nodes, d_feat)),
                "label": rnd.randint(k5, (n_nodes,), 0, n_classes)}
        if coords:
            host["xyz"] = rnd.normal(k4, (n_nodes, 3))
        t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        src, dst, label = t["src"], t["dst"], t["label"]
        feat = t["feat"].to(dtype)
        xyz = t["xyz"].to(dtype) if coords else None
    return GraphBatch(node_feat=feat, edge_src=src, edge_dst=dst,
                      coords=xyz, node_label=label,
                      graph_id=_graph_id(n_nodes, n_graphs, dev),
                      n_graphs=n_graphs)
