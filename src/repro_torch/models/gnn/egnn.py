"""EGNN (Satorras et al. 2021) — E(n)-equivariant GNN
(``repro/models/gnn/egnn.py``).

Per layer:
  m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
  x_i'  = x_i + C * sum_j (x_i - x_j) * phi_x(m_ij)
  h_i'  = phi_h(h_i, sum_j m_ij)
No spherical harmonics — equivariance comes from using only relative
coordinates scaled by invariant scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common as mcommon
from repro_torch.models.gnn import common as g


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_in: int = 16
    d_hidden: int = 64
    dtype: Any = torch.float32


def init_params(cfg: EGNNConfig, generator=None, *, device=None):
    """(params, logical axes) at random init on ``device`` (None: the
    CUDA device; ``"meta"``: shapes only)."""
    f = mcommon.init_factory(generator, cfg.dtype, device)
    d = cfg.d_hidden
    p = {"proj": f.dense((cfg.d_in, d), ("gnn_in", "gnn_out"))}
    for i in range(cfg.n_layers):
        p[f"e0_{i}"] = f.dense((2 * d + 1, d), ("gnn_in", "gnn_out"))
        p[f"e0b_{i}"] = f.zeros((d,), ("gnn_out",))
        p[f"e1_{i}"] = f.dense((d, d), ("gnn_in", "gnn_out"))
        p[f"e1b_{i}"] = f.zeros((d,), ("gnn_out",))
        p[f"x0_{i}"] = f.dense((d, d), ("gnn_in", "gnn_out"))
        p[f"x0b_{i}"] = f.zeros((d,), ("gnn_out",))
        p[f"x1_{i}"] = f.dense((d, 1), ("gnn_in", "gnn_out"), scale=1e-3)
        p[f"h0_{i}"] = f.dense((2 * d, d), ("gnn_in", "gnn_out"))
        p[f"h0b_{i}"] = f.zeros((d,), ("gnn_out",))
        p[f"h1_{i}"] = f.dense((d, d), ("gnn_in", "gnn_out"))
        p[f"h1b_{i}"] = f.zeros((d,), ("gnn_out",))
    p["head"] = f.dense((d, 1), ("gnn_in", "gnn_out"))
    return mcommon.split_tree(p)


def forward(params, batch: g.GraphBatch, cfg: EGNNConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (per-graph scalar prediction, final coords)."""
    n = batch.node_feat.shape[0]
    h = batch.node_feat @ params["proj"]
    x = batch.coords
    src = torch.clamp(batch.edge_src, max=n)
    dst = torch.clamp(batch.edge_dst, max=n)
    valid = (batch.edge_src < n)[:, None].to(h.dtype)

    for i in range(cfg.n_layers):
        h_ext, x_ext = g.with_pad_row(h), g.with_pad_row(x)
        hi, hj = h_ext[dst], h_ext[src]
        dvec = x_ext[dst] - x_ext[src]
        d2 = torch.sum(dvec * dvec, dim=-1, keepdim=True)
        m = F.silu(torch.cat([hi, hj, d2], -1) @ params[f"e0_{i}"]
                   + params[f"e0b_{i}"])
        m = F.silu(m @ params[f"e1_{i}"] + params[f"e1b_{i}"]) * valid
        # coordinate update (equivariant)
        w = F.silu(m @ params[f"x0_{i}"] + params[f"x0b_{i}"])
        w = w @ params[f"x1_{i}"]                     # (E, 1)
        x = x + g.scatter_mean(dvec * w, dst, n)
        # feature update
        agg = g.scatter_sum(m, dst, n)
        u = F.silu(torch.cat([h, agg], -1) @ params[f"h0_{i}"]
                   + params[f"h0b_{i}"])
        h = h + (u @ params[f"h1_{i}"] + params[f"h1b_{i}"])

    node_e = (h @ params["head"])[:, 0]
    return g.segment_sum_graphs(node_e, batch), x


def loss_fn(params, batch: g.GraphBatch, targets: torch.Tensor,
            cfg: EGNNConfig):
    pred, _ = forward(params, batch, cfg)
    loss = torch.mean((pred - targets) ** 2)
    return loss, {"mse": loss}
