"""SchNet (Schütt et al. 2017) — continuous-filter convolutions
(``repro/models/gnn/schnet.py``).

cfconv: for edge (i<-j):  m_ij = h_j * W(rbf(||x_i - x_j||));
W is a filter-generating MLP over 300 Gaussian radial basis functions with
cutoff 10 Å (cosine cutoff envelope). Interaction block = atomwise linear
-> cfconv -> atomwise MLP, residual. Readout sums per-atom energies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common as mcommon
from repro_torch.models.gnn import common as g


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    dtype: Any = torch.float32


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - math.log(2.0)


def init_params(cfg: SchNetConfig, generator=None, *, device=None):
    """(params, logical axes) at random init on ``device`` (None: the
    CUDA device; ``"meta"``: shapes only)."""
    f = mcommon.init_factory(generator, cfg.dtype, device)
    d = cfg.d_hidden
    p = {"embed": f.dense((cfg.n_species, d), ("gnn_in", "gnn_out"), scale=1.0)}
    for i in range(cfg.n_interactions):
        p[f"in_{i}"] = f.dense((d, d), ("gnn_in", "gnn_out"))
        p[f"filt0_{i}"] = f.dense((cfg.n_rbf, d), ("gnn_in", "gnn_out"))
        p[f"filt0b_{i}"] = f.zeros((d,), ("gnn_out",))
        p[f"filt1_{i}"] = f.dense((d, d), ("gnn_in", "gnn_out"))
        p[f"filt1b_{i}"] = f.zeros((d,), ("gnn_out",))
        p[f"out0_{i}"] = f.dense((d, d), ("gnn_in", "gnn_out"))
        p[f"out0b_{i}"] = f.zeros((d,), ("gnn_out",))
        p[f"out1_{i}"] = f.dense((d, d), ("gnn_in", "gnn_out"))
        p[f"out1b_{i}"] = f.zeros((d,), ("gnn_out",))
    p["head0"] = f.dense((d, d // 2), ("gnn_in", "gnn_out"))
    p["head0b"] = f.zeros((d // 2,), ("gnn_out",))
    p["head1"] = f.dense((d // 2, 1), ("gnn_in", "gnn_out"))
    return mcommon.split_tree(p)


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype,
                             device=dist.device)
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    c = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
    return torch.where(dist < cutoff, c, 0.0)


def forward(params, batch: g.GraphBatch, cfg: SchNetConfig) -> torch.Tensor:
    """Returns per-graph energies (n_graphs,)."""
    n = batch.node_feat.shape[0]
    species = g.species_of(batch.node_feat, cfg.n_species)
    h = params["embed"][species]
    x_ext = g.with_pad_row(batch.coords)
    src = torch.clamp(batch.edge_src, max=n)
    dst = torch.clamp(batch.edge_dst, max=n)
    valid = (batch.edge_src < n)[:, None]
    dvec = x_ext[dst] - x_ext[src]
    dist = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + 1e-12)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    env = cosine_cutoff(dist, cfg.cutoff)[:, None] * valid

    for i in range(cfg.n_interactions):
        w = shifted_softplus(rbf @ params[f"filt0_{i}"]
                             + params[f"filt0b_{i}"])
        w = (w @ params[f"filt1_{i}"] + params[f"filt1b_{i}"]) * env
        hj_ext = g.with_pad_row(h @ params[f"in_{i}"])
        m = hj_ext[src] * w
        agg = g.scatter_sum(m, dst, n)
        v = shifted_softplus(agg @ params[f"out0_{i}"] + params[f"out0b_{i}"])
        v = v @ params[f"out1_{i}"] + params[f"out1b_{i}"]
        h = h + v

    e_atom = shifted_softplus(h @ params["head0"] + params["head0b"])
    e_atom = (e_atom @ params["head1"])[:, 0]
    return g.segment_sum_graphs(e_atom, batch)


def loss_fn(params, batch: g.GraphBatch, targets: torch.Tensor,
            cfg: SchNetConfig):
    e = forward(params, batch, cfg)
    loss = torch.mean((e - targets) ** 2)
    return loss, {"mse": loss}
