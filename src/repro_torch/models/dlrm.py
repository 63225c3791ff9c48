"""DLRM (Naumov et al. 2019) — RM2-class config (``repro/models/dlrm.py``).

bottom MLP (13 dense) -> 64; 26 sparse embedding tables -> 64 each;
dot-product feature interaction over the 27 vectors; top MLP 512-512-256-1.

``embedding_bag`` is multi-hot sum/mean pooling as a row gather +
``index_add`` (the reference's take + segment_sum). The fixed-hot path of
``forward`` is one gather over the stacked tables + a mean over the hot
axis; its gradient is a dense (n_sparse, vocab, d) tensor, as the
reference's is.

``retrieval_score`` scores one query against N candidates as a single
(1, d) x (d, N) matmul.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common as mcommon


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_table: int = 1_000_000
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)
    hot: int = 1                   # multi-hot size per field
    dtype: Any = torch.float32

    @property
    def n_params(self) -> int:
        n = self.n_sparse * self.vocab_per_table * self.embed_dim
        dims = (self.n_dense,) + self.bot_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            n += a * b + b
        n_int = self.n_sparse + 1
        d_inter = n_int * (n_int - 1) // 2 + self.embed_dim
        dims = (d_inter,) + self.top_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            n += a * b + b
        return n


def init_params(cfg: DLRMConfig, generator=None, *, device=None):
    """(params, logical axes) at random init on ``device`` (None: the
    CUDA device; ``"meta"``: shapes only)."""
    f = mcommon.init_factory(generator, cfg.dtype, device)
    p = {"tables": f.dense((cfg.n_sparse, cfg.vocab_per_table, cfg.embed_dim),
                           ("tables", "table_rows", "embed"), scale=0.01)}
    dims = (cfg.n_dense,) + cfg.bot_mlp
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"bot_w{i}"] = f.dense((a, b), ("mlp_in", "mlp_out"))
        p[f"bot_b{i}"] = f.zeros((b,), ("mlp_out",))
    n_int = cfg.n_sparse + 1
    d_inter = n_int * (n_int - 1) // 2 + cfg.embed_dim
    dims = (d_inter,) + cfg.top_mlp
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"top_w{i}"] = f.dense((a, b), ("mlp_in", "mlp_out"))
        p[f"top_b{i}"] = f.zeros((b,), ("mlp_out",))
    return mcommon.split_tree(p)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor, *, mode: str = "sum"
                  ) -> torch.Tensor:
    """torch.nn.EmbeddingBag's function, written as the reference writes
    it. table (V, d); indices (nnz,) ragged; offsets (B,) bag starts, the
    first 0. Returns (B, d) pooled embeddings (a row gather +
    ``index_add``)."""
    nnz = indices.shape[0]
    b = offsets.shape[0]
    rows = table[indices]                                 # (nnz, d)
    pos = torch.arange(nnz, dtype=offsets.dtype, device=offsets.device)
    bag_of = torch.searchsorted(offsets, pos, right=True) - 1
    pooled = rows.new_zeros((b, table.shape[1])).index_add(0, bag_of, rows)
    if mode == "mean":
        ends = torch.cat([offsets, offsets.new_full((1,), nnz)])
        sizes = torch.diff(ends)
        pooled = pooled / torch.clamp(sizes, min=1)[:, None]
    return pooled


def _mlp(p, prefix, x, n, last_sigmoid=False):
    for i in range(n):
        x = x @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        if i < n - 1:
            x = F.relu(x)
        elif last_sigmoid:
            x = torch.sigmoid(x)
    return x


def _field_embeddings(tables: torch.Tensor, sparse_idx: torch.Tensor
                      ) -> torch.Tensor:
    """(n_sparse, V, d) tables, (B, n_sparse, hot) ids -> (B, n_sparse, d):
    each field's rows from its own table, averaged over the hot axis."""
    field = torch.arange(tables.shape[0], device=tables.device)[None, :, None]
    return tables[field, sparse_idx].mean(2)


def forward(params, dense: torch.Tensor, sparse_idx: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """dense (B, 13); sparse_idx (B, 26, hot) int32 -> logits (B,)."""
    z = _mlp(params, "bot", dense, len(cfg.bot_mlp))       # (B, d)
    emb = _field_embeddings(params["tables"], sparse_idx)  # (B, 26, d)
    feats = torch.cat([z[:, None, :], emb], dim=1)         # (B, 27, d)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = torch.triu_indices(feats.shape[1], feats.shape[1], offset=1,
                                device=feats.device)
    pairs = inter[:, iu, ju]                               # (B, 351)
    top_in = torch.cat([z, pairs], dim=1)
    return _mlp(params, "top", top_in, len(cfg.top_mlp))[:, 0]


def loss_fn(params, batch: dict, cfg: DLRMConfig):
    logits = forward(params, batch["dense"], batch["sparse"], cfg)
    y = batch["labels"].to(torch.float32)
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {"bce": loss}


def retrieval_score(params, dense: torch.Tensor, sparse_idx: torch.Tensor,
                    candidates: torch.Tensor, cfg: DLRMConfig
                    ) -> torch.Tensor:
    """Score one query against N candidate item embeddings (N, d):
    user tower output dot candidate matrix -> (N,) scores."""
    z = _mlp(params, "bot", dense, len(cfg.bot_mlp))       # (1, d)
    user = z + _field_embeddings(params["tables"], sparse_idx).sum(dim=1)
    return (user @ candidates.T)[0]                        # (N,)
