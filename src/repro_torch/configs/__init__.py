"""Architecture registry (``repro/configs``): the 10 assigned archs and
the paper's own engine.

Each config module exposes ``ARCH: ArchSpec`` with the exact published
config, a reduced smoke config, and its assigned input-shape set. Select
with ``--arch <id>`` in the launchers. Every config is built from this
package's own files at random init; no model is fetched. The port has the
five LM archs and ``paper-ipgc``; the GNN and recsys archs wait for their
models (ROADMAP Queue A item 11) and ``get_arch`` raises for them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | gnn_full | gnn_minibatch
    #                      | gnn_molecule | rs_train | rs_serve | rs_retrieval
    params: dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str          # lm | gnn | recsys | paper
    make_config: Callable[[], Any]
    make_smoke: Callable[[], Any]
    shapes: dict[str, ShapeSpec]
    notes: str = ""


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeSpec("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1)),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "gnn_full",
                               dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    "minibatch_lg": ShapeSpec("minibatch_lg", "gnn_minibatch",
                              dict(n_nodes=232965, n_edges=114615892,
                                   batch_nodes=1024, fanout=(15, 10),
                                   d_feat=602)),
    "ogb_products": ShapeSpec("ogb_products", "gnn_full",
                              dict(n_nodes=2449029, n_edges=61859140,
                                   d_feat=100)),
    "molecule": ShapeSpec("molecule", "gnn_molecule",
                          dict(n_nodes=30, n_edges=64, batch=128)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "rs_train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "rs_serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "rs_serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "rs_retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "nemotron-4-340b": "nemotron_4_340b",
    "gemma-7b": "gemma_7b",
    "minitron-4b": "minitron_4b",
    "equiformer-v2": "equiformer_v2",
    "egnn": "egnn",
    "schnet": "schnet",
    "graphsage-reddit": "graphsage_reddit",
    "dlrm-rm2": "dlrm_rm2",
    "paper-ipgc": "paper_ipgc",
}

ARCH_IDS = [a for a in _MODULES if a != "paper-ipgc"]


#: the archs whose models are ported
PORTED = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "nemotron-4-340b",
          "gemma-7b", "minitron-4b", "paper-ipgc")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: its model (GNN or recsys) "
            "comes with the training substrate, ROADMAP Queue A item 11")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH
