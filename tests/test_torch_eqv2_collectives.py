"""EquiformerV2's collectives in the op counter (``launch/opcost.py``)
against the reference's compiled program.

The reference's edge-sharded step (``edge_shard_axes=("data",)``) is
compiled on a (2, 2) ``("data", "model")`` mesh of four forced host
devices in a subprocess (``tests/_eqv2_collectives_ref.py``); the port's
``forward(..., mesh=)`` runs under ``OpCost`` on the same mesh of ``meta``
entries, the gradient cases with the parameters watched
(``add_grad_sync``), as the dry run counts a training step. Each kind's
per-device bytes and count are equal: the forward pass's all-reduces of
the partial (N + 1)-row sums (and, at one chunk, of the edge embedding's
sum, which the reference's partitioner shards then), and the gradient
pass's all-reduces of the normed features', the queries' and each
product's weight's partial gradients. At one chunk the compiled program
has no loop and the reference's ``collective_bytes`` is its count; at two
chunks each collective of the loop's body runs twice, which
``hlocost.analyze`` counts and ``collective_bytes`` does not.
"""
import json

import pytest
import torch

import _eqv2_collectives_ref as ref_mod
from _mesh_ref import GNN_CFG
from repro_torch.launch import opcost
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import equiformer_v2 as teqv2
from repro_torch.models.gnn.common import GraphBatch


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("eqv2_ref") / "collectives.json"
    ref_mod.run(str(out))
    return json.loads(out.read_text())


def _count(chunk: int, grad: bool) -> dict:
    n, e, n_graphs = ref_mod.GRAPH
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    cfg = teqv2.EqV2Config(**GNN_CFG, edge_chunk=chunk,
                           edge_shard_axes=("data",))
    params, _ = teqv2.init_params(cfg, device="meta")
    params = {k: v.requires_grad_(grad) for k, v in params.items()}

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    batch = GraphBatch(node_feat=zeros(n, 4),
                       edge_src=zeros(e, dtype=torch.int32),
                       edge_dst=zeros(e, dtype=torch.int32),
                       coords=zeros(n, 3), node_label=zeros(n),
                       graph_id=zeros(n, dtype=torch.int32),
                       n_graphs=n_graphs)

    def step(p, batch, targets):
        if not grad:
            return teqv2.forward(p, batch, cfg, mesh=mesh)
        loss = teqv2.loss_fn(p, batch, targets, cfg, mesh=mesh)[0]
        return torch.autograd.grad(loss, list(p.values()))

    return opcost.count(step, (params, batch, zeros(n_graphs)), mesh=mesh,
                        params=params if grad else None)[1]["collectives"]


@pytest.mark.parametrize("chunk, grad", ref_mod.CASES)
def test_eqv2_collectives_match_the_reference(reference, chunk, grad):
    ref = reference[ref_mod.case_key(chunk, grad)]
    one_chunk = chunk >= ref_mod.GRAPH[1]
    if one_chunk:
        for kind in opcost.COLLECTIVES:
            assert ref["text"][kind] == ref["loop"][kind], kind
    want = ref["text"] if one_chunk else ref["loop"]
    got = _count(chunk, grad)
    for kind in opcost.COLLECTIVES:
        assert (got[kind]["bytes"], got[kind]["count"]) == \
            (want[kind]["bytes"], want[kind]["count"]), kind
    assert got["all-reduce"]["axes"] == ["data"]
    assert got["total_bytes"] > 0


def test_gradient_pass_adds_collectives():
    """The gradient pass's all-reduces: the features' and queries' (N, S,
    C) and (N, heads) a layer and chunk, and one a read of each weight the
    edge shards hold whole, none of them added twice by
    ``add_grad_sync``."""
    fwd, grad = _count(40, False), _count(40, True)
    cfg = teqv2.EqV2Config(**GNN_CFG)
    n = ref_mod.GRAPH[0]
    s_dim = (cfg.l_max + 1) ** 2
    layer = 4 * n * (s_dim * cfg.channels + cfg.n_heads)
    params, _ = teqv2.init_params(cfg, device="meta")
    reads = {"so2_m0": 1, "gate": 1, "gateb": 1, "attn_k": 1,
             **{f"so2_{ri}{m}": 2 for ri in "ri"
                for m in range(1, cfg.m_max + 1)}}
    weights = sum(
        reads[k.rsplit("_", 1)[0]] * v.numel() * v.element_size()
        for k, v in params.items() if k.rsplit("_", 1)[0] in reads)
    chunks = 2
    assert grad["all-reduce"]["bytes"] - fwd["all-reduce"]["bytes"] == \
        chunks * (cfg.n_layers * layer + weights)
