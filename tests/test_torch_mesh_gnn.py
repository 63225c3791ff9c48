"""EquiformerV2's edge sharding (``repro_torch.models.gnn.equiformer_v2.
forward(..., mesh=...)`` with ``EqV2Config.edge_shard_axes``) against
``repro`` on the CPU: the reference at ``edge_shard_axes=("data",)`` on a
(4,) mesh of forced host devices, in a subprocess (``tests/_mesh_ref.py``;
under ``jax.set_mesh`` and ``jit``), the port on a ``DeviceMesh`` of
``"cpu"`` entries, the reference's weights and batch carried across.

Cases: a 2-layer model (16 channels, l_max 3, m_max 2) on 20 nodes and 80
edges in two graphs, ``edge_chunk`` 40 (two chunks, each split into four
parts of 10) and 80 (one chunk of four parts of 20): the energies within
1e-5 of the reference's sharded and unsharded forward, ``loss_fn`` within
1e-5 relative and its gradients at ``tests/_gnn_ref.py``'s per-leaf
tolerances. Edge shard axes without a mesh are refused.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _gnn_ref import assert_tree_close
from _gnn_steps import LOSS_RTOL, value_and_grad
from _mesh_ref import GNN_CFG, GNN_CHUNKS, case_key, run, unflat
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import params_from_numpy
from repro_torch.models.gnn import equiformer_v2 as teqv2
from repro_torch.models.gnn.common import GraphBatch

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_gnn") / "gnn.npz"
    run("gnn", str(path))
    data = np.load(path)
    b = {k: torch.from_numpy(v) for k, v in unflat(data, "batch").items()}
    batch = GraphBatch(node_feat=b["node_feat"], edge_src=b["edge_src"],
                       edge_dst=b["edge_dst"], coords=b["coords"],
                       node_label=b["node_label"], graph_id=b["graph_id"],
                       n_graphs=2)
    return dict(data=data, batch=batch,
                params=params_from_numpy(unflat(data, "params"),
                                         device="cpu"),
                targets=torch.from_numpy(data["targets"]))


def _cfg(chunk: int, axes=("data",)) -> teqv2.EqV2Config:
    return teqv2.EqV2Config(**GNN_CFG, edge_chunk=chunk,
                            edge_shard_axes=axes)


MESH = make_mesh((4,), ("data",), "cpu")


@pytest.mark.parametrize("chunk", GNN_CHUNKS)
def test_edge_sharded_forward_matches(ref, chunk):
    with torch.no_grad():
        got = teqv2.forward(ref["params"], ref["batch"], _cfg(chunk),
                            mesh=MESH)
    assert got.shape == (2,)
    np.testing.assert_allclose(
        got.numpy(), ref["data"][case_key("energy", chunk)], **TOL)
    np.testing.assert_allclose(
        got.numpy(), ref["data"][case_key("energy_unsharded", chunk)], **TOL)


@pytest.mark.parametrize("chunk", GNN_CHUNKS)
def test_edge_sharded_gradients_match(ref, chunk):
    cfg = _cfg(chunk)
    loss, grads = value_and_grad(
        lambda p: teqv2.loss_fn(p, ref["batch"], ref["targets"], cfg,
                                mesh=MESH)[0], ref["params"])
    np.testing.assert_allclose(float(loss),
                               float(ref["data"][case_key("loss", chunk)]),
                               rtol=LOSS_RTOL)
    assert_tree_close(grads, unflat(ref["data"], case_key("grads", chunk)))


def test_edge_shards_on_a_two_axis_mesh(ref):
    """Sharding over one axis of a (2, 2) mesh splits each chunk in two;
    the model axis plays no part. Unsharded, sharded over two and over
    four shards give the same energies."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    with torch.no_grad():
        want = teqv2.forward(ref["params"], ref["batch"], _cfg(40, ()))
        for m, axes in ((mesh, ("data",)), (mesh, ("data", "model")),
                        (MESH, ("data",))):
            got = teqv2.forward(ref["params"], ref["batch"], _cfg(40, axes),
                                mesh=m)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_edge_shard_axes_need_a_mesh(ref):
    with pytest.raises(ValueError, match="pass mesh="):
        teqv2.forward(ref["params"], ref["batch"], _cfg(40))
    with pytest.raises(ValueError, match="pass mesh="):
        teqv2.loss_fn(ref["params"], ref["batch"], ref["targets"], _cfg(40))
    cfg = dataclasses.replace(_cfg(40), edge_shard_axes=("pod",))
    with pytest.raises(ValueError, match="not in the mesh"):
        teqv2.forward(ref["params"], ref["batch"], cfg, mesh=MESH)
