"""The expert-parallel MoE (``repro_torch.models.moe.moe_ffn(mesh=...)``)
and the device mesh (``repro_torch.launch.mesh``) against ``repro`` on the
CPU: the reference's ``shard_map`` branch runs in a subprocess on four
forced host devices (``tests/_mesh_ref.py``), the port on a
``DeviceMesh`` of ``"cpu"`` entries, the same seeded inputs and weights.

Cases: meshes (1, 4), (2, 2) and (4, 1), the batch over ``("data",)``,
FSDP over ``()`` and ``("data",)``, a capacity that binds in every data
shard. Each (data, model) shard's routing is exact: the router's expert
ids equal the reference's on the shard's block, and the dispatch (token,
keep flag, slot) equals an independent count of the reference's ids at
the local capacity. ``y`` and ``aux`` agree to ``rtol=atol=1e-5`` (fp32
sums in another order than XLA's). ``place_params`` makes views, never
copies, when every entry shares the parameters' device.
"""
import numpy as np
import pytest
import torch

from _mesh_ref import (MOE, MOE_FSDP, MOE_MESHES, MOE_X, case_key, run,
                       unflat)
from repro_torch.launch.mesh import (DeviceMesh, ExpertShards,
                                     make_local_mesh, make_mesh,
                                     place_params)
from repro_torch.models import moe as tmoe

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = tmoe.MoESettings(**MOE)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_moe") / "moe.npz"
    run("moe", str(path))
    data = np.load(path)
    return dict(data=data, x=torch.from_numpy(data["x"]),
                p={k: torch.from_numpy(v)
                   for k, v in unflat(data, "p").items()})


def _mesh(shape) -> DeviceMesh:
    return make_mesh(shape, ("data", "model"), "cpu")


def _oracle_dispatch(eids: np.ndarray, e_offset: int, e_local: int,
                     capacity: int):
    """The reference's dispatch counted pair by pair: each kept pair's
    position is the number of earlier pairs routed to its expert."""
    t, k = eids.shape
    flat_e = eids.reshape(-1).astype(np.int64) - e_offset
    ok = (flat_e >= 0) & (flat_e < e_local)
    pos = np.zeros_like(flat_e)
    seen = np.zeros(e_local, np.int64)
    for i, e in enumerate(flat_e):
        if ok[i]:
            pos[i] = seen[e]
            seen[e] += 1
    keep = ok & (pos < capacity)
    slot = np.where(keep, flat_e * capacity + pos, e_local * capacity)
    return np.repeat(np.arange(t), k), keep, slot


def test_unsharded_matches_reference(ref):
    y, aux = tmoe.moe_ffn(ref["x"], ref["p"], CFG)
    np.testing.assert_allclose(y.numpy(), ref["data"][case_key("y", None)],
                               **TOL)
    np.testing.assert_allclose(float(aux),
                               float(ref["data"][case_key("aux", None)]),
                               **TOL)


@pytest.mark.parametrize("fsdp", MOE_FSDP, ids=lambda f: "fsdp" + "".join(f))
@pytest.mark.parametrize("shape", MOE_MESHES, ids=str)
def test_mesh_matches_reference(ref, shape, fsdp):
    y, aux = tmoe.moe_ffn(ref["x"], ref["p"], CFG, mesh=_mesh(shape),
                          batch_axes=("data",), fsdp_axes=fsdp)
    assert y.shape == MOE_X
    np.testing.assert_allclose(
        y.numpy(), ref["data"][case_key("y", shape, fsdp)], **TOL)
    np.testing.assert_allclose(
        float(aux), float(ref["data"][case_key("aux", shape, fsdp)]), **TOL)


@pytest.mark.parametrize("shape", MOE_MESHES, ids=str)
def test_mesh_routing_is_exact(ref, shape):
    """Every (data, model) shard: the router's ids equal the reference's
    on the data shard's block, its gates agree, and its dispatch equals
    the oracle's count at the local capacity; the capacity binds."""
    mesh = _mesh(shape)
    n_data, n_model = shape
    e_local = MOE["n_experts"] // n_model
    dropped = 0
    for di, x_l in enumerate(ref["x"].split(MOE_X[0] // n_data)):
        want_eids = ref["data"][case_key("eids", shape, di)]
        want_gates = ref["data"][case_key("gates", shape, di)]
        routes = tmoe.shard_routes(x_l, ref["p"]["router"], CFG, mesh,
                                   {"data": di})
        assert [r.model for r in routes] == list(range(n_model))
        cap = tmoe._capacity(x_l.shape[0] * x_l.shape[1], MOE["top_k"],
                             MOE["n_experts"], MOE["capacity_factor"])
        for r in routes:
            assert (r.e_offset, r.e_local, r.capacity) == \
                (r.model * e_local, e_local, cap)
            np.testing.assert_array_equal(r.eids.numpy(), want_eids)
            np.testing.assert_allclose(r.gates.numpy(), want_gates, **TOL)
            tok, keep, slot = _oracle_dispatch(want_eids, r.e_offset,
                                               e_local, cap)
            np.testing.assert_array_equal(r.flat_tok.numpy(), tok)
            np.testing.assert_array_equal(r.keep.numpy(), keep)
            np.testing.assert_array_equal(r.slot.numpy(), slot)
            in_shard = (want_eids.reshape(-1) // e_local) == r.model
            dropped += int((in_shard & ~keep).sum())
    assert dropped > 0, "the capacity was meant to bind"


def test_per_shard_capacity_is_the_reference_semantics(ref):
    """Where a data shard sees only its own tokens, a binding capacity
    drops other pairs than the unsharded call does: the (2, 2) result
    differs from the unsharded one (the reference's too), while (1, 4),
    one data shard, is the unsharded call bit for bit."""
    y0, aux0 = tmoe.moe_ffn(ref["x"], ref["p"], CFG)
    y14, aux14 = tmoe.moe_ffn(ref["x"], ref["p"], CFG, mesh=_mesh((1, 4)),
                              batch_axes=("data",))
    assert torch.equal(y14, y0) and torch.equal(aux14, aux0)
    y22, _ = tmoe.moe_ffn(ref["x"], ref["p"], CFG, mesh=_mesh((2, 2)),
                          batch_axes=("data",))
    gap = float((y22 - y0).abs().max())
    want_gap = np.abs(ref["data"][case_key("y", (2, 2), ())]
                      - ref["data"][case_key("y", None)]).max()
    assert gap > 1e-2 and want_gap > 1e-2


@pytest.mark.parametrize("fsdp", MOE_FSDP, ids=lambda f: "fsdp" + "".join(f))
@pytest.mark.parametrize("shape", MOE_MESHES, ids=str)
def test_placed_params_give_the_same_result(ref, shape, fsdp):
    mesh = _mesh(shape)
    placed = place_params(ref["p"], mesh, fsdp_axes=fsdp)
    assert isinstance(placed["we_in"], ExpertShards)
    assert placed["router"] is ref["p"]["router"]
    kw = dict(mesh=mesh, batch_axes=("data",), fsdp_axes=fsdp)
    y, aux = tmoe.moe_ffn(ref["x"], ref["p"], CFG, **kw)
    y2, aux2 = tmoe.moe_ffn(ref["x"], placed, CFG, **kw)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


@pytest.mark.parametrize("shape,fsdp", [((1, 4), ()), ((2, 2), ("data",)),
                                        ((4, 1), ("data",))], ids=str)
def test_place_params_makes_views_not_copies(ref, shape, fsdp):
    """Every piece shares the weight's storage and starts at its own
    experts' and ff slice's offset: no weight is copied."""
    mesh = _mesh(shape)
    layers = {k: torch.stack([v, v + 1]) for k, v in ref["p"].items()}
    placed = place_params({"layers": layers}, mesh, fsdp_axes=fsdp)
    n_model, n_fsdp = shape[1], mesh.axis_size(fsdp)
    for name, ff_axis in (("we_in", -1), ("we_gate", -1), ("we_out", -2)):
        w = layers[name]
        shards = placed["layers"][name]
        e_local = w.shape[1] // n_model
        f_local = w.shape[ff_axis] // n_fsdp
        for m in range(n_model):
            for j in range(n_fsdp):
                piece = shards.pieces[m][j]
                assert piece.untyped_storage().data_ptr() == \
                    w.untyped_storage().data_ptr()
                idx = [slice(None)] * 4
                idx[1] = slice(m * e_local, (m + 1) * e_local)
                idx[4 + ff_axis] = slice(j * f_local, (j + 1) * f_local)
                assert piece.data_ptr() == w[tuple(idx)].data_ptr()
                assert torch.equal(piece, w[tuple(idx)])
        # a layer's slice indexes every piece
        one = shards[1]
        assert torch.equal(one.pieces[0][0], shards.pieces[0][0][1])
        assert len(shards.unbind(0)) == 2
    assert placed["layers"]["router"] is layers["router"]


def test_one_fsdp_shard_gathers_a_view(ref):
    """With one FSDP shard the gather joins nothing: the computing device
    gets the weight's own view."""
    from repro_torch.launch.mesh import gather_experts
    w = ref["p"]["we_in"]
    got = gather_experts(w, 1, _mesh((1, 4)), model_axis="model",
                         fsdp_axes=("data",), ff_axis=-1,
                         device=torch.device("cpu"))
    assert got.data_ptr() == w[2:4].data_ptr()


def test_mesh_basics():
    mesh = make_mesh((2, 3), ("data", "model"), "cpu")
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.axis_names == ("data", "model")
    assert mesh.coords(("data",)) == [{"data": 0}, {"data": 1}]
    assert mesh.coords(("model", "data"))[:3] == [
        {"model": 0, "data": 0}, {"model": 0, "data": 1},
        {"model": 1, "data": 0}]
    assert mesh.coords(()) == [{}]
    assert mesh.axis_size(()) == 1 and mesh.axis_size(("model",)) == 3
    assert mesh.device(data=1, model=2) == torch.device("cpu")
    assert mesh.distinct_devices() == [torch.device("cpu")]
    listed = make_mesh((2,), ("data",), ["cpu", "cpu"])
    assert listed.device(data=1) == torch.device("cpu")
    local = make_local_mesh("cpu")
    assert local.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh.coords(("pod",))
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1, 4), ("data", "model"))


def test_mesh_refusals(ref):
    with pytest.raises(AssertionError):          # 8 experts over 3
        tmoe.moe_ffn(ref["x"], ref["p"], CFG,
                     mesh=make_mesh((1, 3), ("data", "model"), "cpu"))
    with pytest.raises(ValueError, match="does not split"):   # batch 4 over 3
        tmoe.moe_ffn(ref["x"], ref["p"], CFG,
                     mesh=make_mesh((3, 1), ("data", "model"), "cpu"),
                     batch_axes=("data",))
    with pytest.raises(ValueError, match="FSDP axis"):
        place_params(ref["p"], _mesh((2, 2)), fsdp_axes=("model",))


def test_mesh_gradients_match_unsharded_at_one_data_shard(ref):
    """Autograd through the mesh form: at (1, 4) the gradients of every
    weight equal the unsharded call's."""
    def grads(**kw):
        p = {k: v.clone().requires_grad_() for k, v in ref["p"].items()}
        y, aux = tmoe.moe_ffn(ref["x"], p, CFG, **kw)
        (y.square().mean() + aux).backward()
        return {k: v.grad for k, v in p.items()}
    want = grads()
    got = grads(mesh=_mesh((1, 4)), batch_axes=("data",),
                fsdp_axes=("data",))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
