"""The port's SO(3) machinery and EquiformerV2 on the CPU: the
reference's property tests (Wigner-D orthogonality and homomorphism at
l_max 1/2/4/6, the spherical-harmonics rotation property, ``rotation_to_z``
at both poles, EqV2 rotation invariance, in one edge chunk and in two)
run on the port; the SO(3) functions against the reference's values and
gradients; the smoke config against the reference (forward, loss,
per-leaf gradients, one AdamW step, from the reference's weights). The
edge-sharded form is held against the reference in
``tests/test_torch_mesh_gnn.py``.

Tolerances: the property tests at the reference tests' own (2e-5 for
the Wigner and SH identities, 2e-6 for ``rotation_to_z``, 2e-4 for the
invariance); the SO(3) functions within 1e-5 of the reference's values
(fp32 recursions, other rounding of the constants) and 1e-4 of each
gradient's largest magnitude; the model as ``tests/_gnn_ref.py`` states
(the attention's query and key weights at 1e-3 there: the reference's own
fp32 gradient of ``attn_q_0`` lies 2.2e-4 from the port's fp64 one, the
port's fp32 one 7.7e-5 from it, the two fp32 ones 1.4e-4 apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.gnn import common as jg
from repro.models.gnn import equiformer_v2 as jeqv2
from repro.models.gnn import so3 as jso3
from repro_torch.configs import get_arch
from repro_torch.data import pipelines as rnd
from repro_torch.models.gnn import common as tg
from repro_torch.models.gnn import equiformer_v2 as teqv2
from repro_torch.models.gnn import so3
from repro_torch.optim.adamw import AdamWConfig, adamw_init

from _gnn_ref import assert_step_matches, jax_step, to_torch, \
    to_torch_params
from _gnn_steps import full_step, value_and_grad

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def _rand_rot(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3))
    q, _ = np.linalg.qr(a)
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return q


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- the reference's property tests, on the port ----------------------------

@pytest.mark.parametrize("l_max", [1, 2, 4, 6])
def test_wigner_orthogonal_and_homomorphic(l_max):
    r1, r2 = _t(_rand_rot(4, 1)), _t(_rand_rot(4, 2))
    d1 = so3.wigner_d_from_r(r1, l_max)
    d2 = so3.wigner_d_from_r(r2, l_max)
    d12 = so3.wigner_d_from_r(r1 @ r2, l_max)
    s = (l_max + 1) ** 2
    np.testing.assert_allclose((d1 @ d1.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(s), (4, s, s)),
                               atol=2e-5)
    np.testing.assert_allclose(d12.numpy(), (d1 @ d2).numpy(), atol=2e-5)


@pytest.mark.parametrize("l_max", [2, 6])
def test_sph_harm_rotation_property(l_max):
    r = _t(_rand_rot(6, 3))
    v = np.random.default_rng(4).normal(size=(6, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = _t(v)
    y = so3.real_sph_harm(v, l_max)
    y_rot = so3.real_sph_harm(torch.einsum("bij,bj->bi", r, v), l_max)
    d = so3.wigner_d_from_r(r, l_max)
    np.testing.assert_allclose(y_rot.numpy(),
                               torch.einsum("bij,bj->bi", d, y).numpy(),
                               atol=2e-5)


def test_rotation_to_z():
    v = np.random.default_rng(5).normal(size=(16, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = np.concatenate([v, [[0, 0, 1]], [[0, 0, -1]]])
    r = so3.rotation_to_z(torch.from_numpy(v).float())
    z = np.einsum("bij,bj->bi", r.numpy(), v)
    np.testing.assert_allclose(z, np.broadcast_to([0, 0, 1], z.shape),
                               atol=2e-6)
    np.testing.assert_allclose(np.linalg.det(r.numpy()), 1.0, atol=1e-5)


# --- the SO(3) functions against the reference's ---------------------------

@pytest.mark.parametrize("l_max", [3, 6])
def test_so3_values_and_gradients_match_reference(l_max):
    """``wigner_d_from_r(rotation_to_z(u))`` and ``real_sph_harm(u)`` at
    random directions and both poles: values, and the gradient of a
    random projection with respect to ``u``."""
    v = np.random.default_rng(6).normal(size=(10, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    u = np.concatenate([v, [[0, 0, 1]], [[0, 0, -1]],
                        [[1e-7, 0, -1]]]).astype(np.float32)
    s = (l_max + 1) ** 2
    cot = np.random.default_rng(7).normal(size=(len(u), s, s)).astype(
        np.float32)
    cot_y = cot[:, 0, :]

    def jfn(x):
        return (jso3.wigner_d_from_r(jso3.rotation_to_z(x), l_max),
                jso3.real_sph_harm(x, l_max))

    (jd, jy), vjp = jax.vjp(jfn, jnp.asarray(u))
    (jgu,) = vjp((jnp.asarray(cot), jnp.asarray(cot_y)))
    tu = torch.from_numpy(u).requires_grad_(True)
    td = so3.wigner_d_from_r(so3.rotation_to_z(tu), l_max)
    ty = so3.real_sph_harm(tu, l_max)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd),
                               atol=1e-5)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5)
    (gu,) = torch.autograd.grad((td * _t(cot)).sum()
                                + (ty * _t(cot_y)).sum(), tu)
    want = np.asarray(jgu)
    assert np.isfinite(gu.numpy()).all() == np.isfinite(want).all()
    ok = np.isfinite(want)
    scale = np.abs(want[ok]).max()
    assert np.abs(gu.numpy()[ok] - want[ok]).max() <= 1e-4 * scale


def test_wigner_tables_are_made_once_per_device_and_dtype():
    so3._tables_on.cache_clear()
    r = _t(_rand_rot(3, 1))
    for _ in range(3):
        so3.wigner_d_from_r(r, 4)
        so3.wigner_d_from_r(r.float(), 4)
    info = so3._tables_on.cache_info()
    assert info.misses == 3 * 2 and info.hits == 3 * 2 * 2


# --- EquiformerV2 -------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke config, weights, batch, forward and jitted
    train step, computed once."""
    jcfg = jget_arch("equiformer-v2").make_smoke()
    jp, _ = jeqv2.init_params(jcfg, KEY)
    jb = jg.random_graph_batch(KEY, 24, 96, 4, coords=True, n_classes=5,
                               n_graphs=2)
    targets = jnp.asarray([0.5, -1.0], jnp.float32)
    loss = lambda p: jeqv2.loss_fn(p, jb, targets, jcfg)[0]
    return dict(jp=jp, jb=jb, targets=targets,
                out=np.asarray(jax.jit(
                    lambda p: jeqv2.forward(p, jb, jcfg))(jp)),
                ref=jax_step(loss, jp))


def test_eqv2_smoke_forward_matches_reference(smoke):
    cfg = get_arch("equiformer-v2").make_smoke()
    assert cfg.edge_chunk == 64          # 96 edges: one chunk
    got = teqv2.forward(to_torch_params(smoke["jp"]), to_torch(smoke["jb"]),
                        cfg)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), smoke["out"], rtol=1e-5,
                               atol=1e-5)


def test_eqv2_smoke_train_step_matches_reference(smoke):
    cfg = get_arch("equiformer-v2").make_smoke()
    tp = to_torch_params(smoke["jp"])
    batch, targets = to_torch(smoke["jb"]), to_torch(smoke["targets"])
    loss, grads = value_and_grad(
        lambda p: teqv2.loss_fn(p, batch, targets, cfg)[0], tp)
    p2, o2, _ = full_step("equiformer-v2", cfg, AdamWConfig())(
        tp, adamw_init(tp), batch, targets)
    assert_step_matches(smoke["ref"], loss, grads, p2, o2)


def test_eqv2_chunks_and_negative_species_match_reference(smoke):
    """Two chunks of 48 edges, pads and zero-length edges, and negative
    species features: the reference's forward on the same numbers."""
    jcfg = dataclasses.replace(jget_arch("equiformer-v2").make_smoke(),
                               edge_chunk=48)
    tcfg = dataclasses.replace(get_arch("equiformer-v2").make_smoke(),
                               edge_chunk=48)
    jb = smoke["jb"]
    feat = np.asarray(jb.node_feat).copy()
    feat[:, 0] = np.linspace(-250.5, 130.2, feat.shape[0])
    src = np.asarray(jb.edge_src).copy()
    dst = np.asarray(jb.edge_dst).copy()
    src[-5:] = dst[-5:] = 24                # pads
    src[3] = dst[3]                         # a zero-length edge
    jb = jb._replace(node_feat=jnp.asarray(feat), edge_src=jnp.asarray(src),
                     edge_dst=jnp.asarray(dst))
    want = jax.jit(lambda p: jeqv2.forward(p, jb, jcfg))(smoke["jp"])
    got = teqv2.forward(to_torch_params(smoke["jp"]), to_torch(jb), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def geo_batch():
    return tg.random_graph_batch(rnd.prng_key(0), 20, 80, 4, coords=True,
                                 n_graphs=2, device="cpu")


@pytest.mark.parametrize("edge_chunk", [80, 40])
def test_eqv2_rotation_invariance(geo_batch, edge_chunk):
    cfg = teqv2.EqV2Config(n_layers=2, channels=16, l_max=3, m_max=2,
                           n_heads=4, n_rbf=8, edge_chunk=edge_chunk)
    params, _ = teqv2.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    q = torch.from_numpy(_rand_rot(1, 7)[0]).float()
    e1 = teqv2.forward(params, geo_batch, cfg)
    e2 = teqv2.forward(params, geo_batch._replace(
        coords=geo_batch.coords @ q.T), cfg)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=2e-4, atol=2e-4)




def test_eqv2_uneven_chunks_are_refused(geo_batch):
    cfg = teqv2.EqV2Config(n_layers=1, channels=8, l_max=1, m_max=1,
                           n_heads=2, n_rbf=4, edge_chunk=25)
    params, _ = teqv2.init_params(cfg, device="cpu")
    with pytest.raises(AssertionError):
        teqv2.forward(params, geo_batch, cfg)     # 80 edges: 3 chunks of 25 do not fit
