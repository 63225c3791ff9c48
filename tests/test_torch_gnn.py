"""The port's GNN substrate on the CPU against the reference: the random
draws (``split``, ``randint``, ``normal``, ``bernoulli``,
``random_graph_batch``), the scatter ops, and SchNet and EGNN at their
smoke configs (forward, loss, per-leaf gradients and one AdamW step, from
the reference's own weights carried across by ``params_from_numpy``),
with the reference's SchNet invariance and EGNN equivariance; the arch
registry on ``meta``; the device rule.

Tolerances: the integer and bool draws bit for bit; ``normal`` within
``pipelines.NORMAL_TOL`` (2e-5; torch's float32 ``erfinv`` is not
XLA's); the scatter ops within 1e-6 (sums of a few fp32 values in
another order); the models as ``tests/_gnn_ref.py`` states (loss 1e-5
relative, gradients, m and v 1e-4 of each leaf's largest magnitude,
parameters 1e-6); the invariance checks at the reference tests' own
tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.models import dlrm as jdlrm
from repro.models.common import ParamFactory as JParamFactory
from repro.models.gnn import common as jg
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import equiformer_v2 as jeqv2
from repro.models.gnn import graphsage as jsage
from repro.models.gnn import schnet as jschnet
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data import pipelines as rnd
from repro_torch.models.common import ParamFactory
from repro_torch.models.gnn import common as tg
from repro_torch.models.gnn import egnn as tegnn
from repro_torch.models.gnn import schnet as tschnet
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves

from _gnn_ref import assert_step_matches, jax_step, to_torch, \
    to_torch_params
from _gnn_steps import full_step, gnn_loss, value_and_grad

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


# --- the random draws ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_split_is_jax_split(seed):
    k = jax.random.PRNGKey(seed)
    for num in (2, 3, 5):
        want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
        assert np.array_equal(rnd.split(rnd.prng_key(seed), num), want)


@pytest.mark.parametrize("minval,maxval", [
    (0, 37), (0, 1), (-5, 5), (3, 3), (7, 2), (0, 2**31 - 1),
    (0, np.array([[1], [0], [5], [100_000], [2**31 - 1], [65_537]],
                 np.int32))])
def test_randint_is_jax_randint(minval, maxval):
    shape = (6, 50)
    want = jax.random.randint(jax.random.PRNGKey(3), shape, minval,
                              jnp.asarray(maxval))
    got = rnd.randint(rnd.prng_key(3), shape, minval, maxval)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(want))


def test_bernoulli_and_normal():
    k, nk = jax.random.PRNGKey(11), rnd.prng_key(11)
    for p in (0.25, 0.5, 0.9):
        assert np.array_equal(rnd.bernoulli(nk, p, (500,)),
                              np.asarray(jax.random.bernoulli(k, p, (500,))))
    want = np.asarray(jax.random.normal(k, (400, 30)))
    got = rnd.normal(nk, (400, 30))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=rnd.NORMAL_TOL)


@pytest.mark.parametrize("n_graphs,coords", [(1, False), (2, True),
                                             (5, True)])
def test_random_graph_batch_is_the_references(n_graphs, coords):
    want = jg.random_graph_batch(KEY, 30, 120, 6, coords=coords,
                                 n_classes=7, n_graphs=n_graphs)
    got = tg.random_graph_batch(rnd.prng_key(0), 30, 120, 6, coords=coords,
                                n_classes=7, n_graphs=n_graphs, device="cpu")
    assert got.n_graphs == want.n_graphs
    for name in ("edge_src", "edge_dst", "node_label", "graph_id"):
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            assert b is None
            continue
        assert b.dtype == torch.int32
        assert np.array_equal(b.numpy(), np.asarray(a)), name
    for name in ("node_feat", "coords"):
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=rnd.NORMAL_TOL)


def test_random_graph_batch_from_a_generator():
    gen = torch.Generator().manual_seed(5)
    b = tg.random_graph_batch(gen, 50, 400, 3, coords=True, n_classes=4,
                              n_graphs=5)
    again = tg.random_graph_batch(torch.Generator().manual_seed(5), 50, 400,
                                  3, coords=True, n_classes=4, n_graphs=5)
    assert b.edge_src.dtype == b.node_label.dtype == torch.int32
    assert b.node_feat.shape == (50, 3) and b.coords.shape == (50, 3)
    assert int(b.edge_src.min()) >= 0 and int(b.edge_dst.max()) < 50
    assert 0 <= int(b.node_label.min()) and int(b.node_label.max()) < 4
    assert torch.equal(b.graph_id, torch.arange(50) * 5 // 50)
    for x, y in zip(b, again):
        assert x == y if isinstance(x, int) else torch.equal(x, y)
    with pytest.raises(ValueError, match="generator"):
        tg.random_graph_batch(gen, 5, 5, 2, device="meta")


def test_pad_edges():
    s, d = tg.pad_edges(np.array([0, 1]), np.array([2, 0]), 3, 5)
    js, jd = jg.pad_edges(np.array([0, 1]), np.array([2, 0]), 3, 5)
    assert np.array_equal(s, js) and np.array_equal(d, jd)
    assert s.dtype == np.int32 and list(s) == [0, 1, 3, 3, 3]


# --- the scatter ops ----------------------------------------------------------

def _scatter_case():
    """Edges into 6 nodes: node 2 and 5 get none, two pads (dst = 6),
    ties at node 0 and node 4."""
    dst = np.array([0, 0, 1, 3, 4, 4, 4, 6, 6, 1], np.int32)
    vals = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
    vals[1] = vals[0]                      # a tie at node 0
    vals[5, 1] = vals[4, 1] = 9.0          # a tie at node 4, column 1
    vals[7] = 50.0                         # pads: never seen
    return vals, dst


@pytest.mark.parametrize("op", ["scatter_sum", "scatter_mean",
                                "scatter_max", "scatter_softmax"])
def test_scatter_ops_match_reference(op):
    vals, dst = _scatter_case()
    if op == "scatter_softmax":
        vals = vals[:, 0]

    def jfn(v):
        return getattr(jg, op)(v, jnp.asarray(dst), 6)

    want, jvjp = jax.vjp(jfn, jnp.asarray(vals))
    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    v = torch.from_numpy(vals).requires_grad_(True)
    got = getattr(tg, op)(v, torch.from_numpy(dst), 6)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    (grad,) = torch.autograd.grad(got, v, torch.from_numpy(cot))
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(jvjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)
    if op != "scatter_softmax":
        # empty segments are 0, the pads' trash row is dropped
        assert got.shape[0] == 6
        assert not got[[2, 5]].any()


def test_mlp_apply_matches_reference():
    layers = jg.mlp(JParamFactory(jax.random.PRNGKey(4), jnp.float32),
                    (5, 8, 3), name="m")
    jp = {k: v[0] for k, v in layers.items()}
    x = np.random.default_rng(2).normal(size=(7, 5)).astype(np.float32)
    tp = to_torch_params(jp)
    for last_act in (False, True):
        want = jg.mlp_apply(jp, jnp.asarray(x), name="m", last_act=last_act)
        got = tg.mlp_apply(tp, torch.from_numpy(x), name="m",
                           last_act=last_act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    tf = tg.mlp(ParamFactory(torch.Generator(), torch.float32, "cpu"),
                (5, 8, 3), name="m")
    assert {k: tuple(v[0].shape) for k, v in tf.items()} == \
        {k: v.shape for k, v in jp.items()}


# --- SchNet and EGNN ----------------------------------------------------------

def _smoke_batch(cfg):
    d_in = getattr(cfg, "d_in", 4)
    return jg.random_graph_batch(KEY, 24, 96, d_in, coords=True,
                                 n_classes=getattr(cfg, "n_classes", 5),
                                 n_graphs=2)


_JMODS = {"schnet": jschnet, "egnn": jegnn}
_TMODS = {"schnet": tschnet, "egnn": tegnn}


@pytest.fixture(scope="module", params=["schnet", "egnn"])
def family(request):
    """The reference's smoke config, weights, batch, forward and jitted
    train step, computed once."""
    arch = request.param
    jcfg = jget_arch(arch).make_smoke()
    jp, _ = _JMODS[arch].init_params(jcfg, KEY)
    jb = _smoke_batch(jcfg)
    targets = jnp.asarray([0.5, -1.0], jnp.float32)
    out = _JMODS[arch].forward(jp, jb, jcfg)
    loss = lambda p: _JMODS[arch].loss_fn(p, jb, targets, jcfg)[0]
    return dict(arch=arch, jcfg=jcfg, jp=jp, jb=jb, targets=targets,
                out=jax.tree.map(np.asarray, out), ref=jax_step(loss, jp))


def test_smoke_forward_matches_reference(family):
    arch = family["arch"]
    cfg = get_arch(arch).make_smoke()
    got = _TMODS[arch].forward(to_torch_params(family["jp"]),
                               to_torch(family["jb"]), cfg)
    want = family["out"]
    if arch == "egnn":
        (got, coords), (want, jcoords) = got, want
        np.testing.assert_allclose(coords.numpy(), jcoords, rtol=1e-5,
                                   atol=1e-5)
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_smoke_train_step_matches_reference(family):
    arch = family["arch"]
    cfg = get_arch(arch).make_smoke()
    tp = to_torch_params(family["jp"])
    batch = to_torch(family["jb"])
    targets = to_torch(family["targets"])
    loss, grads = value_and_grad(
        lambda p: _TMODS[arch].loss_fn(p, batch, targets, cfg)[0], tp)
    p2, o2, m = full_step(arch, cfg, AdamWConfig())(
        tp, adamw_init(tp), batch, targets)
    assert float(m["loss"]) == float(loss)
    assert_step_matches(family["ref"], loss, grads, p2, o2)


def test_gnn_loss_is_the_families_loss(family):
    """``_gnn_steps.gnn_loss`` (``steps.py::_gnn_loss``) equals the
    family's own ``loss_fn``."""
    arch = family["arch"]
    cfg = get_arch(arch).make_smoke()
    tp = to_torch_params(family["jp"])
    batch, targets = to_torch(family["jb"]), to_torch(family["targets"])
    assert float(gnn_loss(arch, cfg)(tp, batch, targets)) == \
        float(_TMODS[arch].loss_fn(tp, batch, targets, cfg)[0])


def _rand_rot(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3))
    q, _ = np.linalg.qr(a)
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return q


@pytest.fixture(scope="module")
def geo_batch():
    return tg.random_graph_batch(rnd.prng_key(0), 20, 80, 4, coords=True,
                                 n_graphs=2, device="cpu")


def _rot_batch(batch, q):
    return batch._replace(coords=batch.coords @ q.T)


def test_egnn_equivariance(geo_batch):
    cfg = tegnn.EGNNConfig(d_in=4, d_hidden=16, n_layers=2)
    params, _ = tegnn.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    q = torch.from_numpy(_rand_rot(1, 8)[0]).float()
    e1, x1 = tegnn.forward(params, geo_batch, cfg)
    e2, x2 = tegnn.forward(params, _rot_batch(geo_batch, q), cfg)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((x1 @ q.T).numpy(), x2.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_schnet_invariance(geo_batch):
    cfg = tschnet.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=16)
    params, _ = tschnet.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    q = torch.from_numpy(_rand_rot(1, 9)[0]).float()
    e1 = tschnet.forward(params, geo_batch, cfg)
    e2 = tschnet.forward(params, _rot_batch(geo_batch, q), cfg)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-4)


def test_species_truncate_then_floor_modulo():
    """Column 0 -> species: ``astype(int32)`` truncates toward zero and
    ``%`` is a floor modulo, on negative features too."""
    feat = np.array([[-3.7], [-0.5], [0.9], [101.2], [-101.9], [250.0]],
                    np.float32)
    want = jnp.asarray(feat)[:, 0].astype(jnp.int32) % 100
    got = tg.species_of(torch.from_numpy(feat), 100)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist() == [97, 0, 0, 1, 99, 50]


# --- the registry -------------------------------------------------------------

_INIT = {"equiformer-v2": (jeqv2, "equiformer_v2"), "egnn": (jegnn, "egnn"),
         "schnet": (jschnet, "schnet"),
         "graphsage-reddit": (jsage, "graphsage"), "dlrm-rm2": (jdlrm, "dlrm")}


@pytest.mark.parametrize("arch", [a for a in J_ARCH_IDS if a in _INIT])
@pytest.mark.parametrize("which", ["make_config", "make_smoke"])
def test_gnn_and_dlrm_archs_build_on_meta(arch, which):
    """Each config equals the reference's field by field (dtypes aside)
    and its tree, built on ``meta``, has the reference's names, shapes
    and parameter count."""
    import importlib
    jcfg = getattr(jget_arch(arch), which)()
    tcfg = getattr(get_arch(arch), which)()
    ja = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
    ta = {k: v for k, v in dataclasses.asdict(tcfg).items() if k != "dtype"}
    assert ta == ja and tcfg.dtype == torch.float32
    jmod, name = _INIT[arch]
    tmod = importlib.import_module(
        "repro_torch.models." + ("dlrm" if name == "dlrm" else f"gnn.{name}"))
    tp, tax = tmod.init_params(tcfg, device="meta")
    jp, jax_ = jmod.init_params(jcfg, KEY, abstract=True)
    assert all(p.is_meta for p in tree_leaves(tp))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert tax == jax_
    n = sum(p.numel() for p in tree_leaves(tp))
    assert n == sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jp))
    if arch == "dlrm-rm2":
        assert tcfg.n_params == jcfg.n_params == n
    assert get_arch(arch).family == jget_arch(arch).family
    assert {k: dataclasses.asdict(v) for k, v in
            get_arch(arch).shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in jget_arch(arch).shapes.items()}


def test_every_arch_is_ported():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS + ["paper-ipgc"]:
        assert get_arch(arch).arch_id == arch


# --- the device rule ----------------------------------------------------------

def test_gnn_entry_points_default_to_the_card(monkeypatch):
    """Without ``device``, the GNN/DLRM entry points allocate on the CUDA
    device and raise where there is none."""
    from repro_torch.models import dlrm as tdlrm
    from repro_torch.models.gnn import equiformer_v2, graphsage
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, cfg in ((tschnet, get_arch("schnet").make_smoke()),
                     (tegnn, get_arch("egnn").make_smoke()),
                     (graphsage, get_arch("graphsage-reddit").make_smoke()),
                     (equiformer_v2, get_arch("equiformer-v2").make_smoke()),
                     (tdlrm, get_arch("dlrm-rm2").make_smoke())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.init_params(cfg)
        assert tree_leaves(mod.init_params(cfg, device="cpu")[0])[0] \
            .device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.random_graph_batch(rnd.prng_key(0), 4, 4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rnd.RecsysPipeline(3, 2, 10, 4).batch_at(0)
