"""The port's DLRM and ``RecsysPipeline`` on the CPU against the
reference: the batches (``sparse`` and ``labels`` bit for bit), the smoke
config's forward, loss, per-leaf gradients and one AdamW step from the
reference's weights, ``retrieval_score``, ``embedding_bag`` in both
modes, and the reference's own checks (the bag modes, the interaction
count).

Tolerances: the batches' ``dense`` within ``pipelines.NORMAL_TOL``
(torch's float32 ``erfinv`` is not XLA's), the model as
``tests/_gnn_ref.py`` states (loss 1e-5 relative, gradients, m and v 1e-4
of each leaf's largest magnitude, parameters 1e-6), forward and scores
within 1e-5, ``embedding_bag`` within 1e-6 (as the reference's test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipelines import RecsysPipeline as JRecsysPipeline
from repro.models import dlrm as jdlrm
from repro_torch.configs import get_arch
from repro_torch.data import pipelines as rnd
from repro_torch.data.pipelines import RecsysPipeline
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim.adamw import AdamWConfig, adamw_init

from _gnn_ref import assert_step_matches, jax_step, to_torch_params
from _gnn_steps import dlrm_step, value_and_grad

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("kw", [
    dict(n_dense=4, n_sparse=3, vocab=50, global_batch=8),
    dict(n_dense=13, n_sparse=26, vocab=1000, global_batch=64, seed=3),
    dict(n_dense=13, n_sparse=26, vocab=1_000_000, global_batch=32, hot=3,
         seed=11)])
def test_recsys_pipeline_is_the_references(kw):
    want_p, got_p = JRecsysPipeline(**kw), RecsysPipeline(**kw)
    for step in (0, 1, 17):
        want, got = want_p.batch_at(step), got_p.batch_at(step, "cpu")
        assert got["sparse"].dtype == torch.int32
        assert got["labels"].dtype == torch.bool
        assert got["sparse"].shape == (kw["global_batch"], kw["n_sparse"],
                                       kw.get("hot", 1))
        assert np.array_equal(got["sparse"].numpy(),
                              np.asarray(want["sparse"]))
        assert np.array_equal(got["labels"].numpy(),
                              np.asarray(want["labels"]))
        np.testing.assert_allclose(got["dense"].numpy(),
                                   np.asarray(want["dense"]), rtol=0,
                                   atol=rnd.NORMAL_TOL)


@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke config, weights, a pipeline batch, forward
    and jitted train step, computed once."""
    jcfg = jget_arch("dlrm-rm2").make_smoke()
    jp, _ = jdlrm.init_params(jcfg, KEY)
    jb = JRecsysPipeline(n_dense=jcfg.n_dense, n_sparse=jcfg.n_sparse,
                         vocab=jcfg.vocab_per_table, global_batch=16,
                         seed=1).batch_at(0)
    loss = lambda p: jdlrm.loss_fn(p, jb, jcfg)[0]
    cands = np.random.default_rng(2).normal(size=(300, jcfg.embed_dim)
                                            ).astype(np.float32)
    score = jdlrm.retrieval_score(jp, jb["dense"][:1], jb["sparse"][:1],
                                  jnp.asarray(cands), jcfg)
    return dict(jp=jp, jb=jax.tree.map(np.asarray, jb), cands=cands,
                out=np.asarray(jdlrm.forward(jp, jb["dense"], jb["sparse"],
                                             jcfg)),
                score=np.asarray(score), ref=jax_step(loss, jp))


def _batch(jb) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def test_dlrm_smoke_forward_and_retrieval_match_reference(smoke):
    cfg = get_arch("dlrm-rm2").make_smoke()
    tp = to_torch_params(smoke["jp"])
    b = _batch(smoke["jb"])
    got = tdlrm.forward(tp, b["dense"], b["sparse"], cfg)
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), smoke["out"], rtol=1e-5,
                               atol=1e-5)
    s = tdlrm.retrieval_score(tp, b["dense"][:1], b["sparse"][:1],
                              torch.from_numpy(smoke["cands"]), cfg)
    assert s.shape == (300,)
    np.testing.assert_allclose(s.numpy(), smoke["score"], rtol=1e-5,
                               atol=1e-5)


def test_dlrm_smoke_train_step_matches_reference(smoke):
    cfg = get_arch("dlrm-rm2").make_smoke()
    tp = to_torch_params(smoke["jp"])
    b = _batch(smoke["jb"])
    loss, grads = value_and_grad(lambda p: tdlrm.loss_fn(p, b, cfg)[0], tp)
    p2, o2, m = dlrm_step(cfg, AdamWConfig())(tp, adamw_init(tp), b)
    assert float(m["loss"]) == float(loss)
    assert_step_matches(smoke["ref"], loss, grads, p2, o2)


def test_dlrm_update_in_chunks_is_the_same_step(smoke):
    """``update_in_chunks`` walks the (26, V, d) tables a table at a time:
    the same step."""
    cfg = get_arch("dlrm-rm2").make_smoke()
    b = _batch(smoke["jb"])
    out = {}
    for chunks in (False, True):
        tp = to_torch_params(smoke["jp"])
        out[chunks] = dlrm_step(cfg, AdamWConfig(update_in_chunks=chunks))(
            tp, adamw_init(tp), b)
    for k in out[False][0]:
        assert torch.equal(out[True][0][k], out[False][0][k]), k
        assert torch.equal(out[True][1].v[k], out[False][1].v[k]), k


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    table = np.random.default_rng(3).normal(size=(30, 6)).astype(np.float32)
    idx = np.array([0, 1, 2, 5, 9, 9, 4], np.int32)
    off = np.array([0, 3, 4, 4], np.int32)           # bag 2 is empty
    want = jdlrm.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(off), mode=mode)
    t = torch.from_numpy(table).requires_grad_(True)
    got = tdlrm.embedding_bag(t, torch.from_numpy(idx), torch.from_numpy(off),
                              mode=mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert not got[2].any()
    (g,) = torch.autograd.grad(got.sum(), t)
    jgr = jax.grad(lambda x: jdlrm.embedding_bag(
        x, jnp.asarray(idx), jnp.asarray(off), mode=mode).sum())(
        jnp.asarray(table))
    np.testing.assert_allclose(g.numpy(), np.asarray(jgr), rtol=1e-6)


def test_embedding_bag_modes():
    table = torch.from_numpy(np.array(jax.random.normal(KEY, (30, 6))))
    idx = torch.tensor([0, 1, 2, 5, 9, 9], dtype=torch.int32)
    off = torch.tensor([0, 3, 4], dtype=torch.int32)
    s = tdlrm.embedding_bag(table, idx, off, mode="sum")
    m = tdlrm.embedding_bag(table, idx, off, mode="mean")
    np.testing.assert_allclose(s[0].numpy(),
                               (table[0] + table[1] + table[2]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(m[2].numpy(), table[9].numpy(), rtol=1e-6)


def test_dlrm_interaction_count():
    cfg = tdlrm.DLRMConfig(vocab_per_table=100, embed_dim=8,
                           bot_mlp=(16, 8), top_mlp=(16, 1))
    params, _ = tdlrm.init_params(cfg, device="cpu")
    n_int = cfg.n_sparse + 1
    d_inter = n_int * (n_int - 1) // 2 + cfg.embed_dim
    assert params["top_w0"].shape[0] == d_inter == 359
    out = tdlrm.forward(params, torch.zeros(3, 13),
                        torch.zeros(3, 26, 1, dtype=torch.int32), cfg)
    assert out.shape == (3,)


def test_dlrm_step_frees_its_gradients():
    """A step's gradients die with it, without waiting for the garbage
    collector (at full width each table gradient is 6.66 GB)."""
    import gc
    import weakref

    from repro_torch import tree
    cfg = get_arch("dlrm-rm2").make_smoke()
    params, _ = tdlrm.init_params(cfg, device="cpu")
    b = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.vocab_per_table,
                       8).batch_at(0, "cpu")
    seen = []
    real = tree.tree_unflatten

    def spy(like, leaves):
        leaves = list(leaves)
        seen.extend(weakref.ref(x) for x in leaves)
        return real(like, leaves)

    gc.disable()
    try:
        from repro_torch.launch import steps
        steps.tree_unflatten = spy
        try:
            dlrm_step(cfg, AdamWConfig())(params, adamw_init(params), b)
        finally:
            steps.tree_unflatten = real
        assert seen and all(r() is None for r in seen)
    finally:
        gc.enable()
