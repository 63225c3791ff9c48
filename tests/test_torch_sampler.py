"""The port's neighbour sampler and GraphSAGE on the CPU against the
reference: ``sample_blocks`` from the same key on the same CSR (bit for
bit, isolated seeds and the span reduction's wide degrees included),
``blocks_to_graphbatch`` (bit for bit), ``forward_sampled`` and
``loss_sampled`` with their gradients on the reference's own blocks, the
smoke config's full-graph forward, loss, per-leaf gradients and one AdamW
step, one minibatch step, and ``forward_full_owner`` at 1, 2 and 4 shards
against ``forward_full``.

Tolerances: the sampler and ``blocks_to_graphbatch`` exactly; the model
as ``tests/_gnn_ref.py`` states (loss 1e-5 relative, gradients, m and v
1e-4 of each leaf's largest magnitude, parameters 1e-6);
``forward_full_owner`` within 1e-5, as
``tests/test_optimizations.py::test_owner_computes_matches_reference_single_shard``
holds the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.graphs.sampler import blocks_to_graphbatch as jblocks_to_gb
from repro.graphs.sampler import sample_blocks as jsample_blocks
from repro.models.gnn import common as jg
from repro.models.gnn import graphsage as jsage
from repro_torch.configs import get_arch
from repro_torch.data import pipelines as rnd
from repro_torch.graphs.sampler import blocks_to_graphbatch, sample_blocks
from repro_torch.models.common import cross_entropy
from repro_torch.models.gnn import common as tg
from repro_torch.models.gnn import graphsage as tsage
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

from _gnn_ref import assert_step_matches, jax_step, to_torch, \
    to_torch_params
from _gnn_steps import (csr_from_edges, full_step, minibatch_step,
                        value_and_grad)

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def _csr(n: int, e: int, seed: int, isolated=()):
    """A random directed CSR over ``n`` nodes, ``isolated`` without
    out-edges: (row_ptr, col_idx) as int32 tensors."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = ~np.isin(src, list(isolated))
    return csr_from_edges(torch.from_numpy(src[keep]),
                          torch.from_numpy(dst[keep]), n)


def test_csr_from_edges():
    src = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    dst = torch.tensor([1, 3, 0, 2, 1], dtype=torch.int32)
    rp, ci = csr_from_edges(src, dst, 4)
    assert rp.tolist() == [0, 2, 3, 5, 5] and ci.tolist() == [3, 1, 2, 1, 0]
    assert rp.dtype == ci.dtype == torch.int32


@pytest.mark.parametrize("n,e,fanouts,seed", [
    (40, 160, (3, 2), 0), (200, 3000, (5, 4), 1), (500, 200_000, (15, 10), 2),
    (50, 120, (1, 6, 2), 3)])
def test_sample_blocks_is_the_references(n, e, fanouts, seed):
    rp, ci = _csr(n, e, seed, isolated=(0, 7))
    seeds = torch.from_numpy(np.random.default_rng(seed + 10).integers(
        0, n, 16).astype(np.int32))
    seeds[:2] = torch.tensor([0, 7], dtype=torch.int32)   # isolated seeds
    want = jsample_blocks(jax.random.PRNGKey(seed), jnp.asarray(rp.numpy()),
                          jnp.asarray(ci.numpy()), jnp.asarray(seeds.numpy()),
                          fanouts)
    got = sample_blocks(rnd.prng_key(seed), rp, ci, seeds, fanouts)
    assert torch.equal(got.seeds, seeds)
    assert len(got.hops) == len(got.masks) == len(fanouts)
    for gh, wh, gm, wm in zip(got.hops, want.hops, got.masks, want.masks):
        assert gh.dtype == torch.int32 and gm.dtype == torch.bool
        assert np.array_equal(gh.numpy(), np.asarray(wh))
        assert np.array_equal(gm.numpy(), np.asarray(wm))
    assert not got.masks[0][:2].any()
    assert (got.hops[0][:2] == seeds[:2, None]).all()


def test_blocks_to_graphbatch_is_the_references():
    rp, ci = _csr(60, 300, 4, isolated=(3,))
    seeds = torch.tensor([3, 1, 2, 9], dtype=torch.int32)
    jblocks = jsample_blocks(KEY, jnp.asarray(rp.numpy()),
                             jnp.asarray(ci.numpy()),
                             jnp.asarray(seeds.numpy()), (3, 2))
    blocks = sample_blocks(rnd.prng_key(0), rp, ci, seeds, (3, 2))
    feats = np.random.default_rng(5).normal(size=(60, 5)).astype(np.float32)
    coords = np.random.default_rng(6).normal(size=(60, 3)).astype(np.float32)
    labels = np.arange(60, dtype=np.int32) % 7
    for c, lab in ((None, None), (coords, labels)):
        want = jblocks_to_gb(jblocks, jnp.asarray(feats),
                             None if c is None else jnp.asarray(c),
                             None if lab is None else jnp.asarray(lab))
        got = blocks_to_graphbatch(blocks, torch.from_numpy(feats),
                                   None if c is None else torch.from_numpy(c),
                                   None if lab is None
                                   else torch.from_numpy(lab))
        assert got.n_graphs == want.n_graphs == 1 and got.graph_id is None
        for name in ("node_feat", "edge_src", "edge_dst", "coords",
                     "node_label"):
            a, b = getattr(want, name), getattr(got, name)
            if a is None:
                assert b is None
                continue
            assert b.dtype == {np.float32: torch.float32,
                               np.int32: torch.int32}[np.asarray(a).dtype.type]
            assert np.array_equal(b.numpy(), np.asarray(a)), name


# --- GraphSAGE ----------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke config and weights, its full-graph train
    step on the smoke batch, and its sampled loss and gradients on its
    own blocks, computed once."""
    jcfg = jget_arch("graphsage-reddit").make_smoke()
    jp, _ = jsage.init_params(jcfg, KEY)
    jb = jg.random_graph_batch(KEY, 24, 96, jcfg.d_in, coords=True,
                               n_classes=jcfg.n_classes, n_graphs=2)
    full = jax_step(lambda p: jsage.loss_full(p, jb, jcfg)[0], jp)
    rp, ci = _csr(300, 2400, 8, isolated=(5,))
    feats = np.random.default_rng(9).normal(size=(300, jcfg.d_in)).astype(
        np.float32)
    labels = (np.arange(300) % jcfg.n_classes).astype(np.int32)
    seeds = np.arange(0, 32, dtype=np.int32)
    blocks = jsample_blocks(jax.random.PRNGKey(3), jnp.asarray(rp.numpy()),
                            jnp.asarray(ci.numpy()), jnp.asarray(seeds),
                            jcfg.fanouts)

    def sampled(p):
        return jsage.loss_sampled(p, jnp.asarray(feats), blocks,
                                  jnp.asarray(labels[seeds]), jcfg)[0]

    return dict(jcfg=jcfg, jp=jp, jb=jb, full=full, rp=rp, ci=ci,
                feats=feats, labels=labels, seeds=seeds, jblocks=blocks,
                logits=np.asarray(jsage.forward_sampled(
                    jp, jnp.asarray(feats), blocks, jcfg)),
                sampled=jax_step(sampled, jp))


def test_sage_smoke_forward_and_train_step_match_reference(smoke):
    cfg = get_arch("graphsage-reddit").make_smoke()
    tp = to_torch_params(smoke["jp"])
    batch = to_torch(smoke["jb"])
    want = jsage.forward_full(smoke["jp"], smoke["jb"], smoke["jcfg"])
    np.testing.assert_allclose(tsage.forward_full(tp, batch, cfg).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    loss, grads = value_and_grad(
        lambda p: tsage.loss_full(p, batch, cfg)[0], tp)
    p2, o2, _ = full_step("graphsage-reddit", cfg, AdamWConfig())(
        tp, adamw_init(tp), batch, None)
    assert_step_matches(smoke["full"], loss, grads, p2, o2)


def test_sage_sampled_matches_reference_on_its_blocks(smoke):
    cfg = get_arch("graphsage-reddit").make_smoke()
    tp = to_torch_params(smoke["jp"])
    jb = smoke["jblocks"]
    blocks = tsage.SampledBlocks(
        seeds=to_torch(jb.seeds), hops=tuple(to_torch(h) for h in jb.hops),
        masks=tuple(to_torch(m) for m in jb.masks))
    feats = torch.from_numpy(smoke["feats"])
    labels = torch.from_numpy(smoke["labels"][smoke["seeds"]])
    logits = tsage.forward_sampled(tp, feats, blocks, cfg)
    np.testing.assert_allclose(logits.detach().numpy(), smoke["logits"],
                               rtol=1e-5, atol=1e-5)
    loss, grads = value_and_grad(
        lambda p: tsage.loss_sampled(p, feats, blocks, labels, cfg)[0], tp)
    p2, o2, _ = adamw_update(grads, adamw_init(tp), tp, AdamWConfig())
    assert_step_matches(smoke["sampled"], loss, grads, p2, o2)


def test_sage_minibatch_step_samples_the_references_blocks(smoke):
    """The minibatch step (blocks sampled inside it, from a key) gives the
    reference's step on the reference's blocks from the same key."""
    cfg = get_arch("graphsage-reddit").make_smoke()
    tp = to_torch_params(smoke["jp"])
    step = minibatch_step("graphsage-reddit", cfg, AdamWConfig(),
                          cfg.fanouts)
    p2, o2, m = step(tp, adamw_init(tp), torch.from_numpy(smoke["feats"]),
                     None, torch.from_numpy(smoke["labels"]), smoke["rp"],
                     smoke["ci"], torch.from_numpy(smoke["seeds"]),
                     rnd.prng_key(3))
    jl, jgr, jp, jo = smoke["sampled"]
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    for k in jp:
        np.testing.assert_allclose(p2[k].detach().numpy(), jp[k], rtol=0,
                                   atol=1e-6)


def _ce(logits, batch):
    return cross_entropy(logits, batch.node_label)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_forward_full_owner_equals_forward_full(smoke, n_shards):
    cfg = get_arch("graphsage-reddit").make_smoke()
    tp = to_torch_params(smoke["jp"])
    batch = tg.random_graph_batch(rnd.prng_key(1), 24, 96, cfg.d_in,
                                  n_classes=cfg.n_classes, device="cpu")
    src, dst = tg.pad_edges(batch.edge_src.numpy(), batch.edge_dst.numpy(),
                            24, 100)
    batch = batch._replace(edge_src=torch.from_numpy(src),
                           edge_dst=torch.from_numpy(dst))
    want = tsage.forward_full(tp, batch, cfg)
    got = tsage.forward_full_owner(tp, batch, cfg,
                                   devices=["cpu"] * n_shards)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    # and its gradient reaches every parameter as forward_full's does
    g_own = value_and_grad(lambda p: _ce(tsage.forward_full_owner(
        p, batch, cfg, devices=["cpu"] * n_shards), batch), tp)[1]
    g_full = value_and_grad(lambda p: _ce(
        tsage.forward_full(p, batch, cfg), batch), tp)[1]
    for k in g_full:
        np.testing.assert_allclose(g_own[k].numpy(), g_full[k].numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_forward_full_owner_matches_reference_owner(smoke):
    """At one shard, against the reference's own owner-computes forward
    on a 1-device mesh."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jsage.forward_full_owner(smoke["jp"], smoke["jb"], smoke["jcfg"],
                                    mesh=mesh, node_axes=("data",))
    got = tsage.forward_full_owner(to_torch_params(smoke["jp"]),
                                   to_torch(smoke["jb"]),
                                   get_arch("graphsage-reddit").make_smoke(),
                                   devices=["cpu"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
