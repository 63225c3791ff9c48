"""The port's compressed training step (``build_step(compress=True)``)
and its bf16 step on the CPU: three compressed steps at one replica
against the reference's jitted step on a one-device mesh, from the same
parameters (drawn by the reference, carried across by
``params_from_numpy``) and the same ``TokenPipeline`` batches; two
replicas on one device, each taking its half of the batch; and three
bf16 steps (``update_in_chunks``, as the full-width cell runs them)
against the reference's.

Tolerances: each step's loss within 1e-4 and its grad norm within 1e-4
relative (an int8 rounding that falls the other way for a ~1e-7
difference moves one gradient entry by 1/127 of its row's absmax, and
the loss by far less); the error trees as stated at their check. Two
replicas against ``compressed_psum`` of the halves' gradients: exact.
bf16: each loss within 1e-2 and grad norm within 1e-3 relative (bf16's
unit roundoff is 2^-8, and the two packages' bf16 products accumulate in
another order; measured: at most 1.6e-3 and 2e-4 over three steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipelines import TokenPipeline as JTokenPipeline
from repro.launch.train import build_step as jbuild_step
from repro.models import transformer as jtfm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.compression import compress_init as jcompress_init
from repro_torch.configs import get_arch
from repro_torch.data.pipelines import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.compression import compress_init, compressed_psum
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

OPT = dict(lr=3e-3, warmup_steps=20, total_steps=5)
LOSS_TOL = 1e-4


def _setup(arch):
    jcfg = jget_arch(arch).make_smoke()
    tcfg = get_arch(arch).make_smoke()
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(vocab=jcfg.vocab, seq_len=16, global_batch=2)
    return jcfg, tcfg, jp, tp, JTokenPipeline(**kw), TokenPipeline(**kw)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gemma-7b"])
def test_compressed_steps_match_reference_one_replica(arch):
    jcfg, tcfg, jp, tp, jpipe, tpipe = _setup(arch)
    mesh = jax.make_mesh((1,), ("data",))
    jstep = jbuild_step(jcfg, JAdamWConfig(**OPT), compress=True, mesh=mesh)
    tstep = ttrain.build_step(tcfg, tadamw.AdamWConfig(**OPT),
                              compress=True, mesh=["cpu"])
    jo, to = jadamw_init(jp), tadamw.adamw_init(tp)
    jerr, terr = jcompress_init(jp), [compress_init(tp)]
    for step in range(3):
        jp, jo, jerr, jm = jstep(jp, jo, jerr, jpipe.batch_at(step))
        tp, to, terr, tm = tstep(tp, to, terr, tpipe.batch_at(step, "cpu"))
        assert set(tm) == set(jm) == {"loss", "lr", "grad_norm"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=LOSS_TOL)
    # the error trees: close (their entries are differences of nearly equal
    # numbers: ~1e-6 of the gradient is ~1e-3 of the error), but where an
    # int8 rounding fell the other way, a quantum apart (at most twice the
    # largest error); that is rare
    assert len(terr) == 1
    for a, b in zip(jax.tree.leaves(jerr), tree_leaves(terr[0])):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-30)
        gap = np.abs(b.numpy() - a) / scale
        flips = gap > 0.1
        assert float(gap.max()) <= 2.5
        assert float(gap[~flips].max(initial=0.0)) <= 1e-2
        assert float(flips.mean()) <= 1e-3


def test_two_replicas_split_the_batch():
    """At two replicas on one device, each replica takes its half of the
    batch: the step reports replica 0's loss and updates with
    ``compressed_psum`` of the two halves' gradients."""
    cfg = get_arch("minitron-4b").make_smoke()
    params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(5),
                                device="cpu")
    batch = TokenPipeline(cfg.vocab, 8, 4).batch_at(0, "cpu")
    halves = [ttrain.value_and_grad(
        params, {k: v[h * 2:(h + 1) * 2] for k, v in batch.items()}, cfg)
        for h in range(2)]
    errs = [compress_init(params), compress_init(params)]
    want, want_errs = compressed_psum([h[2] for h in halves], errs)
    opt_cfg = tadamw.AdamWConfig()
    snapshot = tree_map(torch.clone, params)
    expect, _, _ = tadamw.adamw_update(want, tadamw.adamw_init(snapshot),
                                       snapshot, opt_cfg)
    step = ttrain.build_step(cfg, opt_cfg, compress=True,
                             mesh=["cpu", "cpu"])
    p2, _, err, m = step(params, tadamw.adamw_init(params), errs, batch)
    assert float(m["loss"]) == float(halves[0][0])
    for r in range(2):
        for a, b in zip(tree_leaves(err[r]),
                        tree_leaves(want_errs[r])):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(p2), tree_leaves(expect)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma-7b"])
def test_bf16_steps_track_reference(arch):
    jcfg = dataclasses.replace(jget_arch(arch).make_smoke(),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_arch(arch).make_smoke(),
                               dtype=torch.bfloat16)
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    opt = dict(OPT, update_in_chunks=True)
    jstep = jbuild_step(jcfg, JAdamWConfig(**opt))
    tstep = ttrain.build_step(tcfg, tadamw.AdamWConfig(**opt))
    jo, to = jadamw_init(jp), tadamw.adamw_init(tp)
    kw = dict(vocab=jcfg.vocab, seq_len=16, global_batch=2)
    jpipe, tpipe = JTokenPipeline(**kw), TokenPipeline(**kw)
    for step in range(3):
        jp, jo, jm = jstep(jp, jo, jpipe.batch_at(step))
        tp, to, tm = tstep(tp, to, tpipe.batch_at(step, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(tp))
