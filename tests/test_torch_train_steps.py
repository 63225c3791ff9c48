"""The port's LM training path on the CPU, part two: five
``build_step`` steps of the port against the reference's jitted
``build_step`` for the five LM smoke configs, from the same parameters
(drawn by the reference, carried across by ``params_from_numpy``) and the
same ``TokenPipeline`` batches (bit-equal in the two packages), and the
flash-attention chunk remat (the counterparts of
``tests/test_optimizations.py::test_flash_remat_*`` and
``tests/test_models.py::test_flash_attention_grad_finite``).

Tolerances: each step's loss within 1e-4 (measured: at most 1.5e-6 over
five steps — fp32 sums in another order than XLA's, through the
gradients and the update), the grad norms within 1e-4 relative. Flash
attention: remat against none
equal values and gradients within 1e-5 (the same ops, recomputed), and
each within 1e-4 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipelines import TokenPipeline as JTokenPipeline
from repro.launch.train import build_step as jbuild_step
from repro.models import transformer as jtfm
from repro.models.attention import flash_attention as jflash
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.configs import get_arch
from repro_torch.data.pipelines import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import flash_attention
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

LM_ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "nemotron-4-340b",
            "gemma-7b", "minitron-4b"]
OPT = dict(lr=3e-3, warmup_steps=20, total_steps=5)
LOSS_TOL = 1e-4


def _setup(arch):
    jcfg = jget_arch(arch).make_smoke()
    tcfg = get_arch(arch).make_smoke()
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(vocab=jcfg.vocab, seq_len=16, global_batch=2)
    return jcfg, tcfg, jp, tp, JTokenPipeline(**kw), TokenPipeline(**kw)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_five_build_steps_match_reference(arch):
    jcfg, tcfg, jp, tp, jpipe, tpipe = _setup(arch)
    jstep = jbuild_step(jcfg, JAdamWConfig(**OPT))
    tstep = ttrain.build_step(tcfg, tadamw.AdamWConfig(**OPT))
    jo, to = jadamw_init(jp), tadamw.adamw_init(tp)
    for step in range(5):
        jp, jo, jm = jstep(jp, jo, jpipe.batch_at(step))
        tp, to, tm = tstep(tp, to, tpipe.batch_at(step, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=LOSS_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert set(tm) == set(jm)
    assert int(to.step) == 5
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-3, atol=1e-4)


# --- flash attention ---------------------------------------------------------

def _q(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_flash_remat_same_values_and_grads():
    """``test_flash_remat_same_values_and_grads`` on the port, and each
    equal to the reference's."""
    q = _q((1, 128, 2, 16))

    def loss(t, rc):
        return (flash_attention(t, t, t, q_chunk=32, k_chunk=32,
                                remat_chunks=rc) ** 2).sum()

    got = {}
    for rc in (False, True):
        t = torch.from_numpy(q).requires_grad_(True)
        v = loss(t, rc)
        (g,) = torch.autograd.grad(v, t)
        got[rc] = (float(v.detach()), g)
    assert got[True][0] == pytest.approx(got[False][0], rel=1e-6)
    torch.testing.assert_close(got[True][1], got[False][1], rtol=1e-5,
                               atol=1e-6)
    jv, jg = jax.value_and_grad(lambda x: (jflash(
        x, x, x, q_chunk=32, k_chunk=32) ** 2).sum())(jnp.asarray(q))
    np.testing.assert_allclose(got[True][0], float(jv), rtol=1e-5)
    np.testing.assert_allclose(got[True][1].numpy(), np.asarray(jg),
                               rtol=1e-4, atol=1e-4)


def test_flash_attention_grad_finite():
    """Several causal chunks: the fully masked tiles give no NaN in the
    gradient, with or without remat, and it equals the reference's."""
    q = _q((1, 64, 2, 8), 1)
    jg = jax.grad(lambda x: jflash(x, x, x, q_chunk=16,
                                   k_chunk=16).sum())(jnp.asarray(q))
    for rc in (True, False):
        t = torch.from_numpy(q).requires_grad_(True)
        (g,) = torch.autograd.grad(flash_attention(
            t, t, t, q_chunk=16, k_chunk=16, remat_chunks=rc).sum(), t)
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)


def test_flash_remat_reduces_residual_memory():
    """``test_flash_remat_reduces_residual_memory`` on the port: the bytes
    autograd keeps for backward, counted with ``saved_tensors_hooks``,
    under a third with remat."""
    q = torch.from_numpy(_q((2, 512, 4, 32), 2)).requires_grad_(True)

    def run(rc):
        return _saved_bytes(lambda: (flash_attention(
            q, q, q, q_chunk=64, k_chunk=64, remat_chunks=rc) ** 2).sum())

    with_remat, without = run(True), run(False)
    assert with_remat < without / 3, (with_remat, without)


def test_flash_without_grad_runs_no_checkpoint(monkeypatch):
    """Inference (no tensor needs a gradient) takes the plain loop."""
    from repro_torch.models import attention

    def boom(*a, **k):
        raise AssertionError("checkpoint called without a gradient")

    monkeypatch.setattr(attention, "checkpoint", boom)
    q = torch.from_numpy(_q((1, 32, 2, 8), 3))
    out = flash_attention(q, q, q, q_chunk=8, k_chunk=8)
    assert out.shape == q.shape


def _saved_bytes(fn) -> int:
    """Bytes of the distinct tensors autograd saves for backward while
    ``fn`` runs (storages counted once)."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())
