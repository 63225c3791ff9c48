"""The port's LM training path on the CPU, part one: ``loss_fn``'s
gradients against ``jax.value_and_grad`` of the reference's for the five
LM smoke configs (the same weights, drawn by the reference and carried
across by ``params_from_numpy``; remat on, as the configs have it), and
the layer remat against no remat. Part two (``test_torch_train_steps.py``)
holds whole steps and the flash-attention remat; the driver's CLI, resume
and device rule are in ``test_torch_ckpt.py``.

Tolerances: each gradient leaf within 1e-4 of the reference's, relative
to the leaf's largest magnitude (measured: at most 8.5e-7 — fp32 sums in
another order than XLA's through two layers and their backward); the
loss within 1e-5 relative. Remat against no remat in the port: equal
values and gradients within 1e-6 (the same ops, recomputed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtfm
from repro_torch.configs import get_arch
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

LM_ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "nemotron-4-340b",
            "gemma-7b", "minitron-4b"]
GRAD_TOL = 1e-4


def _batch(vocab: int, seed: int = 1, shape=(2, 16)) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _torch_params(jp) -> dict:
    return tfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_fn_gradients_match_reference(arch):
    jcfg = jget_arch(arch).make_smoke()
    tcfg = get_arch(arch).make_smoke()
    assert tcfg.remat and jcfg.remat
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _torch_params(jp)
    batch = _batch(jcfg.vocab)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg),
        has_aux=True)(jp)
    tl, tparts, tg = ttrain.value_and_grad(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tparts["aux"]), float(jparts["aux"]),
                               rtol=1e-5, atol=1e-7)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(b.numpy() - a).max()) / scale
        assert err <= GRAD_TOL, (path, err)
    # every float leaf now requires grad, the stacks stay stacked
    assert all(p.requires_grad for p in tree_leaves(tp))
    assert tg["layers"]["wq"].shape[0] == tcfg.n_layers


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gemma-7b"])
def test_layer_remat_same_values_and_grads(arch):
    cfg = get_arch(arch).make_smoke()
    params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 2).items()}
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = ttrain.value_and_grad(params, batch, c)
    assert float(out[True][0]) == pytest.approx(float(out[False][0]),
                                                rel=1e-6)
    for a, b in zip(tree_leaves(out[True][2]),
                    tree_leaves(out[False][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_layer_remat_saves_less():
    """With remat, what the graph keeps for backward is each layer's input
    (and the head's), not every layer's activations."""
    cfg = dataclasses.replace(get_arch("gemma-7b").make_smoke(), n_layers=4)
    params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(4),
                                device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.from_numpy(_batch(cfg.vocab, 3, (2, 32))["tokens"])
    saved = {r: _saved_bytes(lambda: tfm.forward(
        params, toks, dataclasses.replace(cfg, remat=r))[0].sum())
        for r in (True, False)}
    assert saved[True] < saved[False] / 2, saved


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
