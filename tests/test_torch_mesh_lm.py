"""The LM stack's mesh forms (``repro_torch.models.transformer``'s
``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` with ``mesh``,
``batch_axes`` and ``fsdp_axes``) against ``repro`` on the CPU: the
reference on four forced host devices in a subprocess
(``tests/_mesh_ref.py``; its meshes automatic, under ``jax.set_mesh`` and
``jit``), the port on a ``DeviceMesh`` of ``"cpu"`` entries, the
reference's weights carried across.

Cases: ``qwen3-moe-30b-a3b``'s smoke config at (2, 2) and (1, 4) and
``minitron-4b``'s at (2, 2), ``batch_axes = fsdp_axes = ("data",)``,
tokens (4, 12): forward logits and aux, ``loss_fn`` value and per-leaf
gradients, prefill of 9 tokens into a 16-slot cache and three decode
steps. Tolerances are ``tests/test_torch_lm.py``'s: 1e-4 absolute and
relative for logits, losses and the cache; each gradient leaf within 1e-4
of its largest magnitude (``tests/test_torch_train.py``'s). Beside them,
the port's own checks: a shard's cache rows on its device, the mesh
prefill equal to the unsharded prefill of each half batch, the int8
cache, the refusals, and ``serve`` on a mesh.
"""
import numpy as np
import pytest
import torch

from _mesh_ref import (LM_CASES, LM_MAX_LEN, LM_PREFILL, LM_TOKENS,
                       case_key, run, unflat)
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_local_mesh, make_mesh, place_params
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as tfm
from repro_torch.models.common import params_from_numpy

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_Q8 = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = 1e-4
AXES = dict(batch_axes=("data",), fsdp_axes=("data",))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_lm") / "lm.npz"
    run("lm", str(path))
    data = np.load(path)
    params = {arch: params_from_numpy(unflat(data, f"params|{arch}"),
                                      device="cpu")
              for arch in dict(LM_CASES)}
    return dict(data=data, params=params,
                tokens=torch.from_numpy(data["tokens"]))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), "cpu")


def _np(t):
    return t.detach().numpy()


CASES = [pytest.param(a, s, id=f"{a}-{s}") for a, s in LM_CASES]


@pytest.mark.parametrize("arch,shape", CASES)
def test_mesh_forward_and_loss_match(ref, arch, shape):
    cfg = get_arch(arch).make_smoke()
    key = case_key(arch, shape)
    kw = dict(mesh=_mesh(shape), **AXES)
    logits, aux, _ = tfm.forward(ref["params"][arch], ref["tokens"], cfg,
                                 **kw)
    assert logits.shape == (*LM_TOKENS, cfg.vocab)
    np.testing.assert_allclose(_np(logits), ref["data"][f"{key}|logits"],
                               **TOL)
    np.testing.assert_allclose(float(aux), float(ref["data"][f"{key}|aux"]),
                               **TOL)
    toks = ref["tokens"]
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    loss, parts = tfm.loss_fn(ref["params"][arch], batch, cfg, **kw)
    np.testing.assert_allclose(float(loss), float(ref["data"][f"{key}|loss"]),
                               **TOL)
    np.testing.assert_allclose(float(parts["ce"]),
                               float(ref["data"][f"{key}|ce"]), **TOL)


@pytest.mark.parametrize("arch,shape", CASES)
def test_mesh_gradients_match(ref, arch, shape):
    """``loss_fn``'s gradients through the mesh form (autograd across the
    shards, the per-layer remat included) against the reference's
    ``value_and_grad`` under its mesh."""
    cfg = get_arch(arch).make_smoke()
    key = case_key(arch, shape)
    params = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_())
              for k, v in ref["params"][arch].items()}
    toks = ref["tokens"]
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    loss, _ = tfm.loss_fn(params, batch, cfg, mesh=_mesh(shape), **AXES)
    loss.backward()
    want = unflat(ref["data"], f"{key}|grads")
    flat_want = {**{k: v for k, v in want.items() if k != "layers"},
                 **{f"layers/{k}": v for k, v in want["layers"].items()}}
    flat_got = {**{k: v for k, v in params.items() if k != "layers"},
                **{f"layers/{k}": v for k, v in params["layers"].items()}}
    assert flat_got.keys() == flat_want.keys()
    for name, w in flat_want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(_np(flat_got[name].grad) - w).max()) / scale
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("arch,shape", CASES)
def test_mesh_prefill_and_decode_match(ref, arch, shape):
    cfg = get_arch(arch).make_smoke()
    key = case_key(arch, shape)
    mesh = _mesh(shape)
    params, toks = ref["params"][arch], ref["tokens"]
    last, cache = tfm.prefill(params, toks[:, :LM_PREFILL], cfg, mesh=mesh,
                              max_len=LM_MAX_LEN, **AXES)
    assert isinstance(cache, tfm.MeshKVCache)
    assert len(cache.shards) == shape[0]
    for i, c in enumerate(cache.shards):
        assert c.k.shape[1] == LM_TOKENS[0] // shape[0]
        assert c.k.device == mesh.device(data=i)
    np.testing.assert_allclose(_np(last), ref["data"][f"{key}|prefill"],
                               **TOL)
    np.testing.assert_allclose(_np(cache.k), ref["data"][f"{key}|cache_k"],
                               **TOL)
    np.testing.assert_allclose(_np(cache.v), ref["data"][f"{key}|cache_v"],
                               **TOL)
    for i in range(LM_PREFILL, LM_TOKENS[1]):
        lg, cache = tfm.decode_step(params, toks[:, i:i + 1], cache, cfg,
                                    mesh=mesh, **AXES)
        assert lg.shape == (LM_TOKENS[0], cfg.vocab)
        np.testing.assert_allclose(_np(lg), ref["data"][f"{key}|decode{i}"],
                                   **TOL)
    np.testing.assert_array_equal(_np(cache.length),
                                  ref["data"][f"{key}|length"])


def test_mesh_prefill_is_each_half_batch_alone(ref):
    """At (2, 2) each data shard's MoE sees only its own tokens: the mesh
    prefill equals two unsharded prefills of the half batches."""
    arch = "qwen3-moe-30b-a3b"
    cfg = get_arch(arch).make_smoke()
    params, toks = ref["params"][arch], ref["tokens"]
    got, _ = tfm.prefill(params, toks, cfg, mesh=_mesh((2, 2)), **AXES)
    halves = [tfm.prefill(params, t, cfg)[0] for t in toks.split(2)]
    np.testing.assert_allclose(_np(got), _np(torch.cat(halves)), **TOL)


def test_mesh_int8_cache(ref):
    """The dense stack (no capacity: a mesh changes no value): the mesh's
    int8 cache, quantized shard by shard, decodes as the unsharded int8
    cache does."""
    arch = "minitron-4b"
    cfg = get_arch(arch).make_smoke()
    params, toks = ref["params"][arch], ref["tokens"]
    mesh = _mesh((2, 2))
    _, mc = tfm.prefill(params, toks[:, :LM_PREFILL], cfg, mesh=mesh,
                        max_len=LM_MAX_LEN, **AXES)
    _, wc = tfm.prefill(params, toks[:, :LM_PREFILL], cfg,
                        max_len=LM_MAX_LEN)
    mc, wq = tfm.quantize_cache(mc), tfm.quantize_cache(wc)
    assert mc.quantized and mc.k.dtype == torch.int8
    tok = toks[:, LM_PREFILL:LM_PREFILL + 1]
    got, mc = tfm.decode_step(params, tok, mc, cfg, mesh=mesh, **AXES)
    want, _ = tfm.decode_step(params, tok, wq, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL_Q8)
    np.testing.assert_array_equal(_np(mc.length), LM_PREFILL + 1)


def test_mesh_axes_need_a_mesh(ref):
    arch = "minitron-4b"
    cfg = get_arch(arch).make_smoke()
    params, toks = ref["params"][arch], ref["tokens"]
    with pytest.raises(ValueError, match="pass mesh="):
        tfm.forward(params, toks, cfg, batch_axes=("data",))
    _, cache = tfm.prefill(params, toks[:, :4], cfg, mesh=_mesh((2, 2)),
                           max_len=8, **AXES)
    with pytest.raises(ValueError, match="pass mesh="):
        tfm.decode_step(params, toks[:, 4:5], cache, cfg)
    _, whole = tfm.prefill(params, toks[:, :4], cfg, max_len=8)
    with pytest.raises(ValueError, match="MeshKVCache"):
        tfm.decode_step(params, toks[:, 4:5], whole, cfg, mesh=_mesh((2, 2)),
                        **AXES)
    with pytest.raises(ValueError, match="MeshKVCache"):
        tfm.decode_step(params, toks[:, 4:5], cache, cfg, mesh=_mesh((1, 4)),
                        **AXES)
    with pytest.raises(ValueError, match="does not split"):
        tfm.forward(params, toks[:3], cfg, mesh=_mesh((2, 2)), **AXES)


def test_serve_on_a_mesh(ref):
    """``serve`` with a mesh: on the one-entry local mesh it serves the
    same tokens as without one, bit for bit; at (2, 2) with placed expert
    weights it serves finite logits of the requested shapes."""
    arch = "qwen3-moe-30b-a3b"
    cfg = get_arch(arch).make_smoke()
    params = ref["params"][arch]
    kw = dict(batch=4, prompt_len=8, gen=4, device="cpu")
    plain = serve(cfg, params=params,
                  generator=torch.Generator().manual_seed(3), **kw)
    local = serve(cfg, params=params, mesh=make_local_mesh("cpu"),
                  generator=torch.Generator().manual_seed(3), **kw, **AXES)
    assert torch.equal(local.tokens, plain.tokens)
    assert torch.equal(local.prefill_logits, plain.prefill_logits)
    mesh = _mesh((2, 2))
    placed = place_params(params, mesh, fsdp_axes=("data",))
    r = serve(cfg, params=placed, mesh=mesh, kv_int8=True,
              generator=torch.Generator().manual_seed(3), **kw, **AXES)
    assert tuple(r.tokens.shape) == (4, 4)
    assert torch.isfinite(r.prefill_logits).all()
    assert torch.isfinite(r.step_logits).all()
