"""The port's LM stack (``repro_torch.models.transformer``) against
``repro.models.transformer`` on the CPU, for the five LM archs' smoke
configs: the same weights (drawn by the reference, carried across by
``params_from_numpy``) and the same seeded tokens give the same
``forward`` logits, ``prefill`` logits and cache, and three teacher-forced
``decode_step`` logits, with the plain and the int8 cache; decode equals
forward at the last position (``tests/test_configs_smoke.py``); the full
configs' parameter counts on ``device="meta"``.

Tolerances: whole-model logits 1e-4 absolute and relative (fp32, two
layers of sums taken in another order than XLA's: the measured gap is
~1e-6); the int8 cache 2e-3 (an int8 rounding that falls on the other
side of .5 for a ~1e-7 difference moves one cache entry by 1/127 of its
row's absmax); decode against forward the reference's own 2e-3 / 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtfm
from repro.models.attention import KVCache as JKVCache
from repro.models.attention import quantize_kv as jquantize_kv
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import transformer as tfm

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

LM_ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "nemotron-4-340b",
            "gemma-7b", "minitron-4b"]
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_Q8 = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module", params=LM_ARCHS)
def case(request):
    """(arch, reference cfg, port cfg, reference params, port params,
    tokens (2, 12) int32)."""
    arch = request.param
    jcfg = jget_arch(arch).make_smoke()
    tcfg = get_arch(arch).make_smoke()
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12)).astype(
        np.int32)
    return arch, jcfg, tcfg, jp, tp, toks


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def test_config_matches_reference(case):
    arch, jcfg, tcfg, *_ = case
    for f in dataclasses.fields(tcfg):
        if f.name in ("dtype", "moe"):
            continue
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    assert (tcfg.moe is None) == (jcfg.moe is None)
    if tcfg.moe:
        assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
    assert (tcfg.n_params, tcfg.n_active_params) == \
        (jcfg.n_params, jcfg.n_active_params)


def test_forward_and_loss_match(case):
    _, jcfg, tcfg, jp, tp, toks = case
    jl, jaux, _ = jtfm.forward(jp, jnp.asarray(toks), jcfg)
    tl, taux, _ = tfm.forward(tp, torch.from_numpy(toks), tcfg)
    assert tl.shape == (2, 12, tcfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss, jparts = jtfm.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tloss, tparts = tfm.loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]),
                               **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_and_decode_match(case, int8):
    """Prefill 9 tokens into a 16-slot cache, then three teacher-forced
    decode steps; the int8 cache is the prefilled one re-quantized, as the
    serve drivers do."""
    _, jcfg, tcfg, jp, tp, toks = case
    jlast, jc = jtfm.prefill(jp, jnp.asarray(toks[:, :9]), jcfg, max_len=16)
    tlast, tc = tfm.prefill(tp, torch.from_numpy(toks[:, :9]), tcfg,
                            max_len=16)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **TOL)
    assert tuple(tc.k.shape) == jc.k.shape
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), **TOL)
    np.testing.assert_array_equal(_np(tc.length), _np(jc.length))
    if int8:
        kq, ks = jquantize_kv(jc.k)
        vq, vs = jquantize_kv(jc.v)
        jc = JKVCache(k=kq, v=vq, length=jc.length, k_scale=ks, v_scale=vs)
        tc = tfm.quantize_cache(tc)
        assert tc.quantized and tc.k.dtype == torch.int8
    tol = TOL_Q8 if int8 else TOL
    for i in range(9, 12):
        jlg, jc = jtfm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                                   jcfg)
        tlg, tc = tfm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), tc,
                                  tcfg)
        assert tlg.shape == (2, tcfg.vocab)
        np.testing.assert_allclose(_np(tlg), _np(jlg), **tol)
        np.testing.assert_array_equal(_np(tc.length), _np(jc.length))


def test_decode_equals_forward_at_the_last_position(case):
    """``tests/test_configs_smoke.py::test_lm_smoke_decode`` on the port."""
    _, _, tcfg, _, tp, toks = case
    t = torch.from_numpy(toks)
    full, _, _ = tfm.forward(tp, t, tcfg)
    _, cache = tfm.prefill(tp, t[:, :11], tcfg, max_len=16)
    logits, cache2 = tfm.decode_step(tp, t[:, 11:12], cache, tcfg)
    np.testing.assert_allclose(_np(logits), _np(full[:, 11]), atol=2e-3,
                               rtol=2e-2)
    assert int(cache2.length[0]) == 12


def test_module_holds_the_reference_tree(case):
    _, jcfg, tcfg, jp, tp, toks = case
    m = tfm.TransformerLM(tcfg, tp)
    names = dict(m.named_parameters())
    flat = {"embed", "lm_head", "final_norm"} | {
        f"layers.{k}" for k in jp["layers"]}
    assert set(names) == flat
    for k, v in jp["layers"].items():
        assert tuple(names[f"layers.{k}"].shape) == v.shape
        assert v.shape[0] == tcfg.n_layers
    assert not any(p.requires_grad for p in m.parameters())
    got, _, _ = m(torch.from_numpy(toks))
    want, _, _ = tfm.forward(tp, torch.from_numpy(toks), tcfg)
    assert torch.equal(got, want)


def test_init_params_shapes_and_axes_match(case):
    _, jcfg, tcfg, *_ = case
    jp, jaxes = jtfm.init_params(jcfg, jax.random.PRNGKey(0), abstract=True)
    gen = torch.Generator().manual_seed(0)
    tp, taxes = tfm.init_params(tcfg, gen, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == \
        {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
             if isinstance(v, dict) else tuple(v.shape))
         for k, v in tp.items()}
    assert taxes == jaxes
    assert all(torch.isfinite(v).all() for v in tp["layers"].values())
    assert not tp["layers"]["ln1"].any()
    # random init: same seed, same weights
    again, _ = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])


def test_bf16_weights_cross_bit_for_bit():
    cfg = jget_arch("gemma-7b").make_smoke()
    cfg = dataclasses.replace(cfg, dtype=jnp.bfloat16)
    jp, _ = jtfm.init_params(cfg, jax.random.PRNGKey(2))
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"]["wq"].float().numpy(),
        np.asarray(jp["layers"]["wq"].astype(jnp.float32)))


#: ``tests/test_configs_smoke.py``'s published ranges
_RANGES = {"qwen3-moe-30b-a3b": (29e9, 32e9),
           "moonshot-v1-16b-a3b": (26e9, 30e9),
           "nemotron-4-340b": (320e9, 350e9),
           "gemma-7b": (8e9, 10e9),
           "minitron-4b": (4e9, 6e9)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_configs_on_meta(arch):
    """The published configs build on ``device="meta"`` (no storage): the
    parameter count equals the reference's ``n_params``, sits in the
    published range, and the tree holds that many elements."""
    cfg = get_arch(arch).make_config()
    jcfg = jget_arch(arch).make_config()
    assert cfg.dtype == torch.bfloat16
    assert (cfg.n_params, cfg.n_active_params) == \
        (jcfg.n_params, jcfg.n_active_params)
    lo, hi = _RANGES[arch]
    assert lo <= cfg.n_params <= hi
    params, _ = tfm.init_params(cfg, device="meta")
    leaves = [params["embed"], params["lm_head"], params["final_norm"],
              *params["layers"].values()]
    assert all(x.is_meta for x in leaves)
    total = sum(x.numel() for x in leaves)
    assert abs(total - cfg.n_params) / cfg.n_params < 0.02


def test_qwen3_full_width_layer_and_head_counts():
    """The serving cell's arithmetic: one Qwen3-30B-A3B layer holds
    623,120,384 parameters and the embedding, head and final norm
    622,331,904."""
    cfg = get_arch("qwen3-moe-30b-a3b").make_config()
    one = dataclasses.replace(cfg, n_layers=1).n_params
    zero = dataclasses.replace(cfg, n_layers=0).n_params
    assert zero == 622_331_904 and one - zero == 623_120_384
    assert dataclasses.replace(cfg, n_layers=8).n_params == 5_607_294_976


def test_arch_registry():
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ("equiformer-v2", "egnn", "schnet", "graphsage-reddit",
                 "dlrm-rm2"):
        assert get_arch(arch).family == jget_arch(arch).family
    with pytest.raises(KeyError):
        get_arch("nope")
    ipgc = get_arch("paper-ipgc")
    assert ipgc.make_config() == jget_arch("paper-ipgc").make_config()
    assert {k: dataclasses.asdict(v) for k, v in ipgc.shapes.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in jget_arch("paper-ipgc").shapes.items()}
    for arch in LM_ARCHS:
        assert set(get_arch(arch).shapes) == set(jget_arch(arch).shapes)
        assert get_arch(arch).make_smoke().n_layers <= 4
