"""The port's model building blocks against ``repro.models`` on the CPU:
the shared layers, attention (flash at the chunk shapes and GQA groups of
``tests/test_models.py``, decode over a plain and an int8 cache) and the
MoE router, dispatch and expert compute. Inputs come from seeded numpy and
go to both packages; fp32 throughout.

Tolerances: 1e-5 relative (and 1e-5 absolute near zero) for attention and
the MoE outputs — fp32 sums taken in another order than XLA's, a few ulps
of fp32 over sums of at most a few hundred terms; expert ids, keep flags
and slots exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# --- common ---------------------------------------------------------------

def test_rms_and_layer_norm_match():
    x = _rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    g = _rng(1).normal(size=(16,)).astype(np.float32)
    b = _rng(2).normal(size=(16,)).astype(np.float32)
    (jx, tx), (jg, tg), (jb, tb) = _both(x), _both(g), _both(b)
    _close(tcommon.rms_norm(tx, tg), jcommon.rms_norm(jx, jg))
    _close(tcommon.layer_norm(tx, tg, tb), jcommon.layer_norm(jx, jg, jb))
    # bf16 in, bf16 out, math in fp32 (the reference's casts)
    got = tcommon.rms_norm(tx.bfloat16(), tg.bfloat16())
    want = jcommon.rms_norm(jx.astype(jnp.bfloat16), jg.astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("name", ["swiglu", "geglu", "relu2", "gelu"])
def test_activation_matches(name):
    x = _rng(3).normal(size=(4, 8)).astype(np.float32)
    gate = _rng(4).normal(size=(4, 8)).astype(np.float32)
    (jx, tx), (jgt, tgt) = _both(x), _both(gate)
    assert tcommon.is_gated(name) == jcommon.is_gated(name)
    _close(tcommon.activation(name, tx, tgt),
           jcommon.activation(name, jx, jgt))
    with pytest.raises(ValueError):
        tcommon.activation("nope", tx)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(masked):
    logits = _rng(5).normal(size=(2, 6, 11)).astype(np.float32)
    labels = _rng(6).integers(0, 11, (2, 6)).astype(np.int32)
    mask = (_rng(7).random((2, 6)) < 0.5).astype(np.float32)
    (jl, tl), (jy, ty), (jm, tm) = _both(logits), _both(labels), _both(mask)
    _close(tcommon.cross_entropy(tl, ty, tm if masked else None),
           jcommon.cross_entropy(jl, jy, jm if masked else None))


def test_param_factory_draws_a_truncated_normal():
    gen = torch.Generator().manual_seed(0)
    f = tcommon.ParamFactory(gen, torch.float32, "cpu")
    w, axes = f.dense((3, 200, 300), ("layer", "embed", "ff"))
    assert axes == ("layer", "embed", "ff") and w.dtype == torch.float32
    z = w * 200 ** 0.5                      # the default 1/sqrt(fan_in)
    assert float(z.abs().max()) <= 2.0
    # a normal truncated to (-2, 2) has std 0.880
    assert abs(float(z.std()) - 0.8796) < 0.01
    assert abs(float(z.mean())) < 0.01
    # drawn a slice at a time: slices differ
    assert not torch.equal(w[0], w[1])
    zeros, _ = f.zeros((4,), ("embed_nm",))
    ones, _ = f.ones((4,), ("embed_nm",), dtype=torch.bfloat16)
    assert not zeros.any() and ones.dtype == torch.bfloat16
    m = tcommon.ParamFactory(None, torch.bfloat16, "meta")
    big, _ = m.dense((96, 18432, 73728), ("layer", "embed", "ff"))
    assert m.abstract and big.is_meta and big.dtype == torch.bfloat16
    assert tcommon.ParamFactory(None, device=torch.device("meta")).abstract


def test_model_constructors_default_to_the_card(monkeypatch):
    """Without a device, ``ParamFactory`` and ``KVCache.init`` allocate
    on the CUDA device, and raise where there is none; ``"cpu"`` runs
    them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcommon.ParamFactory(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tattn.KVCache.init(2, 3, 8, 2, 16)
    assert tcommon.ParamFactory(None, device="cpu").device.type == "cpu"
    assert tattn.KVCache.init(2, 3, 8, 2, 16,
                              device="cpu").k.device.type == "cpu"


def test_param_factory_draws_in_blocks_from_its_seed(monkeypatch):
    """Drawn a block of rows at a time when a tensor is large: the same
    seed gives the same tensor, every block in range."""
    def draw(limit, seed=3):
        monkeypatch.setattr(tcommon, "_DRAW_ELEMENTS", limit)
        gen = torch.Generator().manual_seed(seed)
        return tcommon.ParamFactory(gen, torch.float32, "cpu").dense(
            (40, 6, 5), ("a", "b", "c"), scale=1.0)[0]
    a = draw(30)
    assert torch.equal(a, draw(30))
    assert not torch.equal(a, draw(30, seed=4))
    assert float(a.abs().max()) <= 2.0 and not (a == 0).all(dim=(1, 2)).any()


def test_split_tree():
    tree = {"a": (torch.zeros(2), ("x",)),
            "b": {"c": (torch.ones(3), ("y",))}}
    params, axes = tcommon.split_tree(tree)
    assert axes == {"a": ("x",), "b": {"c": ("y",)}}
    assert params["b"]["c"].shape == (3,)


# --- attention ------------------------------------------------------------

def test_rope_matches():
    pos = np.arange(9).astype(np.int32)
    x = _rng(8).normal(size=(2, 9, 3, 16)).astype(np.float32)
    (jp, tp), (jx, tx) = _both(pos), _both(x)
    jc, js = jattn.rope_angles(jp, 16, 1e6)
    tc, ts = tattn.rope_angles(tp, 16, 1e6)
    _close(tc, jc)
    _close(ts, js)
    _close(tattn.apply_rope(tx, tc, ts), jattn.apply_rope(jx, jc, js))
    # per-batch positions
    pb = np.array([[3], [7]], np.int32)
    (jpb, tpb) = _both(pb)
    jc, js = jattn.rope_angles(jpb, 16, 1e4)
    tc, ts = tattn.rope_angles(tpb, 16, 1e4)
    x1 = x[:, :1]
    _close(tattn.apply_rope(torch.from_numpy(x1), tc, ts),
           jattn.apply_rope(jnp.asarray(x1), jc, js))


@pytest.mark.parametrize("qc,kc", [(16, 16), (32, 64), (128, 128)])
@pytest.mark.parametrize("hk", [1, 2, 4])
def test_flash_attention_matches_reference(qc, kc, hk):
    rng = _rng(9 + hk)
    q = rng.normal(size=(2, 128, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 128, hk, 16)).astype(np.float32)
    v = rng.normal(size=(2, 128, hk, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    _close(tattn.flash_attention(tq, tk, tv, q_chunk=qc, k_chunk=kc),
           jattn.flash_attention(jq, jk, jv, q_chunk=qc, k_chunk=kc))


@pytest.mark.parametrize("sq,sk,qc,kc,causal", [
    (24, 24, 16, 16, True),      # chunks that do not divide: one chunk
    (8, 40, 8, 16, False),       # cross attention, ragged k
    (5, 5, 512, 1024, True),     # chunks larger than the sequence
])
def test_flash_attention_chunk_rules(sq, sk, qc, kc, causal):
    rng = _rng(20)
    q = rng.normal(size=(1, sq, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, sk, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, sk, 2, 8)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    _close(tattn.flash_attention(tq, tk, tv, q_chunk=qc, k_chunk=kc,
                                 causal=causal, remat_chunks=False),
           jattn.flash_attention(jq, jk, jv, q_chunk=qc, k_chunk=kc,
                                 causal=causal))


def test_flash_attention_fully_masked_rows_are_zero():
    """A causal query before every key (q longer than k is not the case
    here: keys start past the queries) gets no weight and a zero output,
    as the reference's guards give."""
    q = torch.ones(1, 4, 2, 4)
    k = torch.ones(1, 4, 2, 4)
    # causal with q_pos >= k_pos: row 0 sees key 0 only; no NaN anywhere
    out = tattn.flash_attention(q, k, k, q_chunk=2, k_chunk=2)
    assert torch.isfinite(out).all()
    m = torch.full((1, 2, 1, 2), float("-inf"))
    s = torch.full((1, 2, 1, 2, 2), float("-inf"))
    carry = (m, torch.zeros(1, 2, 1, 2), torch.zeros(1, 2, 1, 2, 4))
    q5 = torch.ones(1, 2, 2, 1, 4)
    kv = torch.ones(1, 2, 2, 4)
    m2, l2, acc2 = tattn._chunk_attn_block(
        q5, kv, kv, carry, torch.arange(2), torch.arange(5, 7), True, 0.5)
    assert torch.isneginf(m2).all() and not l2.any() and not acc2.any()
    del s


def _cache_case(seed, hk=2, s_max=20):
    rng = _rng(seed)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(3, s_max, hk, 16)).astype(np.float32)
    vc = rng.normal(size=(3, s_max, hk, 16)).astype(np.float32)
    lens = np.array([1, 9, s_max], np.int32)
    return q, kc, vc, lens


@pytest.mark.parametrize("hk", [1, 2, 4])
def test_decode_attention_matches(hk):
    q, kc, vc, lens = _cache_case(30, hk)
    (jq, tq), (jk, tk), (jv, tv), (jl, tl) = map(_both, (q, kc, vc, lens))
    _close(tattn.decode_attention(tq, tk, tv, tl),
           jattn.decode_attention(jq, jk, jv, jl))


def test_quantize_roundtrip_matches():
    x = _rng(31).normal(size=(3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 0
    jx, tx = _both(x)
    jqv, jsc = jattn.quantize_kv(jx)
    tqv, tsc = tattn.quantize_kv(tx)
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float16
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    _close(tattn.dequantize_kv(tqv, tsc, torch.float32),
           jattn.dequantize_kv(jqv, jsc, jnp.float32))


@pytest.mark.parametrize("hk", [1, 2, 4])
def test_decode_attention_q8_matches(hk):
    """The int8 path: the same int8 operands and integer sums, then fp32
    rescales, as the reference."""
    q, kc, vc, lens = _cache_case(32, hk)
    jkq, jks = jattn.quantize_kv(jnp.asarray(kc))
    jvq, jvs = jattn.quantize_kv(jnp.asarray(vc))
    tkq, tks = tattn.quantize_kv(torch.from_numpy(kc))
    tvq, tvs = tattn.quantize_kv(torch.from_numpy(vc))
    got = tattn.decode_attention_q8(torch.from_numpy(q), tkq, tks, tvq, tvs,
                                    torch.from_numpy(lens))
    want = jattn.decode_attention_q8(jnp.asarray(q), jkq, jks, jvq, jvs,
                                     jnp.asarray(lens))
    _close(got, want)
    # and within the KIVI-class error of the unquantized path
    plain = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc),
                                   torch.from_numpy(lens))
    rel = float((got - plain).norm() / plain.norm())
    assert rel < 0.05


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_kv_cache_init(dtype):
    c = tattn.KVCache.init(2, 3, 8, 2, 16, dtype=dtype, device="cpu")
    j = jattn.KVCache.init(2, 3, 8, 2, 16,
                           dtype=jnp.int8 if dtype == torch.int8
                           else jnp.bfloat16)
    assert c.quantized == j.quantized
    assert tuple(c.k.shape) == j.k.shape and c.k.dtype == dtype
    assert tuple(c.length.shape) == j.length.shape
    if c.quantized:
        assert tuple(c.k_scale.shape) == j.k_scale.shape
        assert c.k_scale.dtype == torch.float16


# --- MoE ------------------------------------------------------------------

def test_capacity_matches():
    for t, k, e, cf in [(512, 8, 128, 1.25), (8, 8, 128, 1.25),
                        (24, 2, 8, 2.0), (3, 1, 4, 1.0)]:
        assert tmoe._capacity(t, k, e, cf) == jmoe._capacity(t, k, e, cf)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_matches(k):
    x = _rng(40).normal(size=(32, 16)).astype(np.float32)
    w = _rng(41).normal(size=(16, 8)).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x), _both(w)
    jg, je, ja = jmoe.router_topk(jx, jw, k)
    tg, te, ta = tmoe.router_topk(tx, tw, k)
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg)
    _close(ta, ja)


def _moe_weights(seed, e, d, f):
    rng = _rng(seed)
    return [(rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
            for s in ((e, d, f), (e, d, f), (e, f, d))]


@pytest.mark.parametrize("t,k,e,cap,off,el", [
    (24, 2, 4, 48, 0, 4),        # capacity >= tokens: nothing dropped
    (40, 2, 4, 8, 0, 4),         # drops
    (40, 3, 8, 8, 2, 4),         # an expert slice (offset 2, 4 local)
])
def test_expert_compute_matches(t, k, e, cap, off, el):
    d, f = 8, 16
    rng = _rng(50 + t)
    xt = rng.normal(size=(t, d)).astype(np.float32)
    gates = rng.random((t, k)).astype(np.float32)
    eids = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    w_in, w_gate, w_out = _moe_weights(51, el, d, f)
    kw = dict(e_offset=off, e_local=el, capacity=cap)
    got = tmoe.expert_compute(*map(torch.from_numpy,
                                   (xt, gates, eids, w_in, w_gate, w_out)),
                              **kw)
    want = jmoe.expert_compute(*map(jnp.asarray,
                                    (xt, gates, eids, w_in, w_gate, w_out)),
                               **kw)
    _close(got, want)
    # keep flags exactly: with one choice's gate at 1 and the others at 0,
    # a token's reference output is nonzero iff that pair was kept
    tok, keep, slot = tmoe.dispatch(torch.from_numpy(eids), **kw)
    keep = keep.numpy().reshape(t, k)
    for j in range(k):
        one = np.zeros_like(gates)
        one[:, j] = 1.0
        ref = np.asarray(jmoe.expert_compute(
            *map(jnp.asarray, (xt, one, eids, w_in, w_gate, w_out)), **kw))
        np.testing.assert_array_equal(np.abs(ref).sum(1) > 0, keep[:, j])
    # slots: each local expert's kept pairs take positions 0, 1, ... in
    # token order, the dropped ones the cut slot
    flat = eids.reshape(-1) - off
    want_slot = np.full(t * k, el * cap)
    for ex in range(el):
        idx = np.flatnonzero(flat == ex)[:cap]
        want_slot[idx] = ex * cap + np.arange(len(idx))
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(tok.numpy(), np.repeat(np.arange(t), k))


def test_expert_compute_capacity_drops():
    """Over-capacity tokens are dropped, not mis-routed
    (``tests/test_models.py``)."""
    t, d = 16, 4
    out = tmoe.expert_compute(torch.ones(t, d), torch.ones(t, 1),
                              torch.zeros(t, 1, dtype=torch.int32),
                              torch.ones(1, d, 4), torch.ones(1, d, 4),
                              torch.ones(1, 4, d), e_offset=0, e_local=1,
                              capacity=8)
    assert int((out.abs().sum(-1) > 0).sum()) == 8
    assert (out.abs().sum(-1) > 0)[:8].all()


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_moe_ffn_matches(cf):
    cfg_j = jmoe.MoESettings(n_experts=8, top_k=2, d_ff_expert=16,
                             capacity_factor=cf)
    cfg_t = tmoe.MoESettings(n_experts=8, top_k=2, d_ff_expert=16,
                             capacity_factor=cf)
    rng = _rng(60)
    x = rng.normal(size=(2, 12, 8)).astype(np.float32)
    w_in, w_gate, w_out = _moe_weights(61, 8, 8, 16)
    router = rng.normal(size=(8, 8)).astype(np.float32)
    p = dict(router=router, we_in=w_in, we_gate=w_gate, we_out=w_out)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                            cfg_j)
    ty, taux = tmoe.moe_ffn(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            cfg_t)
    _close(ty, jy)
    _close(taux, jaux)
    # the mesh form on a one-entry mesh is the unsharded call
    my, maux = tmoe.moe_ffn(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            cfg_t, mesh=make_local_mesh("cpu"),
                            batch_axes=("data",), fsdp_axes=("data",))
    assert torch.equal(my, ty) and torch.equal(maux, taux)
