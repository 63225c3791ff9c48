"""The attention products' operand types (``models/attention.py``).

On the card the four products take the operands' own type with float32
results, as the reference's ``preferred_element_type=jnp.float32`` dots
do; the CPU keeps the float32 einsum of the upcast operands. Held here:

* the card's branch, forced on the CPU with float32 operands (where its
  products are plain float32 ``bmm``s), equals the CPU's branch in
  ``flash_attention`` (values and gradients) and ``decode_attention`` at
  batch 1 and 3: the permutes, reshapes and per-row products are right;
  a decode's products over a cache view copied into one batch equal them
  with the view read in place a batch row or a head;
* on ``meta`` (the card's branch, as the dry run counts it), bf16 inputs
  put the forward products' FLOPs under ``bfloat16``, and the gradient of
  one online-softmax block runs the reference's products in the
  reference's types: its FLOPs by type equal those of the dots in
  ``jax.make_jaxpr(jax.grad(...))`` of ``repro``'s ``_chunk_attn_block``
  on bf16 inputs (the forward dots bf16 x bf16, each transposed dot the
  float32 cotangent against the other operand), and the gradients come
  back bf16;
* ``_MixedBmm``'s backward, called on the CPU, is the float32 product of
  the cotangent and the upcast operand, cast to the operand's type.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro_torch.launch import opcost
from repro_torch.models import attention as tatt

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, s, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))


@pytest.mark.parametrize("b", [1, 3])
def test_card_branch_equals_cpu_branch(b, monkeypatch):
    q, k, v = _qkv(b, 16, 8, 2, 8)
    kw = dict(q_chunk=4, k_chunk=8)
    cl = torch.tensor([16, 9, 3][:b])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = tatt.flash_attention(*leaves, **kw)
    want_g = torch.autograd.grad(want.pow(2).sum(), leaves)
    want_dec = tatt.decode_attention(q[:, :1], k, v, cl)
    monkeypatch.setattr(tatt, "_on_card", lambda t: True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = tatt.flash_attention(*leaves, **kw)
    got_g = torch.autograd.grad(got.pow(2).sum(), leaves)
    got_dec = tatt.decode_attention(q[:, :1], k, v, cl)
    torch.testing.assert_close(got, want, **TOL)
    for a, w in zip(got_g, want_g):
        torch.testing.assert_close(a, w, **TOL)
    torch.testing.assert_close(got_dec, want_dec, **TOL)


@pytest.mark.parametrize("b,hk", [(1, 2), (3, 2), (3, 4)])
def test_cache_product_copied_equals_in_place(b, hk, monkeypatch):
    """The card's decode with the cache view copied into one batch (a
    short cache) equals it with one product a batch row or a head, each
    reading the view in place (``_COPY_BYTES`` 0: a long cache)."""
    q, k, v = _qkv(b, 16, 8, hk, 8, seed=b)
    cl = torch.tensor([16, 9, 3][:b])
    monkeypatch.setattr(tatt, "_on_card", lambda t: True)
    copied = tatt.decode_attention(q[:, :1], k, v, cl)
    monkeypatch.setattr(tatt, "_COPY_BYTES", 0)
    torch.testing.assert_close(
        tatt.decode_attention(q[:, :1], k, v, cl), copied, **TOL)


def _meta(*ts, dtype=torch.bfloat16, grad=False):
    return tuple(torch.empty(t.shape, dtype=dtype, device="meta"
                             ).requires_grad_(grad) for t in ts)


def test_forward_products_count_as_bf16():
    q, k, v = _meta(*_qkv(2, 32, 8, 2, 16))
    _, c = opcost.count(lambda *a: tatt.flash_attention(
        *a, q_chunk=8, k_chunk=16), (q, k, v))
    assert set(c["flops_by_dtype"]) == {"bfloat16"}
    cl = torch.tensor([32, 7], device="meta")
    _, c = opcost.count(tatt.decode_attention, (q[:, :1], k, v, cl))
    # (B, Hk) products of (G, D) x (D, S) and (G, S) x (S, D)
    assert c["flops_by_dtype"] == {"bfloat16": 2 * 2 * 2 * 2 * 4 * 32 * 16.0}


def _reference_dot_flops(b, cq, ck, hk, g, d) -> dict:
    """FLOPs of every dot in the reference's gradient of one block, by the
    type of its widest operand."""
    q = jnp.ones((b, cq, hk, g, d), jnp.bfloat16)
    k = v = jnp.ones((b, ck, hk, d), jnp.bfloat16)
    carry = (jnp.full((b, hk, g, cq), -jnp.inf, jnp.float32),
             jnp.zeros((b, hk, g, cq), jnp.float32),
             jnp.zeros((b, hk, g, cq, d), jnp.float32))

    def loss(q, k, v):
        m, l, acc = jatt._chunk_attn_block(q, k, v, carry, jnp.arange(cq),
                                           jnp.arange(ck), True, 0.25)
        return acc.sum() + l.sum()

    out: dict = {}
    for e in jax.make_jaxpr(jax.grad(loss, argnums=(0, 1, 2)))(
            q, k, v).eqns:
        if e.primitive.name != "dot_general":
            continue
        (lc, _), _ = e.params["dimension_numbers"]
        lhs = e.invars[0].aval
        n = 2.0 * np.prod(e.outvars[0].aval.shape) * np.prod(
            [lhs.shape[i] for i in lc])
        dt = max((x.aval.dtype for x in e.invars),
                 key=lambda t: np.dtype(t).itemsize)
        out[str(np.dtype(dt))] = out.get(str(np.dtype(dt)), 0.0) + n
    return out


def test_block_gradient_runs_the_reference_types():
    b, cq, ck, hk, g, d = 2, 8, 16, 2, 4, 16
    q = torch.empty((b, cq, hk, g, d), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k, v = _meta(torch.empty(b, ck, hk, d), torch.empty(b, ck, hk, d),
                 grad=True)
    carry = (torch.full((b, hk, g, cq), float("-inf"), device="meta"),
             torch.zeros((b, hk, g, cq), device="meta"),
             torch.zeros((b, hk, g, cq, d), device="meta"))

    def step(q, k, v):
        m, l, acc = tatt._chunk_attn_block(
            q, k, v, carry, torch.arange(cq, device="meta"),
            torch.arange(ck, device="meta"), True, 0.25)
        return torch.autograd.grad(acc.sum() + l.sum(), (q, k, v))

    grads, c = opcost.count(step, (q, k, v))
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert c["flops_by_dtype"] == _reference_dot_flops(b, cq, ck, hk, g, d)


def test_flash_gradient_through_recompute_is_bf16():
    """``flash_attention``'s checkpointed blocks recompute through the
    bf16 product: the gradients on ``meta`` are bf16, the forward and its
    recomputes count as bf16, the transposed products as float32."""
    q, k, v = _meta(*_qkv(1, 32, 4, 2, 8), grad=True)

    def step(q, k, v):
        o = tatt.flash_attention(q, k, v, q_chunk=8, k_chunk=16)
        return torch.autograd.grad(o.float().sum(), (q, k, v))

    grads, c = opcost.count(step, (q, k, v))
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    by = c["flops_by_dtype"]
    assert set(by) == {"bfloat16", "float32"}
    # forward once, recomputed once a q-block and once a chunk: 3x the
    # forward's bf16 FLOPs; the backward's four products 2x them in float32
    assert by["bfloat16"] == 1.5 * by["float32"]


def test_mixed_bmm_backward():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(3, 4, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 5, 6)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 4, 6)).astype(np.float32))
    ab, bb = a.bfloat16(), b.bfloat16()
    ctx = types.SimpleNamespace(saved_tensors=(ab, bb),
                                needs_input_grad=(True, True))
    ga, gb = tatt._MixedBmm.backward(ctx, g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    torch.testing.assert_close(ga, (g @ bb.float().transpose(1, 2))
                               .bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(gb, (ab.float().transpose(1, 2) @ g)
                               .bfloat16(), rtol=0, atol=0)
    ctx.needs_input_grad = (False, True)
    assert tatt._MixedBmm.backward(ctx, g)[0] is None
