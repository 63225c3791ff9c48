"""The int8 decode's products (``kernels/q8_dot.py``, ``kernels/ops.py``'s
``q8_scores`` and ``q8_values``) on the CPU, where the wrappers run the
plain twins.

The twins equal the reference's ``jnp.einsum(...,
preferred_element_type=jnp.int32)`` of ``repro.models.attention.
decode_attention_q8`` exactly: at the LM smoke configs' shapes, at the
full-width head dims, and where the values' int32 sum wraps (S > 133,144
positions of 127 x 127, past 2^31). On ``meta`` the wrappers give the
output's shape and int32; the op counter takes each call's
``2 * B * Hk * G * S * D`` FLOPs as int8, and the dry run counts the
Minitron smoke decode's products under ``int8``, none under ``float64``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec
from repro_torch.kernels import ops, q8_dot
from repro_torch.launch import dryrun, opcost, steps
from repro_torch.models import attention as tatt

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

#: (B, S, Hk, G, D): the smoke configs' decode shapes (Minitron, Qwen3,
#: Gemma, Nemotron, Moonshot), two full-width heads, G past 16
SHAPES = ((4, 16, 2, 4, 8), (4, 16, 2, 2, 16), (2, 9, 4, 1, 32),
          (2, 16, 2, 3, 16), (3, 5, 4, 1, 16), (1, 64, 8, 3, 128),
          (1, 33, 2, 12, 192), (2, 7, 1, 20, 4))
#: positions where 127 * 127 * S passes 2^31 (the values' sum wraps)
WRAP_S = 140_000


def _int8(rng, shape, fill=None) -> np.ndarray:
    if fill is not None:
        return np.full(shape, fill, np.int8)
    return rng.integers(-127, 128, shape).astype(np.int8)


def _reference(eq: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.einsum(eq, jnp.asarray(a), jnp.asarray(b),
                                 preferred_element_type=jnp.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fill", [None, 127, -127])
def test_plain_twins_match_the_reference(shape, fill):
    b, s, hk, g, d = shape
    rng = np.random.default_rng(sum(shape))
    qq, k = _int8(rng, (b, hk, g, d), fill), _int8(rng, (b, s, hk, d), fill)
    pq, v = _int8(rng, (b, hk, g, s), fill), _int8(rng, (b, s, hk, d))
    got = ops.q8_scores(torch.from_numpy(qq), torch.from_numpy(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _reference("bhgd,bshd->bhgs", qq, k))
    got = ops.q8_values(torch.from_numpy(pq), torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _reference("bhgs,bshd->bhgd", pq, v))


@pytest.mark.parametrize("sign", [1, -1])
def test_values_wrap_as_the_reference(sign):
    """127 * 127 * 140,000 = 2,258,060,000 passes 2^31 - 1: the int32 sum
    wraps, in the reference and in the twin."""
    pq = np.full((1, 1, 1, WRAP_S), 127, np.int8)
    v = np.full((1, WRAP_S, 1, 4), sign * 127, np.int8)
    exact = sign * 127 * 127 * WRAP_S
    assert abs(exact) > 2**31
    want = _reference("bhgs,bshd->bhgd", pq, v)
    assert int(want[0, 0, 0, 0]) == (exact + 2**31) % 2**32 - 2**31
    got = ops.q8_values(torch.from_numpy(pq), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


def test_meta_gives_shapes_and_types():
    qq = torch.empty((2, 4, 3, 128), dtype=torch.int8, device="meta")
    k = torch.empty((2, 1000, 4, 128), dtype=torch.int8, device="meta")
    pq = torch.empty((2, 4, 3, 1000), dtype=torch.int8, device="meta")
    s, o = ops.q8_scores(qq, k), ops.q8_values(pq, k)
    assert (s.device.type, s.dtype, tuple(s.shape)) == \
        ("meta", torch.int32, (2, 4, 3, 1000))
    assert (o.device.type, o.dtype, tuple(o.shape)) == \
        ("meta", torch.int32, (2, 4, 3, 128))
    assert q8_dot.flops(qq, k) == q8_dot.flops(pq, k) == \
        {"int8": 2 * 2 * 4 * 3 * 1000 * 128}


def test_counter_takes_int8_flops():
    b, s, hk, g, d = 2, 1000, 4, 3, 128
    qq = torch.empty((b, hk, g, d), dtype=torch.int8, device="meta")
    k = torch.empty((b, s, hk, d), dtype=torch.int8, device="meta")
    pq = torch.empty((b, hk, g, s), dtype=torch.int8, device="meta")
    _, c = opcost.count(lambda *a: (ops.q8_scores(a[0], a[1]),
                                    ops.q8_values(a[2], a[1])),
                        (qq, k, pq))
    assert c["flops_by_dtype"] == {"int8": 2 * 2.0 * b * hk * g * s * d}
    assert c["kernels"]["q8_dot"]["calls"] == 2


def test_decode_attention_q8_runs_the_kernel_products():
    """``decode_attention_q8`` on ``meta``, the card's path: its products
    are the two ``q8_dot`` calls, int32 out, and no op makes a float64
    tensor; the op counter takes their FLOPs as int8 and nothing else."""
    made = set()

    class Watch(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            made.update(t.dtype for t in opcost._tensors(out, []))
            return out

    b, s, hk, g, d = 2, 12, 2, 4, 16
    q = torch.empty((b, 1, hk * g, d), device="meta")
    kq = torch.empty((b, s, hk, d), dtype=torch.int8, device="meta")
    ks = torch.empty((b, s, hk), dtype=torch.float16, device="meta")
    args = (q, kq, ks, kq, ks, torch.tensor([5, 12], device="meta"))
    with Watch():
        out = tatt.decode_attention_q8(*args)
    assert out.shape == q.shape and torch.float64 not in made
    _, c = opcost.count(tatt.decode_attention_q8, args)
    assert c["flops_by_dtype"] == {"int8": 2 * 2.0 * b * hk * g * s * d}
    assert c["kernels"]["q8_dot"]["calls"] == 2


@pytest.mark.parametrize("variant", ["opt_int8", "opt_int8_half"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dry_run_counts_int8_products(variant, dtype):
    arch = steps.smoke_arch("minitron-4b")
    cfg = dataclasses.replace(arch.make_config(), dtype=dtype)
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    shape = ShapeSpec("s", "decode", dict(seq_len=16, global_batch=4))
    counts = dryrun.count_case(steps.case_for(arch, shape, None,
                                              abstract=True, variant=variant))
    by = counts["flops_by_dtype"]
    assert by["int8"] > 0 and "float64" not in by
    assert set(by) == {"int8", str(dtype).removeprefix("torch.")}
    assert counts["kernels"]["q8_dot"]["calls"] == 2 * cfg.n_layers
