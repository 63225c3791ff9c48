"""The port's optimizers (``repro_torch.optim``) against ``repro.optim`` on
the CPU: ``adamw_update`` (one step and five on the same gradients, fp32
and bf16 leaves, with and without ``update_in_chunks``), ``lr_schedule``,
the quadratic descent, the int8 quantisation (exact) and
``compressed_psum`` at one replica (the reference's one-device
``shard_map``) and at two (a two-device reference run in a subprocess).
Inputs come from seeded numpy and go to both packages.

Tolerances: parameters, m, v, ``lr`` and ``grad_norm`` within 1e-6 in
fp32 (measured: at most 1.5e-8 absolute on O(1) values — fp32 sums and
fused multiply-adds in another order than XLA's); bf16 parameters within
one bf16 ulp of the reference's (a ~1e-8 difference in the fp32 update
can round to the neighbouring bf16; measured: equal). The int8 payloads,
scales, reduced gradients and error trees equal the reference's bit for
bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _hyp import given, settings, st
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"layers": {"w": (3, 4, 5), "ln": (3, 4)}, "embed": (6, 4),
          "b": (7,)}


def _tree(shape_tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shape_tree.items()}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(tree_np, jdt, tdt):
    """The same values as a JAX tree of ``jdt`` and a torch tree of
    ``tdt`` (cast by JAX, so bf16 rounds once, and carried across)."""
    j = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree_np)
    t = jax.tree.map(lambda a: torch.from_numpy(
        np.array(jnp.asarray(a, jnp.float32))).to(tdt), j)
    return j, t


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value of ``x`` (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("chunks", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches(steps, chunks, dtype):
    rng = np.random.default_rng(steps * 10 + chunks)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp, tp = _both(_tree(SHAPES, lambda s: rng.normal(size=s).astype(
        np.float32)), jdt, tdt)
    jg, tg = _both(_tree(SHAPES, lambda s: 0.7 * rng.normal(size=s).astype(
        np.float32)), jdt, tdt)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=8,
              update_in_chunks=chunks)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for _ in range(steps):
        jp, jo, jm = jadamw.adamw_update(jg, jo, jp, jcfg)
        tp, to, tm = tadamw.adamw_update(tg, to, tp, tcfg)
    assert int(to.step) == int(jo.step) == steps
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    for a, b in zip(jl, tl):
        assert b.dtype == tdt and tuple(b.shape) == a.shape
        if dtype == "float32":
            np.testing.assert_allclose(_np(b), _np(a), **TOL)
        else:
            assert (np.abs(_np(b) - _np(a)) <= _bf16_ulp(_np(a))).all()
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(jo, name)),
                        tree_leaves(getattr(to, name))):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(_np(b), _np(a), **TOL)


def test_adamw_update_writes_in_place_and_keeps_the_tree():
    p = {"a": torch.ones(3, 2), "z": {"b": torch.ones(4)}}
    g = tree_map(torch.ones_like, p)
    opt = tadamw.adamw_init(p)
    ids = [id(x) for x in tree_leaves(p)]
    p2, o2, m = tadamw.adamw_update(g, opt, p, tadamw.AdamWConfig())
    assert p2 is p and [id(x) for x in tree_leaves(p2)] == ids
    assert o2.m is opt.m and int(o2.step) == 1 and int(opt.step) == 0
    # the gradients are read, never written (fp32 ones too)
    assert all(bool((x == 1).all()) for x in tree_leaves(g))
    assert set(m) == {"lr", "grad_norm"}
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(10.0))


def test_adamw_bf16_state_dtype_matches():
    rng = np.random.default_rng(3)
    jp, tp = _both({"w": rng.normal(size=(4, 6)).astype(np.float32)},
                   jnp.float32, torch.float32)
    jg, tg = _both({"w": rng.normal(size=(4, 6)).astype(np.float32)},
                   jnp.float32, torch.float32)
    jo = jadamw.adamw_init(jp, jnp.bfloat16)
    to = tadamw.adamw_init(tp, torch.bfloat16)
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    for _ in range(3):
        jp, jo, _ = jadamw.adamw_update(jg, jo, jp, jadamw.AdamWConfig(**cfg))
        tp, to, _ = tadamw.adamw_update(tg, to, tp, tadamw.AdamWConfig(**cfg))
    assert to.m["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tp["w"]), _np(jp["w"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(to.v["w"]), _np(jo.v["w"]), rtol=2 ** -7)


@pytest.mark.parametrize("step", [0, 1, 20, 55, 200, 300])
def test_lr_schedule_matches(step):
    """Steps 0, inside warmup, at warmup, inside the decay, at total and
    past it."""
    kw = dict(lr=3e-3, warmup_steps=20, total_steps=200, min_lr_ratio=0.1)
    want = jadamw.lr_schedule(jadamw.AdamWConfig(**kw),
                              jnp.asarray(step, jnp.int32))
    got = tadamw.lr_schedule(tadamw.AdamWConfig(**kw),
                             torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-12)


def test_global_norm_matches_and_blocks_large_leaves(monkeypatch):
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(50, 8)).astype(np.float32),
            "b": rng.normal(size=(9,)).astype(np.float32)}
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    t = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    np.testing.assert_allclose(float(tadamw.global_norm(t)), want, rtol=1e-6)
    monkeypatch.setattr(tadamw, "_NORM_BLOCK", 16)   # 2 rows a block
    np.testing.assert_allclose(float(tadamw.global_norm(t)), want, rtol=1e-6)
    # the blocked path reads the fp32 leaves and writes nothing back
    for k in tree:
        np.testing.assert_array_equal(t[k].numpy(), tree[k])


@pytest.mark.parametrize("chunks", [False, True])
def test_adamw_update_blocked_norm_matches(monkeypatch, chunks):
    """fp32 leaves larger than ``_NORM_BLOCK`` (shrunk to 16: the norm
    squares them a block of rows at a time) through two ``adamw_update``
    steps on the same gradients, against the reference: parameters, m, v
    and ``grad_norm`` as in ``test_adamw_update_matches``, and the
    gradients unchanged."""
    monkeypatch.setattr(tadamw, "_NORM_BLOCK", 16)
    rng = np.random.default_rng(9)
    jp, tp = _both(_tree(SHAPES, lambda s: rng.normal(size=s).astype(
        np.float32)), jnp.float32, torch.float32)
    gnp = _tree(SHAPES, lambda s: 0.7 * rng.normal(size=s).astype(
        np.float32))
    jg, tg = _both(gnp, jnp.float32, torch.float32)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=8,
              update_in_chunks=chunks)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for _ in range(2):
        jp, jo, jm = jadamw.adamw_update(jg, jo, jp, jcfg)
        tp, to, tm = tadamw.adamw_update(tg, to, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
    for a, b in zip(jax.tree.leaves(gnp), tree_leaves(tg)):
        np.testing.assert_array_equal(b.numpy(), a)
    for name in ("params", "m", "v"):
        jt = jp if name == "params" else getattr(jo, name)
        tt = tp if name == "params" else getattr(to, name)
        for a, b in zip(jax.tree.leaves(jt), tree_leaves(tt)):
            np.testing.assert_allclose(_np(b), _np(a), **TOL)


def test_adamw_descends_quadratic():
    """``tests/test_substrate.py::test_adamw_descends_quadratic``."""
    p = {"w": torch.tensor([5.0, -3.0])}
    opt = tadamw.adamw_init(p)
    cfg = tadamw.AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=0,
                             total_steps=100, min_lr_ratio=1.0)
    for _ in range(60):
        g = tree_map(lambda w: 2 * w, p)
        p, opt, _ = tadamw.adamw_update(g, opt, p, cfg)
    assert float(p["w"].abs().max()) < 0.5


# --- compression -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5,), (3, 17), (2, 3, 4), (1, 1)])
def test_quantize_int8_matches_exactly(shape):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    if len(shape) == 2 and shape[0] == 3:
        x[1] = 0.0                            # an all-zero row
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts, shape).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, shape)))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 6), st.integers(1, 64))
def test_int8_quantization_bounded_error(rows, cols):
    """``tests/test_substrate.py::test_int8_quantization_bounded_error`` on
    the port, and the reference's payload equal."""
    rng = np.random.default_rng(rows * 100 + cols)
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    back = tcomp.dequantize_int8(q, s, x.shape).numpy()
    scale = np.abs(x).max(axis=1, keepdims=True)
    assert (np.abs(back - x) <= scale / 127.0 * 0.5 + 1e-7).all()
    jq, _ = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def _grads_and_errs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 6), "b": (5,), "s": {"t": (2, 3, 2)}}
    g = [_tree(shapes, lambda s: rng.normal(size=s).astype(np.float32))
         for _ in range(n)]
    e = [_tree(shapes, lambda s: 0.01 * rng.normal(size=s).astype(
        np.float32)) for _ in range(n)]
    return g, e


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_compressed_psum_one_replica_matches_shard_map():
    """The reference's one-device ``shard_map`` (its
    ``test_compressed_psum_single_device``) against one replica."""
    from jax.experimental.shard_map import shard_map
    (g,), (e,) = _grads_and_errs(6, 1)
    mesh = jax.make_mesh((1,), ("data",))
    red, err = shard_map(lambda g, e: jcomp.compressed_psum(g, e, "data"),
                         mesh=mesh, in_specs=(P(), P()),
                         out_specs=(P(), P()), check_rep=False)(g, e)
    tred, terrs = tcomp.compressed_psum(
        [_torch_tree(g)], [tcomp.CompressState(error=_torch_tree(e))])
    assert len(terrs) == 1 and isinstance(terrs[0], tcomp.CompressState)
    for a, b in zip(jax.tree.leaves(red), tree_leaves(tred)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(err), tree_leaves(terrs[0])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the reference's own check: close to the input gradient
    np.testing.assert_allclose(tred["w"].numpy(), g["w"] + e["w"],
                               atol=0.02)


_REF_TWO = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.optim.compression import compressed_psum
d = dict(np.load(sys.argv[1]))
g = {k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith("g_")}
e = {k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith("e_")}
mesh = jax.make_mesh((2,), ("data",))

def f(g, e):
    g = jax.tree.map(lambda x: x[0], g)
    e = jax.tree.map(lambda x: x[0], e)
    red, err = compressed_psum(g, e, "data")
    return (jax.tree.map(lambda x: x[None], red),
            jax.tree.map(lambda x: x[None], err))

red, err = shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                     out_specs=(P("data"), P("data")), check_rep=False)(g, e)
np.savez(sys.argv[2], **{"r_" + k: np.asarray(v) for k, v in red.items()},
         **{"e_" + k: np.asarray(v) for k, v in err.items()})
"""


def test_compressed_psum_two_replicas_matches_subprocess(tmp_path):
    """Two replicas against the reference on two simulated devices: each
    device's reduced gradients (replicated) and its own error tree."""
    g, e = _grads_and_errs(7, 2)
    flat = lambda t: {"w": t["w"], "b": t["b"], "t": t["s"]["t"]}  # noqa
    np.savez(tmp_path / "in.npz",
             **{f"g_{k}": np.stack([flat(x)[k] for x in g]) for k in "wbt"},
             **{f"e_{k}": np.stack([flat(x)[k] for x in e]) for k in "wbt"})
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    out = subprocess.run(
        [sys.executable, "-c", _REF_TWO, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))
    red, errs = tcomp.compressed_psum(
        [_torch_tree(x) for x in g],
        [tcomp.CompressState(error=_torch_tree(x)) for x in e])
    for k in "wbt":
        np.testing.assert_array_equal(want[f"r_{k}"][0], want[f"r_{k}"][1])
        np.testing.assert_array_equal(flat(red)[k].numpy(),
                                      want[f"r_{k}"][0])
        for r in range(2):
            np.testing.assert_array_equal(flat(errs[r].error)[k].numpy(),
                                          want[f"e_{k}"][r])


def test_compressed_psum_checks_its_replicas():
    g, e = _grads_and_errs(8, 2)
    with pytest.raises(ValueError, match="one of each a replica"):
        tcomp.compressed_psum(
            [_torch_tree(x) for x in g],
            [tcomp.CompressState(error=_torch_tree(e[0]))])


def test_compress_init_zeros():
    st_ = tcomp.compress_init({"a": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert st_.error["a"].dtype == torch.float32
    assert not st_.error["a"].any()
