"""``repro_torch.launch.opcost``, the op counter of the dry run, against
hand counts and against the reference's ``repro.launch.hlocost``.

Every count here runs on the CPU: on the ``meta`` device, or on CPU
tensors counted as device ops (``on_cpu=True``), at small shapes."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun, opcost, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import opcost_hooks as hooks

F32 = 4


def _loop(x, w):
    """5 x relu(c @ w_i), summed: the reference's loop-correction test."""
    c = x
    for i in range(w.shape[0]):
        c = torch.relu(c @ w[i])
    return c.sum()


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_loop_counts_exactly(device):
    x = torch.zeros(32, 64, device=device)
    w = torch.zeros(5, 64, 64, device=device)
    _, r = opcost.count(_loop, (x, w), on_cpu=device == "cpu")
    assert r["flops"] == 5 * 2 * 32 * 64 * 64
    assert r["flops_by_dtype"] == {"float32": r["flops"]}
    assert r["bytes"] >= 5 * 32 * 64 * F32


def test_flops_are_kept_by_type():
    """Each product's FLOPs under the type it runs in: bf16 operands, a
    float32 one, and a product of mixed types under the wider."""
    a16 = torch.zeros(8, 16, dtype=torch.bfloat16, device="meta")
    b16 = torch.zeros(16, 4, dtype=torch.bfloat16, device="meta")
    a32 = torch.zeros(8, 16, device="meta")

    def fn(a16, b16, a32):
        return a16 @ b16, a32 @ b16.float(), torch.addmm(
            torch.zeros(8, 4, device="meta"), a32, b16.float())

    _, r = opcost.count(fn, (a16, b16, a32))
    one = 2 * 8 * 16 * 4
    assert r["flops_by_dtype"] == {"bfloat16": one, "float32": 2 * one}
    assert r["flops"] == 3 * one


def test_loop_flops_equal_the_reference_hlocost():
    """The same function compiled by XLA on the CPU and read by the
    reference's HLO cost model: the same FLOPs."""
    from repro.launch import hlocost

    def f(x, w):
        def body(c, wi):
            return jax.nn.relu(c @ wi), None
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()

    txt = jax.jit(f).lower(
        jax.ShapeDtypeStruct((32, 64), jnp.float32),
        jax.ShapeDtypeStruct((5, 64, 64), jnp.float32)).compile().as_text()
    ref = hlocost.analyze(txt)
    _, r = opcost.count(_loop, (torch.zeros(32, 64, device="meta"),
                                torch.zeros(5, 64, 64, device="meta")))
    assert r["flops"] == ref["flops"] == 5 * 2 * 32 * 64 * 64


def _bytes_of(fn, *args):
    return opcost.count(fn, args)[1]["bytes"]


def _m(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name, fn, args, want", [
    ("view", lambda x: x.view(8, 16), (_m(16, 8),), 0),
    ("slice", lambda x: x[2:6], (_m(16, 8),), 0),
    ("transpose", lambda x: x.t(), (_m(16, 8),), 0),
    ("empty", lambda x: torch.empty(100, device="meta"), (_m(1),), 0),
    ("add", lambda a, b: a + b, (_m(16, 8), _m(16, 8)), 3 * 16 * 8 * F32),
    ("broadcast add", lambda a, b: a + b, (_m(16, 8), _m(8)),
     (2 * 16 * 8 + 8) * F32),
    ("slice copy", lambda x: x[:, 2:6].contiguous(), (_m(16, 8),),
     2 * 16 * 4 * F32),
    ("gather rows", lambda x, i: x[i], (_m(100, 8), _m(5, dtype=torch.long)),
     2 * 5 * 8 * F32),
    ("index_select", lambda x, i: x.index_select(0, i),
     (_m(100, 8), _m(5, dtype=torch.long)), 2 * 5 * 8 * F32),
    ("index_add_", lambda x, i, s: x.index_add_(0, i, s),
     (_m(100, 8), _m(5, dtype=torch.long), _m(5, 8)), 2 * 5 * 8 * F32),
    ("index_put_", lambda x, i, v: x.index_put_((i,), v),
     (_m(100, 8), _m(5, dtype=torch.long), _m(5, 8)), 2 * 5 * 8 * F32),
    ("copy_", lambda x, y: x.copy_(y), (_m(16, 8), _m(16, 8)),
     2 * 16 * 8 * F32),
    ("out=", lambda a, o: torch.div(a, 2.0, out=o), (_m(16, 8), _m(16, 8)),
     2 * 16 * 8 * F32),
    ("fill", lambda x: torch.zeros(16, 8, device="meta"), (_m(1),),
     16 * 8 * F32),
    ("host work", lambda x: torch.ones(1000) * 2, (_m(1),), 0),
    ("upload", lambda x: torch.ones(10).to("meta"), (_m(1),), 0),
])
def test_byte_rules(name, fn, args, want):
    assert _bytes_of(fn, *args) == want, name


def test_peak_live_bytes():
    """The arguments, then each new storage adds its bytes and a freed one
    takes them away; views and in-place results add nothing."""
    def fn(x):
        a = torch.empty(10, device="meta")            # 40, live 140
        b = torch.empty(20, device="meta")            # 80, live 220
        del a                                         # live 180
        c = b.view(4, 5)                              # a view: nothing
        c.add_(1.0)                                   # in place: nothing
        d = torch.empty(50, device="meta")            # 200, live 380
        del b, c, d                                   # live 100
        e = torch.empty(60, device="meta")            # 240, live 340
        return e

    c = opcost.OpCost(args=(), arg_bytes=100)
    with c:
        out = fn(None)
    assert c.result()["peak_bytes"] == 380
    assert c.live[0] == 340
    del out
    assert c.live[0] == 100


def test_shard_attribution():
    """Per device: the work outside every shard (each device repeats it)
    plus the largest shard's."""
    mesh = make_mesh((3,), ("data",), "meta")
    x, w = _m(32, 64), _m(64, 64)
    one = 2 * 32 * 64 * 64

    def fn(x, w):
        y = x @ w                                     # every device
        with hooks.shard({"data": 0}):
            a = (y @ w) @ w                           # two products
        with hooks.shard({"data": 1}):
            b = y @ w                                 # one
        with hooks.shard({"data": 2}):
            c = (y[:16] @ w)                          # half of one
        return a, b, c

    c = opcost.OpCost(mesh, args=(x, w))
    with c:
        fn(x, w)
    r = c.result()
    assert list(c.flops) == [3 * one, 2 * one, 1.5 * one]
    assert r["flops"] == 3 * one


def test_shard_outputs_carry_their_shard():
    """An op outside every context counts where its operands came from
    (the gradient pass), and a sum of two shards' parts is the
    collective's, not a device's work."""
    mesh = make_mesh((2,), ("data",), "meta")
    w = torch.zeros(64, 64, device="meta", requires_grad=True)
    x = _m(32, 64)

    def fn(x, w):
        parts = []
        for i in range(2):
            with hooks.shard({"data": i}):
                h = x[16 * i:16 * (i + 1)] * 2.0     # the shard's rows
                parts.append((h @ w).sum())
        return torch.autograd.grad(parts[0] + parts[1], w)

    c = opcost.OpCost(mesh, args=(x, w))
    with c:
        fn(x, w)
    r = c.result()
    half = 2 * 16 * 64 * 64
    # the forward product and its weight gradient, on each shard's device
    assert list(c.flops) == [2 * half, 2 * half] and r["flops"] == 2 * half


def _lm_case(arch_id, kind, layers, mesh=None, batch=4):
    arch = steps.smoke_arch(arch_id)
    cfg = dataclasses.replace(arch.make_config(), n_layers=layers)
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    shape = ShapeSpec("s", kind, dict(seq_len=32, global_batch=batch))
    return steps.case_for(arch, shape, mesh, abstract=True)


#: peak live bytes of the depth rule against a full count, relative: the
#: peak falls at the same point of each layer, so it grows by one layer's
#: bytes a layer, but for the decode step's few per-call scalars
#: (measured 5.4e-6 on the decode case, 0 on the others)
PEAK_DEPTH_TOL = 1e-5


@pytest.mark.parametrize("arch_id, kind", [
    ("minitron-4b", "train"), ("qwen3-moe-30b-a3b", "train"),
    ("qwen3-moe-30b-a3b", "prefill"), ("qwen3-moe-30b-a3b", "decode")])
def test_depth_rule_lm(arch_id, kind):
    """Counts at 1 and 2 layers extended to 4 equal a count at 4, exactly
    for FLOPs, bytes and collectives (on a (2, 2) mesh, which has them)."""
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    runs = {d: dryrun.count_case(_lm_case(arch_id, kind, d, mesh))
            for d in (1, 2, 4)}
    ext = opcost.extrapolate(runs[1], runs[2], 1, 2, 4)
    full = runs[4]
    assert ext["flops"] == full["flops"]
    assert ext["bytes"] == full["bytes"]
    for k in opcost.COLLECTIVES:
        assert ext["collectives"][k]["bytes"] == \
            full["collectives"][k]["bytes"], k
        assert ext["collectives"][k]["count"] == \
            full["collectives"][k]["count"], k
    if kind != "decode":
        assert full["collectives"]["total_bytes"] > 0
    assert abs(ext["peak_bytes"] - full["peak_bytes"]) \
        <= PEAK_DEPTH_TOL * full["peak_bytes"]


def test_depth_rule_equiformer():
    """EquiformerV2 at four edge shards: 1 and 2 layers extended to 4 equal
    a count at 4."""
    arch = steps.smoke_arch("equiformer-v2")
    mesh = make_mesh((2, 1), ("data", "model"), "meta")
    shape = ShapeSpec("g", "gnn_full", dict(n_nodes=64, n_edges=256,
                                            d_feat=8))
    runs = {}
    for d in (1, 2, 4):
        cfg = dataclasses.replace(arch.make_config(), n_layers=d)
        a = dataclasses.replace(arch, make_config=lambda cfg=cfg: cfg)
        runs[d] = dryrun.count_case(steps.case_for(a, shape, mesh,
                                                   abstract=True))
    ext = opcost.extrapolate(runs[1], runs[2], 1, 2, 4)
    assert ext["flops"] == runs[4]["flops"]
    assert ext["bytes"] == runs[4]["bytes"]
    assert ext["collectives"]["all-reduce"]["bytes"] == \
        runs[4]["collectives"]["all-reduce"]["bytes"] > 0
    assert abs(ext["peak_bytes"] - runs[4]["peak_bytes"]) \
        <= PEAK_DEPTH_TOL * runs[4]["peak_bytes"]


@pytest.mark.parametrize("arch_id, kind", [
    ("minitron-4b", "train"), ("qwen3-moe-30b-a3b", "train"),
    ("qwen3-moe-30b-a3b", "prefill"), ("dlrm-rm2", "rs_train")])
def test_meta_equals_cpu(arch_id, kind):
    """The same step counted on the ``meta`` device and on CPU tensors:
    the same FLOPs, bytes and peak (what the card's count is held to)."""
    arch = steps.smoke_arch(arch_id)
    shape = ShapeSpec("s", kind, dict(seq_len=32, global_batch=4, batch=64))
    r = {}
    for dev in ("meta", "cpu"):
        case = steps.case_for(arch, shape, abstract=dev == "meta",
                              device="cpu")
        r[dev] = opcost.count(case.fn, case.args, on_cpu=dev == "cpu")[1]
    for k in ("flops", "bytes", "peak_bytes"):
        assert r["meta"][k] == r["cpu"][k], k


def test_sampler_counts_on_meta():
    """The minibatch step (the sampler inside) runs on ``meta`` and counts
    what it counts on CPU tensors."""
    arch = steps.smoke_arch("schnet")
    shape = ShapeSpec("mb", "gnn_minibatch", dict(
        n_nodes=2000, n_edges=8000, batch_nodes=16, fanout=(3, 2),
        d_feat=8))
    r = {}
    for dev in ("meta", "cpu"):
        case = steps.case_for(arch, shape, abstract=dev == "meta",
                              device="cpu")
        r[dev] = opcost.count(case.fn, case.args, on_cpu=dev == "cpu")[1]
    assert r["meta"]["flops"] == r["cpu"]["flops"] > 0
    assert r["meta"]["bytes"] == r["cpu"]["bytes"]


def test_kernel_calls_count_as_one_op():
    """The coloring step's kernel wrappers report each call: its operands'
    and outputs' bytes, the plain twin's own ops not counted."""
    from repro_torch.kernels import ops
    colors = torch.zeros(101, dtype=torch.int32)
    ell = torch.zeros(100, 8, dtype=torch.int32)
    base = torch.zeros(100, dtype=torch.int32)
    active = torch.ones(100, dtype=torch.bool)

    def fn(colors, ell, base, active):
        return ops.mex_window(colors, ell, None, base, active, None, None, 32)

    c = opcost.OpCost(args=(colors, ell, base, active), on_cpu=True)
    with c:
        out = fn(colors, ell, base, active)
    r = c.result()
    want = sum(t.numel() * t.element_size()
               for t in (colors, ell, base, active, out))
    assert r["kernels"] == {"mex_window": {"calls": 1, "bytes": want}}
    assert r["bytes"] == want and r["n_ops"] == 1


def test_kernels_of_the_coloring_step():
    """``ipgc_case``'s dense step on the CPU: ``mex_window``, ``conflict``
    and ``compact`` each counted."""
    from repro_torch.configs import get_arch
    arch = get_arch("paper-ipgc")
    shape = ShapeSpec("k", "coloring", dict(n_nodes=4096, ell_width=8))
    case = steps.case_for(arch, shape, device="cpu")
    r = opcost.count(case.fn, case.args, on_cpu=True)[1]
    assert set(r["kernels"]) >= {"mex_window", "conflict", "compact"}
    assert all(v["calls"] >= 1 and v["bytes"] > 0
               for v in r["kernels"].values())
    assert r["flops"] == 0


def test_nothing_counts_outside_a_counter():
    """The hooks do nothing when no counter runs."""
    t = torch.zeros(3, requires_grad=True)
    assert hooks.collective(t, "all-gather", ("data",),
                            back="reduce-scatter") is t
    with hooks.shard({"data": 1}):
        pass
    assert hooks.active() is None
    assert float(hooks.kernel_call("x", lambda a: a.sum(),
                                   t.detach())) == 0.0


def test_collective_and_its_gradient_pass():
    """``collective`` records its kind at the shard it runs in, and the
    gradient pass's collective ``back`` for the same shard when the
    gradient is taken; a replicated input (kind None) only the latter."""
    mesh = make_mesh((2,), ("data",), "meta")
    x = torch.zeros(8, 4, device="meta", requires_grad=True)

    def fn(x):
        with hooks.shard({"data": 1}):
            y = hooks.collective(x * 2.0, "all-gather", ("data",),
                                 back="reduce-scatter")
            z = hooks.collective(x, None, ("data",), back="all-reduce")
        return torch.autograd.grad((y + z).sum(), x)

    c = opcost.OpCost(mesh, args=(x,))
    with c:
        fn(x)
    nbytes = 8 * 4 * F32
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert list(c.coll[kind]["bytes"]) == [0, nbytes], kind
        assert list(c.coll[kind]["count"]) == [0, 1], kind


def test_kernel_call_flops_by_type():
    """``kernel_call``'s ``flops`` are charged by type beside the call's
    bytes (the int8 decode's products as int8); a call that gives none, as
    the coloring kernels' do, counts no FLOPs."""
    a = torch.zeros(4, 8, dtype=torch.int8)
    c = opcost.OpCost(args=(a,), on_cpu=True)
    with c:
        hooks.kernel_call("k", lambda t: t.to(torch.int32), a,
                          flops={"int8": 64})
        hooks.kernel_call("j", lambda t: t + 1, a)
    r = c.result()
    assert r["flops_by_dtype"] == {"int8": 64.0} and r["flops"] == 64
    assert r["kernels"]["k"] == {"calls": 1, "bytes": 32.0 + 128.0}
    assert r["kernels"]["j"] == {"calls": 1, "bytes": 64.0}


def test_leaves_read_with_their_gradient_collective():
    """A weight that two shards read through ``collective(w, None, axes,
    back="all-reduce")`` gets that all-reduce, one a read for the shard
    that reads it, and no ``add_grad_sync``; one they read plainly gets
    ``add_grad_sync``'s, on every entry."""
    mesh = make_mesh((2,), ("data",), "meta")
    p = {"own": torch.zeros(4, 4, device="meta", requires_grad=True),
         "plain": torch.zeros(4, 4, device="meta", requires_grad=True)}
    x = torch.zeros(3, 4, device="meta")

    def fn(p, x):
        out = []
        for i in range(2):
            with hooks.shard({"data": i}):
                w = hooks.collective(p["own"], None, ("data",),
                                     back="all-reduce")
                out.append((x @ w @ p["plain"]).sum() + (x @ w).sum())
        return torch.autograd.grad(out[0] + out[1], list(p.values()))

    r = opcost.count(fn, (p, x), mesh=mesh, params=p)[1]["collectives"]
    nbytes = 4 * 4 * F32
    # a device: its shard's read of "own", and "plain"'s sum
    assert r["all-reduce"]["count"] == 2
    assert r["all-reduce"]["bytes"] == 2 * nbytes
    bare = opcost.count(fn, (p, x), mesh=mesh)[1]["collectives"]
    assert bare["all-reduce"]["count"] == 1
