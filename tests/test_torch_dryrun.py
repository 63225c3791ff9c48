"""``repro_torch.launch.dryrun``: its records, its argument bytes, its
collectives against hand formulas and against the reference's
``repro.launch.dryrun.collective_bytes`` of the same MoE, and its FLOPs
against the reference's ``repro.launch.hlocost`` on the same smoke cases.
Everything counts on the ``meta`` device on the CPU at small shapes, but
for the two record tests, which build published cells abstractly and stop
before counting a large step."""
from __future__ import annotations

import dataclasses
import json

from typing import ClassVar

import jax
import pytest
import torch

import _moe_collectives_ref
from _case_check import SHAPES
from _mesh_ref import MOE, MOE_X
from _steps_ref import one_device_mesh, reference_case, reference_steps
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun, opcost, steps
from repro_torch.launch.mesh import EXPERT_FF_AXIS, make_mesh
from repro_torch.models.gnn.equiformer_v2 import EqV2Config
from repro_torch.models.moe import MoESettings, moe_ffn

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

KEYS = {"arch", "shape", "mesh", "variant", "n_devices", "ok", "meta",
        "memory", "arg_shard_bytes", "cost", "collectives",
        "depths_counted", "counted_on", "total_s"}


@pytest.mark.parametrize("mesh_name", ["card", "single"])
def test_record_keys(tmp_path, mesh_name):
    """A published cell's record (DLRM-RM2 at ``serve_p99``: its step is
    small on ``meta``) carries the reference's keys."""
    rec = dryrun.run_cell("dlrm-rm2", "serve_p99", mesh_name, str(tmp_path))
    assert rec["ok"], rec.get("error")
    assert KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "peak_bytes",
                                  "temp_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes", "flops_by_dtype"}
    assert sum(rec["cost"]["flops_by_dtype"].values()) == \
        rec["cost"]["flops"]
    assert set(rec["collectives"]) == set(opcost.COLLECTIVES) | {
        "total_bytes"}
    assert rec["counted_on"] == "meta" and rec["cost"]["flops"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    name = "card" if mesh_name == "card" else "h100_32x8"
    path = tmp_path / f"dlrm-rm2__serve_p99__{name}.json"
    assert json.loads(path.read_text())["n_devices"] == rec["n_devices"]


def test_unsplittable_cell_is_written_failed(tmp_path):
    """Qwen3's ``prefill_32k`` (a batch of 32) over the multi-pod mesh's 64
    data shards: ``ok: false`` with the error, as the step would raise."""
    rec = dryrun.run_cell("qwen3-moe-30b-a3b", "prefill_32k", "multi",
                          str(tmp_path))
    assert rec["ok"] is False
    assert "does not split over 64 data shards" in rec["error"]
    assert (tmp_path / "qwen3-moe-30b-a3b__prefill_32k__h100_2x32x8.json"
            ).exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the reason "
                    "given without a card")
def test_value_cell_without_a_card(tmp_path):
    rec = dryrun.run_cell("paper-ipgc", "suite_kron", "card", str(tmp_path))
    assert rec["ok"] is False and "needs values" in rec["error"]


def _smoke_lm(arch_id, kind, mesh, batch=4, abstract=True, layers=None):
    arch = steps.smoke_arch(arch_id)
    if layers is not None:
        cfg = dataclasses.replace(arch.make_config(), n_layers=layers)
        arch = dataclasses.replace(arch, make_config=lambda: cfg)
    shape = ShapeSpec("s", kind, dict(seq_len=16, global_batch=batch))
    return steps.case_for(arch, shape, mesh, abstract=abstract,
                          device=None if abstract else "cpu")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def test_arg_shard_bytes_by_hand():
    """A smoke MoE training case on a (2, 2) CPU mesh: the expert weights
    and their moments over model x FSDP (4 ways), the batch over data (2),
    the rest whole."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    case = _smoke_lm("qwen3-moe-30b-a3b", "train", mesh, abstract=False)
    params, opt, batch = case.args
    want = 0
    for tree in (params, opt.m, opt.v):
        for k, v in tree["layers"].items():
            want += _nbytes(v) // (4 if k in EXPERT_FF_AXIS else 1)
        want += sum(_nbytes(v) for k, v in tree.items() if k != "layers")
    want += _nbytes(opt.step) + sum(_nbytes(v) // 2 for v in batch.values())
    assert dryrun.arg_shard_bytes(case) == want
    assert dryrun.arg_shard_bytes(_smoke_lm(
        "qwen3-moe-30b-a3b", "train", None, abstract=False)) == \
        steps.arg_bytes(case)


def test_collectives_by_hand():
    """A smoke MoE prefill on a (2, 2) mesh: per device and layer, the FSDP
    all-gather of its model shard's three expert weights (their full
    ``ff``), the all-reduce over the model axis that sums its data shard's
    outputs, and the all-reduce of the float32 aux loss."""
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    case = _smoke_lm("qwen3-moe-30b-a3b", "prefill", mesh)
    cfg = steps.smoke_arch("qwen3-moe-30b-a3b").make_config()
    r = dryrun.count_case(case)["collectives"]
    e_local = cfg.moe.n_experts // 2
    esize = torch.empty((), dtype=cfg.dtype).element_size()
    gathered = 3 * e_local * cfg.d_model * cfg.moe.d_ff_expert * esize
    assert r["all-gather"]["bytes"] == cfg.n_layers * gathered
    assert r["all-gather"]["count"] == 3 * cfg.n_layers
    assert r["all-gather"]["axes"] == ["data"]
    tokens = 4 // 2 * 16
    assert r["all-reduce"]["bytes"] == \
        cfg.n_layers * (tokens * cfg.d_model * esize + 4)
    assert r["all-reduce"]["count"] == 2 * cfg.n_layers
    assert r["all-reduce"]["axes"] == ["data", "model"]
    assert r["all-reduce"]["by_axes"] == {
        "data,model": cfg.n_layers * 4,
        "model": cfg.n_layers * tokens * cfg.d_model * esize}
    assert r["all-to-all"]["count"] == r["reduce-scatter"]["count"] == 0


def test_grad_all_reduce_is_the_replicated_leaves():
    """A smoke MoE training step on a (2, 2) mesh: the all-reduce the
    gradient sums add (``count_case`` against the same step counted
    without them) is the gradient bytes of every leaf the data shards
    replicate (all but the expert weights, whose FSDP part is the
    reduce-scatter the gradient pass records), one a leaf."""
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    case = _smoke_lm("qwen3-moe-30b-a3b", "train", mesh)
    r = dryrun.count_case(case)["collectives"]
    bare = opcost.count(case.fn, case.args, mesh=mesh)[1]["collectives"]
    params = case.args[0]
    leaves = [v for k, v in params["layers"].items()
              if k not in EXPERT_FF_AXIS] + \
        [v for k, v in params.items() if k != "layers"]
    assert r["all-reduce"]["bytes"] - bare["all-reduce"]["bytes"] == \
        sum(_nbytes(v) for v in leaves)
    assert r["all-reduce"]["count"] - bare["all-reduce"]["count"] == \
        len(leaves)
    # the transposed FSDP gather: one reduce-scatter a gathered weight
    assert r["reduce-scatter"]["count"] == r["all-gather"]["count"] / 2
    # a dense stack has no experts: only the all-reduce
    dense = dryrun.count_case(_smoke_lm("minitron-4b", "train", mesh))
    assert dense["collectives"]["all-reduce"]["count"] == len(
        [1 for _ in steps.flatten_args(_smoke_lm("minitron-4b", "train",
                                                 mesh).args[0])])


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The reference's ``collective_bytes`` of each MoE case
    (``_moe_collectives_ref``), compiled on four forced host devices in a
    subprocess."""
    out = tmp_path_factory.mktemp("moe_ref") / "collectives.json"
    _moe_collectives_ref.run(str(out))
    return json.loads(out.read_text())


@pytest.mark.parametrize("fsdp, grad", _moe_collectives_ref.CASES)
def test_moe_collectives_match_the_reference(moe_reference, fsdp, grad):
    """The MoE mesh form on the same (2, 2) mesh, shapes and cotangents:
    each kind's per-device bytes and count equal the reference's compiled
    program's. Forward: the FSDP all-gathers, the psum of the outputs over
    the model axis, the aux's pmean; the gradient pass adds the psum of
    the outputs' gradient, the sum of the replicated tokens' gradient over
    the model axis, the aux's, the router's gradient sum and the expert
    weights' reduce-scatter (FSDP) or all-reduce (none)."""
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    cfg = MoESettings(**MOE)
    e, d, f = MOE["n_experts"], MOE_X[2], MOE["d_ff_expert"]
    x = torch.zeros(MOE_X, device="meta", requires_grad=grad)
    p = {k: torch.zeros(s, device="meta", requires_grad=grad)
         for k, s in (("router", (d, e)), ("we_in", (e, d, f)),
                      ("we_gate", (e, d, f)), ("we_out", (e, f, d)))}

    def fn(x, p):
        y, aux = moe_ffn(x, p, cfg, mesh=mesh, batch_axes=("data",),
                         fsdp_axes=fsdp)
        if not grad:
            return y, aux
        return torch.autograd.grad((y, aux), [x, *p.values()],
                                   grad_outputs=(2 * y, torch.ones_like(aux)))

    r = opcost.count(fn, (x, p), mesh=mesh, params=p if grad else None,
                     split={k: ("model",) + fsdp for k in EXPERT_FF_AXIS}
                     )[1]["collectives"]
    ref = moe_reference[_moe_collectives_ref.case_key(fsdp, grad)]
    for kind in opcost.COLLECTIVES:
        assert (r[kind]["bytes"], r[kind]["count"]) == \
            (ref[kind]["bytes"], ref[kind]["count"]), kind
    assert r["total_bytes"] == ref["total_bytes"] > 0


@dataclasses.dataclass(frozen=True)
class _WholeEqV2(EqV2Config):
    """EquiformerV2 that declares no repeated stack."""
    repeated_layers: ClassVar[bool] = False


@pytest.mark.parametrize("make, depths", [
    (EqV2Config, [1, 2]), (_WholeEqV2, None)])
def test_rules_follow_the_config(make, depths):
    """The depth rule follows ``repeated_layers`` and the chunk rule
    ``edge_chunk``, whatever the model's name: the same smoke
    EquiformerV2 at 3 layers and 4 chunks, declared repeated or not."""
    arch = steps.smoke_arch("equiformer-v2")
    fields = {k.name: getattr(arch.make_config(), k.name)
              for k in dataclasses.fields(EqV2Config)}
    cfg = make(**dict(fields, n_layers=3, edge_chunk=1024))
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    shape = ShapeSpec("g", "gnn_full", dict(n_nodes=64, n_edges=4096,
                                            d_feat=8))
    counts, _ = dryrun.count_spec(arch, shape)
    assert counts["depths_counted"] == depths
    assert counts["chunks_counted"] == [1, 2]


def test_depth_rule_skips_an_undeclared_stack():
    """EGNN repeats its layers but declares nothing: counted whole."""
    arch = steps.smoke_arch("egnn")
    shape = ShapeSpec("g", "gnn_full", dict(n_nodes=64, n_edges=256,
                                            d_feat=8))
    counts, _ = dryrun.count_spec(arch, shape)
    assert counts["depths_counted"] is None
    assert counts["chunks_counted"] is None


@pytest.mark.parametrize("arch_id, kind", [
    ("minitron-4b", "train"), ("minitron-4b", "prefill"),
    ("qwen3-moe-30b-a3b", "train"), ("qwen3-moe-30b-a3b", "decode")])
def test_shard_rule(arch_id, kind):
    """Four data shards counted as two, each holding a shard of the four's
    rows (``dryrun.shard_cut``): FLOPs and collectives exactly the four's
    on each device, bytes within ``SHARD_RULE_BYTES``."""
    mesh = make_mesh((4, 2), ("data", "model"), "meta")
    arch = steps.smoke_arch(arch_id)
    shape = ShapeSpec("s", kind, dict(seq_len=16, global_batch=8))
    full = steps.case_for(arch, shape, mesh, abstract=True)
    c_arch, c_shape, c_mesh, keep = dryrun.shard_cut(arch, shape, full)
    assert keep == {"data": 2, "model": 2}
    cut = dryrun.count_case(steps.case_for(c_arch, c_shape, c_mesh,
                                           abstract=True))
    whole = dryrun.count_case(full)
    assert cut["flops"] == whole["flops"]
    for k in opcost.COLLECTIVES:
        assert cut["collectives"][k]["bytes"] == \
            whole["collectives"][k]["bytes"], k
    assert abs(cut["bytes"] - whole["bytes"]) <= \
        SHARD_RULE_BYTES * whole["bytes"]


#: the shard rule's bytes against the full mesh's, relative: the ops on
#: the joined per-shard scalars (the aux losses) are spread over two
#: shards' or four's (measured at most 6.2e-7)
SHARD_RULE_BYTES = 1e-6


def test_chunk_rule():
    """EquiformerV2 with a 1,024-edge chunk: counts at 1 and 2 chunks
    extended to 4 equal a count at 4 chunks."""
    arch = steps.smoke_arch("equiformer-v2")
    cfg = dataclasses.replace(arch.make_config(), edge_chunk=1024)
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    runs = {}
    for k in (1, 2, 4):
        shape = ShapeSpec("g", "gnn_full", dict(n_nodes=64, n_edges=1024 * k,
                                                d_feat=8))
        runs[k] = dryrun.count_case(steps.case_for(arch, shape,
                                                   abstract=True))
    ext = opcost.extrapolate(runs[1], runs[2], 1, 2, 4)
    assert ext["flops"] == runs[4]["flops"]
    assert ext["bytes"] == runs[4]["bytes"]


def test_per_device_flops_split_with_the_batch():
    """A dense stack's training step on two data shards: each device does
    half the matmul FLOPs of the unsharded step."""
    mesh = make_mesh((2, 1), ("data", "model"), "meta")
    one = dryrun.count_case(_smoke_lm("minitron-4b", "train", None))
    two = dryrun.count_case(_smoke_lm("minitron-4b", "train", mesh))
    assert 2 * two["flops"] == one["flops"]


#: the port's matmul FLOPs against the reference's ``hlocost`` on the
#: same smoke cases: prefill and decode measured equal, training at most
#: 0.85% above (the flash loop's recomputed blocks), held to 1%
HLOCOST_CEILING = 0.01


@pytest.fixture
def jsteps(monkeypatch):
    yield from reference_steps(monkeypatch)


@pytest.mark.parametrize("arch_id", ["qwen3-moe-30b-a3b", "minitron-4b",
                                     "gemma-7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_match_the_reference_hlocost(jsteps, arch_id, kind):
    from repro.launch import hlocost
    jcase = reference_case(jsteps, arch_id, SHAPES[kind])
    with jax.set_mesh(one_device_mesh()):
        txt = jax.jit(jcase.fn).lower(*jcase.args).compile().as_text()
    ref = hlocost.analyze(txt)["flops"]
    case = steps.case_for(steps.smoke_arch(arch_id), SHAPES[kind],
                          abstract=True)
    mine = dryrun.count_case(case)["flops"]
    assert ref > 0
    assert abs(mine / ref - 1) <= HLOCOST_CEILING, (mine, ref)


def test_production_meshes_and_pod_axes():
    """The single mesh (32, 8) and the multi-pod mesh (2, 32, 8) on
    ``meta``; on the multi-pod mesh the batch and FSDP axes are ``("pod",
    "data")``."""
    from repro_torch.launch.mesh import make_production_mesh
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 32, "model": 8}
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert single.distinct_devices() == [torch.device("meta")]
    case = steps.build_case("qwen3-moe-30b-a3b", "train_4k", multi,
                            abstract=True)
    assert case.axes == {"batch_axes": ("pod", "data"),
                         "fsdp_axes": ("pod", "data")}
    case = steps.build_case("qwen3-moe-30b-a3b", "train_4k", single,
                            abstract=True)
    assert case.axes == {"batch_axes": ("data",), "fsdp_axes": ("data",)}
