"""``repro_torch.launch.roofline`` on synthetic dry-run records: each term
against the H100 constants, the bound, the fractions and the table."""
from __future__ import annotations

import json
import math

import pytest

from repro_torch.launch import roofline
from repro_torch.launch.mesh import (HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS,
                                     PEAK_FLOPS_BF16)


def _rec(arch, shape, flops, nbytes, coll=None, model_flops=0.0,
         kind="train", ok=True, n=256, by_dtype=None):
    """A record; its FLOPs all bf16 unless ``by_dtype`` splits them."""
    rec = {"arch": arch, "shape": shape, "mesh": roofline.MESH,
           "n_devices": n, "ok": ok}
    if by_dtype is None:
        by_dtype = {"bfloat16": flops} if flops else {}
    if ok:
        rec.update(meta={"model_flops": model_flops, "kind": kind},
                   cost={"flops": flops, "bytes": nbytes,
                         "flops_by_dtype": by_dtype},
                   collectives={**(coll or {}), "total_bytes": sum(
                       v["bytes"] for v in (coll or {}).values())})
    else:
        rec["error"] = "ValueError: a batch of 32 does not split"
    return rec


def _write(tmp_path, recs):
    for r in recs:
        path = tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
        path.write_text(json.dumps(r))


def _coll(**by_axes):
    """One collective kind's record: its bytes split by axes."""
    return {"bytes": sum(by_axes.values()), "count": len(by_axes),
            "axes": sorted({a for k in by_axes for a in k.split("_")}),
            "by_axes": {k.replace("_", ","): v for k, v in by_axes.items()}}


def test_terms_bound_and_fractions():
    coll = {"all-gather": _coll(model=0.5 * NVLINK_BW),
            "all-reduce": _coll(data=0.25 * NET_BW)}
    rec = _rec("a", "s", 2 * PEAK_FLOPS_BF16, 3 * HBM_BW, coll,
               model_flops=256 * PEAK_FLOPS_BF16)
    r = roofline.roofline_row(rec)
    assert r["t_compute"] == pytest.approx(2.0, rel=1e-15)
    assert r["t_memory"] == pytest.approx(3.0, rel=1e-15)
    assert r["t_collective"] == pytest.approx(0.75, rel=1e-15)
    assert r["bound"] == "memory" and r["t_bound"] == r["t_memory"]
    # useful = model FLOPs / (FLOPs a device x devices)
    assert r["useful_ratio"] == pytest.approx(0.5, rel=1e-15)
    # frac = (model FLOPs / (devices x peak)) / bound = 1 s / 3 s
    assert r["roofline_frac"] == pytest.approx(1 / 3, rel=1e-15)


def test_flops_are_priced_by_their_type():
    """1 s of bf16 products and 1 s of float32 ones at their peaks; a type
    the table lacks (int64) at float32's rate. The fraction prices the
    model's FLOPs at the mix's rate: 3 s of work at the counted rate."""
    f32 = PEAK_FLOPS["float32"]
    mix = {"bfloat16": PEAK_FLOPS_BF16, "float32": f32, "int64": f32}
    rec = _rec("a", "s", sum(mix.values()), HBM_BW, by_dtype=mix,
               model_flops=256 * sum(mix.values()), n=256)
    r = roofline.roofline_row(rec)
    assert r["t_compute"] == pytest.approx(3.0, rel=1e-15)
    assert r["bound"] == "compute"
    assert r["roofline_frac"] == pytest.approx(1.0, rel=1e-15)
    assert roofline.compute_seconds({"float32": f32}) == 1.0
    assert f32 == 66.9e12 and PEAK_FLOPS["int8"] == 1978.9e12


def test_collective_over_two_axes_is_priced_at_the_network():
    coll = {"all-gather": _coll(data_model=NET_BW)}
    assert roofline.collective_seconds(coll) == pytest.approx(1.0)
    coll = {"all-gather": _coll(model=NVLINK_BW)}
    assert roofline.collective_seconds(coll) == pytest.approx(1.0)


def test_one_kind_is_priced_by_the_axes_of_each_collective():
    """An all-reduce over the model axis (the MoE's psum) and another over
    the data axis (a gradient sum) in one kind: each at its own link."""
    coll = {"all-reduce": _coll(model=2 * NVLINK_BW, data=3 * NET_BW)}
    assert roofline.collective_seconds(coll) == pytest.approx(5.0)


def test_collective_bound():
    coll = {"all-reduce": _coll(pod_data=5 * NET_BW)}
    r = roofline.roofline_row(_rec("a", "s", PEAK_FLOPS_BF16, HBM_BW, coll))
    assert r["bound"] == "collective" and r["t_bound"] == pytest.approx(5.0)


def test_no_matmul_flops_has_no_useful_ratio():
    """The coloring: no matmul FLOPs, so 'useful' is NaN."""
    r = roofline.roofline_row(_rec("paper-ipgc", "suite_kron", 0.0,
                                   HBM_BW * 1e-3, model_flops=1e9,
                                   kind="coloring", n=1))
    assert math.isnan(r["useful_ratio"])
    assert r["bound"] == "memory"
    assert r["roofline_frac"] == pytest.approx(
        1e9 / PEAK_FLOPS_BF16 / 1e-3)


def test_failed_record_row():
    r = roofline.roofline_row(_rec("a", "s", 0, 0, ok=False))
    assert r["ok"] is False and "does not split" in r["error"]


def test_table_and_summary(tmp_path):
    _write(tmp_path, [
        _rec("gemma-7b", "train_4k", PEAK_FLOPS_BF16, HBM_BW / 2,
             model_flops=100 * PEAK_FLOPS_BF16),
        _rec("qwen3", "prefill_32k", 0, 0, ok=False)])
    table = roofline.markdown_table(str(tmp_path)).splitlines()
    assert table[0].startswith("| arch | shape | kind | compute |")
    assert "| gemma-7b | train_4k | train | 1.00s | 500.00ms | 0us |" \
        in table[2]
    assert table[3] == "| qwen3 | prefill_32k | FAILED | | | | | | |"
    lines = roofline.summary_lines(str(tmp_path))
    assert lines == ["roofline/gemma-7b/train_4k,1000000,"
                     "bound=compute frac=0.391"]


def test_summary_without_records(tmp_path):
    with pytest.raises(FileNotFoundError):
        roofline.summary_lines(str(tmp_path))


def test_main_prints_the_card(tmp_path, capsys):
    _write(tmp_path, [_rec("a", "s", PEAK_FLOPS_BF16, 1.0)])
    roofline.main(["--outdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "NVIDIA H100" in out and "| a | s | train |" in out
