"""The harness's own parts: the import check, lookup by name, the sample of
colorings, the trace reduction, and the refusals of ``run.py``."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench import catalog, harness, tracing

ROOT = catalog.ROOT


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.ipgc", "repro_torch", "repro_torch.core",
             "reproducible", "jaxtyping", "numpy", "bench.harness"]
    assert harness.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
         "repro.core.ipgc"])


def _copy_tree(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((dst / "BENCHMARK.json").read_text())


def test_new_files_are_found_by_name(tmp_path):
    bm = _copy_tree(tmp_path)
    bench = tmp_path / "bench"
    cfg = json.loads((bench / "configs" / "kron_g500.json").read_text())
    cfg["params"]["scale"] = 7
    (bench / "configs" / "kron_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "solve_twice.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "entry": "Session.run", "spec": {},
         "warmup": 2}))
    (bench / "workloads" / "kron_tiny.solve_twice.json").write_text(
        json.dumps({"compare_sample": 3, "profile_colorings": 1}))
    (bench / "metrics" / "pipe.colors.py").write_text(
        "def read(ctx):\n    return ctx.results[0].n_colors\n")
    (bench / "kernels" / "new_kernel.py").write_text(
        "ENTRY = 'repro_torch.kernels.ops:frontier_probe'\n"
        "def bytes_of(call, out):\n    return 0\n")
    bm["configs"].append({"name": "kron_tiny", "source": "test",
                          "file": "bench/configs/kron_tiny.json",
                          "reduced": ["scale"], "why": "test"})
    bm["workloads"].append({"name": "kron_tiny.solve_twice",
                            "config": "kron_tiny", "traffic": "solve_twice",
                            "chips": 1, "why": "test"})
    bm["per_layer"].append({"name": "pipe.colors", "unit": "count",
                            "better": "lower", "source": "program_counter",
                            "layer": "Pipe", "moves": "color_s",
                            "workloads": ["kron_tiny.solve_twice"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    cell = catalog.load_cell("kron_tiny.solve_twice", tmp_path)
    assert cell.config["params"]["scale"] == 7
    assert cell.traffic["warmup"] == 2
    assert cell.settings["compare_sample"] == 3
    assert [m["name"] for m in cell.per_layer] == ["pipe.colors"]
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "color_s", "peak_gib"}
    assert cell.generator().generate.__module__ == "bench_generators.kronecker"
    assert "new_kernel" in catalog.kernel_rules(tmp_path)
    reader = catalog.metric_reader("pipe.colors", tmp_path)

    class R:
        n_colors = 5
    assert reader.read(harness.Context({}, [R()], None, None, 0, None)) == 5
    with pytest.raises(KeyError):
        catalog.load_cell("no_such.cell", tmp_path)


def test_every_listed_metric_has_a_reader():
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bm["per_layer"]:
        assert callable(catalog.metric_reader(m["name"]).read)
    for w in bm["workloads"]:
        cell = catalog.load_cell(w["name"])
        assert cell.per_layer and cell.end_to_end
        assert {"setup_s", "color_s"} <= {m["name"] for m in cell.end_to_end}


def test_sample_is_drawn_from_the_seed_and_keeps_the_last():
    def draw(seed, n=50, k=3):
        s = harness.Sample(k, seed)
        for i in range(n):
            s.offer(i)
        return s.items()
    a = draw(1)
    assert a == draw(1) and len(a) in (3, 4) and a[-1] == 49
    assert draw(1, n=2) == [0, 1]
    assert any(draw(s) != a for s in range(2, 6))


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_reduce_times_busy_idle_and_labels():
    port = "void (anonymous namespace)::mex_window_kernel<4, int, 256>(" \
           "int const*, (anonymous namespace)::MexArgs)"
    events = [
        _ev("user_annotation", tracing.MARK, 0, 100),
        _ev("user_annotation", tracing.MARK, 100, 100),
        _ev("cpu_op", "aten::index_put_", 10, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 5),
        _ev("cpu_op", "aten::item", 150, 40),
        _ev("kernel", port, 20, 10, tid=7),
        _ev("kernel", "void at::native::index_kernel<int>(int*)", 40, 20,
            tid=7),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 55, 25, tid=7),
        _ev("kernel", port, 160, 10, tid=7),
        _ev("gpu_user_annotation", tracing.MARK, 0, 200, tid=7),
        _ev("kernel", port, 250, 10, tid=7),     # outside the window
    ]
    match = tracing.kernel_matcher({"mex_window_kernel", "scan_kernel"})
    red = tracing.reduce(events, match, {"mex_window_kernel"})
    assert red.colorings == 2
    assert red.window_s == pytest.approx(200e-6)
    assert red.busy_s == pytest.approx(60e-6)     # 20-30, 40-80, 160-170
    assert red.span_s == pytest.approx(150e-6)
    assert red.kernel_s == pytest.approx(20e-6)
    assert red.readback_s == pytest.approx(25e-6)
    assert red.other_s == pytest.approx(20e-6)
    assert red.launches == {"mex_window_kernel": 2}
    gaps = dict(red.idle_gaps)
    assert gaps["aten::index_put_"] == pytest.approx(30e-6)   # 0-20, 30-40
    assert gaps["aten::item"] == pytest.approx(30e-6)         # 170-200
    assert gaps["python between operations"] == pytest.approx(80e-6)
    assert sum(gaps.values()) == pytest.approx(red.window_s - red.busy_s)
    ops = dict(red.device_ops)
    assert red.device_ops[0] == ["Memcpy DtoH", pytest.approx(25e-6)]
    assert ops["at::native::index_kernel<int>"] == pytest.approx(20e-6)
    with pytest.raises(RuntimeError, match="no byte rule"):
        tracing.reduce(events, match, set())


def test_steps_keep_device_copies_and_readback_reads_host_copies():
    events = [
        _ev("user_annotation", tracing.MARK, 0, 100),
        _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 10, 20, tid=7),
        _ev("gpu_memset", "Memset (Device)", 30, 5, tid=7),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 40, 30, tid=7),
        _ev("kernel", "void at::native::index_kernel<int>(int*)", 70, 10,
            tid=7),
    ]
    red = tracing.reduce(events, tracing.kernel_matcher(set()), set())
    assert red.other_s == pytest.approx(35e-6)
    assert red.readback_s == pytest.approx(30e-6)
    ctx = harness.Context({}, [], red, None, 0, None)
    steps = catalog.metric_reader("steps.aten_ms").read(ctx)
    readback = catalog.metric_reader("readback.ms").read(ctx)
    assert steps == pytest.approx(35e-3)
    assert readback == pytest.approx(30e-3)
    red.readback_s = 0.0
    assert catalog.metric_reader("readback.ms").read(ctx) is None


def test_kernel_names_of_the_port():
    from repro_torch.kernels._build import CSRC

    names = tracing.port_kernel_names(CSRC)
    assert {"mex_window_kernel", "conflict_kernel", "scan_kernel",
            "fused_rows_kernel"} <= names
    match = tracing.kernel_matcher(names)
    assert match("void compact::scan_kernel<256>(unsigned char const*)") \
        == "scan_kernel"
    assert match("void (anonymous namespace)::conflict_kernel<4, int, 256>"
                 "(int const*)") == "conflict_kernel"
    assert match("void at::native::vectorized_elementwise_kernel<4>()") \
        is None
    assert match("Memcpy DtoH (Device -> Pageable)") is None


def _run_py(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kron_g500.solve",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            _copy_tree(tmp_path)
        p = _run_py(cwd, {"CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0
        assert not any(line.startswith("{") for line in
                       p.stdout.splitlines())
