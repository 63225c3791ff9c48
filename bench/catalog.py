"""Finds what belongs to a cell by the names in ``BENCHMARK.json``.

Each configuration, traffic mix, cell, per-layer metric, graph generator,
reference and kernel byte rule is a file of its own, so that a later
change adds a graph, a mix, a metric or a rule by adding files and
entries, without editing a file that is already there:

    BENCHMARK.json                     cells, configurations, metrics
    <config file named there>          sizes, generator, layout, reference
    bench/traffic/<traffic>.json       the mix: loop, clients, entry, spec
    bench/workloads/<cell>.json        the cell's own settings
    bench/generators/<name>.py         generate(params, seed, device)
    bench/reference/<name>.py          the plain reference
    bench/metrics/<metric>.py          read(ctx) -> float | None
    bench/kernels/<kernel>.py          ENTRY and bytes_of(call, out)

Python files are loaded by path, since a metric's name holds dots.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

#: the checkout's root: the folder that holds ``BENCHMARK.json``
ROOT = Path(__file__).resolve().parents[1]


def bench_dir(root: Path) -> Path:
    return Path(root) / "bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str):
    """The Python file at ``path`` as a module named ``bench_<kind>.<stem>``
    (registered in ``sys.modules`` so that dataclasses resolve)."""
    path = Path(path)
    name = f"bench_{kind}.{path.stem}"
    if name in sys.modules and getattr(sys.modules[name], "__file__",
                                       None) == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return mod


@dataclasses.dataclass
class Cell:
    """Everything one cell's run reads, found by name."""

    name: str
    chips: int
    config_name: str
    config: dict            # the configuration's file
    traffic: dict           # bench/traffic/<traffic>.json
    settings: dict          # bench/workloads/<cell>.json
    end_to_end: list        # BENCHMARK.json entries that this cell reports
    per_layer: list
    root: Path

    def generator(self):
        return load_module(bench_dir(self.root) / "generators"
                           / f"{self.config['generator']}.py", "generators")

    def reference(self):
        return load_module(bench_dir(self.root) / "reference"
                           / f"{self.config['reference']}.py", "reference")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a name the file does not hold."""
    root = Path(root)
    bm = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bm["configs"]}
    cfg = configs[w["config"]]
    bench = bench_dir(root)
    return Cell(
        name=name, chips=int(w["chips"]), config_name=cfg["name"],
        config=load_json(root / cfg["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        settings=load_json(bench / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bm["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bm["per_layer"] if _applies(m, name)],
        root=root)


def metric_reader(name: str, root: Path = ROOT):
    """The reader of the per-layer metric ``name``."""
    return load_module(bench_dir(root) / "metrics" / f"{name}.py", "metrics")


def kernel_rules(root: Path = ROOT) -> dict:
    """Kernel name -> its byte rule, one file a kernel."""
    folder = bench_dir(root) / "kernels"
    return {p.stem: load_module(p, "kernels")
            for p in sorted(folder.glob("*.py"))}


def peak_bytes_per_s(kind: str, root: Path = ROOT) -> "float | None":
    """The device memory bandwidth of the card named ``kind`` in
    ``bench/peaks.json``, None for a card the table does not hold."""
    entry = load_json(bench_dir(root) / "peaks.json").get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])
