"""Time two checkouts of the port on one card, in turns.

    python3 compare_trees.py OTHER_TREE [--runs 3]
    python3 compare_trees.py OTHER_TREE --lm [--runs 3]

``OTHER_TREE`` is another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Each tree runs in a process of its own, in the order
other, this, this, other, so that a drift of the card or its host over the
call falls on both. A process builds its tree's kernels, then:

* by default, colors kron_g500-logn21_s at scale 32 (ell-tail,
  ``ell_cap=128``) and europe_osm_s at scale 127 with ipgc two-phase and
  jpl in the host loop (one untimed run, then ``--runs`` timed ones:
  ``ColoringResult``'s seconds and the peak device memory of each), and
  kron through the distributed Pipe at four shards on the card with jpl
  for ``DIST_ROUNDS`` rounds (seconds a round). The graphs are built once
  and kept in ``build/compare_trees/`` for the other processes. Every run
  of a tree must give the iterations and colors of the other tree's runs.
* with ``--lm``, the LM paths, each after one untimed call: Minitron-4B
  ``long_500k`` (one sequence, 524,288 cached positions) with the
  ``LM_VARIANTS`` decode variants (``launch.steps.build_case`` at the
  published config, ``--runs`` steps timed by CUDA events, as
  ``chip_smoke.py`` phase 12's ``cases.run``); ``launch.serve.serve`` of
  ``chip_smoke.py`` phase 8's cell (``LM_ARCH`` at ``LM_LAYERS`` layers,
  ``LM_SERVE``) with a bf16 and an int8 KV cache: prefill ms and decode ms
  a step; ``launch.train.train`` of phase 9's ``train.full`` cell
  (``TRAIN_ARCH``, ``TRAIN_FULL``, ``TRAIN_FULL_OPT``, remat): the median
  step ms of steps 3-20. The cells' settings are read from
  ``chip_smoke.py``; weights and caches are random from ``LM_SEED``.

Prints one JSON line a process, then the card's name and power limit and a
summary line. Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "compare_trees")
GRAPHS = {"kron": dict(name="kron_g500-logn21_s", scale=32, layout="ell-tail",
                       ell_cap=128),
          "europe": dict(name="europe_osm_s", scale=127, layout="auto")}
ALGOS = ("ipgc", "jpl")
#: the dist jpl run's rounds (kron's 816 would take ~100 s a tree)
DIST_ROUNDS = 16
#: ``--lm``: the decode variants timed at Minitron-4B long_500k, and the
#: names of ``chip_smoke.py``'s settings of the serving and training cells
LM_VARIANTS = ("opt_int8", "opt_int8_half")
LM_SETTINGS = ("LM_ARCH", "LM_LAYERS", "LM_SERVE", "LM_SEED", "TRAIN_ARCH",
               "TRAIN_FULL", "TRAIN_FULL_OPT")


def load_graphs(repro_torch) -> dict:
    """The two graphs, from ``CACHE`` when an earlier process built them."""
    out = {}
    for key, spec in GRAPHS.items():
        path = os.path.join(CACHE, f"{key}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[key] = pickle.load(f)
            continue
        spec = dict(spec)
        g = repro_torch.get_dataset(spec.pop("name"), **spec)
        os.makedirs(CACHE, exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(g, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
        out[key] = g
    return out


def lm_settings() -> dict:
    """``LM_SETTINGS`` from this tree's ``chip_smoke.py`` (read here, in the
    parent, and passed to each tree's process, which must not import this
    tree's package)."""
    import chip_smoke
    return {name: getattr(chip_smoke, name) for name in LM_SETTINGS}


def lm_child(tree: str, runs: int, cells: dict) -> dict:
    """One tree's LM runs (in this process, with ``tree/src`` first on the
    path)."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig

    def free():
        import gc
        gc.collect()
        torch.cuda.empty_cache()

    _, build_s = _build.build_all()
    out = dict(tree=tree, build_seconds=build_s, long_500k={})
    for variant in LM_VARIANTS:
        case = steps.build_case("minitron-4b", "long_500k", variant=variant,
                                device="cuda")
        case.fn(*case.args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
        ev[0].record()
        for i in range(runs):
            case.fn(*case.args)
            ev[i + 1].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(runs)]
        out["long_500k"][variant] = dict(step_ms=ms,
                                         step_ms_mean=float(np.mean(ms)))
        del case
        free()

    cfg = dataclasses.replace(get_arch(cells["LM_ARCH"]).make_config(),
                              n_layers=cells["LM_LAYERS"])
    dev = torch.device("cuda")
    with torch.inference_mode():
        params, _ = tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(cells["LM_SEED"]),
            device=dev)
    serving = cells["LM_SERVE"]
    out["serve"] = {}
    for kv_int8 in (False, True):
        serve(cfg, params=params, batch=serving["batch"],
              prompt_len=serving["prompt_len"], gen=2, kv_int8=kv_int8,
              generator=torch.Generator(device=dev).manual_seed(99))
        r = serve(cfg, params=params, kv_int8=kv_int8,
                  generator=torch.Generator(device=dev).manual_seed(1),
                  **serving)
        out["serve"]["int8" if kv_int8 else "bf16"] = dict(
            prefill_ms=r.prefill_s * 1e3,
            decode_ms_per_step=r.decode_ms_per_step)
    del params
    free()

    tcfg = dataclasses.replace(get_arch(cells["TRAIN_ARCH"]).make_config(),
                               remat=True)
    r = train(tcfg, AdamWConfig(**cells["TRAIN_FULL_OPT"]), log_every=10,
              log=lambda line: None, **cells["TRAIN_FULL"])
    out["train_full"] = dict(step_ms=list(r.step_ms),
                             step_ms_median_3_20=float(
                                 np.median(r.step_ms[2:20])))
    return out


def lm_summary(results: list, other: str) -> dict:
    """Each number's mean over a tree's two processes."""
    def numbers(rec):
        n = {f"long_500k.{v}.step_ms": rec["long_500k"][v]["step_ms_mean"]
             for v in LM_VARIANTS}
        for kv, r in rec["serve"].items():
            n[f"serve.{kv}.prefill_ms"] = r["prefill_ms"]
            n[f"serve.{kv}.decode_ms_per_step"] = r["decode_ms_per_step"]
        n["train_full.step_ms"] = rec["train_full"]["step_ms_median_3_20"]
        return n

    out = {}
    for name, tree in (("other", other), ("this", ROOT)):
        nums = [numbers(r) for r in results if r["tree"] == tree]
        out[name] = {k: sum(n[k] for n in nums) / len(nums) for k in nums[0]}
    return out


def child(tree: str, runs: int) -> dict:
    """One tree's coloring runs (in this process, with ``tree/src`` first on
    the path)."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    import repro_torch
    from repro_torch.exec import default_session
    from repro_torch.kernels import _build

    _, build_s = _build.build_all()
    graphs = load_graphs(repro_torch)
    out = dict(tree=tree, build_seconds=build_s, host={})
    for key, g in graphs.items():
        for algo in ALGOS:
            repro_torch.color(g, algo=algo, fused=False)     # untimed
            seconds, peaks = [], []
            for _ in range(runs):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                r = repro_torch.color(g, algo=algo, fused=False)
                seconds.append(r.total_seconds)
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            out["host"][f"{key} {algo}"] = dict(
                seconds=seconds, peak_gib=peaks, iterations=r.iterations,
                n_colors=r.n_colors)
        default_session().cache.clear()
        torch.cuda.empty_cache()
    dev = torch.device("cuda")
    kw = dict(devices=[dev] * 4, algo="jpl", max_iter=DIST_ROUNDS)
    repro_torch.color_distributed(graphs["kron"], **kw)        # partitions
    seconds = []
    for _ in range(runs):
        r = repro_torch.color_distributed(graphs["kron"], **kw)
        seconds.append(r.total_seconds / r.iterations)
    out["dist_kron_jpl_s4"] = dict(seconds_a_round=seconds,
                                   rounds=r.iterations)
    return out


def coloring_summary(results: list, other: str) -> dict:
    """The best seconds and the last peak of each tree, after checking that
    every run gave the same iterations and colors."""
    for key in results[0]["host"]:
        got = {(r["host"][key]["iterations"], r["host"][key]["n_colors"])
               for r in results}
        if len(got) != 1:
            raise AssertionError(f"{key}: the trees differ: {got}")

    def best(tree, key):
        return min(s for r in results if r["tree"] == tree
                   for s in r["host"][key]["seconds"])

    summary = {key: dict(other_best_s=best(other, key),
                         this_best_s=best(ROOT, key),
                         other_peak_gib=max(r["host"][key]["peak_gib"][-1]
                                            for r in results
                                            if r["tree"] == other),
                         this_peak_gib=max(r["host"][key]["peak_gib"][-1]
                                           for r in results
                                           if r["tree"] == ROOT))
               for key in results[0]["host"]}
    summary["dist_kron_jpl_s4_s_a_round"] = {
        name: min(s for r in results if r["tree"] == tree
                  for s in r["dist_kron_jpl_s4"]["seconds_a_round"])
        for name, tree in (("other", other), ("this", ROOT))}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--cells", help=argparse.SUPPRESS)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--lm", action="store_true",
                    help="time the LM paths instead of the colorings")
    a = ap.parse_args()
    if a.child:
        res = (lm_child(a.child, a.runs, json.loads(a.cells)) if a.lm
               else child(a.child, a.runs))
        print(json.dumps(res), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 2
    if not a.other:
        ap.error("give the other tree")
    other = os.path.abspath(a.other)
    extra = ["--lm", "--cells", json.dumps(lm_settings())] if a.lm else []
    results = []
    for tree in (other, ROOT, ROOT, other):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--runs", str(a.runs), *extra],
            capture_output=True, text=True, check=True, timeout=1800)
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["process_seconds"] = time.perf_counter() - t0
        results.append(res)
        print(json.dumps(res), flush=True)
    summary = (lm_summary if a.lm else coloring_summary)(results, other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
