"""Time two checkouts of the port on one card, in turns.

    python3 compare_trees.py OTHER_TREE [--runs 3]

``OTHER_TREE`` is another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Each tree runs in a process of its own, in the order
other, this, this, other, so that a drift of the card or its host over the
call falls on both. A process builds its tree's kernels, colors
kron_g500-logn21_s at scale 32 (ell-tail, ``ell_cap=128``) and
europe_osm_s at scale 127 with ipgc two-phase and jpl in the host loop
(one untimed run, then ``--runs`` timed ones: ``ColoringResult``'s
seconds and the peak device memory of each), and kron through the
distributed Pipe at four shards on the card with jpl for ``DIST_ROUNDS``
rounds (seconds a round). The graphs are built once and kept in
``build/compare_trees/`` for the other processes. Every run of a tree must
give the iterations and colors of the other tree's runs. Prints one JSON
line a process, then the card's name and power limit and a summary line.
Needs a CUDA device; imports nothing of JAX.
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


def child(tree: str, runs: int) -> dict:
    """One tree's runs (in this process, with ``tree/src`` first on the
    path)."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--runs", type=int, default=3)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child, a.runs)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 2
    if not a.other:
        ap.error("give the other tree")
    other = os.path.abspath(a.other)
    results = []
    for tree in (other, ROOT, ROOT, other):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--runs", str(a.runs)],
            capture_output=True, text=True, check=True, timeout=1800)
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["process_seconds"] = time.perf_counter() - t0
        results.append(res)
        print(json.dumps(res), flush=True)
    for key in results[0]["host"]:
        got = {(r["host"][key]["iterations"], r["host"][key]["n_colors"])
               for r in results}
        if len(got) != 1:
            raise AssertionError(f"{key}: the trees differ: {got}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)

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
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
