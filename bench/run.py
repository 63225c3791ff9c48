"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the cards the cell asks for.
The cell, its configuration, traffic and metrics come from
``BENCHMARK.json`` and the files under ``bench/`` (``catalog.py``). The
last line of standard output is the result; the compared numbers and their
limits are the last lines of standard error. The run exits non-zero, with
no result, without a CUDA card (or with fewer than the cell asks for), and
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the program's default coloring path, whatever the caller's shell says:
    # the host regime, and the tile tuner's cache at its place in the
    # checkout's build folder
    for var in ("REPRO_OUTLINE_HYBRID", "REPRO_TUNE_CACHE"):
        os.environ.pop(var, None)
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench import catalog, harness

    cell = catalog.load_cell(args.workload, ROOT)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"bench: cell {cell.name} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"bench: modules of JAX or of the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
