"""The control of a cell: the program with a guarantee of its configuration
switched off, judged by the comparison that decides ``correct``.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> ...

Each seed makes one run of the cell as ``run.py`` does, with ``fused``
set in the traffic's spec: the program's own one-pass step family (resolve
of the last round and assign of this one on one gather) in place of the
two-phase iterations that the configurations state, the step that saves a
gather an iteration, and whose colors differ. It prints each seed's
compared numbers; a sound control reads ``correct`` false on every
seed. The benchmark's own runs never run it.
"""
import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


#: the traffic spec's change that makes the control
CONTROL = {"fused": True}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for var in ("REPRO_OUTLINE_HYBRID", "REPRO_TUNE_CACHE"):
        os.environ.pop(var, None)
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from bench import catalog, harness

    cell = catalog.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("bench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, False,
                               device="cuda", t_start=time.perf_counter(),
                               spec_overrides=CONTROL)
        harness.note("control", workload=cell.name, seed=seed, spec=CONTROL,
                     correct=out["correct"], attempted=out["attempted"],
                     checks=out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
