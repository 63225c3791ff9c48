"""Roofline from the dry run's records (``repro/launch/roofline.py``).

Per (arch x shape) on the production single mesh (256 NVIDIA H100 SXM5
80GB cards, ``launch/mesh.py``'s constants):

  compute term    = sum over types of FLOPs per device in that type
                    / the type's peak (``PEAK_FLOPS``)           [s]
  memory term     = bytes per device / HBM bandwidth              [s]
  collective term = model-axis bytes / NVLink bandwidth
                    + data- and pod-axis bytes / network bandwidth [s]

(``launch/dryrun.py``'s counts are each device's already.) Derived:

  bound            = the largest term
  step time lower  = max(terms)
  MODEL_FLOPS      = 6*N*D (train) / 2*N*D (serve), N = active params
  useful ratio     = MODEL_FLOPS / (FLOPs per device * devices); NaN for a
                     program with no matmul FLOPs (the coloring)
  roofline frac    = (MODEL_FLOPS / (devices * peak)) / max(terms), the
                     peak the counted FLOPs' mix of types runs at

A collective's bytes are priced by the axes it ran over (the record's
``by_axes``): at NVLink's rate when they all stay inside a node, at the
network's otherwise, the slower link it crosses.
"""
from __future__ import annotations

import glob
import json
import math
import os

from repro_torch.launch.mesh import HBM_BW, NET_BW, NVLINK_BW, \
    PEAK_FLOPS, PEAK_FLOPS_BF16

OUTDIR = "build/repro_torch/dryrun"
MESH = "h100_32x8"
#: the axes that stay inside one NVLink node
NVLINK_AXES = ("model",)


def load_records(outdir: str = OUTDIR, mesh: str = MESH) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(outdir, f"*__{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def compute_seconds(flops_by_dtype: dict) -> float:
    """The compute term: each type's FLOPs over its peak; a type the
    table lacks at float32's rate, the CUDA cores'."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
               for dt, f in flops_by_dtype.items())


def collective_seconds(coll: dict) -> float:
    """The collective term: the bytes of each kind's collectives over
    NVLink when all their axes stay inside a node, over the network
    otherwise."""
    t = 0.0
    for kind, v in coll.items():
        if kind == "total_bytes":
            continue
        for axes, nbytes in v["by_axes"].items():
            inside = all(a in NVLINK_AXES for a in axes.split(","))
            t += nbytes / (NVLINK_BW if inside else NET_BW)
    return t


def roofline_row(rec: dict) -> dict:
    if not rec.get("ok"):
        return {"arch": rec["arch"], "shape": rec["shape"], "ok": False,
                "error": rec.get("error", "")}
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes"]
    coll = rec.get("collectives", {})
    coll_dev = coll.get("total_bytes", 0.0)
    chips = rec.get("n_devices", 256)
    t_comp = compute_seconds(rec["cost"]["flops_by_dtype"])
    t_mem = bytes_dev / HBM_BW
    t_coll = collective_seconds(coll)
    t_bound = max(t_comp, t_mem, t_coll, 1e-12)
    bound = {t_comp: "compute", t_mem: "memory", t_coll: "collective"}[
        max(t_comp, t_mem, t_coll)]
    model_flops = rec.get("meta", {}).get("model_flops", 0)
    # matmul-free programs (the coloring engine's gathers and scatters)
    # have no FLOPs by this count: the 6ND 'useful' convention does not
    # apply
    useful = (model_flops / (flops_dev * chips)
              if flops_dev > 0 else float("nan"))
    peak = flops_dev / t_comp if t_comp > 0 else PEAK_FLOPS_BF16
    frac = (model_flops / (chips * peak)) / t_bound
    return {
        "arch": rec["arch"], "shape": rec["shape"], "ok": True,
        "kind": rec.get("meta", {}).get("kind", "?"), "chips": chips,
        "t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
        "bound": bound, "t_bound": t_bound, "model_flops": model_flops,
        "useful_ratio": useful, "roofline_frac": frac,
        "flops_dev": flops_dev, "bytes_dev": bytes_dev, "coll_dev": coll_dev,
    }


def rows(outdir: str = OUTDIR, mesh: str = MESH) -> list[dict]:
    return [roofline_row(rec) for rec in load_records(outdir, mesh)]


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.0f}us"


def markdown_table(outdir: str = OUTDIR, mesh: str = MESH) -> str:
    lines = [
        "| arch | shape | kind | compute | memory | collective | bound | "
        "useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows(outdir, mesh):
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | FAILED | | | | | "
                         "| |")
            continue
        useful = ("—" if math.isnan(r["useful_ratio"])
                  else f"{r['useful_ratio']:.2f}")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{_fmt_s(r['t_compute'])} | {_fmt_s(r['t_memory'])} | "
            f"{_fmt_s(r['t_collective'])} | **{r['bound']}** | "
            f"{useful} | {r['roofline_frac']:.3f} |")
    return "\n".join(lines)


def summary_lines(outdir: str = OUTDIR) -> list[str]:
    out = []
    for r in rows(outdir):
        if r.get("ok"):
            out.append(
                f"roofline/{r['arch']}/{r['shape']},"
                f"{r['t_bound'] * 1e6:.0f},"
                f"bound={r['bound']} frac={r['roofline_frac']:.3f}")
    if not out:
        raise FileNotFoundError("no dry-run records")
    return out


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description="the roofline table of the "
                                 "dry run's records")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--mesh", default=MESH)
    args = ap.parse_args(argv)
    print(f"\n## Roofline — {args.mesh} (NVIDIA H100 SXM5 80GB: "
          f"{PEAK_FLOPS_BF16 / 1e12:.1f} TFLOP/s bf16, "
          f"{PEAK_FLOPS['float32'] / 1e12:.1f} TFLOP/s float32, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM, {NVLINK_BW / 1e9:.0f} GB/s "
          f"NVLink, {NET_BW / 1e9:.0f} GB/s network)\n")
    print(markdown_table(args.outdir, args.mesh))


if __name__ == "__main__":
    main()
