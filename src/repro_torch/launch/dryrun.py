"""The multi-card dry run (``repro/launch/dryrun.py``).

For every (arch x shape) cell, on one card or on a production H100 mesh
(``launch.mesh.make_production_mesh``), the step of ``steps.build_case``
runs once under ``launch.opcost.OpCost`` and its per-device counts are
written to ``<outdir>/<arch>__<shape>__<mesh>[__<variant>].json``: the
argument bytes each device holds, peak live bytes, FLOPs, bytes moved and
collective bytes by kind and axis. ``launch/roofline.py`` turns them into
the least time the step takes on the card.

The reference compiles each cell for a 256- or 512-chip TPU pod and reads
XLA's memory and cost analyses; here the step runs on the ``meta``
device, where nothing is allocated, with rules that keep that run short
and its counts those of the full cell:

* The depth rule (the reference's loop correction, ``hlocost.py``): the
  layer stack of a config that declares it repeats (``repeated_layers``:
  the LMs and EquiformerV2) is counted at 1 and 2 layers, every other
  part whole, and each count extended linearly to the config's depth
  (``opcost.extrapolate``).
* The shard rule: every data shard of a mesh form runs the same shapes,
  so a batch axis of more than two entries is counted with two, each
  holding the rows one shard of the full mesh holds (an LM step's batch,
  the edges and edge chunk of a config with edge shards). Each entry's FLOPs, bytes and
  collectives are then the full mesh's; its temporaries are, but for the
  one controller's serial sums of gradients over shards (which a
  multi-process run makes in its all-reduce), and its arguments are the
  full mesh's (``arg_shard_bytes``). A cell the rule cannot cut keeps its
  mesh.
* The chunk rule: a full-graph step's loop over the edge chunks of a
  config with an ``edge_chunk`` (EquiformerV2; the reference's scan,
  whose trip count ``hlocost.py`` multiplies) is counted at 1 and 2
  chunks and extended the same way.
* Values: a step whose shapes depend on its values runs on real
  arguments drawn on the card from seed 0 (``counted_on: "cuda"``): the
  paper-ipgc cells, whose kernels take no ``meta`` tensor. Their step is
  unsharded and fits one card, so the one-card count is each device's.
  Without a card such a cell is written ``ok: false`` with that reason.

A cell a mesh cannot split (a batch that its data shards do not divide)
is written ``ok: false`` with the error, as the reference's failed cells
are. No error is caught silently, and an out-of-memory error on the card
is never caught.

The LM and EquiformerV2 steps have mesh forms (``mesh_form: true``); the
other GNNs, DLRM and the coloring step run unsharded on any mesh, so
their per-device counts are the whole step's, while ``arg_shard_bytes``
divides their inputs as the reference's shardings lay them out.

Usage::

    python -m repro_torch.launch.dryrun --all --mesh single
    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    python -m repro_torch.launch.dryrun --paper --mesh card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.launch import opcost, steps
from repro_torch.launch.mesh import (EXPERT_FF_AXIS, ExpertShards, make_mesh,
                                     make_production_mesh, split_batch)
from repro_torch.models.transformer import MeshKVCache

OUTDIR = "build/repro_torch/dryrun"
#: the mesh names of the records
MESHES = {"card": None, "single": "h100_32x8", "multi": "h100_2x32x8"}
#: the layer counts the depth rule counts at
DEPTHS = (1, 2)
#: the entries the shard rule keeps on a batch axis
SHARD_KEEP = 2
#: the LM steps' kinds, whose batch splits over the batch axes
LM_KINDS = ("train", "prefill", "decode")
#: the arguments each kind splits over its batch axes (by position), as
#: the reference's ``in_shardings`` lay them out
_BATCH_ARGS = {
    "train": (2,), "prefill": (1,), "decode": (2,),
    "gnn_train": (2, 3, 4, 5, 6), "gnn_minibatch": (2, 3, 4, 6),
    "rs_train": (2, 3, 4), "rs_serve": (1, 2), "rs_retrieval": (),
    "coloring": (),
}
#: the coloring step's fields split over the batch axes
_COLORING_SPLIT = {"[0].ell_idx", "[0].degrees", "[0].hub_slot", "[2]",
                   "[3].mask", "[3].items"}


def mesh_of(mesh_name: str):
    """The ``meta`` mesh of ``"single"``/``"multi"``, None for ``"card"``."""
    if mesh_name == "card":
        return None
    return make_production_mesh(multi_pod=mesh_name == "multi")


def _leaf_bytes(x) -> int:
    return x.nbytes if not isinstance(x, torch.Tensor) \
        else x.numel() * x.element_size()


def _param_shard_bytes(tree, n_experts_split: int) -> int:
    """A parameter tree's (or its optimizer moments') bytes on one device:
    the expert weights split ``n_experts_split`` ways, the rest whole."""
    total = 0
    for k, v in tree.items():
        if isinstance(v, dict):
            total += _param_shard_bytes(v, n_experts_split)
        elif isinstance(v, ExpertShards):
            total += _leaf_bytes(v.pieces[0][0])
        elif isinstance(v, torch.Tensor):
            div = n_experts_split if k in EXPERT_FF_AXIS else 1
            total += _leaf_bytes(v) // div
    return total


def arg_shard_bytes(case: steps.Case) -> int:
    """The bytes of ``case``'s arguments on one device of its mesh (the
    reference's ``_arg_shard_bytes``): the batch inputs divided over the
    batch axes, the expert weights and their optimizer moments over the
    model and FSDP axes as ``launch.mesh.place_params`` lays them out, a
    ``MeshKVCache`` one data shard's, everything else whole."""
    mesh = case.mesh
    if mesh is None:
        return steps.arg_bytes(case)
    kind = case.meta["kind"]
    n_batch = mesh.axis_size(case.axes.get("batch_axes", ()))
    n_exp = mesh.shape.get("model", 1) * mesh.axis_size(
        case.axes.get("fsdp_axes", ()))
    total = 0
    for i, a in enumerate(case.args):
        if isinstance(a, dict) and i == 0 and kind != "coloring":
            total += _param_shard_bytes(a, n_exp)
        elif i == 1 and kind in ("train", "gnn_train", "gnn_minibatch",
                                 "rs_train"):
            total += _leaf_bytes(a.step) + 2 * _param_shard_bytes(a.m, n_exp)
        elif isinstance(a, MeshKVCache):
            total += max(sum(_leaf_bytes(t) for _, t in
                             steps.flatten_args(c)) for c in a.shards)
        elif kind == "rs_retrieval" and i == 3:
            total += _leaf_bytes(a) // mesh.axis_size(mesh.axis_names)
        else:
            split = i in _BATCH_ARGS[kind]
            for path, t in steps.flatten_args(a, (f"[{i}]",)):
                if kind == "coloring":
                    split = "".join(path) in _COLORING_SPLIT
                total += _leaf_bytes(t) // (n_batch if split else 1)
    return total


def _expert_split(case: steps.Case) -> dict:
    """``opcost.add_grad_sync``'s ``split``: the expert weights over the
    model and FSDP axes."""
    over = ("model",) + tuple(case.axes.get("fsdp_axes", ()))
    return {name: over for name in EXPERT_FF_AXIS}


def _at_depth(arch, depth: int):
    cfg = dataclasses.replace(arch.make_config(), n_layers=depth)
    return dataclasses.replace(arch, make_config=lambda: cfg)


def _check_split(full: steps.Case, shape: ShapeSpec) -> None:
    """Raise as the full mesh's step would where its data shards do not
    divide the batch (``launch.mesh.split_batch``)."""
    axes = full.axes.get("batch_axes", ())
    if full.mesh is None or not axes or full.meta["kind"] not in LM_KINDS:
        return
    b = shape.params["global_batch"]
    if full.meta["kind"] == "train":
        b //= steps._MICROBATCHES.get(full.arch_id, 1)
    split_batch(torch.empty((b,), device="meta"), full.mesh.axis_size(axes))


def shard_cut(arch, shape: ShapeSpec, full: steps.Case):
    """(arch, shape, mesh, keep) of the shard rule: the mesh with
    ``SHARD_KEEP`` entries on each batch axis of more, the shape cut so
    that each shard holds what it holds on the full mesh; None where the
    rule does not apply (no mesh form, no axis to cut, or a cut that would
    change a shard's shapes)."""
    mesh = full.mesh
    axes = full.axes.get("batch_axes", ())
    if mesh is None or not axes or not any(mesh.shape[a] > SHARD_KEEP
                                           for a in axes):
        return None
    keep = {a: min(mesh.shape[a], SHARD_KEEP) if a in axes else mesh.shape[a]
            for a in mesh.axis_names}
    n_full = mesh.axis_size(axes)
    n_cut = 1
    for a in axes:
        n_cut *= keep[a]
    cut_mesh = make_mesh(tuple(keep.values()), mesh.axis_names, "meta")
    p = dict(shape.params)
    if full.meta["kind"] in LM_KINDS:
        p["global_batch"] = p["global_batch"] * n_cut // n_full
        return arch, ShapeSpec(shape.name, shape.kind, p), cut_mesh, keep
    if full.axes.get("edge_shard_axes") and shape.kind == "gnn_full":
        # each chunk's part and the chunk count kept: the edges and the
        # chunk cut together, both still whole multiples of 1,024
        cfg = arch.make_config()
        e = full.args[3].shape[0]
        chunk = min(cfg.edge_chunk, steps.EDGE_CHUNK_MAX)
        if e % n_full or chunk * n_cut % n_full or \
                e * n_cut // n_full % 1024 or chunk * n_cut // n_full % 1024:
            return None
        p["n_edges"] = e * n_cut // n_full
        cut_cfg = dataclasses.replace(cfg, edge_chunk=chunk * n_cut // n_full)
        cut_arch = dataclasses.replace(arch, make_config=lambda: cut_cfg)
        return cut_arch, ShapeSpec(shape.name, shape.kind, p), cut_mesh, keep
    return None


def count_case(case: steps.Case) -> dict:
    """One run of ``case.fn`` under ``OpCost`` on its mesh, starting from
    its per-device argument bytes; the training kinds add the gradient
    sums (``add_grad_sync``)."""
    train = case.meta["kind"] in ("train", "gnn_train", "gnn_minibatch",
                                  "rs_train")
    out, counts = opcost.count(
        case.fn, case.args, mesh=case.mesh, arg_bytes=arg_shard_bytes(case),
        params=case.args[0] if train and case.mesh is not None else None,
        split=_expert_split(case))
    del out
    return counts


def count_cell(arch_id: str, shape_name: str, mesh=None,
               variant: str = "base") -> tuple[dict, steps.Case]:
    """``count_spec`` of a registry cell at its published config."""
    arch = get_arch(arch_id)
    return count_spec(arch, arch.shapes[shape_name], mesh, variant)


def count_spec(arch, shape: ShapeSpec, mesh=None, variant: str = "base"
               ) -> tuple[dict, steps.Case]:
    """(the per-device counts of ``arch`` at ``shape`` on ``mesh``, the
    abstract full case) with the depth, shard and value rules; the counts
    carry ``depths_counted``, ``counted_on`` and ``counted_mesh``."""
    full = steps.case_for(arch, shape, mesh, variant=variant, abstract=True)
    if arch.family == "paper":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "needs values: the coloring step's kernels take no meta "
                "tensor and count on real arguments on the card, and "
                "torch.cuda.is_available() is False")
        real = steps.case_for(arch, shape, None, variant=variant,
                              device="cuda")
        counts = count_case(real)
        del real
        counts.update(depths_counted=None, chunks_counted=None,
                      counted_on="cuda", counted_mesh=None)
        return counts, full
    _check_split(full, shape)
    cut = shard_cut(arch, shape, full)
    c_arch, c_shape, c_mesh = (arch, shape, mesh) if cut is None \
        else cut[:3]
    cfg = arch.make_config()
    depth = cfg.n_layers if getattr(cfg, "repeated_layers", False) else 0
    depths = DEPTHS if depth > DEPTHS[-1] else (None,)
    chunk, n_chunks = _chunks(c_arch, c_shape, c_mesh, variant)
    chunks = DEPTHS if n_chunks > DEPTHS[-1] else (None,)
    grid = []
    for d in depths:
        a = c_arch if d is None else _at_depth(c_arch, d)
        row = []
        for k in chunks:
            sh = c_shape if k is None else ShapeSpec(
                c_shape.name, c_shape.kind,
                dict(c_shape.params, n_edges=k * chunk))
            case = steps.case_for(a, sh, c_mesh, variant=variant,
                                  abstract=True)
            row.append(count_case(case))
            del case
        grid.append(row[0] if k is None else opcost.extrapolate(
            row[0], row[1], chunks[0], chunks[1], n_chunks))
    counts = grid[0] if d is None else opcost.extrapolate(
        grid[0], grid[1], depths[0], depths[1], depth)
    # peak: the counted step's temporaries over the full cell's arguments
    temp = counts["peak_bytes"] - counts["arg_bytes"]
    counts["arg_bytes"] = arg_shard_bytes(full)
    counts["peak_bytes"] = counts["arg_bytes"] + temp
    counts.update(depths_counted=None if d is None else list(depths),
                  chunks_counted=None if k is None else list(chunks),
                  counted_on="meta",
                  counted_mesh=None if cut is None else cut[3])
    return counts, full


def _chunks(arch, shape: ShapeSpec, mesh, variant: str) -> tuple[int, int]:
    """(edge chunk, chunks) of a full-graph case whose config has an
    ``edge_chunk`` that is a whole number of the case's 1,024-edge
    padding, the loop the chunk rule counts at 1 and 2 chunks; (0, 0) for
    any other case."""
    chunk = getattr(arch.make_config(), "edge_chunk", 0)
    if not chunk or shape.kind != "gnn_full":
        return 0, 0
    chunk = min(chunk, steps.EDGE_CHUNK_MAX)
    if chunk % 1024:
        return 0, 0
    case = steps.case_for(arch, shape, mesh, variant=variant, abstract=True)
    return chunk, case.args[3].shape[0] // chunk


def _mesh_form(case: steps.Case) -> bool:
    return case.mesh is not None and (case.meta["kind"] in LM_KINDS or bool(
        case.axes.get("edge_shard_axes")))


def run_cell(arch_id: str, shape_name: str, mesh_name: str, outdir: str,
             variant: str = "base") -> dict:
    """Count one cell on ``mesh_name`` (``"card"``, ``"single"``,
    ``"multi"``) and write its record; returns the record."""
    t0 = time.perf_counter()
    name = MESHES[mesh_name]
    n_dev = {"card": 1, "single": 256, "multi": 512}[mesh_name]
    rec = {"arch": arch_id, "shape": shape_name, "mesh": name or "card",
           "variant": variant, "n_devices": n_dev, "ok": False}
    try:
        counts, full = count_cell(arch_id, shape_name, mesh_of(mesh_name),
                                  variant)
        coll = counts["collectives"]
        rec.update(
            meta=full.meta, mesh_form=_mesh_form(full),
            memory={"argument_bytes": counts["arg_bytes"],
                    "peak_bytes": counts["peak_bytes"],
                    "temp_bytes": counts["peak_bytes"] - counts["arg_bytes"]},
            arg_shard_bytes=arg_shard_bytes(full),
            cost={"flops": counts["flops"], "bytes": counts["bytes"],
                  "flops_by_dtype": counts["flops_by_dtype"]},
            collectives={**{k: v for k, v in coll.items()
                            if k != "total_bytes"},
                         "total_bytes": coll["total_bytes"]},
            kernels=counts["kernels"], n_ops=counts["n_ops"],
            depths_counted=counts["depths_counted"],
            chunks_counted=counts["chunks_counted"],
            counted_on=counts["counted_on"],
            counted_mesh=counts["counted_mesh"], ok=True)
    except torch.cuda.OutOfMemoryError:
        raise
    except Exception:
        rec["error"] = traceback.format_exc()[-2000:]
    rec["total_s"] = time.perf_counter() - t0
    os.makedirs(outdir, exist_ok=True)
    suffix = "" if variant == "base" else f"__{variant}"
    path = os.path.join(outdir,
                        f"{arch_id}__{shape_name}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK  " if rec["ok"] else "FAIL"
    print(f"[{status}] {arch_id:22s} {shape_name:14s} {rec['mesh']:12s} "
          f"{variant:14s} total={rec['total_s']:.2f}s", flush=True)
    return rec


def cell_variants(cells: list, variant: str) -> list:
    """(arch, shape, variant) of ``cells``: ``variant`` for each, or with
    ``"all"`` base for each and the other decode variants for the LM
    decode shapes too."""
    if variant != "all":
        return [(a, s, variant) for a, s in cells]
    return [(a, s, v) for a, s in cells
            for v in ("base",) + (steps.DECODE_VARIANTS if get_arch(a)
                                  .shapes[s].kind == "decode" else ())]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    help="single | multi | both | card, or several joined "
                    "by commas (card,single)")
    ap.add_argument("--all", action="store_true",
                    help="every registry cell (the 40 and paper-ipgc's 2)")
    ap.add_argument("--paper", action="store_true",
                    help="the paper-ipgc cells")
    ap.add_argument("--variant", default="base",
                    help="base | opt | opt_int8 | opt_int8_half, or all "
                    "(base, and each decode cell's other variants)")
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)

    meshes = []
    for m in args.mesh.split(","):
        if m not in ("single", "multi", "both", "card"):
            ap.error(f"unknown mesh {m!r}")
        meshes += ["single", "multi"] if m == "both" else [m]
    if args.paper:
        cells = [("paper-ipgc", s) for s in get_arch("paper-ipgc").shapes]
    elif args.all:
        cells = steps.registry_cells()
    else:
        archs = [args.arch] if args.arch else \
            list(dict.fromkeys(a for a, _ in steps.registry_cells()))
        cells = [(a, s) for a in archs
                 for s in ([args.shape] if args.shape
                           else get_arch(a).shapes)]
    t0 = time.perf_counter()
    n = n_fail = 0
    for m in meshes:
        for a, s, v in cell_variants(cells, args.variant):
            n += 1
            n_fail += 0 if run_cell(a, s, m, args.outdir, v)["ok"] else 1
    print(f"\ndone: {n - n_fail} ok, {n_fail} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
