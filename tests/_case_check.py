"""The step builders' cases at smoke size (``launch/steps.py``), shared by
the CPU parity tests (``tests/test_torch_steps_run*.py``, each case
against the reference's same function), ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``cases.card_vs_cpu`` (each case on the card against
the CPU). Imports torch and numpy only.

A smoke case is the arch's smoke config (``steps.smoke_arch``) at one of
``SHAPES``, small shapes of each kind, its arguments drawn on the CPU
from ``SEED``. ``CASES`` names each one run: every LM arch's train step
(Minitron-4B's two microbatches, Nemotron-4-340B's eight with bf16
optimizer state and gradient accumulation), prefill and decode (base and
the int8 cache; Minitron's other two variants), the four GNNs full-graph
and molecule, GraphSAGE's owner variant, the four GNNs sampled, DLRM's
three kinds and the coloring step at two ELL widths.

Card = CPU (``card_vs_cpu``), fp32 with TF32 off:

* LM train: ``tests/_train_check.py::step_gaps`` (loss, grad norm, every
  m, v and parameter leaf); with bf16 optimizer state (Nemotron's
  profile) m and v within ``BF16_STATE_TOL`` of the leaf's largest in
  place of its ``REL``;
* prefill and decode: logits and the cache's k and v within
  ``LM_CPU_TOL`` of their largest magnitude (at least 1); the int8 cache
  within ``LM_CPU_TOL_Q8`` and each int8 entry within one step;
* GNN and DLRM training: ``tests/_gnn_steps.py::card_cpu_gaps``;
  DLRM serving and retrieval within ``SERVE_TOL`` of the largest output
  (at least 1);
* the coloring step exactly: colors, base, and the worklist's mask,
  items and count.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.kernels.compact import compact_plain
from repro_torch.kernels.conflict import conflict_rows_plain
from repro_torch.kernels.mex_window import mex_window_rows_plain
from repro_torch.launch import steps
from repro_torch.models.attention import KVCache
from repro_torch.tree import tree_leaves

from _gnn_steps import card_cpu_gaps
from _train_check import REL, step_gaps

SEED = 0

SHAPES = {
    "train": ShapeSpec("train_smoke", "train",
                       dict(seq_len=8, global_batch=8)),
    "prefill": ShapeSpec("prefill_smoke", "prefill",
                         dict(seq_len=8, global_batch=2)),
    "decode": ShapeSpec("decode_smoke", "decode",
                        dict(seq_len=16, global_batch=2)),
    "gnn_full": ShapeSpec("full_smoke", "gnn_full",
                          dict(n_nodes=300, n_edges=900, d_feat=8)),
    "gnn_molecule": ShapeSpec("molecule_smoke", "gnn_molecule",
                              dict(n_nodes=256, n_edges=256, batch=4)),
    "gnn_minibatch": ShapeSpec("minibatch_smoke", "gnn_minibatch",
                               dict(n_nodes=500, n_edges=2000,
                                    batch_nodes=8, fanout=(3, 2),
                                    d_feat=8)),
    "rs_train": ShapeSpec("train_smoke", "rs_train", dict(batch=16)),
    "rs_serve": ShapeSpec("serve_smoke", "rs_serve", dict(batch=16)),
    "rs_retrieval": ShapeSpec("retrieval_smoke", "rs_retrieval",
                              dict(batch=1, n_candidates=3000)),
    "coloring_k8": ShapeSpec("coloring_k8", "coloring",
                             dict(n_nodes=4096, ell_width=8)),
    "coloring_k16": ShapeSpec("coloring_k16", "coloring",
                              dict(n_nodes=8192, ell_width=16)),
}

LM_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "nemotron-4-340b",
            "gemma-7b", "minitron-4b")
GNN_ARCHS = ("equiformer-v2", "egnn", "schnet", "graphsage-reddit")

#: (arch, shape key, variant) of every smoke case
CASES = (
    [(a, "train", "base") for a in LM_ARCHS]
    + [(a, "prefill", "base") for a in LM_ARCHS]
    + [(a, "decode", v) for a in ("qwen3-moe-30b-a3b", "minitron-4b")
       for v in ("base", "opt_int8")]
    + [("minitron-4b", "decode", v) for v in ("opt", "opt_int8_half")]
    + [(a, k, "base") for a in GNN_ARCHS
       for k in ("gnn_full", "gnn_molecule", "gnn_minibatch")]
    + [("graphsage-reddit", "gnn_full", "owner")]
    + [("dlrm-rm2", k, "base") for k in ("rs_train", "rs_serve",
                                         "rs_retrieval")]
    + [("paper-ipgc", k, "base") for k in ("coloring_k8", "coloring_k16")])


def case_id(spec: tuple) -> str:
    return "-".join(spec)


#: card = CPU, fp32 with TF32 off (see the module's docstring)
LM_CPU_TOL = 1e-4
LM_CPU_TOL_Q8 = 2e-3
SERVE_TOL = 1e-5
#: bf16 m and v (Nemotron's profile): gradients a few fp32 ulps apart
#: can round a bf16 partial sum of the eight microbatches, and then the
#: stored m or v, to the neighbouring bf16 value; one bf16 step is at
#: most 2**-7 of an entry, so two of them at the leaf's largest
BF16_STATE_TOL = 2.0 ** -6


def smoke_case(spec: tuple, device="cpu", seed: int = SEED,
               **kw) -> steps.Case:
    """The smoke case ``spec`` = (arch, shape key, variant), arguments
    drawn on ``device``; ``kw`` (``keep_grads``) goes to the GNN and
    DLRM cases."""
    arch_id, key, variant = spec
    arch = steps.smoke_arch(arch_id)
    if arch.family not in ("gnn", "recsys"):
        kw = {}
    return steps.case_for(arch, SHAPES[key], None, variant=variant,
                          device=device, seed=seed, **kw)


def to_device(tree, dev):
    """A copy of a case's arguments (or outputs) on ``dev``: tensors
    copied, NumPy arrays and statics kept, containers rebuilt."""
    if tree is None or isinstance(tree, (int, float, str, np.ndarray)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev, copy=True)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, dev) for v in tree))
    return type(tree)(to_device(v, dev) for v in tree)


def _rel(a: torch.Tensor, b: torch.Tensor, floor: float = 1.0) -> float:
    a, b = a.detach().cpu().float(), b.detach().cpu().float()
    return float((a - b).abs().max()
                 / max(floor, float(b.abs().max()), 1e-30))


def _serving_gaps(card, cpu, int8: bool) -> dict:
    """Logits and cache of a prefill or decode step."""
    (cl, cc), (wl, wc) = card, cpu
    tol = LM_CPU_TOL_Q8 if int8 else LM_CPU_TOL
    gaps = {"logits": _rel(cl, wl)}
    if not torch.equal(cc.length.cpu(), wc.length):
        raise AssertionError("the cache lengths differ")
    for name in ("k", "v"):
        a, b = getattr(cc, name).cpu(), getattr(wc, name)
        if int8:
            gaps[name] = int((a.int() - b.int()).abs().max())
            if gaps[name] > 1:
                raise AssertionError(f"int8 cache {name}: {gaps[name]}")
            sa, sb = getattr(cc, name + "_scale"), getattr(wc, name + "_scale")
            gaps[name + "_scale"] = _rel(sa, sb, 0.0)
            if not gaps[name + "_scale"] <= LM_CPU_TOL:
                raise AssertionError(f"{name}_scale: {gaps[name + '_scale']}")
        else:
            gaps[name] = _rel(a, b)
            if not gaps[name] <= tol:
                raise AssertionError(f"cache {name}: {gaps[name]}")
    if not gaps["logits"] <= tol:
        raise AssertionError(f"logits: {gaps['logits']}")
    return gaps


def coloring_equal(a: tuple, b: tuple) -> bool:
    """Two coloring steps' (colors, base, worklist) bit for bit."""
    (c1, b1, w1), (c2, b2, w2) = a, b
    pairs = ((c1, c2), (b1, b2), (w1.mask, w2.mask), (w1.items, w2.items),
             (w1.count, w2.count))
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for x, y in pairs)


def compare(case: steps.Case, card, cpu) -> dict:
    """``card`` against ``cpu``, two outputs of ``case.fn``, by the case's
    kind; the gaps, or AssertionError past a tolerance."""
    kind = case.meta["kind"]
    if kind == "train":
        bf16 = tree_leaves(cpu[1].m)[0].dtype == torch.bfloat16
        return step_gaps(card, cpu, wd=0.1,
                         state_rel=BF16_STATE_TOL if bf16 else REL)
    if kind in ("prefill", "decode"):
        return _serving_gaps(card, cpu, isinstance(cpu[1], KVCache)
                             and cpu[1].quantized)
    if kind in ("gnn_train", "gnn_minibatch", "rs_train"):
        return card_cpu_gaps(card, cpu)
    if kind in ("rs_serve", "rs_retrieval"):
        gap = _rel(card, cpu)
        if not gap <= SERVE_TOL:
            raise AssertionError(f"{kind}: {gap}")
        return {"out": gap}
    if not coloring_equal(card, cpu):
        raise AssertionError("the coloring step differs")
    return {"equal": True}


def card_vs_cpu(spec: tuple, dev) -> dict:
    """The smoke case ``spec`` drawn on the CPU, one step on ``dev`` from
    a copy of its arguments and one on the CPU; ``compare`` of the two.
    Run it with TF32 off."""
    case = smoke_case(spec, "cpu", keep_grads=True)
    card = case.fn(*to_device(case.args, dev))
    cpu = case.fn(*case.args)
    return compare(case, card, cpu)


@contextlib.contextmanager
def plain_kernels():
    """Inside the block ``ops.mex_window``, ``ops.conflict`` and
    ``ops.compact`` (the coloring step's kernels) run their plain twins
    on any device: the same step without the hand-written kernels."""
    def mex(*args, tile_rows=None):
        return mex_window_rows_plain(*args)

    def conflict(*args, tile_rows=None):
        return conflict_rows_plain(*args)

    def compact(mask, capacity=None, sentinel=None, values=None):
        n = mask.shape[0]
        return compact_plain(mask, n if capacity is None else capacity,
                             n if sentinel is None else sentinel, values)

    saved = {name: getattr(ops, name)
             for name in ("mex_window", "conflict", "compact")}
    ops.mex_window, ops.conflict, ops.compact = mex, conflict, compact
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
