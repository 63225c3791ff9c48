"""Layout planning + array assembly — stage 3 of the graph pipeline
(DESIGN.md §8).

The paper's performance story rests on an ELL+COO-tail structure that
keeps dense sweeps tile-friendly while hubs spill to a tail; this module
makes that structure a *plan*, chosen per-graph from the degree
histogram, instead of a hard-coded builder constant (the old fixed
``ell_cap=128``).

A ``LayoutPlan`` is a frozen (hashable) dataclass — it rides through jit
static arguments and cache keys the same way ``Algorithm`` instances do
(DESIGN.md §7). Kinds and the contract kernels may assume per kind:

  pure-ell     ELL width == max degree: NO tail entries exist; the hub
               side-channel is compiled out (``n_hub == 0``).
  ell-tail     the historical layout: per-row first-K neighbours in ELL,
               overflow in the COO tail; rows with degree > K are hubs.
  hub-split    rows with degree > ``hub_threshold`` keep NOTHING in ELL —
               all their entries live in the tail — so K can track the
               typical row tightly instead of the cap; ELL rows of hubs
               are all-padding.
  csr-segment  CSR (row_ptr/col_idx) is the execution layout: steps run
               edge-wise segment ops over all E entries
               (``kernels/csr_segment.py``) and ignore ELL/tail. The ELL
               and tail arrays are STILL assembled (ell-tail rule) so
               ELL-only consumers (JPL rounds, BFS, samplers) remain
               correct on the same Graph.

``plan_layout(degrees, layout="auto")`` picks the kind and the ELL width
from the histogram; every width is a multiple of 8 (tile alignment).
The explicit ``layout="ell-tail"`` + default cap path reproduces the
historical builder bit-identically — the regression guard of the staged
pipeline (tests/test_pipeline.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.ingest import EdgeList

LAYOUT_KINDS = ("pure-ell", "ell-tail", "csr-segment", "hub-split")

#: the historical ELL width cap
DEFAULT_ELL_CAP = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """Static per-graph layout decision (see module docstring).

    ``ell_width``      K — the ELL tile width (multiple of 8, >= 8).
    ``hub_threshold``  rows with degree > this spill to the COO tail;
                       == ell_width for pure-ell/ell-tail/csr-segment
                       (spill = overflow only), and for hub-split the
                       same bound but the WHOLE row spills.
    """

    kind: str = "ell-tail"
    ell_width: int = 8
    hub_threshold: int = 8

    def __post_init__(self):
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(f"unknown layout kind {self.kind!r}; "
                             f"valid: {LAYOUT_KINDS}")
        if self.ell_width < 8 or self.ell_width % 8:
            raise ValueError(f"ell_width must be a positive multiple of 8, "
                             f"got {self.ell_width}")


def _coverage_width(deg: np.ndarray, w_max: int, *,
                    coverage: float = 0.95) -> int:
    """Auto ELL width: the smallest multiple of 8 at which ELL rows hold
    >= ``coverage`` of all edge entries (``sum(min(deg, w)) / sum(deg)``),
    so the COO tail carries at most the remaining ~5%. Replaces the old
    fixed 128 cap: regular graphs get exactly their degree, heavy-tail
    graphs stop paying p99-width padding for every row."""
    total = int(deg.sum()) if deg.size else 0
    if total == 0:
        return 8
    ds = np.sort(deg.astype(np.int64))
    cs = np.concatenate([[0], np.cumsum(ds)])
    ws = np.arange(8, w_max + 8, 8, dtype=np.int64)
    idx = np.searchsorted(ds, ws, side="right")
    cov = cs[idx] + ws * (len(ds) - idx)    # sum(min(deg, w)) per candidate
    hit = np.nonzero(cov >= coverage * total)[0]
    return int(ws[hit[0]]) if hit.size else w_max


def plan_layout(degrees: np.ndarray, *, layout: str | LayoutPlan = "auto",
                ell_cap: int | None = None) -> LayoutPlan:
    """Choose a ``LayoutPlan`` from the degree histogram.

    ``layout`` is a kind name, ``"auto"``, or an explicit plan
    (passthrough). ``ell_cap`` bounds the ELL width; ``None`` means
    auto-select the width from the histogram (p99-degree coverage) for
    the auto kinds, and the historical ``DEFAULT_ELL_CAP`` for the
    explicit ``"ell-tail"`` request (bit-compat with the old builder).
    """
    if isinstance(layout, LayoutPlan):
        return layout
    deg = np.asarray(degrees)
    max_deg = int(deg.max()) if deg.size else 0
    w_max = max(_round_up(max(max_deg, 1), 8), 8)
    if deg.size:
        p50 = float(np.percentile(deg, 50))
        p90 = float(np.percentile(deg, 90))
    else:
        p50 = p90 = 0.0
    # the "typical row" width (covers 90% of rows fully) and the entry
    # coverage the ELL achieves at that width
    w90 = min(max(_round_up(max(int(p90), 1), 8), 8), w_max)
    total = int(deg.sum()) if deg.size else 0
    cov90 = (int(np.minimum(deg, w90).sum()) / total) if total else 1.0
    w_auto = _coverage_width(deg, w_max)

    if layout == "auto":
        cap_ok = ell_cap is None or _round_up(ell_cap, 8) >= w_max
        if w_max <= max(2 * w90, 16) and w_max <= 512 and cap_ok:
            # near-regular histogram: pay max-degree width, drop the tail
            # (only when the caller's ell_cap permits the full width —
            # a capped near-regular graph falls through to ell-tail)
            layout = "pure-ell"
        elif p50 <= 4 and max_deg > 16 * max(p50, 1.0):
            # low-degree skewed rows (road/circuit/BA-sparse families):
            # any ELL width is mostly padding — run edge-wise over CSR
            layout = "csr-segment"
        elif cov90 < 0.75:
            # hubs hold >25% of all entries even at the typical-row
            # width: keep K tight and split hub rows out whole
            layout = "hub-split"
        else:
            layout = "ell-tail"

    if layout == "pure-ell":
        width = w_max if ell_cap is None else min(w_max, _round_up(ell_cap, 8))
        if width < w_max:
            raise ValueError(
                f"pure-ell needs ell_width >= max degree ({max_deg}); "
                f"ell_cap={ell_cap} is too small")
        return LayoutPlan(kind="pure-ell", ell_width=width,
                          hub_threshold=width)
    if layout == "ell-tail":
        # explicit cap: the historical builder rule (bit-compat with
        # ell_cap=128); no cap: auto coverage width (the new default)
        cap = w_auto if ell_cap is None else max(_round_up(ell_cap, 8), 8)
        width = min(w_max, cap)
        return LayoutPlan(kind="ell-tail", ell_width=width,
                          hub_threshold=width)
    if layout in ("csr-segment", "hub-split"):
        # K tracks the typical row: hub-split rows above it ride the
        # tail whole; csr-segment runs edge-wise and keeps ELL/tail only
        # as the side-structure for ELL-only consumers
        cap = ell_cap if ell_cap is not None else w90
        width = min(w_max, max(_round_up(cap, 8), 8))
        return LayoutPlan(kind=layout, ell_width=width,
                          hub_threshold=width)
    raise ValueError(f"unknown layout {layout!r}; valid: "
                     f"{LAYOUT_KINDS + ('auto',)}")


def run_pipeline(edges: EdgeList, *, symmetrize: bool = True,
                 reorder: str = "identity", seed: int = 0,
                 layout: "str | LayoutPlan" = "ell-tail",
                 ell_cap: int | None = None):
    """The full staged pipeline over a raw edge list: normalize ->
    reorder (re-sorting relabeled edges, which breaks the (src, dst)
    order ``assemble`` requires) -> plan -> assemble. The ONE place the
    stage ordering lives — ``registry.get_dataset`` is a thin
    wrapper over it."""
    from repro_torch.graphs import ingest, transform

    edges = ingest.normalize(edges, symmetrize=symmetrize)
    edges, perm = transform.reorder(edges, reorder, seed=seed)
    if not perm.is_identity:
        order = np.lexsort((edges.dst, edges.src))
        edges = dataclasses.replace(edges, src=edges.src[order],
                                    dst=edges.dst[order])
    plan = plan_layout(edges.degrees(), layout=layout, ell_cap=ell_cap)
    return assemble(edges, plan, perm=perm)


def assemble(edges: EdgeList, plan: LayoutPlan, *, perm=None):
    """Assemble the CSR + ELL + COO-tail ``Graph`` for a normalized edge
    list under ``plan`` — stage 4 of the pipeline.

    ``edges`` must already be normalized (``ingest.normalize``): no self
    loops, no duplicates, sorted by (src, dst). ``perm`` is the
    ``transform.Permutation`` that produced this labeling (attached to
    the Graph so callers can map colors back to original ids).
    """
    from repro_torch.graphs.csr import Graph, GraphArrays, _splitmix32

    n_nodes = edges.n_nodes
    s, d = edges.src, edges.dst
    e = len(s)
    degrees = np.bincount(s, minlength=n_nodes).astype(np.int32)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int32)
    np.cumsum(degrees, out=row_ptr[1:])
    col_idx = d.astype(np.int32)

    width = plan.ell_width
    ell_idx = np.full((n_nodes, width), n_nodes, dtype=np.int32)
    within = np.arange(e, dtype=np.int64) - row_ptr[s].astype(np.int64)
    if plan.kind == "hub-split":
        # hub rows keep NOTHING in ELL — their whole row rides the tail
        hub_row = degrees.astype(np.int64) > plan.hub_threshold
        in_ell = (within < width) & ~hub_row[s]
    else:
        in_ell = within < width
    ell_idx[s[in_ell], within[in_ell]] = d[in_ell]
    t_src = s[~in_ell].astype(np.int32)
    t_dst = d[~in_ell].astype(np.int32)
    t = len(t_src)
    t_pad = max(_round_up(max(t, 1), 8), 8)
    tail_src = np.full(t_pad, n_nodes, dtype=np.int32)
    tail_dst = np.full(t_pad, n_nodes, dtype=np.int32)
    tail_src[:t] = t_src
    tail_dst[:t] = t_dst

    arrays = GraphArrays(
        n_nodes=n_nodes,
        n_edges=e,
        ell_width=width,
        row_ptr=row_ptr,
        col_idx=col_idx,
        degrees=degrees,
        ell_idx=ell_idx,
        tail_src=tail_src,
        tail_dst=tail_dst,
        priority=_splitmix32(np.arange(n_nodes, dtype=np.int64)),
    )
    return Graph(name=edges.name, n_nodes=n_nodes, n_edges=e // 2,
                 arrays=arrays, layout=plan, perm=perm)
