"""The ``Algorithm`` protocol and registry (``repro/algos/base.py``).

The step contract the Pipe drives (shared with the IPGC steps):

    step(ig, colors, aux, wl, *, window, force_hub) -> (colors, aux, wl)

  * ``ig``     — the prepared device graph (``core.ipgc.IPGCGraph``).
  * ``colors`` — int32[N+1] color vector (slot N = PAD sentinel).
  * ``aux``    — algorithm-owned state threaded opaquely by the engine
                 (IPGC: int32[N] window bases).
  * ``wl``     — the dual-representation persistent ``Worklist``; every
                 step (dense AND sparse) re-emits both representations so
                 mode switches stay free — the paper's invariant.

Shard-safety declaration (DESIGN.md §7): an algorithm that sets
``shard_safe=True`` promises that its ``make_dist_steps`` returns steps
whose worklist state stays shard-local and whose only cross-shard value is
the color vector — the invariants the distributed Pipe
(``core/distributed.py``) is built on. The others declare
``shard_safe=False`` with a ``shard_unsafe_reason``, and the distributed
Pipe fails fast with it.

Registry: algorithms register under a unique name; ``get_algorithm``
accepts a name or an ``Algorithm`` instance (passthrough). Registered:
``ipgc``, ``jpl`` and ``spec-greedy``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ipgc
from repro_torch.core.worklist import full_worklist
from repro_torch.graphs.csr import Graph


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """Base protocol; concrete algorithms subclass and override."""

    name: str = "abstract"
    #: may this algorithm run in the distributed Pipe?
    shard_safe: bool = False
    #: raised by the distributed Pipe when it is asked for anyway
    shard_unsafe_reason: str = ""
    #: may this algorithm run lane-batched (``Session.run_batch``, the
    #: stream service)? ``True`` promises that ``lane_step`` on a
    #: flattened lane group equals the dense step on each lane, and that
    #: the dense step on any active set gives the sparse step's state (the
    #: dual-worklist invariant), so a dense-only lane equals the host loop
    #: (DESIGN.md §9)
    batch_safe: bool = False
    #: raised by the batched Pipe when it is asked for anyway
    batch_unsafe_reason: str = ""
    #: tie-break priority fed to ``prepare`` when the caller passes None
    default_priority: str = "hash"
    #: whether the steps read a mex color window; ``window="auto"``
    #: resolves to 128 for an algorithm that does not
    uses_window: bool = True

    def prepare(self, g: Graph, *, priority: "str | None" = None, plan=None,
                device=None) -> ipgc.IPGCGraph:
        return ipgc.prepare(g, priority=priority or self.default_priority,
                            plan=plan, device=device)

    def init_state(self, ig: ipgc.IPGCGraph):
        """(colors, aux, wl) initial engine state."""
        raise NotImplementedError

    def step_fns(self, fused: bool):
        """(dense, sparse) step pair for the host-loop Pipe."""
        raise NotImplementedError

    def lane_step(self, fused: bool):
        """The dense step of a lane group laid out as one block-diagonal
        graph (``exec/batch.py``: lane ``l``'s row ``r`` is row
        ``l * n_pad + r``; ``aux`` has ``n_pad`` or one entries per lane).
        The IPGC-family steps compare node ids only with ids of the same
        lane, which the lane offset keeps in order, so their dense step
        runs unchanged; an algorithm that reads ids by value overrides
        this (JPL)."""
        return self.step_fns(fused)[0]

    def resolve_fused(self, fused: "bool | None", *, default: bool) -> bool:
        """Map the caller's ``fused`` request (None = engine default) to
        the family this algorithm runs."""
        return default if fused is None else fused

    def make_dist_steps(self, ig: ipgc.IPGCGraph, mesh, *, window: int,
                        fused: bool, exchange: str = "dense", boundary=None,
                        thresh: "int | None" = None):
        """(dense, sparse) distributed steps over ``mesh`` (a tuple of
        devices, one per shard) on the prepared, partitioned graph ``ig``;
        only called when ``shard_safe``. ``exchange``/``boundary``/
        ``thresh`` select the cross-shard color publication (DESIGN.md
        §13): with ``exchange != "dense"`` the steps take per-shard color
        views and a ``bcap`` keyword and return an extra ``xstats``."""
        raise NotImplementedError(
            f"algorithm {self.name!r} is not shard-safe: "
            f"{self.shard_unsafe_reason or 'no distributed steps'}")

    def finalize(self, colors: np.ndarray) -> tuple[np.ndarray, int]:
        """(final colors, n_colors): the IPGC contract, max + 1."""
        n_colors = int(colors.max()) + 1 if colors.size else 0
        return colors, n_colors

    def check_invariants(self, result, g: "Graph | None" = None) -> None:
        """Result invariants beyond plain validity; raises AssertionError.
        Shared baseline: the persistent active set never grows between
        host observations."""
        counts = result.counts
        if any(b > a for a, b in zip(counts, counts[1:])):
            raise AssertionError(f"{self.name}: worklist grew: {counts}")


def _compact_palette(colors: np.ndarray) -> tuple[np.ndarray, int]:
    """Remap the used colors to a dense 0..k-1 palette (validity-preserving
    relabeling; uncolored slots, if any, stay negative) — the finalize of
    palette-gapped algorithms."""
    used = np.unique(colors[colors >= 0])
    out = colors.copy()
    if used.size:
        out[colors >= 0] = np.searchsorted(used, colors[colors >= 0])
    return out, int(used.size)


def init_ipgc_state(ig: ipgc.IPGCGraph):
    """The IPGC-family state triple: sentinel-slot colors, per-node window
    bases, full worklist."""
    n = ig.n_nodes
    return (ipgc.init_colors(n, ig.device),
            torch.zeros(n, dtype=torch.int32, device=ig.device),
            full_worklist(n, ig.device))


_REGISTRY: dict[str, Algorithm] = {}


def register(algo: Algorithm) -> Algorithm:
    if not algo.name or algo.name == "abstract":
        raise ValueError("algorithm must carry a concrete name")
    _REGISTRY[algo.name] = algo
    return algo


def algorithm_names() -> list[str]:
    return list(_REGISTRY)


def get_algorithm(algo: "str | Algorithm") -> Algorithm:
    if isinstance(algo, Algorithm):
        return algo
    try:
        return _REGISTRY[algo]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {algo!r}; registered: "
            f"{sorted(_REGISTRY)}") from None
