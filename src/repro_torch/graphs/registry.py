"""Dataset registry — the cached entry point over the staged pipeline
(DESIGN.md §8).

``get_dataset(name, scale=..., reorder=..., layout=...)`` unifies the
three historical ways a Graph came to exist — ``SUITE_SPECS`` synthetic
generators, ``load_mtx`` file loads, and ad-hoc benchmark construction —
behind one function with one cache, so benchmarks, tests and examples
stop re-deriving build parameters and re-paying build cost.

Name resolution order:

  1. registered builders (``register_dataset``; the Table-I suite is
     pre-registered at import)
  2. ``mtx:<path>`` — MatrixMarket file
  3. ``snap:<path>`` — SNAP-style edge list

Every lookup is keyed on the full build tuple (name, scale, seed,
reorder, layout, ell_cap), so two callers asking for the same cell share
one Graph object (graphs are frozen — sharing is safe).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.graphs import ingest
from repro_torch.graphs import layout as layout_mod
from repro_torch.graphs.csr import Graph
from repro_torch.graphs.ingest import EdgeList

# name -> builder(scale, seed) -> EdgeList (raw, pre-normalization)
_BUILDERS: dict[str, Callable[[float, int], EdgeList]] = {}
_CACHE: dict[tuple, Graph] = {}


def register_dataset(name: str,
                     builder: Callable[[float, int], EdgeList]) -> None:
    """Register (or replace) an ad-hoc dataset builder.

    ``builder(scale, seed)`` must return a raw ``ingest.EdgeList``; the
    pipeline normalizes, reorders and lays it out per ``get_dataset``'s
    arguments.
    """
    _BUILDERS[name] = builder


def dataset_names() -> list[str]:
    return sorted(_BUILDERS)


def clear_dataset_cache() -> None:
    _CACHE.clear()


def _resolve(name: str, scale: float, seed: int) -> EdgeList:
    if name in _BUILDERS:
        return _BUILDERS[name](scale, seed)
    if name.startswith(("mtx:", "snap:")):
        if scale != 1.0:
            # fail loudly rather than silently return the full-size
            # graph under a scaled cache key (seed still feeds reorder)
            raise ValueError(
                f"{name!r} is a fixed file-backed dataset; scale={scale} "
                "cannot be applied (only generator datasets scale)")
        if name.startswith("mtx:"):
            return ingest.from_mtx(name[4:])
        return ingest.from_snap(name[5:])
    raise ValueError(
        f"unknown dataset {name!r}; registered: {dataset_names()} "
        "(or use an 'mtx:<path>' / 'snap:<path>' name)")


def get_dataset(
    name: str,
    *,
    scale: float = 1.0,
    seed: int = 0,
    reorder: str = "identity",
    layout: "str | layout_mod.LayoutPlan" = "auto",
    ell_cap: int | None = None,
) -> Graph:
    """Build (or fetch from cache) a Graph through the full pipeline:
    ingest -> normalize -> reorder -> plan -> assemble.

    ``layout="auto"`` picks the plan from the degree histogram
    (``layout.plan_layout``); pass ``"ell-tail"`` with
    ``ell_cap=128`` for the historical builder behaviour, or an explicit
    ``LayoutPlan`` to pin everything.
    """
    key = (name, float(scale), int(seed), reorder,
           layout if isinstance(layout, (str, layout_mod.LayoutPlan))
           else repr(layout), ell_cap)
    if key in _CACHE:
        return _CACHE[key]
    g = layout_mod.run_pipeline(_resolve(name, scale, seed),
                                reorder=reorder, seed=seed, layout=layout,
                                ell_cap=ell_cap)
    _CACHE[key] = g
    return g


def _register_suite() -> None:
    """Pre-register the synthetic Table-I suite under its SUITE_SPECS
    names (the generators module stays the source of truth)."""
    from repro_torch.graphs.generators import SUITE_SPECS

    def make_builder(suite_name: str):
        return lambda scale, seed: ingest.from_generator(
            suite_name, scale=scale, seed=seed)

    for suite_name in SUITE_SPECS:
        register_dataset(suite_name, make_builder(suite_name))


_register_suite()
