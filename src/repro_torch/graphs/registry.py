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


def heavy_tail_requests(
    count: int,
    *,
    seed: int = 0,
    names: tuple = ("europe_osm_s", "hollywood-2009_s",
                    "soc-LiveJournal1_s"),
    min_nodes: int = 1_500,
    max_nodes: int = 50_000,
    alpha: float = 1.6,
    rate: "float | None" = None,
    burstiness: float = 1.0,
) -> "list[tuple]":
    """A power-law request mix — the serving workload's size distribution
    (DESIGN.md §11): many small graphs, a few huge ones, which is exactly
    the shape where a barrier batch stalls on its slowest lane and a
    streaming scheduler wins.

    Sizes are drawn from a bounded Pareto on ``[min_nodes, max_nodes]``
    (tail exponent ``alpha``; smaller = heavier tail) and families
    round-robin through ``names`` via the same ``numpy`` generator, so
    the catalog is a pure function of the arguments — two calls with one
    seed produce identical request lists, and repeated (name, scale)
    cells deliberately collapse onto one cached Graph, like a real
    request stream repeating popular inputs. Every ``names`` entry must
    be a node-count-parameterized suite family (its SUITE_SPECS kwargs
    carry ``n``), so target sizes map to exact generator scales.

    ``rate`` turns the catalog into an OPEN-LOOP arrival trace
    (DESIGN.md §14): each entry becomes ``(name, overrides, arrival_s)``
    with arrival timestamps on the service's injectable clock scale
    (seconds, first arrival at 0). Inter-arrival gaps are gamma with
    mean ``1/rate``: ``burstiness=1`` is a Poisson process, > 1
    clusters arrivals into bursts, < 1 smooths toward a paced trace.
    The gap draws happen AFTER the size/family draws on the same
    generator, so for one seed the request mix is byte-identical with
    and without ``rate``.
    """
    import numpy as np

    from repro_torch.graphs.generators import SUITE_SPECS

    bases = {}
    for name in names:
        _, kwargs = SUITE_SPECS[name]
        if "n" not in kwargs:
            raise ValueError(
                f"heavy_tail_requests needs node-parameterized families; "
                f"{name!r} has no 'n' in SUITE_SPECS")
        bases[name] = kwargs["n"]
    if not 0 < min_nodes <= max_nodes:
        raise ValueError(f"need 0 < min_nodes <= max_nodes, got "
                         f"{min_nodes}..{max_nodes}")
    if rate is not None and rate <= 0:
        raise ValueError(f"rate must be positive (requests/second), "
                         f"got {rate}")
    if burstiness <= 0:
        raise ValueError(f"burstiness must be positive, got {burstiness}")
    rng = np.random.default_rng(seed)
    u = rng.random(count)
    ratio = (min_nodes / max_nodes) ** alpha
    sizes = min_nodes / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)
    picks = rng.integers(0, len(names), size=count)
    arrivals = None
    if rate is not None:
        # gamma inter-arrivals with mean 1/rate: shape 1/b^2 keeps the
        # squared coefficient of variation equal to burstiness^2
        shape = 1.0 / (burstiness * burstiness)
        gaps = rng.gamma(shape, burstiness * burstiness / rate,
                         size=count)
        gaps[0] = 0.0
        arrivals = np.cumsum(gaps)
    out = []
    for i, (n_target, pick) in enumerate(zip(sizes, picks)):
        name = names[int(pick)]
        # quantize the scale so near-equal draws share one cache cell
        scale = round(float(n_target) / bases[name], 4)
        entry = (name, {"scale": max(scale, 1e-4)})
        if arrivals is not None:
            entry += (float(arrivals[i]),)
        out.append(entry)
    return out


def get_dataset_batch(requests=None, *, heavy_tail=None,
                      **common) -> "list[Graph]":
    """Build a list of graphs for batched execution (DESIGN.md §9).

    ``requests`` is an iterable of dataset names or ``(name, overrides)``
    pairs; ``common`` supplies shared ``get_dataset`` keyword arguments
    that per-request overrides win over. Every graph comes out of the
    same pipeline cache, so a serving batch that repeats a (name, scale,
    seed, ...) cell shares one Graph object — which is exactly what lets
    ``Session.run_batch`` reuse its padded-lane cache entries::

        graphs = get_dataset_batch(
            ["europe_osm_s", ("kron_g500-logn21_s", {"seed": 3})],
            scale=0.02)

    ``heavy_tail=`` generates the requests instead (mutually exclusive):
    an int is a request count, a dict passes ``heavy_tail_requests``
    knobs, and the mix inherits ``common``'s ``seed`` unless the dict
    pins its own::

        graphs = get_dataset_batch(heavy_tail=64, seed=7)
    """
    if (requests is None) == (heavy_tail is None):
        raise ValueError(
            "pass exactly one of requests= or heavy_tail=")
    if heavy_tail is not None:
        knobs = ({"count": heavy_tail} if isinstance(heavy_tail, int)
                 else dict(heavy_tail))
        knobs.setdefault("seed", int(common.get("seed", 0)))
        requests = heavy_tail_requests(**knobs)
    out = []
    for req in requests:
        if isinstance(req, str):
            name, overrides = req, {}
        else:
            # tolerate (name, overrides, arrival_s) open-loop entries:
            # the timestamp is scheduling metadata, not a build knob
            name, overrides = req[0], req[1]
        out.append(get_dataset(name, **{**common, **overrides}))
    return out


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
