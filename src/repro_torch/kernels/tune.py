"""Persistent tile-size autotuner for the row kernels
(``repro/kernels/tune.py``, DESIGN.md §10).

``tile_rows`` is the number of rows one thread block of a row kernel
owns (``mex_window``, ``conflict``, ``fused_compact``, ``fused_step``,
``jpl_extrema``; ``csrc/rows.cuh``): a launch takes ``tile_rows <<
lpr_log2`` threads, raised to whole warps and capped at 1024. It is a pure
performance knob: any value gives the same result (the tests sweep it),
but the best value depends on the card, the layout kind and the dtype.
The engine asks this module when a run starts:

  * the first use of a ``(backend, layout kind, dtype)`` triple times the
    ``fused_compact`` kernel at each candidate tile over that kind's
    registry graph (``_SWEEP_GRAPHS``; hub tables on for the hub kinds)
    and records the winner;
  * winners persist in an on-disk JSON cache, so later processes skip the
    sweep; the resolved ``tile_rows`` keys the captured CUDA graphs and
    the session caches, so trips made at two tiles never mix.

Cache file format, the reference's: ``{"version": 1, "entries":
{"<backend>/<kind>/<dtype>": {"tile_rows": int, "micros": {"<cand>":
float}}}}``. The backend of a CUDA device is ``cuda-sm<major><minor>``
(``cuda-sm90`` on an H100). Corrupt or version-mismatched files are
discarded and swept again, never trusted. The file is ``$REPRO_TUNE_CACHE``
or ``build/repro_torch/tune.json`` beside the built kernels.

The sweep times the CUDA kernel with CUDA events, the median of
``_SWEEP_REPS`` launches each, over the ELL tile of the registry graph
that runs in that layout (``_SWEEP_GRAPHS``: its width K, its row
lengths and its hub rows, which set the lanes a row and so the block a
tile makes), its rows repeated until a launch takes a few hundred
microseconds, so that launch noise does not rank the candidates (the
reference's 256 random rows would take a few microseconds on the card),
and a ``_SWEEP_WINDOW``-color window. On the CPU there is no kernel to
time: the timer raises rather than time the plain version, and
``resolve_tile_rows`` resolves ``"auto"`` to None there.

``csr-segment`` has no row kernel (its steps are edge-wise scatters), so
its entry records ``tile_rows: None``.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.device import resolve_device

CACHE_ENV = "REPRO_TUNE_CACHE"
CACHE_VERSION = 1
CANDIDATES = (8, 32, 128)
#: the sweep's workload of each ELL kind: (registry graph, its layout
#: arguments, copies of its rows). At scale 1: europe_osm_s as pure-ell is
#: K = 8 with 2.08 entries a row and no hub row, 400,000 rows (x16);
#: kron_g500-logn21_s capped at K = 128 as ell-tail has 15.4 ELL entries a
#: row (median degree 3) and 3.8% hub rows, 65,536 rows (x32: the 2^21
#: rows of the kron graph the engine is measured on); the same graph split
#: at its 90th-percentile degree as hub-split is K = 72 with 9.1% hub rows
#: (x32)
_SWEEP_GRAPHS = {
    "pure-ell": ("europe_osm_s", dict(layout="pure-ell"), 16),
    "ell-tail": ("kron_g500-logn21_s", dict(layout="ell-tail", ell_cap=128),
                 32),
    "hub-split": ("kron_g500-logn21_s", dict(layout="hub-split"), 32),
}
_SWEEP_SCALE = 1.0
#: the color window and the timed launches a candidate
_SWEEP_WINDOW = 128
_SWEEP_REPS = 20

ELL_KINDS = ("pure-ell", "ell-tail", "hub-split")

_MEMO: dict[str, "TileConfig"] = {}


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One tuned entry: the winning tile height plus the sweep timings
    (microseconds per candidate) that justified it."""
    tile_rows: "int | None"
    micros: dict[str, float] = dataclasses.field(default_factory=dict)


def cache_path() -> str:
    override = os.environ.get(CACHE_ENV)
    if override:
        return override
    from repro_torch.kernels._build import build_root
    return str(build_root() / "tune.json")


def tune_key(backend: str, kind: str, dtype: str = "int32") -> str:
    return f"{backend}/{kind}/{dtype}"


def backend_name(device: torch.device) -> str:
    """``cuda-sm<major><minor>`` for a CUDA device, else its type."""
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda-sm{major}{minor}"


def _load() -> dict:
    try:
        with open(cache_path()) as f:
            data = json.load(f)
        if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
            return {}
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}
    except (OSError, ValueError):
        return {}


def _store(entries: dict) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                      indent=1, sort_keys=True)
    except OSError:
        pass  # the cache is an optimisation; a read-only tree sweeps again


def _sweep_case(kind: str, device: torch.device) -> dict:
    """The operands of one ``fused_compact`` call over ``kind``'s sweep
    graph (``_SWEEP_GRAPHS``): its ELL tile repeated (copy c's neighbour
    ids offset by c * n; pad id R), random colors and priorities, every
    row active at 80%, and for the hub kinds hub tables read by the
    graph's hub rows (degree above the layout's threshold)."""
    from repro_torch.core.ipgc import PAD_COLOR
    from repro_torch.graphs.registry import get_dataset
    name, layout, copies = _SWEEP_GRAPHS[kind]
    g = get_dataset(name, scale=_SWEEP_SCALE, **layout)
    n, k, w = g.n_nodes, g.ell_width, _SWEEP_WINDOW
    r = n * copies
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def flags(p, shape):
        return torch.rand(shape, generator=gen, device=device) < p

    colors = ints(-1, 60, (r + 1,))
    colors[r] = PAD_COLOR
    priority = ints(0, 100, (r + 1,))
    one = torch.from_numpy(np.asarray(g.arrays.ell_idx,
                                      dtype=np.int32)).to(device)
    offset = torch.arange(copies, dtype=torch.int32, device=device) * n
    ell = torch.where(one == n, r, one + offset.view(-1, 1, 1))
    ell = ell.reshape(r, k).contiguous()
    active = flags(0.8, (r,))
    case = dict(colors=colors, priority=priority, ell_idx=ell, rows=None,
                base=torch.zeros(r, dtype=torch.int32, device=device),
                cu=colors[:r].clone(), pu=priority[:r].clone(),
                ids=torch.arange(r, dtype=torch.int32, device=device),
                active=active, pending=active & (colors[:r] >= 0),
                hub_forb=None, hub_lose=None, hub_slot=None)
    if kind in ("ell-tail", "hub-split"):
        hub = torch.from_numpy(np.asarray(g.arrays.degrees)
                               > g.layout.hub_threshold).to(device)
        hub = hub.repeat(copies)
        nh = int(hub.sum())
        case["hub_forb"] = flags(0.1, (nh + 1, w))
        case["hub_forb"][nh] = False
        case["hub_lose"] = flags(0.05, (nh + 1,))
        case["hub_lose"][nh] = False
        slot = torch.full((r,), nh, dtype=torch.int32, device=device)
        slot[hub] = torch.arange(nh, dtype=torch.int32, device=device)
        case["hub_slot"] = slot
    return case


def _time_candidate(case: dict, tile_rows: int) -> float:
    """Median device microseconds of one ``fused_compact`` call at this
    tile: CUDA events around each of ``_SWEEP_REPS`` calls, each enqueued
    behind an untimed call so that the host's work of the wrapper falls
    inside the card's work of the call before, after two warm-up calls.
    Raises off the card: the plain version is no yardstick of the kernel's
    tile."""
    from repro_torch.kernels.fused_compact import fused_compact_cuda
    if case["colors"].device.type != "cuda":
        raise RuntimeError(
            "the tile tuner times the CUDA kernel and there is none on "
            f"{case['colors'].device}; tile_rows resolves to None off the "
            "card")
    r = case["ell_idx"].shape[0]

    def call():
        return fused_compact_cuda(**case, window=_SWEEP_WINDOW, capacity=r,
                                  n_sentinel=r, tile_rows=tile_rows)

    call()
    call()
    times = []
    for _ in range(_SWEEP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        call()
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return float(np.median(times))


def sweep(kind: str, *, candidates: "tuple[int, ...]" = CANDIDATES,
          device=None) -> TileConfig:
    """Time every candidate tile height on a ``kind``-shaped workload on
    ``device`` (None: the CUDA device).

    Traced runs see the sweep: with an ambient ``obs.Trace`` installed,
    it records a ``tune.sweep`` span with one ``tune.candidate`` child per
    tile height carrying its measured microseconds. The sweep's launches
    are scoped away from ``KERNEL_LAUNCHES``, as a run report's work
    profile's are: a run that tunes counts its own launches only."""
    from repro_torch.kernels._build import KERNEL_LAUNCHES
    from repro_torch.obs import trace as obs_trace

    if kind not in ELL_KINDS:
        return TileConfig(tile_rows=None)
    case = _sweep_case(kind, resolve_device(device))
    micros = {}
    with obs_trace.maybe_span("tune.sweep", kind=kind,
                              candidates=list(candidates)), \
            KERNEL_LAUNCHES.scope():
        for c in candidates:
            with obs_trace.maybe_span("tune.candidate", kind=kind,
                                      tile_rows=c) as sp:
                micros[str(c)] = _time_candidate(case, c)
                if sp is not None:
                    sp.attrs["micros"] = micros[str(c)]
    best = min(micros, key=micros.get)
    return TileConfig(tile_rows=int(best), micros=micros)


def get_tile_config(kind: str, *, dtype: str = "int32",
                    device=None) -> TileConfig:
    """Tuned config for (``device``'s backend, layout kind, dtype) —
    memoised in-process, persisted on disk, swept on first miss."""
    dev = resolve_device(device)
    key = tune_key(backend_name(dev), kind, dtype)
    if key in _MEMO:
        return _MEMO[key]
    entries = _load()
    hit = entries.get(key)
    if isinstance(hit, dict) and "tile_rows" in hit:
        tr = hit["tile_rows"]
        if tr is None or (isinstance(tr, int) and tr > 0):
            cfg = TileConfig(tile_rows=tr, micros=dict(hit.get("micros", {})))
            _MEMO[key] = cfg
            return cfg
    cfg = sweep(kind, device=dev)
    _MEMO[key] = cfg
    entries[key] = dataclasses.asdict(cfg)
    _store(entries)
    return cfg


def resolve_tile_rows(spec_tile: "int | str | None", kind: str,
                      device) -> "int | None":
    """Resolve ``ExecutionSpec.tile_rows`` to the value the steps take.

    An explicit int is always honoured. The ``"auto"``/None policy
    consults the tuner only on a CUDA device for an ELL-family kind: the
    CPU runs the plain versions, which have no tile, so ``"auto"``
    resolves to None there and cannot fragment the session caches."""
    if isinstance(spec_tile, bool):
        raise ValueError(f"tile_rows must be an int, 'auto' or None, got "
                         f"{spec_tile!r}")
    if isinstance(spec_tile, int):
        return spec_tile
    if spec_tile not in (None, "auto"):
        raise ValueError(f"tile_rows must be an int, 'auto' or None, got "
                         f"{spec_tile!r}")
    dev = torch.device(device)
    if dev.type != "cuda" or kind not in ELL_KINDS:
        return None
    return get_tile_config(kind, device=dev).tile_rows


def clear_memo() -> None:
    """Drop the in-process memo (tests re-point the cache file)."""
    _MEMO.clear()
