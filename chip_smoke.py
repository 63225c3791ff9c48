"""End-to-end smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA device (exits non-zero without printing a result when
``torch.cuda.is_available()`` is false) and the CUDA toolkit (the kernels
are compiled from ``src/repro_torch/kernels/csrc`` at first use). Phases,
each failing the script on any error:

1. device: the card's name and power limit, and the kernels' build time;
   then the tile tuner (``kernels/tune.py``) pointed at a temporary cache
   file sweeps the three ELL kinds on the card, each over its registry
   graph (each candidate's µs, the winner and the sweep's workload,
   ``tune.sweep`` lines), a second lookup is a memo hit and a
   fresh process reads the file without sweeping, so that the main
   path's runs (``tile_rows="auto"``) find their tiles in the memo;
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the shapes of the main paths and at edge cases,
   exactly; their times beside the plain version's, the byte bound and,
   where one PyTorch call computes the same function, that call. A
   kernel the reference tiles runs at the ``tile_rows`` its main-path
   call had (a recorded call keeps it; the kernels line's ``tile_rows``)
   and again at the default block (``default_ms``). The
   kernels that gather the neighbours themselves (``conflict``,
   ``fused_compact``, ``fused_step``) are also timed against the gathers
   their earlier signature needed (``gather_ms``), and at the items block
   of the kron sparse steps' most-used capacity bucket (recorded during
   the ipgc runs of phases 3 and 4), as is ``compact``; ``compact`` (one
   launch, a decoupled look-back) also repeats 100 times at 2**21 and
   50.8M flags, bit-equal every time; the five row kernels the
   reference tiles (``mex_window``, ``conflict``, ``fused_compact``,
   ``fused_step``, ``jpl_extrema``) equal their plain twins at
   ``tile_rows`` 8, 32 and 128 at the kron dense shape (their ms per tile,
   the kernels line's ``tile_ms``) and at the edge-case sizes (and 1024),
   and, after europe's outlined runs, at europe's dense shape
   (``tune.kernels_main_path`` lines, beside the default block's ms and
   the tile "auto" resolves to);
3. path: on kron_g500-logn21_s at scale 32 (2**21 nodes, ell-tail, hubs)
   and europe_osm_s at scale 127 (50.8M nodes, pure-ell), the hybrid Pipe
   (``repro_torch.color``) with ipgc two-phase and fused, jpl and
   spec-greedy, with the kernel launch counts of each run (the counts are
   zeroed just before it and read just after) and a verified coloring;
   the ipgc and jpl Pipes replayed over their step functions with CUDA's
   sync debug mode set to "error" everywhere but the per-iteration count
   read; hybrid BFS (``repro_torch.core.bfs.bfs``) on kron in its three
   modes, which must give the same levels; the paper's baselines
   ``jpl_color`` and ``vb_color`` on kron. The kron ipgc two-phase run is
   repeated traced (``color(..., trace=True)``, a ``RunReport``): equal to
   the untraced run, with the same kernel launches (the report's work
   profile runs after the timed run, its launches scoped away), both
   runs' seconds logged (``traced`` lines);
4. dist: the distributed Pipe on kron with four shards on the one card
   (``color_distributed(devices=[cuda:0] * 4)``: ipgc fused and
   two-phase, spec-greedy, jpl) and on europe with one shard per visible
   card (``color(mode="dist-hybrid")``, the four colorings; ipgc fused
   runs the no-hub ``fused_step`` over 50.8M rows); launch and exchange
   counts per run (1 exchange per fused iteration and JPL round, 2 per
   two-phase one), a verified coloring, and a replay of each under sync
   debug "error" (spec-greedy's runs the ipgc fused steps, replayed
   already; the kron jpl run stops at 64 of its 815 rounds,
   ``DIST_ROUND_CAP``, to leave time for the other phases: its partial
   coloring is verified conflict-free without completeness); the
   ``fused_step``
   kernel row is timed at the kron S=4 dense shape, as shard 0's fused
   dense step hands it over. Then the boundary exchange
   (``exchange="boundary"`` and ``"auto"``: per-shard views, a packed
   publish of the changed boundary vertices or a dense swap, chosen on
   the card) for kron's ipgc fused and two-phase and europe's four
   colorings: each equal to its dense-exchange run in colors, iterations
   and mode trace, one ``boundary_pack`` and one ``dense_swap`` counted a
   publish, the ledger's bytes logged against the dense run's, and the run
   replayed under sync debug "error" (kron's first
   ``BOUNDARY_REPLAY_ITERS`` iterations, europe's whole); the kron auto
   ipgc fused run is repeated traced as in phase 3;
5. card vs CPU: kron at scale 1 colored (ipgc, jpl, spec-greedy) and
   searched (BFS, three modes) on the card and on the CPU gives identical
   results, and BFS equals the host oracle; the distributed Pipe at 1 and
   4 shards gives the same colors, iterations and trace on the card, on
   the CPU and in the host engine on the same partitioned graph, and its
   auto exchange at 4 shards (ipgc two-phase) the same as the CPU's in
   every field but the times (exchange trace and bytes included) and as
   the dense exchange's colors, iterations and trace; the
   outlined regime on the card equals the outlined regime on the CPU in
   every field but ``tti`` and ``total_seconds``, and the card's host loop
   in colors, colors used, iterations and mode trace;
6. outlined: on kron and europe, after each graph's path phase, the
   outlined regime (``color(..., outline=True)``: one chunk per capacity
   bucket, each trip a replay of a captured CUDA graph, ``exec/chunk.py``)
   with the four colorings of phase 3, each run twice on the session (cold:
   the trips are captured; warm: replays only). Each run must equal its
   host loop of phase 3 in colors, iterations and mode trace, give a
   verified coloring (the cold run's is verified, the warm run's equals
   it), keep ``host_dispatches <= len(caps) + 1``, and the warm run must
   capture nothing. Per run: host dispatches, counter reads
   (one per trip), graphs captured and their capture seconds, coloring
   seconds beside the host loop's, peak memory, and the kernel launches.
   The wrappers count a launch when their Python runs, so in this regime
   once per warm-up and capture (``wrapper_launches``, cold run only); the
   launches of the trips that ran are the launches each captured trip
   holds times the replays of that trip (``exec.chunk.REPLAYED_LAUNCHES``,
   ``replayed_launches``), and every kernel of the coloring must have some.
   Each captured trip is replayed once more with CUDA's sync debug mode at
   "error" (the regime replays every trip so too). Then two whole-run
   ``torch.profiler`` traces of kron ipgc two-phase, host loop and
   outlined (warm): the device's busy share over the run, device time by
   op name (this port's kernels and the rest), and launches and device
   operations per iteration. The fused family wins ``fused=None`` on CUDA
   where it is faster warm on both graphs (``outlined.fused_rule``). The
   kron ipgc two-phase warm run is repeated traced as in phase 3 (the
   same kernel and replayed launches). After kron's profile traces, the
   ``tune`` runs: kron ipgc two-phase in the host loop at
   ``tile_rows`` 8, 32, 128 and "auto", each equal to phase 3's run in
   colors, iterations and mode trace, seconds logged; one outlined run at
   8 and 32 on one session, each tile capturing its own trips.

7. batch and stream (after phase 6 and the card-vs-CPU checks, reusing
   phase 3's graphs and results): the heavy-tail request mix
   (``get_dataset_batch(heavy_tail=...)``: 16 requests of the road, hub,
   web and geometric families, 65K to 1M nodes, seed 7, ell-tail at ELL
   width 128), each
   graph's build timed; each colored alone (``Session.run``, the four
   colorings, verified; their sum is the sequential baseline); then
   ``Session.run_batch`` of the mix per coloring, cold (one captured trip
   per lane group) and warm (replays only, nothing captured), every lane
   equal to its solo run, per lane group its shape class, lanes, trips,
   captures and replayed launches, per call the seconds, graphs/s and peak
   memory; every captured lane trip replayed once more under sync debug
   "error"; the stream service (ipgc two-phase, lanes=8, adaptive) fed the
   mix plus phase 3's kron and europe from a producer thread under
   ``serving()``, each result equal to its solo run (phase 3's for kron and
   europe), and a jpl stream of the mix (lanes=4) driven by ``pump()`` and
   ``drain()`` with lanes refilled mid-stream; rounds, dispatches, grows,
   shrinks, restacks, captures, lane occupancy, p50/p90 of the tickets'
   total seconds, graphs/s and peak memory; the kernels of a lane trip
   held against their plain versions, exactly, on the operands the trip
   hands them (recorded two trips into a run) at the real sizes of each
   coloring's largest run_batch lane group and of the ipgc stream's kron
   group (``batch.lane_kernels``; the kernels line's
   ``lane_rows_checked``); the mix in the reference's serving layout
   (ell-tail at the auto ELL width), per coloring a ``run_batch`` of the
   16 requests that either runs or refuses with ``LaneMemoryError`` before
   it allocates, then runs on the largest leading part of the mix that
   fits, cold and warm, every lane equal to its solo run; finally
   ``run_batch`` and a ``ManualClock`` jpl stream at kron scale 1 and
   europe scale 0.02 on the card and on the CPU, identical. The kernels
   line's ``batch_launches`` are the replayed launches of this phase's
   run_batch calls and streams.

8. lm (last): the LM serving path. The five LM archs' smoke configs in
   fp32 (TF32 off) on the card and on the CPU, the same weights and
   tokens: prefill logits and three teacher-forced decode steps, with the
   plain and the int8 cache, within ``LM_CPU_TOL``; then Qwen3-30B-A3B at
   its published widths (d_model 2048, 32 heads, 4 KV heads, head_dim
   128, 128 experts top-8 of width 768, vocab 151,936, rope theta 1e6),
   8 of its 48 layers, bf16, random weights from a seed:
   ``launch.serve.serve`` with the reference driver's defaults (batch 8,
   prompt 64, 32 generated tokens, temperature 0.8) with a bf16 and an
   int8 KV cache, each after an untimed warm-up call; init seconds, prefill
   ms and tok/s, decode ms a step and tok/s, peak GiB (``lm.serve``
   lines); every logit finite; the int8 run's first decode step within
   ``LM_INT8_REL`` of the bf16 run's; and decode at position 63 (prefill
   of 63 tokens, one step) against ``forward`` at 63 within
   ``LM_DECODE_REL``, at a capacity factor that drops no token (the MoE
   drops over-capacity tokens, and 504 or 512 tokens drop others than 8
   do), with the served factor's distance logged beside it; one decode
   step over a bf16 and an int8 cache of the same prompts, interleaved
   wall ms and one ``torch.profiler`` trace of each (device µs, launches,
   the top operations: ``lm.decode_profile``).

The ``done`` line gives the seconds of each stretch of ``main``
(``phase_seconds``).

BFS does not run on europe at full size: its road-like chain needs on the
order of millions of levels from any source.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import repro_torch  # noqa: E402
from repro_torch.algos import get_algorithm  # noqa: E402
from repro_torch.algos.base import init_ipgc_state  # noqa: E402
from repro_torch.algos.jpl import round_hash  # noqa: E402
from repro_torch.core import bfs as bfs_mod  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import ipgc, jpl_color, vb_color  # noqa: E402
from repro_torch.core.engine import adaptive_window  # noqa: E402
from repro_torch.core.policy import (Timer,  # noqa: E402
                                     device_threshold, make_policy)
from repro_torch.core.worklist import (Worklist,  # noqa: E402
                                       bucket_capacities, pick_bucket,
                                       resize_items)
from repro_torch.exec import ExecutionSpec, Session  # noqa: E402
from repro_torch.exec import batch as batch_mod  # noqa: E402
from repro_torch.exec import chunk as chunk_mod  # noqa: E402
from repro_torch.exec import default_session  # noqa: E402
from repro_torch.graphs import (get_dataset_batch,  # noqa: E402
                                heavy_tail_requests)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.compact import TILE as COMPACT_TILE  # noqa: E402
from repro_torch.kernels.compact import compact_plain  # noqa: E402
from repro_torch.kernels.conflict import (conflict_rows_plain,  # noqa: E402
                                          gather_rows)
from repro_torch.kernels.frontier import frontier_probe_plain  # noqa: E402
from repro_torch.kernels.fused_compact import \
    fused_compact_rows_plain  # noqa: E402
from repro_torch.kernels.fused_step import \
    fused_step_rows_plain  # noqa: E402
from repro_torch.kernels.jpl_prio import jpl_extrema_plain  # noqa: E402
from repro_torch.kernels.mex_window import mex_window_plain  # noqa: E402
from repro_torch.kernels import tune  # noqa: E402
from repro_torch.serve import ManualClock, StreamConfig  # noqa: E402

from _gather_cases import gather_case, gathered  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the non-tensor-core
#: 32-bit vector rate (67 TFLOP/s) as the rate of the kernels' integer work
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12

KRON = dict(name="kron_g500-logn21_s", scale=32, layout="ell-tail",
            ell_cap=128)
ROAD = dict(name="europe_osm_s", scale=127, layout="auto")
SMALL = dict(name="kron_g500-logn21_s", scale=1, layout="ell-tail",
             ell_cap=128)
#: BFS starts from node 0 (in kron's giant component at scales 1 and 32)
BFS_SOURCE = 0

#: kernel -> (source, the TPU kernel's pallas_call it replaces, the launch
#: counter of its wrapper in ``_build.KERNEL_LAUNCHES``)
SOURCES = {
    "mex_window": ("src/repro_torch/kernels/csrc/mex_window.cu",
                   "src/repro/kernels/mex_window.py:66", "mex_window"),
    "conflict": ("src/repro_torch/kernels/csrc/conflict.cu",
                 "src/repro/kernels/conflict.py:49", "conflict"),
    "compact": ("src/repro_torch/kernels/csrc/compact.cu",
                "src/repro/kernels/compact.py:66", "compact"),
    "fused_compact": ("src/repro_torch/kernels/csrc/fused_compact.cu",
                      "src/repro/kernels/fused_compact.py:191",
                      "fused_compact"),
    "jpl_extrema": ("src/repro_torch/kernels/csrc/jpl_prio.cu",
                    "src/repro/kernels/jpl_prio.py:65", "jpl_prio"),
    "frontier_probe": ("src/repro_torch/kernels/csrc/frontier.cu",
                       "src/repro/kernels/frontier.py:35", "frontier"),
    "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:99", "fused_step"),
}
#: the shards of the distributed Pipe on kron: four on the one card
KRON_SHARDS = 4


_T0 = time.perf_counter()


def log(**fields) -> None:
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({**fields, "t": time.perf_counter() - _T0}), flush=True)


# --- timing and bounds ---------------------------------------------------------

def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops_: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_ / VECTOR_OPS_PER_S
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def assert_equal(got, want, what: str) -> int:
    """Exact equality of every output; returns the max abs difference (0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel disagrees with its plain "
                                 "version")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# --- phase 1 -------------------------------------------------------------------

def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    out, seconds = _build.build_all()
    log(phase="build", seconds=seconds, directory=str(out))
    print((out / "build.log").read_text() if (out / "build.log").exists()
          else "(libraries already built)", flush=True)
    return card


# --- phase 2 -------------------------------------------------------------------

def edge_cases(dev) -> None:
    """Small and ragged shapes, empty/full masks, hub on/off, truncating
    and padding capacities: every kernel equals its plain version."""
    rng = np.random.default_rng(7)

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

    for r in (1, 7, 257, 3000):
        for k in (1, 8, 40, 128):
            for w in (32, 128, 256):
                nc = rng.integers(-2, 300, size=(r, k)).astype(np.int32)
                base = (rng.integers(0, 4, size=r) * w).astype(np.int32)
                extra = rng.random((r, w)) < 0.25
                for e in (None, extra):
                    assert_equal(ops.mex_window(t(nc), t(base), t(e), w),
                                 mex_window_plain(t(nc), t(base), t(e), w),
                                 f"mex_window r={r} k={k} w={w}")
    gather_edge_cases(dev)
    compact_edge_cases(dev, rng)
    for r in (0, 1, 7, 257, 3000):
        for k in (1, 3, 8, 40, 128):
            for inactive in (0.3, 1.0):
                npr = rng.integers(0, 2**31 - 1, size=(r, k)).astype(np.int32)
                npr = np.where(rng.random((r, k)) < inactive, -1, npr)
                x = t(npr.astype(np.int32))
                assert_equal(ops.jpl_extrema(x), jpl_extrema_plain(x),
                             f"jpl_extrema r={r} k={k}")
            nbr = t(rng.random((r, k)) < 0.05)
            for unvisited in (t(rng.random(r) < 0.6),
                              torch.ones(r, dtype=torch.bool, device=dev)):
                assert_equal(ops.frontier_probe(nbr, unvisited),
                             frontier_probe_plain(nbr, unvisited),
                             f"frontier_probe r={r} k={k}")
            if r > 1:     # unaligned tiles take the narrow loads
                y = x.reshape(-1)[1:][:(r - 1) * k].reshape(r - 1, k)
                assert_equal(ops.jpl_extrema(y), jpl_extrema_plain(y),
                             f"jpl_extrema unaligned r={r} k={k}")
                z = nbr.reshape(-1)[1:][:(r - 1) * k].reshape(r - 1, k)
                u = unvisited[1:]
                assert_equal(ops.frontier_probe(z, u),
                             frontier_probe_plain(z, u),
                             f"frontier_probe unaligned r={r} k={k}")
    log(phase="kernels.edge_cases", equal=True)


#: compact's edge sizes: around its tile (COMPACT_TILE flags), the kron
#: dense worklist (2**21) and europe's (50.8M, 6.2K scan tiles)
COMPACT_SIZES = (0, 1, COMPACT_TILE - 1, COMPACT_TILE, COMPACT_TILE + 1,
                 3 * COMPACT_TILE + 5, 2**21, 50_800_000)
#: sizes whose compactions repeat, every repeat bit-equal to the first
COMPACT_REPEATS = {2**21: 100, 50_800_000: 100}


def compact_edge_cases(dev, rng) -> None:
    """compact (one launch, decoupled look-back) against compact_plain at
    each size and density of flags, capacity below, at and above the
    count, with and without values, and on an unaligned mask (the
    one-byte loads); at 2**21 and 50.8M flags every call repeats 100
    times, bit-equal each time."""
    for n in COMPACT_SIZES:
        values = torch.randint(0, 2**31 - 1, (n,), dtype=torch.int32,
                               device=dev)
        for density in (0.0, 1 / 1024, 0.5, 1.0):
            mask = torch.from_numpy(rng.random(n) < density).to(dev)
            count = int(mask.sum())
            for cap in sorted({max(count - 1 - count // 3, 0), count,
                               count + 7}):
                for vals in (None, values):
                    want = compact_plain(mask, cap, n, vals)
                    what = (f"compact n={n} density={density} cap={cap} "
                            f"values={vals is not None}")
                    for _ in range(COMPACT_REPEATS.get(n, 1)):
                        assert_equal(ops.compact(mask, cap, n, vals), want,
                                     what)
            if n > 1:        # an unaligned view: the one-byte loads
                flat = torch.empty(n, dtype=torch.bool, device=dev)
                view = flat[1:]
                view.copy_(mask[1:])
                assert_equal(ops.compact(view, n, n - 1),
                             compact_plain(view, n, n - 1),
                             f"compact unaligned n={n} density={density}")
    log(phase="kernels.compact_edge_cases", sizes=list(COMPACT_SIZES),
        repeats=COMPACT_REPEATS, bit_equal=True)


def gather_edge_cases(dev) -> None:
    """conflict, fused_compact and fused_step, which gather the neighbours
    themselves: rows None or sparse with sentinels, hub and no-hub, rows of
    length 0, < K and K, R = 0, empty/full activity, exhausted windows,
    truncating and padding capacities, 16-byte and one-entry ELL loads."""
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

    conflict_names = ("colors", "priority", "ell", "rows", "cu", "pu", "ids",
                      "newly")
    fused_names = ("colors", "priority", "ell", "rows", "base", "cu", "pu",
                   "ids", "active", "pending", "hub_forb", "hub_lose",
                   "hub_slot")
    step_names = fused_names[:8] + fused_names[9:]
    for rg in (0, 1, 7, 257, 3000):
        for k in (1, 3, 8, 40, 128):
            for w in (1, 32, 128, 256):
                for sparse in (False, True):
                    for hub in (False, True):
                        c = gather_case(rg + k + w + sparse + hub, rg, k,
                                        sparse=sparse, hub=hub, window=w,
                                        lo=5)
                        r = len(c["cu"])
                        what = (f"rg={rg} k={k} w={w} sparse={sparse} "
                                f"hub={hub}")
                        args = [t(c[n]) for n in conflict_names]
                        assert_equal(ops.conflict(*args),
                                     conflict_rows_plain(*args),
                                     f"conflict {what}")
                        step = [t(c[n]) for n in step_names]
                        got = ops.fused_step(*step, w)
                        assert_equal(got, fused_step_rows_plain(*step, w),
                                     f"fused_step {what}")
                        if hub:
                            # rows at an all-forbidden hub row: first = -1
                            full = gathered(c)["extra"].all(axis=1)
                            if not (got[1].cpu().numpy()[full] == -1).all():
                                raise AssertionError(
                                    f"fused_step {what}: a full window did "
                                    "not give -1")
                        for act_p in (0.0, 1.0, None):
                            if act_p is not None:
                                c["active"] = np.full(r, act_p > 0)
                                c["pending"] = c["active"] & (c["cu"] >= 0)
                            case = [t(c[n]) for n in fused_names]
                            for cap in (max(r, 1), max(r // 3, 1), r + 5):
                                assert_equal(
                                    ops.fused_compact(*case, w, capacity=cap,
                                                      n_sentinel=c["n"]),
                                    fused_compact_rows_plain(
                                        *case, w, capacity=cap,
                                        n_sentinel=c["n"]),
                                    f"fused_compact {what} cap={cap}")
                        if rg > 1 and k % 4 == 0:
                            # an unaligned ELL tile: the one-entry loads
                            flat = t(c["ell"]).reshape(-1)
                            x = torch.empty(flat.numel() + 1,
                                            dtype=flat.dtype, device=dev)
                            x[1:] = flat
                            args[2] = case[2] = step[2] = x[1:].view(rg, k)
                            assert_equal(ops.conflict(*args),
                                         conflict_rows_plain(*args),
                                         f"conflict unaligned {what}")
                            assert_equal(ops.fused_step(*step, w),
                                         fused_step_rows_plain(*step, w),
                                         f"fused_step unaligned {what}")
                            assert_equal(
                                ops.fused_compact(*case, w, capacity=r,
                                                  n_sentinel=c["n"]),
                                fused_compact_rows_plain(
                                    *case, w, capacity=r,
                                    n_sentinel=c["n"]),
                                f"fused_compact unaligned {what}")


def items_rows(args) -> "int | None":
    """The row count of a gathering kernel's call from an items block
    (``rows`` given), None for a dense call (``rows`` None)."""
    return None if args[3] is None else args[4].shape[0]


def all_rows(args) -> int:
    """The row count of a gathering kernel's call."""
    return args[4].shape[0]


class Recorder:
    """Wraps ``ops.<name>`` while active: counts its calls by row count
    (``rows_of(args)``; None skips the call) and keeps the arguments of the
    first call at each row count (the operands the main path hands the
    kernel, as they were, and its keywords, ``tile_rows`` among them, so a
    kept call runs again at the block the path ran; with ``copy``, copies
    of its tensors, for a caller that writes into them after the call)."""

    def __init__(self, name: str, rows_of=items_rows, copy: bool = False):
        self.name, self.rows_of, self.copy = name, rows_of, copy
        self.calls: dict[int, int] = {}
        self.args: dict[int, tuple] = {}

    def __enter__(self):
        real = self.real = getattr(ops, self.name)

        def spy(*args, **kw):
            r = self.rows_of(args)
            if r is not None:
                self.calls[r] = self.calls.get(r, 0) + 1
                if r not in self.args:
                    kept = args
                    if self.copy:
                        kept = tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args)
                    self.args[r] = (kept, dict(kw))
            return real(*args, **kw)

        setattr(ops, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.real)

    def most_used(self) -> tuple[int, int, tuple]:
        """(rows, calls, (args, kwargs)) of the most-called row count."""
        r = max(self.calls, key=lambda x: (self.calls[x], x))
        return r, self.calls[r], self.args[r]


def untiled(kw: dict) -> dict:
    """A recorded call's keywords without ``tile_rows``, which the plain
    twins and the work reckonings do not take."""
    return {k: v for k, v in kw.items() if k != "tile_rows"}


def main_path_operands(ig, window: int):
    """The operands the dense steps hand the kernels, taken from the state
    two fused dense iterations into a run on ``ig`` at the tile the main
    path's runs resolve (``tile_rows="auto"``): ``conflict``'s and
    ``fused_compact``'s as the two-phase and fused dense steps pass them
    from that state (recorded), the others rebuilt as the steps build
    them."""
    tile = tune.resolve_tile_rows("auto", ig.layout_kind, ig.device)
    colors, base, wl = init_ipgc_state(ig)
    for _ in range(2):
        colors, base, wl = ipgc.fused_dense_step(ig, colors, base, wl,
                                                 window=window,
                                                 tile_rows=tile)
    with Recorder("conflict", all_rows) as rec_c:
        ipgc.dense_step(ig, colors, base, wl, window=window, tile_rows=tile)
    with Recorder("fused_compact", all_rows) as rec_f:
        ipgc.fused_dense_step(ig, colors, base, wl, window=window,
                              tile_rows=tile)
    extra = None
    if ig.n_hub > 0:
        extra = ipgc._hub_forbidden(ig, colors, base, window)[ig.hub_slot]
    return dict(nc=colors[ig.ell_idx], base=base, extra=extra,
                active=wl.mask, capacity=wl.capacity, n=ig.n_nodes,
                ids=torch.arange(ig.n_nodes, dtype=torch.int32,
                                 device=ig.device), tile_rows=tile,
                conflict=rec_c.most_used()[2],
                fused_compact=rec_f.most_used()[2])


def _unique(x: torch.Tensor) -> int:
    return int(torch.unique(x).numel())


def conflict_work(colors, priority, ell_idx, rows, cu, pu, ids,
                  newly) -> tuple[int, int]:
    """Bytes and operations the conflict kernel needs on these inputs,
    each read once: ``newly`` (and ``rows``) of every row, ``cu`` of the
    newly colored graph rows, ``pu`` and ``ids`` of those with a color,
    4 bytes per real ELL entry of those (the padding is never read), the
    distinct colors they touch, the distinct priorities at same-color
    entries, and the bool output."""
    pad = colors.shape[0] - 1
    nbr, ok = gather_rows(ell_idx, rows, pad)
    r = cu.shape[0]
    newly_ok = newly & ok
    work = newly_ok & (cu >= 0)
    real = (nbr != pad) & work[:, None]
    same = real & (colors[nbr] == cu[:, None])
    n_real, n_same = int(real.sum()), int(same.sum())
    nbytes = (r + (0 if rows is None else 4 * r) + 4 * int(newly_ok.sum())
              + 8 * int(work.sum()) + 4 * n_real + 4 * _unique(nbr[real])
              + 4 * _unique(nbr[same]) + r)
    return nbytes, n_real + 4 * n_same


def fused_compact_work(colors, priority, ell_idx, rows, base, cu, pu, ids,
                       active, pending, hub_forb, hub_lose, hub_slot,
                       window, *, capacity, n_sentinel) -> tuple[int, int]:
    """Bytes and operations the fused_compact call needs on these inputs,
    each read once: ``base``, ``cu``, ``active``, ``pending`` (and
    ``rows``) of every row; ``pu`` of the pending colored rows and ``ids``
    of those and of the emitted rows; for the working (active or pending)
    graph rows 4 bytes per real ELL entry, the distinct colors they touch,
    the distinct priorities at same-color entries of pending rows, and
    each hub row's slot, W bytes of its forbidden row and its lose flag;
    the outputs (new color, base and still per row, the items, the
    count)."""
    pad = colors.shape[0] - 1
    nbr, ok = gather_rows(ell_idx, rows, pad)
    r = cu.shape[0]
    work = (active | pending) & ok
    check = pending & ok & (cu >= 0)
    still = fused_compact_rows_plain(
        colors, priority, ell_idx, rows, base, cu, pu, ids, active, pending,
        hub_forb, hub_lose, hub_slot, window, capacity=capacity,
        n_sentinel=n_sentinel)[2]
    real = (nbr != pad) & work[:, None]
    same = real & check[:, None] & (colors[nbr] == cu[:, None])
    n_real, n_same = int(real.sum()), int(same.sum())
    nbytes = (r * 10 + (0 if rows is None else 4 * r) + 4 * int(check.sum())
              + 4 * int((check | still).sum()) + 4 * n_real
              + 4 * _unique(nbr[real]) + 4 * _unique(nbr[same])
              + r * 9 + capacity * 4 + 4)
    if hub_forb is not None:
        n_hub = hub_forb.shape[0] - 1
        slot, _ = gather_rows(hub_slot[:, None], rows, n_hub)
        hub_rows = work & (slot[:, 0] < n_hub)
        nbytes += 4 * int(work.sum()) + int(hub_rows.sum()) * (window + 1)
    return nbytes, 4 * n_real + 4 * n_same


def fused_step_work(colors, priority, ell_idx, rows, base, cu, pu, ids,
                    pending, hub_forb, hub_lose, hub_slot,
                    window) -> tuple[int, int]:
    """Bytes and operations the fused_step kernel needs on these inputs,
    each read once: ``rows`` of every row (when given); ``base``, ``cu`` and
    ``pending`` of the graph rows; ``pu`` and ``ids`` of the pending
    colored ones; 4 bytes per real ELL entry of the graph rows (the padding
    is never read), the distinct colors they touch, the distinct
    priorities at same-color entries of pending colored rows; each graph
    row's hub slot and each hub row's W bytes of its forbidden row and its
    lose flag; the outputs (lose and first per row)."""
    pad = colors.shape[0] - 1
    nbr, ok = gather_rows(ell_idx, rows, pad)
    r = cu.shape[0]
    check = pending & ok & (cu >= 0)
    real = (nbr != pad) & ok[:, None]
    same = real & check[:, None] & (colors[nbr] == cu[:, None])
    n_real, n_same = int(real.sum()), int(same.sum())
    n_ok = int(ok.sum())
    nbytes = ((0 if rows is None else 4 * r) + 9 * n_ok
              + 8 * int(check.sum()) + 4 * n_real + 4 * _unique(nbr[real])
              + 4 * _unique(nbr[same]) + 5 * r)
    if hub_forb is not None:
        n_hub = hub_forb.shape[0] - 1
        slot, _ = gather_rows(hub_slot[:, None], rows, n_hub)
        hub_rows = ok & (slot[:, 0] < n_hub)
        nbytes += 4 * n_ok + int(hub_rows.sum()) * (window + 1)
    return nbytes, 4 * n_real + 4 * n_same


#: the gathering kernels: (plain twin, work on the inputs, the index of
#: hub_forb in their arguments (None: no hub tables), of the window)
GATHERING = {
    "conflict": (conflict_rows_plain, conflict_work, None, None),
    "fused_compact": (fused_compact_rows_plain, fused_compact_work, 10, 13),
    "fused_step": (fused_step_rows_plain, fused_step_work, 9, 12),
}


def old_gathers(args, hub_at: "int | None"):
    """The PyTorch gathers the earlier, pre-gathered signature needed on
    these operands, as three callables: ``colors[ell]`` and
    ``priority[ell]`` over the (R, K) neighbour-id tile; for the hub
    variant of fused_compact and fused_step (their hub tables at
    ``args[hub_at:hub_at + 3]``) the (R, W) forbidden rows and the (R,)
    lose flags at each row's hub slot (None without hubs); and the build
    of that tile, which the sparse steps made (``ell_rows``; None for the
    dense steps, whose tile is the graph's)."""
    colors, priority, ell_idx, rows = args[:4]
    pad = colors.shape[0] - 1
    nbr = ell_idx if rows is None else gather_rows(ell_idx, rows, pad)[0]
    hub = None
    if hub_at is not None and args[hub_at] is not None:
        hub_forb, hub_lose, hub_slot = args[hub_at:hub_at + 3]
        slot = (hub_slot if rows is None
                else gather_rows(hub_slot[:, None], rows,
                                 hub_forb.shape[0] - 1)[0][:, 0])

        def hub():
            return hub_forb[slot], hub_lose[slot]

    def ell_rows():
        return gather_rows(ell_idx, rows, pad)[0]

    return ((lambda: (colors[nbr], priority[nbr])), hub,
            None if rows is None else ell_rows)


def gather_row(name, args, kw, shape: dict, reps: int) -> dict:
    """A gathering kernel's row at one recorded call: equality with the
    plain twin, kernel / plain times (the kernel at the call's own
    ``tile_rows`` and at the default block), the bound on these inputs
    and the time of the earlier signature's gathers (``gather_ms``: the
    neighbour tiles' ``tile_gather_ms`` plus the hub rows'
    ``hub_gather_ms``)."""
    plain, work, hub_at, _ = GATHERING[name]
    kernel = getattr(ops, name)
    pkw = untiled(kw)
    nbytes, ops_ = work(*args, **pkw)
    row = kernel_row(name, lambda: kernel(*args, **kw),
                     lambda: plain(*args, **pkw), nbytes, ops_, shape, None,
                     reps, tile_rows=kw.get("tile_rows"),
                     default=lambda: kernel(*args, **pkw))
    tiles, hub, ell_rows = old_gathers(args, hub_at)
    row["tile_gather_ms"] = cuda_ms(tiles, reps)
    row["hub_gather_ms"] = None if hub is None else cuda_ms(hub, reps)
    row["gather_ms"] = row["tile_gather_ms"] + (row["hub_gather_ms"] or 0.0)
    if ell_rows is not None:
        row["ell_rows_ms"] = cuda_ms(ell_rows, reps)
    return row


def bottomup_frontier(ig, levels: int = 2) -> torch.Tensor:
    """The frontier mask ``levels`` bottom-up BFS levels from the BFS
    source."""
    n = ig.n_nodes
    dist = torch.full((n,), -1, dtype=torch.int32, device=ig.device)
    dist[BFS_SOURCE] = 0
    mask = torch.zeros(n, dtype=torch.bool, device=ig.device)
    mask[BFS_SOURCE] = True
    wl = Worklist(mask=mask, items=torch.full((n,), n, dtype=torch.int32,
                                              device=ig.device),
                  count=torch.ones((), dtype=torch.int32, device=ig.device))
    for level in range(levels):
        dist, wl = bfs_mod.bottomup_step(ig, dist, wl, level)
    return wl.mask


def kernel_row(name, kernel, plain, nbytes, ops_, shape: dict,
               library=None, reps: int = 10, tile_rows=None,
               default=None) -> dict:
    """One kernel's row of the kernels line: equality with the plain
    version at main-path shapes, then kernel / plain / library times and
    the bound (its launches are filled in from the path runs). ``kernel``
    runs at the main path's ``tile_rows``; with a tile, ``default`` is the
    same call at the default block (``default_ms``), also held equal."""
    want = plain()
    err = assert_equal(kernel(), want, f"{name} at main-path shapes, "
                       f"tile_rows={tile_rows}")
    t_bound, by = bound(nbytes, ops_)
    ms = cuda_ms(kernel, reps)
    default_ms = ms
    if tile_rows is not None:
        assert_equal(default(), want, f"{name} at main-path shapes, "
                     "default block")
        default_ms = cuda_ms(default, reps)
    return dict(
        name=name, route="cuda", source=SOURCES[name][0],
        replaces=SOURCES[name][1], launches=0, max_abs_err=err,
        equal=True, ms=ms, kernel_ms=ms, tile_rows=tile_rows,
        default_ms=default_ms, plain_ms=cuda_ms(plain, 3),
        bound_ms=t_bound * 1e3, bound_by=by,
        library_ms=None if library is None else cuda_ms(library, reps),
        shape=shape)


def stream_ops(fn, reps: int = 10) -> list:
    """What each of ``reps`` calls of ``fn`` puts on the stream, as
    ``torch.profiler`` records it: ``[name, count per call, device µs per
    call]`` for every operation (kernels, memsets, copies, and the runtime
    calls behind them, which take no device time)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [[e.key, e.count / reps, e.self_device_time_total / reps]
            for e in prof.key_averages()]


def jpl_round_tile(ig, ids) -> torch.Tensor:
    """The JPL dense round's neighbour priorities at round 0, every node
    pending."""
    pr = round_hash(ids, torch.zeros((), dtype=torch.int32,
                                     device=ig.device))
    return torch.cat([pr, pr.new_full((1,), -1)])[ig.ell_idx]


def kernel_phase(ig, window: int, reps: int = 10) -> dict:
    """Each kernel at the kron main paths' shapes (the IPGC dense step, the
    JPL dense round, a bottom-up BFS level): equality with the plain
    version, then kernel / plain / library times and the bound; for
    ``conflict`` and ``fused_compact`` also the time of the gathers their
    earlier signature needed (``gather_ms``)."""
    o = main_path_operands(ig, window)
    r, k = o["nc"].shape
    w, tile = window, o["tile_rows"]
    mask = o["active"]
    shape = dict(rows=r, k=k, window=w, hubs=o["extra"] is not None)
    rows = {}

    def entry(name, kernel, plain, nbytes, ops_, library=None):
        """``kernel(t)`` at tile ``t``; untiled kernels ignore it."""
        tiled = name in ("mex_window", "jpl_extrema")
        rows[name] = kernel_row(
            name, lambda: kernel(tile if tiled else None), plain, nbytes,
            ops_, shape, library, reps, tile if tiled else None,
            lambda: kernel(None))

    entry("mex_window",
          lambda t: ops.mex_window(o["nc"], o["base"], o["extra"], w,
                                   tile_rows=t),
          lambda: mex_window_plain(o["nc"], o["base"], o["extra"], w),
          nbytes=r * k * 4 + r * 4 + (0 if o["extra"] is None else r * w)
          + r * 4,
          ops_=r * k * 4)
    for name in ("conflict", "fused_compact"):
        args, kw = o[name]
        rows[name] = gather_row(name, args, kw, shape, reps)
    args, kw = o["fused_compact"]
    rows["fused_compact"]["stream_ops"] = stream_ops(
        lambda: ops.fused_compact(*args, **kw))
    entry("compact",
          lambda t: ops.compact(mask, o["capacity"], o["n"]),
          lambda: compact_plain(mask, o["capacity"], o["n"]),
          nbytes=r + o["capacity"] * 4 + 4, ops_=r,
          library=lambda: torch.nonzero(mask))
    rows["compact"]["stream_ops"] = stream_ops(
        lambda: ops.compact(mask, o["capacity"], o["n"]))
    npr = jpl_round_tile(ig, o["ids"])
    entry("jpl_extrema", lambda t: ops.jpl_extrema(npr, tile_rows=t),
          lambda: jpl_extrema_plain(npr),
          nbytes=r * k * 4 + r * 8, ops_=r * k * 2)
    TILE_MS.update(tile_kernels_main_path(o, npr, w, KRON["name"]))
    del o, npr
    # a bottom-up BFS level's tile; bfs.bottomup_step passes unvisited all
    # true, so the probe is a row any()
    frontier = bottomup_frontier(ig)
    nbr = torch.cat([frontier, frontier.new_zeros(1)])[ig.ell_idx]
    unvisited = torch.ones(r, dtype=torch.bool, device=ig.device)
    entry("frontier_probe", lambda t: ops.frontier_probe(nbr, unvisited),
          lambda: frontier_probe_plain(nbr, unvisited),
          nbytes=r * k + 2 * r, ops_=r * k,
          library=lambda: torch.any(nbr, dim=1))
    log(phase="kernels.main_path", rows=list(rows.values()), tile_rows=tile,
        frontier_size=int(frontier.sum()))
    return rows


# --- phase 3 -------------------------------------------------------------------

def build_graph(spec: dict):
    t0 = time.perf_counter()
    g = repro_torch.get_dataset(spec["name"], scale=spec["scale"],
                                layout=spec["layout"],
                                ell_cap=spec.get("ell_cap"))
    return g, time.perf_counter() - t0


_peak_bytes = 0
#: kernel -> its ms at each tile at the kron dense shape (the kernels line)
TILE_MS: dict = {}


def reset_peak() -> None:
    """Fold the device's peak memory so far into the run's peak, then
    start a new peak for the next measured run."""
    global _peak_bytes
    _peak_bytes = max(_peak_bytes, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def start_counts() -> None:
    """Zero the kernel launch counts just before a measured run."""
    torch.cuda.synchronize()
    reset_peak()
    _build.KERNEL_LAUNCHES.reset()


def replay_sync_free(ig, alg, window: int, fused: bool,
                     max_iter: int = 10_000):
    """The host-loop Pipe over ``alg``'s step functions, with CUDA's sync
    debug mode at "error" around every step: a step that synchronises with
    the host raises. Only the per-iteration count read runs outside it.
    Returns the finalized colors, the iterations and the mode trace."""
    n = ig.n_nodes
    pol = make_policy("hybrid")
    caps = bucket_capacities(n, ratio=2)
    dense, sparse = alg.step_fns(alg.resolve_fused(fused, default=False))
    colors, aux, wl = alg.init_state(ig)
    torch.cuda.synchronize()
    count, it, trace = n, 0, []
    while count > 0 and it < max_iter:
        use_dense = bool(pol(count, n))
        if not use_dense and wl.capacity > pick_bucket(caps, count):
            wl = resize_items(wl, pick_bucket(caps, count), n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            colors, aux, wl = (dense if use_dense else sparse)(
                ig, colors, aux, wl, window=window)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        count = int(wl.count)
        trace.append("D" if use_dense else "S")
        it += 1
    final, _ = alg.finalize(colors[:n].cpu().numpy())
    return final, it, "".join(trace)


#: (algorithm, fused, kernels its run must launch) of each coloring path
COLORINGS = (("ipgc", False, ("mex_window", "conflict", "compact")),
             ("ipgc", True, ("fused_compact",)),
             ("jpl", None, ("jpl_prio", "compact")),
             ("spec-greedy", None, ("fused_compact",)))


#: the kernels whose sparse-shape rows each ipgc run records
SPARSE_ROWS = {("ipgc", False): ("conflict", "compact"),
               ("ipgc", True): ("fused_compact",)}


def recorder(name: str, n: int) -> Recorder:
    """A recorder of the sparse steps' calls of ``name``: a gathering
    kernel's calls from items blocks, or compact's over fewer than ``n``
    flags (an items block's, not a dense worklist's)."""
    if name == "compact":
        return Recorder(name, lambda a: a[0].shape[0]
                        if a[0].shape[0] < n else None)
    return Recorder(name)


def sparse_row(rec: Recorder, reps: int) -> dict:
    """The recorded kernel at the items block of the sparse steps'
    most-used capacity bucket in the run, as the step handed it over."""
    c, n_calls, (args, kw) = rec.most_used()
    counts = dict(calls_at_this_capacity=n_calls,
                  sparse_calls=sum(rec.calls.values()),
                  calls_by_capacity=rec.calls)
    if rec.name == "compact":
        mask, cap, sentinel, values = args
        row = kernel_row(
            "compact", lambda: ops.compact(*args),
            lambda: compact_plain(mask, cap, sentinel, values),
            c + 4 * int(mask.sum()) + 4 * cap + 4, c,
            dict(rows=c, capacity=cap, **counts),
            lambda: torch.nonzero(mask), reps)
        row["stream_ops"] = stream_ops(lambda: ops.compact(*args))
        return {key: row[key] for key in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "stream_ops")}
    _, _, hub_at, window_at = GATHERING[rec.name]
    shape = dict(rows=c, k=args[2].shape[1],
                 window=None if window_at is None else args[window_at],
                 hubs=hub_at is not None and args[hub_at] is not None,
                 **counts)
    row = gather_row(rec.name, args, kw, shape, reps)
    return {key: row[key] for key in (
        "shape", "max_abs_err", "ms", "tile_rows", "default_ms", "plain_ms",
        "bound_ms", "bound_by", "gather_ms", "tile_gather_ms",
        "hub_gather_ms", "ell_rows_ms")}


def path_phase(g, build_s: float, rows: "dict | None" = None,
               reps: int = 10, results: "dict | None" = None,
               traced: bool = False) -> list[dict]:
    """Every coloring path through ``repro_torch.color`` on ``g``; returns
    the kernel launches of each run. The ipgc and jpl Pipes are replayed
    with the sync check. With ``rows`` (the kernels line's rows), the ipgc
    runs record the sparse steps' calls of ``conflict`` and
    ``fused_compact`` and time each at its most-used capacity bucket. With
    ``results``, each run's ``ColoringResult`` goes there under
    ``(algo, fused)``. With ``traced``, the ipgc two-phase run is repeated
    traced (``traced_check``)."""
    launches = []
    replay_ig = repro_torch.prepare(g)
    for algo, fused, need in COLORINGS:
        alg = get_algorithm(algo)
        names = SPARSE_ROWS.get((algo, fused), ()) if rows is not None else ()
        recs = [recorder(name, g.n_nodes) for name in names]
        start_counts()
        with contextlib.ExitStack() as stack:
            for rec in recs:
                stack.enter_context(rec)
            passes = stack.enter_context(ipgc.LAUNCH_COUNTS.scope())
            t0 = time.perf_counter()
            r = repro_torch.color(g, algo=algo, fused=fused)
            wall = time.perf_counter() - t0
            pass_counts = passes.as_dict()
        counts = _build.KERNEL_LAUNCHES.as_dict()
        for rec in recs:
            rows[rec.name]["sparse"] = sparse_row(rec, reps)
            log(phase="kernels.sparse_shape", name=rec.name,
                **rows[rec.name]["sparse"])
        del recs
        what = f"{g.name} {algo} fused={fused}"
        missing = [k for k in need if counts[k] == 0]
        if missing:
            raise AssertionError(f"{what}: kernels {missing} never launched")
        stats = repro_torch.verify_coloring(g, r.colors, context=what)
        alg.check_invariants(r, g)
        launches.append(counts)
        if results is not None:
            results[(algo, fused)] = r
        log(phase="path", graph=g.name, nodes=g.n_nodes, edges=g.n_edges,
            layout=g.layout.kind, ell_width=g.ell_width,
            build_seconds=build_s, algo=algo, fused=fused,
            iterations=r.iterations, n_colors=r.n_colors,
            mode_trace=r.mode_trace, color_seconds=r.total_seconds,
            call_seconds=wall, kernel_launches=counts,
            logical_passes=pass_counts, verify=stats, invariants=True,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        if algo == "spec-greedy":      # the fused ipgc steps, replayed above
            continue
        window = adaptive_window(g) if alg.uses_window else 128
        colors, iters, trace = replay_sync_free(replay_ig, alg, window, fused)
        if not (np.array_equal(colors, r.colors) and iters == r.iterations
                and trace == r.mode_trace):
            raise AssertionError(f"{what}: the sync-checked replay differs "
                                 "from color()")
        log(phase="path.sync_free_replay", graph=g.name, algo=algo,
            fused=fused, iterations=iters, identical=True)
        if traced and (algo, fused) == ("ipgc", False):
            traced_check(f"host {algo} fused={fused}", r, counts,
                         lambda: repro_torch.color(g, algo=algo, fused=fused,
                                                   trace=True))
    return launches


def bfs_phase(g) -> list[dict]:
    """Hybrid BFS in its three modes from the BFS source: the same levels in
    every mode; returns the kernel launches of each run."""
    launches, first = [], None
    for mode in ("hybrid", "bottomup", "topdown"):
        start_counts()
        t0 = time.perf_counter()
        r = bfs_mod.bfs(g, BFS_SOURCE, mode=mode)
        wall = time.perf_counter() - t0
        counts = _build.KERNEL_LAUNCHES.as_dict()
        if mode != "topdown" and counts["frontier"] == 0:
            raise AssertionError(f"bfs {mode}: frontier never launched")
        if first is None:
            first = r
        elif not (np.array_equal(r.dist, first.dist)
                  and r.levels == first.levels):
            raise AssertionError(f"bfs {mode}: levels differ from hybrid")
        launches.append(counts)
        log(phase="bfs", graph=g.name, nodes=g.n_nodes, source=BFS_SOURCE,
            mode=mode, levels=r.levels, mode_trace=r.mode_trace,
            reached=int((r.dist >= 0).sum()), bfs_seconds=r.total_seconds,
            call_seconds=wall, kernel_launches=counts,
            identical_to_hybrid=True,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return launches


def baselines_phase(g) -> None:
    """The paper's Table III/IV baselines on the card."""
    for name, fn in (("jpl_color", jpl_color), ("vb_color", vb_color)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(g)
        wall = time.perf_counter() - t0
        stats = repro_torch.verify_coloring(g, r.colors, context=name)
        log(phase="baseline", graph=g.name, baseline=name,
            iterations=r.iterations, n_colors=r.n_colors,
            color_seconds=r.total_seconds, call_seconds=wall, verify=stats)


# --- phase 4 -------------------------------------------------------------------

#: (algorithm, fused, exchanges per iteration) of each distributed run
DIST_RUNS = (("ipgc", True, 1), ("ipgc", False, 2), ("spec-greedy", None, 1),
             ("jpl", None, 1))
#: rounds the kron S=4 jpl run stops at (its full depth is 815 rounds,
#: 77 s, which the script's other phases need): a partial JPL coloring
#: is final where it is set, so it is verified without completeness
DIST_ROUND_CAP = {"jpl": 64}
#: the packed exchanges each boundary run of the distributed Pipe takes,
#: held against the dense-exchange run of the same coloring
BOUNDARY_EXCHANGES = ("boundary", "auto")
#: iterations of a boundary run replayed under the sync check on kron
#: (its full depth is ~300 iterations, 9 s at S=4); europe's runs are
#: replayed whole
BOUNDARY_REPLAY_ITERS = 40


def dist_kernels(algo: str, fused) -> tuple:
    """The kernels a distributed run of ``algo`` must launch."""
    if algo == "jpl":
        return ("jpl_prio", "compact")
    if get_algorithm(algo).resolve_fused(fused, default=True):
        return ("fused_step", "compact")
    return ("mex_window", "conflict", "compact")


def replay_dist_sync_free(ig, alg, mesh, window: int, fused, new_of_old,
                          n_orig: int, max_iter: int = 10_000):
    """The distributed Pipe over ``alg``'s distributed steps on the
    prepared partitioned graph ``ig``, with CUDA's sync debug mode at
    "error" around every step. Only the per-iteration count read (and the
    bucket resize, as in ``replay_sync_free``) runs outside it. Returns
    the finalized colors in the original labeling, the iterations and the
    mode trace."""
    n = ig.n_nodes
    block = n // len(mesh)
    pol = make_policy("hybrid")
    caps = bucket_capacities(block, ratio=2)
    dense, sparse = alg.make_dist_steps(
        ig, mesh, window=window, fused=alg.resolve_fused(fused, default=True))
    colors, aux, wl = dist.shard_state(mesh, *alg.init_state(ig))
    torch.cuda.synchronize()
    count, it, trace = n, 0, []
    while count > 0 and it < max_iter:
        use_dense = bool(pol(count, n))
        if not use_dense:
            cap = pick_bucket(caps, min(count, block))
            if wl.capacity > cap:
                wl = dist.resize_worklist(wl, cap, n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            colors, aux, wl = (dense if use_dense else sparse)(colors, aux,
                                                               wl)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        count = int(wl.count)
        trace.append("D" if use_dense else "S")
        it += 1
    full = colors[0][:n].cpu().numpy()
    final, _ = alg.finalize(full[new_of_old[:n_orig]])
    return final, it, "".join(trace)


def dist_entry(sess, mesh, alg, fused: bool, exchange: str):
    """The session's cached distributed build of ``alg`` on ``mesh``:
    ``(ig, window, steps, binfo)``, the steps a run just used."""
    for key, entry in sess.cache.items():
        if (key[0] == "dist" and key[2] == mesh and key[5] == fused
                and key[7] == alg and key[-1] == exchange):
            return entry
    raise AssertionError(f"no cached dist build of {alg.name} {exchange}")


def replay_boundary_sync_free(entry, alg, mesh, run, relabel, n_orig: int,
                              limit: int) -> tuple[int, bool]:
    """The distributed Pipe with a packed exchange over the steps ``run``
    used (``entry``: the session's build), with CUDA's sync debug mode at
    "error" around every step; only the iteration's one read (the count
    and the exchange stats together) runs outside it. Up to ``limit``
    iterations, whose counts, mode trace and exchange trace must be the
    run's; a replay that reaches the end must give the run's colors.
    Returns the iterations replayed and whether the replay was whole."""
    ig, _, (dense, sparse), binfo = entry
    n, s_count = ig.n_nodes, len(mesh)
    block = n // s_count
    pol = make_policy("hybrid")
    caps = bucket_capacities(block, ratio=2)
    bcaps = list(binfo.capacities)
    epi = dense.exchanges_per_iter
    colors, aux, wl = dist.shard_state(mesh, *alg.init_state(ig))
    colors = dist.shard_views(colors)
    torch.cuda.synchronize()
    count, it, prev_mx = n, 0, block
    trace, xtrace, counts = [], [], []
    while count > 0 and it < limit:
        use_dense = bool(pol(count, n))
        counts.append(count)
        if use_dense:
            step = dense
            bcap = pick_bucket(bcaps, min(block, max(8, 2 * prev_mx)))
        else:
            cap = pick_bucket(caps, min(count, block))
            if wl.capacity > cap:
                wl = dist.resize_worklist(wl, cap, n)
            step = sparse
            bcap = pick_bucket(bcaps, min(cap, block, max(8, 2 * prev_mx)))
        torch.cuda.set_sync_debug_mode("error")
        try:
            colors, aux, wl, xs = step(colors, aux, wl, bcap=bcap)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        count, npk, prev_mx = torch.cat([wl.count.view(1), xs]).tolist()
        trace.append("D" if use_dense else "S")
        xtrace.append("b" if npk == epi else ("d" if npk == 0 else "m"))
        it += 1
    same = (counts == run.counts[:it] and "".join(trace) == run.mode_trace[:it]
            and "".join(xtrace) == run.exchange_trace[:it])
    whole = count == 0
    if whole:
        full = dist.views_to_colors(colors, s_count, n)
        final, _ = alg.finalize(full[relabel[:n_orig]])
        same = same and it == run.iterations and np.array_equal(final,
                                                                 run.colors)
    if not same:
        raise AssertionError(f"dist {alg.name} {run.exchange_trace[:8]}...: "
                             "the sync-checked boundary replay differs from "
                             "the run")
    return it, whole


def dist_phase(g, devices, runs, record: bool = False,
               reps: int = 10, boundary=(),
               traced: bool = False) -> tuple[list[dict], dict]:
    """The distributed Pipe on ``g`` for each of ``runs``: over
    ``devices`` through ``color_distributed``, or (None) through
    ``color(mode="dist-hybrid")`` with one shard per visible card. Every
    run is verified, counted and replayed with the sync check. With
    ``record`` the ipgc fused run records the sparse steps' ``fused_step``
    calls and times the kernel at its most-used capacity bucket. Each run
    in ``boundary`` is followed by its boundary and auto exchanges
    (``boundary_phase``; with ``traced``, a traced auto run of ipgc
    fused too). Returns
    the kernel launches of each run, and the prepared partitioned graph,
    the mesh, the window and that sparse entry for the ``fused_step``
    row."""
    sess = default_session()
    mesh = dist.resolve_mesh(None, devices, sess.device)
    t0 = time.perf_counter()
    g2, relabel = sess.partition(g, len(mesh))
    partition_s = time.perf_counter() - t0
    replay_ig = repro_torch.prepare(g2)
    launches, sparse = [], None
    for algo, fused, per_iter in runs:
        alg = get_algorithm(algo)
        rec = (Recorder("fused_step")
               if record and (algo, fused) == ("ipgc", True) else None)
        max_iter = 10_000
        if devices is not None:
            max_iter = DIST_ROUND_CAP.get(algo, max_iter)
        start_counts()
        with (rec or contextlib.nullcontext()), \
                ipgc.LAUNCH_COUNTS.scope() as passes, \
                dist.EXCHANGE_COUNTS.scope() as exchanges:
            t0 = time.perf_counter()
            r = run_dist(g, devices, algo=algo, fused=fused,
                         max_iter=max_iter)
            wall = time.perf_counter() - t0
            pass_counts = passes.as_dict()
            n_exchanges = exchanges["color_psum"]
        counts = _build.KERNEL_LAUNCHES.as_dict()
        if rec is not None and rec.calls:
            sparse = sparse_row(rec, reps)
            sparse["shape"]["shards"] = len(mesh)
            log(phase="kernels.sparse_shape", name="fused_step", graph=g.name,
                **sparse)
        del rec
        what = f"{g.name} dist S={len(mesh)} {algo} fused={fused}"
        missing = [k for k in dist_kernels(algo, fused) if counts[k] == 0]
        if missing:
            raise AssertionError(f"{what}: kernels {missing} never launched")
        if n_exchanges != per_iter * r.iterations:
            raise AssertionError(f"{what}: {n_exchanges} exchanges in "
                                 f"{r.iterations} iterations")
        stats = repro_torch.verify_coloring(
            g, r.colors, context=what,
            require_complete=r.iterations < max_iter)
        alg.check_invariants(r, g)
        launches.append(counts)
        log(phase="dist", graph=g.name, max_iter=max_iter, nodes=g.n_nodes, edges=g.n_edges,
            shards=len(mesh), devices=[str(d) for d in mesh],
            partition_seconds=partition_s, padded_nodes=g2.n_nodes,
            algo=algo, fused=fused, iterations=r.iterations,
            n_colors=r.n_colors, mode_trace=r.mode_trace,
            color_seconds=r.total_seconds, call_seconds=wall,
            exchanges=n_exchanges, exchanges_per_iteration=per_iter,
            exchange_bytes=sum(r.exchange_bytes), kernel_launches=counts,
            logical_passes=pass_counts, verify=stats, invariants=True,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        if algo != "spec-greedy":      # its steps are ipgc fused's
            window = adaptive_window(g2) if alg.uses_window else 128
            colors, iters, trace = replay_dist_sync_free(
                replay_ig, alg, mesh, window, fused, relabel, g.n_nodes,
                max_iter)
            if not (np.array_equal(colors, r.colors)
                    and iters == r.iterations and trace == r.mode_trace):
                raise AssertionError(f"{what}: the sync-checked replay "
                                     "differs from the run")
            log(phase="dist.sync_free_replay", graph=g.name,
                shards=len(mesh), algo=algo, fused=fused, iterations=iters,
                identical=True)
        if (algo, fused, per_iter) in boundary:
            launches += boundary_phase(
                g, devices, mesh, relabel, algo, fused, per_iter, r,
                max_iter, traced and (algo, fused) == ("ipgc", True))
        # free this coloring's prepared graphs (one per exchange) before
        # the next: europe's are 1.6 GB of ELL each
        for key in [k for k in sess.cache if k[0] == "dist" and k[7] == alg]:
            del sess.cache[key]
        torch.cuda.empty_cache()
    return launches, dict(ig=replay_ig, mesh=mesh, window=adaptive_window(g2),
                          sparse=sparse)


def run_dist(g, devices, **kw):
    """One distributed run: over ``devices`` through
    ``color_distributed``, or (None) through ``color(mode="dist-hybrid")``
    with one shard per visible card; ``trace`` goes through ``color``."""
    if devices is None or kw.get("trace"):
        return repro_torch.color(g, mode="dist-hybrid", devices=devices, **kw)
    return repro_torch.color_distributed(g, devices=devices, **kw)


def boundary_phase(g, devices, mesh, relabel, algo: str, fused, per_iter: int,
                   dense, max_iter: int, traced: bool) -> list[dict]:
    """The boundary and auto exchanges of one coloring: each run equal to
    the dense-exchange run ``dense`` in colors, iterations and mode trace,
    every publish counted once as ``boundary_pack`` and once as
    ``dense_swap`` (both paths computed, one selected on the device), the
    kernels of the coloring and ``compact`` launched, the ledger's bytes
    logged against the dense run's, and the run replayed under the sync
    check (its first ``BOUNDARY_REPLAY_ITERS`` iterations where it is
    longer). With ``traced``, the auto run is repeated traced: equal to
    the untraced run, with the same kernel launches. Returns the launches
    of each run."""
    alg = get_algorithm(algo)
    sess = default_session()
    launches = []
    what = f"{g.name} dist S={len(mesh)} {algo} fused={fused}"
    for exchange in BOUNDARY_EXCHANGES:
        start_counts()
        with dist.EXCHANGE_COUNTS.scope() as ec:
            t0 = time.perf_counter()
            r = run_dist(g, devices, algo=algo, fused=fused,
                         max_iter=max_iter, exchange=exchange)
            wall = time.perf_counter() - t0
            exchanges = ec.as_dict()
        counts = _build.KERNEL_LAUNCHES.as_dict()
        need = dist_kernels(algo, fused)
        missing = [k for k in need if counts[k] == 0]
        publishes = per_iter * r.iterations
        if missing:
            raise AssertionError(f"{what} {exchange}: kernels {missing} "
                                 "never launched")
        if exchanges != {"color_psum": 0, "boundary_pack": publishes,
                         "dense_swap": publishes}:
            raise AssertionError(f"{what} {exchange}: exchanges "
                                 f"{exchanges} in {r.iterations} iterations")
        if not (np.array_equal(r.colors, dense.colors)
                and (r.n_colors, r.iterations, r.mode_trace, r.counts)
                == (dense.n_colors, dense.iterations, dense.mode_trace,
                    dense.counts)):
            raise AssertionError(f"{what} {exchange}: differs from the dense "
                                 "exchange")
        launches.append(counts)
        x = r.exchange_trace
        log(phase="dist.boundary", graph=g.name, shards=len(mesh), algo=algo,
            fused=fused, exchange=exchange, iterations=r.iterations,
            n_colors=r.n_colors, identical_to_dense=True,
            exchange_trace={m: x.count(m) for m in "bdm"},
            ledger_bytes=sum(r.exchange_bytes),
            dense_ledger_bytes=sum(dense.exchange_bytes),
            color_seconds=r.total_seconds,
            dense_color_seconds=dense.total_seconds, call_seconds=wall,
            exchanges=exchanges, kernel_launches=counts,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        resolved = alg.resolve_fused(fused, default=True)
        iters, whole = replay_boundary_sync_free(
            dist_entry(sess, mesh, alg, resolved, exchange), alg, mesh, r,
            relabel, g.n_nodes, BOUNDARY_REPLAY_ITERS
            if r.iterations > 4 * BOUNDARY_REPLAY_ITERS else r.iterations)
        log(phase="dist.boundary.sync_free_replay", graph=g.name,
            shards=len(mesh), algo=algo, fused=fused, exchange=exchange,
            iterations=iters, whole=whole, identical=True)
        if traced and exchange == "auto":
            traced_check(f"dist S={len(mesh)} auto {algo} fused={fused}", r,
                         counts, lambda: run_dist(
                             g, devices, algo=algo, fused=fused,
                             max_iter=max_iter, exchange=exchange,
                             trace=True))
    return launches


def traced_check(what: str, plain, plain_counts: dict, traced_run,
                 replayed: "dict | None" = None) -> None:
    """Run ``traced_run()`` (a traced run: a ``RunReport``) with the kernel
    launch counts zeroed: it must equal the untraced run ``plain`` and
    launch what it launched (``plain_counts``; with ``replayed``, the
    replayed launches of an outlined run too). Logs both runs' seconds."""
    start_counts()
    with chunk_mod.REPLAYED_LAUNCHES.scope() as rl:
        rep = traced_run()
        got_replayed = rl.as_dict()
    counts = _build.KERNEL_LAUNCHES.as_dict()
    if not (np.array_equal(rep.colors, plain.colors)
            and (rep.n_colors, rep.iterations, rep.mode_trace, rep.counts)
            == (plain.n_colors, plain.iterations, plain.mode_trace,
                plain.counts)):
        raise AssertionError(f"traced {what}: differs from the untraced run")
    if counts != plain_counts or (replayed is not None
                                  and got_replayed != replayed):
        raise AssertionError(f"traced {what}: launched {counts} "
                             f"{got_replayed}, untraced {plain_counts} "
                             f"{replayed}")
    spans = {name: len(rep.trace.find(name)) for name in (
        "session.prepare", "session.iter", "session.chunk", "obs.profile")}
    log(phase="traced", what=what, regime=rep.regime,
        iterations=rep.iterations, host_dispatches=rep.host_dispatches,
        traced_seconds=rep.total_seconds, untraced_seconds=plain.total_seconds,
        traced_over_untraced=rep.total_seconds / plain.total_seconds,
        profile_seconds=rep.trace.find("obs.profile")[0].seconds,
        same_launches=True, spans=spans,
        launches_per_iter=rep.launches["per_iter"],
        exchanges=None if rep.exchanges is None else {
            k: rep.exchanges[k] for k in ("per_iter", "total",
                                          "total_bytes")},
        timing=rep.timing)


def fused_step_row(ig, mesh, window: int, sparse: "dict | None",
                   reps: int = 10) -> dict:
    """The ``fused_step`` kernel at the dense shape of the distributed
    Pipe's first shard: the operands ``core/distributed.py`` hands it two
    fused dense iterations into a run (recorded), against the gathers its
    earlier signature needed; ``sparse`` is its entry at the sparse steps'
    most-used capacity bucket."""
    dense, _ = get_algorithm("ipgc").make_dist_steps(ig, mesh, window=window,
                                                     fused=True)
    colors, base, wl = dist.shard_state(mesh, *init_ipgc_state(ig))
    for _ in range(2):
        colors, base, wl = dense(colors, base, wl)
    with Recorder("fused_step", all_rows) as rec:
        dense(colors, base, wl)
    r, _, (args, kw) = rec.most_used()
    row = gather_row("fused_step", args, kw,
                     dict(rows=r, k=args[2].shape[1], window=args[12],
                          hubs=args[9] is not None, shards=len(mesh)), reps)
    row["sparse"] = sparse
    return row


# --- phase 6 -------------------------------------------------------------------

#: the names of this port's CUDA kernels, as the profiler reports them
OWN_KERNELS = ("mex_window_kernel", "conflict_kernel", "scan_kernel",
               "fused_rows_kernel", "jpl_extrema_kernel", "frontier_kernel",
               "fused_step_kernel")


def chunk_runners(g, algo: str) -> list:
    """The chunk runners the default session keeps for ``g`` prepared for
    ``algo`` (in the prep entry: ``(g, ig, window, runners)``)."""
    alg = get_algorithm(algo)
    return [r for key, entry in default_session().cache.items()
            if key[0] == "prep" and entry[0] is g and key[2] == alg
            for r in entry[3].values()]


def replay_sync_checked(g, algo: str) -> int:
    """Replay every captured trip of ``g``'s runners once more with CUDA's
    sync debug mode at "error" (after the run: the trips change nothing
    but the counters, which the next run resets). Returns the replays."""
    replays = 0
    for runner in chunk_runners(g, algo):
        for trip in runner.trips.values():
            torch.cuda.set_sync_debug_mode("error")
            try:
                trip.graph.replay()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            replays += 1
    torch.cuda.synchronize()
    return replays


def outlined_phase(g, host: dict, traced: bool = False) -> dict:
    """The outlined regime on ``g`` for every coloring, cold and warm, each
    run equal to its host loop ``host[(algo, fused)]``; returns the warm
    seconds and the replayed launches per coloring. With ``traced``, the
    ipgc two-phase warm run is repeated traced (``traced_check``)."""
    caps = bucket_capacities(g.n_nodes, ratio=2)
    out = {}
    for algo, fused, need in COLORINGS:
        alg = get_algorithm(algo)
        want = host[(algo, fused)]
        what = f"{g.name} outlined {algo} fused={fused}"
        for run in ("cold", "warm"):
            start_counts()
            with chunk_mod.REPLAYED_LAUNCHES.scope() as rl, \
                    chunk_mod.CHUNK_COUNTS.scope() as cc:
                t0 = time.perf_counter()
                r = repro_torch.color(g, algo=algo, fused=fused, outline=True)
                wall = time.perf_counter() - t0
                replayed, counts = rl.as_dict(), cc.as_dict()
            wrapper = _build.KERNEL_LAUNCHES.as_dict()
            if not (np.array_equal(r.colors, want.colors)
                    and (r.n_colors, r.iterations, r.mode_trace)
                    == (want.n_colors, want.iterations, want.mode_trace)):
                raise AssertionError(f"{what} ({run}): differs from the host "
                                     "loop")
            if r.host_dispatches > len(caps) + 1:
                raise AssertionError(f"{what}: {r.host_dispatches} host "
                                     f"dispatches for {len(caps)} buckets")
            if counts["reads"] != r.iterations:
                raise AssertionError(f"{what}: {counts['reads']} counter "
                                     f"reads in {r.iterations} iterations")
            missing = [k for k in need if replayed[k] == 0
                       or (run == "cold" and wrapper[k] == 0)]
            if missing:
                raise AssertionError(f"{what} ({run}): kernels {missing} "
                                     "never launched")
            if run == "warm" and counts["graphs"]:
                raise AssertionError(f"{what}: the warm run captured "
                                     f"{counts['graphs']} graphs")
            # the warm run's colors equal the cold run's, verified here
            if run == "cold":
                stats = repro_torch.verify_coloring(g, r.colors,
                                                    context=what)
            alg.check_invariants(r, g)
            log(phase="outlined", graph=g.name, nodes=g.n_nodes, algo=algo,
                fused=fused, run=run, iterations=r.iterations,
                n_colors=r.n_colors, host_dispatches=r.host_dispatches,
                buckets=len(caps), counter_reads=counts["reads"],
                graphs_captured=counts["graphs"],
                capture_seconds=counts["capture_us"] / 1e6,
                color_seconds=r.total_seconds, call_seconds=wall,
                host_loop_seconds=want.total_seconds,
                replayed_launches={k: v for k, v in replayed.items() if v},
                wrapper_launches={k: v for k, v in wrapper.items() if v},
                verify=stats, identical_to_host_loop=True,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        if traced and (algo, fused) == ("ipgc", False):
            traced_check(f"outlined warm {algo} fused={fused}", r, wrapper,
                         lambda: repro_torch.color(g, algo=algo, fused=fused,
                                                   outline=True, trace=True),
                         replayed=replayed)
        n_trips = replay_sync_checked(g, algo)
        log(phase="outlined.sync_checked_replay", graph=g.name, algo=algo,
            fused=fused, graphs_replayed=n_trips, clean=True)
        out[(algo, fused)] = dict(seconds=r.total_seconds, launches=replayed)
        for runner in chunk_runners(g, algo):
            runner.trips.clear()        # free the pools before the next
        torch.cuda.empty_cache()
    return out


#: coarse classes of device operations, by a substring of their names
OP_CLASSES = (("own kernel", OWN_KERNELS), ("index_put (scatter)",
              ("index_put",)), ("scatter/reduce", ("scatter", "reduce")),
              ("index (gather)", ("index_elementwise", "index_kernel")),
              ("copy", ("copy",)), ("memset", ("memset",)),
              ("memcpy", ("memcpy",)), ("scan", ("scan", "cumsum")))


def op_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in OP_CLASSES
                 if any(k.lower() in low for k in keys)), "elementwise/other")


def trace_summary(prof, iterations: int) -> dict:
    """A whole-run profiler trace, summarised: the device's busy share of
    the run (the union of its operations' intervals over the span of the
    ``coloring_run`` range), device time by op name (this port's kernels,
    the rest), and device operations, kernels and host launch calls per
    iteration."""
    events = prof.events()
    run = next(e for e in events if e.name == "coloring_run"
               and e.device_type == torch.autograd.DeviceType.CPU)
    lo, hi = run.time_range.start, run.time_range.end
    # the device timeline also carries the range itself as an annotation
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "coloring_run"
           and not getattr(e, "is_user_annotation", False)]
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in dev)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    own = {k: v for k, v in by_name.items()
           if any(n in k for n in OWN_KERNELS)}
    rest = {k: v for k, v in by_name.items() if k not in own}
    kernels = [e for e in dev if not any(
        w in e.name.lower() for w in ("memset", "memcpy"))]
    host_calls = {}
    for e in events:
        if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cudaMemsetAsync",
                      "cudaMemcpyAsync", "cudaGraphLaunch"):
            host_calls[e.name] = host_calls.get(e.name, 0) + 1
    by_class: dict = {}
    for name, (t, _) in by_name.items():
        c = op_class(name)
        by_class[c] = by_class.get(c, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    it = max(iterations, 1)
    return dict(
        run_us=hi - lo, device_busy_us=busy,
        device_busy_share=busy / max(hi - lo, 1e-9),
        own_kernels_us=sum(v[0] for v in own.values()),
        other_device_us=sum(v[0] for v in rest.values()),
        device_ops=len(dev), device_ops_per_iteration=len(dev) / it,
        kernels_per_iteration=len(kernels) / it,
        host_launch_calls=host_calls,
        host_launch_calls_per_iteration=sum(host_calls.values()) / it,
        device_us_by_class=by_class,
        top_device_ops=[[k[:90], round(v[0], 1), v[1]] for k, v in top])


def fused_rule(outlined: dict) -> None:
    """Which ipgc family ran faster outlined (warm) on each graph: the
    fused one takes ``fused=None`` on CUDA where it won on every graph."""
    by = {name: {fam: o[("ipgc", fam)]["seconds"] for fam in (False, True)}
          for name, o in outlined.items()}
    log(phase="outlined.fused_rule", warm_seconds={
        name: {"two_phase": v[False], "fused": v[True]}
        for name, v in by.items()},
        fused_faster_everywhere=all(v[True] < v[False] for v in by.values()),
        rule_in_code=repro_torch.exec.session.OUTLINED_FUSED["cuda"])


def profile_phase(g) -> None:
    """Whole-run traces of kron ipgc two-phase in each regime: the host
    loop, then the outlined regime warm (its trips captured by a run just
    before the trace)."""
    repro_torch.color(g, fused=False, outline=True)
    for regime in ("host", "outlined"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("coloring_run"):
                r = repro_torch.color(g, fused=False,
                                      outline=regime == "outlined")
            torch.cuda.synchronize()
        log(phase="profile", graph=g.name, algo="ipgc", fused=False,
            regime=regime, iterations=r.iterations,
            color_seconds=r.total_seconds,
            **trace_summary(prof, r.iterations))
        del prof


# --- phase 5 -------------------------------------------------------------------

def card_vs_cpu_phase() -> None:
    g, _ = build_graph(SMALL)
    for algo, fused, _ in COLORINGS:
        a = repro_torch.color(g, algo=algo, fused=fused)
        b = repro_torch.color(g, algo=algo, fused=fused, device="cpu")
        same = (np.array_equal(a.colors, b.colors)
                and (a.n_colors, a.iterations, a.mode_trace, a.counts)
                == (b.n_colors, b.iterations, b.mode_trace, b.counts))
        if not same:
            raise AssertionError(f"card and CPU colorings differ ({algo}, "
                                 f"fused={fused})")
        log(phase="card_vs_cpu", graph=g.name, nodes=g.n_nodes, algo=algo,
            fused=fused, iterations=a.iterations, n_colors=a.n_colors,
            identical=True)
    # the outlined regime: card = CPU in every field but the times, and
    # = the card's host loop in colors, colors used, iterations and trace
    fields = [f.name for f in dataclasses.fields(repro_torch.ColoringResult)
              if f.name not in ("colors", "tti", "total_seconds")]
    for algo, fused, _ in COLORINGS:
        a = repro_torch.color(g, algo=algo, fused=fused, outline=True)
        b = repro_torch.color(g, algo=algo, fused=fused, outline=True,
                              device="cpu")
        h = repro_torch.color(g, algo=algo, fused=fused, outline=False)
        if not (np.array_equal(a.colors, b.colors)
                and all(getattr(a, f) == getattr(b, f) for f in fields)
                and np.array_equal(a.colors, h.colors)
                and (a.n_colors, a.iterations, a.mode_trace)
                == (h.n_colors, h.iterations, h.mode_trace)):
            raise AssertionError(f"outlined {algo} fused={fused}: the card, "
                                 "the CPU and the card's host loop differ")
        log(phase="card_vs_cpu.outlined", graph=g.name, algo=algo,
            fused=fused, iterations=a.iterations,
            host_dispatches=a.host_dispatches, counts=a.counts,
            identical_cpu=True, identical_host_loop=True)
    oracle = bfs_mod.bfs_reference(g, BFS_SOURCE)
    for mode in ("hybrid", "bottomup", "topdown"):
        a = bfs_mod.bfs(g, BFS_SOURCE, mode=mode)
        b = bfs_mod.bfs(g, BFS_SOURCE, mode=mode, device="cpu")
        if not (np.array_equal(a.dist, b.dist)
                and (a.levels, a.mode_trace) == (b.levels, b.mode_trace)
                and np.array_equal(a.dist, oracle)):
            raise AssertionError(f"bfs {mode}: card, CPU and the host "
                                 "oracle differ")
        log(phase="card_vs_cpu.bfs", graph=g.name, mode=mode,
            levels=a.levels, mode_trace=a.mode_trace,
            reached=int((a.dist >= 0).sum()), identical=True)
    # the distributed Pipe: card, CPU and the host engine on the same
    # partitioned graph (ipgc fused at 1 and 4 shards, every run at 4)
    card = torch.device("cuda")
    for s_count, dist_runs in ((1, DIST_RUNS[:1]), (KRON_SHARDS, DIST_RUNS)):
        g2, relabel = default_session().partition(g, s_count)
        for algo, fused, _ in dist_runs:
            a = repro_torch.color_distributed(g, devices=[card] * s_count,
                                              algo=algo, fused=fused)
            b = repro_torch.color_distributed(g, devices=["cpu"] * s_count,
                                              algo=algo, fused=fused)
            h = repro_torch.color(g2, algo=algo,
                                  fused=True if fused is None else fused)
            h_colors = h.colors[relabel[:g.n_nodes]]
            for other, colors in ((b, b.colors), (h, h_colors)):
                if not (np.array_equal(a.colors, colors)
                        and (a.iterations, a.mode_trace, a.counts)
                        == (other.iterations, other.mode_trace,
                            other.counts)):
                    raise AssertionError(
                        f"dist {algo} fused={fused} S={s_count}: the card, "
                        "the CPU and the host engine differ")
            log(phase="card_vs_cpu.dist", graph=g.name, shards=s_count,
                algo=algo, fused=fused, iterations=a.iterations,
                n_colors=a.n_colors, identical_cpu_and_host_engine=True)
    # the auto exchange of ipgc two-phase at 4 shards (its trace holds
    # packed, dense-swap and mixed iterations): card = CPU in every field
    # but the times (the exchange trace and bytes included), = the dense
    # exchange
    for algo, fused, _ in DIST_RUNS[1:2]:
        dense = repro_torch.color_distributed(
            g, devices=[card] * KRON_SHARDS, algo=algo, fused=fused)
        for exchange in BOUNDARY_EXCHANGES[1:]:
            a, b = (repro_torch.color_distributed(
                g, devices=[d] * KRON_SHARDS, algo=algo, fused=fused,
                exchange=exchange) for d in (card, "cpu"))
            if not (np.array_equal(a.colors, b.colors)
                    and all(getattr(a, f) == getattr(b, f) for f in fields)
                    and np.array_equal(a.colors, dense.colors)
                    and (a.iterations, a.mode_trace)
                    == (dense.iterations, dense.mode_trace)):
                raise AssertionError(
                    f"dist {algo} fused={fused} {exchange}: the card, the "
                    "CPU and the dense exchange differ")
            log(phase="card_vs_cpu.dist_boundary", graph=g.name,
                shards=KRON_SHARDS, algo=algo, fused=fused,
                exchange=exchange, iterations=a.iterations,
                exchange_trace=a.exchange_trace,
                ledger_bytes=sum(a.exchange_bytes),
                dense_ledger_bytes=sum(dense.exchange_bytes),
                identical_cpu_and_dense=True)


# --- phase 7 -------------------------------------------------------------------

#: the serving traffic mix of ``benchmarks/bench_engine_modes.py``
#: (``STREAM_MIX``; names repeat to weight the draw): road and hub graphs
#: are the bulk of the traffic, web uncommon and rgg rare
STREAM_MIX = ("europe_osm_s", "circuit5M_s", "europe_osm_s", "circuit5M_s",
              "europe_osm_s", "circuit5M_s", "indochina-2004_s",
              "rgg_n_2_24_s0_s")
#: the heavy-tail request mix of phase 7: 16 requests, most near 65K
#: nodes, a few near 1M (``get_dataset_batch(heavy_tail=)``)
MIX = dict(count=16, names=STREAM_MIX, min_nodes=65_536,
           max_nodes=1_048_576, alpha=1.5)
MIX_SEED = 7
#: the mix's layout: ell-tail at the historical ELL width of 128, as
#: phase 3's kron. Uncapped (``UNCAPPED_LAYOUT``, the reference's serving
#: layout), the auto width of the hub graphs (circuit5M_s: 1,560 to 3,480)
#: pads every lane of their rung to it, and the two-phase and jpl
#: run_batch of the 16 requests need more than the card's 80 GB
#: (``uncapped_phase``)
MIX_LAYOUT = dict(layout="ell-tail", ell_cap=128)
UNCAPPED_LAYOUT = dict(layout="ell-tail")
#: the card-vs-CPU batch of phase 7
SMALL_ROAD = dict(name="europe_osm_s", scale=0.02, layout="auto")


def mix_phase() -> list:
    """The heavy-tail request mix, one graph at a time (so each build is
    timed), then checked to be what ``get_dataset_batch(heavy_tail=)``
    returns for the same seed."""
    graphs = []
    for name, over in heavy_tail_requests(seed=MIX_SEED, **MIX):
        t0 = time.perf_counter()
        (g,) = get_dataset_batch([(name, over)], seed=MIX_SEED,
                                 **MIX_LAYOUT)
        log(phase="batch.request", graph=g.name, scale=over["scale"],
            nodes=g.n_nodes, edges=g.n_edges, layout=g.layout.kind,
            ell_width=g.ell_width, build_seconds=time.perf_counter() - t0)
        graphs.append(g)
    again = get_dataset_batch(heavy_tail=dict(MIX), seed=MIX_SEED,
                              **MIX_LAYOUT)
    if [id(g) for g in again] != [id(g) for g in graphs]:
        raise AssertionError("get_dataset_batch(heavy_tail=) built another "
                             "mix")
    return graphs


def same_coloring(a, b) -> bool:
    """Colors, colors used, iterations and mode trace."""
    return (np.array_equal(a.colors, b.colors)
            and (a.n_colors, a.iterations, a.mode_trace)
            == (b.n_colors, b.iterations, b.mode_trace))


def solo_phase(sess, graphs, layout: str = "ell_cap=128") -> dict:
    """Each graph of the mix alone (``Session.run``, phase 3's specs), for
    each coloring, verified; the sum of their seconds is the sequential
    baseline."""
    solo = {}
    for algo, fused, _ in COLORINGS:
        spec = ExecutionSpec(regime="host", algo=algo, fused=fused)
        res = []
        for g in graphs:
            r = sess.run(spec, g)
            repro_torch.verify_coloring(g, r.colors,
                                        context=f"{g.name} {algo} solo")
            get_algorithm(algo).check_invariants(r, g)
            res.append(r)
        solo[(algo, fused)] = res
        log(phase="batch.solo", algo=algo, fused=fused, layout=layout,
            graphs=len(graphs),
            seconds=sum(r.total_seconds for r in res),
            iterations=[r.iterations for r in res],
            n_colors=[r.n_colors for r in res])
    return solo


def lane_groups(sess) -> list:
    """``(graphs, LaneState)`` of the run_batch lane groups in ``sess``."""
    return [entry for key, entry in sess.cache.items() if key[0] == "stack"]


def lane_step(algo: str, fused):
    """The dense step a lane group of this coloring runs."""
    alg = get_algorithm(algo)
    return alg.lane_step(alg.resolve_fused(fused, default=False))


def group_summary(graphs, st, step) -> dict:
    """A run_batch lane group after its run: its shape class, lanes,
    trips (= counter reads), captures, the launches its replays made, the
    bytes it owns and the bytes ``batch.group_bytes`` reckoned for it."""
    trips = int(st.host[batch_mod.IT].max())
    replayed: dict = {}
    for trip in st.trips.values():
        for k, v in trip.launches.items():
            replayed[k] = replayed.get(k, 0) + v * trips
    return dict(n_pad=st.sc.n_pad, k_pad=st.sc.k_pad, t_pad=st.sc.t_pad,
                nh_pad=st.sc.nh_pad, window=st.sc.window, b=st.b,
                real_lanes=len(graphs), trips=trips, graphs_captured=len(
                    st.trips), owned_gb=st.nbytes / 2**30,
                reckoned_gb={k: v / 2**30 for k, v in batch_mod.group_bytes(
                    st.sc, st.b, st.alg, step).items()},
                replayed_launches=replayed)


#: the kernels of the lane trips, by wrapper, and their plain versions
LANE_PLAIN = {"mex_window": mex_window_plain,
              "conflict": conflict_rows_plain,
              "compact": compact_plain,
              "fused_compact": fused_compact_rows_plain,
              "jpl_extrema": jpl_extrema_plain}
#: every lane-trip call held against its plain version: (kernel, rows)
LANE_CHECKS: list = []


def lane_call_row(name: str, args, kw, what: str, rows: int,
                  reps: int = 5) -> dict:
    """One recorded call of a lane trip's kernel (on a group of ``rows``
    rows), made again through the kernel and through its plain version:
    exactly equal; both timed."""
    def kernel():
        return getattr(ops, name)(*args, **kw)

    def plain():
        return LANE_PLAIN[name](*args, **untiled(kw))

    err = assert_equal(kernel(), plain(), f"{name} on {what}")
    LANE_CHECKS.append((name, rows))
    return dict(kernel=name, shapes=[list(a.shape) for a in args
                                     if torch.is_tensor(a)],
                max_abs_err=err, equal=True, ms=cuda_ms(kernel, reps),
                plain_ms=cuda_ms(plain, 2))


def load_lanes(st, spec: ExecutionSpec) -> None:
    """Load a fresh run into every lane of ``st``, as run_batch does."""
    pol = make_policy(spec.mode, spec.h)
    for lane, ig in enumerate(st.lanes):
        rn = 0 if ig is None else ig.n_nodes
        st.reset_lane(lane, rn, device_threshold(pol, rn) if rn else 0,
                      spec.max_iter)


def lane_trip_kernels(st, step, what: str, need, trips: int = 2) -> dict:
    """The kernels of a trip of lane group ``st`` under ``step``, held
    against their plain versions on the operands that trip hands them, at
    the group's real size. The trip is the group's own
    (``LaneState._trip``, the code its captured graph holds), run eagerly
    on a copy of its state ``trips`` trips into the run its lanes were
    last loaded with, every kernel's wrapper recorded; each recorded call
    is made again through the kernel and its plain version, which must
    agree exactly. ``need``: the kernels (launch counters) the trip must
    call. Returns the log line's fields."""
    buf = st.buf.clone()
    force_hub = ipgc.force_hub_enabled()
    for _ in range(trips):
        st._trip(buf, step, st.sc.window, force_hub, None)
    recs = [Recorder(name, lambda a: 0, copy=True) for name in LANE_PLAIN]
    with contextlib.ExitStack() as stack:
        for rec in recs:
            stack.enter_context(rec)
        st._trip(buf, step, st.sc.window, force_hub, None)
    del buf
    calls = [lane_call_row(rec.name, *rec.args[0], what,
                           st.b * st.sc.n_pad) for rec in recs if rec.args]
    seen = {SOURCES[c["kernel"]][2] for c in calls}
    if not set(need) <= seen:
        raise AssertionError(f"{what}: the trip called {sorted(seen)}, "
                             f"not all of {list(need)}")
    return dict(n_pad=st.sc.n_pad, b=st.b, rows=st.b * st.sc.n_pad,
                k_pad=st.sc.k_pad, nh_pad=st.sc.nh_pad, window=st.sc.window,
                real_lanes=sum(ig is not None for ig in st.lanes),
                trips_before=trips, calls=calls, equal=True)


def replay_lane_trips(sess) -> int:
    """Replay every captured lane-group trip once more with CUDA's sync
    debug mode at "error" (its lanes drained: the trip changes nothing)."""
    replays = 0
    torch.cuda.synchronize()
    for _, st in lane_groups(sess):
        for trip in st.trips.values():
            torch.cuda.set_sync_debug_mode("error")
            try:
                trip.graph.replay()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            replays += 1
    torch.cuda.synchronize()
    return replays


def run_batch_phase(sess, graphs, solo) -> dict:
    """``Session.run_batch`` of the mix, per coloring, cold (captures) and
    warm (replays only): every lane equal to its solo run. Returns the
    replayed launches per kernel."""
    launches = dict.fromkeys(_build.SOURCES, 0)
    for algo, fused, need in COLORINGS:
        spec = ExecutionSpec(regime="host", algo=algo, fused=fused)
        want = solo[(algo, fused)]
        what = f"run_batch {algo} fused={fused}"
        for run in ("cold", "warm"):
            start_counts()
            with chunk_mod.REPLAYED_LAUNCHES.scope() as rl, \
                    chunk_mod.CHUNK_COUNTS.scope() as cc:
                t0 = time.perf_counter()
                res = sess.run_batch(spec, graphs)
                wall = time.perf_counter() - t0
                replayed, counts = rl.as_dict(), cc.as_dict()
            for g, r, w in zip(graphs, res, want):
                if not same_coloring(r, w):
                    raise AssertionError(f"{what} ({run}): the lane of "
                                         f"{g.name} differs from its solo "
                                         "run")
            missing = [k for k in need if replayed[k] == 0]
            if missing:
                raise AssertionError(f"{what} ({run}): kernels {missing} "
                                     "never replayed")
            if run == "warm" and counts["graphs"]:
                raise AssertionError(f"{what}: the warm call captured "
                                     f"{counts['graphs']} graphs")
            for k, v in replayed.items():
                launches[k] += v
            log(phase="batch.run_batch", algo=algo, fused=fused, run=run,
                graphs=len(graphs), seconds=wall,
                graphs_per_second=len(graphs) / wall,
                solo_seconds=sum(r.total_seconds for r in want),
                chunks=counts["chunks"], counter_reads=counts["reads"],
                graphs_captured=counts["graphs"],
                capture_seconds=counts["capture_us"] / 1e6,
                replayed_launches={k: v for k, v in replayed.items() if v},
                wrapper_launches={k: v for k, v in
                                  _build.KERNEL_LAUNCHES.items() if v},
                groups=[group_summary(*e, lane_step(algo, fused))
                        for e in lane_groups(sess)],
                identical_to_solo=True,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        log(phase="batch.sync_checked_replay", algo=algo, fused=fused,
            graphs_replayed=replay_lane_trips(sess), clean=True)
        # the kernels at the largest group's operands, mid-run
        _, st = max(lane_groups(sess), key=lambda e: e[1].b * e[1].sc.n_pad)
        load_lanes(st, spec)
        log(phase="batch.lane_kernels", algo=algo, fused=fused,
            group="run_batch", **lane_trip_kernels(
                st, lane_step(algo, fused), what, need))
        del st
        # free this coloring's lane groups before the next one's
        for key in [k for k in sess.cache if k[0] == "stack"]:
            del sess.cache[key]
        torch.cuda.empty_cache()
    return launches


def stream_summary(stream, wall: float, n: int) -> dict:
    st = stream.stats()
    total = stream.metrics.get("stream.total_seconds")
    return dict(rounds=st["rounds"], dispatches=st["dispatches"],
                restacks=st["restacks"],
                grows=sum(g["grows"] for g in st["lane_groups"].values()),
                shrinks=sum(g["shrinks"] for g in st["lane_groups"].values()),
                lane_occupancy=st["lane_occupancy"],
                lane_groups=st["lane_groups"],
                total_seconds_p50=total.percentile(50),
                total_seconds_p90=total.percentile(90), seconds=wall,
                graphs_per_second=n / wall)


def stream_phase(sess, graphs, solo, big: list) -> dict:
    """The stream service on the card: the mix plus phase 3's kron and
    europe (``big``: ``(graph, phase-3 result)``), submitted from a
    producer thread under ``serving()`` (ipgc two-phase, lanes=8,
    adaptive), then a jpl stream of the mix with lanes=4 driven by
    ``pump()``/``drain()`` on this thread, lanes refilled mid-stream.
    Every result equal to its solo run. Returns the replayed launches."""
    launches = dict.fromkeys(_build.SOURCES, 0)
    reqs = graphs + [g for g, _ in big]
    want = solo[("ipgc", False)] + [r for _, r in big]
    stream = sess.stream(ExecutionSpec(regime="host"), StreamConfig(
        lanes=8, chunk="auto", adaptive_lanes=True, max_queue=64,
        max_nodes=50_800_000))
    tickets: list = []
    start_counts()
    with chunk_mod.REPLAYED_LAUNCHES.scope() as rl, \
            chunk_mod.CHUNK_COUNTS.scope() as cc:
        t0 = time.perf_counter()
        with stream.serving():
            producer = threading.Thread(
                target=lambda: tickets.extend(stream.submit(g)
                                              for g in reqs))
            producer.start()
            producer.join()
        wall = time.perf_counter() - t0
        replayed, counts = rl.as_dict(), cc.as_dict()
    for tk, w in zip(tickets, want):
        if tk.status != "done" or not same_coloring(tk.result, w):
            raise AssertionError(f"stream ipgc: {tk.graph.name} "
                                 f"({tk.status}) differs from its solo run")
    for k, v in replayed.items():
        launches[k] += v
    # kron and europe ride the rungs of their sizes on the node ladder
    caps = bucket_capacities(stream.config.max_nodes, ratio=2)
    big_rungs = [pick_bucket(caps, g.n_nodes) for g, _ in big]
    groups = stream.stats()["lane_groups"]
    for rung in big_rungs:
        if not any(k.startswith(f"{rung}/") for k in groups):
            raise AssertionError(f"stream ipgc: no lane group at rung {rung}")
    log(phase="batch.stream", algo="ipgc", fused=False, lanes=8,
        requests=len(reqs), captures=counts["graphs"],
        capture_seconds=counts["capture_us"] / 1e6,
        counter_reads=counts["reads"], identical_to_solo=True,
        big_rungs=big_rungs,
        big_service_seconds=[tk.service_seconds
                             for tk in tickets[len(graphs):]],
        big_host_loop_seconds=[r.total_seconds for _, r in big],
        big_chunks=[tk.chunks for tk in tickets[len(graphs):]],
        replayed_launches={k: v for k, v in replayed.items() if v},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        **stream_summary(stream, wall, len(reqs)))
    # the kernels at the operands of the stream's kron lane group, with
    # kron loaded into its lane 0 again (the stream has drained)
    spec = stream.spec
    kron, _ = big[0]
    ig, window = sess._prepare(spec, kron, stream._alg)[:2]
    st = stream._groups[(big_rungs[0], window, ig.layout_kind)].state
    st.admit(0, ig, device_threshold(stream._pol, ig.n_nodes),
             spec.max_iter)
    log(phase="batch.lane_kernels", algo="ipgc", fused=False,
        group=f"stream {kron.name}", **lane_trip_kernels(
            st, stream._step, f"the stream's {kron.name} lane group",
            COLORINGS[0][2]))
    del stream, tickets, st
    torch.cuda.empty_cache()

    want = solo[("jpl", None)]
    stream = sess.stream(ExecutionSpec(regime="host", algo="jpl"),
                         StreamConfig(lanes=4))
    start_counts()
    with chunk_mod.REPLAYED_LAUNCHES.scope() as rl, \
            chunk_mod.CHUNK_COUNTS.scope() as cc:
        t0 = time.perf_counter()
        tickets = [stream.submit(g) for g in graphs[:8]]
        for _ in range(3):
            stream.pump()
        tickets += [stream.submit(g) for g in graphs[8:]]
        stream.drain()
        wall = time.perf_counter() - t0
        replayed, counts = rl.as_dict(), cc.as_dict()
    for tk, w in zip(tickets, want):
        if tk.status != "done" or not same_coloring(tk.result, w):
            raise AssertionError(f"stream jpl: {tk.graph.name} "
                                 f"({tk.status}) differs from its solo run")
    if not any(tk.admit_round > 1 for tk in tickets):
        raise AssertionError("stream jpl: no lane was refilled mid-stream")
    for k, v in replayed.items():
        launches[k] += v
    log(phase="batch.stream", algo="jpl", fused=None, lanes=4,
        requests=len(graphs), captures=counts["graphs"],
        capture_seconds=counts["capture_us"] / 1e6,
        counter_reads=counts["reads"], identical_to_solo=True,
        admit_rounds=[tk.admit_round for tk in tickets],
        replayed_launches={k: v for k, v in replayed.items() if v},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        **stream_summary(stream, wall, len(graphs)))
    return launches


def uncapped_phase() -> dict:
    """The mix in the reference's serving layout (``UNCAPPED_LAYOUT``:
    ell-tail at the auto ELL width, up to 3,480 for the hub graphs). Per
    coloring, ``run_batch`` of the 16 requests; where its reckoning
    (``batch.group_bytes``) is more than the card has free, the call must
    refuse with ``LaneMemoryError`` and leave nothing allocated, and the
    mix is cut to its first ``m`` requests, sizes unchanged, for the
    largest ``m`` that fits. The call that runs goes cold and warm
    (nothing captured), every lane equal to its solo run at the same
    width; the memory its groups and capture pools hold is logged beside
    the reckoning. Returns the replayed launches per kernel."""
    t0 = time.perf_counter()
    graphs = get_dataset_batch(heavy_tail=dict(MIX), seed=MIX_SEED,
                               **UNCAPPED_LAYOUT)
    log(phase="batch.uncapped.mix", graphs=[g.name for g in graphs],
        nodes=[g.n_nodes for g in graphs],
        ell_widths=[g.ell_width for g in graphs],
        build_seconds=time.perf_counter() - t0)
    sess = Session()
    solo = solo_phase(sess, graphs, layout="uncapped")
    launches = dict.fromkeys(_build.SOURCES, 0)
    for algo, fused, need in COLORINGS:
        spec = ExecutionSpec(regime="host", algo=algo, fused=fused)
        what = f"uncapped run_batch {algo} fused={fused}"
        refused = []
        m = len(graphs)
        while True:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            reserved = torch.cuda.memory_reserved()
            free = torch.cuda.mem_get_info()[0]
            start_counts()
            error = None
            try:
                with chunk_mod.REPLAYED_LAUNCHES.scope() as rl:
                    t1 = time.perf_counter()
                    res = sess.run_batch(spec, graphs[:m])
                    cold = time.perf_counter() - t1
                    replayed = rl.as_dict()
            except batch_mod.LaneMemoryError as e:
                error = str(e)
            if error is None:
                break
            # a refused call leaves nothing behind
            torch.cuda.synchronize()
            if lane_groups(sess) or torch.cuda.memory_allocated() != before:
                raise AssertionError(f"{what}: the refused call of {m} "
                                     f"requests left memory behind: {error}")
            refused.append(dict(requests=m, free_gb=free / 2**30,
                                error=error))
            m -= 1
            if m == 0:
                raise AssertionError(f"{what}: no request fits")
        peak_cold = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        # what the call's lane groups and their capture pools hold
        held = torch.cuda.memory_reserved() - reserved
        with chunk_mod.CHUNK_COUNTS.scope() as cc:
            t1 = time.perf_counter()
            warm_res = sess.run_batch(spec, graphs[:m])
            warm = time.perf_counter() - t1
            captured = cc["graphs"]
        if captured:
            raise AssertionError(f"{what}: the warm call captured "
                                 f"{captured} graphs")
        for g, r, rw, w in zip(graphs, res, warm_res,
                               solo[(algo, fused)]):
            if not (same_coloring(r, w) and same_coloring(rw, w)):
                raise AssertionError(f"{what}: the lane of {g.name} "
                                     "differs from its solo run")
        missing = [k for k in need if replayed[k] == 0]
        if missing:
            raise AssertionError(f"{what}: kernels {missing} never "
                                 "replayed")
        for k, v in replayed.items():
            launches[k] += v
        step = lane_step(algo, fused)
        groups = [group_summary(*e, step) for e in lane_groups(sess)]
        log(phase="batch.uncapped.run_batch", algo=algo, fused=fused,
            requests=m, refused=refused, free_gb=free / 2**30,
            held_gb=held / 2**30,
            reckoned_gb=sum(sum(g["reckoned_gb"].values()) for g in groups),
            cold_seconds=cold,
            warm_seconds=warm, graphs_per_second_warm=m / warm,
            solo_seconds=sum(r.total_seconds
                             for r in solo[(algo, fused)][:m]),
            groups=groups,
            replayed_launches={k: v for k, v in replayed.items() if v},
            identical_to_solo=True, peak_mem_gb_cold=peak_cold,
            peak_mem_gb_warm=torch.cuda.max_memory_allocated() / 2**30)
        for key in [k for k in sess.cache if k[0] == "stack"]:
            del sess.cache[key]
        torch.cuda.empty_cache()
    del sess
    torch.cuda.empty_cache()
    return launches


def batch_card_vs_cpu_phase() -> None:
    """run_batch (ipgc two-phase) and a ManualClock jpl stream (lanes
    refilled mid-stream) at kron scale 1 and europe scale 0.02, on the card
    and on the CPU: identical results, tickets and ``stats()``."""
    graphs = [build_graph(SMALL)[0], build_graph(SMALL_ROAD)[0]]
    spec = ExecutionSpec(regime="host")
    a = Session().run_batch(spec, graphs)
    b = Session("cpu").run_batch(spec, graphs)
    for g, ra, rb in zip(graphs, a, b):
        if not (same_coloring(ra, rb) and ra.counts == rb.counts):
            raise AssertionError(f"run_batch: card and CPU differ on "
                                 f"{g.name}")
    runs = []
    for device in ("cuda", "cpu"):
        stream = Session(device).stream(
            ExecutionSpec(regime="host", algo="jpl"),
            StreamConfig(lanes=2, chunk=3, clock=ManualClock(tick=0.25)))
        tickets = [stream.submit(g) for g in graphs + graphs[1:] * 3]
        stream.drain()
        stats = stream.stats()
        stats.pop("dispatch_seconds")
        runs.append(([(tk.status, tk.admit_round, tk.drain_round, tk.chunks,
                       tk.enqueue_s, tk.admit_s, tk.drain_s) for tk in
                      tickets], [tk.result for tk in tickets], stats))
    (ta, ra, sa), (tb, rb, sb) = runs
    if not (ta == tb and sa == sb
            and all(same_coloring(x, y) for x, y in zip(ra, rb))):
        raise AssertionError("stream jpl: card and CPU differ")
    log(phase="batch.card_vs_cpu", graphs=[g.name for g in graphs],
        run_batch_iterations=[r.iterations for r in a],
        stream_admit_rounds=[t[1] for t in ta], stream_rounds=sa["rounds"],
        identical=True)


def batch_phase(big: list) -> dict:
    """Phase 7; ``big``: phase 3's kron and europe with their ipgc
    two-phase results. Returns the replayed launches per kernel of its
    run_batch calls and streams."""
    t0 = time.perf_counter()
    graphs = mix_phase()
    sess = Session()
    solo = solo_phase(sess, graphs)
    launches = run_batch_phase(sess, graphs, solo)
    for k, v in stream_phase(sess, graphs, solo, big).items():
        launches[k] += v
    del sess
    gc.collect()                  # a stream and its lane groups: a cycle
    torch.cuda.empty_cache()
    for k, v in uncapped_phase().items():
        launches[k] += v
    batch_card_vs_cpu_phase()
    log(phase="batch.done", seconds=time.perf_counter() - t0,
        replayed_launches=launches)
    return launches


# --- the tile tuner ----------------------------------------------------------------

#: kron's host-loop colorings run again at each tile: ipgc two-phase (the
#: fused runs were cut to hold the script's time; the fused kernels are
#: held against their plain twins at every tile in phase 2)
TUNE_RUNS = (("ipgc", False),)
#: the tiles of those runs, beside the default run of phase 3 ("auto")
TUNE_TILES = tune.CANDIDATES + ("auto",)


def tune_sweep_phase(cache_file: str) -> dict:
    """Point the tuner at ``cache_file`` and sweep the three ELL kinds on
    the card (each candidate's µs and the winner logged); a second lookup
    is a memo hit, and a fresh process reads the file without sweeping.
    Runs before the main path, so that its runs find the tuned tiles in
    the memo. Returns kind -> tile."""
    os.environ[tune.CACHE_ENV] = cache_file
    tune.clear_memo()
    tiles = {}
    for kind in tune.ELL_KINDS:
        t0 = time.perf_counter()
        with _build.KERNEL_LAUNCHES.scope() as kl:
            cfg = tune.get_tile_config(kind)
            if any(kl.as_dict().values()):
                raise AssertionError("the sweep's launches were counted")
        seconds = time.perf_counter() - t0
        if tune.get_tile_config(kind) is not cfg:
            raise AssertionError(f"tune {kind}: the second lookup swept")
        if set(cfg.micros) != {str(c) for c in tune.CANDIDATES}:
            raise AssertionError(f"tune {kind}: candidates {cfg.micros}")
        tiles[kind] = cfg.tile_rows
        name, layout, copies = tune._SWEEP_GRAPHS[kind]
        sg = repro_torch.get_dataset(name, scale=tune._SWEEP_SCALE,
                                     **layout)
        log(phase="tune.sweep", kind=kind,
            key=tune.tune_key(tune.backend_name(torch.device("cuda")), kind),
            micros=cfg.micros, tile_rows=cfg.tile_rows, seconds=seconds,
            sweep_shape=dict(graph=name, scale=tune._SWEEP_SCALE,
                             copies=copies, rows=sg.n_nodes * copies,
                             k=sg.ell_width, window=tune._SWEEP_WINDOW,
                             reps=tune._SWEEP_REPS))
    code = ("import json, sys; sys.path.insert(0, 'src');"
            "from repro_torch.kernels import tune;"
            "tune.sweep = lambda *a, **k: sys.exit('swept again');"
            "print(json.dumps({k: tune.get_tile_config(k).tile_rows "
            "for k in tune.ELL_KINDS}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    fresh = json.loads(out.strip().splitlines()[-1])
    if fresh != tiles:
        raise AssertionError(f"a fresh process read {fresh}, not {tiles}")
    with open(cache_file) as f:
        data = json.load(f)
    log(phase="tune.cache", file_version=data["version"],
        keys=sorted(data["entries"]), fresh_process=fresh)
    return tiles


def tile_row(name: str, kernel, plain) -> dict:
    """One row kernel at the tuner's tiles on one call's operands: equal
    to its plain twin at each, and its time at each beside the default
    block's."""
    want = plain()
    out = {"default": cuda_ms(lambda: kernel(None))}
    for t in tune.CANDIDATES:
        assert_equal(kernel(t), want, f"{name} tile_rows={t}")
        out[str(t)] = cuda_ms(lambda: kernel(t))
    return out


def tile_kernels_main_path(o: dict, npr, window: int, graph: str) -> dict:
    """The five row kernels the reference tiles at ``graph``'s dense shape
    (``main_path_operands``), at each candidate tile: equal to their plain
    twins; ms per tile, beside the default block's and the tile the main
    path resolves ("auto")."""
    w = window
    c_args, _ = o["conflict"]
    f_args, f_kw = o["fused_compact"]
    f_kw = untiled(f_kw)
    s_args = f_args[:8] + f_args[9:]
    rows = {
        "mex_window": tile_row(
            "mex_window",
            lambda t: ops.mex_window(o["nc"], o["base"], o["extra"], w,
                                     tile_rows=t),
            lambda: mex_window_plain(o["nc"], o["base"], o["extra"], w)),
        "conflict": tile_row(
            "conflict", lambda t: ops.conflict(*c_args, tile_rows=t),
            lambda: conflict_rows_plain(*c_args)),
        "fused_compact": tile_row(
            "fused_compact",
            lambda t: ops.fused_compact(*f_args, **f_kw, tile_rows=t),
            lambda: fused_compact_rows_plain(*f_args, **f_kw)),
        "fused_step": tile_row(
            "fused_step", lambda t: ops.fused_step(*s_args, tile_rows=t),
            lambda: fused_step_rows_plain(*s_args)),
        "jpl_extrema": tile_row(
            "jpl_extrema", lambda t: ops.jpl_extrema(npr, tile_rows=t),
            lambda: jpl_extrema_plain(npr)),
    }
    log(phase="tune.kernels_main_path", graph=graph, rows=o["nc"].shape[0],
        k=o["nc"].shape[1], window=w, auto_tile=o["tile_rows"],
        ms_by_tile=rows, equal=True)
    return rows


def tile_check_phase(g) -> None:
    """The five row kernels at ``g``'s dense shape at every candidate tile
    (``tile_kernels_main_path``): the tile the main path resolves against
    the default block at a shape other than kron's."""
    ig = repro_torch.prepare(g)
    o = main_path_operands(ig, adaptive_window(g))
    tile_kernels_main_path(o, jpl_round_tile(ig, o["ids"]),
                           adaptive_window(g), g.name)
    del ig, o
    torch.cuda.empty_cache()


def tile_kernels_edge_cases(dev) -> None:
    """The five row kernels at the edge-case sizes, each at every
    candidate tile (and blocks past the 1024-thread cap), equal to their
    plain twins."""
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

    rng = np.random.default_rng(11)
    names = ("colors", "priority", "ell", "rows", "base", "cu", "pu", "ids",
             "active", "pending", "hub_forb", "hub_lose", "hub_slot")
    checked = 0
    for rg in (1, 7, 257, 3000):
        for k in (1, 8, 40, 128):
            for w in (32, 256):
                for sparse, hub in ((False, False), (True, True)):
                    c = gather_case(rg * 3 + k + w + sparse, rg, k,
                                    sparse=sparse, hub=hub, window=w, lo=3)
                    r = len(c["cu"])
                    nc = rng.integers(-2, 300, size=(r, k)).astype(np.int32)
                    base = (rng.integers(0, 4, size=r) * w).astype(np.int32)
                    extra = (rng.random((r, w)) < 0.25) if hub else None
                    npr = t(np.where(rng.random((r, k)) < 0.3, -1, nc))
                    m = [t(a) for a in (nc, base, extra)]
                    f = [t(c[n]) for n in names]
                    s_ = f[:8] + f[9:]
                    what = f"rg={rg} k={k} w={w} sparse={sparse}"
                    for tile in tune.CANDIDATES + (1024,):
                        assert_equal(ops.mex_window(*m, w, tile_rows=tile),
                                     mex_window_plain(*m, w),
                                     f"mex_window {what} tile={tile}")
                        assert_equal(ops.jpl_extrema(npr, tile_rows=tile),
                                     jpl_extrema_plain(npr),
                                     f"jpl_extrema {what} tile={tile}")
                        assert_equal(ops.conflict(*f[:4], *f[5:8], f[9],
                                                  tile_rows=tile),
                                     conflict_rows_plain(*f[:4], *f[5:8],
                                                         f[9]),
                                     f"conflict {what} tile={tile}")
                        kw = dict(capacity=r, n_sentinel=c["n"])
                        assert_equal(ops.fused_compact(*f, w, **kw,
                                                       tile_rows=tile),
                                     fused_compact_rows_plain(*f, w, **kw),
                                     f"fused_compact {what} tile={tile}")
                        assert_equal(ops.fused_step(*s_, w, tile_rows=tile),
                                     fused_step_rows_plain(*s_, w),
                                     f"fused_step {what} tile={tile}")
                        checked += 5
    log(phase="tune.kernels_edge_cases", calls_checked=checked, equal=True,
        tiles=list(tune.CANDIDATES) + [1024])


def tune_runs_phase(g, host: dict) -> None:
    """Kron's host-loop runs of ``TUNE_RUNS`` at each tile and
    "auto": every run equal to phase 3's default run in colors,
    iterations and mode trace, its seconds logged; then one outlined run
    at two tiles on one session, each capturing its own trips."""
    for algo, fused in TUNE_RUNS:
        want = host[(algo, fused)]
        for tile in TUNE_TILES:
            start_counts()
            r = repro_torch.color(g, algo=algo, fused=fused, tile_rows=tile)
            if not (np.array_equal(r.colors, want.colors)
                    and (r.iterations, r.mode_trace)
                    == (want.iterations, want.mode_trace)):
                raise AssertionError(f"{g.name} {algo} fused={fused} "
                                     f"tile_rows={tile}: differs from the "
                                     "default run")
            log(phase="tune.run", graph=g.name, algo=algo, fused=fused,
                tile_rows=tile, iterations=r.iterations,
                color_seconds=r.total_seconds,
                default_seconds=want.total_seconds, identical=True,
                kernel_launches={k: v for k, v in
                                 _build.KERNEL_LAUNCHES.as_dict().items()
                                 if v})
    want = host[("ipgc", False)]
    sess = Session()
    for tile in (8, 32):
        with chunk_mod.CHUNK_COUNTS.scope() as cc:
            r = sess.run(ExecutionSpec(regime="outlined", fused=False,
                                       tile_rows=tile), g)
            graphs = cc["graphs"]
        if not (np.array_equal(r.colors, want.colors)
                and r.mode_trace == want.mode_trace):
            raise AssertionError(f"outlined tile_rows={tile}: differs from "
                                 "the host loop")
        if graphs == 0:
            raise AssertionError(f"outlined tile_rows={tile}: replayed "
                                 "another tile's trips")
        log(phase="tune.outlined", graph=g.name, tile_rows=tile,
            graphs_captured=graphs, color_seconds=r.total_seconds,
            identical_to_host_loop=True)
    tiles = {tk[2] for key, entry in sess.cache.items() if key[0] == "prep"
             for runner in entry[3].values() for tk in runner.trips}
    if tiles != {8, 32}:
        raise AssertionError(f"outlined trips keyed by {tiles}")
    del sess
    torch.cuda.empty_cache()


# --- the LM serving path ------------------------------------------------------------

LM_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "nemotron-4-340b",
            "gemma-7b", "minitron-4b")
#: the full-width serving cell: Qwen3-30B-A3B at its published widths, 8 of
#: its 48 layers (the 48 would take ~61 GB and the coloring phases run
#: first), bf16, served with the reference driver's defaults
LM_ARCH = "qwen3-moe-30b-a3b"
LM_LAYERS = 8
LM_SERVE = dict(batch=8, prompt_len=64, gen=32, temperature=0.8)
LM_SEED = 0
#: card = CPU at the smoke configs in fp32, TF32 off: sums in another
#: order than the CPU's, a few ulps over at most a few hundred terms
LM_CPU_TOL = 1e-4
#: the int8 cache at the smoke configs: one int8 rounding on the other
#: side of .5 moves an entry by 1/127 of its row's absmax
LM_CPU_TOL_Q8 = 2e-3
#: decode at position 63 against forward, bf16: relative RMS of the (B, V)
#: logits. The two paths round at other places (504- and 8-row products
#: against a 512-row one; the decode softmax against the flash loop), each
#: at bf16's unit roundoff 2^-8; a CPU rehearsal at a narrower MoE config
#: (d 512, 32 experts, 4 layers) gave 0.4%, and this allows 5x that for
#: the card's other GEMM paths and the deeper stack. fp8's roundoff (2^-4,
#: 16x) would give ~6% and fail
LM_DECODE_REL = 0.02
#: the int8 cache against the bf16 one at the first decode step: the
#: reference's ~1e-2 relative attention error diluted in the residual
#: stream (the CPU rehearsal: 0.5%), with 10x room
LM_INT8_REL = 0.05


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def lm_card_vs_cpu_phase() -> None:
    """The five LM smoke configs in fp32 on the card and on the CPU, the
    same weights and tokens: prefill logits and three teacher-forced
    decode steps (plain and int8 cache) within ``LM_CPU_TOL``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in LM_ARCHS:
            cfg = get_arch(arch).make_smoke()
            params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
            card = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                        if isinstance(v, dict) else v.cuda())
                    for k, v in params.items()}
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab, (2, 12)))
            errs = {}
            for int8 in (False, True):
                got, gc_ = tfm.prefill(card, toks.cuda()[:, :9], cfg,
                                       max_len=16)
                want, wc = tfm.prefill(params, toks[:, :9], cfg, max_len=16)
                e = [_max_abs(got.cpu(), want)]
                if int8:
                    gc_, wc = tfm.quantize_cache(gc_), tfm.quantize_cache(wc)
                for i in range(9, 12):
                    got, gc_ = tfm.decode_step(card, toks.cuda()[:, i:i + 1],
                                               gc_, cfg)
                    want, wc = tfm.decode_step(params, toks[:, i:i + 1], wc,
                                               cfg)
                    e.append(_max_abs(got.cpu(), want))
                tol = LM_CPU_TOL_Q8 if int8 else LM_CPU_TOL
                scale = max(1.0, float(want.abs().max()))
                if max(e) > tol * scale:
                    raise AssertionError(f"lm {arch} int8={int8}: card "
                                         f"differs from the CPU by {e}")
                errs["int8" if int8 else "plain"] = e
            log(phase="lm.card_vs_cpu", arch=arch, max_abs_err=errs,
                tol=dict(plain=LM_CPU_TOL, int8=LM_CPU_TOL_Q8), equal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def lm_decode_profile(params, cfg, prompts, reps: int = 3) -> dict:
    """One decode step over a bf16 and an int8 cache of the same prompts,
    in one run: wall ms of ``reps`` steps of each, interleaved, then one
    step of each under ``torch.profiler``: device µs and operations (the
    events on the card: kernels, copies, memsets), the host's ATen calls,
    and the device operations that take the most time. Each step writes the
    cache at the same position (its returned cache is dropped)."""
    from torch.autograd import DeviceType

    from repro_torch.models import transformer as tfm

    act = torch.profiler.ProfilerActivity
    out = {}
    with torch.inference_mode():
        _, cache = tfm.prefill(params, prompts, cfg,
                               max_len=prompts.shape[1] + 1)
        caches = {"bf16": cache, "int8": tfm.quantize_cache(cache)}
        tok = prompts[:, -1:]
        for c in caches.values():              # warm
            tfm.decode_step(params, tok, c, cfg)
        walls = {name: [] for name in caches}
        for _ in range(reps):
            for name, c in caches.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tfm.decode_step(params, tok, c, cfg)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        for name, c in caches.items():
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as p:
                tfm.decode_step(params, tok, c, cfg)
                torch.cuda.synchronize()
            ev = p.key_averages()
            on_card = sorted((e for e in ev
                              if e.device_type == DeviceType.CUDA),
                             key=lambda e: -e.self_device_time_total)
            out[name] = dict(
                wall_ms=walls[name],
                device_us=sum(e.self_device_time_total for e in on_card),
                device_ops=sum(e.count for e in on_card),
                host_ops=sum(e.count for e in ev
                             if e.key.startswith("aten::")),
                top=[[e.key, e.count, e.self_device_time_total]
                     for e in on_card[:8]])
    return out


def lm_serve_phase(card: str) -> dict:
    """Qwen3-30B-A3B at its published widths, 8 of 48 layers, bf16: init
    at random from a seed, ``serve()`` with the reference's defaults with
    a bf16 and an int8 KV cache (each after an untimed warm-up call), and
    the checks: decode at position 63 equals forward there
    (``LM_DECODE_REL``, at a capacity that drops no token: see the log),
    every logit finite, the int8 run's first decode step within
    ``LM_INT8_REL`` of the bf16 run's; then ``lm_decode_profile``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    default_session().cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    cfg = dataclasses.replace(get_arch(LM_ARCH).make_config(),
                              n_layers=LM_LAYERS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    with Timer() as t:
        with torch.inference_mode():
            params, _ = tfm.init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
    n_params = sum(v.numel() for v in (params["embed"], params["lm_head"],
                                       params["final_norm"],
                                       *params["layers"].values()))
    if n_params != cfg.n_params:
        raise AssertionError(f"lm: {n_params} parameters, config says "
                             f"{cfg.n_params}")
    log(phase="lm.init", arch=LM_ARCH, layers=cfg.n_layers,
        published_layers=get_arch(LM_ARCH).make_config().n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k, d_ff_expert=cfg.moe.d_ff_expert,
        vocab=cfg.vocab, rope_theta=cfg.rope_theta, dtype=str(cfg.dtype),
        n_params=n_params, gb=n_params * 2 / 1e9, init_seconds=t.seconds)
    for kv_int8 in (False, True):       # each cache's first use untimed
        serve(cfg, params=params, batch=LM_SERVE["batch"],
              prompt_len=LM_SERVE["prompt_len"], gen=2, kv_int8=kv_int8,
              generator=torch.Generator(device=dev).manual_seed(99))
    runs = {}
    for kv_int8 in (False, True):
        torch.cuda.reset_peak_memory_stats()
        r = serve(cfg, params=params, kv_int8=kv_int8,
                  generator=torch.Generator(device=dev).manual_seed(1),
                  **LM_SERVE)
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(r.prefill_logits).all()
                      and torch.isfinite(r.step_logits).all())
        if not finite:
            raise AssertionError(f"lm serve int8={kv_int8}: a logit is not "
                                 "finite")
        if tuple(r.tokens.shape) != (LM_SERVE["batch"], LM_SERVE["gen"]):
            raise AssertionError(f"lm serve: tokens {tuple(r.tokens.shape)}")
        runs[kv_int8] = r
        log(phase="lm.serve", card=card, arch=LM_ARCH, layers=cfg.n_layers,
            kv_cache="int8" if kv_int8 else "bf16", **LM_SERVE,
            prefill_tokens=LM_SERVE["batch"] * LM_SERVE["prompt_len"],
            prefill_capacity=moe_mod._capacity(
                LM_SERVE["batch"] * LM_SERVE["prompt_len"], cfg.moe.top_k,
                cfg.moe.n_experts, cfg.moe.capacity_factor),
            decode_capacity=moe_mod._capacity(
                LM_SERVE["batch"], cfg.moe.top_k, cfg.moe.n_experts,
                cfg.moe.capacity_factor),
            prefill_ms=r.prefill_s * 1e3, prefill_tok_s=r.prefill_tok_s,
            decode_steps=r.decode_steps,
            decode_ms_per_step=r.decode_ms_per_step,
            decode_tok_s=r.decode_tok_s, peak_gb=peak, finite=True,
            sample=r.tokens[0, :8].tolist())
    plain, q8 = runs[False], runs[True]
    if not torch.equal(plain.prompts, q8.prompts):
        raise AssertionError("lm: the two runs served other prompts")
    int8_rel = _rel(q8.step_logits, plain.step_logits)
    if not int8_rel <= LM_INT8_REL:
        raise AssertionError(f"lm: the int8 cache's first decode step is "
                             f"{int8_rel} from the bf16 cache's")
    checks = {}
    prompts = plain.prompts
    with torch.inference_mode():
        for name, cf in (("no_drop", cfg.moe.n_experts / cfg.moe.top_k),
                         ("served", cfg.moe.capacity_factor)):
            c2 = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
            full, _, _ = tfm.forward(params, prompts, c2)
            _, cache = tfm.prefill(params, prompts[:, :63], c2, max_len=64)
            step, _ = tfm.decode_step(params, prompts[:, 63:64], cache, c2)
            checks[name] = dict(
                capacity_factor=cf, rel=_rel(step, full[:, 63]),
                max_abs=_max_abs(step, full[:, 63]),
                ref_rms=float(full[:, 63].float().pow(2).mean().sqrt()),
                finite=bool(torch.isfinite(step).all()))
            del full, cache, step
    if not checks["no_drop"]["rel"] <= LM_DECODE_REL:
        raise AssertionError(f"lm: decode at position 63 is "
                             f"{checks['no_drop']} from forward")
    log(phase="lm.checks", decode_vs_forward=checks,
        decode_tol=LM_DECODE_REL, int8_vs_bf16_rel=int8_rel,
        int8_tol=LM_INT8_REL,
        int8_vs_bf16_max_abs=_max_abs(q8.step_logits, plain.step_logits))
    log(phase="lm.decode_profile", card=card,
        **lm_decode_profile(params, cfg, prompts))
    del params, runs, plain, q8
    reset_peak()
    torch.cuda.empty_cache()
    return checks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    card = device_phase()
    mark("device")
    dev = torch.device("cuda")
    tune_dir = tempfile.TemporaryDirectory()
    tune_sweep_phase(os.path.join(tune_dir.name, "tune.json"))
    mark("tune.sweep")

    edge_cases(dev)
    tile_kernels_edge_cases(dev)
    mark("edge_cases")
    kron, kron_s = build_graph(KRON)
    mark("kron.build")
    kron_ig = repro_torch.prepare(kron)
    rows = kernel_phase(kron_ig, adaptive_window(kron))
    mark("kernels")
    del kron_ig
    torch.cuda.empty_cache()

    kron_host: dict = {}
    runs = path_phase(kron, kron_s, rows, results=kron_host,
                      traced=True) + bfs_phase(kron)
    mark("kron.path_bfs")
    baselines_phase(kron)
    mark("kron.baselines")
    outlined = {kron.name: outlined_phase(kron, kron_host, traced=True)}
    mark("kron.outlined")
    profile_phase(kron)
    mark("kron.profile")
    tune_runs_phase(kron, kron_host)
    mark("tune.runs")
    default_session().cache.clear()
    torch.cuda.empty_cache()
    dist_runs, ctx = dist_phase(kron, [dev] * KRON_SHARDS, DIST_RUNS,
                                record=True, boundary=DIST_RUNS[:2],
                                traced=True)
    runs += dist_runs
    rows["fused_step"] = fused_step_row(**ctx)
    mark("kron.dist")
    del ctx
    default_session().cache.clear()
    torch.cuda.empty_cache()
    road, road_s = build_graph(ROAD)
    mark("road.build")
    road_host: dict = {}
    runs += path_phase(road, road_s, results=road_host)
    mark("road.path")
    outlined[road.name] = outlined_phase(road, road_host)
    mark("road.outlined")
    default_session().cache.clear()
    torch.cuda.empty_cache()
    tile_check_phase(road)
    mark("tune.road_tiles")
    torch.cuda.empty_cache()
    runs += dist_phase(road, None, DIST_RUNS, boundary=DIST_RUNS)[0]
    mark("road.dist")
    default_session().cache.clear()
    torch.cuda.empty_cache()
    totals = {k: sum(c[k] for c in runs) for k in _build.SOURCES}
    if any(c == 0 for c in totals.values()):
        raise AssertionError(f"a kernel never launched on the path: {totals}")

    fused_rule(outlined)
    card_vs_cpu_phase()
    mark("card_vs_cpu")
    big = [(kron, kron_host[("ipgc", False)]),
           (road, road_host[("ipgc", False)])]
    del kron_host, road_host
    batch = batch_phase(big)
    mark("batch")
    del big, kron, road
    lm_card_vs_cpu_phase()
    mark("lm.card_vs_cpu")
    lm_serve_phase(card)
    mark("lm.serve")
    tune_dir.cleanup()
    for name, row in rows.items():
        row["launches"] = totals[SOURCES[name][2]]
        row["batch_launches"] = batch[SOURCES[name][2]]
        row["lane_rows_checked"] = [r for k, r in LANE_CHECKS if k == name]
        row["tile_ms"] = TILE_MS.get(name)
        row["outlined_launches"] = sum(
            o["launches"][SOURCES[name][2]] for by in outlined.values()
            for o in by.values())
    reset_peak()
    log(phase="done", seconds=time.perf_counter() - t_start,
        peak_mem_gb=_peak_bytes / 2**30,
        phase_seconds={b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})
    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
