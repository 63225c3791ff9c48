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
   and again at the default block (``default_ms``). The five row
   kernels gather the neighbours themselves (``mex_window``,
   ``conflict``, ``fused_compact``, ``fused_step``, ``jpl_extrema``:
   their rows are recorded from the main path's steps) and are also timed
   against the gathers their earlier signature needed (``gather_ms``),
   and at the items block of the kron sparse steps' most-used capacity
   bucket (recorded during the ipgc and jpl runs of phases 3 and 4), as
   is ``compact``; their edge cases include ids within 4,096 of
   2**31 - 1 over an 8-GiB colors vector (``kernels.huge_ids``) and both
   ``jpl_extrema`` sources at rounds 0, 1, 7 and 9999; ``compact`` (one
   launch, a decoupled look-back) also repeats 100 times at 2**21 and
   50.8M flags, bit-equal every time; the five row kernels the
   reference tiles (``mex_window``, ``conflict``, ``fused_compact``,
   ``fused_step``, ``jpl_extrema``) equal their plain twins at
   ``tile_rows`` 8, 32 and 128 at the kron dense shape (their ms per tile,
   the kernels line's ``tile_ms``) and at the edge-case sizes (and 1024),
   and, after europe's outlined runs, at europe's dense shape
   (``tune.kernels_main_path`` lines, beside the default block's ms and
   the tile "auto" resolves to); the int8 decode's ``q8_dot`` (no
   Pallas kernel: the reference's int8 x int8 -> int32 dots) at
   Minitron-4B's widths (8 KV heads of 128, G = 3) and 32,768 and 140,000
   positions, and at phase 8's serving shape (batch 8, Qwen3's 4 KV heads
   of 128, G = 8, a 96-position cache), random and all 127s, exactly (the
   values' int32 sums of 127s wrap past 2^31 at 140,000, as the
   reference's do), one layer's pair of calls timed, and held exactly, at
   32,768 positions and at ``long_500k``'s 524,288 (``kernels.q8_dot``
   line); its launches are phase 8's int8 run's; the hub side-channel's
   ``hub_forbidden`` and ``hub_lose`` (``kernels.hub`` line) at the
   operands of a kron ipgc two-phase coloring (its dense call and the
   sparse calls whose gate let through the most, the median and the
   fewest entries), byte for byte against their plain twins and timed
   beside the bound of the bytes their rule in ``bench/kernels`` counts,
   and the host's side of them: each call's host µs in an untraced
   coloring, the host seconds inside the steps' ``ipgc.hub`` regions, and
   the wrapper's µs a call against its bare launch function's;
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
   two-phase one), on kron the two-phase run's ``mex_window`` calls and
   the jpl run's ``jpl_extrema`` calls held against their plain twins at
   a shard's dense shape and the most-used sparse one
   (``kernels.dist_shapes`` lines), a verified coloring, and a replay of
   each under sync
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

8. lm: the LM serving path. The five LM archs' smoke configs in
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
   lines; the attention products on bf16 operands, the int8 run's through
   ``q8_dot``, whose launches it counts, the bf16 run's none); every logit
   finite; the int8 run's first decode step within
   ``LM_INT8_REL`` of the bf16 run's; and decode at position 63 (prefill
   of 63 tokens, one step) against ``forward`` at 63 within
   ``LM_DECODE_REL``, at a capacity factor that drops no token (the MoE
   drops over-capacity tokens, and 504 or 512 tokens drop others than 8
   do), with the served factor's distance logged beside it; one decode
   step over a bf16 and an int8 cache of the same prompts, interleaved
   wall ms and one ``torch.profiler`` trace of each (device µs, launches,
   the top operations: ``lm.decode_profile``).
9. train (last): the LM training path (no kernel of this repo runs
   there: the reference has none). ``train.card_vs_cpu``,
   one ``launch.train.build_step`` step of each LM smoke config in fp32
   (TF32 off) on the card and on the CPU from the same weights, state and
   batch, and one ``--compress`` step at one replica, within
   ``tests/_train_check.py``'s tolerances (loss, grad norm, every m, v
   and parameter leaf); ``train.resume``, ``train()`` for 8 steps against
   4, a checkpoint, a restore into fresh state and 4 more, under
   deterministic algorithms, equal losses and parameters, and a checkpoint
   written on the CPU restored onto the card exactly; ``train.full``,
   Minitron-4B at its published widths (d_model 3072, 24 heads, 8 KV
   heads, head_dim 128, d_ff 9216, squared ReLU, vocab 256,000), all 32
   layers, bf16, random weights from a seed, ``launch.train.train``
   on the reference driver's traffic (batch 8 x 128, lr 3e-3, warmup 20)
   for 20 steps with ``update_in_chunks`` and remat: init seconds, each
   step's ms (CUDA events at the step boundaries; the median of steps
   3-20), tok/s, the model-FLOPs share, peak GiB, every loss and grad
   norm; all finite, grad norms above 0, peak under the card's memory.
10. gnn: the GNN and DLRM models (no kernel of this repo runs there:
   the reference has none), their training steps from the port of the
   reference's ``launch/steps.py`` (``repro_torch.launch.steps``).
   ``gnn.card_vs_cpu``: one smoke step of each of the five archs on the card
   and on the CPU (fp32, TF32 off) within the CPU parity tests' tolerances,
   ``sample_blocks`` and ``RecsysPipeline.batch_at`` card = CPU bit for
   bit, ``forward_full_owner`` at four shards on the card = ``forward_full``;
   ``gnn.molecule``: EquiformerV2, EGNN and SchNet at their published
   configs on the padded ``molecule`` shape (4,096 nodes, 8,192 edges, 128
   graphs), 20 steps each; ``gnn.minibatch``: GraphSAGE-Reddit on a random
   graph at Reddit's sizes drawn and sorted into CSR on the card, 20 steps
   of sample, loss, gradient and AdamW (fan-out 15-10, 1,024 seeds) and one
   step's profile; ``recsys.train``: DLRM-RM2 (26 tables of 1M x 64, fp32)
   at 65,536 rows, 20 steps with ``update_in_chunks``, then
   ``retrieval_score`` over 1M candidates and ``forward`` at 262,144 rows.
   Each logs step ms (the median of steps 3-20), its rate (graphs/s, seeds/s,
   samples/s) and peak GiB; all losses and grad norms finite, norms above 0.
11. mesh: the models on meshes of ``cuda:0`` (``launch.mesh``; no
   kernel of this repo runs there: the reference's models have none).
   ``mesh.card_vs_cpu``: the Qwen3, Moonshot and Minitron smoke configs
   (fp32, TF32 off) at (1, 4) and (2, 2), ``batch_axes = fsdp_axes =
   ("data",)``: forward, prefill plus three decode steps and ``loss_fn``'s
   gradients, card = the same mesh of the CPU within ``LM_CPU_TOL``; the
   EquiformerV2 smoke step at four edge shards, card = CPU.
   ``mesh.lm_serve``: phase 8's Qwen3-30B-A3B weights (drawn again from
   its seed, their sums checked equal) served at ``LM_SERVE`` unsharded,
   at (1, 4) and at (2, 4), the
   experts placed once by ``place_params`` (views): prefill ms, decode ms a
   step, tok/s, peak GiB; at (1, 4) and a factor that drops no token the
   prefill and a decode step within ``LM_DECODE_REL`` of the unsharded
   ones, the peak within ``MESH_PEAK_SLACK_GIB``; at (2, 4) the prefill
   within ``LM_DECODE_REL`` of two unsharded half-batch prefills.
   ``mesh.eqv2``: EquiformerV2 at its published config on the molecule
   shape, five steps unsharded and at four edge shards from one init:
   step ms and losses, the first losses equal within ``LOSS_RTOL``.

12. cases (last): the step builders (``repro_torch.launch.steps``).
   ``cases.meta``: every registry cell (42) and the LM decode shapes'
   three other variants built abstract: model FLOPs, tokens, kind and
   argument bytes of each, no byte allocated on the card.
   ``cases.card_vs_cpu``: each family's case function at its smoke config
   and a small shape (``tests/_case_check.py::CASES``) on the card and on
   the CPU, within that file's tolerances, the coloring step exactly.
   ``cases.run``: ``CASES_RUN`` at their published configs and registry
   shapes (the paper-ipgc cells, DLRM's four shapes, SchNet, EGNN and
   GraphSAGE at ``full_graph_sm``, ``molecule`` and ``minibatch_lg``,
   EquiformerV2 at ``molecule``), one warm-up step and ``CASES_TIMED``
   timed: step ms, rate (the case's tokens a second), the model-FLOPs
   share over ``BF16_PEAK_FLOPS``, peak GiB; the paper-ipgc cells count
   ``mex_window``, ``conflict`` and ``compact`` (each above 0, the kernels
   line's ``cases_launches``) and equal the same step through the plain
   twins; the int8 decode variants count ``q8_dot``'s launches (above 0,
   the kernels line's ``cases_launches``). Every other cell is reckoned
   before anything of it is
   allocated (its arguments, then the activations of one step measured at
   a smaller shape and scaled: ``reckon``) and runs where that fits
   ``CASES_FIT`` of the free memory, else is logged as ``cases.left_out``
   with its reckoned bytes and the reason.

13. dryrun (last): the dry run (``repro_torch.launch.dryrun``, its op
   counter ``opcost`` and ``roofline``). Its CLI runs in a process of its
   own from the end of phase 1 (``DryrunProcess``: every case's one-card
   record and every cell's production single-mesh record, on the
   ``meta`` device, the card hidden from it); phase 12's
   ``cases.left_out`` lines carry its one-card peak, and a failed record
   there fails the phase. ``dryrun.card``:
   each cell ``cases.run`` ran, its meta record (none for the paper-ipgc
   cells, which need values) against one step counted on the card after
   a warm-up: FLOPs and bytes equal within ``DRYRUN_EQ``, the meta peak
   beside the card's allocated and reserved peaks of that step, the
   one-card roofline bound over ``cases.run``'s step ms at most
   ``DRYRUN_SHARE_MAX`` (FLOPs at their type's peak). ``dryrun.mesh``:
   each single-mesh record with its roofline row (the paper-ipgc cells'
   from their card count); the process's summary must count no failed
   record beyond the unsplittable ones and the four paper-ipgc records
   it cannot count without the card.

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
from repro_torch.kernels import hub as hub_mod  # noqa: E402
from repro_torch.kernels.hub import (hub_forbidden_plain,  # noqa: E402
                                     hub_lose_plain)
from repro_torch.kernels.jpl_prio import (Hash, Table,  # noqa: E402
                                          jpl_extrema_rows_plain,
                                          round_hash)
from repro_torch.kernels.mex_window import \
    mex_window_rows_plain  # noqa: E402
from repro_torch.kernels import tune  # noqa: E402
from repro_torch.serve import ManualClock, StreamConfig  # noqa: E402

from _gather_cases import (gather_case, gathered,  # noqa: E402
                           jpl_prio_table)

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
    # the hub side-channel: no Pallas kernel, the reference's jnp scatters
    "hub_forbidden": ("src/repro_torch/kernels/csrc/hub.cu",
                      "none: jnp scatters, src/repro/core/ipgc.py:313",
                      "hub"),
    "hub_lose": ("src/repro_torch/kernels/csrc/hub.cu",
                 "none: jnp scatters, src/repro/core/ipgc.py:393", "hub"),
    # the int8 decode's products: no Pallas kernel, the reference's
    # int8 x int8 -> int32 dots (its scores at :215, values at :228)
    "q8_dot": ("src/repro_torch/kernels/csrc/q8_dot.cu",
               "src/repro/models/attention.py:215", "q8_dot"),
}
#: the kernels of the coloring paths (phases 3-7)
COLORING = tuple(k for k in SOURCES if k != "q8_dot")
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

    gather_edge_cases(dev)
    huge_id_cases(dev)
    compact_edge_cases(dev, rng)
    for r in (0, 1, 7, 257, 3000):
        for k in (1, 3, 8, 40, 128):
            nbr = t(rng.random((r, k)) < 0.05)
            for unvisited in (t(rng.random(r) < 0.6),
                              torch.ones(r, dtype=torch.bool, device=dev)):
                assert_equal(ops.frontier_probe(nbr, unvisited),
                             frontier_probe_plain(nbr, unvisited),
                             f"frontier_probe r={r} k={k}")
            if r > 1:     # unaligned tiles take the narrow loads
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


#: the operands of the gathering kernels in a ``gather_case``, by kernel
CONFLICT_NAMES = ("colors", "priority", "ell", "rows", "cu", "pu", "ids",
                  "newly")
FUSED_NAMES = ("colors", "priority", "ell", "rows", "base", "cu", "pu", "ids",
               "active", "pending", "hub_forb", "hub_lose", "hub_slot")
STEP_NAMES = FUSED_NAMES[:8] + FUSED_NAMES[9:]
MEX_NAMES = ("colors", "ell", "rows", "base", "active", "hub_forb",
             "hub_slot")
#: the JPL rounds whose hash the ``jpl_extrema`` checks take
JPL_ROUNDS = (0, 1, 7, 9999)


def jpl_sources(c, prio, dev) -> list:
    """The ``jpl_extrema`` sources of case ``c``: its priority table, and
    the hash of its colors at each of ``JPL_ROUNDS``."""
    return [Table(prio)] + [
        Hash(torch.from_numpy(c["colors"]).to(dev),
             torch.tensor(rnd, dtype=torch.int32, device=dev))
        for rnd in JPL_ROUNDS]


def source_name(src) -> str:
    return ("table" if isinstance(src, Table)
            else f"hash rnd={int(src.rnd)}")


def gather_edge_cases(dev) -> None:
    """The five kernels that gather the neighbours themselves: rows None
    or sparse with sentinels, hub and no-hub, rows of length 0, < K and K,
    R = 0, empty/full activity, exhausted windows, truncating and padding
    capacities, both ``jpl_extrema`` sources at rounds 0, 1, 7 and 9999,
    16-byte and one-entry ELL loads."""
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

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
                        args = [t(c[n]) for n in CONFLICT_NAMES]
                        assert_equal(ops.conflict(*args),
                                     conflict_rows_plain(*args),
                                     f"conflict {what}")
                        step = [t(c[n]) for n in STEP_NAMES]
                        got = ops.fused_step(*step, w)
                        assert_equal(got, fused_step_rows_plain(*step, w),
                                     f"fused_step {what}")
                        full = None
                        if hub:
                            # rows at an all-forbidden hub row: first = -1
                            full = gathered(c)["extra"].all(axis=1)
                            if not (got[1].cpu().numpy()[full] == -1).all():
                                raise AssertionError(
                                    f"fused_step {what}: a full window did "
                                    "not give -1")
                        sources = []
                        if w == 1 and not hub:      # jpl reads no window
                            sources = jpl_sources(
                                c, t(jpl_prio_table(c, rg + k + sparse)),
                                dev)
                            for src in sources:
                                a = (t(c["ell"]), t(c["rows"]), src)
                                assert_equal(ops.jpl_extrema(*a),
                                             jpl_extrema_rows_plain(*a),
                                             f"jpl_extrema {what} "
                                             f"{source_name(src)}")
                        for act_p in (None, 0.0, 1.0):
                            if act_p is not None:
                                c["active"] = np.full(r, act_p > 0)
                                c["pending"] = c["active"] & (c["cu"] >= 0)
                            mex = [t(c[n]) for n in MEX_NAMES]
                            first = ops.mex_window(*mex, w)
                            assert_equal(first,
                                         mex_window_rows_plain(*mex, w),
                                         f"mex_window {what} active={act_p}")
                            if full is not None and not (
                                    first.cpu().numpy()[full] == -1).all():
                                raise AssertionError(
                                    f"mex_window {what}: a full window did "
                                    "not give -1")
                            case = [t(c[n]) for n in FUSED_NAMES]
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
                            ell = x[1:].view(rg, k)
                            args[2] = case[2] = step[2] = mex[1] = ell
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
                            assert_equal(ops.mex_window(*mex, w),
                                         mex_window_rows_plain(*mex, w),
                                         f"mex_window unaligned {what}")
                            for src in sources:
                                a = (ell, t(c["rows"]), src)
                                assert_equal(ops.jpl_extrema(*a),
                                             jpl_extrema_rows_plain(*a),
                                             f"jpl_extrema unaligned {what} "
                                             f"{source_name(src)}")


#: the node count of ``huge_id_cases``: the pad id is the largest int32
HUGE_N = 2**31 - 1


def huge_id_cases(dev) -> None:
    """``jpl_extrema`` (both sources, each round of ``JPL_ROUNDS``) and
    ``mex_window`` over neighbour ids within 4,096 of 2**31 - 1: a colors
    vector of ``HUGE_N + 1`` int32 (8 GiB, written only where it is read),
    an ELL of left-packed rows of such ids (pad ``HUGE_N``), rows None and
    sparse with sentinels; the vector doubles as the priority table."""
    rng = np.random.default_rng(5)
    n, rg, k, w = HUGE_N, 300, 8, 32
    top = 4096
    ell = np.full((rg, k), n, np.int64)
    for r, d in enumerate(rng.integers(0, k + 1, size=rg)):
        ell[r, :d] = np.sort(rng.choice(top, size=d, replace=False)) + n - top
    colors = torch.empty(n + 1, dtype=torch.int32, device=dev)
    colors[n - top:n] = torch.from_numpy(
        rng.integers(-1, 12, size=top).astype(np.int32)).to(dev)
    colors[n] = int(ipgc.PAD_COLOR)
    ell_t = torch.from_numpy(ell.astype(np.int32)).to(dev)
    sparse = torch.from_numpy(rng.integers(0, rg + 3, size=rg + 40)
                              .astype(np.int32)).to(dev)
    checked = 0
    for rows in (None, sparse):
        r = rg if rows is None else rows.shape[0]
        base = torch.from_numpy((rng.integers(0, 2, size=r) * w)
                                .astype(np.int32)).to(dev)
        active = torch.from_numpy(rng.random(r) < 0.8).to(dev)
        mex = (colors, ell_t, rows, base, active, None, None, w)
        assert_equal(ops.mex_window(*mex), mex_window_rows_plain(*mex),
                     f"mex_window huge ids rows={rows is not None}")
        for src in [Table(colors)] + [
                Hash(colors, torch.tensor(rnd, dtype=torch.int32,
                                          device=dev)) for rnd in JPL_ROUNDS]:
            a = (ell_t, rows, src)
            assert_equal(ops.jpl_extrema(*a), jpl_extrema_rows_plain(*a),
                         f"jpl_extrema huge ids rows={rows is not None} "
                         f"{source_name(src)}")
            checked += 1
    del colors
    torch.cuda.empty_cache()
    log(phase="kernels.huge_ids", n=n, rows=rg, k=k,
        max_id=int(ell[ell < n].max()), jpl_calls=checked, equal=True)


def call_rows(name: str, args) -> "tuple[torch.Tensor | None, int]":
    """A gathering kernel's ``rows`` argument and its row count."""
    at = GATHERING[name].ell_at
    ell, rows = args[at:at + 2]
    return rows, ell.shape[0] if rows is None else rows.shape[0]


def items_rows(name: str, args) -> "int | None":
    """The row count of a gathering kernel's call from an items block
    (``rows`` given), None for a dense call (``rows`` None)."""
    rows, r = call_rows(name, args)
    return None if rows is None else r


def all_rows(name: str, args) -> int:
    """The row count of a gathering kernel's call."""
    return call_rows(name, args)[1]


def _cloned(a):
    """A copy of a recorded argument's tensors (a ``jpl_extrema`` source's
    too)."""
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, (Table, Hash)):
        return type(a)(*(x.clone() for x in a))
    return a


class Recorder:
    """Wraps ``ops.<name>`` while active: counts its calls by row count
    (``rows_of(name, args)``; None skips the call) and keeps the arguments
    of the first call at each row count (the operands the main path hands
    the kernel, as they were, and its keywords, ``tile_rows`` among them,
    so a kept call runs again at the block the path ran; with ``copy``,
    copies of its tensors, for a caller that writes into them after the
    call)."""

    def __init__(self, name: str, rows_of=items_rows, copy: bool = False):
        self.name, self.rows_of, self.copy = name, rows_of, copy
        self.calls: dict[int, int] = {}
        self.args: dict[int, tuple] = {}

    def __enter__(self):
        real = self.real = getattr(ops, self.name)

        def spy(*args, **kw):
            r = self.rows_of(self.name, args)
            if r is not None:
                self.calls[r] = self.calls.get(r, 0) + 1
                if r not in self.args:
                    kept = args
                    if self.copy:
                        kept = tuple(_cloned(a) for a in args)
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
    """The operands the dense steps hand the kernels, recorded at the tile
    the main path's runs resolve (``tile_rows="auto"``): ``mex_window``'s
    and ``conflict``'s from the two-phase dense step and
    ``fused_compact``'s from the fused one, two fused dense iterations into
    a run on ``ig``; ``jpl_extrema``'s from the JPL dense round two rounds
    into a JPL run."""
    tile = tune.resolve_tile_rows("auto", ig.layout_kind, ig.device)
    colors, base, wl = init_ipgc_state(ig)
    for _ in range(2):
        colors, base, wl = ipgc.fused_dense_step(ig, colors, base, wl,
                                                 window=window,
                                                 tile_rows=tile)
    with Recorder("mex_window", all_rows) as rec_m, \
            Recorder("conflict", all_rows) as rec_c:
        ipgc.dense_step(ig, colors, base, wl, window=window, tile_rows=tile)
    with Recorder("fused_compact", all_rows) as rec_f:
        ipgc.fused_dense_step(ig, colors, base, wl, window=window,
                              tile_rows=tile)
    jpl = get_algorithm("jpl")
    dense, _ = jpl.step_fns(False)
    jc, rnd, jwl = jpl.init_state(ig)
    for _ in range(2):
        jc, rnd, jwl = dense(ig, jc, rnd, jwl, tile_rows=tile)
    with Recorder("jpl_extrema", all_rows) as rec_j:
        dense(ig, jc, rnd, jwl, tile_rows=tile)
    return dict(active=wl.mask, capacity=wl.capacity, n=ig.n_nodes,
                k=ig.ell_idx.shape[1], tile_rows=tile,
                mex_window=rec_m.most_used()[2],
                conflict=rec_c.most_used()[2],
                fused_compact=rec_f.most_used()[2],
                jpl_extrema=rec_j.most_used()[2])


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


def mex_window_work(colors, ell_idx, rows, base, active, hub_forb, hub_slot,
                    window) -> tuple[int, int]:
    """Bytes and operations the mex_window kernel needs on these inputs,
    each read once: ``active`` (and ``rows``) of every row, ``base`` of the
    active rows; for the active graph rows 4 bytes per real ELL entry (the
    padding is never read) and the distinct colors they touch, and each
    hub row's slot and W bytes of its forbidden row; the int32 output."""
    pad = colors.shape[0] - 1
    nbr, ok = gather_rows(ell_idx, rows, pad)
    r = base.shape[0]
    work = active & ok
    real = (nbr != pad) & work[:, None]
    n_real = int(real.sum())
    nbytes = (r + (0 if rows is None else 4 * r) + 4 * int(active.sum())
              + 4 * n_real + 4 * _unique(nbr[real]) + 4 * r)
    if hub_forb is not None:
        n_hub = hub_forb.shape[0] - 1
        slot, _ = gather_rows(hub_slot[:, None], rows, n_hub)
        hub_rows = work & (slot[:, 0] < n_hub)
        nbytes += 4 * int(work.sum()) + int(hub_rows.sum()) * window
    return nbytes, 4 * n_real


def jpl_extrema_work(ell_idx, rows, source) -> tuple[int, int]:
    """Bytes and operations the jpl_extrema kernel needs on these inputs,
    each read once: ``rows`` (when given), 4 bytes per real ELL entry of
    the graph rows (the padding is never read), the distinct table entries
    they touch (and the round), the two int32 outputs; two compares an
    entry and, for the hash source, ~10 integer operations at each
    uncolored neighbour."""
    hashed = isinstance(source, Hash)
    vec = source.colors if hashed else source.prio
    pad = vec.shape[0] - 1
    nbr, ok = gather_rows(ell_idx, rows, pad)
    r = nbr.shape[0]
    real = (nbr != pad) & ok[:, None]
    n_real = int(real.sum())
    nbytes = ((0 if rows is None else 4 * r) + 4 * n_real
              + 4 * _unique(nbr[real]) + 8 * r + (4 if hashed else 0))
    ops_ = 2 * n_real
    if hashed:
        ops_ += 10 * int((real & (vec[nbr] == ipgc.NO_COLOR)).sum())
    return nbytes, ops_


def _tiles_gathered(args, nbr):
    """The colors and priority tiles of conflict, fused_compact and
    fused_step's earlier signature."""
    return args[0][nbr], args[1][nbr]


def _jpl_tile(args, nbr):
    """jpl_extrema's earlier tile: the table's priorities, or the colors
    gather and the hash passes of the hash source."""
    src = args[2]
    if isinstance(src, Table):
        return src.prio[nbr]
    return torch.where(src.colors[nbr] == ipgc.NO_COLOR,
                       round_hash(nbr, src.rnd), -1)


@dataclasses.dataclass(frozen=True)
class Gathering:
    """A kernel that gathers the neighbours itself: its plain twin, its
    work on the inputs, where its ``ell_idx`` (then ``rows``), window and
    hub tables sit in its arguments, and the tiles its earlier, pre-gathered
    signature needed (``old_tiles(args, nbr)``, at the (R, K) neighbour
    ids ``nbr``)."""

    plain: object
    work: object
    ell_at: int
    window_at: "int | None"
    hub_at: "int | None"      # hub_forb (None: no hub tables)
    slot_at: "int | None"     # hub_slot
    old_tiles: object

    def vector(self, args) -> torch.Tensor:
        """The int32[N+1] vector the neighbour ids index."""
        return args[2][0] if self.ell_at == 0 else args[0]


GATHERING = {
    "mex_window": Gathering(mex_window_rows_plain, mex_window_work, 1, 7, 5,
                            6, lambda a, nbr: a[0][nbr]),
    "conflict": Gathering(conflict_rows_plain, conflict_work, 2, None, None,
                          None, _tiles_gathered),
    "fused_compact": Gathering(fused_compact_rows_plain, fused_compact_work,
                               2, 13, 10, 12, _tiles_gathered),
    "fused_step": Gathering(fused_step_rows_plain, fused_step_work, 2, 12, 9,
                            11, _tiles_gathered),
    "jpl_extrema": Gathering(jpl_extrema_rows_plain, jpl_extrema_work, 0,
                             None, None, None, _jpl_tile),
}


def old_gathers(name, args):
    """The PyTorch gathers the earlier, pre-gathered signature needed on
    these operands, as three callables: the (R, K) neighbour tiles at the
    neighbour-id tile (``Gathering.old_tiles``); for a hub variant the
    (R, W) forbidden rows (and for fused_compact and fused_step the (R,)
    lose flags) at each row's hub slot (None without hubs); and the build
    of the neighbour-id tile, which the sparse steps made (``ell_rows``;
    None for the dense steps, whose tile is the graph's)."""
    gk = GATHERING[name]
    ell_idx, rows = args[gk.ell_at:gk.ell_at + 2]
    pad = gk.vector(args).shape[0] - 1
    nbr = ell_idx if rows is None else gather_rows(ell_idx, rows, pad)[0]
    hub = None
    if gk.hub_at is not None and args[gk.hub_at] is not None:
        hub_forb, hub_slot = args[gk.hub_at], args[gk.slot_at]
        tables = args[gk.hub_at:gk.slot_at]      # forbidden [, lose]
        slot = (hub_slot if rows is None
                else gather_rows(hub_slot[:, None], rows,
                                 hub_forb.shape[0] - 1)[0][:, 0])

        def hub():
            return tuple(tb[slot] for tb in tables)

    def ell_rows():
        return gather_rows(ell_idx, rows, pad)[0]

    return ((lambda: gk.old_tiles(args, nbr)), hub,
            None if rows is None else ell_rows)


def gather_row(name, args, kw, shape: dict, reps: int) -> dict:
    """A gathering kernel's row at one recorded call: equality with the
    plain twin, kernel / plain times (the kernel at the call's own
    ``tile_rows`` and at the default block), the bound on these inputs
    and the time of the earlier signature's gathers (``gather_ms``: the
    neighbour tiles' ``tile_gather_ms`` plus the hub rows'
    ``hub_gather_ms``)."""
    gk = GATHERING[name]
    kernel = getattr(ops, name)
    pkw = untiled(kw)
    nbytes, ops_ = gk.work(*args, **pkw)
    row = kernel_row(name, lambda: kernel(*args, **kw),
                     lambda: gk.plain(*args, **pkw), nbytes, ops_, shape,
                     None, reps, tile_rows=kw.get("tile_rows"),
                     default=lambda: kernel(*args, **pkw))
    tiles, hub, ell_rows = old_gathers(name, args)
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


def kernel_phase(ig, window: int, reps: int = 10) -> dict:
    """Each kernel at the kron main paths' shapes (the IPGC dense steps, the
    JPL dense round, a bottom-up BFS level): equality with the plain
    version, then kernel / plain / library times and the bound; for the
    kernels that gather the neighbours themselves also the time of the
    gathers their earlier signature needed (``gather_ms``)."""
    o = main_path_operands(ig, window)
    r, k, tile = o["n"], o["k"], o["tile_rows"]
    mask = o["active"]
    shape = dict(rows=r, k=k, window=window, hubs=ig.n_hub > 0)
    rows = {}

    def entry(name, kernel, plain, nbytes, ops_, library=None):
        rows[name] = kernel_row(name, kernel, plain, nbytes, ops_, shape,
                                library, reps)

    for name in ("mex_window", "conflict", "fused_compact"):
        args, kw = o[name]
        rows[name] = gather_row(name, args, kw, shape, reps)
    args, kw = o["fused_compact"]
    rows["fused_compact"]["stream_ops"] = stream_ops(
        lambda: ops.fused_compact(*args, **kw))
    entry("compact",
          lambda: ops.compact(mask, o["capacity"], o["n"]),
          lambda: compact_plain(mask, o["capacity"], o["n"]),
          nbytes=r + o["capacity"] * 4 + 4, ops_=r,
          library=lambda: torch.nonzero(mask))
    rows["compact"]["stream_ops"] = stream_ops(
        lambda: ops.compact(mask, o["capacity"], o["n"]))
    args, kw = o["jpl_extrema"]
    rows["jpl_extrema"] = gather_row("jpl_extrema", args, kw, shape, reps)
    TILE_MS.update(tile_kernels_main_path(o, window, KRON["name"]))
    del o, args, kw
    # a bottom-up BFS level's tile; bfs.bottomup_step passes unvisited all
    # true, so the probe is a row any()
    frontier = bottomup_frontier(ig)
    nbr = torch.cat([frontier, frontier.new_zeros(1)])[ig.ell_idx]
    unvisited = torch.ones(r, dtype=torch.bool, device=ig.device)
    entry("frontier_probe", lambda: ops.frontier_probe(nbr, unvisited),
          lambda: frontier_probe_plain(nbr, unvisited),
          nbytes=r * k + 2 * r, ops_=r * k,
          library=lambda: torch.any(nbr, dim=1))
    log(phase="kernels.main_path", rows=list(rows.values()), tile_rows=tile,
        frontier_size=int(frontier.sum()))
    return rows


# --- the hub side-channel's kernels -------------------------------------------

#: the hub kernels' wrappers (both counted as ``KERNEL_LAUNCHES["hub"]``)
HUB_KERNELS = ("hub_forbidden", "hub_lose")
HUB_PLAIN = {"hub_forbidden": hub_forbidden_plain, "hub_lose": hub_lose_plain}


class HubRecorder:
    """Wraps ``ops.hub_forbidden`` and ``ops.hub_lose`` while active. Counts
    each call's entries that its gate lets through (a device scalar, read
    after the run) and keeps the operands of the calls whose index is in
    ``keep[name]``: the graph's tail arrays and slots as they are, copies
    of the step's colors, base (or priority) and gate, no counter."""

    def __init__(self, keep: "dict | None" = None):
        self.keep = keep or {}
        self.on = {name: [] for name in HUB_KERNELS}
        self.kept = {name: {} for name in HUB_KERNELS}

    def __enter__(self):
        self.real = {name: getattr(ops, name) for name in HUB_KERNELS}
        for name in HUB_KERNELS:
            setattr(ops, name, self._spy(name))
        return self

    def _spy(self, name):
        real = self.real[name]

        def spy(*args):
            i = len(self.on[name])
            self.on[name].append(args[6][args[0]].sum())
            if i in self.keep.get(name, ()):
                self.kept[name][i] = (args[:4]
                                      + tuple(a.clone() for a in args[4:7])
                                      + args[7:-1] + (None,))
            return real(*args)
        return spy

    def __exit__(self, *exc):
        for name in HUB_KERNELS:
            setattr(ops, name, self.real[name])

    def shares(self, name: str) -> list:
        """Each call's share of the tail's entries its gate let through."""
        return [int(x) for x in self.on[name]]


def hub_bytes(name: str, args) -> int:
    """The bytes the benchmark's byte rule (``bench/kernels``) counts for
    this call: what its work needs, nothing the gate skips."""
    from bench import catalog, tracing
    kernel = f"{name}_kernel"
    rec = tracing.Recorder({kernel: catalog.kernel_rules()[kernel]})
    with rec.installed():
        getattr(ops, name)(*args)
    return rec.bytes[kernel]


def hub_row(name: str, args, shape: dict, reps: int) -> dict:
    """A hub kernel's row at one recorded call: byte for byte equal to its
    plain twin, then kernel / plain ms beside the gated bound."""
    return kernel_row(name, lambda: getattr(ops, name)(*args),
                      lambda: HUB_PLAIN[name](*args), hub_bytes(name, args),
                      0, shape, None, reps)


def hub_host(g, kept: dict, reps: int = 200) -> dict:
    """The host's side of the hub side-channel. In an untraced, warm kron
    ipgc two-phase coloring: the host seconds of each ``ops.hub_*`` call
    (checks, library lookup, launch) and inside the steps' ``ipgc.hub``
    regions (the calls, the gates and folds around them), beside the
    coloring's seconds. Then, on a kept sparse call, ``reps`` calls back to
    back: the wrapper's host µs against the bare launch function's on the
    same pointers."""
    timed = {name: [] for name in HUB_KERNELS}
    regions: list = []
    real = {name: getattr(ops, name) for name in HUB_KERNELS}
    real_span = ipgc._hub_span

    def clocked(name):
        def call(*args):
            t0 = time.perf_counter()
            out = real[name](*args)
            timed[name].append(time.perf_counter() - t0)
            return out
        return call

    @contextlib.contextmanager
    def region(ig, part):
        t0 = time.perf_counter()
        with real_span(ig, part) as sp:
            yield sp
        regions.append(time.perf_counter() - t0)

    repro_torch.color(g, fused=False)
    torch.cuda.synchronize()
    for name in HUB_KERNELS:
        setattr(ops, name, clocked(name))
    ipgc._hub_span = region
    try:
        r = repro_torch.color(g, fused=False)
    finally:
        ipgc._hub_span = real_span
        for name in HUB_KERNELS:
            setattr(ops, name, real[name])
    out = dict(iterations=r.iterations, color_seconds=r.total_seconds,
               hub_regions=len(regions), hub_region_seconds=sum(regions))
    for name in HUB_KERNELS:
        out[f"{name}_calls"] = len(timed[name])
        out[f"{name}_call_seconds"] = sum(timed[name])
        out[f"{name}_call_us"] = 1e6 * sum(timed[name]) / len(timed[name])
    # the wrapper against the bare launch, on one kept sparse call
    args = kept["hub_forbidden"]
    tail_src, tail_dst, valid, slot, colors, base, gate, window, n_hub, _ = \
        args
    fn = _build.function("hub", "hub_forbidden_launch",
                         hub_mod._FORB_ARGTYPES)
    table = torch.empty((n_hub + 1, window), dtype=torch.bool,
                        device=colors.device)
    ptrs = [t.data_ptr() for t in (tail_src, tail_dst, valid, slot, colors,
                                   base, gate)]
    stream = torch.cuda.current_stream().cuda_stream
    t_entries = tail_src.shape[0]

    def bare():
        _build.check(fn(*ptrs, window, t_entries, n_hub, table.data_ptr(),
                        None, stream), "hub_forbidden")

    for what, call in (("wrapper", lambda: ops.hub_forbidden(*args)),
                       ("bare", bare)):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        out[f"{what}_us"] = 1e6 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
    return out


def hub_phase(g, reps: int = 10) -> dict:
    """The hub kernels at the operands a kron ipgc two-phase coloring
    (``repro_torch.color``, the host loop) hands them: its first call
    (the dense step) and, of the sparse steps' calls, those whose gate let
    through the most, the median and the fewest entries. A first coloring
    counts each call's entries; a second, the same, keeps those calls.
    Each is held byte for byte against its plain twin and timed beside the
    bound of the bytes its byte rule counts; then the host's side
    (``hub_host``). Returns the kernels line's two rows."""
    with HubRecorder() as rec:
        repro_torch.color(g, fused=False)
    picks, share = {}, {}
    for name in HUB_KERNELS:
        on = share[name] = rec.shares(name)
        sparse = sorted(range(1, len(on)), key=lambda i: (on[i], i))
        picks[name] = {"dense": 0, "sparse_most": sparse[-1],
                       "sparse_median": sparse[len(sparse) // 2],
                       "sparse_fewest": sparse[0]}
    with HubRecorder({name: set(p.values()) for name, p in picks.items()}
                     ) as rec:
        repro_torch.color(g, fused=False)
    if any(rec.shares(name) != share[name] for name in HUB_KERNELS):
        raise AssertionError("hub calls: the second kron coloring differs "
                             "from the first")
    rows = {}
    for name in HUB_KERNELS:
        t_entries = rec.kept[name][0][0].shape[0]
        by = {}
        for what, i in picks[name].items():
            args = rec.kept[name][i]
            shape = dict(call=i, calls=len(share[name]), entries=t_entries,
                         let_through=share[name][i],
                         gate_share=share[name][i] / t_entries,
                         n_hub=args[-2],
                         window=args[7] if name == "hub_forbidden" else None)
            by[what] = dict(hub_row(name, args, shape, reps), step=what)
        row = by.pop("dense")
        row["sparse"] = list(by.values())
        row["gate_share_mean"] = (sum(share[name])
                                  / (t_entries * len(share[name])))
        rows[name] = row
    host = hub_host(g, {name: rec.kept[name][picks[name]["sparse_median"]]
                        for name in HUB_KERNELS})
    del rec
    log(phase="kernels.hub", rows=list(rows.values()), host=host)
    return rows


#: the int8 decode's kernel, held exactly against its twin at these (B, S,
#: Hk, G, D): Minitron-4B's widths (one sequence, 8 KV heads of 128, G = 3)
#: at 32,768 positions and at 140,000, past 133,144, where 127^2 * S passes
#: 2^31 and the values' int32 sums of 127s wrap; ``q8_serve_shape`` adds
#: phase 8's int8 serving shape
Q8_CHECKED = ((1, 32_768, 8, 3, 128), (1, 140_000, 8, 3, 128))
#: the timed shapes (also held exactly): Minitron-4B at 32,768 positions
#: (the row's numbers) and at long_500k's 524,288 (``long``)
Q8_TIMED = ((1, 32_768, 8, 3, 128), (1, 524_288, 8, 3, 128))


def q8_serve_shape() -> tuple:
    """(B, S, Hk, G, D) of phase 8's int8 decode: ``LM_SERVE``'s batch, its
    cache of prompt + generated positions, ``LM_ARCH``'s heads."""
    from repro_torch.configs import get_arch

    cfg = get_arch(LM_ARCH).make_config()
    return (LM_SERVE["batch"], LM_SERVE["prompt_len"] + LM_SERVE["gen"],
            cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)


def q8_operands(shape: tuple, gen, fill=None) -> tuple:
    """(qq, k, pq, v) of one layer's decode at ``shape`` (B, S, Hk, G, D):
    random int8 in [-127, 127], or every entry ``fill`` (v its negative)."""
    b, s, hk, g, d = shape
    dev = torch.device("cuda")

    def draw(size, value):
        if value is not None:
            return torch.full(size, value, dtype=torch.int8, device=dev)
        return torch.randint(-127, 128, size, generator=gen, device=dev,
                             dtype=torch.int16).to(torch.int8)

    return (draw((b, hk, g, d), fill), draw((b, s, hk, d), fill),
            draw((b, hk, g, s), fill),
            draw((b, s, hk, d), None if fill is None else -fill))


def q8_row(reps: int = 10) -> dict:
    """``q8_dot`` against its plain twin, exactly, at ``Q8_CHECKED`` and
    phase 8's serving shape (random and all 127s, whose values wrap past
    2^31 at 140,000), then one layer's pair of calls timed, and held
    exactly, at ``Q8_TIMED``: the row's ms, plain ms and bound (both calls'
    bytes, their int8 FLOPs at the int8 peak) at 32,768 positions, and
    ``long`` at 524,288. Its launches are the LM phase's."""
    from repro_torch.kernels import q8_dot
    from repro_torch.launch.mesh import PEAK_FLOPS

    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    checked, err = [], 0
    for shape in (*Q8_CHECKED, q8_serve_shape()):
        s = shape[1]
        for fill in (None, 127):
            qq, k, pq, v = q8_operands(shape, gen, fill)
            want = q8_dot.values_plain(pq, v)
            err = max(err, assert_equal(
                (ops.q8_scores(qq, k), ops.q8_values(pq, v)),
                (q8_dot.scores_plain(qq, k), want),
                f"q8_dot at {shape}, fill={fill}"))
            exact = -fill * fill * s if fill else 0
            wraps = abs(exact) >= 2**31
            if fill and not torch.all(
                    want == (exact + 2**31) % 2**32 - 2**31):
                raise AssertionError(f"q8_dot at {shape}: the sum is not "
                                     "the exact one modulo 2^32")
            checked.append(dict(shape=shape, fill=fill, equal=True,
                                wraps=wraps))
    if not any(c["wraps"] for c in checked):
        raise AssertionError("q8_dot: no checked sum wrapped past 2^31")

    def timed(shape: tuple) -> dict:
        b, s, hk, g, d = shape
        qq, k, pq, v = q8_operands(shape, gen)
        out = {}
        for name, fn, plain, a, cache, n_out in (
                ("scores", ops.q8_scores, q8_dot.scores_plain, qq, k,
                 b * hk * g * s),
                ("values", ops.q8_values, q8_dot.values_plain, pq, v,
                 b * hk * g * d)):
            assert_equal(fn(a, cache), plain(a, cache),
                         f"q8_dot {name} at {shape}")
            nbytes = a.numel() + cache.numel() + 4 * n_out
            int8_ops = q8_dot.flops(a, cache)["int8"]
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = int8_ops / PEAK_FLOPS["int8"]
            out[name] = dict(
                ms=cuda_ms(lambda: fn(a, cache), reps),
                plain_ms=cuda_ms(lambda: plain(a, cache), 3),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, int8_ops=int8_ops)
        return out

    main = timed(Q8_TIMED[0])
    at_long = timed(Q8_TIMED[1])
    b, s, hk, g, d = Q8_TIMED[0]
    row = dict(
        name="q8_dot", route="cuda", source=SOURCES["q8_dot"][0],
        replaces=SOURCES["q8_dot"][1], launches=0, max_abs_err=err,
        equal=True, ms=sum(v["ms"] for v in main.values()),
        plain_ms=sum(v["plain_ms"] for v in main.values()),
        bound_ms=sum(v["bound_ms"] for v in main.values()),
        bound_by="bytes" if all(v["bound_by"] == "bytes"
                                for v in main.values()) else "operations",
        library_ms=None, parts=main,
        long=dict(s=Q8_TIMED[1][1], parts=at_long,
                  ms=sum(v["ms"] for v in at_long.values()),
                  bound_ms=sum(v["bound_ms"] for v in at_long.values())),
        checked=checked,
        shape=dict(batch=b, s=s, kv_heads=hk, group=g, head_dim=d))
    log(phase="kernels.q8_dot", **row)
    return row


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
SPARSE_ROWS = {("ipgc", False): ("mex_window", "conflict", "compact"),
               ("ipgc", True): ("fused_compact",),
               ("jpl", None): ("jpl_extrema",)}


def recorder(name: str, n: int) -> Recorder:
    """A recorder of the sparse steps' calls of ``name``: a gathering
    kernel's calls from items blocks, or compact's over fewer than ``n``
    flags (an items block's, not a dense worklist's)."""
    if name == "compact":
        return Recorder(name, lambda _, a: a[0].shape[0]
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
    gk = GATHERING[rec.name]
    shape = dict(rows=c, k=args[gk.ell_at].shape[1],
                 window=None if gk.window_at is None else args[gk.window_at],
                 hubs=gk.hub_at is not None and args[gk.hub_at] is not None,
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
    and jpl runs record the sparse steps' calls of ``SPARSE_ROWS`` and
    time each at its most-used capacity bucket. With
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
    calls and times the kernel at its most-used capacity bucket, and the
    ipgc two-phase and jpl runs record their ``mex_window`` and
    ``jpl_extrema`` calls, held against the plain twins at a shard's dense
    shape and the most-used sparse one (``dist_held_check``). Each run
    in ``boundary`` is followed by its boundary and auto exchanges
    (``boundary_phase``; with ``traced``, a traced auto run of ipgc
    fused too). Returns
    the kernel launches of each run, and the prepared partitioned graph,
    the mesh, the window, that sparse entry for the ``fused_step``
    row and the held calls by kernel (``checked``)."""
    sess = default_session()
    mesh = dist.resolve_mesh(None, devices, sess.device)
    t0 = time.perf_counter()
    g2, relabel = sess.partition(g, len(mesh))
    partition_s = time.perf_counter() - t0
    replay_ig = repro_torch.prepare(g2)
    launches, sparse, checked = [], None, {}
    for algo, fused, per_iter in runs:
        alg = get_algorithm(algo)
        rec = (Recorder("fused_step")
               if record and (algo, fused) == ("ipgc", True) else None)
        held = [Recorder(name, all_rows) for name in
                (DIST_HELD.get((algo, fused), ()) if record else ())]
        max_iter = 10_000
        if devices is not None:
            max_iter = DIST_ROUND_CAP.get(algo, max_iter)
        start_counts()
        with contextlib.ExitStack() as stack, \
                ipgc.LAUNCH_COUNTS.scope() as passes, \
                dist.EXCHANGE_COUNTS.scope() as exchanges:
            for r_ in held if rec is None else held + [rec]:
                stack.enter_context(r_)
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
        for h in held:
            checked[h.name] = dist_held_check(h, len(mesh), reps)
        del rec, held
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
                          sparse=sparse, checked=checked)


#: the kernels whose dist calls a recorded run holds against their twins
DIST_HELD = {("ipgc", False): ("mex_window",), ("jpl", None): ("jpl_extrema",)}


def dist_held_check(rec: Recorder, shards: int, reps: int) -> dict:
    """The recorded calls of a distributed run (a shard's dense call and
    the sparse calls at the most-used capacity) made again through the
    kernel, at the tile the run used, and through its plain twin: exactly
    equal, both timed."""
    kernel, plain = getattr(ops, rec.name), GATHERING[rec.name].plain
    dense = max(rec.calls)             # a shard's block: the largest call
    out = []
    for r in sorted({dense, rec.most_used()[0]}):
        args, kw = rec.args[r]
        err = assert_equal(kernel(*args, **kw), plain(*args, **untiled(kw)),
                           f"{rec.name} dist S={shards} rows={r}")
        out.append(dict(rows=r, calls=rec.calls[r], dense=r == dense,
                        max_abs_err=err, ms=cuda_ms(
                            lambda: kernel(*args, **kw), reps),
                        plain_ms=cuda_ms(lambda: plain(*args, **untiled(kw)),
                                         2), tile_rows=kw.get("tile_rows")))
    log(phase="kernels.dist_shapes", name=rec.name, shards=shards,
        calls=sum(rec.calls.values()), checked=out, equal=True)
    return dict(shards=shards, calls=sum(rec.calls.values()), checked=out)


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
               "fused_step_kernel", "hub_forbidden_kernel", "hub_lose_kernel")


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
LANE_PLAIN = {"mex_window": mex_window_rows_plain,
              "conflict": conflict_rows_plain,
              "compact": compact_plain,
              "fused_compact": fused_compact_rows_plain,
              "jpl_extrema": jpl_extrema_rows_plain, **HUB_PLAIN}
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
    recs = [Recorder(name, lambda *_: 0, copy=True) for name in LANE_PLAIN]
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


def tile_kernels_main_path(o: dict, window: int, graph: str) -> dict:
    """The five row kernels the reference tiles at ``graph``'s dense shape
    (``main_path_operands``), at each candidate tile: equal to their plain
    twins; ms per tile, beside the default block's and the tile the main
    path resolves ("auto")."""
    f_args, f_kw = o["fused_compact"]
    f_kw = untiled(f_kw)
    s_args = f_args[:8] + f_args[9:]
    rows = {}
    for name in ("mex_window", "conflict", "jpl_extrema"):
        args, _ = o[name]
        rows[name] = tile_row(
            name, lambda t, a=args, fn=getattr(ops, name): fn(*a, tile_rows=t),
            lambda a=args, gk=GATHERING[name]: gk.plain(*a))
    rows["fused_compact"] = tile_row(
        "fused_compact",
        lambda t: ops.fused_compact(*f_args, **f_kw, tile_rows=t),
        lambda: fused_compact_rows_plain(*f_args, **f_kw))
    rows["fused_step"] = tile_row(
        "fused_step", lambda t: ops.fused_step(*s_args, tile_rows=t),
        lambda: fused_step_rows_plain(*s_args))
    log(phase="tune.kernels_main_path", graph=graph, rows=o["n"], k=o["k"],
        window=window, auto_tile=o["tile_rows"], ms_by_tile=rows,
        equal=True)
    return rows


def tile_check_phase(g) -> None:
    """The five row kernels at ``g``'s dense shape at every candidate tile
    (``tile_kernels_main_path``): the tile the main path resolves against
    the default block at a shape other than kron's."""
    ig = repro_torch.prepare(g)
    o = main_path_operands(ig, adaptive_window(g))
    tile_kernels_main_path(o, adaptive_window(g), g.name)
    del ig, o
    torch.cuda.empty_cache()


def tile_kernels_edge_cases(dev) -> None:
    """The five row kernels at the edge-case sizes, each at every
    candidate tile (and blocks past the 1024-thread cap), equal to their
    plain twins (``jpl_extrema`` with both sources)."""
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

    rnd = torch.tensor(7, dtype=torch.int32, device=dev)
    checked = 0
    for rg in (1, 7, 257, 3000):
        for k in (1, 8, 40, 128):
            for w in (32, 256):
                for sparse, hub in ((False, False), (True, True)):
                    c = gather_case(rg * 3 + k + w + sparse, rg, k,
                                    sparse=sparse, hub=hub, window=w, lo=3)
                    r = len(c["cu"])
                    m = [t(c[n]) for n in MEX_NAMES]
                    f = [t(c[n]) for n in FUSED_NAMES]
                    s_ = f[:8] + f[9:]
                    sources = (Table(t(jpl_prio_table(c, rg + k + w))),
                               Hash(f[0], rnd))
                    what = f"rg={rg} k={k} w={w} sparse={sparse}"
                    for tile in tune.CANDIDATES + (1024,):
                        assert_equal(ops.mex_window(*m, w, tile_rows=tile),
                                     mex_window_rows_plain(*m, w),
                                     f"mex_window {what} tile={tile}")
                        for src in sources:
                            a = (f[2], f[3], src)
                            assert_equal(ops.jpl_extrema(*a, tile_rows=tile),
                                         jpl_extrema_rows_plain(*a),
                                         f"jpl_extrema {what} tile={tile} "
                                         f"{source_name(src)}")
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
                        checked += 6
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


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tree_to(tree: dict, dev) -> dict:
    return _tree_map(lambda v: v.to(dev), tree)


def lm_serve_params(cfg):
    """The serving cell's weights: ``cfg`` at random init on the card from
    ``LM_SEED`` (seconds to draw)."""
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    with Timer() as t:
        with torch.inference_mode():
            params, _ = tfm.init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
    return params, t.seconds


def weight_sums(params: dict) -> dict:
    """Each leaf's sum in fp64: a fingerprint that tells two draws of the
    weights apart."""
    out = {}
    for k, v in params.items():
        for name, t in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f"{k}/{name}"] = float(t.double().sum())
    return out


#: the kernel launches of phase 8's int8 serving run (the q8 row's)
_lm_launches: dict = {}


def lm_serve_phase(card: str) -> dict:
    """Qwen3-30B-A3B at its published widths, 8 of 48 layers, bf16: init
    at random from a seed, ``serve()`` with the reference's defaults with
    a bf16 and an int8 KV cache (each after an untimed warm-up call), and
    the checks: decode at position 63 equals forward there
    (``LM_DECODE_REL``, at a capacity that drops no token: see the log),
    every logit finite, the int8 run's first decode step within
    ``LM_INT8_REL`` of the bf16 run's; then ``lm_decode_profile``.
    Returns the weights' ``weight_sums`` (``mesh_serve_phase`` serves the
    same weights again after the training phases)."""
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
    params, init_s = lm_serve_params(cfg)
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
        n_params=n_params, gb=n_params * 2 / 1e9, init_seconds=init_s)
    for kv_int8 in (False, True):       # each cache's first use untimed
        serve(cfg, params=params, batch=LM_SERVE["batch"],
              prompt_len=LM_SERVE["prompt_len"], gen=2, kv_int8=kv_int8,
              generator=torch.Generator(device=dev).manual_seed(99))
    runs = {}
    for kv_int8 in (False, True):
        torch.cuda.reset_peak_memory_stats()
        with _build.KERNEL_LAUNCHES.scope() as kl:
            r = serve(cfg, params=params, kv_int8=kv_int8,
                      generator=torch.Generator(device=dev).manual_seed(1),
                      **LM_SERVE)
            launches = kl["q8_dot"]
        if (launches > 0) != kv_int8:
            raise AssertionError(f"lm serve int8={kv_int8}: q8_dot "
                                 f"launched {launches} times")
        if kv_int8:
            _lm_launches["q8_dot"] = launches
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
            q8_dot_launches=launches, sample=r.tokens[0, :8].tolist())
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
    sums = weight_sums(params)          # phase 11 serves these again
    del params, runs, plain, q8
    reset_peak()
    torch.cuda.empty_cache()
    return sums


# --- the LM training path -----------------------------------------------------

#: card = CPU for one ``build_step`` step at the smoke configs, fp32 (TF32
#: off): the driver's optimizer settings, a short sequence (the tolerances
#: are ``tests/_train_check.py``'s)
TRAIN_OPT = dict(lr=3e-3, warmup_steps=20, total_steps=200)
TRAIN_SMOKE = dict(batch=8, seq_len=32)
#: the resume check: one dense smoke config (every op of its step has a
#: deterministic CUDA form under ``use_deterministic_algorithms``), 8
#: steps against 4 + a restore + 4
TRAIN_RESUME_ARCH = "minitron-4b"
TRAIN_RESUME_STEPS = 8
#: the full-width training cell: Minitron-4B at all 32 layers, bf16, on the
#: reference driver's traffic (batch 8 x 128, lr 3e-3, warmup 20), 20
#: steps, the update a layer at a time, each layer recomputed in backward
TRAIN_ARCH = "minitron-4b"
TRAIN_FULL = dict(batch=8, seq_len=128)
TRAIN_FULL_OPT = dict(lr=3e-3, warmup_steps=20, total_steps=20,
                      update_in_chunks=True)
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for the block. cuBLAS is
    deterministic on one stream with a fixed workspace; torch asks for the
    setting before it allows a GEMM in this mode."""
    prev_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_ws is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_ws


def _cpu_params(cfg, seed: int = 0):
    from repro_torch.models import transformer as tfm
    params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    return params


def train_card_vs_cpu_phase() -> None:
    """One ``build_step`` step of each LM smoke config on the card and on
    the CPU from the same weights, state and batch (fp32, TF32 off); then
    one ``--compress`` step at one replica. Gaps and tolerances as
    ``tests/_train_check.py`` states them."""
    from _train_check import step_gaps, to_device
    from repro_torch.configs import get_arch
    from repro_torch.data.pipelines import TokenPipeline
    from repro_torch.launch.train import build_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.compression import compress_init

    opt_cfg = AdamWConfig(**TRAIN_OPT)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch, compress in [(a, False) for a in LM_ARCHS] + [
                ("gemma-7b", True)]:
            cfg = get_arch(arch).make_smoke()
            params = _cpu_params(cfg)
            batch = TokenPipeline(vocab=cfg.vocab, global_batch=TRAIN_SMOKE[
                "batch"], seq_len=TRAIN_SMOKE["seq_len"]).batch_at(0, "cpu")
            out = {}
            for where in ("cpu", "cuda"):
                p = to_device(params, where)
                b = {k: v.to(where) for k, v in batch.items()}
                if compress:
                    step = build_step(cfg, opt_cfg, compress=True,
                                      mesh=[where])
                    p, o, _, m = step(p, adamw_init(p), [compress_init(p)],
                                      b)
                else:
                    p, o, m = build_step(cfg, opt_cfg)(p, adamw_init(p), b)
                out[where] = (p, o, m)
            torch.cuda.synchronize()
            gaps = step_gaps(out["cuda"], out["cpu"],
                             wd=opt_cfg.weight_decay, compressed=compress)
            log(phase="train.card_vs_cpu", arch=arch, compress=compress,
                loss=float(out["cpu"][2]["loss"]),
                grad_norm=float(out["cpu"][2]["grad_norm"]), gaps=gaps,
                equal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def train_resume_phase() -> None:
    """``train()`` for ``TRAIN_RESUME_STEPS`` steps straight against half,
    a checkpoint, a restore into fresh state and the other half, on the
    card under deterministic algorithms: the same losses and final
    parameters, exactly. Then a checkpoint written on the CPU restored
    onto the card equals the CPU's state exactly."""
    from _train_check import to_device
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves

    cfg = get_arch(TRAIN_RESUME_ARCH).make_smoke()
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2,
                          total_steps=TRAIN_RESUME_STEPS)
    params = _cpu_params(cfg, 1)
    kw = dict(log=lambda line: None, **TRAIN_SMOKE)
    half = TRAIN_RESUME_STEPS // 2
    with deterministic(), tempfile.TemporaryDirectory() as d:
        straight = train(cfg, opt_cfg, params=to_device(params, "cuda"),
                         device="cuda", **kw)
        first = train(cfg, opt_cfg, steps=half, ckpt_dir=d,
                      params=to_device(params, "cuda"), device="cuda", **kw)
        second = train(cfg, opt_cfg, ckpt_dir=d,
                       params=to_device(params, "cuda"), device="cuda", **kw)
    losses = torch.cat([first.losses, second.losses])
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(second.params), tree_leaves(straight.params)))
    if (second.start, len(losses)) != (half, TRAIN_RESUME_STEPS) or \
            not torch.equal(losses, straight.losses) or not same_params:
        raise AssertionError(
            f"train resume: {losses.tolist()} against "
            f"{straight.losses.tolist()}, params equal {same_params}")
    with tempfile.TemporaryDirectory() as d:
        cpu = train(cfg, opt_cfg, steps=2, ckpt_dir=d,
                    params=to_device(params, "cpu"), device="cpu", **kw)
        fresh = to_device(params, "cuda")
        back = restore_checkpoint(d, 1, {"params": fresh,
                                         "opt": adamw_init(fresh)})
    want = [cpu.opt.step, *tree_leaves(cpu.opt.m), *tree_leaves(cpu.opt.v),
            *tree_leaves(cpu.params)]
    got = [back["opt"].step, *tree_leaves(back["opt"].m),
           *tree_leaves(back["opt"].v), *tree_leaves(back["params"])]
    if not all(g.device.type == "cuda" and torch.equal(g.cpu(), w.detach())
               for g, w in zip(got, want)):
        raise AssertionError("a CPU checkpoint restored onto the card "
                             "differs")
    log(phase="train.resume", arch=TRAIN_RESUME_ARCH,
        steps=TRAIN_RESUME_STEPS, resumed_at=half, **TRAIN_SMOKE,
        losses=straight.losses.tolist(), equal=True,
        cpu_checkpoint_on_card=dict(step=int(back["opt"].step), leaves=len(
            got), equal=True))


def train_full_phase(card: str) -> dict:
    """Minitron-4B at its published widths and all 32 layers, bf16,
    random weights from seed 0 (``train``'s): ``launch.train.train`` with
    the reference driver's traffic for 20 steps, ``update_in_chunks`` and
    remat. Logs init seconds, each step's ms (CUDA events; the median of
    steps 3-20), tok/s, the model-FLOPs share, peak GiB and every loss and
    grad norm; gates: all finite, grad norms > 0, peak under the card's
    memory (running out of it fails the phase)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig

    default_session().cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).make_config(),
                              remat=True)
    free, total = torch.cuda.mem_get_info()
    opt_cfg = AdamWConfig(**TRAIN_FULL_OPT)
    lines = []
    torch.cuda.reset_peak_memory_stats()
    r = train(cfg, opt_cfg, log_every=10, log=lines.append, **TRAIN_FULL)
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms = r.losses.tolist(), r.grad_norms.tolist()
    finite = bool(torch.isfinite(r.losses).all()
                  and torch.isfinite(r.grad_norms).all())
    if not finite or min(gnorms) <= 0 or peak >= total:
        raise AssertionError(f"train full: losses {losses}, grad norms "
                             f"{gnorms}, peak {peak} of {total} bytes")
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq_len"]
    step_ms = float(np.median(r.step_ms[2:20]))
    head = cfg.vocab * cfg.d_model
    non_embedding = cfg.n_params - 2 * head
    flops = 6 * non_embedding * tokens
    out = dict(
        card=card, arch=TRAIN_ARCH, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, act=cfg.act, vocab=cfg.vocab,
        dtype=str(cfg.dtype), remat=cfg.remat, **TRAIN_FULL,
        opt=TRAIN_FULL_OPT, n_params=cfg.n_params,
        non_embedding_params=non_embedding, free_gb_before=free / 1e9,
        init_seconds=r.init_s, step_ms=r.step_ms,
        step_ms_median_3_20=step_ms, tok_s=tokens / (step_ms / 1e3),
        mfu=flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
        mfu_with_head=6 * (non_embedding + head) * tokens
        / (step_ms / 1e3) / BF16_FLOPS_PER_S,
        loop_seconds=r.seconds, peak_gib=peak / 2**30,
        card_gib=total / 2**30, losses=losses, grad_norms=gnorms,
        driver_log=lines, finite=True)
    log(phase="train.full", **out)
    del r
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- the GNN and DLRM models -------------------------------------------------

#: each full-width cell runs this many training steps; step ms is the
#: median of steps 3-20
GNN_STEPS = 20
#: the ``molecule`` shape (30 nodes, 64 edges a graph, 128 graphs) padded
#: as the reference's ``steps.py::gnn_full_case`` pads it (to 1,024)
MOLECULE = dict(n_nodes=4096, n_edges=8192, n_graphs=128, d_feat=16)
MOLECULE_ARCHS = ("equiformer-v2", "egnn", "schnet")
#: ``minibatch_lg``: Reddit's sizes (232,965 nodes, 114,615,892 edges,
#: both directions stored), 602 features, 41 classes; 1,024 seeds, fan-out
#: 15-10. The graph is random at those sizes (no dataset is fetched)
REDDIT = dict(n_nodes=232_965, n_entries=2 * 114_615_892, d_feat=602,
              n_classes=41, batch_nodes=1024, fanout=(15, 10))
#: ``train_batch``, ``serve_bulk`` and ``retrieval_cand`` of the recsys
#: shapes
DLRM_TRAIN_BATCH = 65_536
DLRM_SERVE_BATCH = 262_144
DLRM_CANDIDATES = 1_000_000


def timed_steps(step, n: int) -> tuple[list, list]:
    """``step(i)`` for i < n, a CUDA event at each step boundary: (each
    step's ms, each step's return value). The events time the card's
    timeline, so a step that waits for the host counts the wait."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    out = []
    ev[0].record()
    for i in range(n):
        out.append(step(i))
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(n)], out


def profile_once(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device µs and
    operations (the events on the card), the host's ATen calls, and the
    device operations that take the most time."""
    from torch.autograd import DeviceType

    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    ev = p.key_averages()
    on_card = sorted((e for e in ev if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return dict(device_us=sum(e.self_device_time_total for e in on_card),
                device_ops=sum(e.count for e in on_card),
                host_ops=sum(e.count for e in ev
                             if e.key.startswith("aten::")),
                top=[[e.key, e.count, e.self_device_time_total]
                     for e in on_card[:8]])


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def train_summary(card: str, step_ms: list, metrics: list, rate_name: str,
                  per_step: int) -> dict:
    """Step ms (each, and the median of steps 3-20), the rate, peak GiB,
    every loss and grad norm; fails unless all are finite and every grad
    norm is above 0."""
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    if not all(np.isfinite(losses + gnorms)) or min(gnorms) <= 0:
        raise AssertionError(f"losses {losses}, grad norms {gnorms}")
    med = float(np.median(step_ms[2:GNN_STEPS]))
    return {"card": card, "steps": len(step_ms), "step_ms": step_ms,
            "step_ms_median_3_20": med, rate_name: per_step / (med / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "losses": losses, "grad_norms": gnorms, "finite": True}


def gnn_card_vs_cpu_phase() -> None:
    """The five GNN/DLRM smoke configs in fp32 (TF32 off): one train step
    (the family's loss, its gradient, the default AdamW) on the card and
    on the CPU from the same params and batch, within the CPU parity
    tests' tolerances (``tests/_gnn_steps.py::card_cpu_gaps``);
    ``sample_blocks`` and ``RecsysPipeline.batch_at`` on the card equal to
    the CPU bit for bit; ``forward_full_owner`` at four shards on the card
    equal to ``forward_full``."""
    import _gnn_steps as gs

    dev = torch.device("cuda")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in gs.SMOKE_ARCHS:
            log(phase="gnn.card_vs_cpu", arch=arch,
                gaps=gs.step_card_vs_cpu(arch, dev),
                tol=dict(loss=gs.LOSS_RTOL, grads=gs.GRAD_TOL,
                         attn=gs.ATTN_GRAD_TOL, params=gs.PARAM_TOL),
                equal=True)
        log(phase="gnn.card_vs_cpu", what="sample_blocks",
            **gs.sampler_card_vs_cpu(dev), equal=True)
        log(phase="gnn.card_vs_cpu", what="RecsysPipeline",
            **gs.pipeline_card_vs_cpu(dev), equal=True)
        log(phase="gnn.card_vs_cpu", what="forward_full_owner", shards=4,
            max_abs_err=gs.owner_card(dev), tol=1e-5, equal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gnn_molecule_phase(card: str) -> None:
    """EquiformerV2, EGNN and SchNet at their published configs on the
    ``molecule`` shape as ``steps.py`` pads it (4,096 nodes, 8,192 edges,
    128 graphs, 16 features), fp32, the batch from ``random_graph_batch``
    with threefry key 0, the targets from key 1: ``GNN_STEPS`` steps of the
    family's loss, gradient and the default AdamW. Logs each step's ms,
    graphs/s at the median, peak GiB, every loss and grad norm, and one
    more step's profile."""
    from repro_torch.launch import steps
    from repro_torch.configs import get_arch
    from repro_torch.data import pipelines as rnd
    from repro_torch.models.gnn.common import random_graph_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    m = MOLECULE
    for arch in MOLECULE_ARCHS:
        free_card()
        cfg = get_arch(arch).make_config()
        if arch == "egnn":
            cfg = dataclasses.replace(cfg, d_in=m["d_feat"])
        t0 = time.perf_counter()
        batch = random_graph_batch(rnd.prng_key(0), m["n_nodes"],
                                   m["n_edges"], m["d_feat"], coords=True,
                                   n_graphs=m["n_graphs"])
        targets = torch.from_numpy(rnd.normal(rnd.prng_key(1),
                                              (m["n_graphs"],))).cuda()
        params, _ = steps.GNN_MODS[arch].init_params(cfg)
        opt = adamw_init(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step = steps.full_step(arch, cfg, AdamWConfig())
        state = [params, opt]

        def one(i):
            state[0], state[1], met = step(state[0], state[1], batch,
                                           targets)
            return met

        ms, metrics = timed_steps(one, GNN_STEPS)
        out = train_summary(card, ms, metrics, "graphs_s", m["n_graphs"])
        log(phase="gnn.molecule", arch=arch, **m, config={
            k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "dtype"}, n_params=sum(p.numel() for p in
                                           params.values()),
            init_seconds=init_s, profile_one_step=profile_once(
                lambda: one(GNN_STEPS)), **out)
        del params, opt, state, batch, metrics
    free_card()


def gnn_minibatch_phase(card: str) -> None:
    """GraphSAGE-Reddit on ``minibatch_lg``: a random graph at Reddit's
    sizes, drawn on the card from a seeded ``torch.Generator``
    (``random_graph_batch``'s generator path) and sorted into CSR there;
    ``GNN_STEPS`` steps of ``sample_blocks`` (fan-out 15-10 over 1,024
    seeds drawn on the card), ``loss_sampled``, its gradient and the
    default AdamW. Logs the build seconds and peak, each step's ms,
    seeds/s, peak GiB, and one step's profile."""
    from repro_torch.launch import steps
    from repro_torch.configs import get_arch
    from repro_torch.data import pipelines as rnd
    from repro_torch.models.gnn import graphsage
    from repro_torch.models.gnn.common import random_graph_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    r = REDDIT
    free_card()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    g = random_graph_batch(gen, r["n_nodes"], r["n_entries"], r["d_feat"],
                           n_classes=r["n_classes"])
    row_ptr, col_idx = steps.csr_from_edges(g.edge_src, g.edge_dst,
                                         r["n_nodes"])
    feats, labels = g.node_feat, g.node_label
    del g
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    if int(row_ptr[-1]) != r["n_entries"]:
        raise AssertionError("minibatch: the CSR lost entries")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch("graphsage-reddit").make_config(),
                              fanouts=r["fanout"], d_in=r["d_feat"])
    params, _ = graphsage.init_params(cfg)
    opt = adamw_init(params)
    seed_gen = torch.Generator(device="cuda")
    seed_gen.manual_seed(1)
    seeds = [torch.randint(0, r["n_nodes"], (r["batch_nodes"],),
                           generator=seed_gen, device="cuda",
                           dtype=torch.int32) for _ in range(GNN_STEPS + 1)]
    step = steps.minibatch_step("graphsage-reddit", cfg, AdamWConfig(),
                             r["fanout"])
    state = [params, opt]

    def one(i):
        state[0], state[1], met = step(state[0], state[1], feats, None,
                                       labels, row_ptr, col_idx, seeds[i],
                                       rnd.fold_in(rnd.prng_key(0), i))
        return met

    ms, metrics = timed_steps(one, GNN_STEPS)
    out = train_summary(card, ms, metrics, "seeds_s", r["batch_nodes"])
    prof = profile_once(lambda: one(GNN_STEPS))
    log(phase="gnn.minibatch", arch="graphsage-reddit", **r, config={
        k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"},
        build_seconds=build_s, build_peak_gib=build_peak,
        graph_gb=dict(col_idx=col_idx.numel() * 4 / 1e9,
                      feats=feats.numel() * 4 / 1e9),
        profile_one_step=prof, **out)
    del params, opt, state, row_ptr, col_idx, feats, labels, seeds, metrics
    free_card()


def recsys_train_phase(card: str) -> None:
    """DLRM-RM2 at its published config (26 tables of 1,000,000 x 64,
    fp32) on ``train_batch``: ``GNN_STEPS`` steps of the loss, its
    gradient and AdamW with ``update_in_chunks`` (a table at a time) on
    ``RecsysPipeline`` batches (made before the timed loop, their ms
    logged) and one more step's profile. Then one ``retrieval_score`` over
    ``retrieval_cand``'s 1,000,000 candidates and one ``forward`` at
    ``serve_bulk``'s 262,144 rows (ms each, CUDA events, under
    ``inference_mode``)."""
    from repro_torch.launch import steps
    from repro_torch.configs import get_arch
    from repro_torch.data.pipelines import RecsysPipeline
    from repro_torch.models import dlrm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    free_card()
    cfg = get_arch("dlrm-rm2").make_config()
    t0 = time.perf_counter()
    params, _ = dlrm.init_params(cfg)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.vocab_per_table,
                          DLRM_TRAIN_BATCH)
    t0 = time.perf_counter()
    batches = [pipe.batch_at(i) for i in range(GNN_STEPS)]
    torch.cuda.synchronize()
    pipeline_ms = (time.perf_counter() - t0) * 1e3 / GNN_STEPS
    opt_cfg = AdamWConfig(update_in_chunks=True)
    step = steps.dlrm_step(cfg, opt_cfg)
    state = [params, opt]

    def one(i):
        state[0], state[1], met = step(state[0], state[1], batches[i])
        return met

    ms, metrics = timed_steps(one, GNN_STEPS)
    out = train_summary(card, ms, metrics, "samples_s", DLRM_TRAIN_BATCH)
    prof = profile_once(lambda: one(0))
    del batches, metrics
    with torch.inference_mode():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        cands = torch.randn((DLRM_CANDIDATES, cfg.embed_dim), device="cuda",
                            generator=gen)
        q = pipe.batch_at(GNN_STEPS)
        scores = dlrm.retrieval_score(params, q["dense"][:1],
                                      q["sparse"][:1], cands, cfg)
        retrieval_ms = cuda_ms(lambda: dlrm.retrieval_score(
            params, q["dense"][:1], q["sparse"][:1], cands, cfg))
        bulk = RecsysPipeline(cfg.n_dense, cfg.n_sparse,
                              cfg.vocab_per_table, DLRM_SERVE_BATCH
                              ).batch_at(0)
        logits = dlrm.forward(params, bulk["dense"], bulk["sparse"], cfg)
        bulk_ms = cuda_ms(lambda: dlrm.forward(params, bulk["dense"],
                                               bulk["sparse"], cfg), reps=5)
        finite = bool(torch.isfinite(scores).all()
                      and torch.isfinite(logits).all())
    if not finite or scores.shape != (DLRM_CANDIDATES,) or \
            logits.shape != (DLRM_SERVE_BATCH,):
        raise AssertionError("dlrm serve: non-finite or misshapen output")
    log(phase="recsys.train", arch="dlrm-rm2", batch=DLRM_TRAIN_BATCH,
        n_params=cfg.n_params, table_gb=cfg.n_sparse * cfg.vocab_per_table
        * cfg.embed_dim * 4 / 1e9, init_seconds=init_s,
        pipeline_ms_per_batch=pipeline_ms, opt=dict(update_in_chunks=True),
        profile_one_step=prof,
        retrieval=dict(candidates=DLRM_CANDIDATES, ms=retrieval_ms),
        serve_bulk=dict(batch=DLRM_SERVE_BATCH, ms=bulk_ms,
                        samples_s=DLRM_SERVE_BATCH / (bulk_ms / 1e3)),
        **out)
    del params, opt, state, cands, bulk, logits, scores
    free_card()


def gnn_phase(card: str, mark) -> None:
    """Phase 10: the GNN and DLRM models (no kernel of this repo: the
    reference has none there)."""
    gnn_card_vs_cpu_phase()
    mark("gnn.card_vs_cpu")
    gnn_molecule_phase(card)
    mark("gnn.molecule")
    gnn_minibatch_phase(card)
    mark("gnn.minibatch")
    recsys_train_phase(card)
    mark("recsys.train")


# --- the models on a device mesh ---------------------------------------------------

#: the smoke configs of ``mesh.card_vs_cpu`` (two MoE stacks and a dense
#: one) and its meshes of ``cuda:0``, the batch and the expert ``ff`` both
#: over ``data``
MESH_SMOKE_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                    "minitron-4b")
MESH_SHAPES = ((1, 4), (2, 2))
MESH_AXES = dict(batch_axes=("data",), fsdp_axes=("data",))
#: ``mesh.lm_serve``'s meshes: experts over 4 model shards, and the batch
#: split in two besides
MESH_SERVE = ((1, 4), (2, 4))
#: ``mesh.lm_serve``: the (1, 4) run's peak may exceed the unsharded
#: run's by this much (no weight is copied: the placed experts are views)
MESH_PEAK_SLACK_GIB = 1.0
#: ``mesh.eqv2``: edge shards and steps
MESH_EQV2_SHARDS = 4
MESH_EQV2_STEPS = 5


def _lm_mesh_outputs(params, cfg, toks, mesh) -> dict:
    """Forward logits, prefill of 9 tokens and three teacher-forced decode
    steps, and ``loss_fn``'s gradient of each leaf, on ``mesh``."""
    from repro_torch.models import transformer as tfm

    kw = dict(mesh=mesh, **MESH_AXES)
    out = {"forward": tfm.forward(params, toks, cfg, **kw)[0]}
    last, cache = tfm.prefill(params, toks[:, :9], cfg, max_len=16, **kw)
    out["prefill"] = last
    for i in range(9, 12):
        out[f"decode{i}"], cache = tfm.decode_step(params, toks[:, i:i + 1],
                                                   cache, cfg, **kw)
    grad_params = _tree_map(lambda v: v.detach().clone().requires_grad_(),
                            params)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    loss, _ = tfm.loss_fn(grad_params, batch, cfg, **kw)
    loss.backward()
    out["loss"] = loss.detach()
    for k, v in grad_params.items():
        for name, t in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f"grad/{k}/{name}"] = t.grad
    return out


def mesh_card_vs_cpu_phase() -> None:
    """The MoE and dense LM smoke configs in fp32 (TF32 off) on meshes
    (1, 4) and (2, 2) of ``cuda:0`` and of the CPU, the same weights and
    tokens: forward, prefill plus three decode steps and ``loss_fn``'s
    gradients within ``LM_CPU_TOL`` (logits absolute over max(1, their
    largest); each gradient leaf relative to its largest); then the
    EquiformerV2 smoke step at four edge shards, card = CPU within the
    GNN parity tolerances."""
    import _gnn_steps as gs
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in MESH_SMOKE_ARCHS:
            cfg = get_arch(arch).make_smoke()
            params = _cpu_params(cfg)
            card = _tree_to(params, "cuda")
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab, (4, 12)))
            for shape in MESH_SHAPES:
                want = _lm_mesh_outputs(params, cfg, toks, make_mesh(
                    shape, ("data", "model"), "cpu"))
                got = _lm_mesh_outputs(card, cfg, toks.cuda(), make_mesh(
                    shape, ("data", "model"), "cuda:0"))
                errs = {}
                for k, w in want.items():
                    scale = float(w.abs().max()) if k.startswith("grad/") \
                        else max(1.0, float(w.abs().max()))
                    errs[k] = _max_abs(got[k].cpu(), w) / max(scale, 1e-30)
                bad = {k: e for k, e in errs.items() if not e <= LM_CPU_TOL}
                if bad:
                    raise AssertionError(f"mesh {arch} {shape}: the card "
                                         f"differs from the CPU: {bad}")
                log(phase="mesh.card_vs_cpu", arch=arch, mesh=list(shape),
                    **MESH_AXES, loss=float(want["loss"]),
                    worst=max(errs.values()),
                    worst_of=max(errs, key=errs.get), tol=LM_CPU_TOL,
                    equal=True)
        log(phase="mesh.card_vs_cpu", arch="equiformer-v2",
            edge_shards=MESH_EQV2_SHARDS, edge_shard_axes=["data"],
            gaps=gs.eqv2_mesh_card_vs_cpu(torch.device("cuda"),
                                           MESH_EQV2_SHARDS),
            tol=dict(loss=gs.LOSS_RTOL, grads=gs.GRAD_TOL,
                     attn=gs.ATTN_GRAD_TOL, params=gs.PARAM_TOL),
            equal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _serve_run(cfg, params, mesh, gen: int = LM_SERVE["gen"]):
    """``serve()`` at ``LM_SERVE`` on ``mesh`` (None: unsharded), prompts
    and sampling from seed 1; (result, peak GiB of the run)."""
    from repro_torch.launch.serve import serve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw = {} if mesh is None else dict(mesh=mesh, **MESH_AXES)
    r = serve(cfg, params=params, generator=torch.Generator(
        device="cuda").manual_seed(1), **{**LM_SERVE, "gen": gen}, **kw)
    return r, torch.cuda.max_memory_allocated() / 2**30


def mesh_serve_phase(card: str, lm_sums: dict) -> None:
    """Phase 8's Qwen3-30B-A3B weights (8 of 48 layers, bf16), drawn again
    from ``LM_SEED`` (their ``weight_sums`` equal to phase 8's, ``lm_sums``;
    holding them on the host between the phases would add 11.2 GB to the
    host's peak), their experts placed once (``place_params``: views) on
    meshes (1, 4) and (2, 4) of ``cuda:0``; ``serve()`` at ``LM_SERVE`` on
    each and without a mesh, each after an untimed warm-up. Checks: the
    (1, 4) run's peak within ``MESH_PEAK_SLACK_GIB`` of the unsharded
    run's; then, under ``deterministic()`` (a repeat bit-equal), at (1, 4)
    and a capacity that drops no token the prefill and a decode step
    (position 63, teacher-forced) within ``LM_DECODE_REL`` of the
    unsharded ones, and at (2, 4) the prefill logits within
    ``LM_DECODE_REL`` of two unsharded prefills of the half batches (each
    data shard's MoE sees only its own tokens, its capacity theirs)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh, place_params
    from repro_torch.models import transformer as tfm

    free_card()
    cfg = dataclasses.replace(get_arch(LM_ARCH).make_config(),
                              n_layers=LM_LAYERS)
    params, init_s = lm_serve_params(cfg)
    if weight_sums(params) != lm_sums:
        raise AssertionError("mesh serve: other weights than phase 8's")
    meshes = {s: make_mesh(s, ("data", "model"), "cuda:0")
              for s in MESH_SERVE}
    placed = {s: place_params(params, m, fsdp_axes=MESH_AXES["fsdp_axes"])
              for s, m in meshes.items()}
    log(phase="mesh.lm_init", arch=LM_ARCH, layers=cfg.n_layers,
        init_seconds=init_s, same_weights_as_phase_8=True,
        resident_gib=torch.cuda.memory_allocated() / 2**30)
    runs, base_peak = {}, None
    with torch.inference_mode():
        for shape in (None, *MESH_SERVE):
            p = params if shape is None else placed[shape]
            m = None if shape is None else meshes[shape]
            _serve_run(cfg, p, m, gen=2)          # warm-up
            r, peak = _serve_run(cfg, p, m)
            if not (torch.isfinite(r.prefill_logits).all()
                    and torch.isfinite(r.step_logits).all()):
                raise AssertionError(f"mesh serve {shape}: a logit is not "
                                     "finite")
            runs[shape] = r
            log(phase="mesh.lm_serve", card=card, arch=LM_ARCH,
                layers=cfg.n_layers, mesh=list(shape) if shape else None,
                **(MESH_AXES if shape else {}), **LM_SERVE,
                prefill_ms=r.prefill_s * 1e3, prefill_tok_s=r.prefill_tok_s,
                decode_ms_per_step=r.decode_ms_per_step,
                decode_tok_s=r.decode_tok_s, peak_gib=peak,
                peak_over_unsharded_gib=None if shape is None
                else peak - base_peak, finite=True)
            if shape is None:
                base_peak = peak
            elif shape == (1, 4) and not peak - base_peak <= \
                    MESH_PEAK_SLACK_GIB:
                raise AssertionError(f"mesh serve (1, 4): peak {peak} GiB "
                                     f"against {base_peak} unsharded")
        prompts = runs[None].prompts
        for r in runs.values():
            if not torch.equal(r.prompts, prompts):
                raise AssertionError("mesh serve: the runs served other "
                                     "prompts")
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    half = LM_SERVE["batch"] // 2
    # the checks under deterministic algorithms: each number below is the
    # same in every run on this software, not one draw of the atomics'
    # order (a near tie in a router flips with it)
    with torch.inference_mode(), deterministic():
        out = {}
        for shape, p, m in ((None, params, None),
                            ((1, 4), placed[(1, 4)], meshes[(1, 4)])):
            kw = {} if m is None else dict(mesh=m, **MESH_AXES)
            last, cache = tfm.prefill(p, prompts[:, :63], no_drop,
                                      max_len=64, **kw)
            step, _ = tfm.decode_step(p, prompts[:, 63:64], cache, no_drop,
                                      **kw)
            out[shape] = (last, step)
            del cache
        again = tfm.prefill(placed[(1, 4)], prompts[:, :63], no_drop,
                            mesh=meshes[(1, 4)], **MESH_AXES)[0]
        one_by_four = dict(
            prefill_rel=_rel(out[(1, 4)][0], out[None][0]),
            decode_rel=_rel(out[(1, 4)][1], out[None][1]),
            repeat_equal=bool(torch.equal(again, out[(1, 4)][0])),
            served_prefill_rel=_rel(runs[(1, 4)].prefill_logits,
                                    runs[None].prefill_logits))
        two = tfm.prefill(placed[(2, 4)], prompts, cfg, mesh=meshes[(2, 4)],
                          **MESH_AXES)[0]
        halves = torch.cat([tfm.prefill(params, prompts[:half], cfg)[0],
                            tfm.prefill(params, prompts[half:], cfg)[0]])
        two_by_four = dict(
            prefill_vs_halves_rel=_rel(two, halves),
            prefill_vs_whole_batch_rel=_rel(
                two, tfm.prefill(params, prompts, cfg)[0]),
            served_vs_halves_rel=_rel(runs[(2, 4)].prefill_logits, halves))
    if not (one_by_four["prefill_rel"] <= LM_DECODE_REL
            and one_by_four["decode_rel"] <= LM_DECODE_REL
            and one_by_four["repeat_equal"]):
        raise AssertionError(f"mesh (1, 4): {one_by_four} from the "
                             "unsharded run")
    if not two_by_four["prefill_vs_halves_rel"] <= LM_DECODE_REL:
        raise AssertionError(f"mesh (2, 4): {two_by_four} from the half "
                             "batches")
    log(phase="mesh.lm_checks", one_by_four=one_by_four,
        one_by_four_capacity_factor=no_drop.moe.capacity_factor,
        two_by_four=two_by_four, tol=LM_DECODE_REL, deterministic=True,
        equal=True)
    del params, placed, runs, out, halves, two, again
    free_card()


def mesh_eqv2_phase(card: str) -> None:
    """EquiformerV2 at its published config on the ``molecule`` shape
    (``gnn_molecule_phase``'s batch and targets), ``MESH_EQV2_STEPS`` steps
    unsharded and then with each edge chunk split over
    ``MESH_EQV2_SHARDS`` shards of ``cuda:0``, from the same init: each
    run's step ms and losses; the first step's loss within
    ``LOSS_RTOL`` of the unsharded one (the same weights: only the sums'
    order differs)."""
    import _gnn_steps as gs
    from repro_torch.launch import steps
    from repro_torch.configs import get_arch
    from repro_torch.data import pipelines as rnd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn.common import random_graph_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    m = MOLECULE
    base = get_arch("equiformer-v2").make_config()
    batch = random_graph_batch(rnd.prng_key(0), m["n_nodes"], m["n_edges"],
                               m["d_feat"], coords=True,
                               n_graphs=m["n_graphs"])
    targets = torch.from_numpy(rnd.normal(rnd.prng_key(1),
                                          (m["n_graphs"],))).cuda()
    runs = {}
    for shards in (None, MESH_EQV2_SHARDS):
        free_card()
        cfg = base if shards is None else dataclasses.replace(
            base, edge_shard_axes=("data",))
        mesh = None if shards is None else make_mesh((shards,), ("data",),
                                                     "cuda:0")
        params, _ = steps.GNN_MODS["equiformer-v2"].init_params(cfg)
        state = [params, adamw_init(params)]
        step = steps.full_step("equiformer-v2", cfg, AdamWConfig(),
                               mesh=mesh)

        def one(i):
            state[0], state[1], met = step(state[0], state[1], batch,
                                           targets)
            return met

        ms, metrics = timed_steps(one, MESH_EQV2_STEPS)
        losses = [float(x["loss"]) for x in metrics]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"mesh eqv2 {shards}: losses {losses}")
        runs[shards] = losses
        log(phase="mesh.eqv2", card=card, arch="equiformer-v2",
            edge_shards=shards, edge_chunk=cfg.edge_chunk, **m,
            step_ms=ms, step_ms_median_2_5=float(np.median(ms[1:])),
            graphs_s=m["n_graphs"] / (float(np.median(ms[1:])) / 1e3),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            losses=losses)
        del params, state, metrics
    first = abs(runs[MESH_EQV2_SHARDS][0] - runs[None][0]) / abs(runs[None][0])
    if not first <= gs.LOSS_RTOL:
        raise AssertionError(f"mesh eqv2: first loss {first} relative from "
                             "the unsharded step's")
    log(phase="mesh.eqv2_checks", first_loss_rel=first,
        last_loss_rel=abs(runs[MESH_EQV2_SHARDS][-1] - runs[None][-1])
        / abs(runs[None][-1]), tol=gs.LOSS_RTOL, equal=True)
    free_card()


def mesh_phase(card: str, mark, lm_sums: dict) -> None:
    """Phase 11: the models on a device mesh (no kernel of this repo: the
    reference's models have none). ``lm_sums``: phase 8's
    ``weight_sums``."""
    mesh_card_vs_cpu_phase()
    mark("mesh.card_vs_cpu")
    mesh_serve_phase(card, lm_sums)
    mark("mesh.lm_serve")
    mesh_eqv2_phase(card)
    mark("mesh.eqv2")


# --- phase 12: the step builders' cases -----------------------------------------------

#: the card's dense bf16 tensor-core peak (H100 SXM data sheet): the
#: denominator of a case's model-FLOPs share
BF16_PEAK_FLOPS = 989.4e12
#: ``cases.run``: the cells run at their published config and registry
#: shape, each one warm-up step and ``CASES_TIMED`` timed ones; every other
#: cell (and decode variant) runs only where its reckoning fits
CASES_RUN = (("paper-ipgc", "suite_kron"), ("paper-ipgc", "suite_europe"),
             *(("dlrm-rm2", s) for s in ("train_batch", "serve_p99",
                                         "serve_bulk", "retrieval_cand")),
             *((a, s) for a in ("schnet", "egnn", "graphsage-reddit")
               for s in ("full_graph_sm", "molecule", "minibatch_lg")),
             ("equiformer-v2", "molecule"))
CASES_TIMED = 3
#: a reckoned cell runs when its bytes stay within this share of the
#: card's free memory at the phase's start
CASES_FIT = 0.85
#: the reckoning's smaller shape: each kind's size divided by this (an LM
#: at ``RECKON_LAYERS`` layers besides), the measured activations times
#: the same factor (an LM's training and prefill times its layers over
#: ``RECKON_LAYERS`` too: every layer's saved input and KV are kept)
RECKON_CUT = {"train": 64, "prefill": 256, "decode": 16, "gnn_full": 64,
              "gnn_minibatch": 64}
RECKON_CUT_CELL = {("equiformer-v2", "ogb_products"): 16384}
RECKON_LAYERS = 2
#: the coloring step's kernels, which ``cases.run`` counts on the
#: paper-ipgc cells
IPGC_KERNELS = ("mex_window", "conflict", "compact")


def _gib(nbytes: float) -> float:
    return nbytes / 2**30


def case_cells() -> list:
    """(arch, shape, variant) of every registry cell, then the LM decode
    shapes' other variants."""
    from repro_torch.launch import steps
    cells = [(a, s, "base") for a, s in steps.registry_cells()]
    return cells + [(a, s, v) for a, s, _ in cells
                    if s in ("decode_32k", "long_500k")
                    for v in steps.DECODE_VARIANTS]


def cases_meta_phase() -> None:
    """Every cell built abstract (``build_case(..., abstract=True)``): its
    model FLOPs, tokens, kind and argument bytes; no byte allocated on the
    card."""
    from repro_torch.launch import steps

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    for a, s, v in case_cells():
        case = steps.build_case(a, s, variant=v, abstract=True)
        log(phase="cases.meta", arch=a, shape=s, variant=v,
            model_flops=case.meta["model_flops"],
            tokens=case.meta["tokens"], kind=case.meta["kind"],
            kv_bytes=case.meta.get("kv_bytes"),
            arg_bytes=steps.arg_bytes(case),
            n_params=steps.n_params(case), donate=list(case.donate))
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    if grown or torch.cuda.mem_get_info()[0] < free0:
        raise AssertionError(f"cases.meta allocated {grown} bytes")
    log(phase="cases.meta_done", cells=len(case_cells()),
        seconds=time.perf_counter() - t0, allocated_bytes=grown)


def cases_card_vs_cpu_phase() -> None:
    """Each smoke case of ``tests/_case_check.py::CASES`` (every family's
    case function at its smoke config and a small shape) on the card and
    on the CPU from the same arguments, fp32 with TF32 off, within that
    file's tolerances; the coloring step exactly."""
    import _case_check as cc

    dev = torch.device("cuda")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for spec in cc.CASES:
            log(phase="cases.card_vs_cpu", case=cc.case_id(spec),
                gaps=cc.card_vs_cpu(spec, dev), equal=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log(phase="cases.card_vs_cpu_done", cases=len(cc.CASES),
        tol=dict(lm=cc.LM_CPU_TOL, lm_int8=cc.LM_CPU_TOL_Q8,
                 serve=cc.SERVE_TOL, bf16_state=cc.BF16_STATE_TOL))


def reckon_shape(arch_id: str, shape_name: str):
    """(arch, shape, factor, how) of the smaller shape a cell's
    activations are measured at: the size cut by ``RECKON_CUT``, an LM at
    ``RECKON_LAYERS`` layers, EquiformerV2's edge chunk cut with its
    edges; ``factor`` scales the measured bytes back."""
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch import steps

    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    cut = RECKON_CUT_CELL.get((arch_id, shape_name), RECKON_CUT[shape.kind])
    p, cfg = dict(shape.params), arch.make_config()
    if arch.family == "lm":
        # the tokens cut by ``cut``: the batch first, down to the fewest
        # rows the step takes (training: one a microbatch), then the
        # sequence
        b, seq = p["global_batch"], p["seq_len"]
        least = steps._MICROBATCHES.get(arch_id, 1) \
            if shape.kind == "train" else 1
        p["global_batch"] = max(b // cut, least)
        p["seq_len"] = max(seq * b // (cut * p["global_batch"]), 1)
        factor = b * seq / (p["global_batch"] * p["seq_len"])
        if shape.kind != "decode":
            factor *= cfg.n_layers / RECKON_LAYERS
        cfg = dataclasses.replace(cfg, n_layers=RECKON_LAYERS)
    elif shape.kind == "gnn_full":
        p["n_nodes"] = max(p["n_nodes"] // cut, 1)
        p["n_edges"] = max(p["n_edges"] // cut, 1)
        factor = cut
        if arch_id == "equiformer-v2":
            cfg = dataclasses.replace(cfg, edge_chunk=max(
                min(cfg.edge_chunk, 262144) // cut, 1))
    else:                                    # gnn_minibatch
        p["batch_nodes"] = max(p["batch_nodes"] // cut, 1)
        factor = cut
    small = dataclasses.replace(arch, make_config=lambda: cfg)
    return small, ShapeSpec(shape.name + "_reckon", shape.kind, p), factor, p


def measure_step(case) -> int:
    """Bytes one step of ``case`` takes from the card above its arguments
    at its peak: the caching allocator's peak reserved bytes over the
    bytes allocated before the step, so that the blocks a step frees but
    cannot reuse for a larger tensor count, and the free parts of the
    segments earlier phases still hold count as taken (a step at the full
    shape cannot count on either; the case's arguments resident, the
    cache emptied first)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # the blocks the arguments' draws left
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = case.fn(*case.args)
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_reserved() - base


def reckon(arch_id: str, shape_name: str, variant: str, budget: int
           ) -> dict:
    """The cell's reckoned bytes before anything of it is allocated: its
    arguments (parameters, optimizer state, inputs; from the abstract
    case), then, where those fit ``budget``, what one step takes above
    them (``measure_step``) at ``reckon_shape``, scaled. ``fits`` decides
    the run."""
    from repro_torch.launch import steps

    full = steps.build_case(arch_id, shape_name, variant=variant,
                            abstract=True)
    args = steps.arg_bytes(full)
    out = dict(arg_bytes=args, budget_bytes=budget)
    if args > budget:
        return dict(out, fits=False, reckoned_bytes=args,
                    reason="its arguments alone exceed the budget")
    small, shape, factor, params = reckon_shape(arch_id, shape_name)
    free_card()
    case = steps.case_for(small, shape, variant=variant, device="cuda")
    act = measure_step(case)
    del case
    free_card()
    total = args + act * factor
    return dict(out, fits=total <= budget, reckoned_bytes=int(total),
                activation_bytes=int(act * factor), measured_at=params,
                measured_layers=RECKON_LAYERS if small.family == "lm"
                else None, measured_activation_bytes=act, factor=factor,
                reason=None if total <= budget else
                "arguments plus the scaled activations exceed the budget")


def _finite(out) -> bool:
    from repro_torch.launch.steps import flatten_args
    return all(bool(torch.isfinite(t).all())
               for _, t in flatten_args(out)
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def run_cell(card: str, arch_id: str, shape_name: str, variant: str,
             reckoned: "dict | None") -> dict:
    """One cell at its published config and shape on the card: the case
    built from seed 0, one warm-up step, ``CASES_TIMED`` steps timed by
    CUDA events; the paper-ipgc cells count their kernels over the timed
    steps and equal the same step through the plain twins, exactly; the
    int8 decode variants count ``q8_dot``'s launches."""
    import _case_check as cc
    from repro_torch.launch import steps

    free_card()
    t0 = time.perf_counter()
    case = steps.build_case(arch_id, shape_name, variant=variant,
                            device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = case.fn(*case.args)                # warm-up
    torch.cuda.synchronize()
    coloring = case.meta["kind"] == "coloring"
    q8 = "int8" in variant
    if coloring or q8:
        start_counts()
    ms, outs = timed_steps(lambda i: case.fn(*case.args), CASES_TIMED)
    extra = {}
    if q8:
        n = _build.KERNEL_LAUNCHES["q8_dot"]
        if not n:
            raise AssertionError(f"{arch_id}/{shape_name}/{variant}: "
                                 "q8_dot never launched")
        _cells_launches["q8_dot"] = _cells_launches.get("q8_dot", 0) + n
        extra = dict(q8_dot_launches=n)
    if coloring:
        counts = _build.KERNEL_LAUNCHES.as_dict()
        launches = {k: counts[SOURCES[k][2]] for k in IPGC_KERNELS}
        if not all(launches.values()):
            raise AssertionError(f"{arch_id}/{shape_name}: a kernel never "
                                 f"launched: {launches}")
        with cc.plain_kernels():
            plain = case.fn(*case.args)
        if not all(cc.coloring_equal(o, plain) for o in [out] + outs):
            raise AssertionError(f"{arch_id}/{shape_name}: the kernels' "
                                 "step differs from the plain twins'")
        _cells_launches.update({k: _cells_launches.get(k, 0) + v
                                for k, v in launches.items()})
        extra = dict(launches=launches, plain_equal=True,
                     colored=int((outs[-1][0][:-1] >= 0).sum()),
                     worklist=int(outs[-1][2].count))
        del plain
    if not all(_finite(o) for o in outs):
        raise AssertionError(f"{arch_id}/{shape_name}: a value is not "
                             "finite")
    mean = float(np.mean(ms))
    row = dict(phase="cases.run", card=card, arch=arch_id, shape=shape_name,
               variant=variant, kind=case.meta["kind"], build_s=build_s,
               step_ms=ms, step_ms_mean=mean,
               rate_per_s=case.meta["tokens"] / (mean / 1e3),
               tokens=case.meta["tokens"],
               model_flops=case.meta["model_flops"],
               mfu=case.meta["model_flops"] / (mean / 1e3 * BF16_PEAK_FLOPS),
               peak_flops=BF16_PEAK_FLOPS, arg_gib=_gib(steps.arg_bytes(case)),
               peak_gib=_gib(torch.cuda.max_memory_allocated()),
               peak_reserved_gib=_gib(torch.cuda.max_memory_reserved()),
               reckoned_gib=None if reckoned is None
               else _gib(reckoned["reckoned_bytes"]), finite=True, **extra)
    log(**row)
    _cells_run.append(row)
    del case, out, outs
    free_card()
    return row


#: the launches of the coloring step's kernels and of ``q8_dot`` over
#: ``cases.run``'s timed steps, for the kernels line
_cells_launches: dict = {}
#: ``cases.run``'s rows, the cells phase 13 holds the dry run to
_cells_run: list = []


def cases_run_phase(card: str, dry: "DryrunProcess") -> None:
    """``CASES_RUN`` at their published configs and shapes, then every
    other cell reckoned (``reckon``) against ``CASES_FIT`` of the free
    memory: run where it fits, else logged with its reckoned bytes, the
    dry run's one-card peak (``dry``'s record) and the reason
    (``cases.left_out``). No out-of-memory error is caught."""
    free_card()
    budget = int(torch.cuda.mem_get_info()[0] * CASES_FIT)
    fixed = {(a, s) for a, s in CASES_RUN}
    for a, s in CASES_RUN:
        run_cell(card, a, s, "base", None)
    left = 0
    for a, s, v in case_cells():
        if (a, s) in fixed:
            continue
        r = reckon(a, s, v, budget)
        if r["fits"]:
            log(phase="cases.admitted", arch=a, shape=s, variant=v,
                arg_gib=_gib(r["arg_bytes"]),
                reckoned_gib=_gib(r["reckoned_bytes"]),
                budget_gib=_gib(budget), measured_at=r["measured_at"],
                factor=r["factor"])
            run_cell(card, a, s, v, r)
        else:
            left += 1
            rec = dry.record(a, s, "card", v)
            if not rec["ok"] and a != "paper-ipgc":
                raise AssertionError(f"{a}/{s}/{v}: the dry run's one-card "
                                     f"record failed: {rec['error']}")
            log(phase="cases.left_out", arch=a, shape=s, variant=v,
                arg_gib=_gib(r["arg_bytes"]),
                reckoned_gib=_gib(r["reckoned_bytes"]),
                dryrun_peak_gib=_gib(rec["memory"]["peak_bytes"])
                if rec["ok"] else None,
                dryrun_error=None if rec["ok"] else rec["error"][-300:],
                budget_gib=_gib(budget), **{
                    k: r[k] for k in ("activation_bytes", "measured_at",
                                      "measured_layers",
                                      "measured_activation_bytes", "factor")
                    if k in r}, reason=r["reason"])
    log(phase="cases.run_done", run=len(case_cells()) - left, left_out=left,
        budget_gib=_gib(budget), fit_share=CASES_FIT)


def cases_phase(card: str, mark, dry: "DryrunProcess") -> None:
    """Phase 12: the step builders' cases (``launch/steps.py``)."""
    cases_meta_phase()
    mark("cases.meta")
    cases_card_vs_cpu_phase()
    mark("cases.card_vs_cpu")
    cases_run_phase(card, dry)
    mark("cases.run")


# --- phase 13: the dry run against the card ------------------------------------

#: the meta count against the card's count of one step, relative: sums of
#: the same integers (the depth and chunk rules' extension is exact in
#: float64 below 2**53)
DRYRUN_EQ = 1e-9
#: a roofline bound above the measured step by more than this means the
#: count is wrong
DRYRUN_SHARE_MAX = 1.05
#: the seconds phase 13 may wait for the dry run's process (it starts
#: after phase 1 and takes ~10 minutes beside phases 2-12)
DRYRUN_WAIT_S = 120.0


class DryrunProcess:
    """The dry run's CLI (``python -m repro_torch.launch.dryrun --all
    --variant all --mesh card,single``) in a process of its own, started
    after phase 1: every case's one-card record and every cell's
    production single-mesh record, counted on the ``meta`` device on one
    of the host's cores beside phases 2-12 (its card is hidden from it;
    the paper-ipgc cells, which need values, phase 13 counts on the
    card). ``record`` waits for a record; ``stop`` ends the process."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        self.out = open(os.path.join(self.dir.name, "dryrun.log"), "w+")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--variant", "all", "--mesh", "card,single", "--outdir",
             self.dir.name], stdout=self.out, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT)

    def record(self, arch: str, shape: str, mesh: str, variant: str,
               wait: float = DRYRUN_WAIT_S) -> dict:
        suffix = "" if variant == "base" else f"__{variant}"
        path = os.path.join(self.dir.name,
                            f"{arch}__{shape}__{mesh}{suffix}.json")
        deadline = time.perf_counter() + wait
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the dry run wrote no {path} (rc "
                                     f"{self.proc.poll()}): "
                                     f"{self.tail()}")
            time.sleep(0.5)
        for _ in range(20):                   # written whole, then read
            try:
                with open(path) as f:
                    return json.load(f)
            except json.JSONDecodeError:
                time.sleep(0.25)
        raise AssertionError(f"{path} does not parse")

    def tail(self, n: int = 2000) -> str:
        self.out.flush()
        self.out.seek(0)
        return self.out.read()[-n:]

    def finish(self) -> dict:
        """Wait for the process; its summary line and seconds."""
        rc = self.proc.wait(timeout=DRYRUN_WAIT_S)
        done = [ln for ln in self.tail(100000).splitlines()
                if ln.startswith("done:")]
        return dict(rc=rc, summary=done[-1] if done else None,
                    seconds=time.perf_counter() - self.t0)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.dir.cleanup()


def _same(a: float, b: float) -> bool:
    return abs(a - b) <= DRYRUN_EQ * max(abs(a), abs(b), 1.0)


def dryrun_card_phase(card: str, dry: DryrunProcess) -> dict:
    """Each cell ``cases.run`` ran: its one-card dry-run record (counted
    on ``meta`` with the depth and chunk rules; the paper-ipgc cells need
    values: none) against one step counted on the card
    (``launch.dryrun.count_case``, after a warm-up step), FLOPs and bytes
    equal; the meta peak beside the card's allocated peak of that step
    (its arguments plus what the step allocated above them) and its
    reserved peak; the one-card roofline bound (``launch/roofline.py``'s
    terms, FLOPs priced by their type, no collective) over ``cases.run``'s
    step ms, at most ``DRYRUN_SHARE_MAX``. Returns the paper-ipgc cells'
    card counts."""
    from repro_torch.launch import dryrun, roofline, steps
    from repro_torch.launch.mesh import HBM_BW

    paper = {}
    for row in _cells_run:
        a, s, v = row["arch"], row["shape"], row["variant"]
        rec = dry.record(a, s, "card", v)
        if not rec["ok"] and a != "paper-ipgc":
            raise AssertionError(f"{a}/{s}/{v}: the dry run failed: "
                                 f"{rec['error']}")
        meta = rec if rec["ok"] else None
        free_card()
        case = steps.build_case(a, s, variant=v, device="cuda")
        out = case.fn(*case.args)                 # warm-up
        del out
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        got = dryrun.count_case(case)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        args = steps.arg_bytes(case)
        alloc_max = torch.cuda.max_memory_allocated()
        reserved_max = torch.cuda.max_memory_reserved()
        step_peak = args + alloc_max - base
        if a == "paper-ipgc":
            paper[s] = dict(got, meta=case.meta)
        del case
        free_card()
        t_comp = roofline.compute_seconds(got["flops_by_dtype"])
        bound_ms = max(t_comp, got["bytes"] / HBM_BW) * 1e3
        share = bound_ms / row["step_ms_mean"]
        if meta is not None and not (
                _same(meta["cost"]["flops"], got["flops"])
                and _same(meta["cost"]["bytes"], got["bytes"])):
            raise AssertionError(f"{a}/{s}/{v}: meta counts {meta['cost']}; "
                                 f"the card {got['flops']} FLOPs, "
                                 f"{got['bytes']} bytes")
        if share > DRYRUN_SHARE_MAX:
            raise AssertionError(f"{a}/{s}/{v}: the roofline bound "
                                 f"{bound_ms} ms is {share:.3f} of the "
                                 f"measured {row['step_ms_mean']} ms")
        meta_peak = None if meta is None else meta["memory"]["peak_bytes"]
        log(phase="dryrun.card", card=card, arch=a, shape=s, variant=v,
            meta_flops=None if meta is None else meta["cost"]["flops"],
            card_flops=got["flops"],
            meta_bytes=None if meta is None else meta["cost"]["bytes"],
            card_bytes=got["bytes"], equal=meta is not None,
            meta_peak_gib=None if meta is None else _gib(meta_peak),
            card_count_peak_gib=_gib(got["peak_bytes"]),
            card_alloc_peak_gib=_gib(step_peak),
            card_alloc_max_gib=_gib(alloc_max),
            card_reserved_peak_gib=_gib(reserved_max),
            peak_ratio=None if meta is None else meta_peak / step_peak,
            arg_gib=_gib(args), bound_ms=bound_ms,
            bound_by="operations" if t_comp >= got["bytes"] / HBM_BW
            else "bytes", flops_by_dtype=got["flops_by_dtype"],
            step_ms=row["step_ms_mean"], share=share,
            kernels=got["kernels"], n_ops=got["n_ops"],
            depths_counted=None if meta is None else meta["depths_counted"],
            meta_s=None if meta is None else meta["total_s"], card_s=card_s)
    return paper


def dryrun_mesh_phase(card: str, dry: DryrunProcess, paper: dict) -> None:
    """Every cell's production single-mesh record (256 entries on the
    ``meta`` device; the paper-ipgc cells' the card's one-card count, the
    coloring step being unsharded) with its roofline row, one
    ``dryrun.mesh`` line a record. A record that failed other than on a
    batch its data shards do not divide fails the phase, and so does a
    dry run whose failed records are more than those and the paper-ipgc
    records it cannot count without the card (the cells' one-card records
    were each held in phase 12 or above)."""
    from repro_torch.launch import dryrun, roofline, steps

    failed = 0
    n_paper = 0
    for a, s, v in dryrun.cell_variants(steps.registry_cells(), "all"):
        rec = dry.record(a, s, "h100_32x8", v)
        if a == "paper-ipgc":
            n_paper += 2                      # its card and mesh records
            got = paper.get(s)
            if got is None:
                continue
            rec.update(ok=True, meta=got["meta"], mesh_form=False,
                       cost={"flops": got["flops"], "bytes": got["bytes"],
                             "flops_by_dtype": got["flops_by_dtype"]},
                       memory={"peak_bytes": got["peak_bytes"]},
                       collectives=got["collectives"], counted_on="cuda")
            rec.pop("error", None)
        if not rec["ok"]:
            failed += 1
            if "does not split" not in rec["error"]:
                raise AssertionError(f"{a}/{s}/{v} on the single mesh: "
                                     f"{rec['error']}")
        r = roofline.roofline_row(rec)
        log(phase="dryrun.mesh", card=card, arch=a, shape=s, variant=v,
            mesh=rec["mesh"], ok=rec["ok"], seconds=rec["total_s"],
            **({k: rec.get(k) for k in (
                "cost", "memory", "collectives", "counted_on",
                "counted_mesh", "depths_counted", "chunks_counted",
                "mesh_form", "arg_shard_bytes")}
               if rec["ok"] else {"error": rec["error"][-400:]}),
            **({k: r[k] for k in ("t_compute", "t_memory", "t_collective",
                                  "bound", "t_bound", "useful_ratio",
                                  "roofline_frac")} if rec["ok"] else {}))
    done = dry.finish()
    log(phase="dryrun.mesh_done", failed=failed, **done)
    want = failed + n_paper
    if done["summary"] is None or not done["summary"].startswith("done:") \
            or int(done["summary"].split(",")[1].split()[0]) != want \
            or done["rc"] != (1 if want else 0):
        raise AssertionError(f"the dry run's summary {done['summary']!r} "
                             f"(rc {done['rc']}): {want} failed records "
                             f"expected ({failed} unsplittable, {n_paper} "
                             "paper-ipgc)")


def dryrun_phase(card: str, mark, dry: DryrunProcess) -> None:
    """Phase 13: the dry run (``launch/dryrun.py``, ``opcost.py``,
    ``roofline.py``) against the card."""
    paper = dryrun_card_phase(card, dry)
    mark("dryrun.card")
    dryrun_mesh_phase(card, dry, paper)
    mark("dryrun.mesh")


def host_peak_gib() -> float:
    """This process's peak resident host memory (``ru_maxrss``, KiB on
    Linux), GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


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
    dry = DryrunProcess()
    try:
        return run_phases(card, mark, marks, t_start, dry)
    finally:
        dry.stop()


def run_phases(card: str, mark, marks: list, t_start: float,
               dry: DryrunProcess) -> int:
    """Phases 2-13, after ``device_phase`` and with the dry run's process
    running."""
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
    del kron_ig
    torch.cuda.empty_cache()
    rows.update(hub_phase(kron))
    default_session().cache.clear()
    q8 = q8_row()
    mark("kernels")
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
    for name, held in ctx.pop("checked").items():
        rows[name]["dist"] = held
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
    totals = {SOURCES[k][2]: sum(c[SOURCES[k][2]] for c in runs)
              for k in COLORING}
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
    lm_sums = lm_serve_phase(card)
    mark("lm.serve")
    train_card_vs_cpu_phase()
    mark("train.card_vs_cpu")
    train_resume_phase()
    mark("train.resume")
    train_full_phase(card)
    mark("train.full")
    gnn_phase(card, mark)
    mesh_phase(card, mark, lm_sums)
    cases_phase(card, mark, dry)
    dryrun_phase(card, mark, dry)
    tune_dir.cleanup()
    for name, row in rows.items():
        row["launches"] = totals[SOURCES[name][2]]
        row["batch_launches"] = batch[SOURCES[name][2]]
        row["lane_rows_checked"] = [r for k, r in LANE_CHECKS if k == name]
        row["tile_ms"] = TILE_MS.get(name)
        row["cases_launches"] = _cells_launches.get(name, 0)
        row["outlined_launches"] = sum(
            o["launches"][SOURCES[name][2]] for by in outlined.values()
            for o in by.values())
    q8["launches"] = _lm_launches["q8_dot"]
    q8["cases_launches"] = _cells_launches.get("q8_dot", 0)
    rows["q8_dot"] = q8
    reset_peak()
    log(phase="done", seconds=time.perf_counter() - t_start,
        peak_mem_gb=_peak_bytes / 2**30, host_peak_gib=host_peak_gib(),
        phase_seconds={b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})
    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
