"""Shared checks of the port's engine against ``repro``'s: the same
registry graph through ``repro.core.color(impl="jnp")`` and
``repro_torch.color(device="cpu")`` gives the same ``ColoringResult``; the
port's distributed Pipe on S CPU shards gives ``repro``'s host-engine
result on ``repro``'s partitioned graph."""
import functools

import numpy as np
import torch

import repro.core as jcore
import repro_torch
from repro.graphs import get_dataset as jget
from repro.graphs.partition import prepare_partition as jprepare_partition
from repro.graphs.layout import LAYOUT_KINDS
from repro_torch.graphs import get_dataset as tget

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

MODES = ("hybrid", "topology", "data")
CELLS = [(layout, mode, fused) for layout in LAYOUT_KINDS for mode in MODES
         for fused in (False, True)]


def assert_same_coloring(name, layout, mode, fused, scale=0.02):
    jg = jget(name, scale=scale, layout=layout)
    tg = tget(name, scale=scale, layout=layout)
    want = jcore.color(jg, mode=mode, fused=fused, impl="jnp")
    got = repro_torch.color(tg, mode=mode, fused=fused, device="cpu")
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.colors.dtype == want.colors.dtype
    assert (got.n_colors, got.iterations, got.mode_trace, got.counts) == \
        (want.n_colors, want.iterations, want.mode_trace, want.counts)
    repro_torch.verify_coloring(tg, got.colors)


#: (algo, fused) of the distributed colorings: ipgc fused and two-phase,
#: spec-greedy, jpl
DIST_ALGOS = [("ipgc", True), ("ipgc", False), ("spec-greedy", None),
              ("jpl", None)]
_FIELDS = ("n_colors", "iterations", "mode_trace", "counts")


def _fields(r):
    return tuple(getattr(r, f) for f in _FIELDS)


@functools.lru_cache(maxsize=None)
def _reference_host(name, n_shards, algo, fused, scale):
    """``repro``'s host engine on ``repro``'s partitioned graph, colors in
    the original labeling (cached: one reference run serves every exchange
    knob)."""
    jg = jget(name, scale=scale, layout="ell-tail")
    jg2, relabel = jprepare_partition(jg, n_shards)
    want = jcore.color(jg2, algo=algo, outline=False,
                       fused=True if fused is None else fused)
    return want, want.colors[relabel[:jg.n_nodes]]


def assert_same_dist_coloring(name, n_shards, algo, fused, scale=0.01,
                              exchange="dense"):
    """``color_distributed(devices=["cpu"] * S, exchange=...)`` equals
    ``repro.core.color(g2, fused=..., outline=False)`` on ``repro``'s
    partitioned graph (colors mapped back, ``tests/test_distributed.py``'s
    contract); at S = 1 also ``repro.core.color_distributed`` itself, with
    its exchange trace and bytes."""
    tg = tget(name, scale=scale, layout="ell-tail")
    got = repro_torch.color_distributed(tg, devices=["cpu"] * n_shards,
                                        algo=algo, fused=fused,
                                        exchange=exchange)
    want, want_colors = _reference_host(name, n_shards, algo, fused, scale)
    np.testing.assert_array_equal(got.colors, want_colors)
    assert got.colors.dtype == want.colors.dtype
    assert _fields(got) == _fields(want)
    assert len(got.exchange_trace) == len(got.exchange_bytes) == \
        got.iterations
    assert set(got.exchange_trace) <= (
        {"d"} if exchange == "dense" else {"b", "d", "m"})
    repro_torch.verify_coloring(tg, got.colors)
    if n_shards == 1:
        jg = jget(name, scale=scale, layout="ell-tail")
        ref = jcore.color_distributed(jg, n_shards=1, algo=algo, fused=fused,
                                      exchange=exchange)
        np.testing.assert_array_equal(got.colors, ref.colors)
        assert _fields(got) == _fields(ref)
        assert (got.exchange_trace, got.exchange_bytes,
                got.host_dispatches) == \
            (ref.exchange_trace, ref.exchange_bytes, ref.host_dispatches)
