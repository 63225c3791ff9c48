"""The port's host-loop Pipe against ``repro.core.color``: every layout kind
x mode x step family on a power-law graph with hubs and on a road graph;
the device rule; what the port refuses, as the reference does; and the
host helpers the engine shares with the reference."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from _torch_parity import CELLS, assert_same_coloring
from repro.algos.base import _compact_palette as j_compact_palette
from repro.core.engine import adaptive_window as j_adaptive_window
from repro.core.policy import make_policy as j_make_policy
from repro.core.verify import coloring_stats as j_coloring_stats
from repro.graphs import get_dataset as jget
from repro_torch.algos.base import _compact_palette
from repro_torch.core import ipgc
from repro_torch.core.engine import adaptive_window
from repro_torch.core.policy import AutoTuned, make_policy
from repro_torch.core.verify import (InvalidColoringError, coloring_stats,
                                     verify_coloring)
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.graphs import get_dataset

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)


@pytest.mark.parametrize("layout,mode,fused", CELLS)
@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "europe_osm_s"])
def test_coloring_matches_reference(name, layout, mode, fused):
    assert_same_coloring(name, layout, mode, fused)


@pytest.mark.parametrize("fused", [False, True])
def test_forced_hub_and_options_match_reference(fused):
    """Forced hub side-channel on a hub-free layout, a fixed window, an id
    priority, another H and bucket ratio."""
    kw = dict(mode="hybrid", h=0.3, window=64, bucket_ratio=4,
              priority="id", fused=fused)
    jg = jget("europe_osm_s", scale=0.02, layout="pure-ell")
    tg = get_dataset("europe_osm_s", scale=0.02, layout="pure-ell")
    with jcore.ipgc.forced_hub(True):
        want = jcore.color(jg, impl="jnp", **kw)
    with ipgc.forced_hub(True):
        got = repro_torch.color(tg, device="cpu", **kw)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert (got.iterations, got.mode_trace, got.counts) == \
        (want.iterations, want.mode_trace, want.counts)


def test_default_device_without_cuda_raises(monkeypatch):
    """No silent CPU run: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = get_dataset("europe_osm_s", scale=0.01, layout="pure-ell")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.color(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.prepare(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.color(g, device="cuda")
    assert repro_torch.color(g, device="cpu").iterations > 0


@pytest.mark.parametrize("kw,what", [
    # the packed boundary exchange, once unported, now runs; what the
    # distributed Pipe still refuses is what the reference refuses too, a
    # csr-segment graph (the case keeps its test id)
    pytest.param(dict(mode="dist-hybrid", exchange="boundary"),
                 "distributed", id="kw1-distributed"),
])
def test_unported_regimes_raise(kw, what):
    g = get_dataset("europe_osm_s", scale=0.01, layout="pure-ell")
    r = repro_torch.color(g, device="cpu", **kw)
    dense = repro_torch.color(g, device="cpu", mode=kw["mode"])
    np.testing.assert_array_equal(r.colors, dense.colors)
    assert (r.iterations, r.mode_trace) == (dense.iterations,
                                            dense.mode_trace)
    with pytest.raises(NotImplementedError, match=what):
        repro_torch.color(g, device="cpu", layout="csr-segment", **kw)
    s = Session("cpu")
    (batched,) = s.run_batch(ExecutionSpec(), [g])
    solo = s.run(ExecutionSpec(), g)
    np.testing.assert_array_equal(batched.colors, solo.colors)
    assert (batched.n_colors, batched.iterations, batched.mode_trace) == \
        (solo.n_colors, solo.iterations, solo.mode_trace)


def test_session_caches_prepared_graphs():
    g = get_dataset("europe_osm_s", scale=0.01, layout="pure-ell")
    s = Session("cpu")
    a = s.run(ExecutionSpec(fused=True), g)
    b = s.run(ExecutionSpec(fused=True), g)
    assert (s.stats.misses, s.stats.hits) == (1, 1)
    np.testing.assert_array_equal(a.colors, b.colors)
    # an IPGCGraph prepared by the caller runs as is (explicit window)
    ig = repro_torch.prepare(g, device="cpu")
    c = s.run(ExecutionSpec(fused=True, window=adaptive_window(g)), ig)
    np.testing.assert_array_equal(c.colors, a.colors)


def test_hybrid_auto_colors_validly():
    g = get_dataset("kron_g500-logn21_s", scale=0.02, layout="ell-tail")
    r = repro_torch.color(g, mode="hybrid-auto", device="cpu",
                          collect_tti=True)
    verify_coloring(g, r.colors)
    assert len(r.tti) == r.iterations == len(r.counts)
    assert isinstance(make_policy("hybrid-auto"), AutoTuned)


@pytest.mark.parametrize("mode", ["hybrid", "hybrid-auto", "topology",
                                  "dense", "data", "sparse", "plain"])
def test_policies_match_reference(mode):
    mine, theirs = make_policy(mode, 0.45), j_make_policy(mode, 0.45)
    for count in (0, 1, 449, 450, 451, 1000):
        assert mine(count, 1000) == theirs(count, 1000)
    with pytest.raises(ValueError):
        make_policy("nope")


@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "europe_osm_s",
                                  "Audikw_1_s"])
def test_host_helpers_match_reference(name):
    jg = jget(name, scale=0.02, layout="ell-tail")
    tg = get_dataset(name, scale=0.02, layout="ell-tail")
    assert adaptive_window(tg) == j_adaptive_window(jg)
    rng = np.random.default_rng(1)
    for colors in (rng.integers(-1, 6, size=tg.n_nodes).astype(np.int32),
                   repro_torch.color(tg, device="cpu").colors):
        assert coloring_stats(tg, colors) == j_coloring_stats(jg, colors)
    gapped = rng.choice([-1, 2, 5, 9], size=50).astype(np.int32)
    got, k = _compact_palette(gapped)
    want, kj = j_compact_palette(gapped)
    np.testing.assert_array_equal(got, want)
    assert k == kj


def test_verify_coloring_raises_on_bad_colorings():
    g = get_dataset("europe_osm_s", scale=0.01, layout="pure-ell")
    colors = repro_torch.color(g, device="cpu").colors.copy()
    assert verify_coloring(g, colors)["conflicts"] == 0
    a = int(g.arrays.col_idx[0])          # a neighbour of node 0
    bad = colors.copy()
    bad[0] = bad[a]
    with pytest.raises(InvalidColoringError, match="conflicting"):
        verify_coloring(g, bad)
    bad = colors.copy()
    bad[3] = -1
    with pytest.raises(InvalidColoringError, match="uncolored"):
        verify_coloring(g, bad)
    assert verify_coloring(g, bad, require_complete=False)["uncolored"] == 1
