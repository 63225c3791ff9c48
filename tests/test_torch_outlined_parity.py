"""The port's outlined regime against ``repro.core.color_outlined_hybrid``:
the same registry graph through ``repro`` (``impl="jnp"``) and through
``repro_torch`` on the CPU gives the same ``ColoringResult`` in every
field but ``tti`` and ``total_seconds`` (``counts`` and
``host_dispatches`` per chunk), and under these fixed-threshold policies
the port's outlined result also equals its own host loop. Exact
equality: IPGC works only on integers."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro.graphs import get_dataset as jget
from repro_torch.graphs import get_dataset as tget

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

GRAPHS = ["europe_osm_s", "kron_g500-logn21_s", "hollywood-2009_s"]
MODES = ("hybrid", "topology", "data")
#: (algo, fused) of the colorings: ipgc two-phase and fused, jpl,
#: spec-greedy
ALGOS = [("ipgc", False), ("ipgc", True), ("jpl", None),
         ("spec-greedy", None)]
FIELDS = ("n_colors", "iterations", "mode_trace", "counts",
          "host_dispatches")


def _assert_matches(name, layout, algo, fused, mode):
    jg = jget(name, scale=0.02, layout=layout)
    tg = tget(name, scale=0.02, layout=layout)
    want = jcore.color_outlined_hybrid(jg, algo=algo, fused=fused,
                                       mode=mode, impl="jnp")
    got = repro_torch.color_outlined_hybrid(tg, algo=algo, fused=fused,
                                            mode=mode, device="cpu")
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.colors.dtype == want.colors.dtype
    assert [getattr(got, f) for f in FIELDS] == \
        [getattr(want, f) for f in FIELDS]
    host = repro_torch.color(tg, algo=algo, fused=fused, mode=mode,
                             outline=False, device="cpu")
    np.testing.assert_array_equal(got.colors, host.colors)
    assert (got.n_colors, got.iterations, got.mode_trace) == \
        (host.n_colors, host.iterations, host.mode_trace)
    repro_torch.verify_coloring(tg, got.colors)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("algo,fused", ALGOS)
@pytest.mark.parametrize("name", GRAPHS)
def test_outlined_matches_reference(name, algo, fused, mode):
    _assert_matches(name, "ell-tail", algo, fused, mode)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("layout", ["pure-ell", "hub-split", "csr-segment"])
def test_outlined_layouts_match_reference(layout, fused):
    _assert_matches("kron_g500-logn21_s", layout, "ipgc", fused, "hybrid")


@pytest.mark.parametrize("fused", [False, True])
def test_outlined_forced_hub_and_options_match_reference(fused):
    """Forced hub side-channel on a hub-free layout, a fixed window, an id
    priority, another H and bucket ratio, and a max_iter cut."""
    kw = dict(mode="hybrid", h=0.3, window=64, bucket_ratio=4,
              priority="id", fused=fused)
    jg = jget("europe_osm_s", scale=0.02, layout="pure-ell")
    tg = tget("europe_osm_s", scale=0.02, layout="pure-ell")
    for max_iter in (10_000, 2):
        with jcore.ipgc.forced_hub(True):
            want = jcore.color_outlined_hybrid(jg, impl="jnp",
                                               max_iter=max_iter, **kw)
        with repro_torch.core.ipgc.forced_hub(True):
            got = repro_torch.color_outlined_hybrid(
                tg, device="cpu", max_iter=max_iter, **kw)
        np.testing.assert_array_equal(got.colors, want.colors)
        assert [getattr(got, f) for f in FIELDS] == \
            [getattr(want, f) for f in FIELDS]
    assert got.iterations == 2


@pytest.mark.parametrize("name", GRAPHS)
def test_color_outlined_matches_reference(name):
    """The dense-only form: one chunk, mode trace ``"O"`` per iteration."""
    jg = jget(name, scale=0.02)
    tg = tget(name, scale=0.02)
    want = jcore.color_outlined(jg, impl="jnp")
    got = repro_torch.color_outlined(tg, device="cpu")
    np.testing.assert_array_equal(got.colors, want.colors)
    assert [getattr(got, f) for f in FIELDS] == \
        [getattr(want, f) for f in FIELDS]
    assert (got.host_dispatches, got.counts, got.tti) == (1, [], [])
    repro_torch.verify_coloring(tg, got.colors)
