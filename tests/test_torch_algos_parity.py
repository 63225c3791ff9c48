"""Engine parity of the JPL and spec-greedy algorithms and of the paper's
baselines: the same registry graph through ``repro`` and through
``repro_torch`` on the CPU gives the same ``ColoringResult``, field for
field (every layout kind x modes hybrid/topology/data)."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro.graphs import get_dataset as jget
from repro.graphs.layout import LAYOUT_KINDS
from repro_torch.algos import get_algorithm
from repro_torch.core import jpl_color, vb_color
from repro_torch.graphs import get_dataset as tget

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

GRAPHS = ["europe_osm_s", "kron_g500-logn21_s", "hollywood-2009_s"]
MODES = ("hybrid", "topology", "data")


def _assert_same(got, want):
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.colors.dtype == want.colors.dtype
    assert (got.n_colors, got.iterations, got.mode_trace, got.counts) == \
        (want.n_colors, want.iterations, want.mode_trace, want.counts)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUT_KINDS)
@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("algo", ["jpl", "spec-greedy"])
def test_algorithm_matches_reference(algo, name, layout, mode):
    jg = jget(name, scale=0.02, layout=layout)
    tg = tget(name, scale=0.02, layout=layout)
    want = jcore.color(jg, algo=algo, mode=mode, impl="jnp")
    got = repro_torch.color(tg, algo=algo, mode=mode, device="cpu")
    _assert_same(got, want)
    repro_torch.verify_coloring(tg, got.colors)
    get_algorithm(algo).check_invariants(got, tg)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("baseline", ["jpl_color", "vb_color"])
def test_baseline_matches_reference(baseline, name):
    jg = jget(name, scale=0.02, layout="ell-tail", ell_cap=128)
    tg = tget(name, scale=0.02, layout="ell-tail", ell_cap=128)
    want = getattr(jcore, baseline)(jg)
    got = {"jpl_color": jpl_color, "vb_color": vb_color}[baseline](
        tg, device="cpu")
    _assert_same(got, want)
    repro_torch.verify_coloring(tg, got.colors)
