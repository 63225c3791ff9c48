"""Whole distributed colorings of the port on the CPU against ``repro``
(``_torch_parity.assert_same_dist_coloring``): ipgc fused and two-phase,
spec-greedy and jpl, S in {1, 2, 4, 8}, on europe and kron (hubs) at
scale 0.01. Exact, field for field."""
import pytest
from _torch_parity import DIST_ALGOS, assert_same_dist_coloring


@pytest.mark.parametrize("algo,fused", DIST_ALGOS)
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["europe_osm_s", "kron_g500-logn21_s"])
def test_dist_coloring_matches_reference(name, n_shards, algo, fused):
    assert_same_dist_coloring(name, n_shards, algo, fused)
