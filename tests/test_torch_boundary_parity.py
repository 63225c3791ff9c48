"""Whole distributed colorings of the port with the boundary exchange
(``exchange="boundary"|"auto"``) on S = 2, 4 and 8 CPU shards against
``repro``'s host engine on ``repro``'s partitioned graph
(``_torch_parity.assert_same_dist_coloring``, which the dense exchange
meets too): ipgc fused and two-phase, spec-greedy and jpl, on europe and
kron (hubs) at scale 0.01. Exact, field for field."""
import pytest
from _torch_parity import DIST_ALGOS, assert_same_dist_coloring


@pytest.mark.parametrize("exchange", ["boundary", "auto"])
@pytest.mark.parametrize("algo,fused", DIST_ALGOS)
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("name", ["europe_osm_s", "kron_g500-logn21_s"])
def test_boundary_coloring_matches_reference(name, n_shards, algo, fused,
                                             exchange):
    assert_same_dist_coloring(name, n_shards, algo, fused,
                              exchange=exchange)
