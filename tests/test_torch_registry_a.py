"""Engine parity on half of the registry graphs: every layout kind x
modes hybrid/topology/data x fused False/True (see _torch_parity)."""
import pytest

from _torch_parity import CELLS, assert_same_coloring


@pytest.mark.parametrize("layout,mode,fused", CELLS)
@pytest.mark.parametrize("name", ["circuit5M_s", "Audikw_1_s", "Bump_2911_s",
                                  "Queen_4147_s"])
def test_coloring_matches_reference(name, layout, mode, fused):
    assert_same_coloring(name, layout, mode, fused)
