"""Engine parity on the other half of the registry graphs: every layout
kind x modes hybrid/topology/data x fused False/True (see _torch_parity)."""
import pytest

from _torch_parity import CELLS, assert_same_coloring


@pytest.mark.parametrize("layout,mode,fused", CELLS)
@pytest.mark.parametrize("name", ["indochina-2004_s", "hollywood-2009_s",
                                  "rgg_n_2_24_s0_s", "soc-LiveJournal1_s"])
def test_coloring_matches_reference(name, layout, mode, fused):
    assert_same_coloring(name, layout, mode, fused)
