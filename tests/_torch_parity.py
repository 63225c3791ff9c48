"""Shared check of the port's engine against ``repro``'s: the same
registry graph through ``repro.core.color(impl="jnp")`` and
``repro_torch.color(device="cpu")`` gives the same ``ColoringResult``."""
import numpy as np
import torch

import repro.core as jcore
import repro_torch
from repro.graphs import get_dataset as jget
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
