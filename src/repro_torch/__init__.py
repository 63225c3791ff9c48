"""PyTorch and CUDA port of the hybrid IPGC graph-coloring engine.

A second package beside the JAX reference ``repro``, with the same module
names. It imports ``torch`` and ``numpy`` only. The entry points
(``color``, ``Session``, ``prepare``) run on the CUDA device unless the
caller passes ``device="cpu"``; on a CUDA device the row work runs in the
hand-written kernels of ``repro_torch.kernels``, on the CPU in their plain
PyTorch versions.
"""
from repro_torch.core import (ColoringResult, color, coloring_stats,  # noqa: F401
                              color_distributed, color_outlined,
                              color_outlined_hybrid, outlined, prepare,
                              set_outline_default, verify_coloring)
from repro_torch.exec import ExecutionSpec, Session  # noqa: F401
from repro_torch.graphs import get_dataset  # noqa: F401
