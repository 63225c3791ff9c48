"""The Graph500 Kronecker generator, in PyTorch on the device.

It follows the Octave reference generator of the Graph500 specification
(``kronecker_generator.m``): ``edgefactor * 2**scale`` edges, each placed
bit by bit with the initiator probabilities A, B, C (D = 1 - A - B - C),
then the vertex labels permuted at random. The specification's last step,
a random permutation of the edge order, is left out: the port's
``build_graph`` sorts the edges before anything reads their order.

Every draw comes from one ``torch.Generator`` seeded with ``seed`` on
``device``, in a few large calls, so the same seed on the same kind of
device gives the same edge list.
"""
from __future__ import annotations

import torch


def generate(params: dict, seed: int, device
             ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(src, dst, n_nodes)``: int64 edge endpoints on ``device``."""
    scale, edgefactor = int(params["scale"]), int(params["edgefactor"])
    a, b, c = float(params["A"]), float(params["B"]), float(params["C"])
    n = 1 << scale
    m = edgefactor * n
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        cut = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > cut
        src += ii.to(torch.int64) << level
        dst += jj.to(torch.int64) << level
        del ii, jj, cut
    perm = torch.randperm(n, generator=gen, device=device)
    return perm[src], perm[dst], n
