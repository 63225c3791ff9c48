"""The step builders' GNN, DLRM and coloring cases at smoke size on the
CPU against the reference's same case functions
(``tests/_steps_run.py``): the four GNNs full-graph, on a molecule batch
and sampled (the blocks drawn inside the step from the host key),
GraphSAGE's owner variant, DLRM's training step, serving and retrieval,
and ``ipgc_case``'s dense step at two ELL widths, exactly.
"""
import pytest
import torch

from _case_check import CASES, case_id
from _steps_ref import reference_steps
from _steps_run import check_pair

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

OTHER = [c for c in CASES if c[1] not in ("train", "prefill", "decode")]


@pytest.fixture
def jsteps(monkeypatch):
    yield from reference_steps(monkeypatch)


@pytest.mark.parametrize("spec", OTHER, ids=[case_id(c) for c in OTHER])
def test_case_matches_reference(jsteps, spec):
    check_pair(jsteps, spec)


def test_eqv2_masked_self_loop_into_an_unreached_node_stays_finite():
    """A self loop (masked out: no frame) into a node no valid edge
    reaches: the layer's gradients stay finite under a huge upstream
    gradient, as on the card, where EquiformerV2's 12-layer molecule step
    carried the 1e-9 floor's 1e9 back to that edge as inf * 0 = nan."""
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import equiformer_v2 as eqv2

    cfg = get_arch("equiformer-v2").make_smoke()
    params, _ = eqv2.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    n = 4
    x = torch.randn(n, cfg.s_dim, cfg.channels, requires_grad=True)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([0, 2, 1], dtype=torch.int32)   # node 0: a self loop
    unit = torch.nn.functional.normalize(torch.randn(3, 3), dim=-1)
    unit[0] = 0.0
    rbf = torch.rand(3, cfg.n_rbf)
    ok = torch.tensor([False, True, True])
    out = eqv2._layer(x, params, 0, [(src, dst, unit, rbf, ok)], cfg)
    grads = torch.autograd.grad((out * 1e32).sum(),
                                [x] + list(params.values()),
                                allow_unused=True, materialize_grads=True)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
