"""Kernel-launch accounting of the port (``core.policy.measure_launches``)
against ``repro``'s (``tests/test_launches.py``): on the same graph and
state, every step family's launches per iteration equal the reference's —
one launch per fused iteration, three passes per two-phase one, a forced
hub path still one — and the scoped counter groups restore the caller's
counts. The reference traces its step abstractly; the port runs it once on
clones of the state."""
import numpy as np
import pytest
import torch

from repro.algos import get_algorithm as jget_algorithm
from repro.core import ipgc as jipgc
from repro.core.policy import measure_launches as jmeasure
from repro.graphs import get_dataset as jget
from repro_torch.algos import get_algorithm
from repro_torch.core import ipgc
from repro_torch.core.policy import measure_launches
from repro_torch.core.worklist import full_worklist
from repro_torch.graphs import get_dataset as tget
from repro_torch.kernels._build import KERNEL_LAUNCHES

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

ONE_FUSED = {"fused": 1, "mex": 0, "conflict": 0, "compact": 0}
TWO_PHASE = {"fused": 0, "mex": 1, "conflict": 1, "compact": 1}
LAYOUTS = ["pure-ell", "ell-tail", "csr-segment", "hub-split"]
#: (algo, fused) of every host step family
FAMILIES = [("ipgc", True), ("ipgc", False), ("spec-greedy", None),
            ("jpl", None)]
_GRAPHS: dict = {}


def _graphs(kind):
    """``repro``'s and the port's prepared graph of one layout kind (a
    hub-heavy graph, so ell-tail and hub-split carry hubs)."""
    if kind not in _GRAPHS:
        name = "europe_osm_s" if kind == "pure-ell" else "hollywood-2009_s"
        jig = jipgc.prepare(jget(name, scale=0.02, layout=kind))
        tig = ipgc.prepare(tget(name, scale=0.02, layout=kind),
                           device="cpu")
        _GRAPHS[kind] = (jig, tig)
    return _GRAPHS[kind]


def _tstate(tig):
    n = tig.n_nodes
    return (ipgc.init_colors(n, tig.device),
            torch.zeros(n, dtype=torch.int32), full_worklist(n, tig.device))


def _pair(kind, algo, fused, mode, force_hub=None):
    """(reference, port) launches of one step."""
    jig, tig = _graphs(kind)
    idx = 0 if mode == "dense" else 1
    jalg, talg = jget_algorithm(algo), get_algorithm(algo)
    jfused = jalg.resolve_fused(fused, default=False)
    tfused = talg.resolve_fused(fused, default=False)
    jstep = jalg.step_impls(jfused)[idx]
    tstep = talg.step_fns(tfused)[idx]
    want = jmeasure(jstep, jig, *jalg.init_state(jig), window=32,
                    impl="jnp", force_hub=force_hub)
    got = measure_launches(tstep, tig, *talg.init_state(tig), window=32,
                           force_hub=force_hub)
    return want, got


@pytest.mark.parametrize("kind", LAYOUTS)
def test_fused_steps_are_one_launch(kind):
    for mode in ("dense", "sparse"):
        want, got = _pair(kind, "ipgc", True, mode)
        assert got == want == ONE_FUSED, (kind, mode, got)


@pytest.mark.parametrize("kind", LAYOUTS)
def test_two_phase_steps_are_three_launches(kind):
    for mode in ("dense", "sparse"):
        want, got = _pair(kind, "ipgc", False, mode)
        assert got == want == TWO_PHASE, (kind, mode, got)


@pytest.mark.parametrize("algo,fused", FAMILIES)
@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_every_family_matches_reference(algo, fused, mode):
    want, got = _pair("ell-tail", algo, fused, mode)
    assert got == want, (algo, fused, mode, got, want)


def test_forced_hub_path_stays_one_launch():
    """The hub side-channel folds into the same fused launch — forcing it
    on, also on a graph without hubs, must not add a pass."""
    for kind in ("ell-tail", "pure-ell"):
        want, got = _pair(kind, "ipgc", True, "dense", force_hub=True)
        assert got == want == ONE_FUSED, (kind, got)


def test_reset_launch_counts():
    with ipgc.LAUNCH_COUNTS.scope():
        ipgc.LAUNCH_COUNTS["fused"] += 7
        ipgc.LAUNCH_COUNTS.reset()
        assert all(v == 0 for v in ipgc.LAUNCH_COUNTS.as_dict().values())


def test_launch_scope_restores_outer_counts():
    """A measurement inside ``scope()`` starts from zero and does not leak
    into the surrounding accounting."""
    _, tig = _graphs("pure-ell")
    colors, base, wl = _tstate(tig)
    with ipgc.LAUNCH_COUNTS.scope():
        ipgc.LAUNCH_COUNTS["mex"] += 5          # outer accounting...
        with ipgc.LAUNCH_COUNTS.scope() as lc:  # ...invisible inside
            assert lc["mex"] == 0
            ipgc.fused_dense_step(tig, colors, base, wl, window=32)
            assert lc.as_dict() == ONE_FUSED
        assert ipgc.LAUNCH_COUNTS["mex"] == 5
        assert ipgc.LAUNCH_COUNTS["fused"] == 0


def test_measure_launches_preserves_surrounding_counts_and_state():
    """``measure_launches`` leaves the caller's counters (the passes and
    the CUDA launches) and the state it was given exactly as they were."""
    _, tig = _graphs("pure-ell")
    colors, base, wl = _tstate(tig)
    before = (colors.clone(), base.clone(), wl.mask.clone(),
              wl.items.clone(), int(wl.count))
    with ipgc.LAUNCH_COUNTS.scope(), KERNEL_LAUNCHES.scope():
        ipgc.LAUNCH_COUNTS["compact"] += 3
        KERNEL_LAUNCHES["compact"] += 2
        got = measure_launches(ipgc.dense_step, tig, colors, base, wl,
                               window=32, force_hub=None)
        assert got == TWO_PHASE
        assert ipgc.LAUNCH_COUNTS.as_dict() == {
            "mex": 0, "conflict": 0, "compact": 3, "fused": 0}
        assert KERNEL_LAUNCHES["compact"] == 2
    for a, b in zip(before[:4], (colors, base, wl.mask, wl.items)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(wl.count) == before[4]
