"""The port's algorithm registry and the JPL and spec-greedy algorithms
against ``repro``'s: one JPL round of each phase from the same mid-run
state on every layout kind, with and without the forced hub
side-channel; the gather profile; and the per-algorithm contracts of
``tests/test_algos.py`` on the CPU. Exact: all state is int32/bool."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import jpl as jjpl
from repro.core import ipgc as jipgc
from repro.core import worklist as jwl
from repro.graphs import get_dataset as jget
from repro.graphs.layout import LAYOUT_KINDS
import repro_torch
from repro_torch.algos import algorithm_names, get_algorithm
from repro_torch.algos import jpl as tjpl
from repro_torch.core import ipgc as tipgc
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.graphs import get_dataset, ingest, layout

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

ALGOS = ["ipgc", "jpl", "spec-greedy"]


def _prepared(name, layout_kind):
    jig = jipgc.prepare(jget(name, scale=0.02, layout=layout_kind))
    arrays = {f.name: np.asarray(getattr(jig, f.name))
              for f in dataclasses.fields(jig)
              if getattr(jig, f.name) is not None
              and not isinstance(getattr(jig, f.name), (int, str))}
    tig = tipgc.from_numpy(arrays, layout_kind=jig.layout_kind, device="cpu")
    return jig, tig


def _mid_run_state(jig, sparse):
    """A JPL state two dense rounds into a run, resized to its capacity
    bucket when the next round is a sparse one (as the Pipe does)."""
    n = jig.n_nodes
    colors, rnd = jipgc.init_colors(n), jnp.zeros((), jnp.int32)
    wl = jwl.full_worklist(n)
    for _ in range(2):
        colors, rnd, wl = jjpl.jpl_dense_step(jig, colors, rnd, wl,
                                              impl="jnp")
    if sparse:
        caps = jwl.bucket_capacities(n, ratio=2)
        wl = jwl.resize_items(wl, jwl.pick_bucket(caps, int(wl.count)), n)
    return colors, rnd, wl


def _to_torch(colors, rnd, wl):
    c, _, w = tipgc.state_from_numpy(
        *(np.asarray(x) for x in (colors, colors, wl.mask, wl.items,
                                  wl.count)), "cpu")
    return c, torch.tensor(int(rnd), dtype=torch.int32), w


def test_registry_contents():
    names = algorithm_names()
    for name in ALGOS:
        assert name in names
        alg = get_algorithm(name)
        assert alg.name == name
        assert get_algorithm(alg) is alg          # instance passthrough
    assert not get_algorithm("jpl").uses_window
    assert get_algorithm("ipgc").uses_window
    assert get_algorithm("spec-greedy").uses_window
    with pytest.raises(ValueError, match="unknown algorithm"):
        get_algorithm("nope")


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("layout_kind", LAYOUT_KINDS)
@pytest.mark.parametrize("phase", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "europe_osm_s"])
def test_jpl_round_matches_reference(name, phase, layout_kind, force):
    jig, tig = _prepared(name, layout_kind)
    state = _mid_run_state(jig, phase == "sparse")
    jstep = {"dense": jjpl.jpl_dense_step,
             "sparse": jjpl.jpl_sparse_step}[phase]
    tstep = {"dense": tjpl.jpl_dense_step,
             "sparse": tjpl.jpl_sparse_step}[phase]
    want = jstep(jig, *state, impl="jnp", force_hub=force)
    with tipgc.GATHER_COUNTS.scope() as gc:
        got = tstep(tig, *_to_torch(*state), force_hub=force)
        gathers = gc["neighbor_colors"]
    # the reference's profile: a dense round gathers no colors, a sparse
    # round exactly once
    assert gathers == (0 if phase == "dense" else 1)
    assert got[1].dtype == torch.int32 and got[1].shape == ()
    for g, w, what in ((got[0], want[0], "colors"),
                       (got[1], want[1], "round"),
                       (got[2].mask, want[2].mask, "mask"),
                       (got[2].items, want[2].items, "items"),
                       (got[2].count, want[2].count, "count")):
        assert g.dtype == (torch.bool if what == "mask" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)


def test_jpl_gather_profile_from_the_start():
    """The reference's ``test_jpl_gather_profile``: from the initial state,
    a dense round makes 0 colors gathers and a sparse round 1."""
    g = get_dataset("europe_osm_s", scale=0.02, layout="ell-tail",
                    ell_cap=128)
    alg = get_algorithm("jpl")
    ig = alg.prepare(g, device="cpu")
    dense, sparse = alg.step_fns(False)
    for fn, want in ((dense, 0), (sparse, 1)):
        with tipgc.GATHER_COUNTS.scope() as gc:
            fn(ig, *alg.init_state(ig), window=32, force_hub=False)
            assert gc["neighbor_colors"] == want, fn.__name__


def test_jpl_round_leaves_its_inputs_alone():
    jig, tig = _prepared("kron_g500-logn21_s", "ell-tail")
    state = _to_torch(*_mid_run_state(jig, True))
    before = [t.clone() for t in (state[0], state[1], state[2].mask,
                                  state[2].items, state[2].count)]
    for step in (tjpl.jpl_dense_step, tjpl.jpl_sparse_step):
        step(tig, *state)
    after = (state[0], state[1], state[2].mask, state[2].items,
             state[2].count)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.fixture(scope="module")
def europe():
    return get_dataset("europe_osm_s", scale=0.02, layout="ell-tail",
                       ell_cap=128)


def test_jpl_colors_invariant_across_modes(europe):
    """JPL has no speculation: every active node is decided by the same
    priority draw each round, so the policy modes color identically."""
    runs = [repro_torch.color(europe, algo="jpl", mode=m, device="cpu")
            for m in ("hybrid", "topology", "data")]
    for r in runs[1:]:
        np.testing.assert_array_equal(runs[0].colors, r.colors)
        assert r.iterations == runs[0].iterations
    assert set(runs[1].mode_trace) == {"D"}
    assert set(runs[2].mode_trace) == {"S"}


@pytest.mark.parametrize("algo", ["jpl", "spec-greedy"])
def test_palette_is_compact(algo):
    g = get_dataset("kron_g500-logn21_s", scale=0.02, layout="ell-tail",
                    ell_cap=128)
    r = repro_torch.color(g, algo=algo, device="cpu")
    used = np.unique(r.colors[r.colors >= 0])
    np.testing.assert_array_equal(used, np.arange(len(used)))
    assert r.n_colors == len(used)
    repro_torch.verify_coloring(g, r.colors)
    get_algorithm(algo).check_invariants(r, g)


def _small_graph(src, dst, n, name):
    return layout.run_pipeline(ingest.from_arrays(np.array(src),
                                                  np.array(dst), n,
                                                  name=name),
                               layout="ell-tail", ell_cap=128)


@pytest.mark.parametrize("algo", ["jpl", "spec-greedy"])
def test_edge_cases(algo):
    one = _small_graph([0], [0], 1, "one")
    r = repro_torch.color(one, algo=algo, device="cpu")
    assert r.n_colors == 1
    tri = _small_graph([0, 1, 2], [1, 2, 0], 3, "tri")
    r = repro_torch.color(tri, algo=algo, device="cpu")
    repro_torch.verify_coloring(tri, r.colors)
    assert r.n_colors == 3                      # triangle floor holds


def test_jpl_forced_hub_side_channel(europe):
    """Hub tail priorities reach the extrema fold: forcing the hub
    side-channel on a hubless mesh changes nothing."""
    with tipgc.forced_hub(True):
        forced = repro_torch.color(europe, algo="jpl", device="cpu")
    plain = repro_torch.color(europe, algo="jpl", device="cpu")
    np.testing.assert_array_equal(forced.colors, plain.colors)
    assert forced.iterations == plain.iterations


def test_spec_greedy_pins_fused_family(europe):
    """spec-greedy is deferred detect-and-repair: the caller's ``fused``
    request cannot bring back a same-iteration resolve phase."""
    r_def = repro_torch.color(europe, algo="spec-greedy", device="cpu")
    with tipgc.LAUNCH_COUNTS.scope() as lc:
        r_f0 = repro_torch.color(europe, algo="spec-greedy", fused=False,
                                 device="cpu")
        passes = lc.as_dict()
    assert passes["fused"] == r_f0.iterations
    assert passes["mex"] == passes["conflict"] == 0
    np.testing.assert_array_equal(r_def.colors, r_f0.colors)
    assert r_def.iterations == r_f0.iterations
    # the same trajectory as the fused IPGC steps it reuses (palette aside)
    r_ipgc = repro_torch.color(europe, algo="ipgc", fused=True, device="cpu")
    assert (r_def.iterations, r_def.mode_trace) == \
        (r_ipgc.iterations, r_ipgc.mode_trace)


@pytest.mark.parametrize("algo", ALGOS)
def test_check_invariants_flags_growth(algo):
    class FakeResult:
        counts = [5, 9]
        iterations = 2
        n_colors = 3

    with pytest.raises(AssertionError, match="grew"):
        get_algorithm(algo).check_invariants(FakeResult())


def test_jpl_check_invariants_flags_too_many_colors():
    class FakeResult:
        counts = [5, 2]
        iterations = 2
        n_colors = 5

    get_algorithm("ipgc").check_invariants(FakeResult())
    with pytest.raises(AssertionError, match="5 colors from 2 rounds"):
        get_algorithm("jpl").check_invariants(FakeResult())


def test_session_window_rule_for_prepared_graphs(europe):
    """``window="auto"`` on a prepared graph: an algorithm with a mex
    window needs the host graph's degrees and raises; JPL resolves it to
    128, as the reference's session does."""
    s = Session("cpu")
    ig = get_algorithm("jpl").prepare(europe, device="cpu")
    got = s.run(ExecutionSpec(algo="jpl"), ig)
    want = s.run(ExecutionSpec(algo="jpl"), europe)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert s._prepare(ExecutionSpec(algo="jpl"), ig,
                      get_algorithm("jpl"))[1] == 128
    assert s._prepare(ExecutionSpec(algo="jpl"), europe,
                      get_algorithm("jpl"))[1] == 128
    for algo in ("ipgc", "spec-greedy"):
        with pytest.raises(ValueError, match="needs a host Graph"):
            s.run(ExecutionSpec(algo=algo), ig)
        r = s.run(ExecutionSpec(algo=algo, window=64), ig)
        repro_torch.verify_coloring(europe, r.colors)


def test_jpl_state_lives_on_the_graph_device(europe):
    ig = get_algorithm("jpl").prepare(europe, device="cpu")
    colors, rnd, wl = get_algorithm("jpl").init_state(ig)
    assert rnd.shape == () and rnd.dtype == torch.int32
    assert colors.device == rnd.device == wl.mask.device == ig.device
    assert int(rnd) == 0
