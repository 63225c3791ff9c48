"""Lane batching of the port (``repro_torch/exec/batch.py``) against
``repro``'s (``tests/test_exec.py``'s batch contracts): ``run_batch``
equal to ``repro``'s field for field and to the port's solo runs, the
flattened lane group's trip equal to each lane's own dense step (JPL
lanes at different rounds in slots >= 1 included), ``pad_prepared`` and
``stacked_worklist`` arrays equal to the reference's, the request
catalogs, and the spec checks. The tolerance is exact throughout."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.ipgc as jipgc
from repro.core.worklist import stacked_worklist as j_stacked_worklist
from repro.exec import ExecutionSpec as JSpec
from repro.exec import Session as JSession
from repro.graphs import get_dataset as jget
from repro.graphs.registry import get_dataset_batch as j_get_dataset_batch
from repro.graphs.registry import heavy_tail_requests as j_heavy_tail
from repro_torch.algos import get_algorithm
from repro_torch.core import ipgc
from repro_torch.core.worklist import Worklist, stacked_worklist
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.exec import batch
from repro_torch.graphs import get_dataset, get_dataset_batch
from repro_torch.graphs import heavy_tail_requests

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

GRAPHS = ["europe_osm_s", "kron_g500-logn21_s", "hollywood-2009_s"]
#: (name, scale) of the batch the algorithm cases run: three families at
#: 0.02 and a smaller europe on a lower rung
BATCH = [(n, 0.02) for n in GRAPHS] + [("europe_osm_s", 0.005)]
ALGOS = [("ipgc", False), ("ipgc", True), ("jpl", None),
         ("spec-greedy", None)]


def _pair(name, scale, **kw):
    kw = {"layout": "ell-tail", "ell_cap": 128, **kw}
    return (jget(name, scale=scale, **kw), get_dataset(name, scale=scale,
                                                       **kw))


def _assert_same(got, want, *, solo=False):
    """Field for field; against a solo run (``solo``) only colors, colors
    used, iterations and mode trace, since a lane's ``counts`` and host
    dispatches are per batch, not per iteration."""
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.colors.dtype == want.colors.dtype
    assert (got.n_colors, got.iterations, got.mode_trace) == \
        (want.n_colors, want.iterations, want.mode_trace)
    if not solo:
        assert (got.counts, got.host_dispatches) == \
            (want.counts, want.host_dispatches)


# ---------------------------------------------------------------------------
# Session.run_batch against repro's, lane by lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,fused", ALGOS)
def test_run_batch_matches_reference(algo, fused):
    pairs = [_pair(n, s) for n, s in BATCH]
    want = JSession().run_batch(JSpec(regime="host", algo=algo, fused=fused),
                                [j for j, _ in pairs])
    s = Session("cpu")
    spec = ExecutionSpec(regime="host", algo=algo, fused=fused)
    got = s.run_batch(spec, [t for _, t in pairs])
    assert len(got) == len(pairs)
    for (_, tg), g, w in zip(pairs, got, want):
        _assert_same(g, w)
        assert g.host_dispatches == 1
        solo = s.run(spec, tg)
        _assert_same(g, solo, solo=True)


@pytest.mark.parametrize("mode", ["topology", "data"])
def test_run_batch_degenerate_policies(mode):
    pairs = [_pair(n, 0.02) for n in GRAPHS[:2]]
    want = JSession().run_batch(JSpec(regime="host", mode=mode),
                                [j for j, _ in pairs])
    got = Session("cpu").run_batch(ExecutionSpec(regime="host", mode=mode),
                                   [t for _, t in pairs])
    for g, w in zip(got, want):
        _assert_same(g, w)
        assert set(g.mode_trace) == {"D" if mode == "topology" else "S"}


def test_run_batch_duplicate_and_single_lanes():
    jg, tg = _pair("kron_g500-logn21_s", 0.02)
    s = Session("cpu")
    spec = ExecutionSpec(regime="host")
    one = s.run_batch(spec, [tg])
    dup = s.run_batch(spec, [tg, tg, tg])
    want = JSession().run_batch(JSpec(regime="host"), [jg])[0]
    for r in (*one, *dup):
        _assert_same(r, want)
    assert s.run_batch(spec, []) == []


def test_run_batch_warm_reuses_the_lane_group():
    graphs = [_pair(n, 0.02)[1] for n in GRAPHS]
    s = Session("cpu")
    spec = ExecutionSpec(regime="host")
    first = s.run_batch(spec, graphs)
    misses = s.stats.misses
    again = s.run_batch(spec, graphs)        # identical batch: all hits
    assert s.stats.misses == misses
    for a, b in zip(first, again):
        _assert_same(a, b, solo=True)


def test_run_batch_maps_back_through_permutations():
    base = _pair("kron_g500-logn21_s", 0.02)
    shuffled = _pair("kron_g500-logn21_s", 0.02, reorder="shuffle")
    assert shuffled[1].perm is not None
    want = JSession().run_batch(JSpec(regime="host"),
                                [base[0], shuffled[0]], map_to_original=True)
    got = Session("cpu").run_batch(ExecutionSpec(regime="host"),
                                   [base[1], shuffled[1]],
                                   map_to_original=True)
    import repro_torch
    for g, w in zip(got, want):
        _assert_same(g, w)
        # both lanes report colors in original ids: valid on the base graph
        repro_torch.verify_coloring(base[1], g.colors)


def test_run_batch_validation_failures():
    g = _pair("europe_osm_s", 0.02)[1]
    s = Session("cpu")
    with pytest.raises(ValueError, match="regime"):
        s.run_batch(ExecutionSpec(regime="dist", n_shards=2), [g])
    with pytest.raises(ValueError, match="regime"):
        s.run_batch(ExecutionSpec(regime="outlined"), [g])
    with pytest.raises(ValueError, match="monotone"):
        s.run_batch(ExecutionSpec(regime="host", mode="hybrid-auto"), [g])
    with pytest.raises(ValueError, match="monotone"):
        s.run_batch(ExecutionSpec(regime="host", mode="dist-hybrid"), [g])
    with pytest.raises(TypeError, match="host Graph"):
        s.run_batch(ExecutionSpec(regime="host"),
                    [ipgc.prepare(g, device="cpu")])
    from repro_torch.algos.base import Algorithm
    shy = dataclasses.replace(Algorithm(name="shy"),
                              batch_unsafe_reason="not audited")
    with pytest.raises(ValueError, match="not audited"):
        s.run_batch(ExecutionSpec(regime="host", algo=shy), [g])
    with pytest.raises(NotImplementedError, match="csr-segment"):
        s.run_batch(ExecutionSpec(regime="host", layout="csr-segment"), [g])


def test_run_batch_mixed_hub_and_hubless_lanes():
    """A bucket mixing hub-bearing and hubless graphs pads the hubless
    lane's hub side-channel, which must stay inert."""
    hubby = _pair("hollywood-2009_s", 0.01)
    mesh = _pair("europe_osm_s", 0.005)
    assert ipgc.prepare(hubby[1], device="cpu").n_hub > 0
    assert ipgc.prepare(mesh[1], device="cpu").n_hub == 0
    want = JSession().run_batch(JSpec(regime="host", window=64),
                                [hubby[0], mesh[0]])
    s = Session("cpu")
    spec = ExecutionSpec(regime="host", window=64)   # one shape rung
    got = s.run_batch(spec, [hubby[1], mesh[1]])
    for (_, tg), g, w in zip((hubby, mesh), got, want):
        _assert_same(g, w)
        _assert_same(g, s.run(spec, tg), solo=True)


def test_run_batch_report_lanes_match_reference():
    pairs = [_pair("kron_g500-logn21_s", 0.01),
             _pair("rgg_n_2_24_s0_s", 0.01)]
    want = JSession().run_batch(JSpec(regime="host", window=64),
                                [j for j, _ in pairs], trace=True)
    got = Session("cpu").run_batch(ExecutionSpec(regime="host", window=64),
                                   [t for _, t in pairs], trace=True)
    assert got.regime == want.regime == "batch"
    assert got.extra["lanes"] == want.extra["lanes"]
    assert (got.graph, got.n_nodes, got.n_colors, got.iterations,
            got.host_dispatches) == (want.graph, want.n_nodes,
                                     want.n_colors, want.iterations,
                                     want.host_dispatches)
    assert got.host_dispatches == len(got.trace.find("batch.dispatch"))
    for g, w in zip(got.result, want.result):
        _assert_same(g, w)
    assert set(got.to_json()) == set(want.to_json())


# ---------------------------------------------------------------------------
# the flattened trip equals each lane's own dense step
# ---------------------------------------------------------------------------

def _solo_state(alg, fused, ig, rounds):
    """``alg``'s state on ``ig`` after ``rounds`` host-loop dense steps."""
    dense = alg.step_fns(fused)[0]
    colors, aux, wl = alg.init_state(ig)
    for _ in range(rounds):
        colors, aux, wl = dense(ig, colors, aux, wl, window=64)
    return colors, aux, wl


@pytest.mark.parametrize("algo", ["ipgc", "ipgc-fused", "jpl",
                                  "spec-greedy"])
def test_flattened_trip_equals_each_lanes_dense_step(algo):
    """A 4-lane group (slot 2 inert) whose lanes stand at different
    rounds: one trip equals the dense step of each lane's graph alone,
    row for row, aux and counters included. JPL lanes in slots 1 and 3,
    at rounds 2 and 0 beside slot 0's round 1, hash lane-local ids with
    their own round."""
    fused = algo == "ipgc-fused"
    alg = get_algorithm("ipgc" if fused else algo)
    fused = alg.resolve_fused(fused, default=False)
    step = alg.lane_step(fused)
    graphs = [_pair(n, s)[1] for n, s in (("hollywood-2009_s", 0.01),
                                          ("kron_g500-logn21_s", 0.01),
                                          ("europe_osm_s", 0.005))]
    igs = [ipgc.prepare(g, device="cpu") for g in graphs]
    sc = batch.shape_class_for(igs, 1 << 12, 64, "ell-tail")
    st = batch.fresh_lane_state(sc, alg, 4, "cpu")
    slots, rounds = (0, 1, 3), (1, 2, 0)
    solo = []
    for slot, ig, r in zip(slots, igs, rounds):
        st.admit(slot, ig, ig.n_nodes // 2, 100)
        # advance this lane alone to round r, as a stream would have
        colors, aux, wl = _solo_state(alg, fused, ig, r)
        rows = slice(slot * sc.n_pad, slot * sc.n_pad + ig.n_nodes)
        st.buf.colors[rows] = colors[:ig.n_nodes]
        st.buf.aux.view(4, -1)[slot, :aux.numel()] = aux.reshape(-1)
        st.buf.mask[rows] = wl.mask
        st.buf.ctr[batch.COUNT, slot] = int(wl.mask.sum())
        st.buf.ctr[batch.IT, slot] = r
        assert int(wl.count) > 0          # every lane still runs
        solo.append(_solo_state(alg, fused, ig, r + 1))
    st.host = st.buf.ctr.numpy().astype(np.int64)
    assert st.run(1, step=step, window=64, force_hub=False) == 1
    for slot, ig, r, (colors, aux, wl) in zip(slots, igs, rounds, solo):
        n, off = ig.n_nodes, slot * sc.n_pad
        np.testing.assert_array_equal(st.buf.colors[off:off + n].numpy(),
                                      colors[:n].numpy())
        assert (st.buf.colors[off + n:off + sc.n_pad] == ipgc.PAD_COLOR).all()
        lane_aux = st.buf.aux.view(4, -1)[slot]
        np.testing.assert_array_equal(lane_aux[:aux.numel()].numpy(),
                                      aux.reshape(-1).numpy())
        np.testing.assert_array_equal(st.buf.mask[off:off + n].numpy(),
                                      wl.mask.numpy())
        assert int(st.host[batch.COUNT][slot]) == int(wl.count)
        assert int(st.host[batch.IT][slot]) == r + 1
    inert = slice(2 * sc.n_pad, 3 * sc.n_pad)
    assert (st.buf.colors[inert] == ipgc.PAD_COLOR).all()
    assert not st.buf.mask[inert].any()
    assert st.host[:, 2].tolist() == [0, 0, 0, 0]


def test_widen_and_take_lanes_carry_the_lanes_verbatim():
    alg = get_algorithm("jpl")
    g = _pair("europe_osm_s", 0.005)[1]
    ig = ipgc.prepare(g, device="cpu")
    sc = batch.shape_class_for([ig], 2048, 128, "ell-tail")
    p = ipgc.pad_prepared(ig, sc.n_pad, sc.k_pad, sc.t_pad, sc.nh_pad)
    st = batch.fresh_lane_state(sc, alg, 1, "cpu")
    st.admit(0, ig, 0, 100)
    st.run(3, step=alg.lane_step(False), window=128, force_hub=False)
    wide = batch.widen_lanes(st, 4)
    assert wide.b == 4 and wide.ig.n_nodes == 4 * sc.n_pad
    wide.admit(2, ig, 0, 100)
    back = batch.take_lanes(wide, [2, 0])
    n = sc.n_pad
    np.testing.assert_array_equal(back.buf.colors[n:2 * n].numpy(),
                                  st.buf.colors[:n].numpy())
    np.testing.assert_array_equal(back.buf.mask[n:].numpy(),
                                  st.buf.mask.numpy())
    assert back.host[:, 1].tolist() == st.host[:, 0].tolist()
    assert back.host[:, 0].tolist() == [ig.n_nodes, 0, 0, 0]
    assert back.buf.aux.tolist() == [0, 3]
    # lane 1's graph now sits at offset n, its sentinel the new flat one
    ell = back.ig.ell_idx[n:2 * n]
    np.testing.assert_array_equal(
        ell.numpy(), np.where(p.ell_idx.numpy() == n, 2 * n,
                              p.ell_idx.numpy() + n))
    with pytest.raises(ValueError, match="shrink"):
        batch.widen_lanes(wide, 2)


# ---------------------------------------------------------------------------
# memory: a lane group's bytes reckoned before they are allocated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["ipgc", "jpl"])
@pytest.mark.parametrize("b", [1, 4])
def test_group_bytes_are_the_lane_groups_bytes(algo, b):
    """The reckoned graph and state bytes equal what the group owns, for
    lanes with hubs and without; no lane step builds an (N, K) tile (their
    row kernels gather inside the kernel), so every trip is reckoned at
    its rows' and tail entries' intermediates."""
    alg = get_algorithm(algo)
    igs = [ipgc.prepare(_pair(n, s)[1], device="cpu")
           for n, s in (("hollywood-2009_s", 0.01), ("europe_osm_s", 0.005))]
    sc = batch.shape_class_for(igs, 1 << 12, 64, "ell-tail")
    assert sc.nh_pad > 0
    st = batch.LaneState(sc, (igs * b)[:b], alg, "cpu")
    need = batch.group_bytes(sc, b, alg)
    assert set(need) == {"graph", "state"}
    assert need["graph"] + need["state"] == st.nbytes
    n = b * sc.n_pad
    rest = batch.trip_bytes(sc, b)
    assert rest == (batch.TRIP_ROW_BYTES * n
                    + batch.TRIP_TAIL_BYTES * b * sc.t_pad)
    for fused in (False, True):
        step = alg.lane_step(fused)
        assert batch.group_bytes(sc, b, alg, step)["trip"] == rest


def test_run_batch_refuses_before_allocating(monkeypatch):
    """With less device memory free than the reckoning needs, run_batch
    raises LaneMemoryError, naming the bytes, before any lane group is
    built; with enough, it runs as before."""
    graphs = [_pair(n, 0.02)[1] for n in GRAPHS[:2]]
    s = Session("cpu")
    spec = ExecutionSpec(regime="host")
    want = s.run_batch(spec, graphs)
    fresh = Session("cpu")
    monkeypatch.setattr(batch, "_free_bytes", lambda device: 1024)
    with pytest.raises(batch.LaneMemoryError, match="run_batch of 2 graphs "
                       r"needs [0-9.]+ GiB on cpu \(graph "):
        fresh.run_batch(spec, graphs)
    assert not [k for k in fresh.cache if k[0] == "stack"]
    # a warm call builds nothing, so it needs nothing
    s.run_batch(spec, graphs)
    monkeypatch.setattr(batch, "_free_bytes", lambda device: 1 << 50)
    for g, w in zip(fresh.run_batch(spec, graphs), want):
        _assert_same(g, w)


def test_run_batch_refused_midway_leaves_no_group(monkeypatch):
    """When a later check refuses (the free memory shrank after the
    call's reckoning), the groups the call built leave the session."""
    graphs = [_pair(n, 0.02)[1] for n in GRAPHS]   # three lane groups
    s = Session("cpu")
    # room for the reckoning and the first two groups, not the third
    answers = iter([1 << 50] * 3)
    built = []
    real = batch.LaneState.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(batch.LaneState, "__init__", init)
    monkeypatch.setattr(batch, "_free_bytes",
                        lambda device: next(answers, 1024))
    with pytest.raises(batch.LaneMemoryError, match="a lane group of"):
        s.run_batch(ExecutionSpec(regime="host"), graphs)
    assert len(built) == 2
    assert not [k for k in s.cache if k[0] == "stack"]
    assert [k[0] for k in s.cache] == ["prep"] * len(graphs)


def test_lane_group_refuses_before_allocating(monkeypatch):
    """A stream's lane group checks its graph and state bytes when it is
    made, widened or regrown."""
    alg = get_algorithm("ipgc")
    ig = ipgc.prepare(_pair("europe_osm_s", 0.005)[1], device="cpu")
    sc = batch.shape_class_for([ig], 2048, 128, "ell-tail")
    st = batch.fresh_lane_state(sc, alg, 1, "cpu")
    monkeypatch.setattr(batch, "_free_bytes", lambda device: 1024)
    with pytest.raises(batch.LaneMemoryError, match="a lane group of 1 x"):
        batch.fresh_lane_state(sc, alg, 1, "cpu")
    with pytest.raises(batch.LaneMemoryError, match="a lane group of 2 x"):
        batch.widen_lanes(st, 2)


# ---------------------------------------------------------------------------
# batch plumbing against the reference: pad_prepared, stacked_worklist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,scale", [("hollywood-2009_s", 0.01),
                                        ("europe_osm_s", 0.005),
                                        ("kron_g500-logn21_s", 0.01)])
def test_pad_prepared_matches_reference(name, scale):
    jg, tg = _pair(name, scale)
    jig, tig = jipgc.prepare(jg), ipgc.prepare(tg, device="cpu")
    n, k, t, nh = (tig.n_nodes, tig.ell_width, tig.tail_src.shape[0],
                   tig.n_hub)
    for pads in ((n, k, t, nh), (n + 64, k + 8, t + 16, nh + 4),
                 (2 * n, 2 * k, 2 * t + 8, 2 * nh + 1)):
        want = jipgc.pad_prepared(jig, *pads)
        got = ipgc.pad_prepared(tig, *pads)
        assert (got.n_nodes, got.ell_width, got.n_hub, got.layout_kind) == \
            (want.n_nodes, want.ell_width, want.n_hub, want.layout_kind)
        for f in ipgc.ARRAY_FIELDS:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f


def test_pad_prepared_is_inert():
    """One dense step on the padded graph equals the same step on the
    original, on the original's slots; pad slots never change."""
    g = _pair("hollywood-2009_s", 0.02)[1]
    ig = ipgc.prepare(g, device="cpu")
    n = ig.n_nodes
    pad = ipgc.pad_prepared(ig, n + 64, ig.ell_width + 8,
                            ig.tail_src.shape[0] + 16, ig.n_hub + 4)
    colors0 = ipgc.init_colors(n, "cpu")
    colors0_p = torch.cat([colors0[:n],
                           torch.full((65,), int(colors0[n]),
                                      dtype=torch.int32)])
    wl = Worklist(mask=torch.ones(n, dtype=torch.bool),
                  items=torch.arange(n, dtype=torch.int32),
                  count=torch.tensor(n, dtype=torch.int32))
    wl_p = stacked_worklist([n], n + 64, "cpu")
    wl_p = Worklist(mask=wl_p.mask[0], items=wl_p.items[0],
                    count=wl_p.count[0])
    c1, b1, w1 = ipgc.dense_step(ig, colors0, torch.zeros(n, dtype=torch.int32),
                                 wl, window=64, force_hub=False)
    c2, b2, w2 = ipgc.dense_step(pad, colors0_p,
                                 torch.zeros(n + 64, dtype=torch.int32),
                                 wl_p, window=64, force_hub=False)
    np.testing.assert_array_equal(c1[:n].numpy(), c2[:n].numpy())
    np.testing.assert_array_equal(b1.numpy(), b2[:n].numpy())
    assert int(w1.count) == int(w2.count)
    np.testing.assert_array_equal(w1.mask.numpy(), w2.mask[:n].numpy())
    assert (c2[n:] == ipgc.PAD_COLOR).all()
    assert not w2.mask[n:].any()


def test_pad_prepared_rejects_csr_segment():
    g = get_dataset("kron_g500-logn21_s", scale=0.01, layout="csr-segment")
    ig = ipgc.prepare(g, plan=g.layout, device="cpu")
    with pytest.raises(AssertionError, match="csr-segment"):
        ipgc.pad_prepared(ig, ig.n_nodes + 8, ig.ell_width,
                          ig.tail_src.shape[0], ig.n_hub)


@pytest.mark.parametrize("real_ns,n_pad", [([3, 0, 5], 8), ([8], 8),
                                           ([0, 0], 16), ([1, 7, 2, 4], 9)])
def test_stacked_worklist_matches_reference(real_ns, n_pad):
    want = j_stacked_worklist(real_ns, n_pad)
    got = stacked_worklist(real_ns, n_pad, "cpu")
    for f in ("mask", "items", "count"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_lane_colors_and_empty_lane():
    np.testing.assert_array_equal(
        batch.lane_colors(3, 6, "cpu").numpy(), [-1, -1, -1, -2, -2, -2, -2])
    sc = batch.ShapeClass(16, 8, 8, 2, 64, "ell-tail")
    e = batch.empty_lane(sc, "cpu")
    assert (e.ell_idx == 16).all() and (e.priority == -1).all()
    assert (e.hub_slot == 2).all() and not e.tail_valid.any()


def test_shape_classes_match_reference():
    from repro.exec import batch as jbatch
    pairs = [_pair(n, 0.01) for n in GRAPHS]
    jigs = [jipgc.prepare(j) for j, _ in pairs]
    tigs = [ipgc.prepare(t, device="cpu") for _, t in pairs]
    want = jbatch.shape_class_for(jigs, 1 << 14, 64, "ell-tail")
    got = batch.shape_class_for(tigs, 1 << 14, 64, "ell-tail")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for jig, tig in zip(jigs, tigs):
        small = batch.shape_class_for(tigs[:1], 1 << 14, 64, "ell-tail")
        jsmall = jbatch.shape_class_for(jigs[:1], 1 << 14, 64, "ell-tail")
        assert dataclasses.astuple(batch.grow_shape_class(small, tig)) == \
            dataclasses.astuple(jbatch.grow_shape_class(jsmall, jig))


# ---------------------------------------------------------------------------
# request catalogs (graphs/registry) and the spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(count=32, seed=7), dict(count=32, seed=8),
    dict(count=16, seed=7, rate=10.0),
    dict(count=16, seed=7, rate=10.0, burstiness=4.0),
    dict(count=16, seed=7, names=("europe_osm_s", "circuit5M_s",
                                  "indochina-2004_s", "rgg_n_2_24_s0_s"),
         min_nodes=65_536, max_nodes=1_048_576, alpha=1.5),
])
def test_heavy_tail_requests_match_reference(kw):
    assert heavy_tail_requests(**kw) == j_heavy_tail(**kw)


def test_heavy_tail_knob_validation():
    with pytest.raises(ValueError, match="exactly one"):
        get_dataset_batch(["europe_osm_s"], heavy_tail=4)
    with pytest.raises(ValueError, match="exactly one"):
        get_dataset_batch()
    with pytest.raises(ValueError, match="node-parameterized"):
        heavy_tail_requests(4, names=("Audikw_1_s",))
    with pytest.raises(ValueError, match="min_nodes"):
        heavy_tail_requests(4, min_nodes=0)
    with pytest.raises(ValueError, match="rate"):
        heavy_tail_requests(4, rate=0.0)
    with pytest.raises(ValueError, match="burstiness"):
        heavy_tail_requests(4, rate=1.0, burstiness=0.0)


def test_get_dataset_batch_builds_and_shares():
    reqs = ["europe_osm_s", ("europe_osm_s", {"seed": 3}), "europe_osm_s"]
    gs = get_dataset_batch(reqs, scale=0.01)
    want = j_get_dataset_batch(reqs, scale=0.01)
    assert len(gs) == 3
    assert gs[0] is gs[2]                 # same cell -> same cached Graph
    assert gs[0] is not gs[1]             # override produced a new cell
    for g, w in zip(gs, want):
        assert (g.name, g.n_nodes, g.n_edges) == (w.name, w.n_nodes,
                                                  w.n_edges)
        np.testing.assert_array_equal(g.arrays.col_idx,
                                      np.asarray(w.arrays.col_idx))


def test_get_dataset_batch_heavy_tail_matches_reference():
    knobs = {"count": 6, "rate": 5.0, "max_nodes": 20_000}
    gs = get_dataset_batch(heavy_tail=knobs, seed=7)
    want = j_get_dataset_batch(heavy_tail=knobs, seed=7)
    assert [(g.name, g.n_nodes, g.n_edges) for g in gs] == \
        [(w.name, w.n_nodes, w.n_edges) for w in want]


def test_validate_batchable_and_static_key():
    spec = ExecutionSpec(regime="host", algo="jpl", window=64)
    assert spec.validate_batchable() == get_algorithm("jpl")
    assert hash(spec.static_key())
    assert spec.static_key() != ExecutionSpec(regime="outlined",
                                              window=64).static_key()
    assert spec.static_key() == ExecutionSpec(
        regime="host", algo=get_algorithm("jpl"), window=64).static_key()
    for name in ("ipgc", "jpl", "spec-greedy"):
        assert get_algorithm(name).batch_safe


def test_batch_and_stream_never_import_jax():
    """run_batch and a stream on the CPU leave JAX (and the JAX package)
    out of ``sys.modules``."""
    import os
    import subprocess
    import sys
    import textwrap
    code = """
        import sys
        import repro_torch
        from repro_torch.exec import ExecutionSpec, Session
        from repro_torch.serve import ManualClock, StreamConfig
        g = repro_torch.get_dataset("europe_osm_s", scale=0.005,
                                    layout="ell-tail", ell_cap=128)
        s = Session("cpu")
        (r,) = s.run_batch(ExecutionSpec(), [g])
        repro_torch.verify_coloring(g, r.colors)
        stream = s.stream(ExecutionSpec(algo="jpl"),
                          StreamConfig(clock=ManualClock(tick=1.0)))
        (r,) = stream.run([g])
        repro_torch.verify_coloring(g, r.colors)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LEAKED", bad)
    """
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.path.abspath(src),
                                  OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
