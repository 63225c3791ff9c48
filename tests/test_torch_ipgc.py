"""One step of each of the port's four IPGC step functions against
``repro``'s, from the same mid-run state, on every layout kind, with and
without the forced hub side-channel; plus the worklist helpers. Exact:
all state is int32/bool."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ipgc as jipgc
from repro.core import worklist as jwl
from repro.core.policy import measure_launches
from repro.graphs import get_dataset as jget
from repro.graphs.layout import LAYOUT_KINDS
from repro_torch.core import ipgc as tipgc
from repro_torch.core import worklist as twl

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

STEPS = {
    ("two-phase", "dense"): (jipgc.dense_step, jipgc.dense_step_impl,
                             tipgc.dense_step),
    ("two-phase", "sparse"): (jipgc.sparse_step, jipgc.sparse_step_impl,
                              tipgc.sparse_step),
    ("fused", "dense"): (jipgc.fused_dense_step, jipgc.fused_dense_step_impl,
                         tipgc.fused_dense_step),
    ("fused", "sparse"): (jipgc.fused_sparse_step,
                          jipgc.fused_sparse_step_impl,
                          tipgc.fused_sparse_step),
}
WINDOW = 32


def _prepared(name, layout):
    jig = jipgc.prepare(jget(name, scale=0.02, layout=layout))
    arrays = {f.name: np.asarray(getattr(jig, f.name))
              for f in dataclasses.fields(jig)
              if getattr(jig, f.name) is not None
              and not isinstance(getattr(jig, f.name), (int, str))}
    tig = tipgc.from_numpy(arrays, layout_kind=jig.layout_kind, device="cpu")
    return jig, tig


def _mid_run_state(jig, fused, sparse):
    """A state two dense steps into a run, resized to its capacity bucket
    when the next step is a sparse one (as the Pipe does)."""
    n = jig.n_nodes
    colors, base = jipgc.init_colors(n), jax.numpy.zeros((n,), np.int32)
    wl = jwl.full_worklist(n)
    dense = jipgc.fused_dense_step if fused else jipgc.dense_step
    for _ in range(2):
        colors, base, wl = dense(jig, colors, base, wl, window=WINDOW)
    if sparse:
        caps = jwl.bucket_capacities(n, ratio=2)
        wl = jwl.resize_items(wl, jwl.pick_bucket(caps, int(wl.count)), n)
    return colors, base, wl


def _to_torch(colors, base, wl):
    return tipgc.state_from_numpy(*(np.asarray(x) for x in
                                    (colors, base, wl.mask, wl.items,
                                     wl.count)), "cpu")


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("layout", LAYOUT_KINDS)
@pytest.mark.parametrize("family,phase", list(STEPS))
@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "circuit5M_s"])
def test_step_matches_reference(name, family, phase, layout, force):
    jstep, jimpl, tstep = STEPS[family, phase]
    jig, tig = _prepared(name, layout)
    state = _mid_run_state(jig, family == "fused", phase == "sparse")
    want = jstep(jig, *state, window=WINDOW, force_hub=force)
    want_launches = measure_launches(jimpl, jig, *state, window=WINDOW,
                                     force_hub=force)
    with tipgc.forced_hub(force), tipgc.LAUNCH_COUNTS.scope() as lc, \
            tipgc.GATHER_COUNTS.scope() as gc:
        got = tstep(tig, *_to_torch(*state), window=WINDOW)
        launches, gathers = lc.as_dict(), gc.as_dict()
    for g, w, what in ((got[0], want[0], "colors"), (got[1], want[1], "base"),
                       (got[2].mask, want[2].mask, "mask"),
                       (got[2].items, want[2].items, "items"),
                       (got[2].count, want[2].count, "count")):
        assert g.dtype == (torch.bool if what == "mask" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)
    assert launches == want_launches
    expect = ({"mex": 0, "conflict": 0, "compact": 0, "fused": 1}
              if family == "fused" else
              {"mex": 1, "conflict": 1, "compact": 1, "fused": 0})
    assert launches == expect
    assert gathers == {"neighbor_colors": 1 if family == "fused" else 2}


def test_steps_leave_their_inputs_alone():
    _, tig = _prepared("kron_g500-logn21_s", "ell-tail")
    jig, _ = _prepared("kron_g500-logn21_s", "ell-tail")
    state = _to_torch(*_mid_run_state(jig, False, True))
    before = [t.clone() for t in (state[0], state[1], state[2].mask,
                                  state[2].items, state[2].count)]
    for step in (tipgc.dense_step, tipgc.sparse_step, tipgc.fused_dense_step,
                 tipgc.fused_sparse_step):
        step(tig, *state, window=WINDOW)
    after = (state[0], state[1], state[2].mask, state[2].items,
             state[2].count)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n,capacity", [(1, 1), (100, 100), (1000, 1000),
                                        (1000, 512), (1000, 1008)])
def test_worklist_compactions_match(n, capacity, density):
    rng = np.random.default_rng(n + capacity)
    mask = rng.random(n) < density
    want_i, want_c = jwl.compact_mask(jax.numpy.asarray(mask), capacity, n)
    got_i, got_c = twl.compact_mask(torch.from_numpy(mask), capacity, n)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert int(got_c) == int(want_c)
    items = np.where(rng.random(capacity) < 0.8,
                     rng.integers(0, n, size=capacity), n).astype(np.int32)
    keep = (rng.random(capacity) < density) & (items < n)
    want_i, want_c = jwl.compact_items(jax.numpy.asarray(items),
                                       jax.numpy.asarray(keep), n)
    got_i, got_c = twl.compact_items(torch.from_numpy(items),
                                     torch.from_numpy(keep), n)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert int(got_c) == int(want_c)


@pytest.mark.parametrize("n", [1, 8, 1000, 1025, 4096, 100_000])
@pytest.mark.parametrize("ratio", [2, 4])
def test_bucket_ladder_matches(n, ratio):
    caps = twl.bucket_capacities(n, ratio=ratio)
    assert caps == jwl.bucket_capacities(n, ratio=ratio)
    for count in (0, 1, n // 3, n):
        assert twl.pick_bucket(caps, count) == jwl.pick_bucket(caps, count)


@pytest.mark.parametrize("capacity", [3, 10, 16])
def test_resize_items_matches(capacity):
    items = np.array([4, 1, 7, 10, 10, 10, 10, 10, 10, 10], np.int32)
    mask = np.zeros(10, bool)
    jw = jwl.resize_items(jwl.Worklist(jax.numpy.asarray(mask),
                                       jax.numpy.asarray(items),
                                       jax.numpy.asarray(3)), capacity, 10)
    tw = twl.resize_items(twl.Worklist(torch.from_numpy(mask),
                                       torch.from_numpy(items),
                                       torch.tensor(3, dtype=torch.int32)),
                          capacity, 10)
    np.testing.assert_array_equal(tw.items.numpy(), np.asarray(jw.items))
    assert tw.capacity == capacity and tw.count is not None
