"""The gathering signatures of the ``mex_window`` and ``jpl_extrema``
kernels: their plain twins (``mex_window_rows_plain``,
``jpl_extrema_rows_plain``, which ``kernels.ops`` runs on CPU tensors)
against the pre-gathered plain versions and ``repro``'s oracles on the
same numpy inputs, the JPL hash source against ``repro``'s round hash; and
one two-phase step and one JPL round of each phase against ``repro``'s,
with both kernels handed the graph's ELL tile itself (no step builds an
(R, K) neighbour tile). All state is int32/bool, so every comparison is
exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import jpl as jjpl
from repro.core import ipgc as jipgc
from repro.core import worklist as jwl
from repro.graphs import get_dataset as jget
from repro.graphs.layout import LAYOUT_KINDS
from repro.kernels import ref
from repro_torch.algos import jpl as tjpl
from repro_torch.core import ipgc as tipgc
from repro_torch.kernels import ops
from repro_torch.kernels.jpl_prio import (LARGE, Hash, Table,
                                          jpl_extrema_plain,
                                          jpl_extrema_rows_plain, round_hash)
from repro_torch.kernels.mex_window import (mex_window_plain,
                                            mex_window_rows_plain)

from _gather_cases import gather_case, gathered, jpl_prio_table

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

_mex_ref = jax.jit(ref.mex_window_ref, static_argnums=3)
_extrema_ref = jax.jit(ref.jpl_extrema_ref)
_j_round_hash = jax.jit(jjpl.round_hash)

SHAPES = [(0, 8), (1, 8), (7, 8), (40, 16), (100, 40), (257, 128), (50, 3),
          (30, 13)]
ROUNDS = [0, 1, 7, 9999]


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _mex_args(c):
    return (_t(c["colors"]), _t(c["ell"]), _t(c["rows"]), _t(c["base"]),
            _t(c["active"]), _t(c["hub_forb"]), _t(c["hub_slot"]))


def _assert_mex(c):
    """``mex_window_rows_plain`` against ``mex_window_plain`` on the
    gathered tiles and against ``repro``'s oracle, -1 on the rows that are
    not active, and ``ops.mex_window`` on CPU tensors against the twin."""
    g = gathered(c)
    w = c["window"]
    act = c["active"]
    got = mex_window_rows_plain(*_mex_args(c), w)
    assert got.dtype == torch.int32 and got.shape == (len(act),)
    pre = mex_window_plain(_t(g["nc"]), _t(c["base"]), _t(g["extra"]), w)
    _eq(got, torch.where(_t(act), pre, -1), "vs pre-gathered")
    if len(act):
        extra = (g["extra"] if g["extra"] is not None
                 else np.zeros((len(act), w), bool))
        want = np.asarray(_mex_ref(jnp.asarray(g["nc"]),
                                   jnp.asarray(c["base"]),
                                   jnp.asarray(extra), w))
        _eq(got, np.where(act, want, -1), "vs ref")
    _eq(ops.mex_window(*_mex_args(c), w), got, "ops")
    assert (got.numpy()[~act] == -1).all()
    return got


@pytest.mark.parametrize("window", [1, 32, 256])
@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rg,k", SHAPES)
def test_mex_window_rows_plain_matches_ref(rg, k, sparse, hub, window):
    """Rows None and sparse rows with pads >= Rg, Rg = 0, hub and no-hub,
    rows of length 0, < K and K, inactive rows; hub rows with an
    all-forbidden window (every third hub) and one-color windows give
    exhausted rows (-1)."""
    c = gather_case(rg * 17 + k + 3 * sparse + hub + window, rg, k,
                    sparse=sparse, hub=hub, window=window, lo=4)
    got = _assert_mex(c)
    extra = gathered(c)["extra"]
    if extra is not None:
        assert (got.numpy()[extra.all(axis=1)] == -1).all()


def test_mex_window_empty_and_sentinel_rows():
    """An active row >= Rg reads no neighbour: its whole window is free
    (first 0), also when its own base and flags are arbitrary."""
    c = gather_case(9, 30, 8, sparse=True, hub=True)
    bad = c["rows"] >= c["rg"]
    assert bad.any()
    c["active"] = c["active"] | bad
    got = _assert_mex(c)
    assert (got.numpy()[bad] == 0).all()


def test_mex_window_never_reads_the_non_hub_row():
    """The kernel reads a hub table row only where the hub slot is below
    n_hub; the twin equally ignores what row n_hub holds."""
    c = gather_case(10, 60, 8, sparse=True, hub=True, window=32)
    want = _assert_mex(c)
    c["hub_forb"] = c["hub_forb"].copy()
    c["hub_forb"][-1] = True
    _eq(mex_window_rows_plain(*_mex_args(c), 32), want)


def _npr(c, source, prio, rnd):
    """The pre-gathered (R, K) priority tile of the Pallas signature, with
    ``repro``'s round hash for the hash source."""
    nbr = gathered(c)["nbr"]
    if source == "table":
        return prio[nbr]
    h = np.asarray(_j_round_hash(jnp.asarray(nbr), jnp.int32(rnd)))
    return np.where(c["colors"][nbr] == -1, h, -1).astype(np.int32)


def _source(c, source, prio, rnd):
    if source == "table":
        return Table(_t(prio))
    return Hash(_t(c["colors"]), torch.tensor(rnd, dtype=torch.int32))


@pytest.mark.parametrize("rnd", ROUNDS)
@pytest.mark.parametrize("source", ["table", "hash"])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rg,k", SHAPES)
def test_jpl_extrema_rows_plain_matches_ref(rg, k, sparse, source, rnd):
    """Both sources, rows None and sparse with pads, Rg = 0, rows of
    length 0, < K and K: the twin equals ``jpl_extrema_plain`` and
    ``repro``'s oracle on the gathered tile, and a row without a real
    neighbour gives max -1 and min LARGE."""
    c = gather_case(rg * 19 + k + 5 * sparse + rnd, rg, k, sparse=sparse,
                    hub=False, lo=6)
    prio = jpl_prio_table(c, rg + k + rnd)
    args = (_t(c["ell"]), _t(c["rows"]), _source(c, source, prio, rnd))
    got = jpl_extrema_rows_plain(*args)
    npr = _npr(c, source, prio, rnd)
    r = npr.shape[0]
    assert all(x.dtype == torch.int32 and x.shape == (r,) for x in got)
    for a, b in zip(got, jpl_extrema_plain(_t(npr))):
        _eq(a, b, "vs pre-gathered")
    if r:
        for a, b in zip(got, _extrema_ref(jnp.asarray(npr))):
            _eq(a, b, "vs ref")
    for a, b in zip(ops.jpl_extrema(*args), got):
        _eq(a, b, "ops")
    empty = (gathered(c)["nbr"] == c["n"]).all(axis=1)
    assert (got[0].numpy()[empty] == -1).all()
    assert (got[1].numpy()[empty] == LARGE).all()


def test_jpl_extrema_rows_of_no_width():
    """K = 0: every row is empty."""
    ell = torch.zeros((5, 0), dtype=torch.int32)
    mx, mn = jpl_extrema_rows_plain(ell, None,
                                    Table(torch.full((9,), 3,
                                                     dtype=torch.int32)))
    assert (mx == -1).all() and (mn == LARGE).all() and mx.shape == (5,)


def test_jpl_extrema_ignores_the_pad_slot():
    """The kernel stops at a row's first padding entry and never reads slot
    N; the twin equally ignores what slot N holds."""
    c = gather_case(12, 80, 16, sparse=True, hub=False)
    prio = jpl_prio_table(c, 12)
    want = jpl_extrema_rows_plain(_t(c["ell"]), _t(c["rows"]),
                                  Table(_t(prio)))
    prio[c["n"]] = 2**31 - 1
    colors = c["colors"].copy()
    colors[c["n"]] = -1                       # as if uncolored
    for source in (Table(_t(prio)), Hash(_t(colors),
                                         torch.tensor(3, dtype=torch.int32))):
        got = jpl_extrema_rows_plain(_t(c["ell"]), _t(c["rows"]), source)
        if isinstance(source, Table):
            for a, b in zip(got, want):
                _eq(a, b)
        empty = (gathered(c)["nbr"] == c["n"]).all(axis=1)
        assert (got[0].numpy()[empty] == -1).all()


IDS = np.concatenate([np.arange(3000), [2**21, 50_800_000, 2**31 - 3,
                                        2**31 - 2, 2**31 - 1]]
                     ).astype(np.int32)


@pytest.mark.parametrize("rnd", ROUNDS)
def test_round_hash_matches_repro_up_to_int_max(rnd):
    """The hash the twin applies (and the kernel's uint32 mixer copies)
    equals ``repro``'s round hash at ids up to 2**31 - 1."""
    want = np.asarray(_j_round_hash(jnp.asarray(IDS), jnp.int32(rnd)))
    got = round_hash(_t(IDS), torch.tensor(rnd, dtype=torch.int32))
    assert got.dtype == torch.int32 and (got.numpy() >= 0).all()
    _eq(got, want)


# --- the steps against repro's -------------------------------------------------

WINDOW = 32


def _prepared(name, layout):
    jig = jipgc.prepare(jget(name, scale=0.02, layout=layout))
    arrays = {f.name: np.asarray(getattr(jig, f.name))
              for f in dataclasses.fields(jig)
              if getattr(jig, f.name) is not None
              and not isinstance(getattr(jig, f.name), (int, str))}
    tig = tipgc.from_numpy(arrays, layout_kind=jig.layout_kind, device="cpu")
    return jig, tig


def _resized(jig, wl, sparse):
    if not sparse:
        return wl
    caps = jwl.bucket_capacities(jig.n_nodes, ratio=2)
    return jwl.resize_items(wl, jwl.pick_bucket(caps, int(wl.count)),
                            jig.n_nodes)


class _Spy:
    """Records the arguments of each call of ``ops.<name>``."""

    def __init__(self, monkeypatch, name):
        self.calls = []
        real = getattr(ops, name)

        def spy(*args, **kw):
            self.calls.append(args)
            return real(*args, **kw)

        monkeypatch.setattr(ops, name, spy)


def _assert_state(got, want):
    for g, w, what in ((got[0], want[0], "colors"), (got[1], want[1], "aux"),
                       (got[2].mask, want[2].mask, "mask"),
                       (got[2].items, want[2].items, "items"),
                       (got[2].count, want[2].count, "count")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)


def _assert_untiled(spy, ell_at, tig, items, phase):
    """One kernel call, handed the graph's ELL tile itself (not a
    neighbour tile) and, in a sparse step, the worklist's items."""
    assert len(spy.calls) == 1
    ell, rows = spy.calls[0][ell_at:ell_at + 2]
    assert ell is tig.ell_idx
    if phase == "dense":
        assert rows is None
    else:
        assert torch.equal(rows, items)


@pytest.mark.parametrize("phase", ["dense", "sparse"])
@pytest.mark.parametrize("layout", LAYOUT_KINDS)
@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "europe_osm_s"])
def test_two_phase_step_matches_reference(monkeypatch, name, layout, phase):
    """A two-phase step from a state two dense steps into a run equals
    ``repro``'s; its ``mex_window`` call gathers from the ELL tile."""
    jig, tig = _prepared(name, layout)
    n = jig.n_nodes
    colors, base = jipgc.init_colors(n), jnp.zeros((n,), np.int32)
    wl = jwl.full_worklist(n)
    for _ in range(2):
        colors, base, wl = jipgc.dense_step(jig, colors, base, wl,
                                            window=WINDOW)
    wl = _resized(jig, wl, phase == "sparse")
    jstep, tstep = {"dense": (jipgc.dense_step, tipgc.dense_step),
                    "sparse": (jipgc.sparse_step, tipgc.sparse_step)}[phase]
    want = jstep(jig, colors, base, wl, window=WINDOW)
    state = tipgc.state_from_numpy(*(np.asarray(x) for x in (
        colors, base, wl.mask, wl.items, wl.count)), "cpu")
    spy = _Spy(monkeypatch, "mex_window")
    with tipgc.GATHER_COUNTS.scope() as gc:
        got = tstep(tig, *state, window=WINDOW)
        gathers = gc["neighbor_colors"]
    _assert_state(got, want)
    assert gathers == 2
    if tig.layout_kind != "csr-segment":
        _assert_untiled(spy, 1, tig, state[2].items, phase)


@pytest.mark.parametrize("phase", ["dense", "sparse"])
@pytest.mark.parametrize("layout", LAYOUT_KINDS)
@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "europe_osm_s"])
def test_jpl_round_matches_reference(monkeypatch, name, layout, phase):
    """A JPL round from a state two dense rounds into a run equals
    ``repro``'s, with the reference's gather profile (dense 0, sparse 1);
    its ``jpl_extrema`` call gathers from the ELL tile: the priority table
    in a dense round, the hash of the uncolored neighbours in a sparse
    one."""
    jig, tig = _prepared(name, layout)
    n = jig.n_nodes
    colors, rnd = jipgc.init_colors(n), jnp.zeros((), jnp.int32)
    wl = jwl.full_worklist(n)
    for _ in range(2):
        colors, rnd, wl = jjpl.jpl_dense_step(jig, colors, rnd, wl,
                                              impl="jnp")
    wl = _resized(jig, wl, phase == "sparse")
    jstep, tstep = {"dense": (jjpl.jpl_dense_step, tjpl.jpl_dense_step),
                    "sparse": (jjpl.jpl_sparse_step,
                               tjpl.jpl_sparse_step)}[phase]
    want = jstep(jig, colors, rnd, wl, impl="jnp")
    c, _, w = tipgc.state_from_numpy(*(np.asarray(x) for x in (
        colors, colors, wl.mask, wl.items, wl.count)), "cpu")
    spy = _Spy(monkeypatch, "jpl_extrema")
    with tipgc.GATHER_COUNTS.scope() as gc:
        got = tstep(tig, c, torch.tensor(int(rnd), dtype=torch.int32), w)
        gathers = gc["neighbor_colors"]
    _assert_state(got, want)
    assert gathers == (0 if phase == "dense" else 1)
    _assert_untiled(spy, 0, tig, w.items, phase)
    assert isinstance(spy.calls[0][2], Table if phase == "dense" else Hash)
