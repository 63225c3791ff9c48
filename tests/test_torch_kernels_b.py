"""The plain PyTorch versions of the port's ``jpl_extrema`` and
``frontier_probe`` kernels against the JAX oracles in
``repro/kernels/ref.py`` and the Pallas kernels in interpret mode, on the
same numpy inputs; and the JPL round hash against JAX's. All of it is
integer work, so every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos.jpl import round_hash as j_round_hash
from repro.kernels import ref
from repro.kernels.frontier import frontier_probe_pallas
from repro.kernels.jpl_prio import jpl_extrema_pallas
from repro_torch.algos.jpl import round_hash
from repro_torch.kernels import ops
from repro_torch.kernels.frontier import frontier_probe_plain
from repro_torch.kernels.jpl_prio import LARGE, Table, jpl_extrema_plain

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

SHAPES = [(1, 1), (7, 9), (64, 16), (100, 3), (257, 40), (300, 128)]

_extrema_ref = jax.jit(ref.jpl_extrema_ref)
_probe_ref = jax.jit(ref.frontier_probe_ref)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _npr(r, k, seed):
    """Priorities with ~30% inactive (-1) entries, as a JPL round has."""
    rng = np.random.default_rng(seed)
    npr = rng.integers(0, 2**31 - 1, size=(r, k)).astype(np.int32)
    return np.where(rng.random((r, k)) < 0.3, -1, npr).astype(np.int32)


@pytest.mark.parametrize("r,k", SHAPES)
def test_jpl_extrema_plain_matches_ref_and_pallas(r, k):
    npr = _npr(r, k, r * 1000 + k)
    got = jpl_extrema_plain(_t(npr))
    assert all(x.dtype == torch.int32 for x in got)
    for want, what in ((_extrema_ref(jnp.asarray(npr)), "ref"),
                       (jpl_extrema_pallas(jnp.asarray(npr), interpret=True),
                        "pallas")):
        _eq(got[0], want[0], f"max vs {what}")
        _eq(got[1], want[1], f"min vs {what}")
    # the wrapper sends CPU tensors to the plain twin: rows of an ELL tile
    # whose entries index a table holding npr give npr's extrema
    ell = np.arange(r * k, dtype=np.int32).reshape(r, k)
    prio = np.append(npr.reshape(-1), np.int32(-1))
    disp = ops.jpl_extrema(_t(ell), None, Table(_t(prio)))
    assert all(torch.equal(a, b) for a, b in zip(disp, got))


@pytest.mark.parametrize("r,k", [(3, 4), (1, 1), (5, 128)])
def test_jpl_extrema_all_inactive_rows(r, k):
    """A row with no active entry: max -1, min LARGE."""
    npr = np.full((r, k), -1, np.int32)
    gm, gn = jpl_extrema_plain(_t(npr))
    assert (gm.numpy() == -1).all() and (gn.numpy() == LARGE).all()
    wm, wn = jpl_extrema_pallas(jnp.asarray(npr), interpret=True)
    _eq(gm, wm)
    _eq(gn, wn)


def test_jpl_extrema_empty_rows():
    got = jpl_extrema_plain(torch.zeros((0, 8), dtype=torch.int32))
    assert [tuple(x.shape) for x in got] == [(0,), (0,)]


@pytest.mark.parametrize("r,k", SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_frontier_probe_plain_matches_ref_and_pallas(r, k, density):
    rng = np.random.default_rng(r * 7 + k + int(density * 100))
    nbr = rng.random((r, k)) < density
    unvisited = rng.random(r) < 0.6
    got = frontier_probe_plain(_t(nbr), _t(unvisited))
    assert got.dtype == torch.bool
    _eq(got, _probe_ref(jnp.asarray(nbr), jnp.asarray(unvisited)), "ref")
    _eq(got, frontier_probe_pallas(jnp.asarray(nbr), jnp.asarray(unvisited),
                                   interpret=True), "pallas")
    _eq(ops.frontier_probe(_t(nbr), _t(unvisited)), got, "dispatch")


def test_frontier_probe_all_unvisited_is_any():
    """The bottom-up step passes unvisited all true: the probe is then a
    row any()."""
    nbr = np.random.default_rng(2).random((50, 16)) < 0.1
    got = frontier_probe_plain(_t(nbr), torch.ones(50, dtype=torch.bool))
    _eq(got, nbr.any(1))


IDS = np.concatenate([np.arange(5000),
                      [2**21, 50_800_000, 2**31 - 2, 2**31 - 1]]
                     ).astype(np.int32)


@pytest.mark.parametrize("rnd", [0, 1, 7, 9999])
def test_round_hash_matches_jax(rnd):
    want = np.asarray(j_round_hash(jnp.asarray(IDS), jnp.int32(rnd)))
    got = round_hash(_t(IDS), torch.tensor(rnd, dtype=torch.int32))
    assert got.dtype == torch.int32
    _eq(got, want)
    assert (got.numpy() >= 0).all()


def test_round_hash_on_a_tile():
    """The sparse JPL round hashes a (C, K) block of ids."""
    tile = np.random.default_rng(5).integers(0, 2**31 - 1, size=(40, 24)
                                             ).astype(np.int32)
    want = np.asarray(j_round_hash(jnp.asarray(tile), jnp.int32(3)))
    _eq(round_hash(_t(tile), torch.tensor(3, dtype=torch.int32)), want)
