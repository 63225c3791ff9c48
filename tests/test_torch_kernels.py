"""Plain PyTorch versions of the port's kernels against the JAX oracles in
``repro/kernels/ref.py`` (and once against the Pallas kernels in interpret
mode), on the same numpy inputs. All state is int32/bool, so every
comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.compact import compact_pallas
from repro.kernels.conflict import conflict_pallas
from repro.kernels.fused_compact import fused_compact_pallas
from repro.kernels.mex_window import mex_window_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.compact import compact_plain
from repro_torch.kernels.conflict import conflict_plain
from repro_torch.kernels.fused_compact import fused_compact_plain
from repro_torch.kernels.mex_window import mex_window_plain

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)


# the oracles, jitted: one compile per shape instead of one per primitive
_mex_ref = jax.jit(ref.mex_window_ref, static_argnums=3)
_conflict_ref = jax.jit(ref.conflict_ref)
_compact_ref = jax.jit(ref.compact_ref)
_fused_ref = jax.jit(ref.fused_compact_ref,
                     static_argnames=("window", "capacity", "n_sentinel"))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _mex_case(rng, r, k, w, cmax=300):
    nc = rng.integers(-2, cmax, size=(r, k)).astype(np.int32)
    base = (rng.integers(0, max(cmax // w, 1), size=(r,)) * w).astype(
        np.int32)
    extra = rng.random((r, w)) < 0.25
    return nc, base, extra


@pytest.mark.parametrize("r", [1, 7, 32, 100, 257])
@pytest.mark.parametrize("k", [1, 8, 40, 128])
@pytest.mark.parametrize("w", [128, 256])
def test_mex_window_plain_matches_ref(r, k, w):
    nc, base, extra = _mex_case(np.random.default_rng(r * 1000 + k * 10 + w),
                                r, k, w)
    want = _mex_ref(_j(nc), _j(base), _j(extra), w)
    _eq(mex_window_plain(_t(nc), _t(base), _t(extra), w), want)
    # no extra bitmap == an all-false one
    want0 = _mex_ref(_j(nc), _j(base), jnp.zeros((r, w), bool), w)
    _eq(mex_window_plain(_t(nc), _t(base), None, w), want0)


def test_mex_window_full_window():
    """Every slot forbidden -> -1; a window of colors exactly filling it."""
    w = 32
    nc = np.tile(np.arange(w, dtype=np.int32), (3, 1))
    base = np.zeros(3, np.int32)
    extra = np.zeros((3, w), bool)
    extra[1, :] = True
    nc[2, 5] = -1                      # slot 5 free again in row 2
    want = _mex_ref(_j(nc), _j(base), _j(extra), w)
    got = mex_window_plain(_t(nc), _t(base), _t(extra), w)
    _eq(got, want)
    assert got.tolist() == [-1, -1, 5]


@pytest.mark.parametrize("r,k", [(1, 1), (16, 8), (100, 33), (300, 128)])
def test_conflict_plain_matches_ref(r, k):
    rng = np.random.default_rng(r + k)
    nc = rng.integers(-2, 30, size=(r, k)).astype(np.int32)
    npr = rng.integers(-1, 100, size=(r, k)).astype(np.int32)
    nid = rng.integers(0, r + 1, size=(r, k)).astype(np.int32)
    cu = rng.integers(-2, 30, size=(r,)).astype(np.int32)
    pu = rng.integers(0, 100, size=(r,)).astype(np.int32)
    ids = np.arange(r, dtype=np.int32)
    args = (nc, npr, nid, cu, pu, ids)
    _eq(conflict_plain(*map(_t, args)), _conflict_ref(*map(_j, args)))


@pytest.mark.parametrize("n", [1, 5, 256, 1000, 4096])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_compact_plain_matches_ref(n, density):
    mask = np.random.default_rng(n).random(n) < density
    want_i, want_c = _compact_ref(_j(mask))
    got_i, got_c = ops.compact(_t(mask))
    _eq(got_i, want_i)
    assert int(got_c) == int(want_c)
    assert got_i.dtype == torch.int32 and got_c.dtype == torch.int32


@pytest.mark.parametrize("n", [1, 255, 257, 300, 2049, 5000])
def test_compact_ragged_lengths(n):
    """Lengths that are not a multiple of the CUDA kernel's tile (2048)."""
    mask = np.random.default_rng(n).random(n) < 0.5
    want_i, want_c = _compact_ref(_j(mask))
    got_i, got_c = ops.compact(_t(mask))
    _eq(got_i, want_i)
    assert int(got_c) == int(want_c)


@pytest.mark.parametrize("capacity", [1, 40, 99, 100, 108])
@pytest.mark.parametrize("with_values", [False, True])
def test_compact_capacity_and_values(capacity, with_values):
    """Fixed capacity (truncating or sentinel-padded) and emitted values:
    the contract of ``worklist.compact_mask`` / ``compact_items`` in the
    reference (``jnp.nonzero(size=...)``)."""
    rng = np.random.default_rng(capacity)
    n = 100
    mask = rng.random(n) < 0.6
    values = rng.integers(0, 1000, size=n).astype(np.int32)
    (pos,) = np.nonzero(mask)
    src = values if with_values else np.arange(n, dtype=np.int32)
    want = np.full(capacity, 7777, np.int32)
    take = min(capacity, len(pos))
    want[:take] = src[pos[:take]]
    got_i, got_c = compact_plain(_t(mask), capacity, 7777,
                                 _t(values) if with_values else None)
    _eq(got_i, want)
    assert int(got_c) == int(mask.sum())


def test_compact_plain_matches_pallas_interpret():
    mask = np.random.default_rng(3).random(700) < 0.3
    want_i, want_c = compact_pallas(_j(mask), interpret=True)
    got_i, got_c = ops.compact(_t(mask))
    _eq(got_i, want_i)
    assert int(got_c) == int(want_c)


def test_mex_and_conflict_plain_match_pallas_interpret():
    rng = np.random.default_rng(11)
    nc, base, extra = _mex_case(rng, 40, 24, 128)
    want = mex_window_pallas(_j(nc), _j(base), _j(extra), 128,
                             interpret=True)
    _eq(mex_window_plain(_t(nc), _t(base), _t(extra), 128), want)
    npr = rng.integers(-1, 100, size=(40, 24)).astype(np.int32)
    nid = rng.integers(0, 41, size=(40, 24)).astype(np.int32)
    cu = rng.integers(-2, 300, size=(40,)).astype(np.int32)
    pu = rng.integers(0, 100, size=(40,)).astype(np.int32)
    ids = np.arange(40, dtype=np.int32)
    args = (nc, npr, nid, cu, pu, ids)
    _eq(conflict_plain(*map(_t, args)),
        conflict_pallas(*map(_j, args), interpret=True))


def _fused_case(rng, r, k, w, *, hub=False, sparse=False):
    """Operands in the shape the step functions feed the fused kernel:
    dense style (ids = iota) or sparse style (sentinel ids on invalid
    rows, active = valid)."""
    n = r
    nc = rng.integers(-2, 40, size=(r, k)).astype(np.int32)
    npr = rng.integers(-1, 100, size=(r, k)).astype(np.int32)
    nid = rng.integers(0, n + 1, size=(r, k)).astype(np.int32)
    base = (rng.integers(0, 3, size=(r,)) * w).astype(np.int32)
    cu = rng.integers(-2, 40, size=(r,)).astype(np.int32)
    pu = rng.integers(0, 100, size=(r,)).astype(np.int32)
    if sparse:
        valid = rng.random(r) < 0.7
        ids = np.where(valid, rng.integers(0, n, size=(r,)), n)
        active = valid
    else:
        ids = np.arange(r)
        active = rng.random(r) < 0.85
    ids = ids.astype(np.int32)
    pending = active & (cu >= 0)
    extra = (rng.random((r, w)) < 0.2) if hub else None
    hl = ((rng.random(r) < 0.15) & active) if hub else None
    return (nc, npr, nid, base, cu, pu, ids, active, pending, extra, hl), n


def _assert_fused_parity(case, n, *, capacity, w=64, pallas=False):
    want = _fused_ref(*map(_j, case), window=w, capacity=capacity,
                      n_sentinel=n)
    got = fused_compact_plain(*map(_t, case), w, capacity=capacity,
                              n_sentinel=n)
    for g, x, name in zip(got, want,
                          ("new_c", "new_base", "still", "items", "count")):
        _eq(g, x, name)
    if pallas:
        pal = fused_compact_pallas(*map(_j, case), w, capacity=capacity,
                                   n_sentinel=n, interpret=True)
        for g, x, name in zip(got, pal,
                              ("new_c", "new_base", "still", "items",
                               "count")):
            _eq(g, x, name)


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("r,k", [(1, 1), (7, 8), (100, 40), (257, 128)])
def test_fused_compact_plain_matches_ref_dense(r, k, hub):
    case, n = _fused_case(np.random.default_rng(r * 31 + k + hub), r, k, 64,
                          hub=hub)
    _assert_fused_parity(case, n, capacity=r)


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("w", [32, 128, 256])
def test_fused_compact_plain_matches_ref_sparse(hub, w):
    """Sparse-style operands: sentinel ids on invalid rows never emit."""
    case, n = _fused_case(np.random.default_rng(77 + hub + w), 90, 16, w,
                          hub=hub, sparse=True)
    _assert_fused_parity(case, n, capacity=90, w=w)


def test_fused_compact_truncating_capacity():
    """count may exceed capacity: the first ``capacity`` survivors in
    ascending order, and the full popcount."""
    case, n = _fused_case(np.random.default_rng(5), 96, 8, 64)
    _assert_fused_parity(case, n, capacity=40)


@pytest.mark.parametrize("hub", [False, True])
def test_fused_compact_plain_matches_pallas_interpret(hub):
    case, n = _fused_case(np.random.default_rng(9 + hub), 70, 12, 64,
                          hub=hub)
    _assert_fused_parity(case, n, capacity=70, pallas=True)


@pytest.mark.parametrize("state", ["empty", "all"])
def test_fused_compact_empty_and_full_survivors(state):
    """No row survives (nothing active or pending) / every row survives
    (all active and uncolored)."""
    rng = np.random.default_rng(4)
    case, n = _fused_case(rng, 50, 8, 64)
    case = list(case)
    if state == "empty":
        case[7] = np.zeros(50, bool)           # active
        case[8] = np.zeros(50, bool)           # pending
    else:
        case[4] = np.full(50, -1, np.int32)    # cu: all uncolored
        case[7] = np.ones(50, bool)
        case[8] = np.zeros(50, bool)
    _assert_fused_parity(tuple(case), n, capacity=50)


def test_ops_dispatch_rejects_other_devices():
    t = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.mex_window(t[0], t, None, t[0], t[0].bool(), None, None, 32)
