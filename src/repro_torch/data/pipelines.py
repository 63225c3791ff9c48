"""Data pipelines (``repro/data/pipelines.py``).

Deterministic: the batch at step s is a pure function of (seed, s), so a
restarted job regenerates exactly the stream it would have seen — the
checkpoint only stores the step counter. Each host can generate only its
slice (``host_slice``).

The tokens equal the reference's bit for bit: ``threefry2x32`` below is
JAX's counter-based generator in numpy (``jax.random.PRNGKey``,
``fold_in`` and ``uniform`` with the ``threefry2x32`` implementation and
``jax_threefry_partitionable`` on, JAX's default), and the float32
arithmetic follows the reference's (``u ** 3`` is ``u * (u * u)``, as
JAX lowers an integer power). The batch is made on the host and moved to
the requested device.

The other draws of ``jax.random`` the GNN and DLRM substrate makes are
here too: ``split`` and ``randint`` (bit for bit; ``randint_from_words``
is its span reduction on tensors, so a caller can draw the words on the
host and reduce them on the device where the bounds live), ``bernoulli``
(``uniform < p``, exact) and ``normal`` (``sqrt(2) erfinv(u)``: XLA's
float32 ``erfinv`` is not torch's, so it agrees to a few float32 ulps,
``NORMAL_TOL``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    two-word ``key``; uint32 arrays, wrapping arithmetic."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: (0, the seed's low 32 bits)."""
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the key hashed with ``prng_key(data)``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data & 0xFFFFFFFF], np.uint32))
    return np.concatenate([y0, y1])


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32-bit words as ``jax.random.bits`` makes them with
    ``jax_threefry_partitionable``: the two output words of each element's
    64-bit row-major index, XORed."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key: np.ndarray, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits of each word as a float32 in [0, 1), scaled into
    [minval, maxval) in float32 and clipped below at ``minval``."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` with ``jax_threefry_partitionable``:
    key i is the two words threefry gives the counter (0, i); (num, 2)."""
    y0, y1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def randint_from_words(higher: torch.Tensor, lower: torch.Tensor,
                       minval, maxval) -> torch.Tensor:
    """``jax.random.randint``'s reduction of two 32-bit words a draw into
    [minval, maxval) (int32 tensors or ints, broadcast against the words):
    a span of 1 where ``maxval <= minval``, and the two words combined
    modulo the span as the reference's uint32 arithmetic does it. The
    words are int64 tensors holding uint32 values; each product and sum
    is taken in int64 and wrapped to 32 bits where uint32 would wrap."""
    mask = 0xFFFFFFFF
    minval = torch.as_tensor(minval, dtype=torch.int64, device=higher.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=higher.device)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & mask)
    # 2**32 % span as uint32 computes it: the square wraps (to 0 for a
    # span above 2**16)
    mult = ((65536 % span) ** 2 & mask) % span
    off = ((higher % span) * mult) & mask
    off = ((off + lower % span) & mask) % span
    return (minval + off).to(torch.int32)


def randint(key: np.ndarray, shape: tuple, minval, maxval) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32, bit
    for bit; ``maxval`` (and ``minval``) may be arrays broadcast to
    ``shape``."""
    k1, k2 = split(key)
    words = [torch.from_numpy(random_bits(k, shape).astype(np.int64))
             for k in (k1, k2)]
    return randint_from_words(*words, torch.as_tensor(np.asarray(minval)),
                              torch.as_tensor(np.asarray(maxval))).numpy()


def bernoulli(key: np.ndarray, p: float, shape: tuple) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in
    float32, bool."""
    return uniform(key, shape) < np.float32(p)


#: ``normal``'s distance from ``jax.random.normal`` (absolute, float32):
#: the two ``erfinv`` differ by a few ulps, most at the tails
NORMAL_TOL = 2e-5


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: ``sqrt(2) erfinv(u)``
    with ``u`` uniform in (nextafter(-1, 0), 1); within ``NORMAL_TOL``
    (torch's ``erfinv``, not XLA's)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = torch.from_numpy(uniform(key, shape, lo, 1.0))
    return (np.float32(np.sqrt(2)) * torch.special.erfinv(u)).numpy()


def _to_device(host: dict, dev: torch.device) -> dict:
    """numpy arrays -> tensors on ``dev`` (from pinned memory on a card,
    so the copy does not wait for the work queued before it)."""
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(dev, non_blocking=True)
                  if dev.type == "cuda" else t)
    return out


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _host_batch(self, step: int) -> dict:
        """The batch at ``step`` as int32 numpy arrays."""
        key = fold_in(prng_key(self.seed), step)
        # zipf-ish marginal so the loss curve resembles text, not uniform
        # noise
        u = uniform(key, (self.global_batch, self.seq_len + 1))
        u3 = u * (u * u)
        toks = (np.float32(self.vocab) * u3).astype(np.int32) % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch_at(self, step: int, device=None) -> dict:
        """The batch at ``step``: int32 tensors on ``device`` (None: the
        CUDA device)."""
        return _to_device(self._host_batch(step), resolve_device(device))

    def host_slice(self, step: int, host_id: int, n_hosts: int,
                   device=None) -> dict:
        b = self.batch_at(step, device)
        per = self.global_batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in b.items()}


@dataclasses.dataclass(frozen=True)
class RecsysPipeline:
    n_dense: int
    n_sparse: int
    vocab: int
    global_batch: int
    hot: int = 1
    seed: int = 0

    def _host_batch(self, step: int) -> dict:
        key = fold_in(prng_key(self.seed), step)
        k1, k2, k3 = split(key, 3)
        dense = normal(k1, (self.global_batch, self.n_dense))
        # power-law sparse ids (hot items dominate, like production
        # traffic); u ** 4 as JAX's integer_pow computes it
        u = uniform(k2, (self.global_batch, self.n_sparse, self.hot))
        uu = u * u
        sparse = (np.float32(self.vocab) * (uu * uu)).astype(np.int32) \
            % self.vocab
        labels = bernoulli(k3, 0.25, (self.global_batch,))
        return {"dense": dense, "sparse": sparse, "labels": labels}

    def batch_at(self, step: int, device=None) -> dict:
        """The batch at ``step`` on ``device`` (None: the CUDA device):
        ``dense`` float32 (B, n_dense), ``sparse`` int32 (B, n_sparse,
        hot), ``labels`` bool (B,). ``sparse`` and ``labels`` equal the
        reference's bit for bit, ``dense`` within ``NORMAL_TOL``; the
        batch is drawn on the host, so every device gets the same bits."""
        return _to_device(self._host_batch(step), resolve_device(device))
