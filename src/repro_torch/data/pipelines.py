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
the requested device. ``RecsysPipeline`` waits for the DLRM model
(ROADMAP Queue A item 11).
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


def uniform(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) from the top
    23 bits of each word."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


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
        dev = resolve_device(device)
        out = {}
        for k, v in self._host_batch(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            # from pinned memory the copy to the card does not wait for
            # the work queued before it
            out[k] = (t.pin_memory().to(dev, non_blocking=True)
                      if dev.type == "cuda" else t)
        return out

    def host_slice(self, step: int, host_id: int, n_hosts: int,
                   device=None) -> dict:
        b = self.batch_at(step, device)
        per = self.global_batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in b.items()}
