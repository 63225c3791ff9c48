"""Edge-list ingestion — stage 1 of the staged graph pipeline (DESIGN.md §8).

Every graph enters the system as an ``EdgeList``: a named bag of directed
(src, dst) int64 pairs plus a node count. Sources:

  from_arrays     ad-hoc numpy edge lists
  from_generator  the synthetic Table-I suite (``generators.SUITE_SPECS``)
  from_mtx        MatrixMarket coordinate files (real UFL graphs)
  from_snap       SNAP-style whitespace edge lists (``#`` comments)

``normalize`` is the single canonicalisation point the rest of the
pipeline builds on: optional symmetrisation, self-loop removal, and
duplicate removal via lexsort + adjacent-pair comparison — an O(E log E)
dedup that never forms an ``s * n + d`` scalar key, so it cannot overflow
int64 for any node count (the old key-based dedup overflowed once
``n_nodes**2`` left the int64 range). The output is sorted by (src, dst),
bit-identical to the historical key-based ordering wherever that one was
correct.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Directed edge entries over ``n_nodes`` labeled [0, n_nodes)."""

    name: str
    n_nodes: int
    src: np.ndarray   # int64[E]
    dst: np.ndarray   # int64[E]

    @property
    def n_entries(self) -> int:
        return len(self.src)

    def degrees(self) -> np.ndarray:
        """Out-degree per node (== degree once normalized/symmetrized)."""
        return np.bincount(self.src, minlength=self.n_nodes).astype(np.int32)


def from_arrays(src, dst, n_nodes: int, *, name: str = "graph") -> EdgeList:
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if len(src) != len(dst):
        raise ValueError(f"src/dst length mismatch: {len(src)} vs {len(dst)}")
    return EdgeList(name=name, n_nodes=int(n_nodes), src=src, dst=dst)


def from_generator(name: str, *, scale: float = 1.0, seed: int = 0
                   ) -> EdgeList:
    """Synthetic Table-I suite entry (``generators.SUITE_SPECS``)."""
    # lazy: generators imports this module's sibling ``csr`` at import time
    from repro_torch.graphs.generators import SUITE_SPECS, _FAMILY, _scaled
    family, kwargs = SUITE_SPECS[name]
    src, dst, n = _FAMILY[family](seed, **_scaled(kwargs, scale))
    return from_arrays(src, dst, n, name=name)


def from_mtx(path: str, *, name: str | None = None) -> EdgeList:
    """MatrixMarket coordinate file -> EdgeList (1-based -> 0-based).

    Only the (row, col) structure is read; weights, if present, are
    ignored. Raises ``ValueError`` on a malformed header (anything not
    starting with ``%%MatrixMarket matrix coordinate``).
    """
    with open(path) as f:
        header = f.readline()
        fields = header.strip().lower().split()
        if fields[:3] != ["%%matrixmarket", "matrix", "coordinate"]:
            raise ValueError(
                f"{path}: malformed MatrixMarket header {header.strip()!r} "
                "(expected '%%MatrixMarket matrix coordinate ...')")
        while True:
            pos = f.tell()
            line = f.readline()
            if not line.startswith("%"):
                f.seek(pos)
                break
        size_fields = f.readline().split()
        if len(size_fields) < 3:
            raise ValueError(f"{path}: malformed size line "
                             f"{' '.join(size_fields)!r}")
        rows, cols, _ = (int(x) for x in size_fields[:3])
        data = np.loadtxt(f, usecols=(0, 1), dtype=np.int64, ndmin=2)
    n = max(rows, cols)
    return from_arrays(data[:, 0] - 1, data[:, 1] - 1, n, name=name or path)


def from_snap(path: str, *, n_nodes: int | None = None,
              name: str | None = None) -> EdgeList:
    """SNAP-style edge list: one ``u v`` pair per line, ``#`` comments.

    Node ids are used as-is; ``n_nodes`` defaults to ``max(id) + 1``.
    """
    data = np.loadtxt(path, comments="#", usecols=(0, 1), dtype=np.int64,
                      ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 2), dtype=np.int64)
    n = n_nodes if n_nodes is not None else (
        int(data.max()) + 1 if data.size else 0)
    return from_arrays(data[:, 0], data[:, 1], n, name=name or path)


def normalize(edges: EdgeList, *, symmetrize: bool = True) -> EdgeList:
    """Canonical directed entry set: symmetrized (optional), self loops
    dropped, duplicates removed, sorted by (src, dst).

    Dedup is lexsort + adjacent-pair comparison — no flat ``s * n + d``
    key, so arbitrarily large node counts cannot overflow the sort key.
    """
    s, d = edges.src, edges.dst
    if symmetrize:
        s = np.concatenate([edges.src, edges.dst])
        d = np.concatenate([edges.dst, edges.src])
    keep = s != d                      # drop self loops
    s, d = s[keep], d[keep]
    order = np.lexsort((d, s))
    s, d = s[order], d[order]
    if len(s):
        first = np.empty(len(s), dtype=bool)
        first[0] = True
        np.not_equal(s[1:], s[:-1], out=first[1:])
        first[1:] |= d[1:] != d[:-1]
        s, d = s[first], d[first]
    return EdgeList(name=edges.name, n_nodes=edges.n_nodes, src=s, dst=d)
