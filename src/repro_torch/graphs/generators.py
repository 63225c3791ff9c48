"""Synthetic graph generators mirroring the paper's Table I suite.

The paper evaluates on 10 UFL Sparse Matrix Collection graphs. The suite is
not redistributable inside this container, so we generate synthetic graphs
matching each original's *family* and degree statistics (regular FEM meshes,
road networks with median degree 2, RMAT/Kronecker power-law, social,
web-crawl hubs, random geometric), at a configurable scale factor. The
engines and benchmarks are agnostic to where the edge list came from — a
loader for real .mtx files is provided for deployments that have them.
"""
from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------------------
# Edge-list generators (numpy, deterministic via seed)
# ----------------------------------------------------------------------------

def edges_kring2d(side: int, radius: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Regular 2-D mesh, each node connected to its (2r+1)^2-1 ring — FEM-like
    regular graphs (Audikw_1 / Bump_2911 / Queen_4147 analogues)."""
    n = side * side
    ys, xs = np.divmod(np.arange(n), side)
    srcs, dsts = [], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            ny, nx = ys + dy, xs + dx
            ok = (ny >= 0) & (ny < side) & (nx >= 0) & (nx < side)
            srcs.append(np.arange(n)[ok])
            dsts.append((ny * side + nx)[ok])
    return np.concatenate(srcs), np.concatenate(dsts), n


def edges_road(n: int, seed: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Road-network analogue (europe_osm): long chains with sparse branches,
    median degree 2."""
    rng = np.random.default_rng(seed)
    # chain backbone
    src = np.arange(n - 1)
    dst = src + 1
    # random branch edges on ~4% of nodes connecting to a node within a window
    nb = max(n // 25, 1)
    bs = rng.integers(0, n, size=nb)
    bd = np.clip(bs + rng.integers(2, 50, size=nb), 0, n - 1)
    return np.concatenate([src, bs]), np.concatenate([dst, bd]), n


def edges_rmat(scale: int, edge_factor: int, seed: int,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """RMAT / Kronecker power-law graph (kron_g500 analogue)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    e = n * edge_factor
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(e)
        bit_s = (r >= a + b).astype(np.int64)          # lower half of rows
        r2 = rng.random(e)
        p_d = np.where(bit_s == 0, b / (a + b), 1 - (c / (1 - a - b)))
        bit_d = (r2 < p_d).astype(np.int64)            # right half of cols
        src = (src << 1) | bit_s
        dst = (dst << 1) | bit_d
    # permute labels so ids are not degree-correlated
    perm = rng.permutation(n)
    return perm[src], perm[dst], n


def edges_ba(n: int, m: int, seed: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Barabási–Albert preferential attachment (social-network analogue:
    hollywood-2009 with large m, soc-LiveJournal1 with small m)."""
    rng = np.random.default_rng(seed)
    # vectorised BA: repeated-endpoint trick. targets chosen from the edge
    # endpoint pool (degree-proportional) built incrementally in blocks.
    src = np.zeros((n - m) * m, dtype=np.int64)
    dst = np.zeros((n - m) * m, dtype=np.int64)
    pool = list(range(m))  # seed clique endpoints
    pool = np.array(pool, dtype=np.int64)
    e = 0
    block = 4096
    for start in range(m, n, block):
        stop = min(start + block, n)
        for v in range(start, stop):
            targets = pool[rng.integers(0, len(pool), size=m)]
            src[e : e + m] = v
            dst[e : e + m] = targets
            e += m
        # rebuild pool with the block's endpoints appended (approximate BA —
        # within-block degree feedback is delayed by <= block nodes)
        pool = np.concatenate([pool, src[max(0, e - (stop - start) * m) : e],
                               dst[max(0, e - (stop - start) * m) : e]])
        if len(pool) > 4 * n * m:
            pool = pool[rng.integers(0, len(pool), size=2 * n * m)]
    return src[:e], dst[:e], n


def edges_rgg(n: int, avg_deg: float, seed: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Random geometric graph on the unit square (rgg_n_2_24 analogue)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    r = np.sqrt(avg_deg / (np.pi * n))
    # grid binning
    g = max(int(1.0 / r), 1)
    cell = (pts[:, 0] * g).astype(np.int64) * g + (pts[:, 1] * g).astype(np.int64)
    order = np.argsort(cell)
    pts_s, cell_s = pts[order], cell[order]
    starts = np.searchsorted(cell_s, np.arange(g * g))
    ends = np.searchsorted(cell_s, np.arange(g * g), side="right")
    srcs, dsts = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nc = cell_s + dy * g + dx
            ok = (nc >= 0) & (nc < g * g)
            # pairwise within cell-pair via block expansion is expensive in
            # pure numpy for large n; sample-based approximation: compare each
            # point against up to 16 points of the neighbour cell.
            cand_start = starts[np.clip(nc, 0, g * g - 1)]
            cand_len = np.minimum(ends[np.clip(nc, 0, g * g - 1)] - cand_start, 16)
            for k in range(16):
                idx = cand_start + k
                valid = ok & (k < cand_len)
                i = np.nonzero(valid)[0]
                j = idx[valid]
                d2 = ((pts_s[i] - pts_s[j]) ** 2).sum(1)
                keep = (d2 < r * r) & (i != j)
                srcs.append(i[keep])
                dsts.append(j[keep])
    # edges are in sorted-label space; that is just a relabelled RGG, keep it.
    return np.concatenate(srcs), np.concatenate(dsts), n


def edges_hub(n: int, n_hubs: int, hub_frac: float, seed: int
              ) -> tuple[np.ndarray, np.ndarray, int]:
    """Circuit-like: sparse chain + a few mega-hubs touching hub_frac of all
    nodes (circuit5M analogue, delta_max >> delta_median)."""
    rng = np.random.default_rng(seed)
    src = np.arange(n - 1)
    dst = src + 1
    hs, hd = [], []
    for h in range(n_hubs):
        k = int(n * hub_frac)
        hs.append(np.full(k, n - 1 - h))
        hd.append(rng.integers(0, n - n_hubs, size=k))
    extra_s = rng.integers(0, n, size=n)  # light random sprinkle, deg ~ +2
    extra_d = rng.integers(0, n, size=n)
    return (np.concatenate([src, extra_s] + hs),
            np.concatenate([dst, extra_d] + hd), n)


def edges_web(n: int, seed: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Web-crawl analogue (indochina-2004): power-law with locality."""
    rng = np.random.default_rng(seed)
    e = n * 6
    src = rng.integers(0, n, size=e)
    # zipf-ish targets with locality: half local window, half power-law
    local = np.clip(src + rng.integers(-100, 100, size=e), 0, n - 1)
    zipf = (n * rng.power(0.3, size=e)).astype(np.int64) % n
    pick = rng.random(e) < 0.5
    dst = np.where(pick, local, zipf)
    return src, dst, n


# ----------------------------------------------------------------------------
# Suite (Table I analogues). ``scale`` multiplies node counts; scale=1.0 is
# the default CPU-friendly size (~50k-500k nodes); the real suite's relative
# size ordering and degree shapes are preserved.
# ----------------------------------------------------------------------------

SUITE_SPECS = {
    # name:               (family,  kwargs at scale=1)
    "circuit5M_s":        ("hub",   dict(n=120_000, n_hubs=3, hub_frac=0.10)),
    "Audikw_1_s":         ("kring", dict(side=180, radius=4)),     # deg ~ 80
    "Bump_2911_s":        ("kring", dict(side=260, radius=3)),     # deg ~ 48
    "Queen_4147_s":       ("kring", dict(side=300, radius=4)),     # deg ~ 80
    "kron_g500-logn21_s": ("rmat",  dict(scale=16, edge_factor=16)),
    "indochina-2004_s":   ("web",   dict(n=200_000)),
    "hollywood-2009_s":   ("ba",    dict(n=60_000, m=14)),
    "rgg_n_2_24_s0_s":    ("rgg",   dict(n=150_000, avg_deg=16)),
    "soc-LiveJournal1_s": ("ba",    dict(n=120_000, m=3)),
    "europe_osm_s":       ("road",  dict(n=400_000)),
}

_FAMILY = {
    "kring": lambda seed, side, radius: edges_kring2d(side, radius),
    "road": lambda seed, n: edges_road(n, seed),
    "rmat": lambda seed, scale, edge_factor: edges_rmat(scale, edge_factor, seed),
    "ba": lambda seed, n, m: edges_ba(n, m, seed),
    "rgg": lambda seed, n, avg_deg: edges_rgg(n, avg_deg, seed),
    "hub": lambda seed, n, n_hubs, hub_frac: edges_hub(n, n_hubs, hub_frac, seed),
    "web": lambda seed, n: edges_web(n, seed),
}


def _scaled(kwargs: dict, scale: float) -> dict:
    out = dict(kwargs)
    for key in ("n",):
        if key in out:
            out[key] = max(int(out[key] * scale), 64)
    if "side" in out:
        out["side"] = max(int(out["side"] * scale ** 0.5), 8)
    if "scale" in out:  # rmat log2 nodes
        import math
        out["scale"] = max(out["scale"] + int(round(math.log2(max(scale, 1e-9)))), 6)
    return out


def make_graph(name: str, *, scale: float = 1.0, seed: int = 0,
               ell_cap: int = 128, layout="ell-tail",
               reorder: str = "identity"):
    """A suite graph (``SUITE_SPECS``) built through the staged pipeline,
    uncached (``registry.get_dataset`` is the cached entry point)."""
    from repro_torch.graphs.csr import build_graph
    family, kwargs = SUITE_SPECS[name]
    src, dst, n = _FAMILY[family](seed, **_scaled(kwargs, scale))
    return build_graph(src, dst, n, name=name, ell_cap=ell_cap,
                       layout=layout, reorder=reorder, seed=seed)


def make_suite(*, scale: float = 1.0, seed: int = 0, ell_cap: int = 128,
               names: "list[str] | None" = None, layout="ell-tail",
               reorder: str = "identity") -> dict:
    """``make_graph`` of each of ``names`` (default: the whole suite)."""
    names = names or list(SUITE_SPECS)
    return {n: make_graph(n, scale=scale, seed=seed, ell_cap=ell_cap,
                          layout=layout, reorder=reorder) for n in names}


def load_mtx(path: str, *, name: "str | None" = None, ell_cap: int = 128,
             layout="ell-tail", reorder: str = "identity"):
    """A MatrixMarket graph file through the pipeline: ``ingest.from_mtx``
    parses it (and checks its header), ``build_graph`` does the rest."""
    from repro_torch.graphs.csr import build_graph
    from repro_torch.graphs.ingest import from_mtx
    e = from_mtx(path, name=name)
    return build_graph(e.src, e.dst, e.n_nodes, name=e.name,
                       ell_cap=ell_cap, layout=layout, reorder=reorder)
