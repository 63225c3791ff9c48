"""Operands of the gathering kernels (``mex_window``, ``conflict``,
``fused_compact``, ``fused_step``, ``jpl_extrema``) made with numpy from a
seed, and the pre-gathered tiles of the Pallas signature they stand for.
Imports neither JAX nor torch, so the card's tests (``test_torch_cuda.py``)
use it too."""
import numpy as np

#: colors[N] and priority[N], the pad id's slots (``graphs/csr.py``)
PAD_COLOR = -2
PAD_PRIORITY = -1


def gather_case(seed: int, rg: int, k: int, *, sparse: bool, hub: bool,
                window: int = 32, lo: int = 0) -> dict:
    """A left-packed (rg, k) ELL tile over n = lo + rg + k + 7 nodes (pad n)
    whose rows are empty, short (1..k-1 entries) or full (k entries: a hub
    whose other neighbours ride the tail under ell-tail), the colors and
    priority vectors (slot n: PAD_COLOR, -1), and per-row operands in the
    shape the steps hand the kernels: ``rows`` None (rows 0..rg-1) or R
    graph rows with sentinels >= rg; ids are the global ids ``lo + row``
    (pad n), as the distributed steps give them."""
    rng = np.random.default_rng(seed)
    n = lo + rg + k + 7
    kind = rng.integers(0, 3, size=rg)
    lengths = np.where(kind == 0, 0, np.where(kind == 1,
                                              rng.integers(1, max(k, 2),
                                                           size=rg), k))
    lengths = np.minimum(lengths, k)
    ell = np.full((rg, k), n, np.int32)
    for r, d in enumerate(lengths):
        ell[r, :d] = np.sort(rng.choice(n, size=d, replace=False))
    colors = rng.integers(-1, 12, size=n + 1).astype(np.int32)
    colors[n] = PAD_COLOR
    priority = rng.integers(0, 40, size=n + 1).astype(np.int32)
    priority[n] = PAD_PRIORITY
    if sparse:
        r_len = max(rg, 1) + 5
        rows = np.where(rng.random(r_len) < 0.75,
                        rng.integers(0, max(rg, 1), size=r_len),
                        rg + rng.integers(0, 3, size=r_len)).astype(np.int32)
        if rg == 0:
            rows[:] = rg
    else:
        r_len, rows = rg, None
    local = np.arange(rg) if rows is None else rows
    ok = local < rg
    ids = np.where(ok, lo + local, n).astype(np.int32)
    cu = np.where(rng.random(r_len) < 0.7, colors[ids],
                  rng.integers(-1, 12, size=r_len)).astype(np.int32)
    cu = np.where(ok, cu, PAD_COLOR).astype(np.int32)
    active = (rng.random(r_len) < 0.8) & ok
    c = dict(n=n, rg=rg, k=k, window=window, ell=ell, colors=colors,
             priority=priority, rows=rows, ids=ids, cu=cu,
             pu=priority[ids], newly=rng.random(r_len) < 0.7,
             base=(rng.integers(0, 3, size=r_len) * window).astype(np.int32),
             active=active, pending=active & (cu >= 0),
             hub_forb=None, hub_lose=None, hub_slot=None)
    if hub:
        hubs = np.flatnonzero(lengths == k)
        n_hub = len(hubs)
        slot = np.full(rg, n_hub, np.int32)
        slot[hubs] = np.arange(n_hub, dtype=np.int32)
        forb = rng.random((n_hub + 1, window)) < 0.3
        forb[::3] = True                # exhausted windows
        forb[n_hub] = False            # the non-hub rows' all-false row
        lose = rng.random(n_hub + 1) < 0.3
        lose[n_hub] = False
        c.update(hub_forb=forb, hub_lose=lose, hub_slot=slot)
    return c


def gathered(c) -> dict:
    """The pre-gathered (R, K) tiles and (R, W) hub rows of the Pallas
    signature, in numpy."""
    local = np.arange(c["rg"]) if c["rows"] is None else c["rows"]
    ok = local < c["rg"]
    safe = np.where(ok, local, 0)
    nbr = (np.where(ok[:, None], c["ell"][safe], c["n"]) if c["rg"]
           else np.full((len(local), c["k"]), c["n"], np.int32))
    out = dict(nbr=nbr.astype(np.int32), nc=c["colors"][nbr],
               npr=c["priority"][nbr], ok=ok, extra=None, hl=None)
    if c["hub_forb"] is not None:
        n_hub = c["hub_forb"].shape[0] - 1
        slot = np.where(ok, c["hub_slot"][safe] if c["rg"] else n_hub,
                        n_hub)
        out.update(extra=c["hub_forb"][slot], hl=c["hub_lose"][slot])
    return out


def jpl_prio_table(c, seed: int) -> np.ndarray:
    """A JPL round's int32[n+1] priority table for case ``c``: ~30% of the
    nodes not pending (-1), the others hashed-size values; slot n (the pad
    id's) -1."""
    rng = np.random.default_rng(seed)
    prio = rng.integers(0, 2**31 - 1, size=c["n"] + 1).astype(np.int32)
    prio = np.where(rng.random(c["n"] + 1) < 0.3, -1, prio).astype(np.int32)
    prio[c["n"]] = -1
    return prio
