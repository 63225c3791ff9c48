"""The reference's thin public helpers on the port, against ``repro`` on
the CPU: ``graphs.make_graph``, ``make_suite`` and ``load_mtx`` (arrays,
sizes and layout equal), ``degree_stats`` and ``validate_coloring`` (equal
dicts), ``core.policy.fixed_h``, ``always_dense`` and ``always_sparse``
(equal decisions and thresholds), and ``obs.metrics.default_registry``
(the same counter families). Graphs at scale 0.02."""
import dataclasses

import numpy as np
import pytest

from repro.core import policy as jpolicy
from repro.graphs import degree_stats as jdegree_stats
from repro.graphs import make_graph as jmake_graph
from repro.graphs import make_suite as jmake_suite
from repro.graphs import validate_coloring as jvalidate
from repro.graphs.generators import SUITE_SPECS
from repro.graphs.generators import load_mtx as jload_mtx
from repro.obs import default_registry as jdefault_registry
from repro_torch.core import policy as tpolicy
from repro_torch.graphs import (degree_stats, load_mtx, make_graph,
                                make_suite, validate_coloring)
from repro_torch.obs import default_registry

SCALE = 0.02


def _assert_same_graph(t, j):
    assert (t.name, t.n_nodes, t.n_edges, t.ell_width) == \
        (j.name, j.n_nodes, j.n_edges, j.ell_width)
    assert dataclasses.astuple(t.layout) == dataclasses.astuple(j.layout)
    for f in j.arrays._fields:
        a, b = getattr(j.arrays, f), getattr(t.arrays, f)
        if a is None:
            assert b is None, f
            continue
        b, a = np.asarray(b), np.asarray(a)
        assert b.dtype == a.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("name", list(SUITE_SPECS))
def test_make_graph_and_degree_stats_match(name):
    t = make_graph(name, scale=SCALE)
    j = jmake_graph(name, scale=SCALE)
    _assert_same_graph(t, j)
    assert degree_stats(t) == jdegree_stats(j)


@pytest.mark.parametrize("kw", [dict(layout="auto"),
                                dict(layout="hub-split", reorder="bfs-rcm"),
                                dict(ell_cap=16, seed=3)], ids=str)
def test_make_graph_options_match(kw):
    name = "kron_g500-logn21_s"
    t = make_graph(name, scale=SCALE, **kw)
    j = jmake_graph(name, scale=SCALE, **kw)
    _assert_same_graph(t, j)
    assert degree_stats(t) == jdegree_stats(j)


def test_make_suite_matches():
    names = ["europe_osm_s", "Audikw_1_s"]
    t = make_suite(scale=SCALE, names=names)
    j = jmake_suite(scale=SCALE, names=names)
    assert list(t) == list(j) == names
    for n in names:
        _assert_same_graph(t[n], j[n])


def _write_mtx(path, g) -> None:
    """``g``'s upper-triangle edges as a 1-based MatrixMarket pattern
    file, with a comment line."""
    deg = np.asarray(g.arrays.degrees)
    src = np.repeat(np.arange(g.n_nodes), deg)
    dst = np.asarray(g.arrays.col_idx)
    keep = src < dst
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern symmetric\n")
        f.write("% written by the parity test\n")
        f.write(f"{g.n_nodes} {g.n_nodes} {int(keep.sum())}\n")
        for a, b in zip(src[keep] + 1, dst[keep] + 1):
            f.write(f"{a} {b}\n")


@pytest.mark.parametrize("layout", ["ell-tail", "auto"])
def test_load_mtx_matches(tmp_path, layout):
    g = make_graph("hollywood-2009_s", scale=SCALE)
    path = tmp_path / "hollywood.mtx"
    _write_mtx(path, g)
    t = load_mtx(str(path), name="hw", layout=layout)
    j = jload_mtx(str(path), name="hw", layout=layout)
    _assert_same_graph(t, j)
    assert t.n_edges == g.n_edges
    assert degree_stats(t) == jdegree_stats(j)
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a matrix\n1 1 0\n")
    with pytest.raises(ValueError, match="MatrixMarket"):
        load_mtx(str(bad))


def _greedy(g) -> np.ndarray:
    """A sequential first-fit coloring on the host (a valid one)."""
    row = np.asarray(g.arrays.row_ptr)
    col = np.asarray(g.arrays.col_idx)
    colors = np.full(g.n_nodes, -1, np.int32)
    for v in range(g.n_nodes):
        used = set(colors[col[row[v]:row[v + 1]]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


@pytest.mark.parametrize("name", ["europe_osm_s", "Bump_2911_s"])
def test_validate_coloring_matches(name):
    g = make_graph(name, scale=SCALE)
    jg = jmake_graph(name, scale=SCALE)
    good = _greedy(g)
    broken = good.copy()
    broken[:50] = 0                         # conflicts
    broken[60:70] = -1                      # uncolored
    padded = np.concatenate([good, np.full(5, 99, np.int32)])
    for colors in (good, broken, padded, np.full(g.n_nodes, -1, np.int32)):
        assert validate_coloring(g, colors) == jvalidate(jg, colors)
    assert validate_coloring(g, good)["conflicts"] == 0
    assert validate_coloring(g, broken)["conflicts"] > 0


@pytest.mark.parametrize("make", ["fixed_h", "always_dense",
                                  "always_sparse"])
def test_policy_helpers_match(make):
    args = [(), (0.3,), (0.9,)] if make == "fixed_h" else [()]
    for a in args:
        t, j = getattr(tpolicy, make)(*a), getattr(jpolicy, make)(*a)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for n in (1, 7, 1000, 2**21):
            assert t.threshold(n) == j.threshold(n)
            assert tpolicy.device_threshold(t, n) == \
                jpolicy.device_threshold(j, n)
            for count in (0, 1, n // 3, int(0.6 * n), int(0.6 * n) + 1, n):
                assert t(count, n) == j(count, n), (make, a, count, n)


def test_default_registry_holds_the_reference_families():
    import repro.core.distributed  # noqa: F401  (registers its group)
    import repro_torch.core.distributed  # noqa: F401
    t, j = default_registry(), jdefault_registry()
    assert t is default_registry()
    assert set(j.names()) <= set(t.names())
    for name in j.names():
        assert type(t.get(name)).__name__ == type(j.get(name)).__name__
        assert sorted(t.get(name).as_dict()) == sorted(j.get(name).as_dict())
    from repro_torch.core import ipgc
    assert t.get("ipgc.launches") is ipgc.LAUNCH_COUNTS
    with ipgc.LAUNCH_COUNTS.scope():
        ipgc.LAUNCH_COUNTS["fused"] += 1
        assert t.as_dict()["ipgc.launches"]["fused"] == 1
