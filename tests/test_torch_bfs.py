"""The port's hybrid BFS against ``repro.core.bfs``: levels, level count
and direction trace on three registry graphs x the three modes, plus the
host oracle; the direction switch; the device rule; and that the BFS
module keeps JAX out of the process."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.bfs import bfs as j_bfs
from repro.graphs import get_dataset as jget
from repro_torch.core import bfs as tbfs
from repro_torch.graphs import get_dataset as tget

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

GRAPHS = ["europe_osm_s", "kron_g500-logn21_s", "hollywood-2009_s"]
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _graphs(name, scale=0.02):
    kw = dict(scale=scale, layout="ell-tail", ell_cap=128)
    return jget(name, **kw), tget(name, **kw)


@pytest.mark.parametrize("mode", ["topdown", "bottomup", "hybrid"])
@pytest.mark.parametrize("name", GRAPHS)
def test_bfs_matches_reference(name, mode):
    jg, tg = _graphs(name)
    want = j_bfs(jg, 0, mode=mode)
    got = tbfs.bfs(tg, 0, mode=mode, device="cpu")
    assert got.dist.dtype == np.int32
    np.testing.assert_array_equal(got.dist, want.dist)
    assert (got.levels, got.mode_trace) == (want.levels, want.mode_trace)
    np.testing.assert_array_equal(got.dist, tbfs.bfs_reference(tg, 0))


@pytest.mark.parametrize("source", [3, 500])
def test_bfs_other_sources_and_h(source):
    jg, tg = _graphs("kron_g500-logn21_s", scale=0.25)
    want = j_bfs(jg, source, mode="hybrid", h=0.2)
    got = tbfs.bfs(tg, source, mode="hybrid", h=0.2, device="cpu")
    np.testing.assert_array_equal(got.dist, want.dist)
    assert (got.levels, got.mode_trace) == (want.levels, want.mode_trace)


def test_hybrid_uses_both_directions():
    # hollywood-like social graph: the frontier blows up -> bottom-up middle
    jg, tg = _graphs("hollywood-2009_s", scale=0.05)
    got = tbfs.bfs(tg, 0, mode="hybrid", h=0.05, device="cpu")
    assert "T" in got.mode_trace and "B" in got.mode_trace, got.mode_trace
    want = j_bfs(jg, 0, mode="hybrid", h=0.05)
    assert got.mode_trace == want.mode_trace
    np.testing.assert_array_equal(got.dist, tbfs.bfs_reference(tg, 0))


def test_bfs_device_rule_and_modes(monkeypatch):
    _, tg = _graphs("europe_osm_s", scale=0.01)
    with pytest.raises(ValueError, match="unknown BFS mode"):
        tbfs.bfs(tg, 0, mode="sideways", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbfs.bfs(tg, 0)


def test_resize_grows_by_recompacting():
    """A frontier truncated at a small capacity comes back whole when the
    bucket grows (BFS frontiers are not monotone)."""
    n = 40
    mask = torch.zeros(n, dtype=torch.bool)
    mask[[1, 5, 9, 30]] = True
    wl = tbfs.Worklist(mask=mask,
                       items=torch.tensor([1, 5], dtype=torch.int32),
                       count=torch.tensor(4, dtype=torch.int32))
    grown = tbfs._resize(wl, 8, n)
    assert grown.items.tolist() == [1, 5, 9, 30, n, n, n, n]
    assert tbfs._resize(grown, 2, n).items.tolist() == [1, 5]
    assert tbfs._resize(grown, 8, n) is grown


def test_bfs_module_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        from repro_torch.core.bfs import bfs
        from repro_torch.graphs import get_dataset
        g = get_dataset("kron_g500-logn21_s", scale=0.01,
                        layout="ell-tail", ell_cap=128)
        r = bfs(g, 0, device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LEAKED", bad, r.levels)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
