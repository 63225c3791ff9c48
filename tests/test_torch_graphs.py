"""The port's graph pipeline and ``prepare`` against ``repro``'s, on the ten
registry graphs at small scale and all four layout kinds; the
``from_numpy`` hand-off; and the port's independence from JAX."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import ipgc as jipgc
from repro.graphs import dataset_names
from repro.graphs import get_dataset as jget
from repro.graphs.layout import LAYOUT_KINDS
from repro_torch.core import ipgc as tipgc
from repro_torch.graphs import get_dataset as tget
from repro_torch.graphs.registry import dataset_names as tnames

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _host_arrays(ig) -> dict:
    """A prepared graph's array fields as numpy (either package)."""
    out = {}
    for f in dataclasses.fields(ig):
        v = getattr(ig, f.name)
        if v is not None and not isinstance(v, (int, str)):
            out[f.name] = np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                     else v)
    return out


def _assert_same_prepared(j, t):
    assert (t.n_nodes, t.ell_width, t.n_hub, t.layout_kind) == \
        (j.n_nodes, j.ell_width, j.n_hub, j.layout_kind)
    ja, ta = _host_arrays(j), _host_arrays(t)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_registry_names_match():
    assert tnames() == dataset_names()


@pytest.mark.parametrize("layout", LAYOUT_KINDS)
@pytest.mark.parametrize("name", dataset_names())
def test_prepared_arrays_match(name, layout):
    jg = jget(name, scale=0.02, layout=layout)
    tg = tget(name, scale=0.02, layout=layout)
    assert (tg.name, tg.n_nodes, tg.n_edges) == \
        (jg.name, jg.n_nodes, jg.n_edges)
    assert dataclasses.astuple(tg.layout) == dataclasses.astuple(jg.layout)
    for field in jg.arrays._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tg.arrays, field)),
                                      np.asarray(getattr(jg.arrays, field)),
                                      err_msg=field)
    jig = jipgc.prepare(jg)
    tig = tipgc.prepare(tg, device="cpu")
    _assert_same_prepared(jig, tig)
    # the hand-off from repro's prepared graph gives the same IPGCGraph
    handed = tipgc.from_numpy(_host_arrays(jig), layout_kind=jig.layout_kind,
                              device="cpu")
    _assert_same_prepared(jig, handed)


@pytest.mark.parametrize("kwargs", [
    dict(layout="ell-tail", ell_cap=128),
    dict(layout="auto", reorder="degree-sort"),
    dict(layout="hub-split", reorder="bfs-rcm", ell_cap=16),
    dict(layout="csr-segment", reorder="shuffle", seed=3),
])
def test_pipeline_options_match(kwargs):
    jg = jget("kron_g500-logn21_s", scale=0.02, **kwargs)
    tg = tget("kron_g500-logn21_s", scale=0.02, **kwargs)
    assert dataclasses.astuple(tg.layout) == dataclasses.astuple(jg.layout)
    for field in jg.arrays._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tg.arrays, field)),
                                      np.asarray(getattr(jg.arrays, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(tg.perm.new_of_old, jg.perm.new_of_old)
    _assert_same_prepared(jipgc.prepare(jg, priority="id"),
                          tipgc.prepare(tg, priority="id", device="cpu"))


def test_state_from_numpy_round_trip():
    rng = np.random.default_rng(0)
    colors = rng.integers(-2, 9, size=11).astype(np.int32)
    base = rng.integers(0, 3, size=10).astype(np.int32) * 32
    mask = rng.random(10) < 0.5
    items = np.where(mask, np.arange(10), 10).astype(np.int32)
    c, b, wl = tipgc.state_from_numpy(colors, base, mask, items,
                                      int(mask.sum()), "cpu")
    assert c.dtype == b.dtype == wl.items.dtype == wl.count.dtype == \
        torch.int32 and wl.mask.dtype == torch.bool
    np.testing.assert_array_equal(c.numpy(), colors)
    np.testing.assert_array_equal(wl.items.numpy(), items)
    assert int(wl.count) == mask.sum() and wl.capacity == 10


def _run_isolated(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_never_imports_jax():
    """``import repro_torch``, a CPU coloring and a CPU distributed
    coloring leave JAX (and the JAX package) out of ``sys.modules``."""
    out = _run_isolated("""
        import sys
        import repro_torch
        g = repro_torch.get_dataset("kron_g500-logn21_s", scale=0.01,
                                    layout="ell-tail", ell_cap=128)
        r = repro_torch.color(g, device="cpu", fused=True)
        repro_torch.verify_coloring(g, r.colors)
        r = repro_torch.color_distributed(g, devices=["cpu"] * 2)
        repro_torch.verify_coloring(g, r.colors)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LEAKED", bad)
    """)
    assert "LEAKED []" in out, out
