"""The benchmark's plain reference and generators against the port's CPU
path, on tiny Kronecker graphs and the port's own road-like graph: equal
colors and iterations."""
import numpy as np
import pytest
import torch

from bench import catalog

ROOT = catalog.ROOT
KRON = dict(scale=8, edgefactor=16, A=0.57, B=0.19, C=0.19)


def _mod(kind, name):
    return catalog.load_module(ROOT / "bench" / kind / f"{name}.py", kind)


@pytest.fixture(scope="module")
def ref():
    return _mod("reference", "ipgc")


@pytest.mark.parametrize("gen,params,build", [
    ("kronecker", KRON, dict(layout="ell-tail", ell_cap=128)),
    ("kronecker", KRON, dict(layout="ell-tail", ell_cap=8)),
    ("road", 3000, dict(layout="pure-ell", ell_cap=None)),
])
@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_reference_equals_port(ref, gen, params, build, seed):
    from repro_torch.exec import Session, spec_for
    from repro_torch.graphs.csr import build_graph

    if gen == "road":
        from repro_torch.graphs.generators import edges_road
        s, d, n = (torch.from_numpy(a) if not isinstance(a, int) else a
                   for a in edges_road(params, seed))
    else:
        s, d, n = _mod("generators", gen).generate(params, seed, "cpu")
    g = build_graph(s.numpy(), d.numpy(), n, **build)
    got = Session("cpu").run(spec_for(), g)
    ns, nd = ref.normalize(s, d, n)
    want = ref.ipgc(ns, nd, n)
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.colors, want.colors.numpy())
    assert ref.conflicts(ns, nd, want.colors) == 0
    assert int((want.colors < 0).sum()) == 0
    assert want.bytes_needed > 0


def test_normalize_equals_ingest(ref):
    from repro_torch.graphs import ingest

    s, d, n = _mod("generators", "kronecker").generate(KRON, 11, "cpu")
    ns, nd = ref.normalize(s, d, n)
    e = ingest.normalize(ingest.from_arrays(s.numpy(), d.numpy(), n))
    np.testing.assert_array_equal(ns.numpy(), e.src)
    np.testing.assert_array_equal(nd.numpy(), e.dst)


def test_priorities_and_window(ref):
    from repro_torch.core.engine import adaptive_window
    from repro_torch.graphs.csr import _splitmix32, build_graph

    ids = np.arange(70_000)
    np.testing.assert_array_equal(ref.priorities(70_000, "cpu").numpy(),
                                  _splitmix32(ids).astype(np.int64))
    rng = np.random.default_rng(0)
    for n, hi in [(9, 3), (10, 5), (400, 40), (1000, 200)]:
        deg = rng.integers(0, hi, size=n)
        src = np.repeat(np.arange(n), deg)
        dst = (src + 1 + rng.integers(0, n - 1, size=src.size)) % n
        g = build_graph(src, dst, n)
        want = adaptive_window(g)
        got = ref.color_window(torch.from_numpy(
            np.asarray(g.arrays.degrees, dtype=np.int64)))
        assert got == want


def test_generators_are_seeded():
    gen = _mod("generators", "kronecker")
    a = gen.generate(KRON, 5, "cpu")
    b = gen.generate(KRON, 5, "cpu")
    c = gen.generate(KRON, 6, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[2] == b[2] == 1 << KRON["scale"]
    assert a[0].numel() == KRON["edgefactor"] << KRON["scale"]
    assert int(a[0].min()) >= 0 and int(a[0].max()) < a[2]
