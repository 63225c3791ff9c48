"""The port's tile tuner (``repro_torch/kernels/tune.py``) against
``tests/test_tune.py``'s contract: the sweep → disk cache → in-process
memo lifecycle with a stubbed timer, corrupt and version-mismatched files
swept again, the ``resolve_tile_rows`` policy, ``tile_rows`` in the
session key, and colorings at every tile equal to ``repro.core.color`` at
the same tile, field for field."""
import json

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro.graphs import get_dataset as jget
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.graphs import get_dataset
from repro_torch.kernels import tune
from repro_torch.obs import trace as obs_trace

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the sweep graphs' scale in these tests (their workload at scale 1 is
#: the card's)
SMALL = 0.01


def sweep_graph(kind: str):
    """``kind``'s sweep graph at ``SMALL`` and its copies."""
    name, layout, copies = tune._SWEEP_GRAPHS[kind]
    return get_dataset(name, scale=SMALL, **layout), copies


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """Point the tuner at a fresh cache file and a clean memo."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    tune.clear_memo()
    yield path
    tune.clear_memo()


@pytest.fixture
def stub_timer(monkeypatch):
    """A small sweep workload and a timer that ranks the candidates by a
    fixed table (the CPU has no kernel to time); records its calls."""
    monkeypatch.setattr(tune, "_SWEEP_SCALE", SMALL)
    calls = []
    fake = {8: 30.0, 32: 10.0, 128: 20.0}

    def timer(case, tile_rows):
        calls.append((case["ell_idx"].shape, case["hub_forb"] is not None,
                      tile_rows))
        return fake[tile_rows]

    monkeypatch.setattr(tune, "_time_candidate", timer)
    return calls


def test_cache_path_env_override(tmp_cache):
    assert tune.cache_path() == str(tmp_cache)


def test_cache_path_default_is_the_build_directory(monkeypatch):
    monkeypatch.delenv(tune.CACHE_ENV, raising=False)
    from repro_torch.kernels._build import build_root
    assert tune.cache_path() == str(build_root() / "tune.json")


def test_tune_key_shape():
    assert tune.tune_key("cuda-sm90", "ell-tail") == "cuda-sm90/ell-tail/int32"
    assert tune.tune_key("cuda-sm90", "pure-ell", "int16") == \
        "cuda-sm90/pure-ell/int16"
    assert tune.backend_name(CPU) == "cpu"


def test_backend_name_of_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    assert tune.backend_name(torch.device("cuda", 0)) == "cuda-sm90"


def test_constants_are_the_references():
    from repro.kernels import tune as jtune
    assert (tune.CACHE_ENV, tune.CACHE_VERSION, tune.CANDIDATES,
            tune.ELL_KINDS) == (jtune.CACHE_ENV, jtune.CACHE_VERSION,
                                jtune.CANDIDATES, jtune.ELL_KINDS)


def test_sweep_non_ell_kind_is_none():
    cfg = tune.sweep("csr-segment", device="cpu")
    assert cfg.tile_rows is None and cfg.micros == {}


@pytest.mark.parametrize("kind,hub", [("pure-ell", False), ("ell-tail", True),
                                      ("hub-split", True)])
def test_sweep_times_every_candidate(kind, hub, stub_timer):
    cfg = tune.sweep(kind, device="cpu")
    assert cfg.micros == {"8": 30.0, "32": 10.0, "128": 20.0}
    assert cfg.tile_rows == 32          # the measured minimum
    assert [c[2] for c in stub_timer] == list(tune.CANDIDATES)
    g, copies = sweep_graph(kind)
    assert all(c[:2] == ((g.n_nodes * copies, g.ell_width), hub)
               for c in stub_timer)


def test_sweep_graphs_are_the_kinds():
    """Each kind sweeps over a registry graph laid out in that kind, at
    the widths the module names."""
    widths = {"pure-ell": 8, "ell-tail": 128, "hub-split": 72}
    for kind in tune.ELL_KINDS:
        name, layout, _ = tune._SWEEP_GRAPHS[kind]
        g = get_dataset(name, scale=tune._SWEEP_SCALE, **layout)
        assert g.layout.kind == kind and g.ell_width == widths[kind]


def test_sweep_case_is_left_packed_and_sized(monkeypatch):
    monkeypatch.setattr(tune, "_SWEEP_SCALE", SMALL)
    g, copies = sweep_graph("ell-tail")
    r = g.n_nodes * copies
    c = tune._sweep_case("ell-tail", CPU)
    ell = c["ell_idx"]
    assert ell.shape == (r, g.ell_width) and ell.is_contiguous()
    pad = ell == r
    # every row: real entries first, then only padding
    assert (pad[:, 1:] >= pad[:, :-1]).all()
    assert int(c["colors"][r]) == repro_torch.core.ipgc.PAD_COLOR
    nh = c["hub_forb"].shape[0] - 1
    assert not c["hub_forb"][nh].any() and not c["hub_lose"][nh]
    assert tune._sweep_case("pure-ell", CPU)["hub_forb"] is None


@pytest.mark.parametrize("kind", tune.ELL_KINDS)
def test_sweep_case_is_the_graph_repeated(kind, monkeypatch):
    monkeypatch.setattr(tune, "_SWEEP_SCALE", SMALL)
    g, copies = sweep_graph(kind)
    n, k = g.n_nodes, g.ell_width
    r = n * copies
    c = tune._sweep_case(kind, CPU)
    ell = c["ell_idx"]
    assert ell.shape == (r, k) and ell.is_contiguous()
    # copy j is the graph's tile with its ids moved by j * n, pad id R
    one = torch.from_numpy(np.asarray(g.arrays.ell_idx, dtype=np.int32))
    for j in (0, copies - 1):
        part = ell[j * n:(j + 1) * n]
        assert torch.equal(part == r, one == n)
        assert torch.equal(part[one != n], one[one != n] + j * n)
    assert int(c["colors"][r]) == repro_torch.core.ipgc.PAD_COLOR
    if kind == "pure-ell":
        assert c["hub_forb"] is None and c["hub_slot"] is None
        return
    hub = np.tile(np.asarray(g.arrays.degrees) > g.layout.hub_threshold,
                  copies)
    nh = c["hub_forb"].shape[0] - 1
    assert nh == hub.sum() > 0
    assert torch.equal(c["hub_slot"] < nh, torch.from_numpy(hub))
    assert torch.equal(c["hub_slot"][torch.from_numpy(hub)],
                       torch.arange(nh, dtype=torch.int32))
    assert not c["hub_forb"][nh].any() and not c["hub_lose"][nh]


def test_sweep_records_spans(stub_timer):
    with obs_trace.tracing(obs_trace.Trace()) as tr:
        tune.sweep("pure-ell", device="cpu")
    spans = [s for s in tr.walk() if s.name.startswith("tune.")]
    assert [s.name for s in spans] == ["tune.sweep"] + ["tune.candidate"] * 3
    assert [s.attrs["micros"] for s in spans[1:]] == [30.0, 10.0, 20.0]


def test_sweep_never_times_the_plain_version(monkeypatch):
    """Off the card the timer raises: the plain version is no yardstick
    of the kernel's tile, and a failed sweep is not swallowed."""
    monkeypatch.setattr(tune, "_SWEEP_SCALE", SMALL)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tune.sweep("pure-ell", device="cpu")


def test_get_tile_config_sweeps_once_and_persists(tmp_cache, monkeypatch):
    calls = []
    monkeypatch.setattr(
        tune, "sweep", lambda kind, **kw: calls.append(kind) or
        tune.TileConfig(128, {"8": 3.0, "32": 2.0, "128": 1.0}))
    cfg1 = tune.get_tile_config("ell-tail", device="cpu")
    cfg2 = tune.get_tile_config("ell-tail", device="cpu")     # memo hit
    assert calls == ["ell-tail"]
    assert cfg2 is cfg1
    with open(tmp_cache) as f:
        data = json.load(f)
    assert data["version"] == tune.CACHE_VERSION
    key = tune.tune_key("cpu", "ell-tail")
    assert data["entries"][key] == {"tile_rows": 128, "micros":
                                    {"8": 3.0, "32": 2.0, "128": 1.0}}
    # a fresh process (cleared memo) reads the disk entry, no re-sweep
    tune.clear_memo()
    cfg3 = tune.get_tile_config("ell-tail", device="cpu")
    assert calls == ["ell-tail"]
    assert cfg3 == cfg1


def test_get_tile_config_reads_the_references_file(tmp_cache, monkeypatch):
    """The file format is the reference's: an entry that
    ``repro.kernels.tune`` wrote is read back as it is."""
    from repro.kernels import tune as jtune
    monkeypatch.setattr(jtune, "sweep",
                        lambda kind, **kw: jtune.TileConfig(8, {"8": 1.5}))
    jtune.clear_memo()
    try:
        jtune.get_tile_config("pure-ell")         # JAX on the CPU: "cpu/..."
    finally:
        jtune.clear_memo()
    monkeypatch.setattr(tune, "sweep", lambda kind, **kw: pytest.fail(
        "swept despite a valid cache entry"))
    cfg = tune.get_tile_config("pure-ell", device="cpu")
    assert cfg == tune.TileConfig(8, {"8": 1.5})


def test_corrupt_cache_is_discarded_and_reswept(tmp_cache, monkeypatch):
    tmp_cache.write_text("{not json")
    monkeypatch.setattr(
        tune, "sweep", lambda kind, **kw: tune.TileConfig(8, {"8": 1.0}))
    assert tune.get_tile_config("pure-ell", device="cpu").tile_rows == 8
    with open(tmp_cache) as f:
        assert json.load(f)["version"] == tune.CACHE_VERSION


@pytest.mark.parametrize("bad", [
    {"version": 999, "entries": {"cpu/pure-ell/int32": {"tile_rows": 4}}},
    {"version": 1, "entries": {"cpu/pure-ell/int32": {"tile_rows": "x"}}},
    {"version": 1, "entries": {"cpu/pure-ell/int32": {"tile_rows": 0}}},
    {"version": 1, "entries": []},
    [1, 2],
])
def test_mismatched_or_bad_entries_are_reswept(tmp_cache, monkeypatch, bad):
    tmp_cache.write_text(json.dumps(bad))
    monkeypatch.setattr(
        tune, "sweep", lambda kind, **kw: tune.TileConfig(16, {"16": 1.0}))
    assert tune.get_tile_config("pure-ell", device="cpu").tile_rows == 16


def test_csr_segment_records_none(tmp_cache):
    cfg = tune.get_tile_config("csr-segment", device="cpu")
    assert cfg.tile_rows is None
    tune.clear_memo()                     # round-trips through the JSON null
    assert tune.get_tile_config("csr-segment", device="cpu").tile_rows is None
    with open(tmp_cache) as f:
        entry = json.load(f)["entries"]["cpu/csr-segment/int32"]
    assert entry == {"tile_rows": None, "micros": {}}


# ---------------------------------------------------------------------------
# resolve_tile_rows: the Session-facing policy
# ---------------------------------------------------------------------------

def test_resolve_explicit_int_always_wins(tmp_cache):
    for kind in ("pure-ell", "csr-segment"):
        for dev in ("cpu", "cuda"):
            assert tune.resolve_tile_rows(64, kind, dev) == 64


@pytest.mark.parametrize("spec_tile", ["auto", None])
@pytest.mark.parametrize("kind", tune.ELL_KINDS + ("csr-segment",))
def test_resolve_auto_on_the_cpu_is_none(tmp_cache, monkeypatch, spec_tile,
                                         kind):
    """The CPU runs the plain versions, which have no tile: auto must not
    consult the tuner or fragment the session caches."""
    monkeypatch.setattr(tune, "get_tile_config",
                        lambda *a, **k: pytest.fail("tuner consulted"))
    assert tune.resolve_tile_rows(spec_tile, kind, "cpu") is None


def test_resolve_auto_csr_on_cuda_is_none(tmp_cache, monkeypatch):
    monkeypatch.setattr(tune, "get_tile_config",
                        lambda *a, **k: pytest.fail("tuner consulted"))
    assert tune.resolve_tile_rows("auto", "csr-segment", "cuda") is None


def test_resolve_auto_on_cuda_consults_tuner(tmp_cache, monkeypatch):
    seen = []

    def cfg(kind, *, dtype="int32", device=None):
        seen.append((kind, torch.device(device).type))
        return tune.TileConfig(128, {"128": 1.0})

    monkeypatch.setattr(tune, "get_tile_config", cfg)
    assert tune.resolve_tile_rows("auto", "ell-tail", "cuda") == 128
    assert tune.resolve_tile_rows(None, "hub-split", "cuda:0") == 128
    assert seen == [("ell-tail", "cuda"), ("hub-split", "cuda")]


@pytest.mark.parametrize("bad", ["big", 1.5, True])
def test_resolve_rejects_other_values(bad):
    with pytest.raises(ValueError, match="tile_rows"):
        tune.resolve_tile_rows(bad, "ell-tail", "cpu")


def test_tile_rows_joins_the_static_key():
    a = ExecutionSpec(tile_rows=8)
    b = ExecutionSpec(tile_rows=32)
    assert ExecutionSpec().tile_rows == "auto"
    assert a.static_key() != b.static_key()
    assert a.static_key() == ExecutionSpec(tile_rows=8).static_key()
    assert 8 in a.static_key()


def test_session_resolves_once_per_run(monkeypatch):
    """The host and outlined regimes ask the policy once a run, with the
    layout kind and the session's device."""
    from repro_torch.exec import session as session_mod
    seen = []
    real = session_mod.resolve_tile_rows

    def spy(spec_tile, kind, device):
        seen.append((spec_tile, kind, torch.device(device).type))
        return real(spec_tile, kind, device)

    monkeypatch.setattr(session_mod, "resolve_tile_rows", spy)
    g = get_dataset("kron_g500-logn21_s", scale=0.01, layout="ell-tail",
                    ell_cap=128)
    s = Session("cpu")
    s.run(ExecutionSpec(regime="host", tile_rows=8), g)
    s.run(ExecutionSpec(regime="outlined"), g)
    assert seen == [(8, "ell-tail", "cpu"), ("auto", "ell-tail", "cpu")]


def test_ops_take_tile_rows_on_the_cpu():
    """On the CPU the wrappers run the plain versions, which have no tile:
    every tile gives the default's result."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    nc = torch.from_numpy(rng.integers(-2, 40, (50, 7)).astype(np.int32))
    base = torch.zeros(50, dtype=torch.int32)
    npr = torch.from_numpy(rng.integers(-1, 99, (50, 7)).astype(np.int32))
    for t in (None,) + tune.CANDIDATES:
        assert torch.equal(ops.mex_window(nc, base, None, 32, t),
                           ops.mex_window(nc, base, None, 32))
        assert all(torch.equal(a, b) for a, b in
                   zip(ops.jpl_extrema(npr, t), ops.jpl_extrema(npr)))


@pytest.mark.parametrize("bad", [0, -8, 2.0, True])
def test_launch_argument_rejects_bad_tiles(bad):
    from repro_torch.kernels import _build
    with pytest.raises(ValueError, match="tile_rows"):
        _build.tile_arg(bad, "mex_window")
    assert _build.tile_arg(None, "x") == 0 and _build.tile_arg(8, "x") == 8


# ---------------------------------------------------------------------------
# colorings at every tile equal the reference's at the same tile
# ---------------------------------------------------------------------------

_FIELDS = ("n_colors", "iterations", "mode_trace", "counts",
           "host_dispatches")


@pytest.mark.parametrize("tile_rows", [None, 8, 32, 128])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["kron_g500-logn21_s", "europe_osm_s"])
def test_color_at_every_tile_matches_reference(name, fused, tile_rows):
    """``color(g, device="cpu", tile_rows=t)`` equals ``repro.core.color``
    at the same tile (its Pallas kernels in interpret mode for an int
    tile; its jnp path for None, which the reference resolves to no
    tile), field for field."""
    jg = jget(name, scale=0.02)
    tg = get_dataset(name, scale=0.02)
    impl = "jnp" if tile_rows is None else "pallas"
    want = jcore.color(jg, fused=fused, impl=impl, tile_rows=tile_rows)
    got = repro_torch.color(tg, fused=fused, device="cpu",
                            tile_rows=tile_rows)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.colors.dtype == want.colors.dtype
    for f in _FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.tti) == len(want.tti)
    repro_torch.verify_coloring(tg, got.colors)


@pytest.mark.parametrize("tile_rows", [8, 128])
def test_outlined_and_batch_at_a_tile_equal_the_default(tile_rows):
    """The outlined regime, lane batching and the dist regime take a tile
    and give the default run's result."""
    g = get_dataset("kron_g500-logn21_s", scale=0.01, layout="ell-tail",
                    ell_cap=128)
    base = repro_torch.color(g, device="cpu")
    s = Session("cpu")
    out = s.run(ExecutionSpec(regime="outlined", tile_rows=tile_rows), g)
    lanes = s.run_batch(ExecutionSpec(regime="host", tile_rows=tile_rows),
                        [g, g])
    dist = repro_torch.color_distributed(g, devices=["cpu"] * 2)
    dist_t = repro_torch.color(g, device="cpu", mode="dist-hybrid",
                               devices=["cpu"] * 2, tile_rows=tile_rows)
    for r in [out] + lanes:
        np.testing.assert_array_equal(r.colors, base.colors)
        assert (r.iterations, r.mode_trace) == (base.iterations,
                                                base.mode_trace)
    np.testing.assert_array_equal(dist_t.colors, dist.colors)
    assert dist_t.mode_trace == dist.mode_trace
