"""The step builders' cases against the reference's
(``repro_torch.launch.steps`` vs ``repro.launch.steps``, the latter
loaded by ``tests/_steps_ref.py``), abstract: for each of the registry's
42 cells, and the LM decode shapes' three other variants, the same
``meta`` exactly, the same ``donate``, and every argument leaf with the
reference's path, shape and dtype (``DTYPES``; the minibatch key is a
host ``uint32`` pair on both sides). The port's abstract arguments lie on
the ``meta`` device, and building every case allocates nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh

from _steps_ref import (leaf_paths, one_device_mesh, port_paths,
                        reference_steps)

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

#: the reference's dtypes and the port's
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float16): torch.float16,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.int8): torch.int8,
          jnp.dtype(jnp.bool_): torch.bool}

CELLS = [(a, s, "base") for a, s in steps.registry_cells()] + [
    (a, s, v) for a, s in steps.registry_cells()
    if s in ("decode_32k", "long_500k") for v in steps.DECODE_VARIANTS]


@pytest.fixture
def jsteps(monkeypatch):
    yield from reference_steps(monkeypatch)


def test_registry_has_the_reference_cells():
    from repro.configs import ARCH_IDS, get_arch
    want = [(a, s) for a in ARCH_IDS + ["paper-ipgc"]
            for s in get_arch(a).shapes]
    assert steps.registry_cells() == want and len(want) == 42
    assert len(CELLS) == 42 + 5 * 2 * 3


@pytest.mark.parametrize("arch,shape,variant", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_case_matches_reference(jsteps, arch, shape, variant):
    want = jsteps.build_case(arch, shape, one_device_mesh(), variant=variant)
    got = steps.build_case(arch, shape, variant=variant, abstract=True)
    assert (got.arch_id, got.shape_name) == (arch, shape)
    assert got.meta == want.meta
    assert got.donate == want.donate
    assert got.mesh is None
    theirs, mine = leaf_paths(want.args), port_paths(got.args)
    assert list(mine) == list(theirs)
    for path, sds in theirs.items():
        leaf = mine[path]
        if isinstance(leaf, np.ndarray):
            assert leaf.dtype == sds.dtype == np.uint32, path
            assert leaf.shape == sds.shape == (2,), path
        else:
            assert leaf.device.type == "meta", path
            assert tuple(leaf.shape) == sds.shape, path
            assert leaf.dtype == DTYPES[jnp.dtype(sds.dtype)], path
    assert steps.arg_bytes(got) == sum(
        int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize
        for s in theirs.values())


def test_decode_variants_follow_the_reference():
    base = steps.build_case("minitron-4b", "long_500k", abstract=True)
    q8 = steps.build_case("minitron-4b", "long_500k", variant="opt_int8",
                          abstract=True)
    half = steps.build_case("minitron-4b", "long_500k",
                            variant="opt_int8_half", abstract=True)
    assert base.args[1].k.dtype == torch.bfloat16 and not base.args[1].quantized
    assert q8.args[1].k.dtype == torch.int8 and q8.args[1].quantized
    assert q8.args[1].k_scale.dtype == torch.float16
    assert half.args[1].k.shape[2] == q8.args[1].k.shape[2] // 2
    assert q8.meta["kv_bytes"] * 2 == base.meta["kv_bytes"]
    # Minitron's bf16 weights pass 6e9 bytes: the FSDP axes stay
    assert steps.build_case("minitron-4b", "decode_32k", make_local_mesh(
        "cpu"), variant="opt", abstract=True).axes["fsdp_axes"] == ("data",)
    small = steps.build_case("qwen3-moe-30b-a3b", "long_500k",
                             make_local_mesh("cpu"), variant="opt",
                             abstract=True)
    assert small.axes["fsdp_axes"] == ("data",)     # 61 GB of bf16 weights


def test_fit_profiles_are_the_reference_ones(jsteps):
    assert steps._MICROBATCHES == jsteps._MICROBATCHES
    assert set(steps._OPT_STATE_DTYPE) == set(jsteps._OPT_STATE_DTYPE)
    assert set(steps._GRAD_ACCUM_DTYPE) == set(jsteps._GRAD_ACCUM_DTYPE)
    opt = steps.build_case("nemotron-4-340b", "train_4k", abstract=True)
    assert opt.args[1].m["embed"].dtype == torch.bfloat16
    opt = steps.build_case("minitron-4b", "train_4k", abstract=True)
    assert opt.args[1].m["embed"].dtype == torch.float32


@pytest.mark.parametrize("arch,shape", [
    ("minitron-4b", "prefill_32k"), ("qwen3-moe-30b-a3b", "long_500k"),
    ("equiformer-v2", "full_graph_sm"), ("graphsage-reddit", "ogb_products"),
    ("schnet", "molecule"), ("dlrm-rm2", "train_batch")])
def test_a_mesh_changes_axes_not_meta(arch, shape):
    """On a (1, 1) mesh the same meta and argument shapes, the axes the
    mesh forms take (the reference's rules), and each case's device the
    mesh's."""
    mesh = make_local_mesh("cpu")
    plain = steps.build_case(arch, shape, abstract=True)
    meshed = steps.build_case(arch, shape, mesh, abstract=True)
    assert meshed.meta == plain.meta and meshed.mesh is mesh
    assert meshed.axes["batch_axes"] == ("data",)
    assert plain.axes["batch_axes"] == ()
    if arch == "equiformer-v2":
        assert meshed.axes["edge_shard_axes"] == ("data",)
        assert plain.axes["edge_shard_axes"] == ()
    assert steps.arg_bytes(meshed) == steps.arg_bytes(plain)


def test_abstract_cases_allocate_nothing():
    """Building every cell abstract leaves no tensor with storage: each
    leaf is on the meta device (and the biggest, Nemotron's 1.9 TiB of
    training state, costs nothing)."""
    total = 0
    for a, s, v in CELLS:
        case = steps.build_case(a, s, variant=v, abstract=True)
        for _, leaf in steps.flatten_args(case.args):
            assert isinstance(leaf, np.ndarray) or leaf.device.type == "meta"
        total += steps.arg_bytes(case)
    assert total > 2**40


def test_real_arguments_lie_in_range():
    """Arguments drawn on the CPU (small shapes): ids below N or the pad,
    priorities a permutation, labels below the class count, sparse ids
    below the vocabulary, cache lengths below S, a CSR that adds up."""
    from _case_check import SHAPES, smoke_case

    ig, colors, base, wl = smoke_case(("paper-ipgc", "coloring_k8",
                                       "base")).args
    n = ig.n_nodes
    assert int(ig.ell_idx.min()) >= 0 and int(ig.ell_idx.max()) <= n
    assert torch.equal(torch.sort(ig.priority[:n].long()).values,
                       torch.arange(n)) and int(ig.priority[n]) == -1
    assert int((ig.degrees > ig.ell_width).sum()) == ig.n_hub
    assert int(colors[n]) < 0 and bool(wl.mask.all())
    sage = smoke_case(("graphsage-reddit", "gnn_full", "base"))
    feat, src, dst, labels = sage.args[2], sage.args[3], sage.args[4], \
        sage.args[6]
    n_real = SHAPES["gnn_full"].params["n_nodes"]
    assert int(src.max()) == feat.shape[0]          # the pads
    real = src < feat.shape[0]
    assert int(src[real].max()) < n_real and int(dst[real].max()) < n_real
    assert int(labels.max()) < steps.smoke_arch(
        "graphsage-reddit").make_config().n_classes
    mb = smoke_case(("schnet", "gnn_minibatch", "base")).args
    row_ptr, col_idx = mb[5], mb[6]
    assert int(row_ptr[0]) == 0 and int(row_ptr[-1]) == col_idx.shape[0]
    assert bool((row_ptr[1:] >= row_ptr[:-1]).all())
    dl = smoke_case(("dlrm-rm2", "rs_train", "base")).args
    cfg = steps.smoke_arch("dlrm-rm2").make_config()
    assert int(dl[3].max()) < cfg.vocab_per_table
    assert set(dl[4].unique().tolist()) <= {0.0, 1.0}
    dec = smoke_case(("minitron-4b", "decode", "opt_int8")).args[1]
    assert int(dec.length.max()) < dec.k.shape[2]
    assert float(dec.k_scale.min()) > 0


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shape = ShapeSpec("s", "rs_serve", dict(batch=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.case_for(steps.smoke_arch("dlrm-rm2"), shape)
