"""The port's checkpoints, token pipeline, elastic helpers and training
driver on the CPU: ``repro_torch.ckpt`` round trip, atomicity, ``keep=``
garbage collection and restores across the two packages in both
directions, exactly (the same on-disk format: leaf names and order as
``jax.tree_util.tree_flatten_with_path`` gives them, bf16 widened to fp32
with its dtype in the manifest); ``TokenPipeline.batch_at`` and
``host_slice`` bit-equal to the reference's; ``ft/elastic`` as
``tests/test_substrate.py`` checks the reference's; and the
``launch/train.py`` CLI resuming where it stopped, ``train()`` resumed
equal to a straight run, and the device rule of the train entry points;
and that the port and ``chip_smoke.py`` import neither ``jax`` nor
``repro``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jrestore
from repro.ckpt import save_checkpoint as jsave
from repro.data.pipelines import TokenPipeline as JTokenPipeline
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.ckpt import (AsyncCheckpointer, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.data.pipelines import (TokenPipeline, fold_in, prng_key,
                                        uniform)
from repro_torch.ft.elastic import (StragglerMonitor, plan_mesh,
                                    survivors_mesh)
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.randn(3, generator=g).to(torch.bfloat16)}}


def _state(tree):
    """{"params": tree, "opt": AdamWState} with distinct values."""
    opt = tadamw.adamw_init(tree)
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32),
                       m=tree_map(lambda t: t + 1, opt.m),
                       v=tree_map(lambda t: t + 2, opt.v))
    return {"params": tree, "opt": opt}


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    like = tree_map(torch.zeros_like, t)
    back = restore_checkpoint(str(tmp_path), 7, like)
    for a, b in zip(tree_leaves(t), tree_leaves(back)):
        assert _equal(a, b)


def test_checkpoint_names_and_manifest_are_the_reference_format(tmp_path):
    params = {"layers": {"wq": torch.ones(2, 3), "ln1": torch.zeros(2, 3)},
              "embed": torch.ones(4, 3, dtype=torch.bfloat16)}
    save_checkpoint(str(tmp_path), 3, _state(params))
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        man = json.load(f)
    names = [x["name"] for x in man["leaves"]]
    assert names == [
        "['opt']__.step", "['opt']__.m__['embed']",
        "['opt']__.m__['layers']__['ln1']", "['opt']__.m__['layers']__['wq']",
        "['opt']__.v__['embed']", "['opt']__.v__['layers']__['ln1']",
        "['opt']__.v__['layers']__['wq']", "['params']__['embed']",
        "['params']__['layers']__['ln1']", "['params']__['layers']__['wq']"]
    dtypes = {x["name"]: x["dtype"] for x in man["leaves"]}
    assert dtypes["['params']__['embed']"] == "bfloat16"
    assert dtypes["['opt']__.step"] == "int32"
    assert man["step"] == 3
    assert np.load(tmp_path / "step_00000003"
                   / "['params']__['embed'].npy").dtype == np.float32


def test_checkpoint_atomicity(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    # a stale .tmp dir (a crash mid-write) is no step
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """``save`` copies to host memory: an in-place write right after it
    does not reach the checkpoint."""
    t = _tree()
    want = t["a"].clone()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(5, t)
    t["a"].add_(1.0)
    ck.wait()
    back = restore_checkpoint(str(tmp_path), 5, t)
    assert torch.equal(back["a"], want)


def test_restore_onto_another_device_tree(tmp_path):
    """The reference's restore with ``shardings=``: a device, or a tree
    of them, for each leaf."""
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    devs = tree_map(lambda _: torch.device("cpu"), t)
    for device in ("cpu", devs):
        back = restore_checkpoint(str(tmp_path), 3, t, device=device)
        for a, b in zip(tree_leaves(t), tree_leaves(back)):
            assert _equal(a, b) and b.device.type == "cpu"


def _jax_state():
    k = jax.random.PRNGKey(1)
    params = {"layers": {"wq": jax.random.normal(k, (2, 3, 4)),
                         "ln1": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)},
              "embed": jax.random.normal(k, (5, 3)).astype(jnp.bfloat16)}
    opt = jadamw_init(params)
    opt = opt._replace(step=jnp.asarray(4, jnp.int32),
                       m=jax.tree.map(lambda x: x + 0.5, opt.m))
    return {"params": params, "opt": opt}


def _torch_like(jtree):
    """The port's state of the same structure, zeros."""
    def zeros(x):
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int32": torch.int32}[str(x.dtype)]
        return torch.zeros(x.shape, dtype=dt)
    params = tree_map(zeros, jtree["params"])
    return {"params": params,
            "opt": tadamw.AdamWState(step=zeros(jtree["opt"].step),
                                     m=tree_map(zeros, jtree["opt"].m),
                                     v=tree_map(zeros, jtree["opt"].v))}


def _leaves_equal(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = ([ttree["opt"].step] + tree_leaves(ttree["opt"].m)
          + tree_leaves(ttree["opt"].v)
          + tree_leaves(ttree["params"]))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
        np.testing.assert_array_equal(
            b.float().numpy(), np.asarray(jnp.asarray(a, jnp.float32)))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jsave(str(tmp_path), 4, jstate)
    back = restore_checkpoint(str(tmp_path), 4, _torch_like(jstate))
    assert isinstance(back["opt"], tadamw.AdamWState)
    _leaves_equal(jstate, back)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _jax_state()
    # the port's state holding the reference's values
    jsave(str(tmp_path / "src"), 4, jstate)
    tstate = restore_checkpoint(str(tmp_path / "src"), 4,
                                _torch_like(jstate))
    save_checkpoint(str(tmp_path / "dst"), 9, tstate)
    like = jax.tree.map(jnp.zeros_like, jstate)
    back = jrestore(str(tmp_path / "dst"), 9, like)
    _leaves_equal(back, tstate)
    assert str(back["params"]["embed"].dtype) == "bfloat16"


# --- the token pipeline ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 12345, -7])
def test_token_pipeline_bit_equal(seed):
    for vocab, seq, batch in ((100, 16, 8), (256000, 33, 4)):
        jp = JTokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch,
                            seed=seed)
        tp = TokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch,
                           seed=seed)
        for step in (0, 1, 5, 199, 2**31 + 7):
            want, got = jp.batch_at(step), tp.batch_at(step, "cpu")
            assert set(got) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
        for host in range(2):
            want = jp.host_slice(5, host, 2)
            got = tp.host_slice(5, host, 2, "cpu")
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_threefry_primitives_match_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(42), 9)
    np.testing.assert_array_equal(fold_in(prng_key(42), 9), np.asarray(key))
    np.testing.assert_array_equal(uniform(np.asarray(key), (3, 5)),
                                  np.asarray(jax.random.uniform(key, (3, 5))))


def test_data_pipeline_deterministic():
    """``tests/test_substrate.py::test_data_pipeline_deterministic`` on the
    port (its token half)."""
    p = TokenPipeline(vocab=100, seq_len=16, global_batch=8, seed=3)
    a, b = p.batch_at(5, "cpu"), p.batch_at(5, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], p.batch_at(6, "cpu")["tokens"])
    h0, h1 = p.host_slice(5, 0, 2, "cpu"), p.host_slice(5, 1, 2, "cpu")
    assert torch.equal(torch.cat([h0["tokens"], h1["tokens"]]), a["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# --- ft/elastic --------------------------------------------------------------

def test_elastic_mesh_planning():
    assert plan_mesh(512, model_parallel=16, pods=2) == (2, 16, 16)
    assert plan_mesh(256, model_parallel=16) == (16, 16)
    # losing 8 hosts x 4 chips = 32 chips drops 2 data rows
    assert survivors_mesh((16, 16), list(range(8)), 4) == (14, 16)
    assert survivors_mesh((2, 16, 16), list(range(8)), 4) == (2, 15, 16)
    with pytest.raises(ValueError):
        plan_mesh(8, model_parallel=16)


def test_straggler_rebalance():
    mon = StragglerMonitor(n_hosts=4)
    assert mon.rebalance_batch(256) == [64] * 4
    for h, t in [(0, 1.0), (1, 1.0), (2, 1.0), (3, 2.0)]:
        for _ in range(5):
            mon.observe(h, t)
    assert mon.stragglers() == [3]
    sizes = mon.rebalance_batch(256, granule=8)
    assert sum(sizes) == 256
    assert sizes[3] < sizes[0]


def test_elastic_is_the_reference_module():
    from repro.ft import elastic as jel
    from repro_torch.ft import elastic as tel
    for name in ("plan_mesh", "survivors_mesh", "StragglerMonitor"):
        assert getattr(tel, name).__module__ == "repro_torch.ft.elastic"
    assert tel.plan_mesh(96, model_parallel=8, pods=3) == \
        jel.plan_mesh(96, model_parallel=8, pods=3)


# --- the training driver --------------------------------------------------------------

def _smoke(arch="gemma-7b"):
    return get_arch(arch).make_smoke()


def test_train_resumed_equals_straight(tmp_path):
    """Three steps, a checkpoint, a restore into fresh state and three
    more: the same losses and final parameters as six steps straight, on
    one schedule."""
    cfg = _smoke("minitron-4b")
    opt_cfg = tadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    kw = dict(batch=2, seq_len=16, device="cpu", log=lambda s: None)
    straight = ttrain.train(cfg, opt_cfg, **kw)
    first = ttrain.train(cfg, opt_cfg, steps=3, ckpt_dir=str(tmp_path), **kw)
    logs = []
    second = ttrain.train(cfg, opt_cfg, ckpt_dir=str(tmp_path),
                          **{**kw, "log": logs.append})
    assert (first.start, first.steps, second.start, second.steps) == \
        (0, 3, 3, 6)
    assert logs[0] == "resumed from step 2"
    assert torch.equal(torch.cat([first.losses, second.losses]),
                       straight.losses)
    assert torch.equal(torch.cat([first.grad_norms, second.grad_norms]),
                       straight.grad_norms)
    for a, b in zip(tree_leaves(second.params),
                    tree_leaves(straight.params)):
        assert torch.equal(a, b)
    assert int(second.opt.step) == 6
    assert straight.step_ms is None and straight.init_s is not None
    assert bool(torch.isfinite(straight.losses).all())


def test_main_resumes_where_it_stopped(tmp_path, capsys):
    args = ["--smoke", "--arch", "nemotron-4-340b", "--batch", "2",
            "--seq-len", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--log-every", "2", "--device", "cpu"]
    r1 = ttrain.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "arch=nemotron-smoke" in out and out.rstrip().endswith("done.")
    assert "step     4 loss" in out and "gnorm" in out and "tok/s" in out
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000002", "step_00000004"]
    r2 = ttrain.main(args + ["--steps", "8"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert (r1.start, r1.steps, r2.start, r2.steps) == (0, 5, 5, 8)
    assert len(r2.losses) == 3 and bool(torch.isfinite(r2.losses).all())
    assert int(r2.opt.step) == 8
    # keep=3: the saves at 2, 4, 6 and the final 7 leave the last three
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000004", "step_00000006", "step_00000007"]


def test_main_compress_runs_one_replica(capsys):
    r = ttrain.main(["--smoke", "--arch", "moonshot-v1-16b-a3b", "--steps",
                     "2", "--batch", "2", "--seq-len", "8", "--compress",
                     "--device", "cpu"])
    assert len(r.losses) == 2 and bool(torch.isfinite(r.grad_norms).all())
    assert "done." in capsys.readouterr().out


def test_train_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.data.pipelines import TokenPipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(cfg, tadamw.AdamWConfig(total_steps=1), batch=1,
                     seq_len=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(vocab=10, seq_len=4, global_batch=2).batch_at(0)
    with pytest.raises(ValueError, match="mesh"):
        ttrain.build_step(cfg, tadamw.AdamWConfig(), compress=True)


_NO_JAX = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = ["src", "tests", "."]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke, _train_check, _gnn_steps, profile_train
print("NO_JAX_OK")
"""


def test_port_and_chip_smoke_import_no_jax_or_repro():
    """Every module of ``repro_torch``, ``chip_smoke.py``,
    ``profile_train.py`` and the card checks' helpers import with ``jax``
    and ``repro`` unimportable."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=repo,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0 and "NO_JAX_OK" in out.stdout, \
        out.stderr[-3000:]
