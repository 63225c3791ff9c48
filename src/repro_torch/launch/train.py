"""Training driver, LM family (``repro/launch/train.py``).

Production behaviours, end to end on the card or the CPU:
  * a deterministic restartable data pipeline (batch = f(seed, step)),
  * async checkpointing with atomic renames and keep-N GC,
  * resume from the latest complete checkpoint (restoring onto another
    device is the same call),
  * an optional int8-compressed gradient reduction over data replicas
    (``--compress``; here one replica on the run's device, the reference's
    mesh of one).

The step is ``loss_fn``'s autograd gradient (each layer recomputed in
backward when ``cfg.remat``) and the in-place ``adamw_update``; the
parameters are the functional params dict, float leaves requiring grad.
The host reads values back only on log steps (and once at the end).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --smoke \\
      --steps 200 --batch 8 --seq-len 128 --ckpt-dir /tmp/ck [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given; without a card
the default raises. ``train()`` takes any ``LMConfig``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import torch

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data.pipelines import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)
from repro_torch.optim.compression import compress_init, compressed_psum
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(params: dict, batch: dict, cfg: tfm.LMConfig, **kw
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, loss_fn's metrics, gradients in ``params``' tree), all
    detached. Marks the float leaves of ``params`` as requiring grad.
    ``kw`` goes to ``loss_fn`` (``mesh``, ``batch_axes``, ``fsdp_axes``)."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = tfm.loss_fn(params, batch, cfg, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_unflatten(params, list(grads))


def build_step(cfg: tfm.LMConfig, opt_cfg: AdamWConfig, *,
               compress: bool = False, mesh: "list | None" = None):
    """The training step. ``step(params, opt, batch) -> (params, opt,
    metrics)``; with ``compress``, ``step(params, opt, err, batch) ->
    (params, opt, err, metrics)``: ``mesh`` lists one device a data
    replica (several may share one), the batch is split over them along
    its leading axis, ``err`` holds one ``CompressState`` a replica, and
    the replicas' gradients meet in ``compressed_psum``.
    The loss reported is replica 0's, as the reference's replicated
    output gives it."""
    if not compress:
        def step(params, opt, batch):
            loss, metrics, grads = value_and_grad(params, batch, cfg)
            p2, o2, om = adamw_update(grads, opt, params, opt_cfg)
            return p2, o2, {**metrics, **om, "loss": loss}
        return step

    if not mesh:
        raise ValueError("compress=True needs a mesh: one device a data "
                         "replica")
    devices = [resolve_device(d) for d in mesh]

    def step(params, opt, err, batch):
        per = batch["tokens"].shape[0] // len(devices)
        home = tree_leaves(params)[0].device
        losses, grads = [], []
        for r, dev in enumerate(devices):
            shard = {k: v[r * per:(r + 1) * per].to(dev)
                     for k, v in batch.items()}
            p = params if dev == home else tree_map(
                lambda t: t.detach().to(dev), params)
            loss, _, g = value_and_grad(p, shard, cfg)
            losses.append(loss)
            grads.append(g)
        red, err2 = compressed_psum(grads, err)
        p2, o2, om = adamw_update(red, opt, params, opt_cfg)
        return p2, o2, err2, {"loss": losses[0].to(home), **om}
    return step


@dataclasses.dataclass
class TrainResult:
    """What one ``train`` call ran and how long it took."""

    params: dict
    opt: AdamWState
    #: the first step run (the one after a restored checkpoint) and the
    #: step count run to
    start: int
    steps: int
    #: (steps - start,) fp32 on the host: each step's loss and grad norm
    losses: torch.Tensor
    grad_norms: torch.Tensor
    #: ms between consecutive steps' starts on the card's timeline (CUDA
    #: events, the last to the loop's end); None on the CPU
    step_ms: "list[float] | None"
    #: seconds: init (None when the caller passed params), the loop (its
    #: checkpoint saves and the final synchronisation included)
    init_s: "float | None"
    seconds: float
    tokens_per_step: int

    @property
    def tok_s(self) -> float:
        return (self.steps - self.start) * self.tokens_per_step \
            / self.seconds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: tfm.LMConfig, opt_cfg: AdamWConfig, *,
          steps: "int | None" = None, batch: int = 8, seq_len: int = 128,
          ckpt_dir: str = "", ckpt_every: int = 50, log_every: int = 10,
          compress: bool = False, device=None,
          params: "dict | None" = None,
          log: Callable[[str], None] = print) -> TrainResult:
    """Train ``cfg`` on ``TokenPipeline`` batches up to step ``steps``
    (default ``opt_cfg.total_steps``; a smaller one stops early on the same
    schedule). ``params`` None draws the weights from a generator seeded
    with 0 on the device, as the reference draws them from
    ``PRNGKey(0)``, timed as ``init_s``. With
    ``ckpt_dir``, resumes after its latest complete checkpoint, saves every
    ``ckpt_every`` steps and at the end. ``device`` None is the CUDA
    device."""
    dev = resolve_device(device)
    steps = opt_cfg.total_steps if steps is None else steps
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq_len,
                         global_batch=batch)
    init_s = None
    if params is None:
        t0 = time.perf_counter()
        with torch.no_grad():
            params, _ = tfm.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        _sync(dev)
        init_s = time.perf_counter() - t0
    opt = adamw_init(params, opt_cfg.state_dtype)
    start = 0
    ck = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ck:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, last,
                                       {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            start = last + 1
            log(f"resumed from step {last}")

    mesh = err = None
    if compress:
        mesh = [dev]
        err = [compress_init(params) for _ in mesh]
    step_fn = build_step(cfg, opt_cfg, compress=compress, mesh=mesh)

    n_par = sum(x.numel() for x in tree_leaves(params))
    log(f"arch={cfg.name} params={n_par / 1e6:.1f}M "
        f"steps={steps} batch={batch}x{seq_len}")
    cuda = dev.type == "cuda"
    marks, losses, gnorms = [], [], []
    t0 = time.perf_counter()
    for step in range(start, steps):
        b = pipe.batch_at(step, dev)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        if compress:
            params, opt, err, m = step_fn(params, opt, err, b)
        else:
            params, opt, m = step_fn(params, opt, b)
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        if step % log_every == 0 or step == steps - 1:
            loss = float(m["loss"])
            tok_s = (step - start + 1) * batch * seq_len \
                / (time.perf_counter() - t0)
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(m['grad_norm']):.3f} tok/s {tok_s:,.0f}")
        if ck and step % ckpt_every == 0 and step > start:
            ck.save(step, {"params": params, "opt": opt})
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    if ck:
        ck.save(steps - 1, {"params": params, "opt": opt})
        ck.wait()
    _sync(dev)
    seconds = time.perf_counter() - t0
    flat = torch.zeros(0)
    return TrainResult(
        params=params, opt=opt, start=start, steps=max(steps, start),
        losses=torch.stack(losses).float().cpu() if losses else flat,
        grad_norms=torch.stack(gnorms).float().cpu() if gnorms else flat,
        step_ms=[a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        if cuda else None,
        init_s=init_s, seconds=seconds, tokens_per_step=batch * seq_len)


def main(argv: "list[str] | None" = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient reduction (explicit DP)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    r = train(cfg, opt_cfg, batch=args.batch, seq_len=args.seq_len,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              log_every=args.log_every, compress=args.compress,
              device=args.device)
    print("done.")
    return r


if __name__ == "__main__":
    main()
