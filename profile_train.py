"""Where one LM training step's time goes on the card: Minitron-4B at its
published widths and all 32 layers, bf16, remat and ``update_in_chunks``,
on the reference driver's traffic (batch 8 x 128), as ``chip_smoke.py``'s
``train.full`` cell runs it.

After ``--warm`` steps of ``launch.train.train`` (random weights from seed
0), ``--reps`` gradient passes and updates are timed apart, then one whole
step runs under ``torch.profiler``. Prints the card's name and power limit,
then one JSON line (``phase: train.profile``).

Usage (on a machine with one CUDA card):
  python3 profile_train.py [--warm 3] [--reps 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import torch

from chip_smoke import TRAIN_ARCH, TRAIN_FULL, TRAIN_FULL_OPT, log


def train_step_profile(cfg, opt_cfg, params, opt, reps: int = 2) -> dict:
    """Where a training step's time goes, after the timed run: ``reps``
    gradient passes (``value_and_grad``: forward, recompute, backward) and
    updates (``adamw_update``) each timed on the host clock (the host's
    issue time, then the wall to a synchronisation) and by CUDA events,
    then one whole step under ``torch.profiler``: device µs and operations
    (the events on the card), the host's ATen calls, and the device and
    host operations that take the most time."""
    from torch.autograd import DeviceType

    from repro_torch.data.pipelines import TokenPipeline
    from repro_torch.launch.train import build_step, value_and_grad
    from repro_torch.optim.adamw import adamw_update

    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=TRAIN_FULL["batch"],
                         seq_len=TRAIN_FULL["seq_len"])
    parts = {"grad": [], "update": []}
    for rep in range(reps):
        b = pipe.batch_at(rep)
        torch.cuda.synchronize()
        for name in parts:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            if name == "grad":
                _, _, grads = value_and_grad(params, b, cfg)
            else:
                params, opt, _ = adamw_update(grads, opt, params, opt_cfg)
                del grads
            ev[1].record()
            issued = time.perf_counter()
            torch.cuda.synchronize()
            parts[name].append(dict(
                host_issue_ms=(issued - t0) * 1e3,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                event_ms=ev[0].elapsed_time(ev[1])))
    act = torch.profiler.ProfilerActivity
    step = build_step(cfg, opt_cfg)
    b = pipe.batch_at(reps)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        params, opt, _ = step(params, opt, b)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    on_card = sorted((e for e in ev if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    aten = sorted((e for e in ev if e.key.startswith("aten::")),
                  key=lambda e: -e.self_cpu_time_total)
    return dict(
        **parts, device_us=sum(e.self_device_time_total for e in on_card),
        device_ops=sum(e.count for e in on_card),
        host_ops=sum(e.count for e in aten),
        top_device=[[e.key[:90], e.count, e.self_device_time_total]
                    for e in on_card[:10]],
        top_host=[[e.key, e.count, e.self_cpu_time_total]
                  for e in aten[:10]])


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).make_config(),
                              remat=True)
    opt_cfg = AdamWConfig(**TRAIN_FULL_OPT)
    r = train(cfg, opt_cfg, steps=args.warm, log=lambda line: None,
              **TRAIN_FULL)
    log(phase="train.profile", card=card, arch=TRAIN_ARCH,
        layers=cfg.n_layers, warm_steps=args.warm,
        **train_step_profile(cfg, opt_cfg, r.params, r.opt, args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
