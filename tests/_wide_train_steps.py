"""The port's training step against the reference's at Minitron-4B's
published widths, on the CPU: too large for tier-1 (about 5 GB and a
minute), so a script, not a test.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_wide_train_steps.py \
        [--layers 2] [--vocab 8192] [--steps 4]

Both packages start from the reference's random weights (carried across
by ``params_from_numpy``), in bf16, and take the reference driver's
steps (lr 3e-3, warmup 20, ``update_in_chunks``) on the same
``TokenPipeline`` batches of 8 x 128; each step prints one JSON line with
both losses and grad norms. It shows whether the full-width cell's loss
curve on the card (``chip_smoke.py``'s ``train.full``) is the reference's
arithmetic at these widths or the port's own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipelines import TokenPipeline as JTokenPipeline
from repro.launch.train import build_step as jbuild_step
from repro.models import transformer as jtfm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.configs import get_arch
from repro_torch.data.pipelines import TokenPipeline
from repro_torch.launch.train import build_step
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig, adamw_init


def main(argv: "list[str] | None" = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    cut = dict(n_layers=args.layers, vocab=args.vocab)
    jcfg = dataclasses.replace(jget_arch(args.arch).make_config(), **cut)
    tcfg = dataclasses.replace(get_arch(args.arch).make_config(), **cut)
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    opt = dict(lr=3e-3, warmup_steps=20, total_steps=20,
               update_in_chunks=True)
    jstep = jbuild_step(jcfg, JAdamWConfig(**opt))
    tstep = build_step(tcfg, AdamWConfig(**opt))
    jo, to = jadamw_init(jp), adamw_init(tp)
    kw = dict(vocab=jcfg.vocab, seq_len=128, global_batch=8)
    jpipe, tpipe = JTokenPipeline(**kw), TokenPipeline(**kw)
    out = []
    for step in range(args.steps):
        jp, jo, jm = jstep(jp, jo, jpipe.batch_at(step))
        tp, to, tm = tstep(tp, to, tpipe.batch_at(step, "cpu"))
        out.append(dict(step=step, layers=args.layers, vocab=args.vocab,
                        d_model=tcfg.d_model, dtype=str(tcfg.dtype),
                        reference_loss=float(jm["loss"]),
                        port_loss=float(tm["loss"]),
                        reference_grad_norm=float(jm["grad_norm"]),
                        port_grad_norm=float(tm["grad_norm"])))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
