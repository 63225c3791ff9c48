"""Serving driver: batched prefill, then decode with a KV cache
(``repro/launch/serve.py``).

A batch of random prompts is prefilled, then decoded token by token
(the first token greedy from the prefill logits, the rest sampled at
``temperature``); reports prefill and per-step decode latency and
throughput. The CLI serves an arch's smoke config, as the reference's
does; ``serve()`` takes any ``LMConfig``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --batch 8 --prompt-len 64 --gen 32 [--kv-int8] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given; without a card
the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.core.policy import Timer
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class ServeResult:
    """What one ``serve`` call produced and how long it took."""

    #: (B, gen) int64 generated token ids
    tokens: torch.Tensor
    #: (B, prompt_len) int64 prompts
    prompts: torch.Tensor
    #: (B, V) logits of the last prompt position (prefill)
    prefill_logits: torch.Tensor
    #: (B, V) logits of the first decode step (its input: the greedy
    #: token of the prefill logits, the same for every cache type)
    step_logits: "torch.Tensor | None"
    #: seconds: init (None when the caller passed params), prefill (the
    #: int8 re-quantization included), decode (gen - 1 steps)
    init_s: "float | None"
    prefill_s: float
    decode_s: float
    batch: int
    prompt_len: int
    gen: int

    @property
    def prefill_tok_s(self) -> float:
        return self.batch * self.prompt_len / self.prefill_s

    @property
    def decode_steps(self) -> int:
        return max(self.gen - 1, 1)

    @property
    def decode_ms_per_step(self) -> float:
        return self.decode_s / self.decode_steps * 1e3

    @property
    def decode_tok_s(self) -> float:
        return self.batch * (self.gen - 1) / self.decode_s

    def timings(self) -> dict:
        return dict(init_s=self.init_s, prefill_ms=self.prefill_s * 1e3,
                    prefill_tok_s=self.prefill_tok_s,
                    decode_ms_per_step=self.decode_ms_per_step,
                    decode_tok_s=self.decode_tok_s)


def _sync(dev: torch.device, mesh=None) -> None:
    devs = [dev] if mesh is None else [dev, *mesh.distinct_devices()]
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def serve(cfg: tfm.LMConfig, *, batch: int = 8, prompt_len: int = 64,
          gen: int = 32, temperature: float = 0.8, kv_int8: bool = False,
          device=None, generator: "torch.Generator | None" = None,
          params: "dict | None" = None, mesh=None, batch_axes: tuple = (),
          fsdp_axes: tuple = ()) -> ServeResult:
    """Serve one batch: random prompts (from ``generator``), prefill into
    a cache with room for ``gen`` more tokens (re-quantized to int8 with
    ``kv_int8``), then ``gen - 1`` decode steps. ``params`` None draws the
    weights from ``generator`` first (timed as ``init_s``). ``device``
    None is the CUDA device; ``generator`` None one seeded with 0 there.
    ``mesh``, ``batch_axes`` and ``fsdp_axes`` go to ``prefill`` and
    ``decode_step`` (``launch.mesh``; ``params`` may hold
    ``place_params``' expert shards). Every time ends in a device
    synchronisation (of each device of the mesh)."""
    shard = dict(mesh=mesh, batch_axes=batch_axes, fsdp_axes=fsdp_axes)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    with torch.inference_mode():
        init_s = None
        if params is None:
            with Timer() as t:
                params, _ = tfm.init_params(cfg, generator, device=dev)
                _sync(dev)
            init_s = t.seconds
        prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                generator=generator, device=dev)
        max_len = prompt_len + gen

        with Timer() as t:
            logits, cache = tfm.prefill(params, prompts, cfg,
                                        max_len=max_len, **shard)
            if kv_int8:
                cache = tfm.quantize_cache(cache)
            _sync(dev, mesh)
        prefill_s = t.seconds
        prefill_logits = logits

        toks = torch.argmax(logits, -1)[:, None]
        out = [toks]
        step_logits = None
        with Timer() as t:
            for i in range(gen - 1):
                logits, cache = tfm.decode_step(params, toks, cache, cfg,
                                                **shard)
                if i == 0:
                    step_logits = logits
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                toks = torch.multinomial(probs, 1, generator=generator)
                out.append(toks)
            _sync(dev, mesh)
        decode_s = t.seconds
    return ServeResult(tokens=torch.cat(out, dim=1), prompts=prompts,
                       prefill_logits=prefill_logits,
                       step_logits=step_logits, init_s=init_s,
                       prefill_s=prefill_s, decode_s=decode_s, batch=batch,
                       prompt_len=prompt_len, gen=gen)


def main(argv: "list[str] | None" = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--kv-int8", action="store_true",
                    help="serve with an int8-quantized KV cache")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    r = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen, temperature=args.temperature,
              kv_int8=args.kv_int8, device=args.device)
    if args.kv_int8:
        print("serving with an int8 KV cache (half the cache bytes a "
              "decode step reads)")
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{r.prefill_s * 1e3:.1f}ms ({r.prefill_tok_s:,.0f} tok/s)")
    print(f"decode: {args.gen - 1} steps x batch {args.batch} in "
          f"{r.decode_s:.2f}s ({r.decode_ms_per_step:.1f}ms/step, "
          f"{r.decode_tok_s:,.0f} tok/s)")
    print("sample token ids:", r.tokens[0, :16].tolist())
    return r


if __name__ == "__main__":
    main()
