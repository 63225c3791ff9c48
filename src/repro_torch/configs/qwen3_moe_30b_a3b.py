"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4)
MoE 128 experts top-8, expert d_ff=768, vocab 151936, head_dim 128."""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.moe import MoESettings
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936, act="swiglu",
        rope_theta=1e6,
        moe=MoESettings(n_experts=128, top_k=8, d_ff_expert=768),
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab=512, act="swiglu",
        dtype=torch.float32,
        moe=MoESettings(n_experts=8, top_k=2, d_ff_expert=96,
                        capacity_factor=2.0),
    )


ARCH = ArchSpec(arch_id="qwen3-moe-30b-a3b", family="lm",
                make_config=make_config, make_smoke=make_smoke,
                shapes=LM_SHAPES)
