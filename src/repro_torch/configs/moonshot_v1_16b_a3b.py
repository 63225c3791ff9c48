"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 48L d=2048 16H
(kv=16, MHA), MoE 64 experts top-6, expert d_ff=1408, vocab 163840."""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.moe import MoESettings
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1408, vocab=163840, act="swiglu",
        rope_theta=5e6,
        moe=MoESettings(n_experts=64, top_k=6, d_ff_expert=1408),
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, act="swiglu",
        dtype=torch.float32,
        moe=MoESettings(n_experts=8, top_k=3, d_ff_expert=128,
                        capacity_factor=2.0),
    )


ARCH = ArchSpec(arch_id="moonshot-v1-16b-a3b", family="lm",
                make_config=make_config, make_smoke=make_smoke,
                shapes=LM_SHAPES)
