"""Gemma-7B [arXiv:2403.08295]: 28L d=3072 16H (kv=16, MHA), GeGLU
d_ff=24576, vocab 256000, head_dim 256, embeddings scaled by sqrt(d)."""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
        n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000, act="geglu",
        rope_theta=1e4, embed_scale=True,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="gemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, act="geglu", embed_scale=True,
        dtype=torch.float32,
    )


ARCH = ArchSpec(arch_id="gemma-7b", family="lm",
                make_config=make_config, make_smoke=make_smoke,
                shapes=LM_SHAPES)
