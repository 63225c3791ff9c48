"""Nemotron-4-340B [arXiv:2402.16819]: 96L d=18432 96H (GQA kv=8),
d_ff=73728, squared-ReLU (ungated), vocab 256000, head_dim 192."""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
        n_kv_heads=8, head_dim=192, d_ff=73728, vocab=256000, act="relu2",
        rope_theta=1e4,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="nemotron-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=384, vocab=512, act="relu2",
        dtype=torch.float32,
    )


ARCH = ArchSpec(arch_id="nemotron-4-340b", family="lm",
                make_config=make_config, make_smoke=make_smoke,
                shapes=LM_SHAPES)
