"""Minitron-4B [arXiv:2407.14679] (pruned Nemotron): 32L d=3072 24H
(GQA kv=8), d_ff=9216, squared-ReLU, vocab 256000, head_dim 128."""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=9216, vocab=256000, act="relu2",
        rope_theta=1e4,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="minitron-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=192, vocab=512, act="relu2",
        dtype=torch.float32,
    )


ARCH = ArchSpec(arch_id="minitron-4b", family="lm",
                make_config=make_config, make_smoke=make_smoke,
                shapes=LM_SHAPES)
