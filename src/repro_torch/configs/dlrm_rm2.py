"""DLRM RM2-class [arXiv:1906.00091]: 13 dense + 26 sparse features,
embed_dim 64, bottom MLP 13-512-256-64, top MLP 512-512-256-1, dot
interaction. Tables: 26 x 1M rows (row-sharded over the model axis)."""
from repro_torch.configs import ArchSpec, RECSYS_SHAPES
from repro_torch.models.dlrm import DLRMConfig


def make_config() -> DLRMConfig:
    return DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26,
                      embed_dim=64, vocab_per_table=1_000_000,
                      bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))


def make_smoke() -> DLRMConfig:
    return DLRMConfig(name="dlrm-smoke", n_dense=13, n_sparse=26,
                      embed_dim=16, vocab_per_table=1000,
                      bot_mlp=(64, 32, 16), top_mlp=(64, 32, 1))


ARCH = ArchSpec(arch_id="dlrm-rm2", family="recsys",
                make_config=make_config, make_smoke=make_smoke,
                shapes=RECSYS_SHAPES)
