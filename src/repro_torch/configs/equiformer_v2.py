"""EquiformerV2 [arXiv:2306.12059]: 12 blocks, 128 sphere channels,
l_max=6, m_max=2, 8 heads, SO(2)-eSCN convolutions."""
from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.equiformer_v2 import EqV2Config


def make_config() -> EqV2Config:
    return EqV2Config(name="equiformer-v2", n_layers=12, channels=128,
                      l_max=6, m_max=2, n_heads=8, edge_chunk=262144)


def make_smoke() -> EqV2Config:
    return EqV2Config(name="equiformer-v2-smoke", n_layers=2, channels=16,
                      l_max=3, m_max=2, n_heads=4, n_rbf=8, edge_chunk=64)


ARCH = ArchSpec(arch_id="equiformer-v2", family="gnn",
                make_config=make_config, make_smoke=make_smoke,
                shapes=GNN_SHAPES)
