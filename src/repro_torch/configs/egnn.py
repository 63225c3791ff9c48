"""EGNN [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n)-equivariant."""
from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.egnn import EGNNConfig


def make_config() -> EGNNConfig:
    return EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_in=16)


def make_smoke() -> EGNNConfig:
    return EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_in=4)


ARCH = ArchSpec(arch_id="egnn", family="gnn",
                make_config=make_config, make_smoke=make_smoke,
                shapes=GNN_SHAPES)
