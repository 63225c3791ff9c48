"""SchNet [arXiv:1706.08566]: 3 interactions, d_hidden=64, 300 RBF,
cutoff 10."""
from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.schnet import SchNetConfig


def make_config() -> SchNetConfig:
    return SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0)


def make_smoke() -> SchNetConfig:
    return SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16,
                        n_rbf=20)


ARCH = ArchSpec(arch_id="schnet", family="gnn",
                make_config=make_config, make_smoke=make_smoke,
                shapes=GNN_SHAPES)
