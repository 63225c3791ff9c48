"""GraphSAGE-Reddit [arXiv:1706.02216]: 2 layers, d_hidden=128, mean
aggregator, fan-out 25-10 (Reddit: 232 965 nodes, 602 features, 41
classes). The assignment's minibatch shape samples with fan-out 15-10."""
from repro_torch.configs import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.graphsage import SAGEConfig


def make_config() -> SAGEConfig:
    return SAGEConfig(name="graphsage-reddit", n_layers=2, d_in=602,
                      d_hidden=128, n_classes=41, aggregator="mean",
                      fanouts=(25, 10))


def make_smoke() -> SAGEConfig:
    return SAGEConfig(name="graphsage-smoke", n_layers=2, d_in=8,
                      d_hidden=16, n_classes=5, fanouts=(5, 3))


ARCH = ArchSpec(arch_id="graphsage-reddit", family="gnn",
                make_config=make_config, make_smoke=make_smoke,
                shapes=GNN_SHAPES)
