"""The paper's own engine as an 11th selectable arch: hybrid IPGC
coloring. Shapes = representative synthetic suite graphs; the dry-run
lowers the distributed dense step (node-sharded, color all-gather)."""
from repro_torch.configs import ArchSpec, ShapeSpec


def make_config():
    return dict(window=128, h=0.6)


def make_smoke():
    return dict(window=128, h=0.6)


SHAPES = {
    "suite_europe": ShapeSpec("suite_europe", "coloring",
                              dict(n_nodes=52_428_800, ell_width=8)),
    "suite_kron": ShapeSpec("suite_kron", "coloring",
                            dict(n_nodes=2_097_152, ell_width=128)),
}

ARCH = ArchSpec(arch_id="paper-ipgc", family="paper",
                make_config=make_config, make_smoke=make_smoke,
                shapes=SHAPES)
