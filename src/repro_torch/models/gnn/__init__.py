"""GNN models (``repro/models/gnn``): SchNet, EGNN, GraphSAGE and
EquiformerV2 with its SO(3) machinery, over the edge-list substrate of
``common.py``, as plain PyTorch ops with autograd (the reference has no
Pallas kernel here)."""
