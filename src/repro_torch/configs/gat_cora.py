"""gat-cora [gnn] n_layers=2 d_hidden=8 n_heads=8 aggregator=attn
[arXiv:1710.10903; paper].  The four shape cells swap the dataset geometry
(d_feat/classes per cell — see configs.common.GNN_SHAPES)."""
from repro_torch.configs.common import gnn_cells
from repro_torch.models.gnn import GATConfig

CONFIG = GATConfig(
    name="gat-cora",
    d_in=1433,
    d_hidden=8,
    n_heads=8,
    n_layers=2,
    n_classes=7,
)


def cells():
    return gnn_cells("gat-cora", CONFIG)
