"""pna [arXiv:2004.05718; paper] — 4L d75, mean/max/min/std x id/amp/atten."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import PNAConfig


def make_config(d_feat: int = 1433, n_classes: int = 7, task: str = "node",
                **kw) -> PNAConfig:
    return PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=d_feat,
                     n_classes=n_classes, task=task)


def make_smoke_config(**kw) -> PNAConfig:
    return PNAConfig(name="pna-smoke", n_layers=2, d_hidden=16, d_in=8,
                     n_classes=3)


SPEC = ArchSpec("pna", "gnn", "arXiv:2004.05718",
                make_config, make_smoke_config, GNN_SHAPES)
