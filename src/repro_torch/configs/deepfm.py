"""deepfm [arXiv:1703.04247; paper] — 39 sparse, embed 10, MLP 400x3, FM."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="deepfm", arch="deepfm", n_dense=0, n_sparse=39,
                        embed_dim=10, vocab_per_field=1_000_000,
                        mlp_dims=(400, 400, 400))


def make_smoke_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="deepfm-smoke", arch="deepfm", n_dense=0,
                        n_sparse=8, embed_dim=4, vocab_per_field=100,
                        mlp_dims=(16, 16))


SPEC = ArchSpec("deepfm", "recsys", "arXiv:1703.04247",
                make_config, make_smoke_config, RECSYS_SHAPES)
