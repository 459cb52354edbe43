"""dlrm-rm2 [arXiv:1906.00091; paper] — 13 dense, 26 sparse, embed 64,
bot 13-512-256-64, top 512-512-256-1, dot interaction."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="dlrm-rm2", arch="dlrm", n_dense=13, n_sparse=26,
                        embed_dim=64, vocab_per_field=1_000_000,
                        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))


def make_smoke_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="dlrm-smoke", arch="dlrm", n_dense=4, n_sparse=6,
                        embed_dim=8, vocab_per_field=100,
                        bot_mlp=(16, 8), top_mlp=(16, 8, 1))


SPEC = ArchSpec("dlrm-rm2", "recsys", "arXiv:1906.00091",
                make_config, make_smoke_config, RECSYS_SHAPES)
