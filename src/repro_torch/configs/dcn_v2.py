"""dcn-v2 [arXiv:2008.13535; paper] — 13 dense, 26 sparse, embed 16,
3 cross layers, MLP 1024-1024-512."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="dcn-v2", arch="dcn_v2", n_dense=13, n_sparse=26,
                        embed_dim=16, vocab_per_field=1_000_000,
                        mlp_dims=(1024, 1024, 512), n_cross_layers=3)


def make_smoke_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="dcn-v2-smoke", arch="dcn_v2", n_dense=4,
                        n_sparse=6, embed_dim=4, vocab_per_field=100,
                        mlp_dims=(16, 8), n_cross_layers=2)


SPEC = ArchSpec("dcn-v2", "recsys", "arXiv:2008.13535",
                make_config, make_smoke_config, RECSYS_SHAPES)
