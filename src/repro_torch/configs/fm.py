"""fm [ICDM'10 (Rendle); paper] — 39 sparse, embed 10, pairwise via O(nk)
sum-square trick. Exactly the paper's SEP-LR model class."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig


def make_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="fm", arch="fm", n_dense=0, n_sparse=39,
                        embed_dim=10, vocab_per_field=1_000_000)


def make_smoke_config(**kw) -> RecsysConfig:
    return RecsysConfig(name="fm-smoke", arch="fm", n_dense=0, n_sparse=8,
                        embed_dim=4, vocab_per_field=100)


SPEC = ArchSpec("fm", "recsys", "ICDM'10 Rendle",
                make_config, make_smoke_config, RECSYS_SHAPES)
