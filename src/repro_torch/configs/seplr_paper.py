"""The paper's own model class: SEP-LR catalogues at the scales of its
experiments (§4.1 CF, §4.2 Uniprot, §4.4 LSHTC), generated from a seed by
``repro_torch.core.seplr.random_model``. ``chip_smoke.py`` reads its
catalogue sizes from here."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SepLRBenchConfig:
    name: str
    num_targets: int
    rank: int
    distribution: str = "normal"
    sparsity: float = 0.0


# paper-scale stand-ins, generated (nothing is downloaded)
CF_DATASETS = (
    SepLRBenchConfig("audioscrobbler-like", 47085, 50, "lognormal", 0.99),
    SepLRBenchConfig("bookcrossing-like", 105283, 50, "lognormal", 0.995),
    SepLRBenchConfig("movielens100k-like", 1682, 50, "normal", 0.94),
    SepLRBenchConfig("movielens1m-like", 3952, 50, "normal", 0.96),
    SepLRBenchConfig("recipes-like", 381, 50, "lognormal", 0.9),
)

UNIPROT_LIKE = SepLRBenchConfig("uniprot-like", 21274, 500, "lowrank_spectrum")
LSHTC_LIKE = SepLRBenchConfig("lshtc-like", 325056, 100, "lowrank_spectrum")

