"""Registry of the ported architectures: the four recsys models, each a
published configuration with its smoke configuration and shape cells.
The LM and GNN architectures come with their models."""
from repro_torch.configs import dcn_v2, deepfm, dlrm_rm2, fm
from repro_torch.configs.base import ArchSpec

REGISTRY = {spec.arch_id: spec
            for spec in [deepfm.SPEC, dcn_v2.SPEC, dlrm_rm2.SPEC, fm.SPEC]}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
