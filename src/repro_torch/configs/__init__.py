"""Registry of the ported architectures: the five LMs (three dense, two
MoE), the GNN (PNA) and the four recsys models, each a published
configuration with its smoke configuration and shape cells, in the
reference's order (so that :func:`all_cells` yields its cells in the
reference's order)."""
from repro_torch.configs import (dcn_v2, deepfm, deepseek_67b, dlrm_rm2, fm,
                                 gemma_2b, llama4_scout_17b_a16e, olmoe_1b_7b,
                                 pna, stablelm_3b)
from repro_torch.configs.base import ArchSpec

REGISTRY = {spec.arch_id: spec
            for spec in [olmoe_1b_7b.SPEC, llama4_scout_17b_a16e.SPEC,
                         deepseek_67b.SPEC, gemma_2b.SPEC, stablelm_3b.SPEC,
                         pna.SPEC, deepfm.SPEC, dcn_v2.SPEC, dlrm_rm2.SPEC,
                         fm.SPEC]}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells():
    """Every (arch x shape) cell of the dry run, 40 in all."""
    for arch_id, spec in REGISTRY.items():
        for cell in spec.shapes:
            yield arch_id, cell.name
