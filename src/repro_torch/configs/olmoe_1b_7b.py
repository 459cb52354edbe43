"""olmoe-1b-7b [arXiv:2409.02060; hf] — 16L d2048 16H(kv16) MoE 64e top-8."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=0, vocab_size=50304,
        moe=True, n_experts=64, moe_top_k=8, moe_d_ff=1024, act="silu")


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=512,
        moe=True, n_experts=8, moe_top_k=2, moe_d_ff=32, act="silu",
        logit_chunk=64, kv_block=32)


SPEC = ArchSpec("olmoe-1b-7b", "lm", "arXiv:2409.02060",
                make_config, make_smoke_config, LM_SHAPES)
