"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d5120 40H(kv8) d_ff 8192 vocab 202048, MoE 16e top-1."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, head_dim=128, d_ff=0, vocab_size=202048,
        moe=True, n_experts=16, moe_top_k=1, moe_d_ff=8192, act="silu")


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=0, vocab_size=512,
        moe=True, n_experts=4, moe_top_k=1, moe_d_ff=64, act="silu",
        logit_chunk=64, kv_block=32)


SPEC = ArchSpec("llama4-scout-17b-a16e", "lm",
                "hf:meta-llama/Llama-4-Scout-17B-16E",
                make_config, make_smoke_config, LM_SHAPES)
