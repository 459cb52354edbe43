"""deepseek-67b [arXiv:2401.02954; hf] — dense llama-arch 95L d8192 64H(kv8)."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=22016, vocab_size=102400, act="silu")


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-67b-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab_size=512, act="silu",
        logit_chunk=64, kv_block=32)


SPEC = ArchSpec("deepseek-67b", "lm", "arXiv:2401.02954",
                make_config, make_smoke_config, LM_SHAPES)
