"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b; unverified] — dense MHA."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32,
        n_kv_heads=32, head_dim=80, d_ff=6912, vocab_size=50304, act="silu")


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, act="silu",
        logit_chunk=64, kv_block=32)


SPEC = ArchSpec("stablelm-3b", "lm", "hf:stabilityai/stablelm-2-1_6b",
                make_config, make_smoke_config, LM_SHAPES)
