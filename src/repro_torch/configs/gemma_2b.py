"""gemma-2b [arXiv:2403.08295; hf] — GeGLU, head_dim 256, MQA (kv=1)."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="gemma-2b", n_layers=18, d_model=2048, n_heads=8,
        n_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=256000,
        act="gelu_tanh")


def make_smoke_config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="gemma-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512,
        act="gelu_tanh", logit_chunk=64, kv_block=32)


SPEC = ArchSpec("gemma-2b", "lm", "arXiv:2403.08295",
                make_config, make_smoke_config, LM_SHAPES)
