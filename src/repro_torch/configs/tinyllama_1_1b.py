"""TinyLlama-1.1B: llama2-architecture small dense GQA [arXiv:2401.02385]."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=1e4,
    block_pattern=(BlockKind.ATTN,),
    source="arXiv:2401.02385",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=3, d_model=96, n_heads=8, n_kv_heads=2, head_dim=12,
        d_ff=192, vocab_size=384, dtype="float32",
    )
