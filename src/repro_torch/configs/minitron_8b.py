"""Minitron-8B: width-pruned Nemotron-4 dense GQA [arXiv:2407.14679]."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=1e4,
    block_pattern=(BlockKind.ATTN,),
    source="arXiv:2407.14679",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=320, vocab_size=640, dtype="float32",
    )
