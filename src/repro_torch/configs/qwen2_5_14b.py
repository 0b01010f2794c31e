"""Qwen2.5-14B: dense GQA decoder with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=(BlockKind.ATTN,),
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, dtype="float32",
    )
