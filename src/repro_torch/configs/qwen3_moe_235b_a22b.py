"""Qwen3-MoE-235B-A22B: 128 routed experts top-8, no shared experts
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # (unused dense path; experts carry the FFN)
    d_ff_expert=1536,
    vocab_size=151936,
    n_experts=128,
    n_experts_active=8,
    n_shared_experts=0,
    rope_theta=1e6,
    block_pattern=(BlockKind.MOE,),
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=96, n_heads=8, n_kv_heads=2, head_dim=12,
        d_ff=64, d_ff_expert=64, vocab_size=384, n_experts=8,
        n_experts_active=2, dtype="float32",
    )
