"""Qwen1.5/2-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,  # dense-equivalent (shared expert path)
    d_ff_expert=1408,
    vocab_size=151936,
    n_experts=60,
    n_experts_active=4,
    n_shared_experts=4,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=(BlockKind.MOE,),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, d_ff_expert=32, vocab_size=384, n_experts=8,
        n_experts_active=2, n_shared_experts=2, dtype="float32",
    )
