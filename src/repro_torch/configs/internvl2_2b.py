"""InternVL2-2B: InternViT frontend (stub embeddings) + InternLM2-1.8B
backbone [arXiv:2404.16821]. The vision tower is provided as precomputed
patch embeddings via input_specs per the assignment."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1e6,
    block_pattern=(BlockKind.ATTN,),
    frontend="vision",
    frontend_tokens=256,  # 448x448 / 14 patch / pixel-shuffle 4 -> 256 tokens
    frontend_dim=1024,  # InternViT-300M hidden
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=512, frontend_tokens=16, frontend_dim=48,
        dtype="float32",
    )
