"""Gemma3-27B: dense GQA with 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]. head_dim=128 per the public config
(attention width independent of d_model)."""
from repro_torch.models.config import BlockKind, ModelConfig

_L, _G = BlockKind.ATTN_LOCAL, BlockKind.ATTN

CONFIG = ModelConfig(
    name="gemma3-27b",
    n_layers=62,  # 10 full 5:1 units + 2 tail local layers
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    rope_theta=1e6,  # global layers
    rope_theta_local=1e4,  # sliding-window layers
    window=1024,
    block_pattern=(_L, _L, _L, _L, _L, _G),
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=8,  # one unit + 2-layer tail, keeps the 5:1 + tail topology
        d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=512, window=32, dtype="float32",
    )
