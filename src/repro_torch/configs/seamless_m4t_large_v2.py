"""SeamlessM4T-large-v2: speech/text encoder-decoder [arXiv:2308.11596].
The w2v-BERT speech frontend is a stub (precomputed frame embeddings feed
the 24-layer text-free encoder); the 24-layer decoder cross-attends."""
from repro_torch.models.config import BlockKind, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    n_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=1e4,
    block_pattern=(BlockKind.ATTN,),
    frontend="audio",
    frontend_tokens=1024,  # speech frames after frontend striding
    frontend_dim=1024,
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, encoder_layers=2, d_model=96, n_heads=8, n_kv_heads=8,
        head_dim=12, d_ff=192, vocab_size=384, frontend_tokens=24,
        frontend_dim=48, dtype="float32",
    )
