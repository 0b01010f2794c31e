"""xLSTM-350M: sLSTM + mLSTM block stack [arXiv:2405.04517; unverified].
The 350M band uses an xLSTM[7:1]-style ratio: each 8-block unit holds 7
mLSTM blocks and 1 sLSTM block. xLSTM blocks carry their own up/down
projections, so d_ff = 0 (no separate MLP)."""
from repro_torch.models.config import BlockKind, ModelConfig

_M, _S = BlockKind.MLSTM, BlockKind.SLSTM

CONFIG = ModelConfig(
    name="xlstm-350m",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    block_pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab_size=384, block_pattern=(_M, _M, _M, _S), dtype="float32",
    )
