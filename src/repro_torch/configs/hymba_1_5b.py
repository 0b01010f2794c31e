"""Hymba-1.5B: hybrid-head blocks running attention and SSM heads in
parallel [arXiv:2411.13676]. Most layers use sliding-window attention on the
attention half; every 8th layer is global (the paper keeps 3 global layers:
first / middle / last — approximated here by the pattern tail)."""
from repro_torch.models.config import BlockKind, ModelConfig

_HL, _HG = BlockKind.HYMBA_LOCAL, BlockKind.HYMBA

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    window=1024,
    rope_theta=1e4,
    block_pattern=(_HG, _HL, _HL, _HL, _HL, _HL, _HL, _HL),
    source="arXiv:2411.13676",
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=4, d_model=100, n_heads=5, n_kv_heads=5, head_dim=20,
        d_ff=192, vocab_size=384, window=32, ssm_state=8,
        block_pattern=(_HG, _HL, _HL, _HL), dtype="float32",
    )
