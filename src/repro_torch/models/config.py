"""Architecture configuration schema (the port's copy of the reference
package's ``repro.models.config``; it imports nothing of it).

One frozen dataclass describes every supported architecture family; the
per-arch modules in ``repro_torch.configs`` instantiate it with the exact
published numbers. ``block_pattern`` cycles over layers (e.g. gemma3's 5 local : 1
global attention); heterogeneous stacks (xLSTM mLSTM/sLSTM mixes, hybrid
attn+SSM) are expressed the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "BlockKind"]


class BlockKind:
    ATTN = "attn"  # full causal GQA attention + MLP
    ATTN_LOCAL = "attn_local"  # sliding-window GQA attention + MLP
    MOE = "moe"  # GQA attention + mixture-of-experts FFN
    MAMBA = "mamba"  # mamba-style selective SSM + MLP
    HYMBA = "hymba"  # parallel attention & mamba heads (+ MLP)
    HYMBA_LOCAL = "hymba_local"  # hymba with sliding-window attention half
    MLSTM = "mlstm"  # xLSTM matrix-memory block (no separate MLP)
    SLSTM = "slstm"  # xLSTM scalar-memory block (recurrent)

    ALL = (ATTN, ATTN_LOCAL, MOE, MAMBA, HYMBA, HYMBA_LOCAL, MLSTM, SLSTM)

    RECURRENT = (MAMBA, MLSTM, SLSTM)  # O(1)-state decode
    SUBQUADRATIC = (MAMBA, HYMBA_LOCAL, MLSTM, SLSTM, ATTN_LOCAL)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads

    # layer composition
    block_pattern: Tuple[str, ...] = (BlockKind.ATTN,)
    window: Optional[int] = None  # sliding window for *_local blocks

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    d_ff_expert: Optional[int] = None
    moe_dispatch: str = "onehot"  # "onehot" (GShard-style) | "sort" (optimized)
    moe_capacity_factor: float = 1.25

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_local: Optional[float] = None  # sliding-window layers (gemma3)

    # encoder-decoder (0 = decoder-only)
    encoder_layers: int = 0

    # modality frontend stubs (precomputed embeddings via input_specs)
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # SSM / xLSTM
    ssm_state: int = 16
    ssm_expand: int = 2
    conv_kernel: int = 4

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True  # False: unrolled (dry-run cost extrapolation)
    # beyond-paper perf levers (§Perf iterations; baseline = none):
    #   "hoist_rope"    — compute RoPE tables once per step, not per layer
    #   "bf16_boundary" — pin TP partial-sum resolution (REFUTED, see §Perf)
    #   "act_pin"       — pin block activations to the Megatron layout
    #   "gqa_grouped"   — GQA attention without KV head replication
    opt_flags: Tuple[str, ...] = ()

    def opt(self, flag: str) -> bool:
        return flag in self.opt_flags
    # notes for DESIGN / roofline bookkeeping
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        for b in self.block_pattern:
            if b not in BlockKind.ALL:
                raise ValueError(f"{self.name}: unknown block kind {b}")
        if BlockKind.MOE in self.block_pattern and not self.n_experts:
            raise ValueError(f"{self.name}: MoE blocks need n_experts")

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_units(self) -> int:
        """Number of full pattern repetitions scanned over."""
        return self.n_layers // self.pattern_len

    @property
    def tail_blocks(self) -> Tuple[str, ...]:
        """Leftover layers when n_layers % pattern_len != 0."""
        return self.block_pattern[: self.n_layers % self.pattern_len]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        full = self.block_pattern * self.n_units + self.tail_blocks
        return full

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True when no layer holds an unbounded full-attention KV cache
        (pure recurrent / windowed stacks), or when only a bounded fraction
        does (gemma-style local:global mixes are retained; see DESIGN.md)."""
        kinds = set(self.layer_kinds)
        quad = {BlockKind.ATTN, BlockKind.MOE, BlockKind.HYMBA}
        n_quad = sum(1 for k in self.layer_kinds if k in quad)
        return n_quad <= self.n_layers // 4

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced-config constructor for smoke tests."""
        return dataclasses.replace(self, **overrides)

    # -- parameter counting (for 6ND roofline bookkeeping) --------------
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d, hd = cfg.d_model, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    total = cfg.vocab_size * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    if cfg.frontend:
        total += cfg.frontend_dim * d

    def attn_params() -> int:
        p = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if cfg.qkv_bias:
            p += H * hd + 2 * Hkv * hd
        return p

    def mlp_params(ff: int) -> int:
        return 3 * d * ff  # gated (swiglu) MLP

    def moe_params() -> int:
        ffe = cfg.d_ff_expert or cfg.d_ff
        experts = cfg.n_experts if not active_only else cfg.n_experts_active
        p = d * cfg.n_experts  # router
        p += experts * 3 * d * ffe
        p += cfg.n_shared_experts * 3 * d * ffe
        return p

    def mamba_params() -> int:
        di = cfg.ssm_expand * d
        return (
            d * 2 * di  # in_proj
            + di * cfg.conv_kernel  # depthwise conv
            + di * (2 * cfg.ssm_state + 1)  # x_proj (B, C, dt)
            + di * cfg.ssm_state  # A_log
            + di  # D
            + di * d  # out_proj
        )

    def mlstm_params() -> int:
        di = cfg.ssm_expand * d
        return d * 2 * di + 3 * di * di + 2 * di * cfg.n_heads + di * d

    def slstm_params() -> int:
        nh = cfg.n_heads
        dh = d // nh
        return 4 * d * d + 4 * nh * dh * dh + (cfg.d_ff and 3 * d * cfg.d_ff or 2 * d * d)

    for kind in cfg.layer_kinds:
        total += 2 * d  # norms
        if kind in (BlockKind.ATTN, BlockKind.ATTN_LOCAL):
            total += attn_params() + mlp_params(cfg.d_ff)
        elif kind == BlockKind.MOE:
            total += attn_params() + moe_params()
        elif kind == BlockKind.MAMBA:
            total += mamba_params() + mlp_params(cfg.d_ff)
        elif kind in (BlockKind.HYMBA, BlockKind.HYMBA_LOCAL):
            total += attn_params() + mamba_params() + mlp_params(cfg.d_ff)
        elif kind == BlockKind.MLSTM:
            total += mlstm_params()
        elif kind == BlockKind.SLSTM:
            total += slstm_params()
    # encoder stack (attention, non-causal) + cross-attention in decoder
    if cfg.is_encdec:
        total += cfg.encoder_layers * (2 * d + attn_params() + mlp_params(cfg.d_ff))
        total += cfg.n_layers * (d + attn_params())  # cross-attn per dec layer
    total += d  # final norm
    return int(total)
