"""Architecture configs the port runs: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)`` / ``list_archs()``.

The port's copies of the reference package's ``repro.configs`` modules for
every language-model architecture it registers (attention, sliding-window
attention, the mixture of experts, mamba-style SSD heads, hymba's parallel
pair, xLSTM's mLSTM and sLSTM blocks, the encoder-decoder stack of
seamless-m4t-large-v2 and the vision frontend of internvl2-2b). Each module
defines ``CONFIG`` (the published numbers) and ``smoke_config()`` (a
reduced same-family config for CPU tests). The reference's ``gdaps-wlcg``
entry (the paper's calibration pipeline, not a language model) is not
registered yet (ROADMAP A). qwen3-moe-235b-a22b is registered, but at full width
it fits no single card (470 GB in bf16) and its 16 query heads a KV head
pass the decode kernel's 8 (ROADMAP B): it runs at its smoke config.

Training on the card: tinyllama-1.1b and hymba-1.5b at full width, and
qwen2-moe-a2.7b at full width and reduced depth (2 of its 24 layers: the
full depth's weights and AdamW moments, 143 GB, fit no single card). The
CPU tests hold training at the smoke configs of those three and of
qwen3-moe-235b-a22b against the reference. The dense D = 128 configs'
attention backward runs on the card; their full-width training does not
fit one card (ROADMAP A); xLSTM training and the training of the
encoder-decoder and vision configs are not held against the reference yet
(ROADMAP A).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

__all__ = ["get_config", "get_smoke_config", "list_archs"]

_ARCHS = {
    "qwen2.5-14b": "qwen2_5_14b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "minitron-8b": "minitron_8b",
    "gemma3-27b": "gemma3_27b",
    "internvl2-2b": "internvl2_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-350m": "xlstm_350m",
}


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(
            f"unknown or unported arch {arch!r}; the port runs {sorted(_ARCHS)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
