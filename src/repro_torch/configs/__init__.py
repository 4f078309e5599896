"""Model configurations of the port, and their registry.

Counterpart of ``repro.configs``: every architecture is a module with
``FULL`` (the published config) and ``SMOKE`` (the same family at tiny
widths), plus ``LONG_500K_SUPPORTED`` and, where that is False,
``SKIP_REASON``, which the (architecture x shape) matrix reads.  The DeiT
classifiers live in ``deit`` (``VIT_IDS``) and are not in the matrix.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.model_api import ModelConfig

ARCH_IDS: List[str] = [
    "llava_next_mistral_7b",
    "recurrentgemma_2b",
    "llama3_8b",
    "deepseek_67b",
    "phi4_mini_3_8b",
    "qwen3_14b",
    "mixtral_8x7b",
    "granite_moe_3b_a800m",
    "xlstm_350m",
    "seamless_m4t_medium",
]

VIT_IDS: List[str] = ["deit_tiny", "deit_small", "deit_base"]

DEFAULT_SKIP_REASON = ("full quadratic attention at 512k context is "
                       "neither sub-quadratic nor in scope")


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def full_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def shape_supported(arch_id: str, shape_name: str) -> bool:
    """The (architecture x shape) applicability matrix: every cell but
    ``long_500k``, which only the sub-quadratic architectures take."""
    if shape_name == "long_500k":
        return getattr(_module(arch_id), "LONG_500K_SUPPORTED", False)
    return True


def skip_reason(arch_id: str, shape_name: str) -> str:
    return getattr(_module(arch_id), "SKIP_REASON", DEFAULT_SKIP_REASON)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: full_config(a) for a in ARCH_IDS}
