"""Config registry; port of ``repro/configs/__init__.py``.

The dense decoders, the MoE family and the audio and vision families
are registered, in the reference's order; the recurrent families follow
the order in ``ROADMAP.md``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, QuantConfig, smoke_reduce)

ARCH_IDS = (
    "llama-3.2-vision-90b",
    "qwen3-moe-235b-a22b",
    "qwen3-4b",
    "mistral-large-123b",
    "whisper-large-v3",
    "starcoder2-3b",
    "arctic-480b",
    "granite-3-8b",
)

_MODULES = {
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-4b": "qwen3_4b",
    "mistral-large-123b": "mistral_large_123b",
    "whisper-large-v3": "whisper_large_v3",
    "starcoder2-3b": "starcoder2_3b",
    "arctic-480b": "arctic_480b",
    "granite-3-8b": "granite_3_8b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{sorted(_MODULES)} (see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
