"""Config registry; port of ``repro/configs/__init__.py``.

Every architecture of the reference is registered, in its order: the
dense decoders, the MoE family, the audio and vision families and the
recurrent families (recurrentgemma-2b, rwkv6-3b).
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
    "recurrentgemma-2b",
    "rwkv6-3b",
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
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-3b": "rwkv6_3b",
    "arctic-480b": "arctic_480b",
    "granite-3-8b": "granite_3_8b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
