"""Config registry; port of ``repro/configs/__init__.py``.

Only the architectures the port serves so far are registered; the others
follow the order in ``ROADMAP.md``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, QuantConfig, smoke_reduce)

ARCH_IDS = ("qwen3-4b",)

_MODULES = {"qwen3-4b": "qwen3_4b"}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{sorted(_MODULES)} (see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
