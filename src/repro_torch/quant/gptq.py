"""Offline model-quantization entry point for trained dense params; port
of ``repro/quant/gptq.py``.

``quantize_model`` wraps the plan compiler's quantize and layout stages
(``plan/compiler.compile_params``), the one pipeline that also backs
``Model.init`` and ``prepare``, so a trained checkpoint and a random init
take the same path to deployment-ready ``PlannedPair``s.  Act-order is
emulated by a random processing order (paper Eq. 2); callers with real
calibration data pass per-pair Hessians to ``core/reorder.plan_pair``
(``use_gptq=True``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.plan import compiler


def quantize_model(cfg: ModelConfig, params: Any, *,
                   scheme: Optional[str] = None,
                   group_size: Optional[int] = None,
                   act_order: Optional[bool] = None,
                   generator: Optional[torch.Generator] = None) -> Any:
    """Dense params -> deployment params with quantized MLP pairs.

    Defaults come from ``cfg.quant``; attention, embeddings and norms stay
    dense (the attention fold is ``compiler.stage_fold_attention``'s).
    ``generator`` draws the processing orders (default: seed 0 on the
    CPU, as ``compile_params``)."""
    overrides = {}
    if scheme is not None:
        overrides["scheme"] = scheme
    if group_size is not None:
        overrides["group_size"] = group_size
    if act_order is not None:
        overrides["act_order"] = act_order
    qcfg = cfg.with_quant(**overrides) if overrides else cfg
    return compiler.compile_params(qcfg, params, generator=generator)
