"""ExecutionPolicy, the a-priori deployment plan; port of
``repro/core/policy.py``.

``backend`` keys the kernel registry (``kernels/dispatch.py``);
``collective`` is a ``CollectiveSpec`` or a per-layer ``CollectivePlan``
(or a shorthand of either) that ``comm/dispatch.py`` runs at each row-TP
epilogue; ``kv`` is a ``PageSpec`` (the decode cache's layout:
``dense`` or ``paged:N[:int8|:int4]``); ``mesh`` is a ``MeshPlan``
(``dpNxtpM[xepK]``): the grid the plan is served on, of which an
engine checks the TP degree against its ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.cache.spec import PageSpec
from repro_torch.comm.spec import (CollectivePlan, CollectiveSpec,
                                   parse_collective)
from repro_torch.dist.topology import MeshPlan

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class KernelTiling:
    """Tiling knobs of the CUDA dequant-GEMM.  None yet: the kernel picks
    its K step (``dequant_matmul.pick_block_k``), row tile and K split
    from the shape and the card."""


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """The runtime execution contract for a quantized deployment."""

    scheme: str = "tp-aware"
    backend: str = "torch"          # key into kernels.dispatch registry
    compute_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32
    collective: Union[CollectiveSpec, CollectivePlan, str] = CollectiveSpec()
    tiling: KernelTiling = KernelTiling()
    # Decode-cache layout (``PageSpec``): dense per-slot rows, or a shared
    # page pool ("paged:16", "paged:16:int8", ...); shorthands parse in
    # __post_init__, as ``collective`` does.
    kv: Any = None
    mesh: Any = None

    def __post_init__(self):
        from repro_torch.core.reorder import SCHEMES

        if self.scheme not in SCHEMES:
            raise ValueError(
                f"unknown scheme {self.scheme!r}, expected one of {SCHEMES}")
        for field in ("compute_dtype", "accum_dtype"):
            dt = getattr(self, field)
            if isinstance(dt, str):
                if dt not in _DTYPES:
                    raise ValueError(f"unknown {field} {dt!r}, expected one "
                                     f"of {sorted(_DTYPES)}")
                object.__setattr__(self, field, _DTYPES[dt])
        if self.accum_dtype != torch.float32:
            raise ValueError("the dequant-GEMMs accumulate in float32 only, "
                             f"got accum_dtype={self.accum_dtype}")
        object.__setattr__(self, "collective",
                           parse_collective(self.collective))
        object.__setattr__(self, "kv", PageSpec.parse(self.kv))
        object.__setattr__(self, "mesh", MeshPlan.parse(self.mesh))

    def with_(self, **kw) -> "ExecutionPolicy":
        return dataclasses.replace(self, **kw)

    @classmethod
    def auto(cls, scheme: str = "tp-aware", *,
             device: Optional[torch.device] = None,
             **overrides) -> "ExecutionPolicy":
        """The CUDA kernel for ordered layouts whose tensors live on the
        card, else the plain ``torch`` path (mirrors the reference's
        pallas-on-TPU rule).  The naive ``g_idx`` layout takes ``torch``
        even on the card, as the reference takes ``jnp``; its CUDA kernel
        runs when ``backend="cuda"`` is asked for."""
        on_cuda = device is not None and torch.device(device).type == "cuda"
        ordered = scheme != "naive-actorder"
        backend = "cuda" if (on_cuda and ordered) else "torch"
        return cls(scheme=scheme, backend=backend, **overrides)

    @classmethod
    def from_config(cls, cfg, *, device: Optional[torch.device] = None
                    ) -> "ExecutionPolicy":
        """The plan recorded in a ``ModelConfig`` (its ``quant``) or a
        ``QuantConfig``; ``backend="auto"`` resolves for ``device``."""
        qc = getattr(cfg, "quant", cfg)
        kv = PageSpec(page_size=qc.kv_page_size, bits=qc.kv_bits)
        kw = dict(compute_dtype=qc.compute_dtype, collective=qc.collective,
                  kv=kv)
        if qc.backend == "auto":
            return cls.auto(qc.scheme, device=device, **kw)
        return cls(scheme=qc.scheme, backend=qc.backend, **kw)


DEFAULT_POLICY = ExecutionPolicy()


def resolve_policy(policy: Optional[ExecutionPolicy] = None
                   ) -> ExecutionPolicy:
    """``policy`` if given, else the defaults."""
    return policy if policy is not None else DEFAULT_POLICY
