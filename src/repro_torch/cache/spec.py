"""PageSpec — the KV/state cache half of the deployment plan; port of
``repro/cache/spec.py`` (host-side, copied verbatim).

Mirrors ``comm.CollectiveSpec``: a tiny frozen, hashable record with a
string shorthand, parsed once at config time and carried on
``ExecutionPolicy.kv`` so the scheduler, the serving loop, and the
``DeploymentArtifact`` manifest all read one source of truth.

Shorthands::

    dense             no paging: one max_seq-length cache row per slot
    paged:16          16-token pages, bf16 payload
    paged:16:int8     16-token pages, blockwise-int8 quantized payload
    paged:64:int4     64-token pages, nibble-packed int4 payload

Quantized pages reuse ``core/quantization``'s asymmetric min/max scheme
per (token, head) row over head_dim (see ``cache/paged.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """How decode cache memory is laid out for one deployment.

    ``page_size is None`` — dense per-slot rows (the historical layout).
    Otherwise the KV store is a shared pool of ``page_size``-token pages
    indexed through per-slot page tables, with ``bits`` selecting the
    page payload: None (bf16), 8 (uint8 codes + f32 scale/zero per
    token-head row) or 4 (uint32 nibble-packed codes).
    """

    page_size: Optional[int] = None
    bits: Optional[int] = None

    def __post_init__(self):
        if self.page_size is not None and self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.bits is not None:
            if self.page_size is None:
                raise ValueError("kv bits require a page size (quantized "
                                 "pages are a paged-cache feature)")
            if self.bits not in (8, 4):
                raise ValueError(f"kv bits must be 8 or 4, got {self.bits}")

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    def pages_for(self, tokens: int) -> int:
        """Pages covering ``tokens`` cache positions (ceil division)."""
        if not self.paged:
            raise ValueError("dense cache has no pages")
        return max(0, -(-int(tokens) // self.page_size))

    def shorthand(self) -> str:
        if not self.paged:
            return "dense"
        if self.bits is None:
            return f"paged:{self.page_size}"
        return f"paged:{self.page_size}:int{self.bits}"

    @classmethod
    def parse(cls, value: Union["PageSpec", str, None]) -> "PageSpec":
        if value is None:
            return cls()
        if isinstance(value, PageSpec):
            return value
        parts = str(value).split(":")
        if parts[0] == "dense":
            if len(parts) != 1:
                raise ValueError(f"malformed kv spec {value!r}")
            return cls()
        if parts[0] != "paged" or len(parts) not in (2, 3):
            raise ValueError(
                f"unknown kv spec {value!r}, expected 'dense', "
                "'paged:<page_size>' or 'paged:<page_size>:int{8,4}'")
        try:
            page_size = int(parts[1])
        except ValueError:
            raise ValueError(
                f"malformed page size in kv spec {value!r}") from None
        bits = None
        if len(parts) == 3:
            if not parts[2].startswith("int"):
                raise ValueError(f"malformed kv bits in spec {value!r}")
            try:
                bits = int(parts[2][3:])
            except ValueError:
                raise ValueError(
                    f"malformed kv bits in spec {value!r}") from None
        return cls(page_size=page_size, bits=bits)
