"""Paged KV cache subsystem; port of ``repro/cache`` (DESIGN.md §9).

``PageSpec`` (the policy knob) -> ``PagedCacheManager`` (host page
tables, prefix sharing, reservations) -> ``paged`` (device pool,
gather/scatter, quantized page codec, in torch) on top of
``PageAllocator`` / ``PrefixStore``.  The host-side modules are the
reference's, copied.
"""

from repro_torch.cache.allocator import OutOfPages, PageAllocator
from repro_torch.cache.manager import PagedCacheManager
from repro_torch.cache.prefix import PrefixStore, chain_keys
from repro_torch.cache.spec import PageSpec

__all__ = [
    "OutOfPages", "PageAllocator", "PagedCacheManager", "PrefixStore",
    "chain_keys", "PageSpec",
]
