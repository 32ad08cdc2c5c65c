"""Radix-tree prefix KV cache (block-granular sharing over the paged
allocator). See :mod:`llmq_tpu_torch.prefixcache.radix`."""

from llmq_tpu_torch.prefixcache.radix import (
    EVICTION_POLICIES,
    PrefixCache,
    PrefixMatch,
    RadixNode,
)

__all__ = [
    "EVICTION_POLICIES",
    "PrefixCache",
    "PrefixMatch",
    "RadixNode",
]
