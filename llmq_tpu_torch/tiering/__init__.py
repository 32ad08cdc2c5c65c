"""Tiered KV plane: HBM → pinned host memory → store (``plane.py``)."""

from llmq_tpu_torch.tiering.plane import (
    TIERS,
    HostTierPool,
    KVTieringPlane,
    PagePayload,
    TierEntry,
    blob_meta,
    decode_blob,
    encode_blob,
    flush_metrics,
    pack_pages,
    page_payload_nbytes,
    unpack_pages,
)

__all__ = [
    "TIERS",
    "HostTierPool",
    "KVTieringPlane",
    "PagePayload",
    "TierEntry",
    "blob_meta",
    "decode_blob",
    "encode_blob",
    "flush_metrics",
    "pack_pages",
    "page_payload_nbytes",
    "unpack_pages",
]
