"""W3C trace-context propagation for the request-lifecycle trace plane
(the port's copy of ``llmq_tpu/observability/trace.py``).

One request owns one trace for its whole life: API ingest, queue,
worker, engine. The trace id is DERIVED from ``Message.id``: a
``uuid4`` string is exactly 32 hex digits once the dashes are stripped,
which is a W3C ``trace-id``, so any process holding the message computes
the same trace id with no coordination, and a ``traceparent`` made here
parses in the JAX package and the reverse.

Format (https://www.w3.org/TR/trace-context/):

    traceparent: 00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import NamedTuple, Optional

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
_HEX32_RE = re.compile(r"^[0-9a-f]{32}$")


class TraceContext(NamedTuple):
    """Parsed ``traceparent`` triple (version is validated, not kept)."""

    trace_id: str   # 32 lowercase hex
    span_id: str    # 16 lowercase hex
    flags: str = "01"

    def to_header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


def trace_id_for(request_id: str) -> str:
    """Deterministic trace id for a request: the uuid's own 32 hex
    digits when the id is a uuid, else a hash of the id — so every
    process derives the SAME trace id from the message alone."""
    hex_id = request_id.replace("-", "").lower()
    if _HEX32_RE.match(hex_id):
        return hex_id
    return hashlib.md5(request_id.encode("utf-8", "replace")).hexdigest()


def new_span_id() -> str:
    return os.urandom(8).hex()


def make_traceparent(request_id: str,
                     span_id: Optional[str] = None) -> str:
    """A ``traceparent`` header value for one hop of this request."""
    return TraceContext(trace_id_for(request_id),
                        span_id or new_span_id()).to_header()


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a ``traceparent`` header; None when absent or malformed
    (a bad header must degrade to local derivation, never error)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None   # invalid per spec
    return TraceContext(trace_id, span_id, flags)
