"""Overload shedding at the API admission edge (the port's copy of
``llmq_tpu/api/overload.py``, without the tenancy quotas and the
degradation ladder, which wait for the tenancy and control planes).

Once the backlog exceeds what the engine can serve within the SLA,
accepting more work makes every queued request later; the move that
keeps latency is to reject at the edge, explicitly, with a
``Retry-After`` the client can act on. Three checks, in cost order:

1. **engine down** → 503: the engine loop is restarting (the crash
   supervisor) or gone.
2. **queue backlog** → 429: pending messages across the manager's
   queues reached ``overload.queue_depth_limit`` (default 90% of
   ``queue.max_queue_size``, so clients back off before the hard
   queue-full 503).
3. **deadline headroom** → 429: the estimated wait plus the prompt's
   prefill ETA at the resource scheduler's learned rate already exceeds
   the request's own ``timeout`` × ``deadline_headroom``.

Every shed counts in ``shed_counts`` and in ``requests_shed_total`` (by
reason and code, with ``queue.enable_metrics``) and carries
``Retry-After`` (header and body). ``overload.enabled: false`` builds no
shedder at all.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from llmq_tpu_torch.core.types import Message
from llmq_tpu_torch.metrics.registry import get_metrics

log = logging.getLogger("llmq_tpu_torch.overload")

#: Prompt characters per token of the admission-time estimate.
_CHARS_PER_TOKEN = 4.0


def estimate_prompt_tokens(msg: Any) -> int:
    """Prompt-only token estimate (characters / 4)."""
    return int(len(getattr(msg, "content", "") or "") / _CHARS_PER_TOKEN)


class OverloadShedder:
    def __init__(self, config, queue_config=None, *, engine=None,
                 resource_scheduler=None,
                 enable_metrics: bool = True) -> None:
        #: An OverloadConfig (or anything with its fields).
        self.config = config
        self.engine = engine
        #: Anything with ``prefill_eta_ms(tokens)`` (the resource
        #: scheduler); None: the prefill ETA is 0.
        self.resource_scheduler = resource_scheduler
        self._metrics = get_metrics() if enable_metrics else None
        limit = int(getattr(config, "queue_depth_limit", 0) or 0)
        if limit <= 0 and queue_config is not None:
            limit = int(0.9 * getattr(queue_config, "max_queue_size",
                                      10000))
        self.queue_depth_limit = limit
        self._mu = threading.Lock()
        self.shed_counts = {"backlog": 0, "sla": 0, "engine_down": 0}

    def admit(self, msg: Message, manager=None,
              estimated_wait: float = 0.0) -> None:
        """Raise ``ApiError`` (429/503, with ``retry_after``) when the
        request should be shed; return to admit. ``manager`` None skips
        the backlog check (the SSE path has its own stream gates)."""
        retry_base = max(0.5, float(getattr(self.config, "retry_after",
                                            1.0)))
        eng = self.engine
        if eng is not None and not getattr(eng, "running", True):
            self._shed("engine_down", 503, retry_base,
                       "engine not running on this host (restarting or "
                       "failed) — retry or use another replica")
        depth_limit = self.queue_depth_limit
        if manager is not None and depth_limit > 0:
            try:
                depth = manager.total_pending()
            except Exception:  # noqa: BLE001 — advisory check
                depth = 0
            if depth >= depth_limit:
                self._shed(
                    "backlog", 429,
                    max(retry_base, float(estimated_wait)),
                    f"queue backlog too deep ({depth} pending >= "
                    f"{depth_limit})")
        headroom = float(getattr(self.config, "deadline_headroom", 0.0))
        if headroom > 0 and msg.timeout and msg.timeout > 0:
            eta = float(estimated_wait) + self._prefill_eta_s(msg)
            if eta > msg.timeout * headroom:
                self._shed(
                    "sla", 429,
                    max(retry_base, eta - float(msg.timeout)),
                    f"cannot meet deadline: estimated {eta:.1f}s to "
                    f"first service exceeds the request's "
                    f"{msg.timeout:.1f}s budget")

    def _prefill_eta_s(self, msg: Message) -> float:
        """Learned prefill cost of this prompt (seconds); 0 without a
        resource scheduler or before it has observations."""
        rs = self.resource_scheduler
        if rs is None:
            return 0.0
        est_tokens = estimate_prompt_tokens(msg)
        if est_tokens <= 0:
            return 0.0
        try:
            eta_ms = rs.prefill_eta_ms(est_tokens)
        except Exception:  # noqa: BLE001 — advisory
            return 0.0
        return (eta_ms or 0.0) / 1e3

    def _shed(self, reason: str, code: int, retry_after: float,
              detail: str) -> None:
        from llmq_tpu_torch.api.server import ApiError
        with self._mu:
            self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        if self._metrics is not None:
            self._metrics.requests_shed.labels(reason, str(code)).inc()
        log.warning("shedding request (%s → %d, retry in %.1fs): %s",
                    reason, code, retry_after, detail)
        raise ApiError(code, f"overloaded ({reason}): {detail}",
                       retry_after=retry_after)

    def get_stats(self) -> dict:
        with self._mu:
            return {"queue_depth_limit": self.queue_depth_limit,
                    "shed": dict(self.shed_counts)}


def build_shedder(config, *, engine=None,
                  resource_scheduler=None) -> Optional[OverloadShedder]:
    """An :class:`OverloadShedder` from a full ``Config``, or None when
    ``overload.enabled`` is false."""
    ocfg = getattr(config, "overload", None)
    if ocfg is None or not getattr(ocfg, "enabled", False):
        return None
    qcfg = getattr(config, "queue", None)
    return OverloadShedder(ocfg, qcfg, engine=engine,
                           resource_scheduler=resource_scheduler,
                           enable_metrics=getattr(qcfg, "enable_metrics",
                                                  True))
