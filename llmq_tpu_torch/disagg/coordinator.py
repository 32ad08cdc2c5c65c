"""The disaggregation coordinator: the exchange wired into one replica's
planes (the port's copy of ``llmq_tpu/disagg/coordinator.py``).

Every mechanism lives in a plane of its own: the tiering plane
serializes, injects and owns the worker (``export_to_exchange``,
``prepare(remote=True)``), the engine fires ``on_conversation_cached``
when a finished turn's KV is pinned and ``demote_conversation`` turns
the pin into a plane entry, and the cluster router places turns by role.
The coordinator is the role policy: who publishes (a prefill replica
after each finished turn; anyone at drain), who claims (setting
``plane.exchange``), and the restart rehydration.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from llmq_tpu_torch.disagg.exchange import KVExchange

log = logging.getLogger("llmq_tpu_torch.disagg")


class DisaggCoordinator:
    """One replica's disaggregation wiring (see :func:`build_disagg`)."""

    def __init__(self, cfg: Any, engine: Any,
                 exchange: Optional[KVExchange]) -> None:
        #: The DisaggConfig block.
        self.cfg = cfg
        self.role = str(cfg.role)
        self.engine = engine
        self.exchange = exchange
        plane = getattr(engine, "_tiering", None)
        self.plane = plane
        engine.disagg_role = self.role
        if exchange is not None and plane is not None:
            # The receive path: a remote prepare's local miss becomes a
            # claim on the plane's worker.
            plane.exchange = exchange
        if (self.role == "prefill"
                and bool(getattr(cfg, "publish_on_finish", True))
                and exchange is not None and plane is not None):
            engine.on_conversation_cached = self._publish_turn

    def _publish_turn(self, conv_id: str) -> None:
        """Engine hook (engine thread, a finished turn's KV pinned):
        demote the pin into a plane entry, then queue its publication.
        The worker is FIFO, so the demote's copy ends before the publish
        job reads the payload."""
        try:
            self.engine.demote_conversation(conv_id)
            if self.plane is not None:
                self.plane.export_to_exchange(conv_id)
        except Exception:  # noqa: BLE001 — the decode side recomputes
            log.exception("exchange publish hook failed for %s", conv_id)

    def publish_warm(self) -> int:
        """Drain-time migration: publish every warm conversation, pinned
        or already held by the plane, so peers resume them from the store
        tier instead of by recompute. Any role may call it. Returns the
        number of publish jobs queued."""
        plane = self.plane
        if plane is None or self.exchange is None:
            return 0
        for cid in self.engine.cached_conversations():
            try:
                self.engine.demote_conversation(cid)
            except Exception:  # noqa: BLE001 — the next one migrates
                log.exception("drain demote failed for %s", cid)
        with plane._mu:
            held = list(plane._entries.keys())
        n = sum(1 for cid in held if plane.export_to_exchange(cid))
        if n:
            log.info("drain: published %d warm conversation(s) to the "
                     "kv exchange", n)
        return n

    def rehydrate(self) -> int:
        """Restart recovery: adopt the owned spilled blobs again, so
        re-arrivals hit the store tier."""
        try:
            return int(self.engine.rehydrate_tiered_conversations())
        except Exception:  # noqa: BLE001 — recovery is best-effort
            log.exception("disagg rehydrate failed")
            return 0

    def stats(self) -> dict:
        out = {"role": self.role,
               "exchange": self.exchange is not None,
               "tiering": self.plane is not None}
        if self.exchange is not None:
            out.update(self.exchange.stats())
        return out


def build_disagg(cfg: Any, engine: Any, store: Any, *,
                 enable_metrics: bool = True
                 ) -> Optional[DisaggCoordinator]:
    """The replica's disaggregation wiring from the full config, or None
    when ``disagg.enabled`` is false (nothing built, no engine hook
    touched). ``store`` is the conversation store; without its
    KV-payload seam, or without the tiering plane, the replica still
    takes a role (the router steers by it) but every handoff recomputes,
    and a warning says so."""
    dcfg = cfg.disagg
    if not dcfg.enabled:
        return None
    exchange: Optional[KVExchange] = None
    if store is not None and hasattr(store, "save_kv"):
        exchange = KVExchange(
            store, role=dcfg.role, claim_ttl_s=dcfg.claim_ttl_s,
            miss_ttl_s=dcfg.miss_ttl_s, metrics=enable_metrics)
    else:
        log.warning("disagg enabled but the conversation store has no "
                    "KV-payload seam; role routing only (no exchange)")
    if getattr(engine, "_tiering", None) is None:
        log.warning("disagg enabled without executor.kv_tiering — KV "
                    "handoffs will recompute from history text "
                    "(enable kv_tiering for store-tier handoffs)")
    coord = DisaggCoordinator(dcfg, engine, exchange)
    if dcfg.rehydrate_on_start:
        coord.rehydrate()
    return coord
