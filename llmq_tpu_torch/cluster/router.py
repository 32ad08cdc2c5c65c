"""Replica-set routing (the port's copy of ``llmq_tpu/cluster/router.py``):
the dispatch of the cluster plane, built from ``cluster.peers`` by
:func:`llmq_tpu_torch.cluster.build_cluster_router` and installed as the
workers' ``process_fn`` in ``serve`` and ``gateway``.

- **Affinity** (``cluster.affinity: prefix``): a follow-up turn routed
  to another replica prefills again what the first replica's radix tree
  would have served. The router keys affinity on the conversation's
  placement record, kept in the state manager beside the engine's prefix
  handle, so turn N+1 lands where turn N's KV is. When that replica is
  saturated (``spill_load``), draining or behind an open breaker, the
  dispatch spills to the best other replica by the load balancer's
  strategy. ``session`` uses the load balancer's session map instead,
  ``none`` the strategy alone.
- **Failover**: a replica that fails within a dispatch (unreachable, a
  5xx) is charged an error and the message goes to another replica in
  the same worker call, up to ``failover_retries`` and the worker's
  deadline. A deadline miss (TimeoutError) never fails over: the work
  may have run, and running it again would deliver twice; it takes the
  worker's retry path, with the dead-letter queue behind it.
- **Drain**: :meth:`ClusterRouter.drain_endpoint` stops new dispatch to
  a replica (affinity included) while its in-flight calls finish.

Each endpoint has a circuit breaker (``cluster.breaker``): selection
skips an endpoint whose breaker blocks, the HTTP transport gates and
feeds its own endpoint's breaker, and the router does both for local
engines. Metrics: ``cluster_dispatch_total{endpoint,reason}``,
``cluster_affinity_hit_rate``, ``cluster_failovers_total{endpoint}``,
``cluster_drains_total{endpoint}``, ``cluster_endpoints{status}``, and
the breakers' ``circuit_breaker_state`` and
``circuit_breaker_trips_total``.

With ``disagg`` set (the disaggregation plane on), the first pick of a
dispatch steers by role: a follow-up turn (``history_text`` on the
message, or a recorded placement) prefers decode replicas, a first turn
prefers prefill replicas when its learned prefill ETA
(``prefill_eta``, the resource scheduler's) reaches
``disagg.long_prompt_ms``, or, before any observation, its estimated
tokens reach ``long_prompt_tokens``. Replicas of the other role are
excluded while one of the preferred role (or a unified one) remains; a
conversation whose birth replica has the wrong role leaves its affinity
(reason ``handoff``), and the KV exchange carries the KV across.
Failover re-picks are never steered.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from llmq_tpu_torch import observability
from llmq_tpu_torch.core.config import ClusterConfig
from llmq_tpu_torch.core.errors import NoEndpointError
from llmq_tpu_torch.core.types import Message
from llmq_tpu_torch.loadbalancer.circuit_breaker import (BreakerBoard,
                                                         CircuitOpenError)
from llmq_tpu_torch.loadbalancer.load_balancer import (Endpoint,
                                                       EndpointStatus,
                                                       LoadBalancer)
from llmq_tpu_torch.loadbalancer.router import EngineRouter
from llmq_tpu_torch.utils.logging import bind_log_context, reset_log_context

log = logging.getLogger("llmq_tpu_torch.cluster")


class ClusterRouter(EngineRouter):
    """EngineRouter with the replica set's policies (affinity, spill,
    failover, drain) and their metrics."""

    def __init__(self, load_balancer: LoadBalancer, *,
                 config: Optional[ClusterConfig] = None,
                 state_manager=None,
                 enable_metrics: bool = True) -> None:
        super().__init__(load_balancer)
        self.config = config or ClusterConfig()
        self.state_manager = state_manager
        self._metrics = None
        if enable_metrics:
            from llmq_tpu_torch.metrics.registry import get_metrics
            self._metrics = get_metrics()
        self._mu = threading.Lock()
        self.breakers = BreakerBoard(self.config.breaker,
                                     enable_metrics=enable_metrics)
        #: conversation → endpoint id in this process; the state
        #: manager's placement record is the durable copy.
        self._affinity: Dict[str, str] = {}
        self._local_endpoint_id: Optional[str] = None
        self.dispatches = 0
        self.affinity_hits = 0
        self.affinity_eligible = 0
        self.spills = 0
        self.failovers = 0
        #: The DisaggConfig when the disaggregation plane is on; None
        #: keeps every decision the unified route.
        self.disagg = None
        #: ``fn(est_tokens) -> Optional[float]``: the learned prefill ETA
        #: in ms (None before the first observation).
        self.prefill_eta = None
        #: endpoint id → role pinned by an operator or the controller;
        #: probes and local engines fill the rest.
        self._roles: Dict[str, str] = {}
        self.role_routes = 0
        self.handoffs = 0

    # -- registration --------------------------------------------------------

    def register_engine(self, engine, **kw) -> Endpoint:
        ep = super().register_engine(engine, **kw)
        if self._local_endpoint_id is None:
            self._local_endpoint_id = ep.id
        return ep

    def engine_for(self, ep: Endpoint):
        """EngineRouter.engine_for, and every HTTP transport here shares
        the router's breaker of its endpoint: the transport's precise
        classing (fault or deadline miss) feeds the state selection
        reads."""
        engine = super().engine_for(ep)
        if (engine is not None and self.breakers.enabled
                and hasattr(engine, "breaker")
                and getattr(engine, "breaker", None) is None):
            engine.breaker = self.breakers.breaker(ep.id)
        return engine

    def register_peers(self, peers) -> None:
        """Register the configured replicas (once per URL). An endpoint's
        id is the ``host:port`` of its URL: a whole URL would break the
        path routes (``POST /api/v1/endpoints/:id/drain``)."""
        known = {e.url for e in self.lb.endpoints()}
        for url in peers:
            if url in known:
                continue
            eid = url.split("://", 1)[-1].rstrip("/") or url
            self.register_remote(url, endpoint_id=eid,
                                 timeout=self.config.peer_timeout)

    # -- disaggregation roles -------------------------------------------------

    def set_endpoint_role(self, endpoint_id: str, role: str) -> None:
        """Pin an endpoint's role (the operator's and the controller's
        seam; no probe overrides it)."""
        with self._mu:
            self._roles[endpoint_id] = role

    def _role_of(self, ep: Endpoint) -> str:
        """An endpoint's role: the pinned one, else the local engine's
        ``disagg_role``, else the role its last /health probe advertised.
        Anything unknown reads "unified" (routable for every preference)."""
        with self._mu:
            r = self._roles.get(ep.id)
        if not r:
            engine = self.engine_for(ep)
            r = getattr(engine, "disagg_role", None)
            if not r:
                health = getattr(engine, "last_health", None)
                if isinstance(health, dict):
                    r = health.get("role")
        return r if r in ("prefill", "decode") else "unified"

    def _role_pref(self, msg: Message,
                   session: Optional[str]) -> Optional[str]:
        """The role that should serve this turn, or None with the plane
        off. Tokens are estimated as ``len(content) // 4``, as JAX's
        router does."""
        dcfg = self.disagg
        if dcfg is None or not getattr(dcfg, "enabled", False):
            return None
        followup = bool(msg.metadata.get("history_text"))
        if not followup and session and self.state_manager is not None:
            try:
                followup = (self.state_manager.placement(session)
                            is not None)
            except Exception:  # noqa: BLE001 — a hint, not a gate
                followup = False
        if followup:
            return "decode"
        est_tokens = max(1, len(msg.content) // 4)
        eta = None
        if self.prefill_eta is not None:
            try:
                eta = self.prefill_eta(est_tokens)
            except Exception:  # noqa: BLE001 — the estimator is advisory
                eta = None
        if eta is not None:
            return ("prefill" if eta >= float(dcfg.long_prompt_ms)
                    else "decode")
        return ("prefill" if est_tokens >= int(dcfg.long_prompt_tokens)
                else "decode")

    def _role_exclusions(self, pref: Optional[str], avoid: set) -> set:
        """The endpoints specialised for the other role; empty unless an
        endpoint of the preferred role (or a unified one) stays
        selectable: a preference never raises a NoEndpointError that the
        unified route would not."""
        if pref is None:
            return set()
        eps = self.lb.endpoints()
        mismatched = {ep.id for ep in eps
                      if self._role_of(ep) not in (pref, "unified")}
        if not mismatched:
            return set()
        if not any(ep.id not in avoid and ep.id not in mismatched
                   for ep in eps):
            return set()
        with self._mu:
            self.role_routes += 1
        return mismatched

    # -- affinity ------------------------------------------------------------

    def _affine_endpoint(self, conv_id: str) -> Optional[str]:
        """The replica believed to hold this conversation's prefix: this
        process's map, else the conversation's placement record, else,
        when the local engine recorded a prefix handle, this process's
        own endpoint."""
        with self._mu:
            eid = self._affinity.get(conv_id)
        if eid is not None:
            return eid
        sm = self.state_manager
        if sm is None:
            return None
        try:
            pl = sm.placement(conv_id)
        except Exception:  # noqa: BLE001 — affinity is a hint, not a gate
            pl = None
        if pl and pl.get("endpoint_id"):
            return str(pl["endpoint_id"])
        if self._local_endpoint_id is not None:
            try:
                if sm.prefix_handle(conv_id):
                    return self._local_endpoint_id
            except Exception:  # noqa: BLE001
                pass
        return None

    def _avoid(self, tried: set) -> set:
        """The endpoints selection skips: those tried in this dispatch and
        those whose breaker blocks new traffic (checked without taking
        the half-open probe slot, which only the dispatch takes)."""
        avoid = set(tried)
        if self.breakers.enabled:
            for ep in self.lb.endpoints():
                if ep.id not in avoid and self.breakers.blocked(ep.id):
                    avoid.add(ep.id)
        return avoid

    def _acquire(self, msg: Message, session: Optional[str],
                 tried: set) -> Tuple[Endpoint, str]:
        """Pick and book one endpoint: (endpoint, reason)."""
        aff = self.config.affinity
        avoid = self._avoid(tried)
        # Role steering shapes the first pick only: a failover re-pick
        # goes wide open.
        pref = self._role_pref(msg, session) if not tried else None
        role_avoid = self._role_exclusions(pref, avoid)

        def pick(sid: Optional[str], reason: str) -> Tuple[Endpoint, str]:
            if role_avoid:
                try:
                    return (self.lb.get_endpoint(
                        msg, session_id=sid,
                        exclude=avoid | role_avoid), reason)
                except NoEndpointError:
                    # The preferred role left meanwhile: the unified
                    # route, never an error it would not raise.
                    pass
            return (self.lb.get_endpoint(msg, session_id=sid,
                                         exclude=avoid), reason)

        if aff == "prefix" and session and not tried:
            eid = self._affine_endpoint(session)
            if eid is not None:
                with self._mu:
                    self.affinity_eligible += 1
                ep = self.lb.get_endpoint_by_id(eid)
                if role_avoid and eid in role_avoid:
                    # The birth replica has the wrong role for this turn:
                    # the prefill → decode handoff leaves the affinity.
                    with self._mu:
                        self.handoffs += 1
                    return pick(None, "handoff")
                if (ep is not None and ep.load < self.config.spill_load
                        and eid not in avoid):
                    got = self.lb.acquire_endpoint(eid)
                    if got is not None:
                        with self._mu:
                            self.affinity_hits += 1
                        return got, "affinity"
                # Saturated, draining, blocked or gone: spill by the
                # strategy.
                with self._mu:
                    self.spills += 1
                return pick(None, "spill")
            return pick(None, "select")
        # "session" keeps the LB's session map; "none" and the failover
        # re-picks go by the strategy alone.
        sid = session if (aff == "session" and not tried) else None
        reason = "failover" if tried else "select"
        return pick(sid, reason)

    # -- dispatch ------------------------------------------------------------

    def process_fn(self, ctx, msg: Message) -> None:
        """Worker seam: dispatch with affinity and failover. Raises when
        every replica tried failed (the worker's retry path, then the
        dead-letter queue, own the message from there)."""
        session = msg.conversation_id or None
        tried: set = set()
        attempts = max(0, int(self.config.failover_retries)) + 1
        last_err: Optional[BaseException] = None
        for _ in range(attempts):
            if ctx is not None:
                rem = ctx.remaining()
                if rem is not None and rem <= 0:
                    break      # the deadline is gone: raise the last error
            try:
                ep, reason = self._acquire(msg, session, tried)
            except NoEndpointError:
                # Every untried replica is unhealthy or draining: raise
                # the dispatch failure if there was one (the cause).
                if last_err is None:
                    raise
                break
            engine = self.engine_for(ep)
            if engine is None:
                self.lb.release_endpoint(ep.id, is_error=True)
                tried.add(ep.id)
                last_err = RuntimeError(
                    f"endpoint {ep.id} has no attached engine and no "
                    f"transport for url {ep.url!r}")
                continue
            # The gate of an engine without a breaker of its own (the HTTP
            # transport gates and feeds its own: counting here too would
            # halve the trip threshold).
            own_breaker = getattr(engine, "breaker", None) is not None
            if (not own_breaker and self.breakers.enabled
                    and not self.breakers.allow(ep.id)):
                self.lb.release_endpoint(ep.id)
                tried.add(ep.id)
                last_err = CircuitOpenError(
                    ep.id, self.breakers.breaker(ep.id).retry_in())
                continue
            if session is not None:
                # Placement is resolved: a local engine starts promoting a
                # store-tier conversation now (a transport has no hint;
                # the replica's own submit path prepares it).
                hint = getattr(engine, "hint_arrival", None)
                if hint is not None:
                    try:
                        hint(session)
                    except Exception:  # noqa: BLE001 — a hint only
                        log.exception("arrival hint failed for %s",
                                      session)
            observability.record(msg.id, "dispatched", endpoint=ep.id,
                                 reason=reason,
                                 priority=msg.priority.tier_name)
            ltoken = bind_log_context(endpoint=ep.id, request_id=msg.id)
            t0 = time.perf_counter()
            try:
                engine.process_fn(ctx, msg)
            except TimeoutError:
                # The work may have run (or still run): the worker's
                # timeout and retry path owns this. Not a breaker fault,
                # but a held half-open probe slot is given back.
                if not own_breaker:
                    self.breakers.record_timeout(ep.id)
                self.lb.release_endpoint(ep.id, is_error=True)
                raise
            except CircuitOpenError as e:
                # The transport's own gate closed after selection: nothing
                # was sent, so no error and no failover are charged.
                self.lb.release_endpoint(ep.id)
                tried.add(ep.id)
                last_err = e
                continue
            except Exception as e:  # noqa: BLE001 — a replica failure
                self.lb.release_endpoint(ep.id, is_error=True)
                if not own_breaker:
                    self.breakers.record(ep.id, ok=False)
                tried.add(ep.id)
                last_err = e
                with self._mu:
                    self.failovers += 1
                if self._metrics:
                    self._metrics.cluster_failovers.labels(ep.id).inc()
                # A local engine's partial work is this process's failover
                # waste; a remote replica bills its own ledger.
                if ep.id == self._local_endpoint_id:
                    observability.get_usage_ledger().note_failover(msg.id)
                observability.record(msg.id, "failover", endpoint=ep.id,
                                     error=repr(e))
                log.warning("dispatch of %s to %s failed (%s); "
                            "retrying on another replica",
                            msg.id, ep.id, e)
                continue
            finally:
                reset_log_context(ltoken)
            if not own_breaker:
                self.breakers.record(ep.id, ok=True)
            self._commit(msg, ep, session, reason,
                         time.perf_counter() - t0)
            return
        raise last_err if last_err is not None else RuntimeError(
            f"no replica available for message {msg.id} "
            f"before its deadline")

    def _commit(self, msg: Message, ep: Endpoint, session: Optional[str],
                reason: str, elapsed: float) -> None:
        self.lb.release_endpoint(ep.id, elapsed)
        msg.metadata["endpoint_id"] = ep.id
        with self._mu:
            self.dispatches += 1
        if session:
            with self._mu:
                self._affinity[session] = ep.id
                # Bound the map; the durable record lives with the
                # conversation.
                if len(self._affinity) > 65536:
                    for k in list(self._affinity)[:4096]:
                        self._affinity.pop(k, None)
            if self.state_manager is not None:
                usage = msg.metadata.get("usage") or {}
                try:
                    self.state_manager.record_placement(
                        session, ep.id,
                        cached_tokens=int(usage.get("cached_tokens", 0)
                                          or 0))
                except Exception:  # noqa: BLE001 — bookkeeping only
                    log.exception("placement record failed for %s",
                                  session)
        if self._metrics:
            self._metrics.cluster_dispatch.labels(ep.id, reason).inc()
            with self._mu:
                hits, eligible = (self.affinity_hits,
                                  self.affinity_eligible)
            if eligible:
                self._metrics.cluster_affinity_hit_rate.set(
                    hits / eligible)
            self._set_endpoint_gauges()

    def _set_endpoint_gauges(self) -> None:
        counts = {s.value: 0 for s in EndpointStatus}
        for e in self.lb.endpoints():
            counts[e.status.value] = counts.get(e.status.value, 0) + 1
        for status, n in counts.items():
            self._metrics.cluster_endpoints.labels(status).set(n)

    # -- drain ---------------------------------------------------------------

    def drain_endpoint(self, endpoint_id: str,
                       wait: float = 0.0) -> bool:
        """Stop new dispatch to a replica (affinity included: its
        conversations spill); in-flight calls finish. With ``wait`` > 0,
        block until its connections reach zero or the wait ends. True
        when fully drained (at once, when not waiting)."""
        if not self.lb.set_draining(endpoint_id, True):
            return False
        if self._metrics:
            self._metrics.cluster_drains.labels(endpoint_id).inc()
            self._set_endpoint_gauges()
        log.info("endpoint %s draining", endpoint_id)
        deadline = time.monotonic() + max(0.0, wait)
        while True:
            ep = self.lb.get_endpoint_by_id(endpoint_id)
            if ep is None or ep.connections <= 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def undrain_endpoint(self, endpoint_id: str) -> bool:
        """Readmit a drained replica, through DEGRADED: the health probe
        proves it before full traffic."""
        ok = self.lb.set_draining(endpoint_id, False)
        if ok and self._metrics:
            self._set_endpoint_gauges()
        return ok

    # -- stats ---------------------------------------------------------------

    def _overview_entry(self, ep: Endpoint) -> Dict:
        """One replica's block of the overview: its engine counters and
        device block, read in process or over the transport, and its
        usage, SLO and boot blocks. A replica that does not answer is an
        ``error`` entry."""
        entry: Dict = {"id": ep.id, "url": ep.url,
                       "status": ep.status.value}
        eng = self.engine_for(ep)
        stats = None
        remote = getattr(eng, "engine_stats", None)
        if eng is None:
            entry["error"] = "no engine/transport attached"
        else:
            try:
                if remote is not None:
                    stats = remote()
                elif hasattr(eng, "get_stats"):
                    stats = eng.get_stats()
            except Exception as e:  # noqa: BLE001 — degrade per replica
                entry["error"] = f"{type(e).__name__}: {e}"
        if not stats:
            return entry
        # Only a device block with content: ``reporting`` counts them.
        dev = stats.get("device")
        if dev:
            entry["device"] = dev
        entry["engine"] = {
            k: stats.get(k)
            for k in ("name", "slots", "active", "pending", "decode_steps",
                      "tokens_generated", "kv_pages_used", "kv_pages_total")}
        # A peer attaches its own usage, SLO and boot blocks to its engine
        # stats; a local engine's are this process's.
        if stats.get("usage") is not None:
            entry["usage"] = stats["usage"]
        elif remote is None:
            led = observability.get_usage_ledger()
            if led.enabled:
                entry["usage"] = led.snapshot(top_conversations=0)
        if stats.get("slo") is not None:
            entry["slo"] = stats["slo"]
        elif remote is None:
            # The deferred feed first, as the engine stats route does.
            observability.get_recorder().flush_metrics()
            entry["slo"] = observability.get_slo_tracker().snapshot()
        if stats.get("boot") is not None:
            entry["boot"] = stats["boot"]
        elif remote is None and observability.cp_enabled():
            boot_id = ep.metadata.get("boot_id")
            boot = (observability.get_boot_registry().get(str(boot_id))
                    if boot_id else None)
            if boot is None:
                boot = observability.process_boot_snapshot()
            if boot is not None:
                entry["boot"] = boot
        return entry

    def overview(self) -> Dict:
        """The cluster's device-telemetry rollup
        (``GET /api/v1/cluster/overview``): every endpoint's engine and
        device blocks, the peers' fetched concurrently (the route takes
        about one probe timeout, however many replicas are dead)."""
        endpoints = self.lb.endpoints()
        if endpoints:
            with ThreadPoolExecutor(
                    max_workers=min(16, len(endpoints))) as pool:
                replicas = list(pool.map(self._overview_entry, endpoints))
        else:
            replicas = []
        agg_tok_s = 0.0
        mfus = []
        occupancies = []
        u_device = u_waste = 0.0
        gp_tokens = gp_device = 0.0
        usage_reporting = 0
        for entry in replicas:
            usage = entry.get("usage")
            if usage:
                usage_reporting += 1
                tot = usage.get("totals") or {}
                u_device += tot.get("device_seconds") or 0.0
                u_waste += tot.get("waste_device_seconds") or 0.0
                gp = usage.get("goodput") or {}
                gp_tokens += gp.get("tokens_slo_met") or 0
                gp_device += gp.get("device_seconds") or 0.0
            dev = entry.get("device")
            if not dev:
                continue
            agg_tok_s += dev.get("decode_tokens_per_s") or 0.0
            if dev.get("mfu_pct") is not None:
                mfus.append(dev["mfu_pct"])
            occ = (dev.get("hbm") or {}).get("kv_pool_occupancy")
            if occ is not None:
                occupancies.append(occ)
        return {
            "replicas": replicas,
            "aggregate": {
                "endpoints": len(replicas),
                "reporting": sum(1 for r in replicas if "device" in r),
                "decode_tokens_per_s": round(agg_tok_s, 1),
                "mean_mfu_pct": (round(sum(mfus) / len(mfus), 3)
                                 if mfus else 0.0),
                "max_kv_pool_occupancy": (round(max(occupancies), 4)
                                          if occupancies else 0.0),
                "boot_reporting": sum(1 for r in replicas if "boot" in r),
                "usage": {
                    "reporting": usage_reporting,
                    "device_seconds": round(u_device, 6),
                    "waste_device_seconds": round(u_waste, 6),
                    "waste_ratio": (round(u_waste / u_device, 4)
                                    if u_device > 0 else 0.0),
                    "goodput_tokens_per_device_second": (
                        round(gp_tokens / gp_device, 3)
                        if gp_device > 0 else 0.0),
                },
            },
        }

    def get_stats(self) -> Dict:
        with self._mu:
            hits, eligible = self.affinity_hits, self.affinity_eligible
            dispatches, spills = self.dispatches, self.spills
            failovers = self.failovers
            role_routes, handoffs = self.role_routes, self.handoffs
        out = {
            "dispatches": dispatches,
            "affinity_hits": hits,
            "affinity_eligible": eligible,
            "affinity_hit_rate": (
                round(hits / eligible, 4) if eligible else 0.0),
            "spills": spills,
            "failovers": failovers,
            "local_endpoint_id": self._local_endpoint_id,
            "endpoints": self.lb.get_stats(),
            "breakers": self.breakers.get_stats(),
        }
        if self.disagg is not None and getattr(self.disagg, "enabled",
                                               False):
            out["disagg"] = {
                "role_routes": role_routes,
                "handoffs": handoffs,
                "roles": {ep.id: self._role_of(ep)
                          for ep in self.lb.endpoints()},
            }
        return out
