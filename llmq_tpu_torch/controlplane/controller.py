"""The reconcile controller: the observe → decide → act loop (the port's
copy of ``llmq_tpu/controlplane/controller.py``).

What the serving stack measures drives it: the SLO plane's burn rates,
the queue backlog, each replica's health and breaker state, the engines'
decode tokens/s. One tick (``run_once``):

1. **observe**: probe the replicas' health at the controller's cadence,
   read burn rates, backlog, live and target replicas, breakers and
   tokens/s;
2. **decide**: heal first (a pool replica out of rotation is
   decommissioned and replaced, exempt from the cooldown), then move the
   target on burn or backlog (cooldown, and a rolling actions-per-minute
   limit as the thrash guard), then tick the degradation ladder;
3. **act**: provision through the :class:`ReplicaPool`, scale down by a
   drain and then a decommission (never below ``min_replicas``, never
   below the capacity the measured tokens/s needs), apply or clear the
   ladder's rung at the overload shedder.

A paused controller (``POST /api/v1/admin/controller``) keeps observing
(its snapshot stays fresh and /health says "paused") and takes no new
action; a disabled control plane has no controller at all.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from llmq_tpu_torch.controlplane.ladder import DegradationLadder
from llmq_tpu_torch.controlplane.pool import ReplicaPool
from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import ControlPlaneConfig
from llmq_tpu_torch.loadbalancer.load_balancer import (Endpoint,
                                                       EndpointStatus)

log = logging.getLogger("llmq_tpu_torch.controlplane")

#: Closed enums mirrored into metrics/registry.py LABEL_CONTRACT.
ACTIONS = ("scale_up", "scale_down", "replace", "escalate", "relax",
           "pause", "resume", "skip")
REASONS = ("burn_fast", "burn_slow", "backlog", "replica_dead",
           "breaker_open", "rate_limited", "cooldown", "recovered",
           "idle", "operator", "capacity")

#: Consecutive ticks an endpoint's breaker must stay blocked before
#: the controller treats the replica as dead (a single OPEN window is
#: the breaker doing its job; a breaker that never re-closes is a
#: replica that failed out of rotation).
_BREAKER_DEAD_TICKS = 3


class ReplicaController:
    def __init__(self, *, config: Optional[ControlPlaneConfig] = None,
                 router: Any,
                 pool: Optional[ReplicaPool] = None,
                 queue_manager: Any = None,
                 shedder: Any = None,
                 slo_tracker: Any = None,
                 supervisor: Any = None,
                 clock: Optional[Clock] = None,
                 enable_metrics: bool = True) -> None:
        self.config = config or ControlPlaneConfig(enabled=True)
        #: ClusterRouter (or anything with .lb, .drain_endpoint,
        #: .breakers) — the act seam.
        self.router = router
        self.pool = pool
        #: DisaggConfig when the disagg plane is on (set by
        #: build_controller) — scale-ups then pick which role the new
        #: replica joins.
        self.disagg: Any = None
        self.queue_manager = queue_manager
        self.supervisor = supervisor
        self._clock = clock or SYSTEM_CLOCK
        if slo_tracker is None:
            from llmq_tpu_torch.observability.slo import get_slo_tracker
            slo_tracker = get_slo_tracker()
        self.slo = slo_tracker
        self.ladder = DegradationLadder(
            self.config.rungs, shedder=shedder,
            relax_after_ticks=self.config.relax_after_ticks)
        self._metrics = None
        if enable_metrics:
            try:
                from llmq_tpu_torch.metrics.registry import get_metrics
                self._metrics = get_metrics()
            except Exception:  # noqa: BLE001
                self._metrics = None
        self._mu = threading.Lock()
        self.paused = False
        #: Replica count being reconciled toward; initialized from the
        #: first observation (lazy — the router may still be filling).
        self.target: Optional[int] = None
        self._seq = 0
        self._last_scale_at = float("-inf")
        self._actions_window: Deque[float] = deque()
        #: endpoint id → drain deadline (scale-down in flight).
        self._draining: Dict[str, float] = {}
        #: endpoint id → consecutive ticks its breaker stayed blocked.
        self._breaker_blocked_ticks: Dict[str, int] = {}
        #: Peak observed per-replica decode tokens/s (the scale-down
        #: capacity guard's denominator).
        self._peak_replica_tok_s = 0.0
        self._recovering_since: Optional[float] = None
        self.last_recovery_s: Optional[float] = None
        #: Boot-registry id of the most recently provisioned replica —
        #: joins recovery_seconds to its boot decomposition (how much
        #: of the recovery wall was compile vs weights vs provision).
        self.last_boot_id: Optional[str] = None
        self.last_action: Optional[Dict[str, Any]] = None
        self.action_counts: Dict[str, int] = {}
        self.ticks = 0
        self._last_obs: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or self.config.interval <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="controlplane", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # A tick can legitimately block in pool.provision for up
            # to the pool's ready_timeout; give it room. Provisions
            # finishing after this join are caught by the stop-flag
            # check in _provision_one (decommissioned, never
            # registered), so even a join timeout leaves no orphan.
            self._thread.join(timeout=30.0)
            self._thread = None
        if self.pool is not None:
            self.pool.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("controller tick failed")

    # -- operator control ----------------------------------------------------

    def pause(self) -> None:
        with self._mu:
            already = self.paused
            self.paused = True
        if not already:
            self._count("pause", "operator")
            log.warning("controller PAUSED by operator (observing "
                        "only; POST action=resume to re-enable)")

    def resume(self) -> None:
        with self._mu:
            was = self.paused
            self.paused = False
        if was:
            self._count("resume", "operator")
            log.info("controller resumed")

    # -- observe -------------------------------------------------------------

    def _burn(self) -> Tuple[float, float]:
        """(fast, slow) burn rates: max across SLOs of the shortest /
        longest configured window. Flushes the recorder's deferred
        feed first so burn reflects every finished request even when
        nothing scrapes /metrics."""
        try:
            from llmq_tpu_torch.observability.recorder import get_recorder
            get_recorder().flush_metrics()
        except Exception:  # noqa: BLE001 — observation must degrade,
            pass           # not die, without the trace plane
        fast = slow = 0.0
        try:
            rates = self.slo.burn_rates()
        except Exception:  # noqa: BLE001
            return 0.0, 0.0
        for per in rates.values():
            vals = [d.get("burn_rate", 0.0) for d in per.values()]
            if not vals:
                continue
            fast = max(fast, vals[0])
            slow = max(slow, vals[-1])
        return fast, slow

    def _tokens_per_s(self, endpoints: List[Endpoint]) -> float:
        """Measured aggregate decode tokens/s across LOCAL engines
        (remote replicas are read by the overview route, not on the
        reconcile tick — a black-holed peer must not stall the loop)."""
        total = 0.0
        for ep in endpoints:
            eng = ep.metadata.get("engine")
            if eng is None or hasattr(eng, "engine_stats"):
                continue               # remote transport or bare URL
            try:
                dev = eng.get_stats().get("device") or {}
                total += float(dev.get("decode_tokens_per_s") or 0.0)
            except Exception:  # noqa: BLE001 — advisory signal
                continue
        return total

    @staticmethod
    def _healthy_count(endpoints: List[Endpoint]) -> int:
        """Dispatchable replicas: the one live-capacity definition
        every decide step shares."""
        return sum(1 for e in endpoints
                   if e.status in (EndpointStatus.HEALTHY,
                                   EndpointStatus.DEGRADED))

    def observe(self) -> Dict[str, Any]:
        lb = self.router.lb
        # Drive the probe state machine at OUR cadence: the LB's own
        # health loop defaults to 30 s ticks, and healing bounded by
        # 3 failures × 30 s cannot meet a 30 s recovery budget. Probes
        # are probe-grade-cheap (engine.healthy() locally, short-
        # timeout /health over HTTP) and the state machine is
        # direction-stable under extra probes, so running it here as
        # well as in the LB loop is safe.
        try:
            lb.check_health_once()
        except Exception:  # noqa: BLE001
            log.exception("controller health probe failed")
        endpoints = lb.endpoints()
        healthy = [e for e in endpoints
                   if e.status in (EndpointStatus.HEALTHY,
                                   EndpointStatus.DEGRADED)]
        unhealthy = [e for e in endpoints
                     if e.status == EndpointStatus.UNHEALTHY]
        draining = [e for e in endpoints
                    if e.status == EndpointStatus.DRAINING]
        # Breaker watch: a pool-owned endpoint whose breaker stays
        # blocked across consecutive ticks has failed out of rotation
        # even if its /health still answers.
        breaker_dead: List[Endpoint] = []
        breakers = getattr(self.router, "breakers", None)
        if breakers is not None and getattr(breakers, "enabled", False):
            for e in endpoints:
                if breakers.blocked(e.id):
                    n = self._breaker_blocked_ticks.get(e.id, 0) + 1
                    self._breaker_blocked_ticks[e.id] = n
                    if (n >= _BREAKER_DEAD_TICKS
                            and e.metadata.get("pool")
                            and e.status != EndpointStatus.DRAINING):
                        breaker_dead.append(e)
                else:
                    self._breaker_blocked_ticks.pop(e.id, None)
        if self._breaker_blocked_ticks:
            # Entries for endpoints that left the LB while blocked
            # (e.g. drained away) must not accumulate forever under
            # replica churn.
            known = {e.id for e in endpoints}
            for eid in list(self._breaker_blocked_ticks):
                if eid not in known:
                    self._breaker_blocked_ticks.pop(eid, None)
        backlog = 0
        if self.queue_manager is not None:
            try:
                backlog = int(self.queue_manager.total_pending())
            except Exception:  # noqa: BLE001
                backlog = 0
        fast, slow = self._burn()
        tok_s = self._tokens_per_s(healthy)
        if healthy and tok_s > 0:
            self._peak_replica_tok_s = max(self._peak_replica_tok_s,
                                           tok_s / len(healthy))
        sup_gave_up = bool(self.supervisor is not None
                           and getattr(self.supervisor, "gave_up",
                                       False))
        obs = {
            "fast_burn": fast,
            "slow_burn": slow,
            "backlog": backlog,
            "tokens_per_s": round(tok_s, 1),
            "healthy": [e.id for e in healthy],
            "unhealthy": [e.id for e in unhealthy],
            # Unhealthy endpoints the controller OWNS (can replace):
            # scale-down and recovery gate on these — a permanently
            # down static peer is not ours to fix and must not pin the
            # fleet at peak target or hold recovery open forever.
            "unhealthy_pool": [e.id for e in unhealthy
                               if e.metadata.get("pool")],
            "draining": [e.id for e in draining],
            "breaker_dead": [e.id for e in breaker_dead],
            "supervisor_gave_up": sup_gave_up,
        }
        self._last_obs = obs
        return obs

    # -- decide + act --------------------------------------------------------

    def run_once(self) -> Dict[str, Any]:
        """One reconcile tick. Returns a decision record (tests drive
        this directly; the loop thread just calls it)."""
        now = self._clock.now()
        obs = self.observe()
        self.ticks += 1
        actions: List[Tuple[str, str]] = []
        lb = self.router.lb
        healthy_n = len(obs["healthy"])
        if self.target is None:
            self.target = max(self.config.min_replicas,
                              healthy_n + len(obs["draining"]))
        if self.paused:
            # Paused stops NEW decisions, not the mechanical tail of
            # already-decided ones: a drain in flight still gets
            # reaped (a drained replica taking no traffic must not
            # burn replica-seconds for the whole pause). The ladder is
            # deliberately frozen — the operator took control.
            self._reap_drained(now, actions)
            self._flush_gauges(healthy_n)
            return {"paused": True, "target": self.target, "obs": obs,
                    "actions": actions, "rung": self.ladder.level}

        # 1. Finish any scale-down drains whose endpoint went idle.
        self._reap_drained(now, actions)

        # 2. Self-healing: replace pool-owned replicas that failed out
        #    of rotation (LB UNHEALTHY, or breaker permanently open).
        dead_ids = list(obs["unhealthy"]) + list(obs["breaker_dead"])
        for eid in dead_ids:
            ep = lb.get_endpoint_by_id(eid)
            if ep is None or not ep.metadata.get("pool"):
                continue               # not ours to replace
            if not self._allow_action(now, actions):
                break
            reason = ("breaker_open" if eid in obs["breaker_dead"]
                      else "replica_dead")
            log.warning("replacing dead replica %s (%s)", eid, reason)
            self.pool_decommission(ep)
            self._breaker_blocked_ticks.pop(eid, None)
            self._provision_one()
            self._mark_action(now)
            self._count("replace", reason)
            actions.append(("replace", reason))
            self._recovering_since = (self._recovering_since or now)

        # Re-read health after replacements.
        healthy_n = self._healthy_count(lb.endpoints())

        # 3. Target adjustment: burn/backlog scale-up, idle scale-down.
        assert self.target is not None
        cfg = self.config
        backlog_limit = max(1, cfg.backlog_per_replica * max(1,
                                                            healthy_n))
        up_reason: Optional[str] = None
        if obs["fast_burn"] >= cfg.fast_burn_threshold:
            up_reason = "burn_fast"
        elif obs["slow_burn"] >= cfg.slow_burn_threshold:
            up_reason = "burn_slow"
        elif obs["backlog"] > backlog_limit:
            up_reason = "backlog"
        up_pending: Optional[str] = None
        if (up_reason is not None and self.target < cfg.max_replicas
                and self.pool is not None):
            if now - self._last_scale_at < cfg.cooldown:
                self._count("skip", "cooldown")
                actions.append(("skip", "cooldown"))
            elif self._allow_action(now, actions):
                # The raise and its provision (step 4) are ONE logical
                # action — counted and rate-limit-marked at the
                # provision, with this reason.
                self.target += 1
                self._last_scale_at = now
                up_pending = up_reason
                log.info("scale up → target %d (%s: fast=%.2f "
                         "slow=%.2f backlog=%d)", self.target,
                         up_reason, obs["fast_burn"], obs["slow_burn"],
                         obs["backlog"])
        elif (up_reason is None and self.target > cfg.min_replicas
              and healthy_n >= self.target
              and obs["fast_burn"] < 1.0 and obs["slow_burn"] < 1.0
              and obs["backlog"] <= max(1, backlog_limit // 4)
              and not obs["unhealthy_pool"] and not self._draining):
            if self._capacity_allows_scale_down(obs, healthy_n):
                if now - self._last_scale_at < cfg.cooldown:
                    pass               # idle; no need to count skips
                elif self._allow_action(now, actions):
                    if self._start_scale_down(now):
                        self.target -= 1
                        self._last_scale_at = now
                        self._mark_action(now)
                        self._count("scale_down", "idle")
                        actions.append(("scale_down", "idle"))

        # 4. Reconcile live toward target (provision the shortfall) —
        #    re-read statuses: step 3 may have started a drain.
        healthy_n = self._healthy_count(lb.endpoints())
        shortfall = self.target - healthy_n - len(self._draining)
        while shortfall > 0 and self.pool is not None:
            if not self._allow_action(now, actions):
                break
            if not self._provision_one():
                break
            self._mark_action(now)
            # "replica_dead" only for deaths the controller OWNS (a
            # pool replica, or this process's own engine after a
            # supervisor give-up) — a down static peer is not a death
            # this backfill recovers from, and mislabeling it would
            # point the thrash-alert runbook at the wrong replica.
            reason = up_pending or (
                "replica_dead" if (obs["unhealthy_pool"]
                                   or obs["supervisor_gave_up"])
                else "capacity")
            up_pending = None
            self._count("scale_up", reason)
            actions.append(("scale_up", reason))
            if reason == "replica_dead":
                self._recovering_since = self._recovering_since or now
            shortfall -= 1

        # 5. Degradation ladder (hysteresis inside).
        hot = (obs["fast_burn"] >= cfg.escalate_burn
               or obs["backlog"] > backlog_limit)
        calm = (obs["fast_burn"] <= cfg.relax_burn
                and obs["backlog"] <= max(1, backlog_limit // 2))
        moved = self.ladder.tick(hot=hot, calm=calm)
        if moved == "escalate":
            reason = ("burn_fast"
                      if obs["fast_burn"] >= cfg.escalate_burn
                      else "backlog")
            self._count("escalate", reason)
            actions.append(("escalate", reason))
        elif moved == "relax":
            self._count("relax", "recovered")
            actions.append(("relax", "recovered"))

        # 6. Recovery bookkeeping (kill → SLO-met).
        self._track_recovery(now, obs)

        self._flush_gauges(healthy_n)
        return {"paused": False, "target": self.target,
                "healthy": healthy_n, "obs": obs, "actions": actions,
                "rung": self.ladder.level}

    # -- act helpers ---------------------------------------------------------

    def _next_seq(self) -> int:
        with self._mu:
            self._seq += 1
            return self._seq

    def _role_for_new_replica(self) -> Optional[str]:
        """Role-aware scaling: a new replica
        joins the UNDER-represented disagg side of the live set, so
        scale-ups repair the prefill:decode balance instead of skewing
        it. Ties (and a so-far-unified set) go to decode — decode
        capacity is what steady-state token throughput binds on. None
        when the disagg plane is off (the role env is never set)."""
        dcfg = self.disagg
        if dcfg is None or not getattr(dcfg, "enabled", False):
            return None
        role_of = getattr(self.router, "_role_of", None)
        if role_of is None:
            return None
        counts = {"prefill": 0, "decode": 0}
        for e in self.router.lb.endpoints():
            try:
                r = role_of(e)
            except Exception:  # noqa: BLE001 — advisory signal
                continue
            if r in counts:
                counts[r] += 1
        return ("prefill" if counts["prefill"] < counts["decode"]
                else "decode")

    def _provision_one(self) -> bool:
        if self.pool is None:
            return False
        role = self._role_for_new_replica()
        self.pool.role_hint = role
        try:
            ep = self.pool.provision(self._next_seq())
        except Exception:  # noqa: BLE001 — a broken pool must not
            log.exception("pool provision failed")  # kill the loop
            return False
        if ep is None:
            return False
        if self._stop.is_set():
            # Shutdown raced the provision: the replica exists but the
            # controller is being torn down — registering it would
            # orphan it past pool.stop()'s snapshot. Tear it straight
            # back down instead.
            log.warning("provision of %s completed during shutdown; "
                        "decommissioning", ep.id)
            try:
                self.pool.decommission(ep)
            except Exception:  # noqa: BLE001
                log.exception("shutdown decommission of %s failed",
                              ep.id)
            return False
        ep.metadata.setdefault("pool", True)
        self.last_boot_id = str(ep.metadata.get("boot_id") or ep.id)
        self.router.lb.add_endpoint(ep)
        if role is not None:
            # Pin the role in the router immediately: local-engine
            # pools have no /health advertisement, and a subprocess
            # replica's first probe may not have landed yet — the
            # router must steer correctly from the first dispatch.
            try:
                self.router.set_endpoint_role(ep.id, role)
            except AttributeError:
                pass                   # bare-router test doubles
            ep.metadata.setdefault("disagg_role", role)
        return True

    def pool_decommission(self, ep: Endpoint) -> None:
        """Remove + tear down one pool-owned endpoint (no drain — used
        for DEAD replicas; scale-down goes through _start_scale_down)."""
        self.router.lb.remove_endpoint(ep.id)
        if self.pool is not None:
            try:
                self.pool.decommission(ep)
            except Exception:  # noqa: BLE001
                log.exception("pool decommission of %s failed", ep.id)

    def _start_scale_down(self, now: float) -> bool:
        """Pick the least-busy pool-owned replica and start its
        graceful drain; decommission happens once it goes idle (or the
        drain deadline passes). Returns False when nothing is ours to
        remove."""
        candidates = [
            e for e in self.router.lb.endpoints()
            if e.metadata.get("pool")
            and e.status in (EndpointStatus.HEALTHY,
                             EndpointStatus.DEGRADED)
            and e.id not in self._draining]
        if not candidates:
            return False
        victim = min(candidates, key=lambda e: e.connections)
        drain_timeout = float(getattr(
            getattr(self.router, "config", None), "drain_timeout",
            30.0))
        self.router.drain_endpoint(victim.id)
        with self._mu:
            self._draining[victim.id] = now + drain_timeout
        log.info("scale down: draining %s (deadline %.0fs)", victim.id,
                 drain_timeout)
        return True

    def _reap_drained(self, now: float,
                      actions: List[Tuple[str, str]]) -> None:
        with self._mu:
            pending = dict(self._draining)
        for eid, deadline in pending.items():
            ep = self.router.lb.get_endpoint_by_id(eid)
            if ep is None:
                with self._mu:
                    self._draining.pop(eid, None)
                continue
            if ep.connections <= 0 or now >= deadline:
                with self._mu:
                    self._draining.pop(eid, None)
                self.pool_decommission(ep)
                log.info("scale down: %s drained and decommissioned",
                         eid)

    def _capacity_allows_scale_down(self, obs: Dict[str, Any],
                                    healthy_n: int) -> bool:
        """Never drain below the capacity the measured tokens/s
        requires: after removing one replica, peak per-replica
        throughput times the remaining count must still cover the
        measured load with ``scale_down_headroom`` to spare. With no
        throughput signal yet (cold start, echo without metrics) the
        burn/backlog idle conditions already gate the decision."""
        tok_s = float(obs.get("tokens_per_s") or 0.0)
        if tok_s <= 0 or self._peak_replica_tok_s <= 0:
            return True
        remaining = max(0, healthy_n - 1)
        need = tok_s * self.config.scale_down_headroom
        if remaining * self._peak_replica_tok_s < need:
            self._count("skip", "capacity")
            return False
        return True

    def _allow_action(self, now: float,
                      actions: List[Tuple[str, str]]) -> bool:
        """Hard thrash guard: at most ``max_actions_per_minute``
        scale/replace actions in any rolling 60 s window; <= 0
        disables the limit (the repo-wide "0 = unlimited"
        convention)."""
        limit = self.config.max_actions_per_minute
        if limit <= 0:
            return True
        window = self._actions_window
        while window and now - window[0] > 60.0:
            window.popleft()
        if len(window) >= limit:
            self._count("skip", "rate_limited")
            if not actions or actions[-1] != ("skip", "rate_limited"):
                actions.append(("skip", "rate_limited"))
            return False
        return True

    def _mark_action(self, now: float) -> None:
        self._actions_window.append(now)

    def _track_recovery(self, now: float, obs: Dict[str, Any]) -> None:
        if self._recovering_since is None:
            return
        assert self.target is not None
        healthy_n = len(obs["healthy"])
        if (not obs["unhealthy_pool"] and healthy_n >= self.target
                and obs["fast_burn"] < 1.0):
            took = now - self._recovering_since
            self._recovering_since = None
            self.last_recovery_s = round(took, 3)
            if self._metrics:
                self._metrics.controller_recovery_seconds.observe(took)
            if took > self.config.recovery_budget_s:
                log.error("recovery took %.1fs — OVER the %.0fs budget",
                          took, self.config.recovery_budget_s)
            else:
                log.info("recovered in %.1fs (budget %.0fs)", took,
                         self.config.recovery_budget_s)

    # -- accounting ----------------------------------------------------------

    def _last_boot_snapshot(self) -> Optional[Dict[str, Any]]:
        """Boot decomposition of the most recently provisioned replica
        (critical-path plane) — answers "how much of recovery_seconds
        was compile" without grepping logs. None when nothing was
        provisioned yet or the plane is off."""
        if self.last_boot_id is None:
            return None
        try:
            from llmq_tpu_torch.observability.critical_path import (
                cp_enabled, get_boot_registry)
            if not cp_enabled():
                return None
            return get_boot_registry().get(self.last_boot_id)
        except Exception:  # noqa: BLE001 — snapshot must never raise
            return None

    def _count(self, action: str, reason: str) -> None:
        with self._mu:
            key = f"{action}:{reason}"
            self.action_counts[key] = self.action_counts.get(key, 0) + 1
            self.last_action = {"action": action, "reason": reason,
                                "at": self._clock.now()}
        if self._metrics:
            self._metrics.controller_actions.labels(action,
                                                    reason).inc()

    def _flush_gauges(self, healthy_n: int) -> None:
        if not self._metrics:
            return
        self._metrics.controller_rung.set(self.ladder.level)
        self._metrics.controller_target_replicas.set(self.target or 0)
        self._metrics.controller_live_replicas.set(healthy_n)
        self._metrics.controller_paused.set(1 if self.paused else 0)

    def scale_action_total(self) -> int:
        """Scale/replace actions taken (the thrash-guard subject)."""
        with self._mu:
            return sum(n for k, n in self.action_counts.items()
                       if k.split(":", 1)[0] in ("scale_up",
                                                 "scale_down",
                                                 "replace"))

    def snapshot(self) -> Dict[str, Any]:
        """Operator view (``GET /api/v1/cluster/overview`` controller
        block; ``GET /api/v1/admin/controller``)."""
        obs = dict(self._last_obs)
        with self._mu:
            counts = dict(self.action_counts)
            last = dict(self.last_action) if self.last_action else None
            draining = sorted(self._draining)
        return {
            "enabled": True,
            "paused": self.paused,
            "target_replicas": self.target,
            "live_replicas": len(obs.get("healthy", [])),
            "draining": draining,
            "rung": self.ladder.level,
            "rung_name": self.ladder.rung_name(),
            "ladder": self.ladder.snapshot(),
            "inputs": {
                "fast_burn": obs.get("fast_burn"),
                "slow_burn": obs.get("slow_burn"),
                "backlog": obs.get("backlog"),
                "tokens_per_s": obs.get("tokens_per_s"),
                "unhealthy": obs.get("unhealthy", []),
                "supervisor_gave_up": obs.get("supervisor_gave_up"),
            },
            "recovery": {
                "in_progress": self._recovering_since is not None,
                "last_seconds": self.last_recovery_s,
                "budget_seconds": self.config.recovery_budget_s,
                "last_boot": self._last_boot_snapshot(),
            },
            "ticks": self.ticks,
            "last_action": last,
            "actions": counts,
            "pool": (self.pool.get_stats() if self.pool is not None
                     else None),
        }
