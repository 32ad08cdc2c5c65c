"""Scenario driver: plays a compiled schedule closed-loop (the port's
copy of ``llmq_tpu/scenarios/driver.py``).

The driver owns three concerns (docs/scenarios.md):

- **clients** — every compiled conversation is a small state machine:
  turn k+1 is only released after turn k completes plus its compiled
  think time, and each re-arrival carries the grown history as
  ``GenRequest.history_text`` under the same ``conversation_id`` — the
  shape that exercises the radix prefix cache and the tiering plane's
  demote/promote economics at depth;
- **time** — the schedule runs on an injected :class:`Clock`. With a
  :class:`FakeClock` the arrival/think gaps are compressed to nothing
  (a 100k-conversation diurnal soak takes minutes of wall time, not a
  day); with the system clock the same spec is a real load generator;
- **faults** — ``chaos_events`` arm seeded injector rules
  (chaos/injector.py) when the virtual clock reaches their ``at_s``,
  and every attempt is tracked by a chaos
  :class:`~llmq_tpu_torch.chaos.invariants.InvariantChecker`: zero loss,
  zero duplicate completions, monotone token streams — crash or not.

Targets abstract *where* traffic lands: an in-process engine
(:class:`EngineTarget`), a set of controller-managed
``LocalEnginePool`` replicas (:class:`PoolTarget`), or a remote
gateway URL (:class:`GatewayTarget`). Nothing in the serving path
imports this module — the scenarios plane is a tool with zero cost
when unused.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from llmq_tpu_torch.core.clock import Clock, SYSTEM_CLOCK
from llmq_tpu_torch.core.types import Priority
from llmq_tpu_torch.scenarios.spec import (Arrival, CompiledScenario,
                                           ScenarioSpec, TurnPlan,
                                           compile_scenario)

log = logging.getLogger("llmq_tpu_torch.scenarios")

#: Wall-clock bound on draining one tick's in-flight attempts before
#: the run is declared wedged (loudly — never a silent hang).
_TICK_WALL_TIMEOUT_S = 60.0

#: Poll interval while waiting on in-flight attempts (real seconds).
_POLL_S = 0.002


# -- targets -------------------------------------------------------------------


class EngineTarget:
    """Closed-loop traffic into one in-process
    :class:`~llmq_tpu_torch.engine.engine.InferenceEngine`. The engine runs
    its own thread loop; a crash supervisor is attached but polled
    synchronously (``check_once``) from the driver — recovery happens
    at a deterministic point in the run, not on a racing timer."""

    def __init__(self, engine: Any, *, own: bool = False) -> None:
        from llmq_tpu_torch.core.config import SupervisorConfig
        from llmq_tpu_torch.engine.supervisor import EngineSupervisor
        self.engine = engine
        self._own = own
        self.recoveries = 0
        if not engine.running:
            engine.start()
        self._sup = EngineSupervisor(
            engine, config=SupervisorConfig(check_interval=0.01,
                                            max_restarts=64),
            enable_metrics=False)

    def submit(self, req: Any,
               on_token: Callable[[int], None]) -> Any:
        return self.engine.submit(req, on_token=on_token)

    def poll(self, handle: Any) -> Optional[Dict[str, Any]]:
        if not handle.done:
            return None
        return _result_from_handle(handle)

    def check_recover(self) -> bool:
        if self.engine.running:
            return False
        if self._sup.check_once():
            self.recoveries += 1
            return True
        return False

    def engines(self) -> List[Any]:
        return [self.engine]

    def stop(self) -> None:
        if self._own:
            self.engine.stop()


class PoolTarget:
    """Round-robin submit across ``LocalEnginePool`` replicas (the
    controller's in-process provision seam, controlplane/pool.py).
    Supervision comes from the pool itself (each replica gets its own
    threaded supervisor there)."""

    def __init__(self, pool: Any, replicas: int) -> None:
        self._pool = pool
        self._eps = []
        for seq in range(replicas):
            ep = pool.provision(seq)
            if ep is not None:
                self._eps.append(ep)
        if not self._eps:
            raise RuntimeError("pool provisioned zero replicas")
        self._rr = itertools.cycle(list(self._eps))

    def submit(self, req: Any,
               on_token: Callable[[int], None]) -> Any:
        ep = next(self._rr)
        return ep.metadata["engine"].submit(req, on_token=on_token)

    def poll(self, handle: Any) -> Optional[Dict[str, Any]]:
        if not handle.done:
            return None
        return _result_from_handle(handle)

    def check_recover(self) -> bool:
        return False  # the pool's threaded supervisors own recovery

    def engines(self) -> List[Any]:
        return [ep.metadata["engine"] for ep in self._eps]

    def stop(self) -> None:
        for ep in list(self._eps):
            self._pool.decommission(ep)


class GatewayTarget:
    """Remote target: POSTs each turn to ``{url}/api/v1/generate``
    (the sync inference RPC every replica serves) from a small worker
    pool. Tokens are counted from the response usage — no SSE tap, so
    the monotone-stream invariant is vacuous here."""

    def __init__(self, url: str, *, workers: int = 16,
                 timeout_s: float = 120.0) -> None:
        from concurrent.futures import ThreadPoolExecutor
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        self._ex = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix="scenario-gw")

    def _post(self, req: Any) -> Dict[str, Any]:
        import json as _json
        import urllib.request
        payload = {
            "id": req.id,
            "content": req.prompt,
            "user_id": req.tenant_id or "scenario",
            "tenant_id": req.tenant_id,
            "conversation_id": req.conversation_id,
            "priority": int(req.priority),
            "timeout": self.timeout_s,
            "metadata": {"history_text": req.history_text,
                         "max_new_tokens": req.max_new_tokens},
        }
        body = _json.dumps(payload).encode()
        r = urllib.request.Request(
            f"{self.url}/api/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=self.timeout_s) as resp:
            return _json.loads(resp.read().decode())

    def submit(self, req: Any,
               on_token: Callable[[int], None]) -> Any:
        return self._ex.submit(self._post, req)

    def poll(self, handle: Any) -> Optional[Dict[str, Any]]:
        if not handle.done():
            return None
        try:
            data = handle.result()
        except Exception as e:  # noqa: BLE001 — remote failure = attempt failure
            return {"ok": False, "error": str(e), "tokens": 0,
                    "prompt_tokens": 0, "device_s": 0.0,
                    "kv_tier": "", "text": "", "ttft_ms": None}
        usage = data.get("usage") or {}
        return {"ok": True, "error": "",
                "tokens": int(usage.get("tokens", 0) or 0),
                "prompt_tokens": int(usage.get("prompt_tokens", 0)
                                     or 0),
                "device_s": float(usage.get("device_seconds", 0.0)
                                  or 0.0),
                "kv_tier": str(usage.get("kv_tier", "") or ""),
                "text": str(data.get("response") or ""),
                "ttft_ms": None}

    def check_recover(self) -> bool:
        return False

    def engines(self) -> List[Any]:
        return []

    def stop(self) -> None:
        self._ex.shutdown(wait=False)


def _result_from_handle(handle: Any) -> Dict[str, Any]:
    """Normalize a finished GenHandle into the driver's attempt-result
    shape."""
    res = handle.result
    usage = handle.usage or {}
    marks = handle.marks or {}
    ttft_ms: Optional[float] = None
    if "first_token" in marks and "admitted" in marks:
        ttft_ms = (marks["first_token"] - marks["admitted"]) * 1e3
    ok = res is not None and res.finish_reason in ("eos", "length")
    token_ids: List[int] = []
    if res is not None and isinstance(res.tokens, (list, tuple)):
        token_ids = list(res.tokens)
    return {"ok": ok,
            "error": (res.error if res is not None else "gone") or "",
            "tokens": len(token_ids),
            "token_ids": token_ids,
            "prompt_tokens": int(res.prompt_tokens
                                 if res is not None else 0),
            "device_s": float(usage.get("device_seconds", 0.0) or 0.0),
            "kv_tier": (res.kv_tier if res is not None else "") or "",
            "text": (res.text if res is not None else "") or "",
            "ttft_ms": ttft_ms}


def make_echo_engine(name: str = "scenario0", *, slots: int = 16,
                     num_pages: int = 4096, page_size: int = 16,
                     max_pages_per_seq: int = 512,
                     kv_tiering: Any = None,
                     prefix_cache: Any = None,
                     max_decode_steps: int = 64) -> Any:
    """The echo backend every CI scenario runs against: a real
    continuous-batching engine over the EchoExecutor (no model, no
    accelerator), tiering/prefix planes attachable."""
    from llmq_tpu_torch.engine.engine import InferenceEngine
    from llmq_tpu_torch.engine.executor import EchoExecutor
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    ex = EchoExecutor(batch_size=slots, page_size=page_size,
                      num_pages=num_pages,
                      max_pages_per_seq=max_pages_per_seq,
                      eos_id=tok.eos_id)
    return InferenceEngine(ex, tok, name=name, enable_metrics=False,
                           max_decode_steps=max_decode_steps,
                           kv_tiering=kv_tiering,
                           prefix_cache=prefix_cache)


# -- run state -----------------------------------------------------------------


@dataclass
class _Client:
    """One conversation's closed-loop state."""
    arrival: Arrival
    turn: int = 0
    history: str = ""
    retries_left: int = 0


@dataclass
class _Attempt:
    """One in-flight request attempt."""
    rid: str
    client: _Client
    plan: TurnPlan
    handle: Any
    submitted_v: float
    attempt: int = 0


@dataclass
class RunStats:
    """Driver-side counters + the scorer's timeline buckets."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    retried: int = 0
    shed: int = 0
    conversations: int = 0
    turns_planned: int = 0
    chaos_fired: int = 0
    recoveries: int = 0
    tokens_out: int = 0
    prompt_tokens: int = 0
    tenant_tokens: Dict[str, int] = field(default_factory=dict)
    tier_hits: Dict[str, int] = field(default_factory=dict)
    slo_met_requests: int = 0
    slo_met_tokens: int = 0
    device_s: float = 0.0
    buckets: List[Dict[str, float]] = field(default_factory=list)
    virtual_s: float = 0.0
    wall_s: float = 0.0


class ScenarioDriver:
    """Plays one compiled scenario against one target."""

    def __init__(self, spec: ScenarioSpec, target: Any, *,
                 clock: Optional[Clock] = None, scale: float = 1.0,
                 checker: Optional[Any] = None) -> None:
        from llmq_tpu_torch.chaos import InvariantChecker
        self.spec = spec
        self.target = target
        self.scale = scale
        self.clock = clock or SYSTEM_CLOCK
        self.checker = checker or InvariantChecker()
        self.compiled: Optional[CompiledScenario] = None
        self.stats = RunStats()
        self._virtual = hasattr(self.clock, "advance")
        self._vnow = 0.0
        self._seq = 0
        #: (t, seq, kind, payload) event heap; kinds: "turn" | "chaos".
        self._events: List[Tuple[float, int, str, Any]] = []
        self._inflight: Dict[str, _Attempt] = {}
        self._bucket_s = 1.0
        self._slo_ttft_ms: Optional[float] = None

    # -- event plumbing ------------------------------------------------------

    def _push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self._events, (t, self._seq, kind, payload))
        self._seq += 1

    def _advance_to(self, t: float) -> None:
        if t <= self._vnow:
            return
        if self._virtual:
            self.clock.advance(t - self._vnow)
        else:
            self.clock.sleep(t - self._vnow)
        self._vnow = t

    def _bucket(self, v: float) -> Dict[str, float]:
        idx = int(v / self._bucket_s)
        while len(self.stats.buckets) <= idx:
            self.stats.buckets.append({
                "t_start": len(self.stats.buckets) * self._bucket_s,
                "submitted": 0, "completed": 0, "failed": 0,
                "tokens_out": 0, "slo_met_tokens": 0,
                "device_s": 0.0})
        return self.stats.buckets[idx]

    # -- setup ---------------------------------------------------------------

    def _configure_planes(self) -> None:
        spec = self.spec
        if spec.chaos_events:
            from llmq_tpu_torch import chaos
            from llmq_tpu_torch.core.config import ChaosConfig
            chaos.configure(ChaosConfig(enabled=True, seed=spec.seed))
        if spec.tenancy:
            from llmq_tpu_torch.core.config import (TenancyConfig,
                                                    TenantClassConfig)
            from llmq_tpu_torch.tenancy import configure_tenancy
            default = TenantClassConfig(
                **{str(k).replace("-", "_"): v for k, v in
                   (spec.tenancy.get("default") or {}).items()})
            cfg = TenancyConfig(
                enabled=bool(spec.tenancy.get("enabled", True)),
                tenants=dict(spec.tenancy.get("tenants") or {}),
                default=default,
                share_window_s=float(
                    spec.tenancy.get("share_window_s", 60.0)))
            configure_tenancy(cfg)

    # -- client state machine ------------------------------------------------

    def _prompt_text(self, client: _Client, plan: TurnPlan) -> str:
        cid = client.arrival.conversation_id
        stem = f"{cid} turn {client.turn}: "
        filler = (cid + " lorem ").ljust(8, "x")
        body = (filler * (plan.prompt_chars // len(filler) + 1))
        return (stem + body)[:max(len(stem) + 1, plan.prompt_chars)]

    def _admit(self, client: _Client, plan: TurnPlan,
               rid: str) -> bool:
        """Tenant-quota admission edge (only when the spec carries a
        tenancy block): mirrors the API shedder's token-bucket check,
        which is what mints registry state under an id spray."""
        if not self.spec.tenancy:
            return True
        from llmq_tpu_torch.tenancy import get_tenant_registry
        reg = get_tenant_registry()
        if not reg.enabled:
            return True
        est = plan.prompt_chars // 4 + plan.output_tokens
        ok, _retry_after = reg.admit_tokens(client.arrival.tenant, est)
        if not ok:
            reg.note_rejection("rate")
        return ok

    def _submit_turn(self, client: _Client) -> None:
        from llmq_tpu_torch.engine.engine import GenRequest
        arrival = client.arrival
        plan = arrival.turns[client.turn]
        rid = f"{arrival.conversation_id}.t{client.turn}"
        self.checker.submitted(rid)
        if not self._admit(client, plan, rid):
            self.checker.shed(rid, status=429)
            self.stats.shed += 1
            return  # conversation ends here: quota said no
        prompt = self._prompt_text(client, plan)
        req = GenRequest(
            id=rid, prompt=prompt,
            priority=Priority.from_name(arrival.priority),
            conversation_id=arrival.conversation_id,
            history_text=client.history,
            max_new_tokens=plan.output_tokens,
            tenant_id=arrival.tenant)
        handle = self.target.submit(req,
                                    on_token=self.checker.on_token(rid))
        b = self._bucket(self._vnow)
        b["submitted"] += 1
        self.stats.submitted += 1
        self._inflight[rid] = _Attempt(
            rid=rid, client=client, plan=plan, handle=handle,
            submitted_v=self._vnow)

    def _retry_turn(self, att: _Attempt) -> None:
        from llmq_tpu_torch.engine.engine import GenRequest
        client = att.client
        arrival = client.arrival
        n = att.attempt + 1
        rid = f"{arrival.conversation_id}.t{client.turn}.r{n}"
        self.checker.submitted(rid)
        prompt = self._prompt_text(client, att.plan)
        req = GenRequest(
            id=rid, prompt=prompt,
            priority=Priority.from_name(arrival.priority),
            conversation_id=arrival.conversation_id,
            history_text=client.history,
            max_new_tokens=att.plan.output_tokens,
            tenant_id=arrival.tenant)
        handle = self.target.submit(req,
                                    on_token=self.checker.on_token(rid))
        b = self._bucket(self._vnow)
        b["submitted"] += 1
        self.stats.submitted += 1
        self.stats.retried += 1
        self._inflight[rid] = _Attempt(
            rid=rid, client=client, plan=att.plan, handle=handle,
            submitted_v=self._vnow, attempt=n)

    def _on_complete(self, att: _Attempt,
                     result: Dict[str, Any]) -> None:
        client = att.client
        b = self._bucket(att.submitted_v)
        if result["ok"]:
            self.checker.completed(att.rid,
                                   tokens=result.get("token_ids"))
            self.stats.completed += 1
            b["completed"] += 1
            tokens = result["tokens"]
            self.stats.tokens_out += tokens
            self.stats.prompt_tokens += result["prompt_tokens"]
            tenant = client.arrival.tenant
            self.stats.tenant_tokens[tenant] = (
                self.stats.tenant_tokens.get(tenant, 0)
                + tokens + result["prompt_tokens"])
            tier = result["kv_tier"] or "none"
            self.stats.tier_hits[tier] = (
                self.stats.tier_hits.get(tier, 0) + 1)
            dev = result["device_s"]
            self.stats.device_s += dev
            b["tokens_out"] += tokens
            b["device_s"] += dev
            met = True
            if (self._slo_ttft_ms is not None
                    and result["ttft_ms"] is not None
                    and result["ttft_ms"] > self._slo_ttft_ms):
                met = False
            if met:
                self.stats.slo_met_requests += 1
                self.stats.slo_met_tokens += tokens
                b["slo_met_tokens"] += tokens
            # Grow the history the next turn re-arrives with (prefix
            # growth — the radix/tiering workload).
            client.history += self._prompt_text(client, att.plan) \
                + result["text"]
            client.turn += 1
            if client.turn < len(client.arrival.turns):
                think = client.arrival.turns[client.turn].think_s
                self._push(self._vnow + think, "turn", client)
            return
        # Failure: explicit terminal for this attempt, then (maybe)
        # a client retry under a NEW id — the crash-recovery contract
        # the chaos lane pins.
        self.checker.failed(att.rid, reason=result["error"])
        self.stats.failed += 1
        b["failed"] += 1
        if client.retries_left > 0:
            client.retries_left -= 1
            self._retry_turn(att)
        # else: conversation abandoned (still a clean terminal).

    # -- pump ----------------------------------------------------------------

    def _drain_inflight(self) -> None:
        """Wait (real time) for every in-flight attempt to reach a
        terminal state, recovering crashed engines as we go. Virtual
        time does not move here — service is instantaneous on the
        scenario clock; only think-times and arrival gaps advance it."""
        deadline = time.perf_counter() + _TICK_WALL_TIMEOUT_S
        while self._inflight:
            progressed = False
            for rid in list(self._inflight):
                att = self._inflight[rid]
                result = self.target.poll(att.handle)
                if result is None:
                    continue
                del self._inflight[rid]
                self._on_complete(att, result)
                progressed = True
            if not self._inflight:
                break
            if self.target.check_recover():
                self.stats.recoveries += 1
                progressed = True
            if progressed:
                deadline = time.perf_counter() + _TICK_WALL_TIMEOUT_S
                continue
            if time.perf_counter() > deadline:
                stuck = sorted(self._inflight)
                raise RuntimeError(
                    f"scenario {self.spec.name!r} wedged: "
                    f"{len(stuck)} attempts stuck "
                    f"(first: {stuck[:3]}) at v={self._vnow:.2f}s")
            time.sleep(_POLL_S)

    def _fire_chaos(self, ev: Any) -> None:
        from llmq_tpu_torch.chaos import get_injector
        inj = get_injector()
        if inj is None:
            return
        inj.add_rule(ev.point, kind=ev.kind, times=ev.times,
                     latency_ms=ev.latency_ms,
                     match=None if not ev.match
                     else {"engine": ev.match})
        self.stats.chaos_fired += 1
        log.info("scenario %s: chaos %s@%s armed at v=%.2fs",
                 self.spec.name, ev.kind, ev.point, self._vnow)

    # -- run -----------------------------------------------------------------

    def run(self) -> RunStats:
        wall_start = time.perf_counter()
        compiled = compile_scenario(self.spec, self.scale)
        self.compiled = compiled
        self.stats.conversations = len(compiled.arrivals)
        self.stats.turns_planned = compiled.total_turns
        duration = self.spec.duration_s
        self._bucket_s = (self.spec.bucket_s
                          or max(duration / 8.0, self.spec.tick_s))
        self._configure_planes()
        try:
            from llmq_tpu_torch.observability.slo import get_slo_tracker
            self._slo_ttft_ms = get_slo_tracker().targets.get("ttft")
        except Exception:  # noqa: BLE001 — SLO plane absent = no gate
            self._slo_ttft_ms = None
        for a in compiled.arrivals:
            self._push(a.t, "turn",
                       _Client(arrival=a,
                               retries_left=self.spec.retries))
        for ev in compiled.chaos:
            self._push(ev.at_s, "chaos", ev)
        tick = max(self.spec.tick_s, 1e-3)
        while self._events:
            window_end = self._events[0][0] + tick
            while self._events and self._events[0][0] <= window_end:
                t, _, kind, payload = heapq.heappop(self._events)
                self._advance_to(t)
                if kind == "chaos":
                    self._fire_chaos(payload)
                else:
                    self._submit_turn(payload)
            self._drain_inflight()
        self.stats.virtual_s = max(self._vnow, duration)
        self.stats.wall_s = time.perf_counter() - wall_start
        return self.stats
