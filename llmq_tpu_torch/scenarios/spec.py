"""Scenario spec model + deterministic workload compiler (the port's copy
of ``llmq_tpu/scenarios/spec.py``).

A scenario is a declarative description of *who* talks to the system
and *when* (docs/scenarios.md): phases with arrival processes, client
populations with multi-turn conversation shapes, and chaos events.
:func:`compile_scenario` turns a spec into a fully materialized
schedule — every conversation start time, every turn's prompt/output
size and think time, every tenant assignment — using nothing but the
spec's seed, so the same spec + seed yields the *identical* schedule
(pinned by tests/test_torch_scenarios.py, which holds the digest equal
to the JAX package's compiler's). The driver then plays that
schedule closed-loop: turn k+1 of a conversation is only released
after turn k completes plus the compiled think time, which is the
regime the arrival literature says breaks open-loop Poisson benches
(PAPERS.md arxiv 2606.01839).

Everything here is plain data — no engine, clock or metrics imports —
so compiling a 10^5-conversation soak schedule is cheap and the module
carries zero serving-path cost.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import math
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import yaml

#: Arrival process kinds understood by the compiler.
ARRIVAL_KINDS = ("poisson", "diurnal", "flash_crowd", "replay")

#: Chaos event kinds forwarded to the injector (chaos/injector.py).
CHAOS_KINDS = ("crash", "error", "timeout", "partial", "oserror",
               "latency")


@dataclass
class ArrivalSpec:
    """One phase's conversation-arrival process.

    ``poisson`` is a constant-rate Poisson process; ``diurnal`` is a
    non-homogeneous Poisson whose rate follows one sine cycle between
    ``rate`` (trough) and ``peak_rate`` over ``period_s``;
    ``flash_crowd`` adds ``step_rate`` on top of ``rate`` during
    ``[step_at_s, step_at_s + step_duration_s)``; ``replay`` reads
    arrival offsets from ``trace_file`` (JSON lines). A diurnal spec
    may also carry a step — that is exactly the
    diurnal_tenant_mix_with_flash_crowd shipped scenario."""
    kind: str = "poisson"
    rate: float = 10.0
    peak_rate: float = 0.0
    period_s: float = 0.0
    step_rate: float = 0.0
    step_at_s: float = 0.0
    step_duration_s: float = 0.0
    trace_file: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"arrival kind {self.kind!r} not in {ARRIVAL_KINDS}")
        if self.kind == "replay" and not self.trace_file:
            raise ValueError("replay arrival needs trace_file")

    def rate_at(self, t: float, duration_s: float) -> float:
        """Instantaneous arrival rate at phase-relative time ``t``."""
        r = self.rate
        if self.kind == "diurnal":
            period = self.period_s or duration_s or 1.0
            peak = max(self.peak_rate, self.rate)
            # One full cycle: trough at t=0, peak at period/2.
            r += (peak - self.rate) * 0.5 * (
                1.0 - math.cos(2.0 * math.pi * t / period))
        if self.step_rate > 0 and self.step_duration_s > 0:
            if self.step_at_s <= t < self.step_at_s + self.step_duration_s:
                r += self.step_rate
        return max(0.0, r)

    def max_rate(self, duration_s: float) -> float:
        """Upper bound on ``rate_at`` (thinning envelope)."""
        r = max(self.rate, self.peak_rate)
        if self.step_rate > 0 and self.step_duration_s > 0:
            r += self.step_rate
        return max(r, 1e-9)


@dataclass
class PopulationSpec:
    """A client population: how its conversations are shaped.

    Token counts are *plan* figures; the compiler materializes prompts
    as ``~4 chars/token`` text (the admission-path estimate the whole
    repo shares — tenancy/registry.py). ``tenant_prefix`` mints one
    unique tenant id per conversation (the adversarial id-spray
    shape); otherwise tenants are drawn from the ``tenants`` weight
    map."""
    name: str = "default"
    weight: float = 1.0
    tenants: Dict[str, float] = field(default_factory=dict)
    tenant_prefix: str = ""
    priority: str = "normal"
    turns_min: int = 1
    turns_max: int = 1
    #: Mean of the exponential think-time between a turn's completion
    #: and the next turn's arrival (0 = immediate re-arrival).
    think_time_s: float = 0.0
    prompt_tokens_min: int = 16
    prompt_tokens_max: int = 32
    #: New user text per follow-up turn — the *prefix growth* each
    #: re-arrival carries into the radix cache / tiering plane.
    followup_tokens_min: int = 8
    followup_tokens_max: int = 16
    output_tokens_min: int = 8
    output_tokens_max: int = 16

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError("population weight must be > 0")
        if self.turns_min < 1 or self.turns_max < self.turns_min:
            raise ValueError("bad turn depth range")


@dataclass
class PhaseSpec:
    """One timed slice of the scenario: an arrival process feeding a
    subset of populations (``populations: []`` = all of them)."""
    name: str = "phase"
    duration_s: float = 10.0
    arrival: ArrivalSpec = field(default_factory=ArrivalSpec)
    populations: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.duration_s <= 0:
            raise ValueError("phase duration must be > 0")


@dataclass
class ChaosEventSpec:
    """A chaos-plane event at a named scenario time: the driver arms
    one seeded injector rule (chaos/injector.py FaultRule) when the
    virtual clock reaches ``at_s``."""
    at_s: float = 0.0
    point: str = "engine.step"
    kind: str = "crash"
    times: int = 1
    latency_ms: float = 0.0
    match: str = ""

    def __post_init__(self) -> None:
        if self.kind not in CHAOS_KINDS:
            raise ValueError(
                f"chaos kind {self.kind!r} not in {CHAOS_KINDS}")


@dataclass
class ScenarioSpec:
    """A full scenario: phases × populations × chaos, one seed."""
    name: str = "scenario"
    seed: int = 0
    phases: List[PhaseSpec] = field(default_factory=list)
    populations: List[PopulationSpec] = field(default_factory=list)
    chaos_events: List[ChaosEventSpec] = field(default_factory=list)
    #: Hard cap on compiled conversations (0 = whatever the arrival
    #: process yields). Scaled by the run's ``scale`` factor.
    max_conversations: int = 0
    #: Driver batching granularity in virtual seconds: arrivals due
    #: within one tick are submitted together (that is the batch the
    #: engine sees).
    tick_s: float = 0.25
    #: Timeline bucket width for the scorer (0 = duration / 8).
    bucket_s: float = 0.0
    #: Optional tenancy block applied for the run's duration
    #: (TenancyConfig shape: enabled/default/tenants/share_window_s) —
    #: the adversarial quota-probe scenario carries one.
    tenancy: Dict[str, Any] = field(default_factory=dict)
    #: Client retries after a failed/crashed request (at-least-once
    #: from the client's seat; the invariant checker still demands
    #: exactly-one terminal per attempt id).
    retries: int = 2

    @property
    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)


# -- compiled form -------------------------------------------------------------


@dataclass
class TurnPlan:
    """One planned conversation turn."""
    prompt_chars: int
    output_tokens: int
    think_s: float


@dataclass
class Arrival:
    """One compiled conversation: start time + full turn plan."""
    t: float
    conversation_id: str
    tenant: str
    priority: str
    population: str
    turns: List[TurnPlan]


@dataclass
class CompiledScenario:
    """The materialized schedule the driver plays."""
    spec: ScenarioSpec
    scale: float
    arrivals: List[Arrival]
    chaos: List[ChaosEventSpec]

    @property
    def total_turns(self) -> int:
        return sum(len(a.turns) for a in self.arrivals)

    def planned_tenant_tokens(self) -> Dict[str, int]:
        """tenant → planned (prompt-estimate + output) tokens; the
        scorer's *expected share* denominator."""
        out: Dict[str, int] = {}
        for a in self.arrivals:
            tok = sum(t.prompt_chars // 4 + t.output_tokens
                      for t in a.turns)
            out[a.tenant] = out.get(a.tenant, 0) + tok
        return out

    def schedule_digest(self) -> str:
        """Stable hash of the full schedule — what the determinism
        test pins (same spec + seed ⇒ same digest)."""
        h = hashlib.sha256()
        for a in self.arrivals:
            h.update((f"{a.t:.6f}|{a.conversation_id}|{a.tenant}|"
                      f"{a.priority}").encode())
            for t in a.turns:
                h.update((f"|{t.prompt_chars},{t.output_tokens},"
                          f"{t.think_s:.6f}").encode())
        return h.hexdigest()


# -- spec loading --------------------------------------------------------------


def _build(cls: type, data: Dict[str, Any]) -> Any:
    """Construct a spec dataclass from a raw dict, rejecting unknown
    keys (same contract as core.config._merge)."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**data)


def spec_from_dict(data: Dict[str, Any]) -> ScenarioSpec:
    """Build a :class:`ScenarioSpec` from a plain dict (YAML-shaped)."""
    d = dict(data)
    phases = []
    for p in d.pop("phases", []) or []:
        p = dict(p)
        arrival = _build(ArrivalSpec, dict(p.pop("arrival", {}) or {}))
        phases.append(_build(PhaseSpec, {**p, "arrival": arrival}))
    pops = [_build(PopulationSpec, dict(p))
            for p in d.pop("populations", []) or []]
    chaos = [_build(ChaosEventSpec, dict(c))
             for c in d.pop("chaos_events", []) or []]
    spec = _build(ScenarioSpec, {
        **d, "phases": phases, "populations": pops,
        "chaos_events": chaos})
    if not spec.phases:
        raise ValueError(f"scenario {spec.name!r} has no phases")
    if not spec.populations:
        raise ValueError(f"scenario {spec.name!r} has no populations")
    return spec


def load_scenario_file(path: str) -> ScenarioSpec:
    """Load one scenario YAML file."""
    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: scenario YAML must be a mapping")
    data.setdefault("name",
                    os.path.splitext(os.path.basename(path))[0])
    return spec_from_dict(data)


# -- compiler ------------------------------------------------------------------

#: Stream offsets for the per-concern RNGs (chaos/injector.py uses the
#: same ``seed * 1000003 + k`` derivation for per-rule streams).
_STREAM_ARRIVALS = 1
_STREAM_ASSIGN = 2
_STREAM_TURNS = 3

#: ~4 chars/token — the admission-path estimate shared repo-wide.
_CHARS_PER_TOKEN = 4


def _phase_arrivals(arr: ArrivalSpec, duration: float, scale: float,
                    rng: random.Random) -> List[float]:
    """Phase-relative arrival offsets for one phase (thinning for the
    non-homogeneous kinds; file replay for ``replay``)."""
    if arr.kind == "replay":
        out = []
        with open(arr.trace_file, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                t = float(rec["at"] if isinstance(rec, dict) else rec)
                if 0.0 <= t < duration:
                    out.append(t)
        out.sort()
        return out
    cap = arr.max_rate(duration) * scale
    out = []
    t = 0.0
    while True:
        t += rng.expovariate(cap)
        if t >= duration:
            break
        if rng.random() * cap <= arr.rate_at(t, duration) * scale:
            out.append(t)
    return out


def _pick_tenant(pop: PopulationSpec, conv_index: int,
                 rng: random.Random) -> str:
    if pop.tenant_prefix:
        return f"{pop.tenant_prefix}{conv_index}"
    tenants = pop.tenants or {"anon": 1.0}
    names = sorted(tenants)
    weights = [float(tenants[n]) for n in names]
    return rng.choices(names, weights=weights, k=1)[0]


def _plan_turns(pop: PopulationSpec, rng: random.Random) -> List[TurnPlan]:
    depth = rng.randint(pop.turns_min, pop.turns_max)
    turns = []
    for k in range(depth):
        lo, hi = ((pop.prompt_tokens_min, pop.prompt_tokens_max)
                  if k == 0 else
                  (pop.followup_tokens_min, pop.followup_tokens_max))
        prompt_tokens = rng.randint(lo, max(lo, hi))
        output = rng.randint(pop.output_tokens_min,
                             max(pop.output_tokens_min,
                                 pop.output_tokens_max))
        think = (rng.expovariate(1.0 / pop.think_time_s)
                 if pop.think_time_s > 0 else 0.0)
        turns.append(TurnPlan(prompt_chars=prompt_tokens
                              * _CHARS_PER_TOKEN,
                              output_tokens=output, think_s=think))
    return turns


def compile_scenario(spec: ScenarioSpec,
                     scale: float = 1.0) -> CompiledScenario:
    """Materialize the full schedule from the spec's seed.

    ``scale`` multiplies arrival rates and the conversation cap —
    nothing else — so a reduced-scale CI run is a thinned sample of
    the same scenario, not a different one."""
    if scale <= 0:
        raise ValueError("scale must be > 0")
    rng_arr = random.Random(spec.seed * 1000003 + _STREAM_ARRIVALS)
    rng_assign = random.Random(spec.seed * 1000003 + _STREAM_ASSIGN)
    rng_turns = random.Random(spec.seed * 1000003 + _STREAM_TURNS)
    pop_by_name = {p.name: p for p in spec.populations}
    cap = int(spec.max_conversations * scale) or 0
    arrivals: List[Arrival] = []
    merged: List[Tuple[float, int, PopulationSpec]] = []
    offset = 0.0
    seq = 0
    for phase in spec.phases:
        pops = ([pop_by_name[n] for n in phase.populations]
                if phase.populations else spec.populations)
        for n in phase.populations:
            if n not in pop_by_name:
                raise ValueError(
                    f"phase {phase.name!r} names unknown population "
                    f"{n!r}")
        offsets = _phase_arrivals(phase.arrival, phase.duration_s,
                                  scale, rng_arr)
        weights = [p.weight for p in pops]
        for t in offsets:
            pop = rng_assign.choices(pops, weights=weights, k=1)[0]
            merged.append((offset + t, seq, pop))
            seq += 1
        offset += phase.duration_s
    heapq.heapify(merged)
    idx = 0
    while merged:
        t, _, pop = heapq.heappop(merged)
        if cap and idx >= cap:
            break
        arrivals.append(Arrival(
            t=t,
            conversation_id=f"{spec.name}-c{idx}",
            tenant=_pick_tenant(pop, idx, rng_assign),
            priority=pop.priority,
            population=pop.name,
            turns=_plan_turns(pop, rng_turns)))
        idx += 1
    chaos = sorted(spec.chaos_events, key=lambda c: c.at_s)
    return CompiledScenario(spec=spec, scale=scale,
                            arrivals=arrivals, chaos=chaos)
