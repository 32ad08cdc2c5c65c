"""Scenario scorer: joins driver stats with the usage/trace planes (the
port's copy of ``llmq_tpu/scenarios/scorer.py``).

One scenario run produces one report (``SCENARIO_<name>.json``): the
usage ledger's goodput (SLO-met tokens per attributed device-second —
the north-star metric, not p99), per-tenant share error against the
compiled schedule's planned mix, the ledger's waste decomposition,
the tiering/prefix-cache hit breakdown, SLO attainment, the chaos
invariant summary, and a virtual-time goodput timeline (what the
conversation_soak_100k acceptance bar — "goodput within 10% of steady
state through one diurnal cycle + two kills" — is asserted against).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.scenarios.driver import RunStats
from llmq_tpu_torch.scenarios.spec import CompiledScenario

#: Report schema version (bump on breaking field changes).
REPORT_VERSION = 1


def _share_error(compiled: CompiledScenario,
                 stats: RunStats) -> Dict[str, Any]:
    """Per-tenant achieved token share vs the compiled schedule's
    planned share. Sprayed (per-conversation) tenants are collapsed
    into one ``sprayed`` row — 10^5 rows of one conversation each is
    noise, not signal."""
    planned = compiled.planned_tenant_tokens()
    sprayed_prefixes = [p.tenant_prefix
                        for p in compiled.spec.populations
                        if p.tenant_prefix]

    def collapse(label: str) -> str:
        for pre in sprayed_prefixes:
            if label.startswith(pre):
                return "sprayed"
        return label

    plan: Dict[str, int] = {}
    for t, n in planned.items():
        plan[collapse(t)] = plan.get(collapse(t), 0) + n
    actual: Dict[str, int] = {}
    for t, n in stats.tenant_tokens.items():
        actual[collapse(t)] = actual.get(collapse(t), 0) + n
    plan_total = sum(plan.values()) or 1
    actual_total = sum(actual.values()) or 1
    tenants: Dict[str, Dict[str, float]] = {}
    max_err = 0.0
    for t in sorted(set(plan) | set(actual)):
        expected = plan.get(t, 0) / plan_total
        achieved = actual.get(t, 0) / actual_total
        err = achieved - expected
        max_err = max(max_err, abs(err))
        tenants[t] = {"expected_share": round(expected, 4),
                      "achieved_share": round(achieved, 4),
                      "error": round(err, 4)}
    return {"tenants": tenants, "max_abs_error": round(max_err, 4)}


def _engine_breakdown(engines: List[Any]) -> Dict[str, Any]:
    """Aggregate tiering + prefix-cache visibility across the target's
    engines (empty for remote targets — the driver-side kv_tier counts
    still populate the tier_hits field)."""
    tier_hits: Dict[str, int] = {}
    tiering: Dict[str, Any] = {}
    prefix: Dict[str, Any] = {}
    for e in engines:
        try:
            st = e.get_stats()
        except Exception:  # noqa: BLE001 — a dead replica scores as absent
            continue
        kv = st.get("kv_tiering") or {}
        for t, n in (kv.get("hits") or {}).items():
            tier_hits[t] = tier_hits.get(t, 0) + int(n)
        for k in ("demotions", "promotions", "spills", "round_trips",
                  "host_entries", "store_entries"):
            if k in kv:
                tiering[k] = tiering.get(k, 0) + int(kv[k])
        pc = st.get("prefix_cache") or {}
        for k in ("admission_hits", "admission_misses"):
            if k in pc:
                prefix[k] = prefix.get(k, 0) + int(pc[k])
    return {"plane_hits": tier_hits, "tiering": tiering,
            "prefix_cache": prefix}


def goodput_timeline(stats: RunStats) -> List[Dict[str, float]]:
    """Per-virtual-bucket goodput (SLO-met tokens per device-second);
    buckets with no attributed device time score 0."""
    out = []
    for b in stats.buckets:
        dev = b["device_s"]
        out.append({**b,
                    "goodput_tps": (round(b["slo_met_tokens"] / dev, 1)
                                    if dev > 0 else 0.0)})
    return out


def build_report(compiled: CompiledScenario, stats: RunStats, *,
                 checker: Any, engines: List[Any],
                 flush: bool = True) -> Dict[str, Any]:
    """Assemble one scenario's scorecard.

    ``flush=True`` drives the recorder→ledger metrics join first (the
    goodput window is FED by FlightRecorder.flush_metrics — same
    contract as the /metrics scrape chain)."""
    from llmq_tpu_torch.observability.usage import get_usage_ledger
    ledger = get_usage_ledger()
    if flush:
        try:
            from llmq_tpu_torch.observability.recorder import get_recorder
            get_recorder().flush_metrics()
        except Exception:  # noqa: BLE001 — report degrades, never dies
            pass
    snap = ledger.snapshot(top_conversations=0)
    spec = compiled.spec
    violations = checker.violations()
    invariants = checker.summary()
    invariants["violations"] = len(violations)
    if violations:
        invariants["violation_samples"] = violations[:10]
    requests = {
        "conversations": stats.conversations,
        "turns_planned": stats.turns_planned,
        "submitted": stats.submitted,
        "completed": stats.completed,
        "failed": stats.failed,
        "retried": stats.retried,
        "shed": stats.shed,
        "chaos_events_fired": stats.chaos_fired,
        "engine_recoveries": stats.recoveries,
    }
    slo_total = stats.completed or 1
    report: Dict[str, Any] = {
        "version": REPORT_VERSION,
        "scenario": spec.name,
        "seed": spec.seed,
        "scale": compiled.scale,
        "schedule_digest": compiled.schedule_digest(),
        "duration": {"virtual_s": round(stats.virtual_s, 3),
                     "wall_s": round(stats.wall_s, 3),
                     "compression": (round(stats.virtual_s
                                           / stats.wall_s, 1)
                                     if stats.wall_s > 0 else 0.0)},
        "requests": requests,
        "tokens": {"generated": stats.tokens_out,
                   "prompt": stats.prompt_tokens},
        "goodput": snap.get("goodput", ledger.goodput()),
        "driver_goodput_tps": (round(stats.slo_met_tokens
                                     / stats.device_s, 1)
                               if stats.device_s > 0 else 0.0),
        "slo": {"attainment": round(stats.slo_met_requests
                                    / slo_total, 4),
                "met_requests": stats.slo_met_requests,
                "met_tokens": stats.slo_met_tokens},
        "share_error": _share_error(compiled, stats),
        "waste": {"by_reason": snap.get("waste_by_reason", {}),
                  "ratio": snap.get("totals", {}).get(
                      "waste_ratio", 0.0)},
        "tier_hits": {"requests_by_tier": dict(stats.tier_hits),
                      **_engine_breakdown(engines)},
        "invariants": invariants,
        "timeline": goodput_timeline(stats),
    }
    if spec.tenancy:
        from llmq_tpu_torch.tenancy import get_tenant_registry
        reg = get_tenant_registry()
        report["tenancy"] = {
            "rejections": dict(reg.rejections_total),
            "registry_evictions": reg.evictions_total,
        }
    try:
        # Critical-path rollup (observability/critical_path.py): where
        # the scenario's request time went, per segment — fed by the
        # same recorder flush as the goodput window above.
        from llmq_tpu_torch.observability.critical_path import (
            get_critical_path)
        ana = get_critical_path()
        if ana.enabled and ana.requests > 0:
            cp = ana.snapshot(recent=0)
            report["critical_path"] = {
                "requests": cp["requests"],
                "conservation_failures": cp["conservation_failures"],
                "totals_ms": cp["totals_ms"],
                "share": cp["share"],
                "dominant": cp["dominant"],
            }
    except Exception:  # noqa: BLE001 — report degrades, never dies
        pass
    return report


def write_report(report: Dict[str, Any],
                 out_dir: str = ".") -> str:
    """Emit ``SCENARIO_<name>.json`` and return its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"SCENARIO_{report['scenario']}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=False)
        f.write("\n")
    return path


def steady_state_deviation(report: Dict[str, Any],
                           skip_buckets: int = 1,
                           min_fraction: float = 0.05) -> Optional[float]:
    """Max relative deviation of per-bucket goodput from the run's
    steady state (median bucket goodput), ignoring the first
    ``skip_buckets`` warmup buckets and low-sample buckets (fewer than
    ``min_fraction`` of the busiest bucket's completions — the drain
    tail after the last phase ends, where a handful of straggler
    follow-ups make per-bucket goodput statistical noise). The soak
    acceptance bar asserts this ≤ 0.10."""
    buckets = report["timeline"][skip_buckets:]
    floor = min_fraction * max(
        (b["completed"] for b in buckets), default=0)
    vals = [b["goodput_tps"] for b in buckets
            if b["completed"] >= max(1, floor) and b["goodput_tps"] > 0]
    if len(vals) < 2:
        return None
    ordered = sorted(vals)
    median = ordered[len(ordered) // 2]
    if median <= 0:
        return None
    return max(abs(v - median) / median for v in vals)
