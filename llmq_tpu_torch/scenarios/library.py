"""Named-scenario library + the one-call run entrypoint (the port's copy
of ``llmq_tpu/scenarios/library.py``).

The shipped scenarios live as YAML specs under ``configs/scenarios/``
(docs/scenarios.md documents each): ``agentic_tool_loops``,
``rag_long_prompt_flood``, ``diurnal_tenant_mix_with_flash_crowd``,
``adversarial_id_spray_quota_probe``, ``conversation_soak_100k``,
``disagg_long_prompt_handoff``, ``store_brownout``.
:func:`run_scenario` is what the bench section, the CI lane and the
tests all call — build (or accept) a target, play the schedule on a
FakeClock, score, optionally emit ``SCENARIO_<name>.json``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from llmq_tpu_torch.core.clock import Clock
from llmq_tpu_torch.scenarios.driver import (EngineTarget, ScenarioDriver,
                                             make_echo_engine)
from llmq_tpu_torch.scenarios.scorer import build_report, write_report
from llmq_tpu_torch.scenarios.spec import (ScenarioSpec, load_scenario_file,
                                           spec_from_dict)

#: The shipped named scenarios (one YAML each under ``scenario_dir``).
SHIPPED = ("agentic_tool_loops", "rag_long_prompt_flood",
           "diurnal_tenant_mix_with_flash_crowd",
           "adversarial_id_spray_quota_probe",
           "conversation_soak_100k", "disagg_long_prompt_handoff",
           "store_brownout")


def scenario_dir(configured: str = "") -> str:
    """Resolve the scenario spec directory: an explicit setting wins,
    else the repo's ``configs/scenarios/`` relative to this package (the
    JAX package's specs, read as data).
    A relative setting that doesn't exist from the current working
    directory (the config default run from elsewhere) anchors at the
    repo root instead."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    if configured:
        if os.path.isabs(configured) or os.path.isdir(configured):
            return configured
        return os.path.join(repo, configured)
    return os.path.join(repo, "configs", "scenarios")


def list_scenarios(directory: str = "") -> List[str]:
    d = scenario_dir(directory)
    if not os.path.isdir(d):
        return []
    return sorted(os.path.splitext(f)[0] for f in os.listdir(d)
                  if f.endswith((".yaml", ".yml")))


def load_named(name: str, directory: str = "") -> ScenarioSpec:
    """Load one named scenario spec from the scenario directory."""
    d = scenario_dir(directory)
    for ext in (".yaml", ".yml"):
        path = os.path.join(d, name + ext)
        if os.path.exists(path):
            return load_scenario_file(path)
    raise FileNotFoundError(
        f"scenario {name!r} not found in {d} "
        f"(known: {list_scenarios(directory)})")


class _StoreTarget(EngineTarget):
    """EngineTarget whose engine rides a resilience-wrapped store:
    tiering spill + KV exchange + conversation state all share the ONE
    wrapped backend, so a ``store.*`` chaos rule browns out every
    store-backed plane at once (docs/robustness.md "Store fault
    domain")."""

    def __init__(self, engine: Any, state_manager: Any,
                 store: Any) -> None:
        super().__init__(engine, own=True)
        self.state_manager = state_manager
        self.store = store

    def stop(self) -> None:
        super().stop()
        try:
            self.store.close()
        except Exception:  # noqa: BLE001 — teardown must not mask the run
            pass


def store_tiering() -> Any:
    """The tiering plane a ``store.*`` scenario's engine runs: a 1 MiB
    host tier of 32 conversations spilling to the store, so re-arrivals
    promote through the store tier the chaos rule browns out."""
    from llmq_tpu_torch.core.config import KVTieringConfig
    return KVTieringConfig(enabled=True, host_capacity_mb=1,
                           host_max_conversations=32, store_spill=True)


def _store_target(spec: ScenarioSpec, rcfg: Any = None, *,
                  engine: Any = None) -> _StoreTarget:
    """Build the store-backed target a ``store.*`` scenario needs: an
    engine with the tiering plane enabled, a state manager, and a
    KV exchange — all over one ``ResilientKVStore``-wrapped
    InMemoryStore. Tuned for the compressed clock: sub-second breaker
    backoff and probe interval so blackout recovery happens inside the
    run, not minutes of wall time later. ``rcfg`` overrides the
    resilience config (the bench's no-domain A/B leg passes a
    neutralized one that keeps the chaos seam but removes every
    protection). ``engine`` (a parameter JAX's lacks) is the engine to
    wire, built with :func:`store_tiering` for the store tier to be
    faulted; without one an echo engine is built, as in JAX. The target
    owns and stops it either way."""
    from llmq_tpu_torch.conversation.persistence import InMemoryStore
    from llmq_tpu_torch.conversation.resilience import wrap_store
    from llmq_tpu_torch.conversation.state_manager import StateManager
    from llmq_tpu_torch.core.config import (BreakerConfig,
                                            ConversationConfig,
                                            StoreResilienceConfig)
    from llmq_tpu_torch.disagg.exchange import KVExchange

    if rcfg is None:
        rcfg = StoreResilienceConfig(
            enabled=True, op_timeout_s=0.3, retries=2,
            timeout_threshold=3, probe_interval_s=0.05,
            seed=spec.seed or 1,
            breaker=BreakerConfig(enabled=True, failure_threshold=3,
                                  base_backoff=0.2, max_backoff=1.0))
    store = wrap_store(InMemoryStore(), rcfg)
    if engine is None:
        engine = make_echo_engine(f"scn-{spec.name}",
                                  kv_tiering=store_tiering())
    sm = StateManager(ConversationConfig(persist=True), store=store)
    engine.attach_conversation_manager(sm)
    if engine._tiering is not None:  # noqa: SLF001 — test/tool wiring
        engine._tiering.exchange = KVExchange(  # noqa: SLF001
            store, role="unified", metrics=False)
    return _StoreTarget(engine, sm, store)


def run_scenario(scenario: Any, *, target: Any = None,
                 scale: float = 1.0, clock: Optional[Clock] = None,
                 out_dir: str = ".", emit_json: bool = False,
                 reset_planes: bool = True,
                 directory: str = "") -> Dict[str, Any]:
    """Run one scenario end to end and return its report dict.

    ``scenario`` is a name (looked up in the library), a spec dict, or
    a built :class:`ScenarioSpec`. Without an explicit ``target`` an
    echo-backend engine is built and torn down around the run; without
    an explicit ``clock`` a fresh FakeClock compresses the schedule.
    ``reset_planes`` clears the usage ledger and flight recorder first
    so the scorecard is this run's, not the process history's."""
    if isinstance(scenario, str):
        spec = load_named(scenario, directory)
    elif isinstance(scenario, dict):
        spec = spec_from_dict(scenario)
    else:
        spec = scenario
    if clock is None:
        from llmq_tpu_torch.core.clock import FakeClock
        clock = FakeClock()
    own_target = target is None
    if own_target:
        if any(str(ev.point).startswith("store.")
               for ev in spec.chaos_events):
            # Store-fault scenarios need store-backed planes to fault.
            target = _store_target(spec)
        else:
            target = EngineTarget(make_echo_engine(f"scn-{spec.name}"),
                                  own=True)
    if reset_planes:
        from llmq_tpu_torch.observability.recorder import get_recorder
        from llmq_tpu_torch.observability.usage import get_usage_ledger
        ledger = get_usage_ledger()
        ledger.reconfigure(enabled=True)
        ledger.clear()
        get_recorder().clear()
    driver = ScenarioDriver(spec, target, clock=clock, scale=scale)
    try:
        stats = driver.run()
    finally:
        if own_target:
            target.stop()
        if spec.chaos_events:
            # Disarm: a scenario's leftover rules must never leak into
            # the next run (or the host process).
            from llmq_tpu_torch import chaos
            from llmq_tpu_torch.core.config import ChaosConfig
            chaos.configure(ChaosConfig(enabled=False))
    assert driver.compiled is not None
    report = build_report(driver.compiled, stats,
                          checker=driver.checker,
                          engines=target.engines())
    if emit_json:
        report["report_path"] = write_report(report, out_dir)
    return report
