"""Scenario engine: the trace-driven workload plane (docs/scenarios.md),
the port's copy of ``llmq_tpu/scenarios/``.

Compiles declarative scenario specs — phases × arrival processes ×
client populations × chaos events — into deterministic closed-loop
traffic against the real serve path, and scores each run with the
usage plane's goodput instead of p99. A *tool*, not a serving-path
feature: nothing on the port's serving path imports this package, so the
``scenarios.enabled`` off-switch literally means zero import cost.
"""

from llmq_tpu_torch.scenarios.driver import (  # noqa: F401
    EngineTarget, GatewayTarget, PoolTarget, RunStats, ScenarioDriver,
    make_echo_engine)
from llmq_tpu_torch.scenarios.library import (  # noqa: F401
    SHIPPED, list_scenarios, load_named, run_scenario, scenario_dir)
from llmq_tpu_torch.scenarios.scorer import (  # noqa: F401
    build_report, steady_state_deviation, write_report)
from llmq_tpu_torch.scenarios.spec import (  # noqa: F401
    ArrivalSpec, ChaosEventSpec, CompiledScenario, PhaseSpec,
    PopulationSpec, ScenarioSpec, compile_scenario, load_scenario_file,
    spec_from_dict)
