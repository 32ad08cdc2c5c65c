"""Request-lifecycle trace plane (the port's copy of
``llmq_tpu/observability/``), one request legible from the API edge to
the card:

- :mod:`trace` — W3C ``traceparent`` propagation, trace ids derived
  from ``Message.id`` so every process agrees without coordination;
- :mod:`recorder` — the bounded :class:`FlightRecorder` of per-request
  stage timelines (ring + SLA-breach retention), feeding the
  stage histograms on each request's terminal event;
- :mod:`chrome` — Chrome/Perfetto trace export stitching host
  timelines with the engine's ``SpanRecorder`` spans;
- :mod:`device` — the device telemetry plane: step-time decomposition,
  live MFU/decode-rate, HBM accounting, graph-capture visibility,
  single-flight on-demand ``torch.profiler`` captures;
- :mod:`slo` — config-defined SLO targets and rolling error-budget
  burn rates, fed from the recorder's finalized timelines;
- :mod:`usage` — the attribution ledger: per-request device-seconds
  and KV page-seconds, per-tenant rollups, waste decomposition and the
  rolling goodput gauge;
- :mod:`critical_path` — the per-request critical-path decomposition
  (conservation-checked segments joining stage events and device
  attribution) plus the ``replica_ready_seconds{stage}`` boot
  decomposition.

The usage contract for instrumented layers is one line:

    from llmq_tpu_torch import observability
    observability.record(msg.id, "scheduled", priority=..., ...)

which no-ops fast when ``observability.enabled`` is false.
"""

from llmq_tpu_torch.observability.chrome import chrome_trace, perf_anchor  # noqa: F401
from llmq_tpu_torch.observability.critical_path import (  # noqa: F401
    BOOT_STAGES,
    SEGMENTS,
    BootRegistry,
    CriticalPathAnalyzer,
    boot_begin,
    boot_ready,
    boot_stage,
    configure_critical_path,
    cp_enabled,
    decompose,
    get_boot_registry,
    get_critical_path,
    process_boot_snapshot,
)
from llmq_tpu_torch.observability.device import (  # noqa: F401
    DeviceTelemetry,
    ProfileInProgress,
    decode_mfu,
    get_device_telemetry,
    measure_rtt,
    peak_flops,
)
from llmq_tpu_torch.observability.slo import (  # noqa: F401
    SloTracker,
    configure_slo,
    get_slo_tracker,
)
from llmq_tpu_torch.observability.usage import (  # noqa: F401
    RequestUsage,
    UsageLedger,
    configure_usage,
    get_usage_ledger,
    sanitize_tenant,
)
from llmq_tpu_torch.observability.recorder import (  # noqa: F401
    TERMINAL_STAGES,
    FlightRecorder,
    Timeline,
    TraceEvent,
    configure,
    get_recorder,
    record,
)
from llmq_tpu_torch.observability.trace import (  # noqa: F401
    TRACEPARENT_HEADER,
    TraceContext,
    make_traceparent,
    new_span_id,
    parse_traceparent,
    trace_id_for,
)
