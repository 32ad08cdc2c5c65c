"""Prefill/decode disaggregation plane (the port's copy of
``llmq_tpu/disagg/``).

The conversation store becomes a cluster-wide KV exchange: prefill
replicas serve long first turns and publish each finished turn's KV under
a claimable key; decode replicas claim it and inject it through the
tiering plane's promote path; the cluster router places turns by role.
``disagg.enabled: false`` (the default) builds nothing."""

from llmq_tpu_torch.disagg.coordinator import DisaggCoordinator, build_disagg
from llmq_tpu_torch.disagg.exchange import (EXCHANGE_PREFIX, KVExchange,
                                            flush_metrics)

__all__ = [
    "DisaggCoordinator",
    "EXCHANGE_PREFIX",
    "KVExchange",
    "build_disagg",
    "flush_metrics",
]
