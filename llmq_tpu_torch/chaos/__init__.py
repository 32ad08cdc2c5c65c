"""Chaos plane (the port's copy of ``llmq_tpu/chaos/``): deterministic,
seeded fault injection at named points of the real code paths, and the
invariant checker that scenarios end with.

``chaos.enabled: true`` (default false) arms the rules of the ``chaos``
config block. Disabled, every fault point is one attribute check.

    from llmq_tpu_torch import chaos
    chaos.fault("engine.step", engine=self.name)
"""

from llmq_tpu_torch.chaos.injector import (  # noqa: F401
    VALID_KINDS,
    ChaosFault,
    ChaosOSError,
    ChaosPartialResponse,
    ChaosTimeout,
    EngineCrash,
    FaultInjector,
    FaultRule,
    configure,
    fault,
    get_injector,
)
from llmq_tpu_torch.chaos.invariants import InvariantChecker  # noqa: F401
