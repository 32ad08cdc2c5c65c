"""The self-healing control plane (the port's copy of
``llmq_tpu/controlplane/``): a reconcile controller (:mod:`controller`)
that reads the SLO burn rates, the queue backlog, replica health and
breakers and the measured tokens/s, and drives replica scaling through a
provision seam (:mod:`pool`), the replacement of dead replicas, and a
degradation ladder (:mod:`ladder`) that tightens admission at the
overload shedder before SLOs burn.

``controlplane.enabled: false`` (the default) builds nothing:
:func:`build_controller` returns None.
"""

from __future__ import annotations

from typing import Any, Optional

from llmq_tpu_torch.controlplane.controller import (  # noqa: F401
    ACTIONS, REASONS, ReplicaController)
from llmq_tpu_torch.controlplane.ladder import DegradationLadder  # noqa: F401
from llmq_tpu_torch.controlplane.pool import (  # noqa: F401
    ExecReplicaPool, LocalEnginePool, ReplicaPool, SubprocessReplicaPool,
    build_pool)


def build_controller(cfg: Any, router: Any, *,
                     queue_manager: Any = None,
                     shedder: Any = None,
                     supervisor: Any = None,
                     pool: Optional[ReplicaPool] = None,
                     enable_metrics: Optional[bool] = None
                     ) -> Optional[ReplicaController]:
    """A :class:`ReplicaController` from the full config, or None when
    ``controlplane.enabled`` is false or there is no router. ``pool``
    replaces the configured pool (tests pass a :class:`LocalEnginePool`).
    With the disaggregation plane on, scale-ups join the
    under-represented role."""
    cp = getattr(cfg, "controlplane", None)
    if cp is None or not getattr(cp, "enabled", False):
        return None
    if router is None:
        return None
    if enable_metrics is None:
        enable_metrics = getattr(getattr(cfg, "queue", None),
                                 "enable_metrics", True)
    if pool is None:
        pool = build_pool(cp.pool)
    controller = ReplicaController(
        config=cp, router=router, pool=pool,
        queue_manager=queue_manager, shedder=shedder,
        supervisor=supervisor, enable_metrics=enable_metrics)
    dcfg = getattr(cfg, "disagg", None)
    if dcfg is not None and getattr(dcfg, "enabled", False):
        controller.disagg = dcfg
    return controller
