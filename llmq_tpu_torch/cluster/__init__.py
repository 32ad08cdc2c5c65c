"""The replica-set plane (the port's copy of ``llmq_tpu/cluster/``).

``cluster.peers: [http://host:port, ...]`` (or ``--peers``) makes
``serve`` and ``gateway`` build a :class:`ClusterRouter` over the listed
replicas (and, in ``serve``, the local engine) and install it as the
workers' ``process_fn``. Hosts added at run time
(``POST /api/v1/endpoints``) land in the same load balancer and are
routable from their first dispatch. Nothing here initialises CUDA: a
gateway with peers never touches a card.
"""

from __future__ import annotations

from typing import Optional

from llmq_tpu_torch.cluster.router import ClusterRouter  # noqa: F401
from llmq_tpu_torch.core.config import ClusterConfig, Config


def build_cluster_router(cfg: Config, load_balancer, *,
                         state_manager=None, engine=None
                         ) -> Optional[ClusterRouter]:
    """A ClusterRouter over ``cluster.peers`` (and the local engine, when
    there is one and ``include_local`` is set), or None without peers:
    the caller then dispatches to its engine directly."""
    ccfg: ClusterConfig = cfg.cluster
    if not ccfg.enabled:
        return None
    router = ClusterRouter(load_balancer, config=ccfg,
                           state_manager=state_manager,
                           enable_metrics=cfg.queue.enable_metrics)
    if cfg.disagg.enabled:
        # Role-aware placement: long first turns to prefill replicas,
        # follow-ups to decode replicas.
        router.disagg = cfg.disagg
    if engine is not None and ccfg.include_local:
        router.register_engine(engine)
    router.register_peers(ccfg.peers)
    return router
