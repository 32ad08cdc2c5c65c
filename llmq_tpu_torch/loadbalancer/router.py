"""Message → engine routing through the load balancer (the port's copy of
``llmq_tpu/loadbalancer/router.py``).

An :class:`EngineRouter` registers in-process engines as ``local://``
endpoints of a load balancer (the probe consults ``engine.healthy()``,
so a dead engine turns UNHEALTHY and traffic fails over) and peer serve
processes as ``http://`` endpoints behind the HTTP transport, and
resolves the engine or transport behind an endpoint. The dispatch, a
worker ``process_fn`` that picks each message's endpoint and feeds its
response time and errors back, is the cluster router's
(``cluster/router.py``), which builds on it.
"""

from __future__ import annotations

from typing import Dict, Optional

from llmq_tpu_torch.loadbalancer.load_balancer import Endpoint, LoadBalancer
from llmq_tpu_torch.loadbalancer.transport import HttpEngineClient


class EngineRouter:
    def __init__(self, load_balancer: LoadBalancer) -> None:
        self.lb = load_balancer

    def register_engine(self, engine, *, endpoint_id: Optional[str] = None,
                        weight: float = 1.0,
                        max_connections: int = 0,
                        metadata: Optional[Dict] = None) -> Endpoint:
        """Expose an in-process engine as a ``local://`` endpoint."""
        eid = endpoint_id or engine.name
        md = dict(metadata or {})
        md["engine"] = engine
        ep = Endpoint(id=eid, name=engine.name,
                      url=f"local://{engine.name}", weight=weight,
                      max_connections=max_connections, metadata=md)
        self.lb.add_endpoint(ep)
        return ep

    def register_remote(self, url: str, *,
                        endpoint_id: Optional[str] = None,
                        name: Optional[str] = None, weight: float = 1.0,
                        max_connections: int = 0,
                        metadata: Optional[Dict] = None,
                        timeout: float = 120.0) -> Endpoint:
        """Expose a peer serve process (its REST API at ``url``) as an
        endpoint: dispatch and health go over the HTTP transport."""
        client = HttpEngineClient(url, timeout=timeout)
        eid = endpoint_id or url
        md = dict(metadata or {})
        md["engine"] = client
        ep = Endpoint(id=eid, name=name or url, url=url, weight=weight,
                      max_connections=max_connections, metadata=md)
        self.lb.add_endpoint(ep)
        return ep

    def engine_for(self, ep: Endpoint):
        """The engine or transport behind an endpoint. An http endpoint
        registered without one (``POST /api/v1/endpoints``) gets a
        transport on first use, so hosts added at run time are routable.
        None when the endpoint has neither."""
        engine = ep.metadata.get("engine")
        if engine is None and ep.url.startswith(("http://", "https://")):
            engine = HttpEngineClient(ep.url)
            ep.metadata["engine"] = engine
        return engine
