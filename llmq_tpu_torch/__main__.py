"""Command line: ``python -m llmq_tpu_torch serve|queue-manager|gateway|scheduler|check|scenarios``.

``serve`` runs the monolith: the REST API (``/metrics`` included), the
preprocessor, the queue factory's managers with their delayed and
dead-letter queues, the workers (retry backoff, watchdog), the
conversation service tied to the engine's KV pins, the engine and its
crash supervisor, the load balancer, the resource scheduler holding the
card as CHIP/HBM_GB resources (the engine's chip allocated and
heartbeaten while the engine runs, cache-aware admission wired). SIGTERM
drains (no new work, in-flight work
finishes, up to ``cluster.drain_timeout`` seconds) before it stops;
SIGINT stops at once. ``check`` builds the same monolith on an ephemeral
port, sends one message through REST end to end and exits 0 when it
completes.

The split deployment runs the same wiring in two processes that share
``queue.spool_dir`` (``queueing/spool.py``): ``gateway`` is the API edge
with the queues and no engine (it never touches the card); a relay
thread drains its queues into the spool and a collector applies the
acknowledgements, so a client polls the gateway for results.
``queue-manager`` has the workers and the engine and no HTTP: it claims
spooled messages into its queues and acknowledges each result (success
or a retry-exhausted failure). With ``queue.wal_dir`` every queue
manager journals its messages, so either process restarts without losing
what it had accepted (at-least-once). ``serve``, ``queue-manager`` and
``check`` run on ``cuda`` unless ``--device cpu`` is given.

A replica set: ``--peers URL[,URL...]`` (or ``cluster.peers``) makes
``serve`` route its workers' messages through a cluster router over the
local engine and the peer serve processes (conversation affinity, spill,
failover, drain; ``cluster/``), and makes ``gateway`` grow workers that
route to the peers over HTTP, without an engine of its own (it never
touches the card). ``serve`` runs the endpoint autoscaler
(``scheduling/autoscaler.py``) over its load balancer, as the JAX
package's does; at the default ``scheduler`` block it removes one
endpoint of a two-replica set on its first tick, about
``scheduler.monitor_interval`` seconds after start, unless
``scheduler.min_endpoints`` keeps it. ``scheduler`` runs that monitor
loop alone, with no API, workers or engine.

The control plane (``controlplane.enabled``, ``controlplane/``) takes
the autoscaler's place in ``serve``: a reconcile controller over the
cluster router (built over the local engine when there are no peers)
that provisions and replaces replicas through its pool (``pool.kind:
subprocess`` spawns ``python -m llmq_tpu_torch serve`` children) and
climbs the degradation ladder at the overload shedder. The
disaggregation plane (``disagg.enabled``, ``disagg/``) gives the engine
its ``role``, wires the KV exchange over the conversation store into the
tiering plane, steers the router by role, and on drain publishes every
warm conversation to the exchange.

``scenarios`` plays named workload specs (``configs/scenarios/``)
closed-loop into an engine built as ``serve`` builds its own (on ``cuda``
unless ``--device cpu``; the echo executor only when named,
``--backend echo``), or into a remote gateway with ``--gateway URL``,
and prints one summary line a run (``scenarios/``).

Configuration: dataclass defaults, then a YAML file (``--config``, else
``LLMQ_CONFIG``, else ``./config.yaml`` or ``./configs/config.yaml``),
then ``LLMQ_*`` environment overrides, then these flags. A file that
does not load (a key not ported, the JAX package's own config found by
the search) ends the command with the reason and exit code 2.
``executor.backend: echo`` (a named file, or
``LLMQ_EXECUTOR_BACKEND=echo``) serves the host-only echo executor. The
``chaos`` block arms the chaos plane at start, and the ``tenancy`` block
configures the tenant registry before any queue manager is built (weighted
fair dequeue, per-tenant quotas, decode fairness; ``X-Tenant-Id`` names a
request's tenant); ``store.resilience``
wraps the conversation store in the fault domain
(``conversation/resilience.py``) and adds a ``store`` block to
``/health``.

Multi-process bring-up (JAX's ``_maybe_join_cluster``): with
``LLMQ_COORDINATOR`` (``host:port``), ``LLMQ_NUM_PROCESSES`` and
``LLMQ_PROCESS_ID`` set (all three, or the command refuses to start), every
entry point joins the ``torch.distributed`` world before any backend
work: NCCL on ``cuda`` (this rank's card, ``cuda:{rank % device_count}``),
gloo under ``--device cpu`` and on ``cuda`` for a mesh whose ``tp`` is 1
(a ``dp`` mesh moves only host traffic between its ranks, and gloo lets
its ranks share one card); ``LLMQ_CLUSTER_TIMEOUT`` (seconds, default
300) bounds the rendezvous and a follower's wait. With a mesh configured
(``executor.mesh`` or ``tpu.mesh_shape``) rank 0 runs the command and
drives; a rank above 0 of ``serve``, ``queue-manager``, ``check`` or
``scenarios`` builds only its executor shard and follows rank 0's
(``TorchExecutor.follow``), exiting 0 at the driver's stop and non-zero
when the driver is lost.
"""

from __future__ import annotations

import argparse
import atexit
import json
import logging
import os
import signal
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Optional

import torch

from llmq_tpu_torch import chaos, observability, tenancy
from llmq_tpu_torch.api.message_store import MessageStore
from llmq_tpu_torch.api.server import ApiServer
from llmq_tpu_torch.cluster import ClusterRouter, build_cluster_router
from llmq_tpu_torch.conversation.persistence import make_store
from llmq_tpu_torch.conversation.resilience import wrap_store
from llmq_tpu_torch.conversation.state_manager import StateManager
from llmq_tpu_torch.controlplane import ReplicaController, build_controller
from llmq_tpu_torch.core.config import Config, load_config
from llmq_tpu_torch.disagg import DisaggCoordinator, build_disagg
from llmq_tpu_torch.engine.builder import build_engine
from llmq_tpu_torch.engine.engine import InferenceEngine
from llmq_tpu_torch.engine.supervisor import EngineSupervisor
from llmq_tpu_torch.loadbalancer.load_balancer import LoadBalancer
from llmq_tpu_torch.preprocessor.preprocessor import Preprocessor
from llmq_tpu_torch.core.types import Message, MessageStatus
from llmq_tpu_torch.native.loader import loaded_path
from llmq_tpu_torch.queueing.factory import QueueFactory, QueueType
from llmq_tpu_torch.queueing.spool import (SpoolCollector, SpoolConsumer,
                                           SpoolProducer)
from llmq_tpu_torch.scheduling.autoscaler import Autoscaler
from llmq_tpu_torch.scheduling.resource_scheduler import (ResourceRequest,
                                                          ResourceScheduler,
                                                          ResourceType)
from llmq_tpu_torch.scheduling.topology import GpuTopology
from llmq_tpu_torch.utils.logging import configure_logging

log = logging.getLogger("llmq_tpu_torch")


class App:
    """One wired process, as the JAX package's ``App`` wires the parts the
    port has. The mode flags choose the parts: the API server
    (``with_api``), the workers (``with_workers``, which need an engine
    or cluster peers), the engine (``with_engine``, or one given as
    ``engine``) and the endpoint autoscaler (``with_scheduler``). With
    ``queue.spool_dir`` set, workers without the API make the split
    deployment's consumer and the API without workers its gateway. With
    ``cluster.peers`` the workers dispatch through the cluster router,
    and a process without workers (the gateway) gets them."""

    def __init__(self, cfg: Config,
                 engine: Optional[InferenceEngine] = None, *,
                 with_api: bool = True, with_workers: bool = True,
                 with_engine: bool = True,
                 with_scheduler: bool = False) -> None:
        self.cfg = cfg
        self.factory = QueueFactory(cfg)
        self.factory.create_queue_manager("standard", QueueType.STANDARD)
        self.factory.create_queue_manager("delayed", QueueType.DELAYED)
        self.factory.create_queue_manager("priority", QueueType.PRIORITY)
        self.preprocessor = Preprocessor()
        p = cfg.persistence
        store = make_store(p.backend, sqlite_path=p.sqlite_path,
                           redis_url=p.redis_url, key_prefix=p.key_prefix,
                           cache_ttl=p.cache_ttl)
        # The store fault domain: deadlines, retry and a breaker around
        # the one store the state manager and the tiering plane share.
        # Off (the default), the raw backend serves as it is.
        if cfg.store.resilience.enabled:
            store = wrap_store(store, cfg.store.resilience)
        self.state_manager = StateManager(cfg.conversation, store=store)
        self.load_balancer = LoadBalancer(cfg.loadbalancer)
        self.resource_scheduler = ResourceScheduler(cfg.resource_scheduler)

        if engine is None and with_engine:
            # On the card the engine warms up before it serves: every
            # program runs once and its CUDA graph is captured.
            engine = build_engine(
                cfg, warmup=torch.device(cfg.device).type == "cuda")
        self.engine = engine
        self.engine_allocation = None
        self._own_resource_ids: List[str] = []
        self.supervisor: Optional[EngineSupervisor] = None
        if engine is not None:
            # Conversation eviction frees the conversation's pinned KV.
            engine.attach_conversation_manager(self.state_manager)
            # Cache-aware admission: a token-sized resource request pays
            # only for its expected new prefill tokens, and the scheduler
            # learns the prefill rate the engine really sustains.
            self.resource_scheduler.set_prefill_estimator(
                lambda md: engine.prefill_estimate(
                    str(md.get("conversation_id", "")),
                    int(md.get("prompt_tokens", 0) or 0)))
            engine.on_prefill_observed = (
                self.resource_scheduler.observe_prefill)
            self._register_chip_resources()
            if cfg.executor.supervisor.enabled:
                self.supervisor = EngineSupervisor(
                    engine, config=cfg.executor.supervisor,
                    enable_metrics=cfg.queue.enable_metrics)

        # The replica-set plane: cluster.peers builds the router over this
        # process's load balancer, the one POST /api/v1/endpoints feeds,
        # so hosts added at run time take traffic from the live router.
        self.cluster_router: Optional[ClusterRouter] = build_cluster_router(
            cfg, self.load_balancer, state_manager=self.state_manager,
            engine=engine)
        if self.cluster_router is not None:
            log.info("cluster plane up: %d peer(s)%s",
                     len(cfg.cluster.peers),
                     " + local engine" if (engine is not None
                                           and cfg.cluster.include_local)
                     else "")

        # The disaggregation plane: the role and the KV exchange over the
        # store the state manager persists to. Off, nothing is built.
        self.disagg: Optional[DisaggCoordinator] = None
        if cfg.disagg.enabled and engine is not None:
            self.disagg = build_disagg(cfg, engine, store,
                                       enable_metrics=cfg.queue.enable_metrics)
            if self.disagg is not None:
                log.info("disagg plane up: role=%s exchange=%s",
                         self.disagg.role, self.disagg.exchange is not None)
        # The control plane needs the replica set's routing: a serve
        # process without peers gets a router over its own engine, so
        # provisioned replicas take traffic. The controller itself is
        # built after the API server (the ladder acts at its shedder).
        self.controller: Optional[ReplicaController] = None
        if (cfg.controlplane.enabled and self.cluster_router is None
                and engine is not None):
            self.cluster_router = ClusterRouter(
                self.load_balancer, config=cfg.cluster,
                state_manager=self.state_manager,
                enable_metrics=cfg.queue.enable_metrics)
            self.cluster_router.register_engine(engine)
            log.info("control plane: cluster router built over the "
                     "local engine")
        if cfg.disagg.enabled and self.cluster_router is not None:
            # Role steering on either router: the learned prefill rate
            # decides which first turns are long.
            self.cluster_router.disagg = cfg.disagg
            self.cluster_router.prefill_eta = (
                self.resource_scheduler.prefill_eta_ms)

        # The split deployment's transport: the consumer side claims
        # spooled messages into the local queues and acknowledges the
        # results; the gateway side relays drained messages out and
        # applies the acknowledgements.
        self.spool_consumer: Optional[SpoolConsumer] = None
        self.spool_producer: Optional[SpoolProducer] = None
        self.spool_collector: Optional[SpoolCollector] = None
        self._spool_relay: Optional[threading.Thread] = None
        self._spool_ack_failure = None
        spool_dir = cfg.queue.spool_dir
        # A gateway with peers gets workers: its queues drain through the
        # router to the replicas over HTTP.
        if self.cluster_router is not None:
            with_workers = True
        self.workers: List = []
        if with_workers:
            if engine is None and self.cluster_router is None:
                raise ValueError("workers need an engine or cluster peers")
            process_fn = (self.cluster_router.process_fn
                          if self.cluster_router is not None
                          else engine.process_fn)
            # Spool and cluster are two transports; with peers the
            # router owns the dispatch.
            if spool_dir and not with_api and self.cluster_router is None:
                process_fn = self._wire_spool_consumer(spool_dir)
            self.workers = self.factory.create_workers(
                "standard", max(1, cfg.queue.worker.count), process_fn,
                start=False, on_permanent_failure=self._spool_ack_failure)
        self.message_store = MessageStore()
        self.api: Optional[ApiServer] = None
        if with_api:
            self.api = ApiServer(cfg, queue_factory=self.factory,
                                 preprocessor=self.preprocessor,
                                 state_manager=self.state_manager,
                                 load_balancer=self.load_balancer,
                                 resource_scheduler=self.resource_scheduler,
                                 engine=engine,
                                 cluster_router=self.cluster_router,
                                 drain_hook=self.drain,
                                 message_store=self.message_store)
            if spool_dir and not with_workers:
                self._wire_spool_gateway(spool_dir)
        if cfg.controlplane.enabled and self.cluster_router is not None:
            self.controller = build_controller(
                cfg, self.cluster_router,
                queue_manager=self.factory.get_queue_manager("standard"),
                shedder=self.api.shedder if self.api is not None else None,
                supervisor=self.supervisor)
            if self.api is not None:
                self.api.controller = self.controller
            if self.controller is not None:
                log.info("control plane up: %d..%d replicas, %d ladder "
                         "rung(s), pool=%s", cfg.controlplane.min_replicas,
                         cfg.controlplane.max_replicas,
                         len(cfg.controlplane.rungs),
                         cfg.controlplane.pool.kind)
        self.autoscaler: Optional[Autoscaler] = None
        # The controller supersedes the autoscaler: two reconcilers on
        # one load balancer would fight over its endpoints.
        if with_scheduler and self.controller is None:
            self.autoscaler = Autoscaler(
                self.factory.get_queue_manager("standard"),
                self.load_balancer, cfg.scheduler)
        self._stop = threading.Event()
        #: Set when the stop signal was SIGTERM: the process then drains
        #: before it stops (SIGINT stops at once).
        self._term = threading.Event()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._drain_mu = threading.Lock()
        self._drain_started = False
        self._drain_done = threading.Event()
        self._drain_idle = False

    def queue_cores(self) -> Dict[str, str]:
        """The ordering core of each queue manager's queues."""
        return {name: self.factory.get_queue_manager(name).queue.backend_name
                for name in self.factory.manager_names()}

    # -- the split deployment's spool ----------------------------------------

    def _wire_spool_consumer(self, spool_dir: str):
        """Queue-manager side: spooled messages land in the local queues,
        and each result (success, or a failure once the retries are
        spent) is acknowledged into ``done/`` for the gateway. Returns
        the workers' process function."""
        mgr = self.factory.get_queue_manager("standard")
        consumer = SpoolConsumer(spool_dir,
                                 lambda q, m: mgr.push_message(m, q))
        self.spool_consumer = consumer
        inner = self.engine.process_fn

        def process(ctx, msg):
            inner(ctx, msg)
            ack = Message.from_dict(msg.to_dict())
            ack.status = MessageStatus.COMPLETED
            consumer.ack_done(ack)

        def ack_failure(msg, reason):
            # Every permanent failure (an error, a timeout, the watchdog
            # giving up) sends the gateway a terminal record.
            ack = Message.from_dict(msg.to_dict())
            ack.status = MessageStatus.FAILED
            ack.error = reason
            consumer.ack_done(ack)

        self._spool_ack_failure = ack_failure
        return process

    def _wire_spool_gateway(self, spool_dir: str) -> None:
        """Gateway side: a relay thread drains the local queues into the
        spool (the messages stay in flight locally, in the WAL across
        restarts); the collector applies the ``done/`` records, so polling
        clients see responses and the queue stats see completions."""
        mgr = self.factory.get_queue_manager("standard")
        self.spool_producer = SpoolProducer(spool_dir)

        def on_done(done: Message) -> None:
            orig = self.message_store.get(done.id)
            if orig is not None:
                orig.response = done.response
                orig.error = done.error
                orig.status = done.status
                orig.metadata.update(done.metadata or {})
                target = orig
            else:
                target = done
            if done.status == MessageStatus.COMPLETED:
                mgr.complete_message(target)
                observability.record(done.id, "completed", source="spool")
            else:
                mgr.fail_message(target, 0.0)
                observability.record(done.id, "failed", source="spool",
                                     reason=done.error)

        self.spool_collector = SpoolCollector(spool_dir, on_done)

        def relay_loop() -> None:
            while not self._stop.is_set():
                try:
                    batch = mgr.drain_in_priority_order(64)
                except Exception:  # noqa: BLE001 — the relay must live
                    log.exception("spool relay drain failed")
                    self._stop.wait(1.0)
                    continue
                # On a failed publish the whole undelivered rest goes
                # back to the queue: drained messages are out of it, and
                # dropping them would strand their clients in PROCESSING.
                undelivered: List[Message] = []
                for i, m in enumerate(batch):
                    try:
                        self.spool_producer.push(m)
                    except Exception:  # noqa: BLE001
                        log.exception(
                            "spool push failed; requeueing %d messages",
                            len(batch) - i)
                        undelivered = batch[i:]
                        break
                for m in undelivered:
                    try:
                        mgr.push_message(m)
                    except Exception:  # noqa: BLE001
                        log.exception("requeue of %s failed", m.id)
                if undelivered:
                    self._stop.wait(1.0)
                elif not batch:
                    self._stop.wait(0.05)

        self._spool_relay = threading.Thread(
            target=relay_loop, name="spool-relay", daemon=True)

    # -- the card as schedulable resources -----------------------------------

    def _register_chip_resources(self) -> None:
        """Register the device's topology as CHIP/HBM_GB resources and
        allocate the engine's one chip, pinned (it never expires), so
        ``/api/v1/resources`` shows what the engine holds. A topology
        that cannot be read on ``cuda`` raises."""
        topo = GpuTopology.discover(self.cfg.device)
        own = self.resource_scheduler.register_topology_resources(
            topo, chips_per_resource=1)
        self._own_resource_ids = [r.id for r in own]
        self.engine_allocation = self.resource_scheduler.request_resource_now(
            ResourceRequest(
                model_type="llm", capabilities={topo.chips[0].platform},
                amounts={ResourceType.CHIP: 1.0},
                metadata={"engine": self.engine.name,
                          "model": self.cfg.model.name, "pinned": True}))
        log.info("engine %s holds 1 chip of %s (%s, %.1f GB of %.1f GB in "
                 "all)", self.engine.name, topo.slice_name,
                 topo.chips[0].kind, topo.chips[0].hbm_gb, topo.total_hbm_gb)

    def _start_chip_heartbeat(self) -> None:
        """Heartbeat the resources this process registered while the
        engine runs: the scheduler's monitor takes a resource offline
        after ``heartbeat_timeout`` without one, so a dead engine loop
        ages its chips out."""
        sched = self.resource_scheduler
        interval = max(1.0, sched.config.heartbeat_timeout / 3.0)
        own = list(self._own_resource_ids)

        def beat() -> None:
            while not self._hb_stop.wait(interval):
                if not self.engine.running:
                    continue
                for rid in own:
                    sched.heartbeat(rid)

        self._hb_stop.clear()
        self._hb_thread = threading.Thread(target=beat, daemon=True,
                                           name="chip-heartbeat")
        self._hb_thread.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self, host: Optional[str] = None,
              port: Optional[int] = None) -> Optional[int]:
        """Start everything; returns the API's bound port (None without
        the API)."""
        self.state_manager.start()
        self.resource_scheduler.start()
        if self.cfg.loadbalancer.health_check_interval > 0:
            self.load_balancer.start()
        if self.engine is not None:
            self.engine.start()
            self._start_chip_heartbeat()
        if self.supervisor is not None:
            self.supervisor.start()
        for w in self.workers:
            w.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        if self.controller is not None:
            self.controller.start()
        for part in (self.spool_consumer, self.spool_collector,
                     self._spool_relay):
            if part is not None:
                part.start()
        return None if self.api is None else self.api.start(host, port)

    def stop(self) -> None:
        """The shutdown cascade: the supervisor before the engine (else
        it would take the deliberate stop for a crash), the engine's
        chip allocation released before the engine stops."""
        log.info("shutting down ...")
        if self.controller is not None:
            # First: a live controller would replace the replicas this
            # teardown stops. Its pool stops its replicas.
            self.controller.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        if self.api is not None:
            self.api.stop()
        self._stop.set()                # ends the spool relay's loop
        for part in (self.spool_consumer, self.spool_collector):
            if part is not None:
                part.stop()
        if self._spool_relay is not None:
            self._spool_relay.join(timeout=5.0)
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.factory.stop_all()
        if self.engine_allocation is not None:
            self.resource_scheduler.release_allocation(
                self.engine_allocation.id, self.engine_allocation.token)
            self.engine_allocation = None
        if self.engine is not None:
            self.engine.stop()
            # A mesh driver's followers stop with it.
            release = getattr(self.engine.executor, "release_mesh", None)
            if release is not None:
                release()
        self.load_balancer.stop()
        self.resource_scheduler.stop()
        self.state_manager.stop()
        self._stop.set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Leave gracefully: /health reads "draining", the workers stop
        taking new messages while their in-flight calls finish, then the
        engine gets up to ``timeout`` (default ``cluster.drain_timeout``)
        seconds to go idle. Returns True when it did. A second caller
        (the admin route and SIGTERM) waits for the one drain and gets
        its result."""
        if timeout is None:
            timeout = self.cfg.cluster.drain_timeout
        with self._drain_mu:
            already = self._drain_started
            self._drain_started = True
        if already:
            self._drain_done.wait(max(0.0, timeout) + 10.0)
            return self._drain_idle
        log.info("draining (timeout %.0f s) ...", timeout)
        if self.api is not None:
            self.api.draining = True
        router = self.cluster_router
        if router is not None and router._local_endpoint_id:  # noqa: SLF001
            # The local replica leaves this process's router too.
            router.drain_endpoint(router._local_endpoint_id)  # noqa: SLF001
        for w in self.workers:
            w.stop(wait=True)      # finishes in-flight dispatches
        deadline = time.monotonic() + max(0.0, timeout)
        idle = True
        if self.engine is not None:
            while time.monotonic() < deadline:
                s = self.engine.get_stats()
                if s["active"] == 0 and s["pending"] == 0:
                    break
                time.sleep(0.05)
            else:
                idle = False
        if self.disagg is not None:
            # Every warm conversation goes to the exchange, so peers
            # resume it from the store tier; the publishes land before
            # the stop cascade stops the plane.
            try:
                if (self.disagg.publish_warm()
                        and self.disagg.plane is not None):
                    self.disagg.plane.flush_jobs(
                        timeout=max(1.0, timeout / 2))
            except Exception:  # noqa: BLE001 — the drain must end
                log.exception("drain-time kv migration failed")
        log.info("drain complete (idle=%s)", idle)
        self._drain_idle = idle
        self._drain_done.set()
        return idle

    def wait(self) -> None:
        """Block until SIGINT or SIGTERM."""
        signal.signal(signal.SIGINT, lambda *_: self._stop.set())

        def on_term(*_a) -> None:
            self._term.set()
            self._stop.set()

        signal.signal(signal.SIGTERM, on_term)
        while not self._stop.is_set():
            self._stop.wait(0.5)

    def shutdown(self) -> None:
        """After :meth:`wait`: drain first on SIGTERM (or after an admin
        drain, whose end this then waits for), then stop."""
        if self._term.is_set() or self._drain_started:
            self.drain()
        self.stop()


def _load(args) -> Config:
    cfg = load_config(args.config) if args.config else load_config()
    if args.config:
        # Processes this one starts read the same file.
        os.environ["LLMQ_CONFIG"] = os.path.abspath(args.config)
    if args.host is not None:
        cfg.server.host = args.host
    if args.port is not None:
        cfg.server.port = args.port
    if args.model is not None:
        cfg.model.name = args.model
    if args.device is not None:
        cfg.device = args.device
    if args.backend is not None:
        cfg.executor.backend = args.backend
    if args.log_format is not None:
        cfg.logging.format = args.log_format
    if args.peers:
        # Comma-separated replica URLs, normalised as the file's are.
        cfg.cluster.peers = args.peers
        cfg.cluster.__post_init__()
    configure_logging(cfg.logging.level, cfg.logging.format,
                      cfg.logging.output)
    # The trace plane (and through it the SLO, usage and critical-path
    # planes) is sized and switched before any component records.
    observability.configure(cfg.observability)
    # The chaos plane is armed only with chaos.enabled: otherwise every
    # fault point is one attribute check.
    chaos.configure(cfg.chaos)
    # The tenancy registry (weights, quotas, in-flight counters) is
    # configured before any queue manager builds its fair scheduler.
    tenancy.configure_tenancy(cfg.tenancy)
    _maybe_join_cluster(cfg)
    return cfg


def _maybe_join_cluster(cfg: Config) -> None:
    """Join the ``torch.distributed`` world from the ``LLMQ_COORDINATOR``
    variables before any backend work (``llmq_tpu/__main__.py``'s
    ``_maybe_join_cluster``). A partial set refuses to start; a broken
    rendezvous raises (``distributed_init`` propagates it). On ``cuda``
    the rank takes ``cuda:{rank % device_count}``, and a mesh of several
    ranks whose ``tp`` is 1 joins over gloo."""
    coordinator = os.environ.get("LLMQ_COORDINATOR")
    if not coordinator:
        return
    missing = [k for k in ("LLMQ_NUM_PROCESSES", "LLMQ_PROCESS_ID")
               if k not in os.environ]
    if missing:
        raise SystemExit(
            f"LLMQ_COORDINATOR is set but {', '.join(missing)} is not: "
            f"multi-process bring-up needs all three")
    from llmq_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S,
                                              distributed_init)

    from llmq_tpu_torch.engine.builder import mesh_shape

    rank = int(os.environ["LLMQ_PROCESS_ID"])
    world = int(os.environ["LLMQ_NUM_PROCESSES"])
    if torch.device(cfg.device).type == "cuda" and torch.cuda.is_available():
        if torch.device(cfg.device).index is None:
            cfg.device = f"cuda:{rank % torch.cuda.device_count()}"
    shape = mesh_shape(cfg) or {}
    others = 1
    for ax, n in shape.items():
        if ax != "tp" and n > 0:
            others *= n
    tp = shape.get("tp", 1)
    if tp == -1:
        tp = world // max(1, others)
    distributed_init(
        coordinator=coordinator,
        num_processes=world,
        process_id=rank,
        initialization_timeout=float(os.environ.get(
            "LLMQ_CLUSTER_TIMEOUT", DEFAULT_TIMEOUT_S)),
        device=cfg.device,
        backend="gloo" if shape and tp == 1 and world > 1 else None)
    # Registered after the executor's hooks would be, so it runs last.
    atexit.register(_leave_cluster)


def _leave_cluster() -> None:
    """Leave the world at exit. An NCCL world of several ranks is left to
    the process's exit: its ``destroy_process_group`` waits on the peers'
    communicators and can hang there (seen on four cards with dp=2 ×
    tp=2)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() == "nccl" and dist.get_world_size() > 1:
        return
    dist.destroy_process_group()


def _mesh_follower(cfg: Config) -> bool:
    """Whether this process is a mesh rank other than 0: it follows."""
    import torch.distributed as dist

    from llmq_tpu_torch.engine.builder import mesh_shape

    return (mesh_shape(cfg) is not None and dist.is_available()
            and dist.is_initialized() and dist.get_rank() != 0)


def cmd_follow(cfg: Config, args) -> int:
    """A follower rank: this rank's executor shard, then the driver's
    calls until its stop (0) or its loss (1)."""
    from llmq_tpu_torch.engine.builder import build_executor

    ex = build_executor(cfg)
    print(f"rank {ex.mesh.rank} of mesh {ex.mesh.shape} following on "
          f"{cfg.device}", flush=True)
    try:
        ex.follow()
    except Exception as e:  # noqa: BLE001 — the mesh is broken
        log.error("mesh follower left the mesh: %s", e)
        return 1
    return 0


def cmd_serve(cfg: Config, args) -> int:
    # This process's boot record opens before the App builds the engine:
    # the builder stamps weights, compile and warmup into it, the first
    # committed token closes it, and /health shows it.
    serve_id = f"serve:{cfg.server.host}:{cfg.server.port}"
    t_boot0 = time.perf_counter()
    observability.boot_begin(serve_id, "serve", process=True)
    app = App(cfg, with_scheduler=True)
    port = app.start()
    observability.boot_ready(serve_id, time.perf_counter() - t_boot0)
    print(f"serving {cfg.model.name} on {cfg.device} at "
          f"http://{cfg.server.host}:{port}", flush=True)
    app.wait()
    app.shutdown()
    return 0


def cmd_queue_manager(cfg: Config, args) -> int:
    """The split deployment's consumer: the queues, the workers and the
    engine, no HTTP. It claims messages from ``queue.spool_dir``."""
    boot_id = f"queue-manager:{os.getpid()}"
    t_boot0 = time.perf_counter()
    observability.boot_begin(boot_id, "queue-manager", process=True)
    app = App(cfg, with_api=False, with_workers=True, with_engine=True)
    app.start()
    observability.boot_ready(boot_id, time.perf_counter() - t_boot0)
    boot = observability.process_boot_snapshot() or {}
    log.info("queue-manager consuming with %d workers (%s on %s)",
             len(app.workers), cfg.model.name, cfg.device,
             extra={"fields": {"queue_cores": app.queue_cores(),
                               "native_lib": loaded_path(),
                               "spool_dir": cfg.queue.spool_dir,
                               "wal_dir": cfg.queue.wal_dir,
                               "boot_s": boot.get("stages_s"),
                               "boot_total_s": boot.get("total_s")}})
    app.wait()
    app.shutdown()
    return 0


def cmd_gateway(cfg: Config, args) -> int:
    """The API edge: the REST API and the queues, no engine (the card is
    never touched). Its queues drain into ``queue.spool_dir`` (the split
    deployment) or, with ``cluster.peers``, through the cluster router's
    workers to the replicas."""
    app = App(cfg, with_api=True, with_workers=False, with_engine=False)
    port = app.start()
    if app.cluster_router is not None:
        log.info("gateway routing to %d endpoint(s)",
                 len(app.load_balancer.endpoints()))
    log.info("gateway serving at http://%s:%d", cfg.server.host, port,
             extra={"fields": {"queue_cores": app.queue_cores(),
                               "native_lib": loaded_path(),
                               "spool_dir": cfg.queue.spool_dir,
                               "wal_dir": cfg.queue.wal_dir}})
    print(f"gateway at http://{cfg.server.host}:{port}", flush=True)
    app.wait()
    app.shutdown()
    return 0


def cmd_scheduler(cfg: Config, args) -> int:
    """The endpoint autoscaler's monitor loop over the load balancer: no
    API, no workers, no engine."""
    app = App(cfg, with_api=False, with_workers=False, with_engine=False,
              with_scheduler=True)
    app.start()
    log.info("scheduler monitoring (strategy=%s)", cfg.scheduler.strategy)
    print(f"scheduler monitoring (strategy={cfg.scheduler.strategy})",
          flush=True)
    app.wait()
    app.stop()
    return 0


def cmd_check(cfg: Config, args) -> int:
    """Run one message end to end through REST; exit 0 when it
    completes with usage metadata."""
    app = App(cfg)
    port = app.start(host="127.0.0.1", port=0)
    ok = False
    try:
        body = json.dumps({"content": "smoke check", "user_id": "check",
                           "metadata": {"max_new_tokens": 8}}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v1/messages", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            mid = json.loads(resp.read())["message_id"]
        deadline = time.time() + args.timeout
        while time.time() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/api/v1/messages/{mid}",
                    timeout=10) as resp:
                m = json.loads(resp.read())
            if m["status"] in ("completed", "failed"):
                ok = (m["status"] == "completed"
                      and "usage" in m["metadata"])
                print(json.dumps({"status": m["status"],
                                  "usage": m["metadata"].get("usage")}))
                break
            time.sleep(0.05)
    finally:
        app.stop()
    print("CHECK", "OK" if ok else "FAILED")
    return 0 if ok else 1


def _scenario_target(cfg: Config, spec, mesh_executor: Dict):
    """The target of one scenario run: an engine from the builder (a
    ``store.*`` scenario's with the tiering plane JAX's store target
    runs, unless the config enables one, behind the resilient store).
    On a mesh the first run's executor serves every later run's engine:
    the followers serve the one executor they built
    (``mesh_executor["ex"]``)."""
    import copy

    from llmq_tpu_torch.engine.builder import mesh_shape
    from llmq_tpu_torch.scenarios import EngineTarget
    from llmq_tpu_torch.scenarios.library import _store_target, store_tiering

    name = f"scn-{spec.name}"
    warm = torch.device(cfg.device).type == "cuda"
    shared = mesh_executor.get("ex")
    store = any(str(ev.point).startswith("store.")
                for ev in spec.chaos_events)
    c = cfg
    if store and not cfg.executor.kv_tiering.enabled:
        c = copy.deepcopy(cfg)
        c.executor.kv_tiering = store_tiering()
    engine = build_engine(c, name=name, warmup=warm and shared is None,
                          executor=shared)
    if mesh_shape(cfg) is not None:
        mesh_executor["ex"] = engine.executor
    if store:
        return _store_target(spec, engine=engine)
    return EngineTarget(engine, own=True)


def cmd_scenarios(cfg: Config, args) -> int:
    """The scenario engine: compile the named (or ``scenarios.run``)
    workload specs and drive them closed-loop into an engine from the
    builder (or a remote gateway with ``--gateway``), one summary JSON
    line a run, plus ``SCENARIO_<name>.json`` with
    ``scenarios.emit_json``. Exit 2 when scenarios are disabled and no
    name is given, 1 if a run fails or breaks an invariant."""
    from llmq_tpu_torch.scenarios import SHIPPED

    scn = cfg.scenarios
    names = list(args.names or scn.run)
    if not names:
        if not scn.enabled:
            log.error("scenarios.enabled is false and no scenario names "
                      "were given: pass names on the command line or set "
                      "scenarios.run")
            return 2
        names = list(SHIPPED)
    # Scenario runs narrate each preemption and eviction at INFO;
    # warnings and errors still surface.
    for noisy in ("engine", "supervisor", "tiering"):
        logging.getLogger(f"llmq_tpu_torch.{noisy}").setLevel(logging.WARNING)
    scale = args.scale if args.scale is not None else scn.scale
    mesh_executor: Dict = {}
    try:
        rc = _run_scenarios(cfg, args, names, scale, mesh_executor)
    finally:
        # A mesh driver's followers stop with the last run.
        if "ex" in mesh_executor:
            mesh_executor["ex"].release_mesh()
    return rc


def _run_scenarios(cfg: Config, args, names: List[str], scale: float,
                   mesh_executor: Dict) -> int:
    """:func:`cmd_scenarios`'s runs, one summary line each."""
    from llmq_tpu_torch.scenarios import (GatewayTarget, load_named,
                                          run_scenario)

    scn = cfg.scenarios
    rc = 0
    for name in names:
        spec = load_named(name, directory=scn.dir)
        if spec.seed == 0 and scn.default_seed:
            spec.seed = scn.default_seed
        target = None
        try:
            target = (GatewayTarget(args.gateway) if args.gateway
                      else _scenario_target(cfg, spec, mesh_executor))
            rep = run_scenario(spec, target=target, scale=scale,
                               out_dir=scn.out_dir,
                               emit_json=scn.emit_json,
                               directory=scn.dir)
        except Exception as e:  # noqa: BLE001 — one failed scenario
            log.error("scenario %s failed: %s: %s",  # must not eat the rest
                      name, type(e).__name__, e)
            rc = 1
            continue
        finally:
            if target is not None:
                target.stop()
                for eng in target.engines():
                    # The next scenario's engine needs the card's memory
                    # (a mesh's next engine serves the same executor).
                    if eng.executor is not mesh_executor.get("ex"):
                        getattr(eng.executor, "release_graphs",
                                lambda: None)()
        req = rep["requests"]
        violations = rep["invariants"]["violations"]
        if violations:
            rc = 1
        sys.stdout.write(json.dumps({
            "scenario": name,
            "scale": scale,
            "goodput_tps": rep["goodput"].get("tokens_per_device_second"),
            "slo_attainment": rep["slo"]["attainment"],
            "completed": req["completed"],
            "failed": req["failed"],
            "shed": req["shed"],
            "chaos_events_fired": req["chaos_events_fired"],
            "engine_recoveries": req["engine_recoveries"],
            "invariant_violations": violations,
            "report_path": rep.get("report_path"),
        }) + "\n")
        sys.stdout.flush()
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="llmq_tpu_torch",
        description="LLM message queue + serving on PyTorch/CUDA")
    parser.add_argument("--config", "-c", help="config YAML path")
    parser.add_argument("--host", help="override server.host")
    parser.add_argument("--port", type=int, help="override server.port")
    parser.add_argument("--model", help="override model.name "
                        "(llama3-tiny | llama3-1b | llama3-8b | llama3-70b)")
    parser.add_argument("--device", help="override device (cuda | cpu)")
    parser.add_argument("--backend", choices=["torch", "echo"],
                        help="override executor.backend")
    parser.add_argument("--log-format", choices=["json", "console"],
                        help="override logging.format (JSON lines with the "
                             "request's ids, or console lines)")
    parser.add_argument("--peers",
                        help="comma-separated replica base URLs (override "
                             "cluster.peers): serve and gateway route "
                             "through the cluster plane")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("serve", help="monolith: API + workers + engine")
    sub.add_parser("queue-manager", help="consumer daemon (no HTTP)")
    sub.add_parser("gateway", help="API edge (no workers/engine)")
    sub.add_parser("scheduler", help="autoscaler monitor loop")
    chk = sub.add_parser("check", help="one message end to end, then exit")
    chk.add_argument("--timeout", type=float, default=120.0,
                     help="seconds to wait for the message")
    scn = sub.add_parser("scenarios",
                         help="run workload scenarios closed-loop")
    scn.add_argument("names", nargs="*",
                     help="scenario names (default: scenarios.run, or all "
                          "shipped when scenarios.enabled)")
    scn.add_argument("--scale", type=float, default=None,
                     help="arrival/population scale factor (default: "
                          "scenarios.scale)")
    scn.add_argument("--gateway", default="",
                     help="drive a remote gateway URL instead of an "
                          "engine built here")
    args = parser.parse_args(argv)
    try:
        cfg = _load(args)
    except (ValueError, FileNotFoundError) as e:
        parser.error(str(e))
    if (args.command in ("serve", "queue-manager", "check", "scenarios")
            and _mesh_follower(cfg)):
        return cmd_follow(cfg, args)
    return {"serve": cmd_serve, "queue-manager": cmd_queue_manager,
            "gateway": cmd_gateway, "scheduler": cmd_scheduler,
            "check": cmd_check,
            "scenarios": cmd_scenarios}[args.command](cfg, args)


if __name__ == "__main__":
    sys.exit(main())
