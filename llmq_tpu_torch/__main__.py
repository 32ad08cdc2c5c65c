"""Command line: ``python -m llmq_tpu_torch serve|check``.

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
completes. Both run on ``cuda`` unless ``--device cpu`` is given. (The
JAX package's ``scheduler`` subcommand, its endpoint autoscaler, waits
for the slice that gives it something to provision.)

Configuration: dataclass defaults, then a YAML file (``--config``, else
``LLMQ_CONFIG``, else ``./config.yaml`` or ``./configs/config.yaml``),
then ``LLMQ_*`` environment overrides, then these flags. A file that
does not load (a key not ported, the JAX package's own config found by
the search) ends the command with the reason and exit code 2.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time
import urllib.request
from typing import List, Optional

import torch

from llmq_tpu_torch import observability
from llmq_tpu_torch.api.message_store import MessageStore
from llmq_tpu_torch.api.server import ApiServer
from llmq_tpu_torch.conversation.persistence import make_store
from llmq_tpu_torch.conversation.state_manager import StateManager
from llmq_tpu_torch.core.config import Config, load_config
from llmq_tpu_torch.engine.builder import build_engine
from llmq_tpu_torch.engine.engine import InferenceEngine
from llmq_tpu_torch.engine.supervisor import EngineSupervisor
from llmq_tpu_torch.loadbalancer.load_balancer import LoadBalancer
from llmq_tpu_torch.preprocessor.preprocessor import Preprocessor
from llmq_tpu_torch.queueing.factory import QueueFactory, QueueType
from llmq_tpu_torch.scheduling.resource_scheduler import (ResourceRequest,
                                                          ResourceScheduler,
                                                          ResourceType)
from llmq_tpu_torch.scheduling.topology import GpuTopology
from llmq_tpu_torch.utils.logging import configure_logging

log = logging.getLogger("llmq_tpu_torch")


class App:
    """One wired process, as the JAX package's monolith ``App`` wires the
    parts the port has."""

    def __init__(self, cfg: Config,
                 engine: Optional[InferenceEngine] = None) -> None:
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
        self.state_manager = StateManager(cfg.conversation, store=store)
        self.load_balancer = LoadBalancer(cfg.loadbalancer)
        self.resource_scheduler = ResourceScheduler(cfg.resource_scheduler)

        # On the card the engine warms up before it serves: every
        # program runs once and its CUDA graph is captured.
        self.engine = engine if engine is not None else build_engine(
            cfg, warmup=torch.device(cfg.device).type == "cuda")
        # Conversation eviction frees the conversation's pinned KV.
        self.engine.attach_conversation_manager(self.state_manager)
        # Cache-aware admission: a token-sized resource request pays only
        # for its expected new prefill tokens, and the scheduler learns
        # the prefill rate the engine really sustains.
        eng = self.engine
        self.resource_scheduler.set_prefill_estimator(
            lambda md: eng.prefill_estimate(
                str(md.get("conversation_id", "")),
                int(md.get("prompt_tokens", 0) or 0)))
        self.engine.on_prefill_observed = (
            self.resource_scheduler.observe_prefill)
        self.engine_allocation = None
        self._own_resource_ids: List[str] = []
        self._register_chip_resources()

        self.supervisor: Optional[EngineSupervisor] = None
        if cfg.executor.supervisor.enabled:
            self.supervisor = EngineSupervisor(
                self.engine, config=cfg.executor.supervisor,
                enable_metrics=cfg.queue.enable_metrics)
        self.workers = self.factory.create_workers(
            "standard", max(1, cfg.queue.worker.count),
            self.engine.process_fn, start=False)
        self.message_store = MessageStore()
        self.api = ApiServer(cfg, queue_factory=self.factory,
                             preprocessor=self.preprocessor,
                             state_manager=self.state_manager,
                             load_balancer=self.load_balancer,
                             resource_scheduler=self.resource_scheduler,
                             engine=self.engine, drain_hook=self.drain,
                             message_store=self.message_store)
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
              port: Optional[int] = None) -> int:
        """Start everything; returns the API's bound port."""
        self.state_manager.start()
        self.resource_scheduler.start()
        if self.cfg.loadbalancer.health_check_interval > 0:
            self.load_balancer.start()
        self.engine.start()
        self._start_chip_heartbeat()
        if self.supervisor is not None:
            self.supervisor.start()
        for w in self.workers:
            w.start()
        return self.api.start(host, port)

    def stop(self) -> None:
        """The shutdown cascade: the supervisor before the engine (else
        it would take the deliberate stop for a crash), the engine's
        chip allocation released before the engine stops."""
        log.info("shutting down ...")
        if self.supervisor is not None:
            self.supervisor.stop()
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        self.api.stop()
        self.factory.stop_all()
        if self.engine_allocation is not None:
            self.resource_scheduler.release_allocation(
                self.engine_allocation.id, self.engine_allocation.token)
            self.engine_allocation = None
        self.engine.stop()
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
        self.api.draining = True
        for w in self.workers:
            w.stop(wait=True)      # finishes in-flight dispatches
        deadline = time.monotonic() + max(0.0, timeout)
        idle = True
        while time.monotonic() < deadline:
            s = self.engine.get_stats()
            if s["active"] == 0 and s["pending"] == 0:
                break
            time.sleep(0.05)
        else:
            idle = False
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
    if args.log_format is not None:
        cfg.logging.format = args.log_format
    configure_logging(cfg.logging.level, cfg.logging.format,
                      cfg.logging.output)
    # The trace plane (and through it the SLO, usage and critical-path
    # planes) is sized and switched before any component records.
    observability.configure(cfg.observability)
    return cfg


def cmd_serve(cfg: Config, args) -> int:
    # This process's boot record opens before the App builds the engine:
    # the builder stamps weights, compile and warmup into it, the first
    # committed token closes it, and /health shows it.
    serve_id = f"serve:{cfg.server.host}:{cfg.server.port}"
    t_boot0 = time.perf_counter()
    observability.boot_begin(serve_id, "serve", process=True)
    app = App(cfg)
    port = app.start()
    observability.boot_ready(serve_id, time.perf_counter() - t_boot0)
    print(f"serving {cfg.model.name} on {cfg.device} at "
          f"http://{cfg.server.host}:{port}", flush=True)
    app.wait()
    app.shutdown()
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
    parser.add_argument("--log-format", choices=["json", "console"],
                        help="override logging.format (JSON lines with the "
                             "request's ids, or console lines)")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("serve", help="monolith: API + workers + engine")
    chk = sub.add_parser("check", help="one message end to end, then exit")
    chk.add_argument("--timeout", type=float, default=120.0,
                     help="seconds to wait for the message")
    args = parser.parse_args(argv)
    try:
        cfg = _load(args)
    except (ValueError, FileNotFoundError) as e:
        parser.error(str(e))
    return {"serve": cmd_serve, "check": cmd_check}[args.command](cfg, args)


if __name__ == "__main__":
    sys.exit(main())
