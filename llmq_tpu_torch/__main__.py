"""Command line: ``python -m llmq_tpu_torch serve|check``.

``serve`` runs the monolith until SIGINT/SIGTERM: the REST API, the
preprocessor, the queue factory's managers with their delayed and
dead-letter queues, the workers (retry backoff, watchdog), the
conversation service tied to the engine's KV pins, the engine and its
crash supervisor. ``check`` builds the same monolith on an ephemeral
port, sends one message through REST end to end and exits 0 when it
completes. Both run on ``cuda`` unless ``--device cpu`` is given.

Configuration: dataclass defaults, then ``LLMQ_*`` environment
overrides, then these flags.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
import time
import urllib.request
from typing import List, Optional

import torch

from llmq_tpu_torch.api.message_store import MessageStore
from llmq_tpu_torch.api.server import ApiServer
from llmq_tpu_torch.conversation.persistence import make_store
from llmq_tpu_torch.conversation.state_manager import StateManager
from llmq_tpu_torch.core.config import Config, load_config
from llmq_tpu_torch.engine.builder import build_engine
from llmq_tpu_torch.engine.engine import InferenceEngine
from llmq_tpu_torch.engine.supervisor import EngineSupervisor
from llmq_tpu_torch.preprocessor.preprocessor import Preprocessor
from llmq_tpu_torch.queueing.factory import QueueFactory, QueueType

log = logging.getLogger("llmq_tpu_torch")


class App:
    """The serving process, wired as the JAX package's ``App`` wires the
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
        # On the card the engine warms up before it serves: every program
        # runs once and its CUDA graph is captured.
        self.engine = engine if engine is not None else build_engine(
            cfg, warmup=torch.device(cfg.device).type == "cuda")
        # Conversation eviction frees the conversation's pinned KV.
        self.engine.attach_conversation_manager(self.state_manager)
        self.supervisor: Optional[EngineSupervisor] = None
        if cfg.executor.supervisor.enabled:
            self.supervisor = EngineSupervisor(
                self.engine, config=cfg.executor.supervisor)
        self.workers = self.factory.create_workers(
            "standard", max(1, cfg.queue.worker.count),
            self.engine.process_fn, start=False)
        self.message_store = MessageStore()
        self.api = ApiServer(cfg, queue_factory=self.factory,
                             preprocessor=self.preprocessor,
                             state_manager=self.state_manager,
                             engine=self.engine,
                             message_store=self.message_store)

    def start(self, host: Optional[str] = None,
              port: Optional[int] = None) -> int:
        """Start everything; returns the API's bound port."""
        self.state_manager.start()
        self.engine.start()
        if self.supervisor is not None:
            self.supervisor.start()
        for w in self.workers:
            w.start()
        return self.api.start(host, port)

    def stop(self) -> None:
        """The shutdown cascade: the supervisor before the engine (else
        it would take the deliberate stop for a crash)."""
        if self.supervisor is not None:
            self.supervisor.stop()
        self.api.stop()
        self.factory.stop_all()
        self.engine.stop()
        self.state_manager.stop()


def _load(args) -> Config:
    cfg = load_config()
    if args.host is not None:
        cfg.server.host = args.host
    if args.port is not None:
        cfg.server.port = args.port
    if args.model is not None:
        cfg.model.name = args.model
    if args.device is not None:
        cfg.device = args.device
    return cfg


def cmd_serve(args) -> int:
    cfg = _load(args)
    app = App(cfg)
    port = app.start()
    print(f"serving {cfg.model.name} on {cfg.device} at "
          f"http://{cfg.server.host}:{port}", flush=True)
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    app.stop()
    return 0


def cmd_check(args) -> int:
    """Run one message end to end through REST; exit 0 when it
    completes with usage metadata."""
    cfg = _load(args)
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
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(
        prog="llmq_tpu_torch",
        description="LLM message queue + serving on PyTorch/CUDA")
    parser.add_argument("--host", help="override server.host")
    parser.add_argument("--port", type=int, help="override server.port")
    parser.add_argument("--model", help="override model.name "
                        "(llama3-tiny | llama3-1b | llama3-8b | llama3-70b)")
    parser.add_argument("--device", help="override device (cuda | cpu)")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("serve", help="monolith: API + workers + engine")
    chk = sub.add_parser("check", help="one message end to end, then exit")
    chk.add_argument("--timeout", type=float, default=120.0,
                     help="seconds to wait for the message")
    args = parser.parse_args(argv)
    return {"serve": cmd_serve, "check": cmd_check}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
