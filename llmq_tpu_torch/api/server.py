"""REST API on the standard library's ``http.server`` (the port's
counterpart of ``llmq_tpu/api/server.py``, with the routes of the planes
the port has):

- ``GET  /health`` (engine liveness; ``draining`` while the process
  drains)
- ``GET  /metrics`` (Prometheus text exposition, ``metrics/registry.py``)
- ``POST /api/v1/messages`` → 202, or with ``"stream": true`` an SSE
  stream of tokens; ``GET /api/v1/messages`` (filters) and
  ``GET /api/v1/messages/:id``
- ``POST /api/v1/conversations``, ``GET /api/v1/conversations/:id``,
  ``POST /api/v1/conversations/:id/messages``,
  ``PUT /api/v1/conversations/:id/state``,
  ``GET /api/v1/users/:user_id/conversations``
- ``GET /api/v1/queues/stats``, ``GET /api/v1/engine/stats``
- ``POST /api/v1/resources``, ``GET /api/v1/resources``,
  ``GET /api/v1/resources/stats`` (the resource scheduler)
- ``POST /api/v1/endpoints``, ``GET /api/v1/endpoints``,
  ``GET /api/v1/endpoints/stats``, ``POST /api/v1/endpoints/:id/drain``,
  ``DELETE /api/v1/endpoints/:id`` (the load balancer)
- ``POST /api/v1/generate`` (synchronous generation)
- observability: ``GET /api/v1/requests/:id/trace`` (one request's
  timeline, ``?format=chrome`` for Perfetto), ``GET /api/v1/usage``,
  ``GET /api/v1/analysis/critical-path``,
  ``GET /api/v1/admin/flightrecorder``, ``POST``/``GET
  /api/v1/admin/profile`` (a bounded on-demand ``torch.profiler``
  capture; 409 while one runs)
- admin: the process drain, preprocessor rules and user priorities,
  removal of a pending message, dead-letter requeue (one and all)

Every submission runs through the preprocessor (priority inference),
the overload shedder (429/503 with ``Retry-After``), the queue manager
and the conversation service, and stamps its ``enqueued`` stage (the
SSE path its ``dispatched`` too) into the flight recorder. The routes
of planes the port does not have yet (cluster, tenancy, control plane)
wait for them.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from llmq_tpu_torch import __version__, observability
from llmq_tpu_torch.api.message_store import MessageStore
from llmq_tpu_torch.api.overload import build_shedder
from llmq_tpu_torch.core.config import Config
from llmq_tpu_torch.core.errors import QueueFullError, QueueNotFoundError
from llmq_tpu_torch.core.types import (ConversationState, Message,
                                       MessageStatus, Priority, new_id)
from llmq_tpu_torch.loadbalancer.load_balancer import Endpoint, EndpointStatus
from llmq_tpu_torch.metrics.registry import exposition
from llmq_tpu_torch.scheduling.resource_scheduler import (Resource,
                                                          ResourceStatus,
                                                          ResourceType)
from llmq_tpu_torch.utils.logging import bind_log_context, reset_log_context

log = logging.getLogger("llmq_tpu_torch.api")

#: Fallback per-tier wait estimates, seconds, before any wait is measured.
_WAIT_TABLE = {Priority.REALTIME: 1.0, Priority.HIGH: 5.0,
               Priority.NORMAL: 15.0, Priority.LOW: 30.0}

Handler = Callable[["_Request"], Tuple[int, Any]]


class _Deadline:
    """The worker context's deadline for the synchronous generate route:
    the engine's ``process_fn`` only consults ``remaining()``."""

    def __init__(self, secs: float) -> None:
        self._deadline = time.monotonic() + secs

    def remaining(self) -> float:
        return self._deadline - time.monotonic()


class _SSEStream:
    """Dispatch payload marker: each yielded string is written as it is
    produced (``text/event-stream``). ``on_close`` (idempotent) runs when
    the HTTP handler is done with the stream, also when the generator
    never started."""

    def __init__(self, events, on_close=None, headers=None) -> None:
        self.events = events
        self.on_close = on_close
        self.headers = headers or {}

    def __iter__(self):
        return iter(self.events)


class ApiError(Exception):
    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None) -> None:
        super().__init__(message)
        self.status = status
        self.message = message
        #: Seconds the client should wait before retrying (overload
        #: shedding): a ``Retry-After`` header and a ``retry_after``
        #: body field.
        self.retry_after = retry_after


class _Request:
    """Parsed request handed to route handlers."""

    def __init__(self, method: str, path: str, params: Dict[str, str],
                 query: Dict[str, List[str]], body: bytes,
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.method = method
        self.path = path
        self.params = params
        self.query = query
        self._body = body
        self.headers = {str(k).lower(): v
                        for k, v in (headers or {}).items()}

    def json(self) -> Dict[str, Any]:
        if not self._body:
            raise ApiError(400, "request body required")
        try:
            data = json.loads(self._body)
        except json.JSONDecodeError as e:
            raise ApiError(400, f"invalid JSON: {e}") from None
        if not isinstance(data, dict):
            raise ApiError(400, "JSON object expected")
        return data

    def q(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default


class ApiServer:
    """The v1 REST contract over the queue factory, the preprocessor, the
    conversation service and the engine."""

    def __init__(self, config: Optional[Config] = None, *,
                 queue_factory=None, preprocessor=None, state_manager=None,
                 load_balancer=None, resource_scheduler=None,
                 engine=None, drain_hook: Optional[Callable[[], None]] = None,
                 message_store: Optional[MessageStore] = None,
                 manager_name: str = "standard") -> None:
        self.config = config or Config()
        self.factory = queue_factory
        self.preprocessor = preprocessor
        self.state_manager = state_manager
        self.load_balancer = load_balancer
        self.resource_scheduler = resource_scheduler
        self.engine = engine
        #: The process drain (``App.drain``), run on a thread of its own
        #: by the admin route.
        self.drain_hook = drain_hook
        #: While True, /health answers status "draining".
        self.draining = False
        self.store = message_store or MessageStore()
        self.manager_name = manager_name
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        # SSE admission: streams bypass the queue plane, so they carry a
        # gate of their own (_acquire_stream_slot).
        self._stream_mu = threading.Lock()
        self._active_streams = 0
        #: None when overload.enabled is false. The resource scheduler's
        #: learned prefill rate feeds its deadline check.
        self.shedder = build_shedder(self.config, engine=engine,
                                     resource_scheduler=resource_scheduler)
        self._setup_routes()

    # -- SSE admission -------------------------------------------------------

    def _acquire_stream_slot(self) -> None:
        """429 past the concurrent-stream cap, 503 when the engine's
        pending queue is already deep."""
        scfg = self.config.server
        limit = scfg.stream_pending_limit
        if limit > 0 and self.engine is not None:
            pending = self.engine.get_stats().get("pending", 0)
            if pending >= limit:
                raise ApiError(
                    503, f"engine backlog too deep for streaming "
                         f"({pending} pending >= {limit})")
        cap = scfg.max_concurrent_streams
        with self._stream_mu:
            if cap > 0 and self._active_streams >= cap:
                raise ApiError(
                    429, f"too many concurrent streams (max {cap})")
            self._active_streams += 1

    def _release_stream_slot(self) -> None:
        with self._stream_mu:
            if self._active_streams > 0:
                self._active_streams -= 1

    # -- routing table -------------------------------------------------------

    def _route(self, method: str, pattern: str, handler: Handler) -> None:
        rx = re.sub(r":(\w+)", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method, re.compile(f"^{rx}$"), handler))

    def _setup_routes(self) -> None:
        r = self._route
        r("GET", "/health", self.health_check)
        r("GET", "/metrics", self.metrics_exposition)
        v1 = "/api/v1"
        r("POST", f"{v1}/messages", self.submit_message)
        r("GET", f"{v1}/messages/:id", self.get_message)
        r("GET", f"{v1}/messages", self.list_messages)
        r("POST", f"{v1}/conversations", self.create_conversation)
        r("GET", f"{v1}/conversations/:id", self.get_conversation)
        r("POST", f"{v1}/conversations/:id/messages",
          self.add_message_to_conversation)
        r("PUT", f"{v1}/conversations/:id/state",
          self.update_conversation_state)
        r("GET", f"{v1}/users/:user_id/conversations",
          self.list_user_conversations)
        r("GET", f"{v1}/queues/stats", self.get_queue_stats)
        r("POST", f"{v1}/resources", self.register_resource)
        r("GET", f"{v1}/resources", self.list_resources)
        r("GET", f"{v1}/resources/stats", self.get_resource_stats)
        r("POST", f"{v1}/endpoints", self.register_endpoint)
        r("GET", f"{v1}/endpoints", self.list_endpoints)
        r("GET", f"{v1}/endpoints/stats", self.get_endpoint_stats)
        r("POST", f"{v1}/endpoints/:id/drain", self.drain_endpoint)
        r("DELETE", f"{v1}/endpoints/:id", self.delete_endpoint)
        r("GET", f"{v1}/engine/stats", self.get_engine_stats)
        r("GET", f"{v1}/usage", self.get_usage)
        r("GET", f"{v1}/analysis/critical-path", self.get_critical_path)
        r("POST", f"{v1}/generate", self.generate_sync)
        r("GET", f"{v1}/requests/:id/trace", self.get_request_trace)
        adm = f"{v1}/admin"
        r("GET", f"{adm}/flightrecorder", self.get_flight_recorder)
        r("POST", f"{adm}/profile", self.start_profile)
        r("GET", f"{adm}/profile", self.get_profile_status)
        r("POST", f"{adm}/drain", self.drain_self)
        r("POST", f"{adm}/preprocessor/rules", self.add_priority_rule)
        r("GET", f"{adm}/preprocessor/rules", self.list_priority_rules)
        r("POST", f"{adm}/preprocessor/user-priorities",
          self.set_user_priority)
        r("DELETE", f"{adm}/queues/:queue_type/:id", self.remove_message)
        r("POST", f"{adm}/dead-letter/requeue/:id",
          self.requeue_dead_letter_message)
        r("POST", f"{adm}/dead-letter/requeue-all",
          self.requeue_all_dead_letter_messages)

    def dispatch(self, method: str, raw_path: str, body: bytes,
                 headers: Optional[Dict[str, str]] = None,
                 ) -> Tuple[int, Any, str]:
        """Route one request. Returns (status, payload, content_type)."""
        parsed = urlparse(raw_path)
        path = parsed.path.rstrip("/") or "/"
        query = parse_qs(parsed.query)
        matched_path = False
        for m, rx, handler in self._routes:
            match = rx.match(path)
            if not match:
                continue
            matched_path = True
            if m != method:
                continue
            req = _Request(method, path, match.groupdict(), query, body,
                           headers)
            ltoken = bind_log_context(endpoint=path)
            try:
                status, payload = handler(req)
            except ApiError as e:
                err: Dict[str, Any] = {"error": e.message}
                if e.retry_after is not None:
                    err["retry_after"] = round(float(e.retry_after), 3)
                return e.status, err, "application/json"
            except QueueNotFoundError as e:
                return 404, {"error": str(e)}, "application/json"
            except QueueFullError as e:
                return 503, {"error": str(e)}, "application/json"
            except Exception as e:  # noqa: BLE001 — one bad request must not kill the server
                log.exception("handler error on %s %s", method, path)
                return 500, {"error": f"internal error: {e}"}, \
                    "application/json"
            finally:
                reset_log_context(ltoken)
            if isinstance(payload, bytes):
                return status, payload, "text/plain; version=0.0.4"
            if isinstance(payload, _SSEStream):
                return status, payload, "text/event-stream"
            return status, payload, "application/json"
        if matched_path:
            return 405, {"error": "method not allowed"}, "application/json"
        return 404, {"error": "not found"}, "application/json"

    # -- helpers -------------------------------------------------------------

    def _manager(self, name: Optional[str] = None):
        if self.factory is None:
            raise ApiError(503, "queue factory not configured")
        mgr = self.factory.get_queue_manager(name or self.manager_name)
        if mgr is None:
            if name:
                raise ApiError(404, f"no queue manager named {name!r}")
            raise ApiError(500, "failed to access message queue")
        return mgr

    def _require_state_manager(self):
        if self.state_manager is None:
            raise ApiError(503, "conversation service not configured")
        return self.state_manager

    def _require_preprocessor(self):
        if self.preprocessor is None:
            raise ApiError(503, "preprocessor not configured")
        return self.preprocessor

    def estimate_wait(self, priority: Priority) -> float:
        """Measured per-tier estimate (average wait scaled by the
        backlog), with a fixed table before any wait is measured."""
        fallback = _WAIT_TABLE.get(priority, 15.0)
        if self.factory is None:
            return fallback
        mgr = self.factory.get_queue_manager(self.manager_name)
        if mgr is None:
            return fallback
        try:
            stats = mgr.get_stats(priority.tier_name)
        except QueueNotFoundError:
            return fallback
        if stats.wait_samples == 0:
            return fallback
        backlog_factor = 1.0 + stats.pending_count / max(
            1, stats.completed_count + stats.processing_count)
        return round(stats.avg_wait_time * backlog_factor, 4)

    @staticmethod
    def _parse_message(data: Dict[str, Any], tenant_header: str) -> Message:
        if not isinstance(data.get("content", ""), str):
            raise ApiError(400, "content must be a string")
        if not isinstance(data.get("metadata", {}), dict):
            raise ApiError(400, "metadata must be an object")
        try:
            msg = Message.from_dict(data)
        except (ValueError, TypeError) as e:
            raise ApiError(400, f"invalid message: {e}") from None
        # The X-Tenant-Id header wins over the body field.
        msg.tenant_id = observability.sanitize_tenant(
            tenant_header or msg.tenant_id)
        return msg

    def _ingest_message(self, data: Dict[str, Any],
                        conversation_id: str = "",
                        tenant_header: str = "") -> Message:
        """Shared submit pipeline: parse → id/timestamps → preprocess →
        analysis metadata → shed → push → store → conversation update."""
        msg = self._parse_message(data, tenant_header)
        if conversation_id:
            msg.conversation_id = conversation_id
        if not msg.id:
            msg.id = new_id()
        now = time.time()
        msg.created_at = now
        msg.updated_at = now
        if self.preprocessor is not None:
            msg = self.preprocessor.process_message(msg)
            if self.preprocessor.enable_content_analysis:
                # The analysis also goes under metadata["analysis"] as a
                # JSON string, from the keys process_message annotated.
                msg.metadata["analysis"] = json.dumps(
                    {k: msg.metadata[k]
                     for k in ("word_count", "char_count", "sentiment",
                               "is_question") if k in msg.metadata})
        mgr = self._manager()
        if self.shedder is not None:
            # A shed request never entered the queue plane: its 429/503
            # and Retry-After are its whole outcome.
            self.shedder.admit(msg, mgr, self.estimate_wait(msg.priority))
        # Stamped before the push: a near-idle worker can pop and stamp
        # "scheduled" before this thread resumes.
        observability.record(msg.id, "enqueued",
                             priority=msg.priority.tier_name,
                             conversation_id=msg.conversation_id,
                             user_id=msg.user_id)
        mgr.push_message(msg)
        self.store.record(msg)
        if msg.conversation_id and self.state_manager is not None:
            try:
                self.state_manager.add_message(msg.conversation_id, msg)
            except Exception:  # noqa: BLE001 — log, don't fail the submit
                log.exception("conversation update failed for %s", msg.id)
        return msg

    # -- handlers ------------------------------------------------------------

    def health_check(self, req: _Request) -> Tuple[int, Any]:
        out: Dict[str, Any] = {
            "status": "draining" if self.draining else "ok",
            "version": __version__, "time": time.time()}
        if self.engine is not None:
            out["engine"] = "running" if self.engine.running else "stopped"
        self._add_boot(out)
        return 200, out

    @staticmethod
    def _add_boot(out: Dict[str, Any]) -> None:
        """This process's boot decomposition (critical-path plane), when
        the plane is on and an entry point or a build opened one."""
        try:
            if observability.cp_enabled():
                boot = observability.process_boot_snapshot()
                if boot is not None:
                    out["boot"] = boot
        except Exception:  # noqa: BLE001 — never fail a route on telemetry
            log.exception("boot snapshot failed")

    def metrics_exposition(self, req: _Request) -> Tuple[int, Any]:
        return 200, exposition()

    def submit_message(self, req: _Request) -> Tuple[int, Any]:
        data = req.json()
        stream = data.pop("stream", False)
        if stream is None:
            stream = False
        if isinstance(stream, str):
            low = stream.strip().lower()
            if low in ("true", "1", "yes", "on"):
                stream = True
            elif low in ("false", "0", "no", "off", ""):
                stream = False
            else:
                raise ApiError(400, f"invalid stream value {stream!r}")
        elif not isinstance(stream, (bool, int)):
            raise ApiError(400, "stream must be a boolean")
        tenant = req.headers.get("x-tenant-id", "")
        if stream:
            return self._stream_message(data, tenant_header=tenant)
        msg = self._ingest_message(data, tenant_header=tenant)
        return 202, {
            "message_id": msg.id,
            "priority": int(msg.priority),
            "queue_time": time.time(),
            "estimated_wait": self.estimate_wait(msg.priority),
        }

    def _stream_message(self, data: Dict[str, Any],
                        tenant_header: str = "") -> Tuple[int, Any]:
        """``POST /api/v1/messages`` with ``"stream": true``: tokens over
        SSE. The message goes straight to the engine with an ``on_token``
        subscription (first-token latency is what a realtime client
        feels); it is still recorded in the store and its conversation
        updated, so the query API sees it like a queued one. Events:
        ``event: start``, ``data: {"token": ...}`` per committed burst,
        ``event: done`` with ``finish_reason``, ``first_token_ms`` and
        ``usage``."""
        if self.engine is None:
            raise ApiError(503, "streaming requires an attached engine")
        from queue import Empty, Queue

        from llmq_tpu_torch.engine.engine import GenRequest

        # The client's timeout, read before Message.from_dict fills in
        # the 30 s default: an unset field gets the streaming default.
        explicit_timeout = data.get("timeout")
        if explicit_timeout is not None:
            try:
                explicit_timeout = float(explicit_timeout)
            except (TypeError, ValueError):
                raise ApiError(
                    400, f"timeout must be a number, "
                         f"got {explicit_timeout!r}") from None
        msg = self._parse_message(data, tenant_header)
        if self.shedder is not None:
            # Engine-down and SLA shedding; no manager: the stream cap
            # and backlog gates below stand in for the queue's.
            self.shedder.admit(msg, None, 0.0)
        self._acquire_stream_slot()
        try:
            if not msg.id:
                msg.id = new_id()
            msg.created_at = msg.updated_at = time.time()
            if self.preprocessor is not None:
                msg = self.preprocessor.process_message(msg)
            msg.status = MessageStatus.PROCESSING
            self.store.record(msg)
            if msg.conversation_id and self.state_manager is not None:
                try:
                    self.state_manager.add_message(msg.conversation_id, msg)
                except Exception:  # noqa: BLE001 — log, don't fail
                    log.exception("conversation update failed for %s",
                                  msg.id)
            observability.record(msg.id, "enqueued",
                                 priority=msg.priority.tier_name,
                                 conversation_id=msg.conversation_id,
                                 user_id=msg.user_id, stream=True)
            # The SSE path bypasses the queue: the submit is the dispatch,
            # stamped before it so the engine's admission cannot come
            # first.
            observability.record(msg.id, "dispatched",
                                 endpoint=getattr(self.engine, "name",
                                                  "engine"),
                                 reason="stream",
                                 priority=msg.priority.tier_name)
            tokens: "Queue[int]" = Queue()
            handle = self.engine.submit(GenRequest.from_message(msg),
                                        on_token=tokens.put)
            tokenizer = self.engine.tokenizer
            timeout = (explicit_timeout
                       if explicit_timeout and explicit_timeout > 0
                       else 120.0)
        except BaseException:
            self._release_stream_slot()
            raise

        def events():
            yield ("event: start\ndata: "
                   + json.dumps({"message_id": msg.id,
                                 "priority": int(msg.priority)})
                   + "\n\n")
            ids: List[int] = []
            sent = ""
            deadline = time.monotonic() + timeout

            def drain_delta(final: bool = False) -> str:
                nonlocal sent
                # Cumulative decode, then slice: a per-id decode would
                # split multi-byte characters at burst boundaries. A
                # trailing U+FFFD is held back mid-stream (its tail
                # usually lands in the next burst); the final flush
                # emits everything.
                full = tokenizer.decode(ids)
                safe = full
                if not final:
                    while safe and safe[-1] == "�":
                        safe = safe[:-1]
                if len(safe) < len(sent):
                    return ""
                delta, sent = safe[len(sent):], safe
                return delta

            try:
                while True:
                    try:
                        ids.append(tokens.get(timeout=0.05))
                    except Empty:
                        if handle.done:
                            break
                        if time.monotonic() > deadline:
                            handle.cancel()
                            break
                        continue
                    while not tokens.empty():   # a burst → one event
                        ids.append(tokens.get_nowait())
                    delta = drain_delta()
                    if delta:
                        yield ("data: " + json.dumps({"token": delta})
                               + "\n\n")
                handle.wait(5.0)
                while not tokens.empty():
                    ids.append(tokens.get_nowait())
                delta = drain_delta(final=True)
                if delta:
                    yield "data: " + json.dumps({"token": delta}) + "\n\n"
                res = handle.result
                first_ms = None
                if "first_token" in handle.marks:
                    first_ms = round((handle.marks["first_token"]
                                      - handle.submitted_at) * 1e3, 1)
                msg.response = res.text if res else sent
                msg.status = (MessageStatus.COMPLETED
                              if res and res.finish_reason in
                              ("eos", "length") else MessageStatus.FAILED)
                msg.updated_at = time.time()
                usage = {
                    "prompt_tokens": res.prompt_tokens if res else 0,
                    "completion_tokens": len(res.tokens) if res else 0,
                }
                if handle.usage is not None:
                    # What this request cost, from the usage ledger.
                    usage.update(handle.usage)
                done = {
                    "message_id": msg.id,
                    "finish_reason": res.finish_reason if res else "timeout",
                    "first_token_ms": first_ms,
                    "usage": usage,
                }
                yield "event: done\ndata: " + json.dumps(done) + "\n\n"
            except BaseException:
                # Client gone (GeneratorExit) or a mid-stream failure:
                # stop generating for it and close out the record.
                handle.cancel()
                msg.status = MessageStatus.FAILED
                msg.updated_at = time.time()
                raise

        # The slot is released once: from the generator's finally, or
        # from on_close when the generator never started (then the
        # engine request is cancelled here too).
        released = threading.Event()
        started = threading.Event()

        def release_once():
            if released.is_set():
                return
            released.set()
            self._release_stream_slot()
            if not started.is_set():
                handle.cancel()
                msg.status = MessageStatus.FAILED
                msg.updated_at = time.time()

        def guarded():
            started.set()
            try:
                yield from events()
            finally:
                release_once()

        return 200, _SSEStream(
            guarded(), on_close=release_once,
            headers={"traceparent": observability.make_traceparent(msg.id),
                     "X-Request-Id": msg.id})

    def get_message(self, req: _Request) -> Tuple[int, Any]:
        msg = self.store.get(req.params["id"])
        if msg is None:
            return 404, {"error": "message not found"}
        return 200, msg.to_dict()

    def list_messages(self, req: _Request) -> Tuple[int, Any]:
        try:
            limit = int(req.q("limit", "10"))
            offset = int(req.q("offset", "0"))
        except ValueError:
            raise ApiError(400, "limit/offset must be integers") from None
        msgs = self.store.list(
            user_id=req.q("user_id"),
            conversation_id=req.q("conversation_id"),
            status=req.q("status"),
            limit=limit, offset=offset)
        return 200, {"messages": [m.to_dict() for m in msgs],
                     "count": len(msgs)}

    def create_conversation(self, req: _Request) -> Tuple[int, Any]:
        data = req.json()
        user_id = data.get("user_id")
        if not user_id:
            raise ApiError(400, "user_id is required")
        sm = self._require_state_manager()
        conv = sm.create(user_id, metadata=data.get("metadata") or {})
        return 201, {
            "conversation_id": conv.id,
            "user_id": conv.user_id,
            "created_at": conv.created_at,
            "state": conv.state.value,
        }

    def get_conversation(self, req: _Request) -> Tuple[int, Any]:
        sm = self._require_state_manager()
        try:
            conv = sm.get(req.params["id"])
        except KeyError:
            return 404, {"error": "conversation not found"}
        return 200, conv.to_dict()

    def add_message_to_conversation(self, req: _Request) -> Tuple[int, Any]:
        conv_id = req.params["id"]
        msg = self._ingest_message(
            req.json(), conversation_id=conv_id,
            tenant_header=req.headers.get("x-tenant-id", ""))
        return 202, {
            "message_id": msg.id,
            "conversation_id": conv_id,
            "priority": int(msg.priority),
            "queue_time": time.time(),
            "estimated_wait": self.estimate_wait(msg.priority),
        }

    def update_conversation_state(self, req: _Request) -> Tuple[int, Any]:
        data = req.json()
        state = data.get("state")
        if not state:
            raise ApiError(400, "state is required")
        try:
            new_state = ConversationState(state)
        except ValueError:
            raise ApiError(
                400, f"invalid state {state!r}; valid: "
                f"{[s.value for s in ConversationState]}") from None
        sm = self._require_state_manager()
        try:
            sm.update_state(req.params["id"], new_state)
        except KeyError:
            return 404, {"error": "conversation not found"}
        return 200, {"status": "updated"}

    def list_user_conversations(self, req: _Request) -> Tuple[int, Any]:
        sm = self._require_state_manager()
        convs = sm.user_conversations(req.params["user_id"])
        return 200, {"conversations": [c.to_dict(include_messages=False)
                                       for c in convs]}

    def get_queue_stats(self, req: _Request) -> Tuple[int, Any]:
        if self.factory is None:
            raise ApiError(503, "queue factory not configured")
        stats: Dict[str, Any] = {}
        for name in self.factory.manager_names():
            mgr = self.factory.get_queue_manager(name)
            if mgr is None:
                continue
            stats[name] = {qn: s.to_dict()
                           for qn, s in mgr.get_all_stats().items()}
            stats[name]["workers"] = self.factory.get_worker_stats(name)
            dlq = self.factory.get_dead_letter_queue(name)
            if dlq is not None:
                stats[name]["dead_letter_size"] = dlq.size()
        return 200, stats

    def register_resource(self, req: _Request) -> Tuple[int, Any]:
        if self.resource_scheduler is None:
            raise ApiError(503, "resource scheduler not configured")
        data = req.json()
        try:
            capacity = {ResourceType(k): float(v)
                        for k, v in (data.get("capacity") or {}).items()}
            res = Resource(
                id=data.get("id") or new_id(),
                model_type=data.get("model_type", "llm"),
                capabilities=set(data.get("capabilities") or []),
                capacity=capacity,
                endpoint=data.get("endpoint", ""),
                status=ResourceStatus(data.get("status", "online")),
                metadata=data.get("metadata") or {},
            )
        except (ValueError, TypeError) as e:
            raise ApiError(400, f"invalid resource: {e}") from None
        self.resource_scheduler.register_resource(res)
        return 201, {"resource_id": res.id, "status": res.status.value}

    def list_resources(self, req: _Request) -> Tuple[int, Any]:
        if self.resource_scheduler is None:
            raise ApiError(503, "resource scheduler not configured")
        return 200, {"resources": [
            r.to_dict() for r in self.resource_scheduler.resources()]}

    def get_resource_stats(self, req: _Request) -> Tuple[int, Any]:
        if self.resource_scheduler is None:
            raise ApiError(503, "resource scheduler not configured")
        return 200, self.resource_scheduler.get_stats()

    def register_endpoint(self, req: _Request) -> Tuple[int, Any]:
        if self.load_balancer is None:
            raise ApiError(503, "load balancer not configured")
        data = req.json()
        try:
            ep = Endpoint(
                id=data.get("id") or new_id(),
                name=data.get("name", ""),
                url=data.get("url", ""),
                model_type=data.get("model_type", "llm"),
                weight=float(data.get("weight", 1.0)),
                max_connections=int(data.get("max_connections", 0)),
                status=EndpointStatus(data.get("status", "healthy")),
                metadata=data.get("metadata") or {},
            )
        except (ValueError, TypeError) as e:
            raise ApiError(400, f"invalid endpoint: {e}") from None
        self.load_balancer.add_endpoint(ep)
        return 201, {"endpoint_id": ep.id, "status": ep.status.value}

    def list_endpoints(self, req: _Request) -> Tuple[int, Any]:
        if self.load_balancer is None:
            raise ApiError(503, "load balancer not configured")
        return 200, {"endpoints": [e.to_dict()
                                   for e in self.load_balancer.endpoints()]}

    def get_endpoint_stats(self, req: _Request) -> Tuple[int, Any]:
        if self.load_balancer is None:
            raise ApiError(503, "load balancer not configured")
        return 200, self.load_balancer.get_stats()

    def drain_endpoint(self, req: _Request) -> Tuple[int, Any]:
        """Take an endpoint out of new dispatch (its in-flight work
        finishes). Body ``{"drain": false}`` re-admits it through
        DEGRADED, and the health probe restores full traffic."""
        lb = self.load_balancer
        if lb is None:
            raise ApiError(503, "load balancer not configured")
        eid = req.params["id"]
        drain = True
        if req._body:   # noqa: SLF001 — same module
            drain = bool(req.json().get("drain", True))
        if lb.get_endpoint_by_id(eid) is None:
            return 404, {"error": f"no endpoint {eid!r}"}
        lb.set_draining(eid, drain)
        return 200, {"endpoint_id": eid,
                     "status": "draining" if drain else "degraded"}

    def delete_endpoint(self, req: _Request) -> Tuple[int, Any]:
        if self.load_balancer is None:
            raise ApiError(503, "load balancer not configured")
        eid = req.params["id"]
        if not self.load_balancer.remove_endpoint(eid):
            return 404, {"error": f"no endpoint {eid!r}"}
        return 200, {"status": "removed", "endpoint_id": eid}

    def drain_self(self, req: _Request) -> Tuple[int, Any]:
        """The process drain: /health reads "draining" at once; the
        drain hook (stop taking new work, wait out what is in flight)
        runs on a thread of its own, so the response does not wait."""
        self.draining = True
        if self.drain_hook is not None:
            threading.Thread(target=self.drain_hook, name="api-drain",
                             daemon=True).start()
        return 202, {"status": "draining"}

    def get_engine_stats(self, req: _Request) -> Tuple[int, Any]:
        if self.engine is None:
            raise ApiError(503, "engine not configured")
        out = self.engine.get_stats()
        try:
            # The process's SLO burn rates, after draining the recorder's
            # deferred feed (this route must show real burn even when
            # nothing scrapes /metrics).
            observability.get_recorder().flush_metrics()
            out["slo"] = observability.get_slo_tracker().snapshot()
        except Exception:  # noqa: BLE001 — stats must not fail on SLO plane
            log.exception("SLO snapshot failed")
        try:
            led = observability.get_usage_ledger()
            if led.enabled:
                out["usage"] = led.snapshot(top_conversations=0)
        except Exception:  # noqa: BLE001 — stats must not fail on usage plane
            log.exception("usage snapshot failed")
        self._add_boot(out)
        return 200, out

    def get_critical_path(self, req: _Request) -> Tuple[int, Any]:
        """Critical-path rollup: per-segment time totals and shares,
        dominant-segment counts, recent decompositions and every known
        boot decomposition. ``?recent=N`` sizes the recent list."""
        ana = observability.get_critical_path()
        if not ana.enabled:
            raise ApiError(503, "critical-path plane disabled "
                                "(set observability.critical_path"
                                ".enabled)")
        try:
            # Drain the recorder's deferred feed first, so the rollup
            # holds every finished request even with nothing scraping.
            observability.get_recorder().flush_metrics()
        except Exception:  # noqa: BLE001 — rollup must not fail on trace plane
            log.exception("flight-recorder flush failed")
        try:
            recent = int(req.q("recent") or 20)
        except ValueError:
            raise ApiError(400, "recent must be an integer")
        out = ana.snapshot(recent=max(0, min(recent, 256)))
        out["boot"] = observability.get_boot_registry().snapshot()
        return 200, out

    def get_usage(self, req: _Request) -> Tuple[int, Any]:
        """Usage-ledger rollups: per-tenant/priority/engine
        device-seconds, KV page-seconds, waste by reason and the rolling
        goodput. ``?tenant=`` narrows to one tenant's rollup."""
        led = observability.get_usage_ledger()
        if not led.enabled:
            raise ApiError(503, "usage plane disabled "
                                "(set observability.usage.enabled)")
        try:
            # The goodput join is fed by the recorder's flush.
            observability.get_recorder().flush_metrics()
        except Exception:  # noqa: BLE001 — usage must not fail on trace plane
            log.exception("flight-recorder flush failed")
        snap = led.snapshot()
        tenant = req.q("tenant")
        if tenant:
            return 200, {
                "tenant": tenant,
                "usage": snap["tenants"].get(tenant),
                "goodput": snap["goodput"],
            }
        return 200, snap

    def generate_sync(self, req: _Request) -> Tuple[int, Any]:
        """Synchronous generation: the message goes straight to the
        engine and the completion comes back in the response."""
        if self.engine is None:
            raise ApiError(503, "no engine attached to this process")
        if not self.engine.running:
            # Fail fast: a submit to a stopped engine would block the
            # caller for its whole generation budget.
            raise ApiError(503, "engine not running on this host")
        data = req.json()
        timeout = float(data.pop("timeout", 0) or 120.0)
        try:
            msg = Message.from_dict(data)
        except (ValueError, TypeError) as e:
            raise ApiError(400, f"invalid message: {e}") from None
        if not msg.id:
            msg.id = new_id()
        # The caller's W3C trace context is recorded onto this host's
        # timeline (the same trace id: both sides derive it from the
        # message id), and the arrival is the request's "dispatched".
        traceparent = req.headers.get(observability.TRACEPARENT_HEADER)
        parsed_tp = observability.parse_traceparent(traceparent)
        observability.record(
            msg.id, "dispatched", reason="remote",
            priority=msg.priority.tier_name,
            traceparent=traceparent or "",
            parent_span_id=parsed_tp.span_id if parsed_tp else "")
        try:
            self.engine.process_fn(_Deadline(timeout), msg)
        except TimeoutError as e:
            raise ApiError(504, str(e)) from None
        except RuntimeError as e:
            raise ApiError(500, f"generation failed: {e}") from None
        out = {"message_id": msg.id, "response": msg.response,
               "usage": msg.metadata.get("usage", {})}
        if self.config.observability.propagate_trace:
            rec = observability.get_recorder()
            if rec.enabled:
                tl = rec.get(msg.id)
                if tl is not None:
                    # This host's events, for a caller to merge.
                    out["trace"] = [e.to_dict()
                                    for e in tl.sorted_events()]
        return 200, out

    # -- observability -------------------------------------------------------

    def get_request_trace(self, req: _Request) -> Tuple[int, Any]:
        """One request's lifecycle timeline. ``?format=chrome`` exports
        a chrome://tracing / Perfetto document with the engine's host
        spans stitched in (and a pointer to the ``torch.profiler``
        capture directory when LLMQ_TRACE_DIR is set)."""
        rec = observability.get_recorder()
        if not rec.enabled:
            raise ApiError(503, "observability disabled "
                                "(set observability.enabled)")
        tl = rec.get(req.params["id"])
        if tl is None:
            return 404, {"error": "no trace for that request id "
                                  "(evicted or never recorded)"}
        if req.q("format") == "chrome":
            from llmq_tpu_torch.utils.profiling import trace_dir
            spans = None
            prof = getattr(self.engine, "_prof", None)
            if prof is not None:
                spans = prof.snapshot()
            return 200, observability.chrome_trace(
                [tl], spans=spans, jax_trace_dir=trace_dir())
        out = tl.to_dict()
        try:
            # The finished request's critical-path decomposition.
            if observability.cp_enabled():
                d = observability.decompose(tl)
                if d is not None:
                    d["segments"] = {k: round(v, 6)
                                     for k, v in d["segments"].items()}
                    out["critical_path"] = d
        except Exception:  # noqa: BLE001 — trace must not fail on cp plane
            log.exception("critical-path decomposition failed")
        return 200, out

    def get_flight_recorder(self, req: _Request) -> Tuple[int, Any]:
        """Flight-recorder state: ring stats, the most recent request
        timelines, and the slow/failed retention buffer."""
        rec = observability.get_recorder()
        try:
            limit = int(req.q("limit", "50"))
        except ValueError:
            raise ApiError(400, "limit must be an integer") from None
        return 200, {
            **rec.get_stats(),
            "recent": [t.summary() for t in rec.recent(limit)],
            "slow": [t.summary() for t in rec.slow()],
        }

    def start_profile(self, req: _Request) -> Tuple[int, Any]:
        """A bounded on-demand ``torch.profiler`` capture on a background
        thread (the card's activity too when the process serves on
        ``cuda``; the engine is paused between two steps while the
        profiler starts and stops); answers 202 with the trace path at
        once. Single flight: a concurrent capture answers 409. The output directory
        is the server's (LLMQ_TRACE_DIR, else a fresh temporary one),
        never the request's."""
        device = observability.device
        data = req.json() if req._body else {}   # noqa: SLF001 — same module
        try:
            duration_s = float(data.get("duration_ms", 1000.0)) / 1e3
        except (TypeError, ValueError):
            raise ApiError(400, "duration_ms must be a number") from None
        label = re.sub(r"[^\w.-]", "_",
                       str(data.get("label") or "ondemand"))[:64]
        try:
            info = device.start_profile(
                duration_s=duration_s, label=label,
                base_dir=os.environ.get("LLMQ_TRACE_DIR") or None,
                cuda=self.config.device.startswith("cuda"),
                quiesce=getattr(self.engine, "paused", None))
        except device.ProfileInProgress as e:
            raise ApiError(409, str(e)) from None
        return 202, info

    def get_profile_status(self, req: _Request) -> Tuple[int, Any]:
        return 200, observability.device.profile_status()

    # -- admin ---------------------------------------------------------------

    def add_priority_rule(self, req: _Request) -> Tuple[int, Any]:
        pre = self._require_preprocessor()
        data = req.json()
        pattern = data.get("pattern")
        if not pattern:
            raise ApiError(400, "pattern is required")
        try:
            priority = Priority.parse(data.get("priority", "normal"))
        except (ValueError, TypeError):
            raise ApiError(400, f"invalid priority {data.get('priority')!r}") \
                from None
        try:
            rule = pre.add_rule(pattern, priority, name=data.get("name", ""))
        except re.error as e:
            raise ApiError(400, f"invalid pattern: {e}") from None
        return 201, {"status": "rule added", "rule": rule.to_dict()}

    def list_priority_rules(self, req: _Request) -> Tuple[int, Any]:
        pre = self._require_preprocessor()
        return 200, {"rules": [r.to_dict() for r in pre.list_rules()]}

    def set_user_priority(self, req: _Request) -> Tuple[int, Any]:
        pre = self._require_preprocessor()
        data = req.json()
        user_id = data.get("user_id")
        prio_raw = data.get("priority")
        if not user_id or prio_raw is None:
            raise ApiError(400, "user_id and priority are required")
        try:
            priority = Priority.parse(prio_raw)
        except (ValueError, TypeError):
            raise ApiError(400, f"invalid priority {prio_raw!r}") from None
        pre.set_user_priority(user_id, priority)
        return 200, {"status": "user priority set"}

    def remove_message(self, req: _Request) -> Tuple[int, Any]:
        mgr = self._manager(req.params["queue_type"])
        msg = mgr.remove_message(req.params["id"])
        if msg is None:
            return 404, {"error": "no pending message with that id"}
        return 200, {"status": "removed", "message_id": msg.id}

    def _dead_letters(self, req: _Request):
        if self.factory is None:
            raise ApiError(503, "queue factory not configured")
        name = req.q("manager", self.manager_name)
        dlq = self.factory.get_dead_letter_queue(name)
        if dlq is None:
            raise ApiError(404, f"no dead-letter queue for manager {name!r}")
        return dlq, self._manager(name)

    def requeue_dead_letter_message(self, req: _Request) -> Tuple[int, Any]:
        dlq, mgr = self._dead_letters(req)
        try:
            msg = dlq.requeue(req.params["id"], mgr)
        except KeyError:
            return 404, {"error": "message not in dead-letter queue"}
        return 200, {"status": "requeued", "message_id": msg.id}

    def requeue_all_dead_letter_messages(self, req: _Request
                                         ) -> Tuple[int, Any]:
        dlq, mgr = self._dead_letters(req)
        return 200, {"status": "requeued",
                     "count": len(dlq.batch_requeue(mgr))}

    # -- HTTP plumbing -------------------------------------------------------

    def _make_handler(self):
        server = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _respond(self) -> None:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                status, payload, ctype = server.dispatch(
                    self.command, self.path, body,
                    dict(self.headers.items()))
                if isinstance(payload, _SSEStream):
                    self._stream(status, payload, ctype)
                    return
                data = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                if isinstance(payload, dict) and "retry_after" in payload:
                    # Whole seconds, rounded up.
                    self.send_header("Retry-After", str(max(1, math.ceil(
                        float(payload["retry_after"])))))
                self.end_headers()
                self.wfile.write(data)

            def _stream(self, status: int, payload: _SSEStream,
                        ctype: str) -> None:
                # Chunks flushed per event; the closed connection ends
                # the body. The header writes sit inside the try, so a
                # client gone before them still reaches the cleanup.
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    for hk, hv in payload.headers.items():
                        self.send_header(hk, hv)
                    self.end_headers()
                    for event in payload:
                        self.wfile.write(event.encode("utf-8"))
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass   # client hung up
                finally:
                    # Closing the generator raises GeneratorExit in it,
                    # which cancels its engine request; on_close covers
                    # a generator that never started.
                    close = getattr(payload.events, "close", None)
                    if close is not None:
                        close()
                    if payload.on_close is not None:
                        payload.on_close()
                self.close_connection = True

            do_GET = do_POST = do_PUT = do_DELETE = _respond  # noqa: N815

            def log_message(self, fmt: str, *args) -> None:
                log.debug("%s %s", self.address_string(), fmt % args)

        return _Handler

    def start(self, host: Optional[str] = None,
              port: Optional[int] = None) -> int:
        """Serve on a background thread; returns the bound port (port 0
        picks a free one)."""
        host = self.config.server.host if host is None else host
        port = self.config.server.port if port is None else port
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="api-server", daemon=True)
        self._thread.start()
        bound = self._httpd.server_address[1]
        log.info("API server listening on %s:%d", host, bound)
        return bound

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
