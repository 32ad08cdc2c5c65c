"""REST API on the standard library's ``http.server`` (counterpart of
``llmq_tpu/api/server.py``, trimmed to the serving main path):

- ``GET  /health``
- ``POST /api/v1/messages``      → 202 ``{"message_id", "priority", ...}``
- ``GET  /api/v1/messages/:id``  → the message, with ``response`` and
  ``metadata.usage`` once its status is ``completed``

Submitted messages go to the queue manager's tier queues; workers
drain them into the engine. A bounded in-memory store keeps every
submitted message for the query route: the queue plane mutates the
same ``Message`` objects, so status and response show up there.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from llmq_tpu_torch import __version__
from llmq_tpu_torch.core.types import (Message, MessageStatus,
                                       QueueFullError, QueueNotFoundError,
                                       new_id)

log = logging.getLogger("llmq_tpu_torch.api")

_TERMINAL = (MessageStatus.COMPLETED, MessageStatus.FAILED,
             MessageStatus.TIMEOUT)


class MessageStore:
    """Bounded registry of submitted messages; when full, the oldest
    terminal message is evicted first."""

    def __init__(self, max_messages: int = 10_000) -> None:
        self.max_messages = max_messages
        self._messages: "OrderedDict[str, Message]" = OrderedDict()
        self._mu = threading.Lock()

    def record(self, message: Message) -> None:
        with self._mu:
            self._messages[message.id] = message
            self._messages.move_to_end(message.id)
            if len(self._messages) > self.max_messages:
                victim = next((mid for mid, m in self._messages.items()
                               if m.status in _TERMINAL),
                              next(iter(self._messages)))
                del self._messages[victim]

    def get(self, message_id: str) -> Optional[Message]:
        with self._mu:
            return self._messages.get(message_id)


class ApiError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


class ApiServer:
    def __init__(self, manager, engine=None,
                 store: Optional[MessageStore] = None) -> None:
        self.manager = manager
        self.engine = engine
        self.store = store or MessageStore()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._routes = []
        self._route("GET", "/health", self.health_check)
        self._route("POST", "/api/v1/messages", self.submit_message)
        self._route("GET", "/api/v1/messages/:id", self.get_message)

    def _route(self, method: str, pattern: str, handler) -> None:
        rx = re.sub(r":(\w+)", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method, re.compile(f"^{rx}$"), handler))

    def dispatch(self, method: str, path: str,
                 body: bytes) -> Tuple[int, Dict[str, Any]]:
        """Route one request; returns (status, JSON payload)."""
        path = path.split("?", 1)[0].rstrip("/") or "/"
        matched_path = False
        for m, rx, handler in self._routes:
            match = rx.match(path)
            if not match:
                continue
            matched_path = True
            if m != method:
                continue
            try:
                return handler(match.groupdict(), body)
            except ApiError as e:
                return e.status, {"error": e.message}
            except QueueNotFoundError as e:
                return 404, {"error": str(e)}
            except QueueFullError as e:
                return 503, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 — one bad request must not kill the server
                log.exception("handler error on %s %s", method, path)
                return 500, {"error": f"internal error: {e}"}
        if matched_path:
            return 405, {"error": "method not allowed"}
        return 404, {"error": "not found"}

    # -- handlers ------------------------------------------------------------

    def health_check(self, params, body) -> Tuple[int, Dict[str, Any]]:
        out: Dict[str, Any] = {"status": "ok", "version": __version__,
                               "time": time.time()}
        if self.engine is not None:
            out["engine"] = "running" if self.engine.running else "stopped"
        return 200, out

    def submit_message(self, params, body) -> Tuple[int, Dict[str, Any]]:
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            raise ApiError(400, "body must be JSON") from None
        if not isinstance(data, dict):
            raise ApiError(400, "body must be a JSON object")
        if not isinstance(data.get("content", ""), str):
            raise ApiError(400, "content must be a string")
        if not isinstance(data.get("metadata", {}), dict):
            raise ApiError(400, "metadata must be an object")
        try:
            msg = Message.from_dict(data)
        except (ValueError, TypeError) as e:
            raise ApiError(400, f"invalid message: {e}") from None
        if not msg.id:
            msg.id = new_id()
        now = time.time()
        msg.created_at = now
        msg.updated_at = now
        self.store.record(msg)
        self.manager.push_message(msg)
        return 202, {"message_id": msg.id, "priority": int(msg.priority),
                     "queue_time": now}

    def get_message(self, params, body) -> Tuple[int, Dict[str, Any]]:
        msg = self.store.get(params["id"])
        if msg is None:
            return 404, {"error": "message not found"}
        return 200, msg.to_dict()

    # -- HTTP plumbing -------------------------------------------------------

    def _make_handler(self):
        server = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _respond(self) -> None:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                status, payload = server.dispatch(self.command, self.path,
                                                  body)
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = _respond  # noqa: N815

            def log_message(self, fmt: str, *args) -> None:
                log.debug("%s %s", self.address_string(), fmt % args)

        return _Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a background thread; returns the bound port (port 0
        picks a free one)."""
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
