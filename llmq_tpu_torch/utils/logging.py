"""Structured logging (the port's copy of ``llmq_tpu/utils/logging.py``).

One configuration serves every component: JSON or console lines, per
``LoggingConfig``. Layers that handle one request bind ``request_id`` /
``conversation_id`` / ``endpoint`` into a context variable
(:func:`bind_log_context`); both formatters merge the bound fields into
every record emitted while the binding is live, so a line from deep in
the engine carries the request's identity without every call site
passing it on. Per-record ``extra={"fields": {...}}`` wins over the
bound fields on a key collision.

Importing this module configures nothing: the entry points call
:func:`configure_logging`.
"""

from __future__ import annotations

import contextvars
import json
import logging
import sys
import time
from typing import Any, Dict, Optional

#: The port's loggers are ``llmq_tpu_torch.*``; the handler sits here.
ROOT = "llmq_tpu_torch"

#: Fields bound for the current logical request (the dict is replaced,
#: never mutated: a token restores the previous binding exactly).
_LOG_CTX: contextvars.ContextVar[Dict[str, Any]] = contextvars.ContextVar(
    "llmq_tpu_torch_log_ctx", default={})


def bind_log_context(**fields: Any) -> contextvars.Token:
    """Bind request-scoped fields (empty values skipped) on top of the
    current binding. Returns a token for :func:`reset_log_context`."""
    merged = dict(_LOG_CTX.get())
    merged.update({k: v for k, v in fields.items() if v})
    return _LOG_CTX.set(merged)


def reset_log_context(token: Optional[contextvars.Token] = None) -> None:
    if token is not None:
        _LOG_CTX.reset(token)
    else:
        _LOG_CTX.set({})


def current_log_context() -> Dict[str, Any]:
    return dict(_LOG_CTX.get())


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        out.update(_LOG_CTX.get())
        out.update(getattr(record, "fields", None) or {})
        return json.dumps(out, default=str)


class ConsoleFormatter(logging.Formatter):
    """Human lines with the bound and per-record fields appended as
    ``k=v``."""

    def __init__(self) -> None:
        super().__init__("%(asctime)s %(levelname)-5s %(name)s %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        fields = dict(_LOG_CTX.get())
        fields.update(getattr(record, "fields", None) or {})
        if fields:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            return f"{base} [{kv}]"
        return base


def configure_logging(level: str = "info", fmt: str = "json",
                      output: str = "stdout") -> None:
    """One handler on the package's root logger: ``fmt`` "json" or
    "console", ``output`` "stdout" or "stderr". Records still propagate
    to the handlers of the interpreter's root logger, if the embedding
    program set any."""
    root = logging.getLogger(ROOT)
    root.handlers.clear()
    stream = sys.stdout if output == "stdout" else sys.stderr
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonFormatter() if fmt == "json"
                         else ConsoleFormatter())
    root.addHandler(handler)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
