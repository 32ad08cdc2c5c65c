"""Cross-process queue transport: a shared-directory message spool (the
port's copy of ``llmq_tpu/queueing/spool.py``; the file names and
records are the same, so either package's gateway and queue-manager can
share one spool).

A split deployment runs the API edge (``gateway``) and the consumer
(``queue-manager``) as two processes. This spool carries messages between
them with at-least-once delivery and no other service:

- :class:`SpoolProducer` publishes a message file
  (``<priority>-<time>-<seq>-<id>.msg``, written to a temporary name,
  fsynced, renamed into place).
- :class:`SpoolConsumer` claims a file by renaming it to ``.claim`` (the
  rename is the mutual exclusion: one consumer wins), delivers it into
  its local queue manager, and acknowledges the processed message by
  writing it into ``done/``. Claims whose consumer died are returned to
  the spool after ``claim_ttl`` (at-least-once: a consumer must tolerate
  duplicates, the contract of the WAL and the retry path too). A file
  that does not parse is parked as ``.poison``.
- :class:`SpoolCollector` is the producer's return path: it applies the
  ``done/`` records (the gateway updates its store, so a client polling
  ``GET /messages/:id`` sees the result).

The names sort by (priority, publish time), so a consumer scanning in
name order keeps the priority order across processes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, List, Optional

from llmq_tpu_torch.core.types import Message

log = logging.getLogger("llmq_tpu_torch.spool")

_DONE_DIR = "done"


class SpoolProducer:
    def __init__(self, spool_dir: str) -> None:
        self.dir = spool_dir
        os.makedirs(spool_dir, exist_ok=True)
        os.makedirs(os.path.join(spool_dir, _DONE_DIR), exist_ok=True)
        self._seq = 0
        self._mu = threading.Lock()

    def push(self, msg: Message, queue_name: Optional[str] = None) -> str:
        """Publish one message; returns the spool file name."""
        with self._mu:
            self._seq += 1
            seq = self._seq
        name = (f"{int(msg.priority)}-{time.time():017.6f}-{seq:06d}-"
                f"{msg.id}.msg")
        payload = json.dumps({"q": queue_name or "", "msg": msg.to_dict()},
                             default=str)
        tmp = os.path.join(self.dir, f".tmp-{os.getpid()}-{seq}")
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        dst = os.path.join(self.dir, name)
        os.rename(tmp, dst)        # atomic publish
        return name


class SpoolConsumer:
    """Claims spooled messages into a local delivery callback."""

    def __init__(self, spool_dir: str,
                 deliver: Callable[[Optional[str], Message], None],
                 *, consumer_id: Optional[str] = None,
                 claim_ttl: float = 120.0,
                 poll_interval: float = 0.2) -> None:
        self.dir = spool_dir
        os.makedirs(spool_dir, exist_ok=True)
        os.makedirs(os.path.join(spool_dir, _DONE_DIR), exist_ok=True)
        self.deliver = deliver
        self.cid = consumer_id or f"c{os.getpid()}"
        self.claim_ttl = claim_ttl
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> int:
        """One scan: reclaim stale claims, then claim + deliver every
        ready message (lexicographic order = priority, publish time).
        Returns the number delivered."""
        self._reclaim_stale()
        n = 0
        try:
            names = sorted(os.listdir(self.dir))
        except FileNotFoundError:
            return 0
        for name in names:
            if not name.endswith(".msg"):
                continue
            src = os.path.join(self.dir, name)
            claim = os.path.join(self.dir, f"{name}.{self.cid}.claim")
            try:
                os.rename(src, claim)   # exactly one consumer wins
            except OSError:
                continue                # someone else claimed it
            try:
                # rename preserves mtime — stamp the CLAIM time, or the
                # stale-claim TTL would measure publish age and every
                # backlogged message would be instantly "stale"
                # (guaranteed duplicate delivery across consumers).
                os.utime(claim)
            except OSError:
                pass
            try:
                with open(claim) as f:
                    rec = json.loads(f.read())
                msg = Message.from_dict(rec["msg"])
            except Exception:  # noqa: BLE001 — truly poison (unreadable
                # /unparseable): park it for inspection, don't wedge.
                log.exception("poison spool file %s", name)
                try:
                    os.rename(claim, os.path.join(
                        self.dir, f"{name}.poison"))
                except OSError:
                    pass
                continue
            try:
                self.deliver(rec.get("q") or None, msg)
            except Exception as e:  # noqa: BLE001 — TRANSIENT (queue
                # full / backpressure): return the message to the spool
                # for a later scan; parking it would turn backpressure
                # into permanent loss.
                log.warning("spool delivery of %s failed (will retry): "
                            "%r", name, e)
                try:
                    os.rename(claim, src)
                except OSError:
                    pass
                continue
            try:
                os.unlink(claim)
            except OSError:
                pass
            n += 1
        return n

    def ack_done(self, msg: Message) -> None:
        """Publish the processed message (response/status included) into
        done/ for the producer-side collector."""
        done = os.path.join(self.dir, _DONE_DIR, f"{msg.id}.json")
        tmp = done + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(msg.to_dict(), default=str))
            f.flush()
            # The spool is the durability boundary on BOTH legs: after
            # processing, the consumer's WAL won't redeliver — losing
            # this record to a crash would wedge the gateway's message
            # in PROCESSING forever.
            os.fsync(f.fileno())
        os.rename(tmp, done)

    def _reclaim_stale(self) -> None:
        now = time.time()
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return
        for name in names:
            if not name.endswith(".claim"):
                continue
            path = os.path.join(self.dir, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age < self.claim_ttl:
                continue
            # Claim owner died mid-delivery: return to the spool
            # (at-least-once — the message may be processed twice).
            orig = name.split(".msg.")[0] + ".msg"
            try:
                os.rename(path, os.path.join(self.dir, orig))
                log.warning("reclaimed stale spool claim %s", name)
            except OSError:
                pass

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="spool-consumer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                log.exception("spool consumer scan failed")


class SpoolCollector:
    """Producer-side return path: surfaces processed messages from
    done/ to a callback (gateway store/queue-stats update)."""

    def __init__(self, spool_dir: str,
                 on_done: Callable[[Message], None],
                 poll_interval: float = 0.2) -> None:
        self.done_dir = os.path.join(spool_dir, _DONE_DIR)
        os.makedirs(self.done_dir, exist_ok=True)
        self.on_done = on_done
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> int:
        n = 0
        try:
            names = sorted(os.listdir(self.done_dir))
        except FileNotFoundError:
            return 0
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.done_dir, name)
            try:
                with open(path) as f:
                    msg = Message.from_dict(json.loads(f.read()))
            except Exception:  # noqa: BLE001
                log.exception("bad done record %s", name)
                try:
                    os.rename(path, path + ".poison")
                except OSError:
                    pass
                continue
            try:
                self.on_done(msg)
            except Exception:  # noqa: BLE001 — keep the record: the
                # transport is at-least-once everywhere else; deleting
                # a completion the callback failed to apply would make
                # the return path at-most-once (client polls forever).
                log.exception("done callback failed for %s; will retry",
                              name)
                continue
            try:
                os.unlink(path)
            except OSError:
                pass
            n += 1
        return n

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="spool-collector", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                log.exception("spool collector scan failed")


def pending_files(spool_dir: str) -> List[str]:
    """Unclaimed message files (diagnostics)."""
    try:
        return sorted(n for n in os.listdir(spool_dir)
                      if n.endswith(".msg"))
    except FileNotFoundError:
        return []
