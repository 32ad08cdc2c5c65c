"""Write-ahead log of a queue manager (the port's copy of
``llmq_tpu/queueing/wal.py``; the record format is the same, so a journal
written by either package replays to the same live set in the other).

Every queue mutation appends one JSON line; at startup :meth:`QueueWAL.replay`
rebuilds the live set: pending messages re-enter their queues in arrival
order (``Message.created_at`` rides along, so priority and FIFO survive),
and popped-but-unfinished messages are redelivered (at-least-once, the
contract the worker's retry path already assumes).

Ops: ``push`` (carries the whole message), ``pop``, ``complete``, ``fail``,
``remove`` (terminal), ``requeue`` / ``stash`` (the message returns to the
live set; ``stash`` marks a retry parked in the delayed queue, which a
replay redelivers at once: a retry made earlier, never lost).

Durability: the file is flushed on every append and fsynced every
``fsync_every`` appends (64) and on close. A crash loses at most the last
fsync window and never corrupts the journal (a torn trailing line is
skipped). Compaction rewrites the file as the live set once dead records
outnumber live ones by ``compact_ratio``; the slow part runs outside the
manager's lock (``begin_compact`` / ``write_compact_tmp`` /
``finish_compact``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

from llmq_tpu_torch import chaos
from llmq_tpu_torch.core.types import Message

log = logging.getLogger("llmq_tpu_torch.wal")


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``: a rename is durable only
    once its directory entry is, so without this a crash right after
    compaction's ``os.replace`` can lose the compacted journal. Skipped
    where a directory cannot be opened."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


_TERMINAL = ("complete", "fail", "remove")
_LIVE_PENDING = "pending"
_LIVE_INFLIGHT = "inflight"


def _push_line(qname: str, msg: Message) -> str:
    """The one serialization of a live message as a push record, shared
    by append, rewrite and compaction."""
    return json.dumps({"op": "push", "q": qname, "id": msg.id,
                       "msg": msg.to_dict()}, default=str)


class QueueWAL:
    """Append-only journal of one queue manager's mutations."""

    def __init__(self, path: str, *, fsync_every: int = 64,
                 compact_ratio: float = 4.0) -> None:
        self.path = path
        self.fsync_every = max(1, fsync_every)
        self.compact_ratio = compact_ratio
        self._mu = threading.Lock()
        self._since_sync = 0
        self._records = 0
        self._live = 0
        # While a compaction writes its tmp file outside the manager's
        # lock, appends keep going to the current journal (crash-safe at
        # every point) and are also buffered here, to be copied into the
        # tmp file before the swap.
        self._compact_buf: Optional[List[str]] = None
        self._compact_tmp = None  # the tmp journal's open file
        self._closed = False
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    # -- writing -------------------------------------------------------------

    def append(self, op: str, queue: str, message_id: str,
               message: Optional[Message] = None) -> None:
        # Chaos point: an injected fault (a full disk) reaches the caller
        # before the queue changes, so nothing is half recorded.
        chaos.fault("wal.append", op=op, queue=queue)
        if op == "push" and message is not None:
            line = _push_line(queue, message)
        else:
            rec: Dict = {"op": op, "q": queue, "id": message_id}
            if message is not None:
                rec["msg"] = message.to_dict()
            line = json.dumps(rec, default=str)
        with self._mu:
            self._f.write(line + "\n")
            self._f.flush()
            if self._compact_buf is not None:
                self._compact_buf.append(line)
            self._since_sync += 1
            self._records += 1
            if op == "push":
                self._live += 1
            elif op in _TERMINAL:
                self._live = max(0, self._live - 1)
            if self._since_sync >= self.fsync_every:
                # A failing fsync (the chaos point too) propagates; the
                # record is already written and flushed, so a replay
                # still sees it.
                chaos.fault("wal.fsync")
                os.fsync(self._f.fileno())
                self._since_sync = 0

    def needs_compact(self) -> bool:
        """Do dead records dominate enough for a compaction pass? A
        counter check, so a monitor tick pays for no snapshot."""
        with self._mu:
            return self._records >= 1024 and (
                self._records > self.compact_ratio * max(1, self._live))

    # -- concurrent compaction -------------------------------------------------
    #
    # The caller holds its data-path lock only for begin and finish:
    #
    #   with lock:  live = snapshot(); wal.begin_compact()
    #   wal.write_compact_tmp(live)      # slow, no lock; appends go to
    #                                    # the old journal AND a buffer
    #   with lock:  wal.finish_compact(n, commit=ok)
    #                                    # buffer → tmp, fsync, swap
    #
    # A crash at any point is safe: the old journal only grows until the
    # os.replace, so a replay sees the whole history.

    def begin_compact(self) -> bool:
        """Start buffering appends for a compaction; False if one is
        already in flight."""
        with self._mu:
            if self._compact_buf is not None:
                return False
            self._compact_buf = []
            return True

    def write_compact_tmp(self, live: List[Tuple[str, Message]]) -> int:
        """Write the live set to the tmp journal (no lock held). Returns
        the records written."""
        f = open(self.path + ".tmp", "w", encoding="utf-8")
        # Registered before writing, so an aborted finish closes and
        # removes a file whose write failed half way (ENOSPC).
        self._compact_tmp = f
        for qname, msg in live:
            f.write(_push_line(qname, msg) + "\n")
        return len(live)

    def finish_compact(self, n_live: int, commit: bool = True) -> None:
        """Copy the records buffered meanwhile into the tmp file, fsync,
        and swap it in (the caller holds its lock, so no append races
        the swap). With ``commit=False`` the tmp file is dropped and
        journaling goes on as before."""
        with self._mu:
            buf, self._compact_buf = self._compact_buf, None
            f, self._compact_tmp = self._compact_tmp, None
            # A journal closed meanwhile (the manager stopped during a
            # slow serialization) is neither swapped nor reopened: the
            # old journal holds the whole history.
            if not commit or f is None or self._closed:
                if f is not None:
                    f.close()
                    try:
                        os.remove(f.name)
                    except OSError:
                        pass
                return
            for line in buf:
                f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
            f.close()
            self._f.close()
            os.replace(f.name, self.path)
            _fsync_dir(self.path)
            self._f = open(self.path, "a", encoding="utf-8")
            self._records = n_live + len(buf)
            self._live = min(self._live, self._records)
            self._since_sync = 0
        log.info("wal compacted to %d live (+%d concurrent) records (%s)",
                 n_live, len(buf), self.path)

    def rewrite(self, live: List[Tuple[str, Message]]) -> None:
        """Replace the journal with push records of ``live``, atomically.
        The synchronous form (the restore at startup, tests); refused
        while a concurrent compaction is in flight, whose finish would
        overwrite it with an older snapshot."""
        tmp = self.path + ".tmp"
        with self._mu:
            if self._compact_buf is not None:
                raise RuntimeError(
                    "rewrite() during an in-flight concurrent compaction")
            with open(tmp, "w", encoding="utf-8") as f:
                for qname, msg in live:
                    f.write(_push_line(qname, msg) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            _fsync_dir(self.path)
            self._f = open(self.path, "a", encoding="utf-8")
            self._records = len(live)
            self._live = len(live)
            self._since_sync = 0
        log.info("wal compacted to %d live records (%s)", len(live),
                 self.path)

    def close(self) -> None:
        with self._mu:
            self._closed = True
            # Abort a compaction still in flight (a monitor thread that
            # outlived the stop's join): drop its buffer and tmp file.
            self._compact_buf = None
            f, self._compact_tmp = self._compact_tmp, None
            if f is not None:
                try:
                    f.close()
                    os.remove(f.name)
                except OSError:
                    pass
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()

    # -- replay --------------------------------------------------------------

    @staticmethod
    def replay(path: str) -> List[Tuple[str, Message]]:
        """The live set of a journal: (queue, message) pairs in arrival
        order, pending and popped-but-unfinished alike. Unreadable lines
        (a torn tail) are skipped."""
        if not os.path.exists(path):
            return []
        state: Dict[str, Tuple[str, Dict, str]] = {}  # id → (q, msg, liveness)
        order: List[str] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    log.warning("wal: skipping corrupt record in %s", path)
                    continue
                op = rec.get("op")
                mid = rec.get("id")
                if op == "push":
                    if mid not in state:
                        order.append(mid)
                    state[mid] = (rec["q"], rec["msg"], _LIVE_PENDING)
                elif mid in state:
                    # Each op names the queue it acted on: a requeue into
                    # another queue restores there.
                    q, msg, _ = state[mid]
                    q = rec.get("q") or q
                    if op == "pop":
                        state[mid] = (q, msg, _LIVE_INFLIGHT)
                    elif op in _TERMINAL:
                        del state[mid]
                    elif op in ("requeue", "stash"):
                        state[mid] = (q, msg, _LIVE_PENDING)
        out: List[Tuple[str, Message]] = []
        for mid in order:
            if mid in state:
                q, msg_dict, _ = state[mid]
                try:
                    out.append((q, Message.from_dict(msg_dict)))
                except (KeyError, TypeError, ValueError) as e:
                    log.warning("wal: dropping unreadable message %s: %s",
                                mid, e)
        return out
