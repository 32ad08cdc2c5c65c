"""Engine crash supervisor (the port's copy of
``llmq_tpu/engine/supervisor.py``).

The engine loop catches ``Exception`` per step, but a BaseException (or
a bug in the except path itself) kills the thread. ``serve`` runs a
supervisor that:

1. **detects** the dead loop thread within ``check_interval`` seconds;
2. **recovers** in-flight work: ``engine.recover_after_crash()`` fails
   every unfinished handle, which unblocks the worker threads parked in
   ``process_fn``: they raise and the worker retry path requeues the
   messages through the delayed queue (at-least-once, the dead-letter
   queue as backstop). Handles that finished before the crash are left
   alone, so completed work is never requeued;
3. **restarts** the loop (``engine.start()``, a fresh thread over the
   reset state; on the card the executor's captured CUDA graphs are
   replayed as before, not captured again).

A crash loop is bounded: more than ``max_restarts`` restarts inside a
sliding ``restart_window`` stops the restarts; the engine stays down and
``/health`` reports it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from llmq_tpu_torch.metrics.registry import get_metrics

log = logging.getLogger("llmq_tpu_torch.supervisor")


class EngineSupervisor:
    def __init__(self, engine, *, config=None,
                 enable_metrics: bool = True) -> None:
        #: A SupervisorConfig, or anything with its fields.
        self.engine = engine
        self._metrics = get_metrics() if enable_metrics else None
        self.check_interval = float(getattr(config, "check_interval", 0.5))
        self.max_restarts = int(getattr(config, "max_restarts", 5))
        self.restart_window = float(getattr(config, "restart_window", 60.0))
        self.restarts = 0
        self.recovered_total = 0
        #: True once the crash-loop bound tripped: no further restarts.
        self.gave_up = False
        self._restart_times: List[float] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"supervisor-{self.engine.name}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """MUST run before the engine's own stop in a shutdown cascade:
        a supervisor that outlives it would 'recover' the deliberate
        stop as a crash."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- the watch -----------------------------------------------------------

    def _loop(self) -> None:
        # The engine was alive when the supervisor started; only a
        # transition alive → dead is a crash (an engine that was never
        # started is an operator choice, not a failure).
        while not self._stop.wait(self.check_interval):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the supervisor itself
                log.exception("supervisor check failed")  # must survive

    def check_once(self) -> bool:
        """One detection pass; returns True when a restart was
        performed. Callable directly from tests (no loop needed)."""
        eng = self.engine
        thread = getattr(eng, "_thread", None)
        if eng.running or thread is None or self._stop.is_set():
            return False                  # alive, or never started
        eng_stop = getattr(eng, "_stop", None)
        if eng_stop is not None and eng_stop.is_set():
            # engine.stop() in progress (its stop flag is set before
            # the join): a deliberate stop, not a crash — restarting
            # here would resurrect an engine the owner is tearing down
            # and orphan a live loop thread.
            return False
        if self.gave_up:
            return False
        now = time.monotonic()
        self._restart_times = [t for t in self._restart_times
                               if now - t < self.restart_window]
        if len(self._restart_times) >= self.max_restarts:
            self.gave_up = True
            log.error(
                "engine %s crash-looping (%d restarts in %.0fs): giving "
                "up — the engine stays down",
                eng.name, len(self._restart_times), self.restart_window)
            # The FINAL crash's in-flight work is still recovered —
            # without this, its handles never finish and every parked
            # worker waits out its full deadline (the exact failure
            # mode this module exists to remove). No restart follows.
            self._recover(eng)
            return False
        log.warning("engine %s thread is DEAD; recovering + restarting",
                    eng.name)
        counts = self._recover(eng)
        eng.start()
        self._restart_times.append(now)
        self.restarts += 1
        if self._metrics is not None:
            self._metrics.engine_restarts.labels(eng.name).inc()
        log.warning("engine %s restarted (restart #%d; %d in-flight "
                    "requeued, %d deduped-as-done)", eng.name,
                    self.restarts, counts.get("recovered", 0),
                    counts.get("already_done", 0))
        return True

    def _recover(self, eng) -> Dict:
        """One crash recovery (shared by the restart and give-up
        paths): fail the in-flight handles over to the worker retry
        path and account the counts."""
        counts = {"recovered": 0, "already_done": 0}
        try:
            counts = eng.recover_after_crash()
        except Exception:  # noqa: BLE001 — a failed recovery must not
            # kill the supervisor; proceed (the worker deadline path
            # remains the backstop for anything un-recovered).
            log.exception("crash recovery failed for engine %s", eng.name)
        rec = int(counts.get("recovered", 0))
        self.recovered_total += rec
        if self._metrics is not None and rec:
            self._metrics.engine_recovered_requests.labels(eng.name).inc(rec)
        return counts

    def get_stats(self) -> Dict:
        return {
            "restarts": self.restarts,
            "recovered_requests": self.recovered_total,
            "gave_up": self.gave_up,
            "running": self.running,
        }
