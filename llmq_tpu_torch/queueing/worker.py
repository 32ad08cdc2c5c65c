"""Batch consumer workers (the port's copy of
``llmq_tpu/queueing/worker.py``).

- every ``process_interval`` a worker pops up to ``max_batch_size``
  messages in strict priority order and runs each on a pool of
  ``max_concurrent`` threads, calling ``process_fn(ctx, message)``
- the :class:`ProcessContext` carries the message's deadline; a process
  function that wants the timeout/retry path must raise, and a normal
  return always completes the message (an overrun is still counted in
  ``stats.timeouts``)
- a failure is retried after a backoff (``ExponentialBackoff`` or
  ``FixedBackoff``) scheduled through the :class:`DelayedQueue`, until
  the message's ``max_retries``; then it fails and goes to the
  :class:`DeadLetterQueue`
- a watchdog abandons calls still running at ``hard_deadline_grace`` ×
  their deadline: the slot is freed and the message takes the
  timeout/retry path (the call itself cannot be killed)
- ``on_permanent_failure`` is called once for every message that fails
  for good
"""

from __future__ import annotations

import itertools
import logging
import queue as _queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from llmq_tpu_torch.core.clock import SYSTEM_CLOCK, Clock
from llmq_tpu_torch.core.config import RetryConfig, WorkerConfig
from llmq_tpu_torch.core.types import Message, MessageStatus
from llmq_tpu_torch.queueing.dead_letter_queue import DeadLetterQueue
from llmq_tpu_torch.queueing.delayed_queue import DelayedQueue
from llmq_tpu_torch.queueing.queue_manager import QueueManager
from llmq_tpu_torch.utils.logging import bind_log_context, reset_log_context

log = logging.getLogger("llmq_tpu_torch.worker")


class ProcessContext:
    """Cooperative cancellation + deadline for one message."""

    def __init__(self, deadline: Optional[float], clock: Clock) -> None:
        self.deadline = deadline
        self._clock = clock
        self._cancelled = threading.Event()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - self._clock.now()

    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0


ProcessFn = Callable[[ProcessContext, Message], None]


class _Inflight:
    """One dispatched message, shared between the processing thread and
    the watchdog. ``claim()`` arbitrates who owns the outcome: the
    processing thread claims on return, the watchdog claims at the hard
    deadline — exactly one side wins and handles completion/failure and
    the semaphore slot."""

    __slots__ = ("msg", "ctx", "start", "deadline", "pool", "_claimed",
                 "_mu")

    def __init__(self, msg: Message, ctx: ProcessContext, start: float,
                 deadline: float,
                 pool: Optional["_DispatchPool"] = None) -> None:
        self.msg = msg
        self.ctx = ctx
        self.start = start
        self.deadline = deadline
        #: The pool that dispatched this call — grow/shrink must target
        #: IT, not whatever pool the worker holds later (a stop()/start()
        #: cycle swaps pools; shrinking the fresh one would leave it a
        #: thread short of the semaphore forever).
        self.pool = pool
        self._claimed = False
        self._mu = threading.Lock()

    def claim(self) -> bool:
        with self._mu:
            if self._claimed:
                return False
            self._claimed = True
            return True


class _DispatchPool:
    """Daemon-thread pool whose REAL capacity tracks the concurrency
    semaphore. A watchdog abandonment frees a semaphore slot but the
    wedged call still occupies its pool thread; without compensation the
    dispatch loop would keep pulling messages that just queue inside the
    pool — drained from the shared queue, trapped locally with no
    deadline (their clock only starts when the thread picks them up),
    invisible to the retry machinery. ``grow()`` spawns a replacement
    thread per abandonment; ``shrink()`` retires one thread when the
    wedged call finally returns, so capacity converges back."""

    def __init__(self, capacity: int, name: str) -> None:
        self._q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._mu = threading.Lock()
        self._name = name
        self._cap = capacity          # target live-thread count
        self._seq = 0
        self._shrink = 0
        self._live: set = set()       # threads not yet exited
        self._shut = False

    def _spawn_locked(self) -> None:
        self._seq += 1
        t = threading.Thread(target=self._run,
                             name=f"{self._name}-{self._seq}",
                             daemon=True)
        self._live.add(t)
        t.start()

    def _run(self) -> None:
        me = threading.current_thread()
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                fn, args = item
                try:
                    fn(*args)
                except Exception:  # noqa: BLE001 — a task failure must
                    # never kill the pool thread (completion plumbing
                    # bugs would otherwise silently strand messages).
                    log.exception("dispatch task failed in pool %s",
                                  self._name)
                with self._mu:
                    if self._shrink > 0:
                        # A replacement was spawned for an abandonment
                        # that has since returned: retire one thread
                        # (any thread — capacity is what matters).
                        self._shrink -= 1
                        return
        finally:
            with self._mu:
                self._live.discard(me)

    def submit(self, fn: Callable[..., None], *args: Any) -> None:
        with self._mu:
            if self._shut:
                raise RuntimeError("dispatch pool is shut down")
            # Enqueue under the lock: shutdown() also enqueues its exit
            # sentinels under it, so an item can never land BEHIND the
            # sentinels and be silently dropped.
            self._q.put((fn, args))
            if len(self._live) < self._cap:
                self._spawn_locked()   # lazy spawn, up to capacity

    def grow(self) -> None:
        """One thread is wedged on an abandoned call: add a replacement
        so live capacity stays at the semaphore's count."""
        with self._mu:
            if not self._shut:
                self._cap += 1
                self._spawn_locked()

    def shrink(self) -> None:
        """An abandoned call returned — its thread is usable again;
        retire one thread to undo the matching ``grow()``."""
        with self._mu:
            self._cap = max(1, self._cap - 1)
            self._shrink += 1

    def shutdown(self, wait: bool = True) -> None:
        import time as _time
        with self._mu:
            self._shut = True
            live = list(self._live)
            for _ in live:
                self._q.put(None)
        if wait:
            # One overall deadline — wedged threads never consume their
            # sentinel, and stop() must be bounded regardless of how
            # many are stuck. Real wall time on purpose: thread joins
            # block in the OS, so a FakeClock (which never advances on
            # its own) would turn this bound into a hang.
            deadline = _time.monotonic() + 5.0
            for t in live:
                t.join(timeout=max(0.0, deadline - _time.monotonic()))


class BackoffStrategy:
    """Delay before retry ``retry_count``."""

    def next_backoff(self, retry_count: int) -> float:  # pragma: no cover
        raise NotImplementedError


class ExponentialBackoff(BackoffStrategy):
    """initial · multiplier^(retry-1), capped."""

    def __init__(self, initial: float = 1.0, maximum: float = 60.0,
                 multiplier: float = 2.0) -> None:
        self.initial = initial
        self.maximum = maximum
        self.multiplier = multiplier

    def next_backoff(self, retry_count: int) -> float:
        d = self.initial * (self.multiplier ** max(0, retry_count - 1))
        return min(d, self.maximum)


class FixedBackoff(BackoffStrategy):
    """Constant delay."""

    def __init__(self, delay: float = 1.0) -> None:
        self.delay = delay

    def next_backoff(self, retry_count: int) -> float:
        return self.delay


@dataclass
class WorkerStats:
    """Per-worker counters."""

    processed: int = 0
    succeeded: int = 0
    failed: int = 0
    retried: int = 0
    dead_lettered: int = 0
    timeouts: int = 0
    total_process_time: float = 0.0
    _mu: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def to_dict(self) -> Dict[str, float]:
        with self._mu:
            return {
                "processed": self.processed,
                "succeeded": self.succeeded,
                "failed": self.failed,
                "retried": self.retried,
                "dead_lettered": self.dead_lettered,
                "timeouts": self.timeouts,
                "avg_process_time": (
                    self.total_process_time / self.processed if self.processed else 0.0),
            }


class Worker:
    def __init__(
        self,
        name: str,
        manager: QueueManager,
        process_fn: ProcessFn,
        worker_config: Optional[WorkerConfig] = None,
        retry_config: Optional[RetryConfig] = None,
        backoff: Optional[BackoffStrategy] = None,
        delayed_queue: Optional[DelayedQueue] = None,
        dead_letter_queue: Optional[DeadLetterQueue] = None,
        clock: Optional[Clock] = None,
        on_permanent_failure: Optional[
            Callable[[Message, str], None]] = None,
    ) -> None:
        self.name = name
        self.manager = manager
        self.process_fn = process_fn
        self.wconfig = worker_config or manager.config.queue.worker
        self.rconfig = retry_config or manager.config.queue.retry
        self._clock = clock or SYSTEM_CLOCK
        self.backoff = backoff or self._backoff_from_config()
        if delayed_queue is None:
            # A worker ALWAYS has a delayed queue so retry backoff is real
            # (without one, scheduled_at would be set but nothing would
            # honor it and retries would burn instantly). An owned queue is
            # started/stopped with the worker and additionally ticked from
            # process_batch so synchronous (loop-less) usage works too.
            delayed_queue = DelayedQueue(
                deliver=lambda qname, msg: manager.push_message(msg, qname or None),
                clock=clock or SYSTEM_CLOCK, name=f"{name}-retries")
            self._owned_delayed = True
        else:
            self._owned_delayed = False
        self.delayed_queue = delayed_queue
        self.dead_letter_queue = dead_letter_queue
        #: Called once per message that fails PERMANENTLY (retries
        #: exhausted), from whichever path killed it — synchronous
        #: error, timeout, or watchdog abandonment.
        self.on_permanent_failure = on_permanent_failure
        self.stats = WorkerStats()
        self._sem = threading.Semaphore(self.wconfig.max_concurrent)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[_DispatchPool] = None
        self._watchdog: Optional[threading.Thread] = None
        self._inflight: Dict[int, _Inflight] = {}
        self._inflight_mu = threading.Lock()
        self._inflight_seq = itertools.count()

    def _backoff_from_config(self) -> BackoffStrategy:
        r = self.rconfig
        if r.strategy == "fixed":
            return FixedBackoff(r.initial_backoff)
        return ExponentialBackoff(r.initial_backoff, r.max_backoff, r.backoff_multiplier)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        if self._owned_delayed:
            self.delayed_queue.start()
        self._pool = _DispatchPool(self.wconfig.max_concurrent,
                                   f"worker-{self.name}")
        self._thread = threading.Thread(
            target=self._process_loop, name=f"worker-loop-{self.name}", daemon=True)
        self._thread.start()
        if self.wconfig.hard_deadline:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop,
                name=f"worker-watchdog-{self.name}", daemon=True)
            self._watchdog.start()

    def stop(self, wait: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
            self._watchdog = None
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait)
        if self._owned_delayed:
            self.delayed_queue.stop()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- processing ----------------------------------------------------------

    def _process_loop(self) -> None:
        while not self._stop.wait(self.wconfig.process_interval):
            try:
                self.process_batch()
            except Exception:  # noqa: BLE001
                log.exception("worker %s batch failed", self.name)

    def process_batch(self) -> int:
        """Pop up to max_batch_size in priority order and dispatch.
        Returns the number of messages dispatched. Callable directly from
        tests (no loop needed)."""
        if self._owned_delayed and self._thread is None:
            # Synchronous mode: tick retry deliveries ourselves.
            self.delayed_queue.run_due_once()
        batch = self.manager.drain_in_priority_order(self.wconfig.max_batch_size)
        for msg in batch:
            self._sem.acquire()
            pool = self._pool
            if pool is not None:
                try:
                    pool.submit(self._run_one, msg)
                except RuntimeError:
                    # Pool shut down between the check and the submit (a
                    # stop() race): process inline so an already-popped
                    # message is never abandoned in PROCESSING.
                    self._run_one(msg)
            else:  # synchronous mode (tests, echo bench)
                self._run_one(msg)
        return len(batch)

    def process_one_sync(self, msg: Message) -> None:
        """Process a single already-popped message synchronously."""
        self._sem.acquire()
        self._run_one(msg)

    def _run_one(self, msg: Message) -> None:
        release = True
        # Log lines emitted while this message is processed, the
        # engine's included, carry the request's identity.
        token = bind_log_context(request_id=msg.id,
                                 conversation_id=msg.conversation_id)
        try:
            release = self._process_message(msg)
        finally:
            reset_log_context(token)
            if release:
                # False → the watchdog already freed this slot when it
                # abandoned the (then-wedged) call.
                self._sem.release()

    def _process_message(self, msg: Message) -> bool:
        """Process one message. Returns True if the caller must release
        the concurrency slot (False when the watchdog already did)."""
        start = self._clock.now()
        deadline = start + msg.timeout if msg.timeout and msg.timeout > 0 else None
        ctx = ProcessContext(deadline, self._clock)
        rec: Optional[_Inflight] = None
        token = -1
        if deadline is not None and self._watchdog is not None:
            # The watchdog fires at a GRACE multiple of the cooperative
            # deadline: a slow-but-finishing handler between 1× and
            # grace× completes normally (counted in stats.timeouts, work
            # kept); only calls still running at grace× are abandoned —
            # which risks duplicate side effects (see WorkerConfig).
            grace = max(1.0, self.wconfig.hard_deadline_grace)
            rec = _Inflight(msg, ctx, start, start + msg.timeout * grace,
                            pool=self._pool)
            token = next(self._inflight_seq)
            with self._inflight_mu:
                self._inflight[token] = rec
        err: Optional[BaseException] = None
        try:
            self.process_fn(ctx, msg)
        except BaseException as e:  # noqa: BLE001 — any failure, a
            # BaseException too, enters the retry path (the JAX package's
            # worker does the same): re-raising it would kill the pool
            # thread and leave the message to the watchdog.
            err = e
        if rec is not None:
            with self._inflight_mu:
                self._inflight.pop(token, None)
            if not rec.claim():
                # The watchdog declared this call wedged, failed the
                # message and freed the slot while we were still running.
                # The work's outcome is discarded: completing now could
                # double-deliver a message the retry path already
                # re-queued.
                log.warning(
                    "message %s returned %.3fs after its watchdog "
                    "abandonment; result dropped",
                    msg.id, self._clock.now() - rec.deadline)
                if rec.pool is not None:
                    # This thread was written off when the call was
                    # abandoned (a replacement was spawned); retire one
                    # thread so pool capacity matches the semaphore again.
                    rec.pool.shrink()
                return False
        elapsed = self._clock.now() - start
        timed_out = ctx.expired()
        with self.stats._mu:
            self.stats.processed += 1
            self.stats.total_process_time += elapsed
            if timed_out:
                self.stats.timeouts += 1
        if err is None:
            # A successful return completes the message even when the
            # deadline elapsed mid-flight (recorded in stats.timeouts
            # above): the work — side effects, generated response — is
            # done, and retrying would discard and re-execute it. (A
            # WATCHDOG-abandoned call never reaches here — it lost the
            # claim above.)
            self.manager.complete_message(msg, elapsed)
            with self.stats._mu:
                self.stats.succeeded += 1
            return True
        reason = (f"timeout after {elapsed:.3f}s ({err!r})" if timed_out
                  else repr(err))
        self._handle_failure(msg, reason, elapsed, timed_out)
        return True

    # -- watchdog ------------------------------------------------------------

    def _watchdog_loop(self) -> None:
        """Abandon calls that run past their hard deadline: free the
        concurrency slot and push the message through the timeout/retry
        path. The wedged call itself cannot be killed (Python threads);
        it is disowned — its eventual return is dropped by the claim
        arbitration in _process_message."""
        while not self._stop.wait(0.05):
            now = self._clock.now()
            expired = []
            with self._inflight_mu:
                for token, rec in list(self._inflight.items()):
                    if now >= rec.deadline:
                        expired.append((token, rec))
            for token, rec in expired:
                if not rec.claim():
                    continue  # finished in the window; thread handles it
                with self._inflight_mu:
                    self._inflight.pop(token, None)
                rec.ctx.cancel()
                self._sem.release()          # free the wedged slot
                if rec.pool is not None:
                    # The freed semaphore slot is only real capacity if
                    # a thread exists to serve it — the wedged call
                    # still occupies one; spawn a replacement.
                    rec.pool.grow()
                elapsed = now - rec.start
                with self.stats._mu:
                    self.stats.processed += 1
                    self.stats.total_process_time += elapsed
                    self.stats.timeouts += 1
                log.warning("message %s watchdog-abandoned after %.3fs "
                            "(hard deadline)", rec.msg.id, elapsed)
                self._handle_failure(
                    rec.msg,
                    f"watchdog: hard deadline exceeded after {elapsed:.3f}s",
                    elapsed, True)

    # -- failure path --------------------------------------------------------

    def _handle_failure(self, msg: Message, reason: str, elapsed: float,
                        timed_out: bool) -> None:
        msg.retry_count += 1
        msg.error = reason
        if msg.can_retry():
            delay = self.backoff.next_backoff(msg.retry_count)
            with self.stats._mu:
                self.stats.retried += 1
            # Requeue accounting now, delivery after the backoff delay.
            qname = self.manager.stash_for_retry(msg)
            msg.status = MessageStatus.PENDING
            self.delayed_queue.schedule_after(msg, delay, qname)
            log.info("message %s retry %d/%d in %.2fs (%s)",
                     msg.id, msg.retry_count, msg.max_retries, delay, reason)
            return
        qname = self.manager._pop_inflight(msg.id) or self.manager.route_for(msg)
        self.manager.fail_message(msg, elapsed, qname)
        if timed_out:
            msg.status = MessageStatus.TIMEOUT
        with self.stats._mu:
            self.stats.failed += 1
        if self.dead_letter_queue is not None:
            self.dead_letter_queue.push(msg, reason, qname)
            with self.stats._mu:
                self.stats.dead_lettered += 1
        if self.on_permanent_failure is not None:
            try:
                self.on_permanent_failure(msg, reason)
            except Exception:  # noqa: BLE001 — a failing hook must not
                # break the failure path itself.
                log.exception("on_permanent_failure hook failed for %s",
                              msg.id)
        log.warning("message %s failed permanently after %d retries: %s",
                    msg.id, msg.retry_count, reason)
