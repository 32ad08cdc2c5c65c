"""Invariant checker for chaos scenarios (the port's copy of
``llmq_tpu/chaos/invariants.py``). A scenario ends with ``check()``,
which asserts the three properties the robustness story rests on:

1. **Zero loss**: every submitted request reaches a terminal outcome:
   completed, failed or shed (the client was told), or dead-lettered.
2. **Zero duplicate completions**: redelivery may run a request again,
   but never complete it twice.
3. **Monotone token streams**: what a streaming consumer saw is a prefix
   of the final result; a crash never replays tokens into a live stream.

A passive, thread-safe event sink (engine callbacks fire on engine
threads).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional


class InvariantChecker:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._submitted: List[str] = []
        #: request id → terminal outcomes seen ("completed" | "failed" |
        #: "shed" | "dead_lettered").
        self._terminal: Dict[str, List[str]] = {}
        #: request id → tokens seen through the stream callback, in order.
        self._streams: Dict[str, List[int]] = {}
        #: request id → final result tokens, when known.
        self._results: Dict[str, List[int]] = {}

    # -- event sinks ---------------------------------------------------------

    def submitted(self, request_id: str) -> None:
        with self._mu:
            self._submitted.append(request_id)

    def on_token(self, request_id: str) -> Callable[[int], None]:
        """A ``cb(token_id)`` for ``GenHandle.on_token`` that records the
        stream for the monotonicity check."""
        def cb(token: int) -> None:
            with self._mu:
                self._streams.setdefault(request_id, []).append(int(token))
        return cb

    def completed(self, request_id: str,
                  tokens: Optional[List[int]] = None) -> None:
        with self._mu:
            self._terminal.setdefault(request_id, []).append("completed")
            if tokens is not None:
                self._results[request_id] = list(tokens)

    def failed(self, request_id: str, reason: str = "") -> None:
        with self._mu:
            self._terminal.setdefault(request_id, []).append("failed")

    def shed(self, request_id: str, status: int = 0) -> None:
        """An admission rejection (429/503) is a terminal outcome: the
        client was told to retry."""
        with self._mu:
            self._terminal.setdefault(request_id, []).append("shed")

    def dead_lettered(self, request_id: str) -> None:
        with self._mu:
            self._terminal.setdefault(request_id, []).append(
                "dead_lettered")

    # -- the checks ----------------------------------------------------------

    def violations(self) -> List[str]:
        out: List[str] = []
        with self._mu:
            submitted = list(self._submitted)
            terminal = {k: list(v) for k, v in self._terminal.items()}
            streams = {k: list(v) for k, v in self._streams.items()}
            results = {k: list(v) for k, v in self._results.items()}
        seen = set()
        for rid in submitted:
            if rid in seen:
                out.append(f"duplicate submission id {rid}")
            seen.add(rid)
            outcomes = terminal.get(rid, [])
            if not outcomes:
                out.append(f"LOST: {rid} reached no terminal outcome")
            completions = sum(1 for o in outcomes if o == "completed")
            if completions > 1:
                out.append(f"DUPLICATE COMPLETION: {rid} completed "
                           f"{completions}×")
            # Completed and dead-lettered delivers twice once an operator
            # requeues the dead letter.
            if completions and "dead_lettered" in outcomes:
                out.append(f"COMPLETED+DLQ: {rid} completed and was "
                           f"dead-lettered")
        for rid, stream in streams.items():
            final = results.get(rid)
            if final is None:
                continue
            if stream != final[:len(stream)]:
                out.append(
                    f"NON-MONOTONE STREAM: {rid} streamed {len(stream)} "
                    f"tokens that are not a prefix of its {len(final)}-"
                    f"token result")
        return out

    def check(self) -> None:
        """Raise AssertionError listing every violated invariant."""
        v = self.violations()
        if v:
            raise AssertionError(
                "chaos invariants violated:\n  " + "\n  ".join(v))

    def summary(self) -> Dict:
        with self._mu:
            outcomes: Dict[str, int] = {}
            for os_ in self._terminal.values():
                for o in os_:
                    outcomes[o] = outcomes.get(o, 0) + 1
            return {"submitted": len(self._submitted),
                    "terminal": dict(outcomes),
                    "streams": len(self._streams)}
