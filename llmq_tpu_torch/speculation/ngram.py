"""N-gram / prompt-lookup drafter (a copy of ``llmq_tpu/speculation/ngram.py``;
PAPERS.md: prompt lookup decoding).

Zero extra weights: the draft model IS the request's own token history.
The drafter matches the longest suffix n-gram (n ≤ ``ngram_max``) of the
context (prompt + generated, including the pending last token) against
an earlier occurrence in the same context and proposes the tokens that
followed it. Strongest on agentic and multi-turn traffic — tool
transcripts and quoted context repeat long spans verbatim, so
acceptance rates there are high; on novel text it simply proposes
nothing and the verify window degrades to a plain decode step.

Pure host-side Python over small ints — the drafter runs on the engine
thread between chunk dispatches, so it must never touch the device or
allocate per-call numpy buffers.
"""

from __future__ import annotations

from typing import List, Sequence


def propose_ngram(context: Sequence[int], k: int,
                  ngram_max: int = 3) -> List[int]:
    """Propose up to ``k`` draft tokens continuing ``context``.

    Finds the LONGEST suffix n-gram (n from ``ngram_max`` down to 1)
    with an earlier occurrence in ``context`` and returns the tokens
    that followed the MOST RECENT such occurrence. Longest-first beats
    most-recent-first on acceptance: a 3-gram match carries far more
    signal about the continuation than the nearest 1-gram. Returns []
    when nothing matches (or ``k <= 0``) — the caller then dispatches
    an undrafted window (q_len 1), never skips the row.
    """
    n_ctx = len(context)
    if k <= 0 or n_ctx < 2:
        return []
    for n in range(min(ngram_max, n_ctx - 1), 0, -1):
        pattern = tuple(context[n_ctx - n:])
        # Scan candidate starts newest-first; the suffix occurrence
        # itself (start == n_ctx - n) is excluded — it has no
        # continuation to propose.
        for start in range(n_ctx - n - 1, -1, -1):
            if tuple(context[start:start + n]) == pattern:
                follow = context[start + n:start + n + k]
                if follow:
                    return list(follow)
        # No occurrence at this n: try a shorter suffix.
    return []


class NgramDrafter:
    """Stateless drafter facade the engine holds per speculation plane.

    ``propose`` caps drafts at ``draft_k`` and never raises — a drafter
    failure must degrade to an undrafted window, not kill the step.
    """

    def __init__(self, draft_k: int, ngram_max: int = 3) -> None:
        self.draft_k = max(1, int(draft_k))
        self.ngram_max = max(1, int(ngram_max))
        #: Proposal-side counters (engine-thread only): windows drafted
        #: vs windows where the lookup came up empty — the acceptance
        #: histogram only sees drafted windows, so this is the
        #: denominator that makes its rates interpretable.
        self.windows_drafted = 0
        self.windows_empty = 0

    def propose(self, context: Sequence[int],
                k: int | None = None) -> List[int]:
        kk = self.draft_k if k is None else min(int(k), self.draft_k)
        try:
            drafts = propose_ngram(context, kk, self.ngram_max)
        except Exception:  # noqa: BLE001 — draft failure must not kill the step
            drafts = []
        if drafts:
            self.windows_drafted += 1
        else:
            self.windows_empty += 1
        return drafts
