"""Device idle at the port's carried decode-chunk boundaries, sampled many
times in the state the chip smoke test's ``serve-plane`` phase reaches.

Runs ``chip_smoke.py``'s phases (all of them up to ``serve-plane`` unless
``--phases`` says otherwise). Just before ``serve-plane`` times its five
carried chunks, this script runs ``--rounds`` rounds of its own on the
same engine: it frees the pool, starts 8 rows of 900 new tokens, and
times the next ``--boundaries`` chunk boundaries with the smoke test's
``_event_chunk_gaps`` (the chunks' own CUDA events). Per round it prints
the largest and smallest idle, every boundary of 0.1 ms or more, how
many chunks were dispatched only after the chunk before had ended on the
card, and the garbage-collector pauses of 2 ms or more inside the timed
window; at the end the live threads and the process's collector pauses.
Then ``serve-plane`` runs as in the smoke test, gates included.

    python scripts/torch_chunk_gaps.py --rounds 5 --boundaries 40

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

PROMPT = "The quick brown fox jumps over the lazy dog. " * 2

#: (start, seconds, generation) of every collector pause of 2 ms or more.
PAUSES = []
_started = [0.0]


def _note_pause(phase, info) -> None:
    if phase == "start":
        _started[0] = time.perf_counter()
        return
    dt = time.perf_counter() - _started[0]
    if dt >= 0.002:
        PAUSES.append((_started[0], dt, info.get("generation")))


def _round(engine, i: int, boundaries: int) -> None:
    from llmq_tpu_torch.engine.engine import GenRequest

    cs._until(lambda: cs._idle(engine), 120, "an idle engine")
    with engine.paused():
        pc = engine._prefix_cache
        pc.evict_pages(pc.pages)
        while engine._reclaim_idle_conversation():
            pass
    hs = [engine.submit(GenRequest(id=f"gaps-{i}-{r}-{time.time()}",
                                   prompt=f"{r}: {PROMPT}",
                                   max_new_tokens=900)) for r in range(8)]
    cs._until(lambda: cs._decoding_rows(engine) >= 8, 120, "8 rows decoding")
    time.sleep(0.3)
    t0 = time.perf_counter()
    gaps, late = cs._event_chunk_gaps(engine, boundaries)
    t1 = time.perf_counter()
    for h in hs:
        h.cancel()
    inside = [(round(d * 1e3, 1), g) for t, d, g in PAUSES if t0 <= t <= t1]
    cs.log(f"[chunk-gaps] round {i}: {len(gaps)} boundaries, idle "
           f"{min(gaps):.4f}-{max(gaps):.4f} ms; 0.1 ms or more "
           f"{[round(g, 4) for g in gaps if g >= 0.1]}; dispatched after "
           f"the chunk before had ended {sum(late)}; collector pauses in "
           f"the window (ms, generation) {inside}; all "
           f"{[round(g, 4) for g in gaps]} ({cs.CARD})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--boundaries", type=int, default=40,
                    help="chunk boundaries a round (8 rows of 900 tokens "
                         "give about 50 chunks)")
    ap.add_argument("--phases", default=",".join(
        n for n, _ in cs.PHASES[:[n for n, _ in cs.PHASES]
                                .index("serve-plane") + 1]))
    args = ap.parse_args()
    gc.callbacks.append(_note_pause)
    gate = cs._obs_b8

    def rounds_then_gate(app, engine, base):
        cs.log(f"[chunk-gaps] live threads: "
               f"{sorted(t.name for t in threading.enumerate())}")
        cs.log(f"[chunk-gaps] objects the collector tracks: "
               f"{len(gc.get_objects())}")
        for i in range(args.rounds):
            _round(engine, i, args.boundaries)
        longest = sorted((round(d * 1e3, 1), g) for _, d, g in PAUSES)
        cs.log(f"[chunk-gaps] collector pauses of 2 ms or more since the "
               f"start: {len(PAUSES)}, longest (ms, generation) "
               f"{longest[-8:]}")
        return gate(app, engine, base)

    cs._obs_b8 = rounds_then_gate
    return cs.main(["--phases", args.phases])


if __name__ == "__main__":
    sys.exit(main())
