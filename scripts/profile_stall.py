"""How long a ``torch.profiler`` capture holds the interpreter, on one card,
while another thread replays CUDA graphs of many small kernels (the
serving engine's llama3-8b decode step is one graph of ~1800 kernels).

A replay thread launches a graph of ``--kernels`` small elementwise
kernels, waits for it, and notes the time, over and over; a ticker
thread notes the time every 10 ms (a stand-in for the serving process's
heartbeat). For each profiler setting, in turns, a 1 s capture is taken
on a third thread: the replay thread is held between two replays while
the profiler starts and stops (as ``InferenceEngine.paused`` holds the
engine), then the trace is written. Printed per setting: the capture's
card kernels, the seconds of the start, the stop and the write, and the
longest gap of the replay thread and of the ticker over the capture.

Settings: ``cpu+cuda`` (the on-demand profile's), ``cuda`` (card
activity only), ``no-extcorr`` (``disable_external_correlation``) and
``trace-only`` (``trace_only``: no event objects built at the stop,
Kineto's own ``save`` writes the trace), each where the installed
PyTorch has it.

    python scripts/profile_stall.py --kernels 1800 --seconds 1

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from llmq_tpu_torch.utils.profiling import write_chrome_trace  # noqa: E402


class Replayer:
    """Replays ``graph`` and waits for it, in a loop, noting each end;
    :meth:`held` parks the loop between two replays."""

    def __init__(self, graph) -> None:
        self.graph = graph
        self.done = []
        self.stop = threading.Event()
        self._req = threading.Event()
        self._parked = threading.Event()
        self._lift = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self.stop.is_set():
            if self._req.is_set():
                self._parked.set()
                self._lift.wait()
                continue
            self.graph.replay()
            torch.cuda.current_stream().synchronize()
            self.done.append(time.perf_counter())

    @contextmanager
    def held(self):
        self._lift.clear()
        self._parked.clear()
        self._req.set()
        self._parked.wait()
        try:
            yield
        finally:
            self._req.clear()
            self._lift.set()


def build_graph(n: int, elems: int):
    x = torch.zeros(elems, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(n):
            x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            x.add_(1.0)
    torch.cuda.synchronize()
    return g


def settings():
    from torch._C._profiler import _ExperimentalConfig

    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = [("cpu+cuda", both, None), ("cuda", [ProfilerActivity.CUDA], None)]
    for name, kw in (("no-extcorr", {"disable_external_correlation": True}),
                     ("trace-only", {"trace_only": True})):
        try:
            out.append((name, both, _ExperimentalConfig(**kw)))
        except TypeError as e:
            print(f"{name}: not in torch {torch.__version__} ({e})",
                  flush=True)
    return out


def gap(times, t0, t1) -> float:
    seen = [t0] + [t for t in times if t0 < t < t1] + [t1]
    return max(b - a for a, b in zip(seen, seen[1:]))


def capture(rep, ticks, name, acts, cfg, seconds, out_dir) -> dict:
    kw = {"experimental_config": cfg} if cfg is not None else {}
    prof = profile(activities=acts, **kw)
    path = os.path.join(out_dir, f"{name}.json")
    t0 = time.perf_counter()
    with rep.held():
        prof.start()
    t1 = time.perf_counter()
    time.sleep(seconds)
    t2 = time.perf_counter()
    with rep.held():
        prof.stop()
    t3 = time.perf_counter()
    res = prof.profiler.kineto_results
    if cfg is not None and name == "trace-only":
        res.save(path)
        kernels = None
    else:
        write_chrome_trace(res, path)
        kernels = sum(1 for line in open(path) if '"cat": "kernel"' in line)
    t4 = time.perf_counter()
    return {"setting": name, "kernels": kernels,
            "trace_mib": round(os.path.getsize(path) / 2**20, 1),
            "start_s": round(t1 - t0, 3), "stop_s": round(t3 - t2, 3),
            "write_s": round(t4 - t3, 3),
            "replay_gap_s": round(gap(rep.done, t0, t4), 3),
            "ticker_gap_s": round(gap(ticks, t0, t4), 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", type=int, default=1800)
    ap.add_argument("--elems", type=int, default=1 << 20,
                    help="float32 elements each kernel adds to")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stall: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)
    rep = Replayer(build_graph(args.kernels, args.elems))
    ticks = []
    stop = threading.Event()

    def tick():
        while not stop.wait(0.01):
            ticks.append(time.perf_counter())

    threading.Thread(target=tick, daemon=True).start()
    rep.thread.start()
    time.sleep(1.0)
    n0, t0 = len(rep.done), time.perf_counter()
    time.sleep(1.0)
    per_s = (len(rep.done) - n0) / (time.perf_counter() - t0)
    print(f"{per_s:.1f} graphs/s of {args.kernels} kernels: "
          f"{per_s * args.kernels:.0f} kernels/s ({card})", flush=True)
    with tempfile.TemporaryDirectory() as d:
        for r in range(args.rounds):
            for name, acts, cfg in settings():
                res = capture(rep, ticks, name, acts, cfg, args.seconds, d)
                print(f"round {r}: {res} ({card})", flush=True)
                os.remove(os.path.join(d, f"{name}.json"))
    rep.stop.set()
    stop.set()
    rep.thread.join(5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
