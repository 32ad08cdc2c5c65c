"""B=1 decode of the port's llama3-8b engine under each setting of the
async pipeline and the prefix cache, in turns, on one card.

Builds the default engine (``warmup=True``), then for each round runs
four engines over the same executor and allocator, one after another:
the defaults (pipeline and prefix cache on), both off, the pipeline
alone, the prefix cache alone. Each serves three 90-token prompts of 32
new tokens (every prompt's first page its own, so no prefix hit), then
one more under torch.profiler (device activity only). Prints per engine
the decode tok/s after the first token, the executor's step time (CUDA
events at fetch), the profiled request's device span and busy time, and
the card's SM clock and power.

    python scripts/torch_b1_switches.py --quant int8 --rounds 2

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from llmq_tpu_torch.core.config import (AsyncPipelineConfig,  # noqa: E402
                                        PrefixCacheConfig)
from llmq_tpu_torch.engine.builder import build_engine  # noqa: E402
from llmq_tpu_torch.engine.engine import GenRequest, InferenceEngine  # noqa: E402

SETTINGS = {"defaults": (True, True), "off": (False, False),
            "pipeline only": (True, False), "prefix cache only": (False, True)}
BASE = "The quick brown fox jumps over the lazy dog. " * 2


def engine_for(default, pipe: bool, prefix: bool):
    """An engine over the default engine's executor and allocator."""
    if pipe and prefix:
        return default
    eng = InferenceEngine(
        default.executor, default.tokenizer, name="variant",
        max_decode_steps=default.max_decode_steps,
        mixed_batch=default._mixed_cfg,
        async_pipeline=AsyncPipelineConfig() if pipe else None,
        prefix_cache=PrefixCacheConfig() if prefix else None)
    eng.allocator = default.allocator
    if eng._prefix_cache is not None:
        eng._prefix_cache.allocator = default.allocator
    return eng


def request(eng, n: int):
    h = eng.submit(GenRequest(id=f"b1-{n}", prompt=f"{n:02d}" + BASE[2:],
                              max_new_tokens=32))
    if not h.wait(120):
        raise TimeoutError("request timed out")
    return ((len(h.result.tokens) - 1) / (h.finished_at - h.marks["first_token"]),
            eng.executor.step_ms)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", choices=("bf16", "int8"), default="int8")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    cfg = cs._serve_cfg()
    if args.quant == "int8":
        cfg.model.quantization = cfg.model.kv_quantization = "int8"
    default = build_engine(cfg, warmup=True)
    n = 0
    for rnd in range(args.rounds):
        for name, (pipe, prefix) in SETTINGS.items():
            eng = engine_for(default, pipe, prefix)
            eng.start()
            rates = []
            for _ in range(3):
                n += 1
                rates.append(request(eng, n))
            n += 1
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                request(eng, n)
                torch.cuda.synchronize()
            eng.stop()
            events = cs._device_events(prof)
            span = (events[-1][1] - events[0][0]) / 1e3
            idle = cs._chunk_gaps(events, 0)[1]
            print(f"{args.quant} round {rnd} {name}: decode "
                  f"{', '.join(f'{r:.1f}' for r, _ in rates)} tok/s; step "
                  f"{', '.join(f'{s:.2f}' for _, s in rates)} ms; profiled "
                  f"request: device span {span:.1f} ms, busy "
                  f"{span - idle:.1f} ms; {cs.clocks()} ({cs.nvidia_smi_line()})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
