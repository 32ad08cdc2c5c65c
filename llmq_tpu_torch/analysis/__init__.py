"""Correctness-tooling plane (docs/analysis.md), the port's copy of
``llmq_tpu/analysis/``.

Runtime instruments that make concurrency and invariant bugs
mechanically detectable instead of convention-enforced:

- ``lockdep`` — lock-order-graph instrument over ``threading.Lock`` /
  ``RLock`` (potential-deadlock cycles, held-lock blocking calls);
  opt-in via ``LLMQ_LOCKDEP=1`` for ``chip_smoke.py``.

The JAX package's static half (``scripts/analysis/``) analyses the tree
rather than the running process, and has no copy here.
"""

from llmq_tpu_torch.analysis import lockdep

__all__ = ["lockdep"]
