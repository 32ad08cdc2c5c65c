"""Speculative decoding plane (the port's counterpart of
``llmq_tpu/speculation/``): an n-gram / prompt-lookup drafter proposes
tokens out of the request's own prompt and generated suffix, the
executor verifies a whole window in one device program (teacher-forced
decode steps, each a replay of a captured CUDA graph on the card, with
position-keyed sampling), and the engine commits the accepted run plus
the correction token per single readback.

``executor.speculation.enabled: false`` (the default) is a hard
off-switch: no drafter runs, no verify program is built, and the engine
schedules exactly as without the plane.
"""

from llmq_tpu_torch.speculation.ngram import NgramDrafter, propose_ngram

__all__ = ["NgramDrafter", "propose_ngram"]
