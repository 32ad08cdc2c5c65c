"""PyTorch/CUDA port of ``llmq_tpu``: the same queue, engine and Llama-3
serving path, on one NVIDIA H100 with hand-written Hopper kernels.

The JAX package is the reference; this package imports nothing of it
(nor of JAX). Entry points run on ``device="cuda"`` and raise without a
GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
