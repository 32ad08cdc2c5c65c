"""Tensor ops of the port: norms, rotary embeddings, sampling, attention
routes and the hand-written CUDA kernels (``kernels``)."""
