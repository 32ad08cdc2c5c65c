"""Execution plane of the port: tokenizer, page allocator, executor,
continuous-batching engine and its builder."""
