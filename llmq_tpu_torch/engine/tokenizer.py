"""Byte tokenizer: the port's copy of ``llmq_tpu/engine/tokenizer.py``'s
``ByteTokenizer``. Dependency-free; its ids fit any vocab ≥ 259."""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """UTF-8 bytes shifted past 3 special ids (pad=0, bos=1, eos=2)."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _OFFSET = 3
    vocab_size = 256 + _OFFSET
    #: Characters per token of a text-length estimate (one byte, one id).
    chars_per_token = 1.0

    def encode(self, text: str) -> List[int]:
        return [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(i - self._OFFSET for i in ids
                     if self._OFFSET <= i < self.vocab_size)
        return data.decode("utf-8", errors="replace")


def get_tokenizer(path: str = "") -> ByteTokenizer:
    """The byte tokenizer. Local Hugging Face tokenizers are not ported
    yet, so a path is refused rather than ignored."""
    if path:
        raise ValueError("only the byte tokenizer is ported; "
                         f"tokenizer path {path!r} is not supported")
    return ByteTokenizer()
