"""Tokenizers: the port's copy of ``llmq_tpu/engine/tokenizer.py``. The
byte tokenizer is dependency-free, its ids fit any vocab ≥ 259; a local
Hugging Face tokenizer directory needs the ``transformers`` package
(imported only when a path is configured; a host without it raises
``ImportError`` naming the package, and nothing falls back to bytes)."""

from __future__ import annotations

from typing import List, Union


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


class HFTokenizer:
    """A Hugging Face tokenizer from local files only (no download)."""

    def __init__(self, path: str) -> None:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"model.tokenizer_path {path!r} needs the 'transformers' "
                f"package, which is not importable here ({e}); leave the "
                f"path empty for the byte tokenizer") from e

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

        def _id(value, default):
            # `or` would turn a legitimate token id 0 into the default.
            return default if value is None else value

        self.pad_id = _id(self._tok.pad_token_id, 0)
        self.bos_id = _id(self._tok.bos_token_id, 1)
        self.eos_id = _id(self._tok.eos_token_id, 2)
        self.vocab_size = len(self._tok)
        #: Subword vocabularies average ~4 characters a token on English
        #: text: admission heuristics only, never KV sizing.
        self.chars_per_token = 4.0

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


Tokenizer = Union[ByteTokenizer, HFTokenizer]


def get_tokenizer(path: str = "") -> Tokenizer:
    """The tokenizer of ``model.tokenizer_path``: a local Hugging Face
    tokenizer directory if given, else bytes."""
    if path:
        return HFTokenizer(path)
    return ByteTokenizer()
