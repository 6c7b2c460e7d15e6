"""Byte-level tokenizer (counterpart of gofr_tpu/models/tokenizer.py
``ByteTokenizer``; the HF ``Tokenizer`` waits for tokenizer files)."""

from __future__ import annotations

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    """Dependency-free byte-level tokenizer: token id i < 256 IS byte i,
    followed by bos (256) and eos (257). Any model with vocab_size >=
    258 can serve text through it — lossless on arbitrary UTF-8, no
    tokenizer.json required. This is what lets the OpenAI-compatible
    edge serve text against randomly initialized models with zero
    assets."""

    def __init__(self, vocab_size: int = 258):
        if vocab_size < 258:
            raise ValueError(
                f"ByteTokenizer needs vocab_size >= 258 (256 bytes + "
                f"bos/eos), got {vocab_size}"
            )
        self.bos_id = 256
        self.eos_id = 257
        self._vocab_size = vocab_size
        self.vocab = [bytes([i]) for i in range(256)] + [
            b"" for _ in range(vocab_size - 256)
        ]

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")

    @property
    def vocab_size(self) -> int:
        return self._vocab_size
