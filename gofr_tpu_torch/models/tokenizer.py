"""Tokenizers: text <-> token ids for the serving path (counterpart of
gofr_tpu/models/tokenizer.py). ``Tokenizer`` wraps an HF ``tokenizer.json``
through the ``tokenizers`` library, imported only when one is loaded;
``ByteTokenizer`` needs no file."""

from __future__ import annotations

import os

__all__ = ["ByteTokenizer", "Tokenizer", "load_tokenizer"]


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


class Tokenizer:
    """An HF ``tokenizers.Tokenizer`` behind the serving surface. bos/eos
    are found by name (``<bos>``/``<s>``, ``<eos>``/``</s>``) unless given."""

    def __init__(self, inner, *, bos_id: int | None = None, eos_id: int | None = None):
        self._tok = inner
        self.bos_id = bos_id if bos_id is not None else self._special("<bos>", "<s>")
        self.eos_id = eos_id if eos_id is not None else self._special("<eos>", "</s>")

    def _special(self, *names: str) -> int | None:
        for n in names:
            i = self._tok.token_to_id(n)
            if i is not None:
                return i
        return None

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        # strip bos/eos here: not every tokenizer.json registers them in
        # its special-token set, and skip_special_tokens misses those
        specials = {self.bos_id, self.eos_id}
        ids = [i for i in ids if i not in specials]
        return self._tok.decode(ids, skip_special_tokens=True)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


def load_tokenizer(path: str) -> Tokenizer:
    """Load from a tokenizer.json file or a checkpoint directory that
    contains one. Without the ``tokenizers`` library this raises (the
    serving path then keeps its id-only API), never a silent byte
    fallback."""
    try:
        from tokenizers import Tokenizer as HFTokenizer
    except ImportError as e:
        raise RuntimeError(
            "the `tokenizers` library is required for text serving; "
            "pass token ids directly if it is unavailable"
        ) from e

    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"tokenizer file not found: {path}")
    return Tokenizer(HFTokenizer.from_file(path))
