"""File-upload helpers: in-memory zip binding with a decompression cap
(counterpart of gofr_tpu/fileutil.py).

``Zip`` is the form-upload type a dataclass field binds a multipart zip
part to (``Request.bind``): the archive is unpacked in memory, capped at
100 MB decompressed (``ZipTooLargeError`` past it).
"""

from __future__ import annotations

import io
import zipfile

MAX_DECOMPRESSED_BYTES = 100 * 1024 * 1024


class ZipTooLargeError(Exception):
    pass


class Zip:
    """An uploaded zip archive, eagerly unpacked into {name: bytes}."""

    __slots__ = ("files",)

    def __init__(self, files: dict[str, bytes]):
        self.files = files

    @classmethod
    def from_bytes(cls, data: bytes) -> "Zip":
        out: dict[str, bytes] = {}
        total = 0
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            for info in zf.infolist():
                if info.is_dir():
                    continue
                total += info.file_size
                if total > MAX_DECOMPRESSED_BYTES:
                    raise ZipTooLargeError(f"decompressed size exceeds {MAX_DECOMPRESSED_BYTES} bytes")
                out[info.filename] = zf.read(info)
        return cls(out)

    def __len__(self) -> int:
        return len(self.files)

    def __contains__(self, name: str) -> bool:
        return name in self.files
