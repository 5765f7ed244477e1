"""FNV-1a 64-bit checksums.  A copy of ``codec_eval_tpu/corpus/checksum.py``
(reference: src/corpus/checksum.rs:12-49).
"""

from __future__ import annotations

from pathlib import Path

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a_64(data: bytes) -> int:
    """FNV-1a 64-bit hash of in-memory bytes."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def fnv1a_64_file(path: Path, chunk_size: int = 1 << 20) -> int:
    """Streaming FNV-1a 64-bit hash of a file."""
    h = _FNV_OFFSET
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            for b in chunk:
                h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def checksum_hex(value: int) -> str:
    return f"{value:016x}"
