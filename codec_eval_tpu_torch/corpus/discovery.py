"""Filesystem image discovery with header-only dimension parsing.

A copy of ``codec_eval_tpu/corpus/discovery.py`` (reference:
src/corpus/discovery.rs): a recursive scan that skips hidden directories,
the supported-extension filter, and PNG / JPEG / WebP header parsers, so
discovery decodes no pixels (PIL only for other formats).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Tuple

from ..errors import CorpusError
from .category import ImageCategory

#: reference: src/corpus/discovery.rs:10-12
SUPPORTED_EXTENSIONS = {
    "png", "jpg", "jpeg", "webp", "avif", "jxl", "heic", "heif", "bmp",
    "tiff", "tif",
}


def parse_png_dimensions(header: bytes) -> Optional[Tuple[int, int]]:
    """IHDR width/height.  reference: src/corpus/discovery.rs:132-138."""
    if len(header) < 24 or header[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    if header[12:16] != b"IHDR":
        return None
    w, h = struct.unpack(">II", header[16:24])
    return (w, h)


def parse_jpeg_dimensions(data: bytes) -> Optional[Tuple[int, int]]:
    """Scan segments for a SOFn marker.
    reference: src/corpus/discovery.rs:153-193."""
    if len(data) < 4 or data[0:2] != b"\xff\xd8":
        return None
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        if i + 4 > len(data):
            return None
        seg_len = struct.unpack(">H", data[i + 2 : i + 4])[0]
        # SOF0-SOF15 except DHT(C4)/JPG(C8)/DAC(CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 > len(data):
                return None
            h, w = struct.unpack(">HH", data[i + 5 : i + 9])
            return (w, h)
        i += 2 + seg_len
    return None


def parse_webp_dimensions(data: bytes) -> Optional[Tuple[int, int]]:
    """VP8 / VP8L / VP8X chunk headers.
    reference: src/corpus/discovery.rs:195-225."""
    if len(data) < 30 or data[0:4] != b"RIFF" or data[8:12] != b"WEBP":
        return None
    chunk = data[12:16]
    if chunk == b"VP8 ":
        # Lossy: frame tag at offset 20, then sync code, then 14-bit dims.
        if data[23:26] != b"\x9d\x01\x2a":
            return None
        w = struct.unpack("<H", data[26:28])[0] & 0x3FFF
        h = struct.unpack("<H", data[28:30])[0] & 0x3FFF
        return (w, h)
    if chunk == b"VP8L":
        if data[20] != 0x2F:
            return None
        bits = struct.unpack("<I", data[21:25])[0]
        w = (bits & 0x3FFF) + 1
        h = ((bits >> 14) & 0x3FFF) + 1
        return (w, h)
    if chunk == b"VP8X":
        w = (data[24] | (data[25] << 8) | (data[26] << 16)) + 1
        h = (data[27] | (data[28] << 8) | (data[29] << 16)) + 1
        return (w, h)
    return None


def image_dimensions(path: Path) -> Optional[Tuple[int, int]]:
    """Header-only dimensions; falls back to PIL for formats without a
    hand-rolled parser (avif/heic/bmp/tiff/jxl)."""
    ext = path.suffix.lower().lstrip(".")
    try:
        with open(path, "rb") as f:
            head = f.read(65536)
    except OSError:
        return None
    if ext == "png":
        return parse_png_dimensions(head)
    if ext in ("jpg", "jpeg"):
        return parse_jpeg_dimensions(head)
    if ext == "webp":
        return parse_webp_dimensions(head)
    try:
        from PIL import Image

        with Image.open(path) as im:
            return im.size
    except Exception:  # noqa: BLE001
        return None


def infer_category_from_path(relative_path: Path) -> ImageCategory:
    """Category from any matching directory component.
    reference: src/corpus/discovery.rs:228-246."""
    for part in relative_path.parts[:-1]:
        cat = ImageCategory.from_str_loose(part)
        if cat is not None:
            return cat
    return ImageCategory.OTHER


def discover_images(root: Path) -> List[dict]:
    """Recursively list supported images with header-parsed dimensions.

    Returns dicts with relative_path, width, height, file_size, format,
    category.  Hidden directories are skipped
    (reference: src/corpus/discovery.rs:69-78).
    """
    root = Path(root)
    if not root.exists():
        raise CorpusError(f"Path does not exist: {root}")
    if not root.is_dir():
        raise CorpusError(f"Path is not a directory: {root}")

    found: List[dict] = []

    def walk(current: Path) -> None:
        try:
            entries = sorted(current.iterdir())
        except OSError as e:
            raise CorpusError(f"Failed to read directory {current}: {e}") from e
        for entry in entries:
            if entry.is_dir():
                if entry.name.startswith("."):
                    continue
                walk(entry)
            elif entry.is_file():
                ext = entry.suffix.lower().lstrip(".")
                if ext not in SUPPORTED_EXTENSIONS:
                    continue
                dims = image_dimensions(entry)
                if dims is None:
                    continue
                rel = entry.relative_to(root)
                found.append(
                    {
                        "relative_path": str(rel),
                        "width": dims[0],
                        "height": dims[1],
                        "file_size": entry.stat().st_size,
                        "format": ext,
                        "category": infer_category_from_path(rel),
                    }
                )

    walk(root)
    return found
