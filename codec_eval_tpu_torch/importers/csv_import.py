"""CSV import of external benchmark results.

A copy of ``codec_eval_tpu/importers/csv_import.py`` (reference:
src/import/mod.rs:40-389): ``ExternalResult`` rows with optional fields, a
column schema with a builder, and case-insensitive alias detection of
common column names.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..errors import CsvImportError


@dataclass
class ExternalResult:
    """One imported benchmark row.  reference: src/import/mod.rs:40-77."""

    image_name: str
    codec: str
    codec_version: Optional[str] = None
    quality_setting: Optional[float] = None
    file_size: Optional[int] = None
    bits_per_pixel: Optional[float] = None
    ssimulacra2: Optional[float] = None
    dssim: Optional[float] = None
    psnr: Optional[float] = None
    butteraugli: Optional[float] = None
    encode_time_ms: Optional[float] = None
    extra: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "image_name": self.image_name,
            "codec": self.codec,
            "codec_version": self.codec_version,
            "quality_setting": self.quality_setting,
            "file_size": self.file_size,
            "bits_per_pixel": self.bits_per_pixel,
            "ssimulacra2": self.ssimulacra2,
            "dssim": self.dssim,
            "psnr": self.psnr,
            "butteraugli": self.butteraugli,
            "encode_time_ms": self.encode_time_ms,
            "extra": self.extra,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ExternalResult":
        return cls(**{k: d.get(k) for k in (
            "image_name", "codec", "codec_version", "quality_setting",
            "file_size", "bits_per_pixel", "ssimulacra2", "dssim", "psnr",
            "butteraugli", "encode_time_ms",
        )}, extra=d.get("extra", {}))


#: Column-name aliases for auto-detection.
#: reference: src/import/mod.rs:262-330.
_ALIASES = {
    "image": ["image", "filename", "file", "name", "source", "input"],
    "codec": ["codec", "encoder", "format", "method"],
    "codec_version": ["version", "codec_version", "encoder_version"],
    "quality": ["quality", "q", "qp", "crf", "effort"],
    "size": ["size", "file_size", "bytes", "filesize"],
    "bpp": ["bpp", "bits_per_pixel", "bitrate"],
    "ssimulacra2": ["ssimulacra2", "ssim2", "ssimulacra_2"],
    "dssim": ["dssim", "ssim", "ms_ssim", "ms-ssim"],
    "psnr": ["psnr", "psnr_db", "psnr-hvs"],
    "butteraugli": ["butteraugli", "butter", "ba"],
    "encode_time": ["encode_time", "encode_ms", "time_ms", "encoding_time"],
}


@dataclass
class CsvSchema:
    """Explicit column names; None = auto-detect by alias.
    reference: src/import/mod.rs:81-143."""

    image_column: Optional[str] = None
    codec_column: Optional[str] = None
    codec_version_column: Optional[str] = None
    quality_column: Optional[str] = None
    size_column: Optional[str] = None
    bpp_column: Optional[str] = None
    ssimulacra2_column: Optional[str] = None
    dssim_column: Optional[str] = None
    psnr_column: Optional[str] = None
    butteraugli_column: Optional[str] = None
    encode_time_column: Optional[str] = None

    @classmethod
    def builder(cls) -> "CsvSchemaBuilder":
        return CsvSchemaBuilder()

    @classmethod
    def auto_detect(cls) -> "CsvSchema":
        return cls()

    def find_column(
        self, headers: Sequence[str], primary: Optional[str], aliases: Sequence[str]
    ) -> Optional[int]:
        lowered = [h.strip().lower() for h in headers]
        if primary:
            p = primary.strip().lower()
            if p in lowered:
                return lowered.index(p)
        for alias in aliases:
            if alias in lowered:
                return lowered.index(alias)
        return None


class CsvSchemaBuilder:
    """Fluent schema builder.  reference: src/import/mod.rs:145-233."""

    def __init__(self) -> None:
        self._schema = CsvSchema()

    def image_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.image_column = name
        return self

    def codec_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.codec_column = name
        return self

    def codec_version_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.codec_version_column = name
        return self

    def quality_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.quality_column = name
        return self

    def size_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.size_column = name
        return self

    def bpp_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.bpp_column = name
        return self

    def ssimulacra2_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.ssimulacra2_column = name
        return self

    def dssim_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.dssim_column = name
        return self

    def psnr_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.psnr_column = name
        return self

    def butteraugli_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.butteraugli_column = name
        return self

    def encode_time_column(self, name: str) -> "CsvSchemaBuilder":
        self._schema.encode_time_column = name
        return self

    def build(self) -> CsvSchema:
        return self._schema


class CsvImporter:
    """reference: src/import/mod.rs:236-389."""

    def __init__(self, schema: Optional[CsvSchema] = None):
        self.schema = schema or CsvSchema.auto_detect()

    @classmethod
    def auto_detect(cls) -> "CsvImporter":
        return cls(CsvSchema.auto_detect())

    def import_file(self, path) -> List[ExternalResult]:
        path = Path(path)
        try:
            f = open(path, newline="")
        except OSError as e:
            raise CsvImportError(f"cannot open {path}: {e}") from e
        with f:
            reader = csv.reader(f)
            try:
                headers = next(reader)
            except StopIteration:
                raise CsvImportError(f"{path}: empty CSV") from None

            s = self.schema
            cols = {
                "image": s.find_column(headers, s.image_column, _ALIASES["image"]),
                "codec": s.find_column(headers, s.codec_column, _ALIASES["codec"]),
                "version": s.find_column(
                    headers, s.codec_version_column, _ALIASES["codec_version"]
                ),
                "quality": s.find_column(headers, s.quality_column, _ALIASES["quality"]),
                "size": s.find_column(headers, s.size_column, _ALIASES["size"]),
                "bpp": s.find_column(headers, s.bpp_column, _ALIASES["bpp"]),
                "ssimulacra2": s.find_column(
                    headers, s.ssimulacra2_column, _ALIASES["ssimulacra2"]
                ),
                "dssim": s.find_column(headers, s.dssim_column, _ALIASES["dssim"]),
                "psnr": s.find_column(headers, s.psnr_column, _ALIASES["psnr"]),
                "butteraugli": s.find_column(
                    headers, s.butteraugli_column, _ALIASES["butteraugli"]
                ),
                "encode_time": s.find_column(
                    headers, s.encode_time_column, _ALIASES["encode_time"]
                ),
            }
            if cols["image"] is None:
                raise CsvImportError("Could not find image/filename column")
            if cols["codec"] is None:
                raise CsvImportError("Could not find codec/encoder column")

            def get(record, key):
                i = cols[key]
                if i is None or i >= len(record):
                    return None
                v = record[i].strip()
                return v or None

            def as_float(v):
                try:
                    return float(v) if v is not None else None
                except ValueError:
                    return None

            def as_int(v):
                try:
                    return int(float(v)) if v is not None else None
                except ValueError:
                    return None

            results: List[ExternalResult] = []
            for record in reader:
                image_name = get(record, "image") or ""
                codec = get(record, "codec") or ""
                if not image_name or not codec:
                    continue
                results.append(
                    ExternalResult(
                        image_name=image_name,
                        codec=codec,
                        codec_version=get(record, "version"),
                        quality_setting=as_float(get(record, "quality")),
                        file_size=as_int(get(record, "size")),
                        bits_per_pixel=as_float(get(record, "bpp")),
                        ssimulacra2=as_float(get(record, "ssimulacra2")),
                        dssim=as_float(get(record, "dssim")),
                        psnr=as_float(get(record, "psnr")),
                        butteraugli=as_float(get(record, "butteraugli")),
                        encode_time_ms=as_float(get(record, "encode_time")),
                    )
                )
            return results

    # Rust-parity alias.
    import_ = import_file


__all__ = ["ExternalResult", "CsvSchema", "CsvSchemaBuilder", "CsvImporter"]
