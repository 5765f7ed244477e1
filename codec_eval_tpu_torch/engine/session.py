"""EvalSession: the callback-based evaluation engine.

Port of the host path of ``codec_eval_tpu/engine/session.py`` (reference:
src/eval/session.rs:280-585).  Codecs are opaque host callbacks; every
decoded candidate of an image goes to the ``BatchScorer`` as one batch (the
list of decoded arrays, which the scorer copies into its staging buffer) and
is scored on the session's device in one pass.  ``evaluate_corpus``
runs a one-slot pipeline: a worker thread encodes and decodes image i+1 on
the host while the main thread scores image i on the card.

Adapter-registered codecs take two device fast paths, as in the JAX
session: a codec with a ``device_sweep`` (tpujpeg) runs its whole ladder
(encode, decode, score) on the device (``engine.tpu_sweep``), and a codec
whose ``format()`` is ``"jpg"`` is encoded on the host and decoded on the
device (``codecs.jpeg_device``), its candidates never visiting host RAM.
A fast path that raises falls back to the host cells with a
``RuntimeWarning``, and the session counts both the runs and the
fallbacks.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..errors import CodecError, CodecEvalError, DimensionMismatch, InvalidQuality
from ..metrics import MetricConfig, MetricResult
from ..utils.profiling import span
from ..viewing import ViewingCondition
from .image import ImageData
from .report import CodecResult, CorpusReport, ImageReport, write_csv_summary, write_json
from .scoring import METRICS, BatchScorer

#: Encode callback: (ImageData, EncodeRequest) -> bytes
EncodeFn = Callable[["ImageData", "EncodeRequest"], bytes]
#: Decode callback: bytes -> ImageData
DecodeFn = Callable[[bytes], "ImageData"]

DEFAULT_QUALITY_LEVELS = [50.0, 60.0, 70.0, 80.0, 85.0, 90.0, 95.0]


@dataclass
class EncodeRequest:
    """Quality + codec-specific params.  reference: src/eval/session.rs:150-178."""

    quality: float
    params: Dict[str, str] = field(default_factory=dict)

    def with_param(self, key: str, value: str) -> "EncodeRequest":
        self.params[key] = value
        return self


@dataclass
class EvalConfig:
    """Session configuration.  reference: src/eval/session.rs:188-278."""

    report_dir: Path
    cache_dir: Optional[Path] = None
    viewing: ViewingCondition = field(default_factory=ViewingCondition.desktop)
    metrics: MetricConfig = field(default_factory=MetricConfig.all)
    quality_levels: List[float] = field(default_factory=lambda: list(DEFAULT_QUALITY_LEVELS))
    #: Byte sizes on the device-sweep fast path: "exact" entropy-codes the
    #: fetched coefficients on the host; "device" derives them from device
    #: rate statistics (``kernels.jpeg_rate``: entropy-exact, 0xFF stuffing
    #: estimated to about +-0.15%).  Exact whenever ``cache_dir`` needs the
    #: artifact bytes.
    device_size_mode: str = "exact"

    def __post_init__(self) -> None:
        for q in self.quality_levels:
            if not 0.0 <= q <= 100.0:
                raise InvalidQuality(q)
        if self.device_size_mode not in ("exact", "device"):
            raise ValueError(
                f"device_size_mode must be 'exact' or 'device', got {self.device_size_mode!r}"
            )

    @classmethod
    def builder(cls) -> "EvalConfigBuilder":
        return EvalConfigBuilder()


class EvalConfigBuilder:
    """Builder with the reference's defaulting rules (report_dir required)."""

    def __init__(self) -> None:
        self._report_dir: Optional[Path] = None
        self._cache_dir: Optional[Path] = None
        self._viewing: Optional[ViewingCondition] = None
        self._metrics: Optional[MetricConfig] = None
        self._quality_levels: Optional[List[float]] = None
        self._device_size_mode: str = "exact"

    def report_dir(self, path) -> "EvalConfigBuilder":
        self._report_dir = Path(path)
        return self

    def cache_dir(self, path) -> "EvalConfigBuilder":
        """Write every encoded artifact to
        ``<path>/<image>-<codec>-q<quality>.bin``."""
        self._cache_dir = Path(path)
        return self

    def viewing(self, viewing: ViewingCondition) -> "EvalConfigBuilder":
        self._viewing = viewing
        return self

    def metrics(self, metrics: MetricConfig) -> "EvalConfigBuilder":
        self._metrics = metrics
        return self

    def quality_levels(self, levels: List[float]) -> "EvalConfigBuilder":
        self._quality_levels = [float(q) for q in levels]
        return self

    def device_size_mode(self, mode: str) -> "EvalConfigBuilder":
        """Byte sizes on the device-sweep fast path: "exact" (the host
        entropy coder) or "device" (device rate statistics)."""
        self._device_size_mode = mode
        return self

    def build(self) -> EvalConfig:
        if self._report_dir is None:
            raise ValueError("report_dir is required")
        return EvalConfig(
            report_dir=self._report_dir,
            cache_dir=self._cache_dir,
            viewing=self._viewing or ViewingCondition.desktop(),
            metrics=self._metrics or MetricConfig.all(),
            quality_levels=self._quality_levels or list(DEFAULT_QUALITY_LEVELS),
            device_size_mode=self._device_size_mode,
        )


@dataclass
class _CodecEntry:
    id: str
    version: str
    encode: EncodeFn
    decode: Optional[DecodeFn]
    #: The adapter object (``codecs.base.CodecImpl``) when registered with
    #: ``add_codec_impl``: it may take a device fast path.
    impl: Optional[object] = None


class EvalSession:
    """The evaluation engine.  reference: src/eval/session.rs:309-497.

    ``device`` is where the metrics run: the card ("cuda", the default) or
    the host ("cpu", when the caller asks for it).
    """

    def __init__(self, config: EvalConfig, device="cuda"):
        self.config = config
        self._codecs: List[_CodecEntry] = []
        self._scorer = BatchScorer(config.metrics, device=device)
        #: The fast paths' runs and fallbacks: a fallback survives, but a
        #: silent one would hide a defect.
        self.device_sweeps_run = 0
        self.device_sweep_fallbacks = 0
        self.jpeg_device_decodes_run = 0
        self.jpeg_device_decode_fallbacks = 0

    def add_codec(self, codec_id: str, version: str, encode: EncodeFn) -> "EvalSession":
        self._codecs.append(_CodecEntry(codec_id, version, encode, None))
        return self

    def add_codec_with_decode(
        self, codec_id: str, version: str, encode: EncodeFn, decode: DecodeFn
    ) -> "EvalSession":
        self._codecs.append(_CodecEntry(codec_id, version, encode, decode))
        return self

    def add_codec_impl(self, codec) -> "EvalSession":
        """Register a ``CodecImpl`` adapter through its encode and decode
        callbacks, keeping the adapter object for the device fast paths."""
        self._codecs.append(
            _CodecEntry(
                codec.id(), codec.version(), codec.encode_fn(), codec.decode_fn(), impl=codec
            )
        )
        return self

    @property
    def codec_count(self) -> int:
        return len(self._codecs)

    def _stage_cell(
        self,
        name: str,
        image: ImageData,
        codec: _CodecEntry,
        quality: float,
        keep_bytes: bool = False,
    ) -> dict:
        """Host phase for one (codec, quality) cell: encode/decode, timed,
        the artifact written under ``cache_dir`` when it is set.  Callback
        failures become typed ``CodecError``s.  ``keep_bytes`` keeps the
        stream under "data" in place of the host decode (the device decodes
        it)."""
        width, height = image.width, image.height
        request = EncodeRequest(quality=quality)
        t0 = time.perf_counter()
        try:
            encoded = codec.encode(image, request)
        except CodecEvalError:
            raise
        except Exception as e:  # noqa: BLE001 - callback boundary
            raise CodecError(
                codec.id, f"encode failed at q{quality:g}: {type(e).__name__}: {e}"
            ) from e
        encode_ms = int((time.perf_counter() - t0) * 1000)

        cached_path = None
        if self.config.cache_dir is not None:
            self.config.cache_dir.mkdir(parents=True, exist_ok=True)
            cached = self.config.cache_dir / f"{name}-{codec.id}-q{quality:g}.bin"
            cached.write_bytes(encoded)
            cached_path = str(cached)

        entry = {
            "codec": codec,
            "quality": quality,
            "params": request.params,
            "file_size": len(encoded),
            "encode_ms": encode_ms,
            "decode_ms": None,
            "decoded": None,
            "cached_path": cached_path,
            "error": None,
        }
        if keep_bytes:
            entry["data"] = encoded
        elif codec.decode is not None:
            t0 = time.perf_counter()
            try:
                decoded = codec.decode(encoded)
            except CodecEvalError:
                raise
            except Exception as e:  # noqa: BLE001 - callback boundary
                raise CodecError(
                    codec.id, f"decode failed at q{quality:g}: {type(e).__name__}: {e}"
                ) from e
            entry["decode_ms"] = int((time.perf_counter() - t0) * 1000)
            decoded_rgb = decoded.to_rgb8_srgb()
            if decoded_rgb.shape[:2] != (height, width):
                raise DimensionMismatch(
                    (width, height), (decoded_rgb.shape[1], decoded_rgb.shape[0])
                )
            entry["decoded"] = decoded_rgb
        return entry

    def _stage_image(self, name: str, image: ImageData, on_error: str = "raise") -> List[dict]:
        """Run every (codec, quality) cell.  With ``on_error="skip"`` a
        failing cell is kept as an unscored row and the others still run."""
        with span("ce.session.codecs"):
            staged: List[dict] = []
            for codec in self._codecs:
                if self._device_sweep_ok(codec):
                    try:
                        staged.extend(self._stage_codec_device(name, image, codec))
                        self.device_sweeps_run += 1
                        continue
                    except Exception as e:  # noqa: BLE001 - fall back, loudly
                        self.device_sweep_fallbacks += 1
                        warnings.warn(
                            f"device sweep failed for {codec.id} ({type(e).__name__}: {e}); "
                            "using the host per-cell path", RuntimeWarning, stacklevel=2)
                if self._jpeg_device_ok(codec):
                    try:
                        staged.extend(self._stage_codec_jpeg_device(name, image, codec))
                        self.jpeg_device_decodes_run += 1
                        continue
                    except Exception as e:  # noqa: BLE001 - fall back, loudly
                        self.jpeg_device_decode_fallbacks += 1
                        warnings.warn(
                            f"device JPEG decode failed for {codec.id} ({type(e).__name__}: {e}); "
                            "using the host per-cell path", RuntimeWarning, stacklevel=2)
                for quality in self.config.quality_levels:
                    try:
                        staged.append(self._stage_cell(name, image, codec, quality))
                    except CodecEvalError as e:
                        if on_error != "skip":
                            raise
                        staged.append(
                            {
                                "codec": codec,
                                "quality": quality,
                                "params": {},
                                "file_size": 0,
                                "encode_ms": 0,
                                "decode_ms": None,
                                "decoded": None,
                                "cached_path": None,
                                "error": str(e),
                            }
                        )
        return staged

    def _wanted(self) -> tuple:
        m = self.config.metrics
        return tuple(k for k in METRICS if getattr(m, k))

    def _device_sweep_ok(self, codec: _CodecEntry) -> bool:
        return (
            codec.impl is not None
            and hasattr(codec.impl, "device_sweep")
            and getattr(codec.impl, "supports_device_sweep", lambda: True)()
            and not self.config.metrics.xyb_roundtrip
            and bool(self._wanted())
        )

    def _jpeg_device_ok(self, codec: _CodecEntry) -> bool:
        """An adapter whose streams are standard JPEG decodes and scores on
        the device: the host runs only the Huffman parse.  Gated like the
        device sweep; callback-registered codecs never qualify (their
        decode is opaque)."""
        if (codec.impl is None or codec.decode is None or self.config.metrics.xyb_roundtrip
                or not self._wanted()):
            return False
        try:
            return codec.impl.format() == "jpg"
        except Exception:  # noqa: BLE001 - capability probe only
            return False

    def _stage_codec_jpeg_device(
        self, name: str, image: ImageData, codec: _CodecEntry
    ) -> List[dict]:
        """Every quality encoded on the host (timed per cell), then one
        device decode and one scoring batch for the ladder; decode_ms is
        each cell's share of that batch's wall time."""
        from ..codecs.jpeg_device import score_jpeg_files

        wanted = self._wanted()
        entries = [self._stage_cell(name, image, codec, q, keep_bytes=True)
                   for q in self.config.quality_levels]
        t0 = time.perf_counter()
        scores = score_jpeg_files(image.to_rgb8(), [e["data"] for e in entries],
                                  metrics=wanted, device=self._scorer.device)
        per_cell_ms = int((time.perf_counter() - t0) * 1000 / max(len(entries), 1))
        for e, s in zip(entries, scores):
            e.pop("data", None)
            e["metrics"] = MetricResult(**{k: s.get(k) for k in wanted})
            e["scored"] = True
            e["decode_ms"] = per_cell_ms
        return entries

    def _stage_codec_device(self, name: str, image: ImageData, codec: _CodecEntry) -> List[dict]:
        """One codec's ladder on the device (``engine.tpu_sweep``): encode,
        decode and scoring there, the host entropy pass giving exact sizes
        (and the artifacts' bytes when ``cache_dir`` is set).  encode_ms is
        each cell's share of the ladder's wall time; decode_ms is 0, since
        no host decode happens."""
        wanted = self._wanted()
        want_bytes = self.config.cache_dir is not None
        t0 = time.perf_counter()
        points = codec.impl.device_sweep(
            image, list(self.config.quality_levels), wanted,
            with_bytes=want_bytes, size_mode=self.config.device_size_mode,
        )
        per_cell_ms = int((time.perf_counter() - t0) * 1000 / max(len(points), 1))
        staged = []
        for p in points:
            cached_path = None
            if want_bytes and p.data is not None:
                self.config.cache_dir.mkdir(parents=True, exist_ok=True)
                cached = self.config.cache_dir / f"{name}-{codec.id}-q{p.quality:g}.bin"
                cached.write_bytes(p.data)
                cached_path = str(cached)
            staged.append({
                "codec": codec,
                "quality": p.quality,
                "params": {},
                "file_size": p.file_size or 0,
                "encode_ms": per_cell_ms,
                "decode_ms": 0,
                "decoded": None,
                "cached_path": cached_path,
                "error": None,
                "metrics": MetricResult(**{k: p.metrics.get(k) for k in wanted}),
                "scored": True,
            })
        return staged

    def _score_and_report(self, name: str, image: ImageData, staged: List[dict]) -> ImageReport:
        """Device phase: one batch for all decodable pairs not yet scored."""
        width, height = image.width, image.height
        report = ImageReport(name=name, width=width, height=height)
        decodable = [e for e in staged if e["decoded"] is not None and "metrics" not in e]
        if decodable and self._scorer.enabled():
            with span("ce.session.batch"):
                batch = [e["decoded"] for e in decodable]
                reference = image.to_rgb8()
            results = self._scorer.score_batch(reference, batch)
            for e, m in zip(decodable, results):
                e["metrics"] = m
        with span("ce.session.report"):
            for e in staged:
                metrics = e.get("metrics", MetricResult())
                report.results.append(
                    CodecResult(
                        codec_id=e["codec"].id,
                        codec_version=e["codec"].version,
                        quality=e["quality"],
                        file_size=e["file_size"],
                        bits_per_pixel=e["file_size"] * 8 / (width * height),
                        encode_time_ms=e["encode_ms"],
                        decode_time_ms=e["decode_ms"],
                        metrics=metrics,
                        perception=(metrics.perception_level()
                                    if e["decoded"] is not None or e.get("scored") else None),
                        cached_path=e["cached_path"],
                        codec_params=e["params"],
                    )
                )
        return report

    def evaluate_image(self, name: str, image: ImageData, on_error: str = "raise") -> ImageReport:
        """Evaluate one image across all codecs x quality levels: host codecs
        run serially (timed each), then every decoded candidate is scored in
        one batch."""
        with span("ce.session.image"):
            return self._score_and_report(name, image, self._stage_image(name, image, on_error))

    def evaluate_corpus(
        self, images, name: str = "corpus", on_error: str = "skip", progress=None
    ) -> CorpusReport:
        """Evaluate an iterable of (name, ImageData) pairs with a one-slot
        host/device pipeline: a worker thread runs image i+1's codecs while
        the card scores image i.  ``on_error="skip"`` applies the
        reference's skip-and-continue policy (a failing cell becomes an
        unscored row); "raise" propagates."""
        from concurrent.futures import ThreadPoolExecutor

        items = list(images)
        corpus_report = CorpusReport(name=name)
        if not items:
            return corpus_report

        def stage(idx):
            img_name, image = items[idx]
            return self._stage_image(img_name, image, on_error=on_error)

        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(stage, 0)
            for i, (img_name, image) in enumerate(items):
                try:
                    staged = future.result()
                except CodecEvalError as e:
                    if on_error == "raise":
                        raise
                    if progress:
                        progress(f"SKIP {img_name} ({e})")
                    staged = None
                if i + 1 < len(items):
                    future = pool.submit(stage, i + 1)
                if staged is None:
                    continue
                with span("ce.session.image"):
                    corpus_report.images.append(self._score_and_report(img_name, image, staged))
                if progress:
                    progress(f"[{i + 1}/{len(items)}] {img_name} OK")
        return corpus_report

    def write_image_report(self, report: ImageReport) -> None:
        """JSON report at <report_dir>/<name>.json.  reference: src/eval/session.rs:500-508."""
        self.config.report_dir.mkdir(parents=True, exist_ok=True)
        write_json(report, self.config.report_dir / f"{report.name}.json")

    def write_corpus_report(self, report: CorpusReport) -> None:
        """JSON and the 13-column CSV summary at <report_dir>/<name>.{json,csv}.
        reference: src/eval/session.rs:511-584."""
        self.config.report_dir.mkdir(parents=True, exist_ok=True)
        write_json(report, self.config.report_dir / f"{report.name}.json")
        write_csv_summary(report, self.config.report_dir / f"{report.name}.csv")
