"""Device JPEG decoding: host Huffman parse, reconstruction on the card.

Port of ``codec_eval_tpu/codecs/jpeg_device.py``.  The host runs only the
entropy decode (native/jpeg_huff_decode.cpp, baseline and progressive);
dequantization, the float inverse DCT and libjpeg's fancy chroma upsampling
run on the device (``kernels.jpeg_enc.jpeg_decode``).  For scoring the
decoded pixels stay there: ``decode_jpeg_to_device`` returns the planar
(3, H, W) u8 tensor the batch scorer takes, and ``score_jpeg_files``
scores same-shape .jpg candidates against a reference with no decoded
pixel on the host.

Supported envelope: 8-bit Huffman JPEG with three components (4:4:4 /
4:2:0 / 4:2:2 / 4:4:0) or one (grayscale, the luma replicated to RGB),
baseline SOF0/SOF1 and progressive SOF2, restart markers, JFIF or Adobe
APP14 containers (transform 0 passes the channels through: tpujpeg's XYB
container decodes through the same path).  Anything else raises
``UnsupportedFormat``; corrupt data raises ``ValueError``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..engine.scoring import METRICS
from ..utils import native as _native

__all__ = [
    "is_available",
    "parse_jpeg",
    "decode_jpeg_device",
    "decode_jpeg_to_device",
    "score_jpeg_files",
]

def is_available() -> bool:
    """True once the native parser is loaded; a failed build raises."""
    return _native.load() is not None


def parse_jpeg(data: bytes) -> dict:
    """Host half: entropy-decode to quantized zigzag coefficient planes
    (``utils.native.jpeg_parse_coefficients`` lists the fields)."""
    return _native.jpeg_parse_coefficients(data)


def _colorspace_of(parsed: dict) -> str:
    # Adobe transform 0 passes the channels through: tpujpeg's XYB
    # container.  JFIF (no Adobe marker) and Adobe transform 1 are YCbCr.
    return "xyb" if parsed["adobe_transform"] == 0 else "ycbcr"


def _decode_parsed(parsed: List[dict], device: torch.device) -> torch.Tensor:
    """(N, 3, H, W) u8 on ``device`` for parsed streams of one decode
    configuration, in one batch."""
    from ..kernels.jpeg_enc import jpeg_decode

    p0 = parsed[0]

    def stacked(key: str, dtype) -> torch.Tensor:
        return torch.from_numpy(np.stack([p[key] for p in parsed]).astype(dtype)).to(device)

    return jpeg_decode(
        stacked("y", np.int16), stacked("cb", np.int16), stacked("cr", np.int16),
        stacked("qtab_luma_zz", np.float32), stacked("qtab_chroma_zz", np.float32),
        p0["height"], p0["width"], p0["subsampling"], _colorspace_of(p0),
    )


def decode_jpeg_to_device(data: bytes, device="cuda") -> torch.Tensor:
    """Parse on the host, reconstruct on ``device`` (the card unless the
    caller asks for the CPU): the planar (3, H, W) u8 tensor, left there."""
    return _decode_parsed([parse_jpeg(data)], resolve_device(device))[0]


def decode_jpeg_device(data: bytes, device="cuda") -> np.ndarray:
    """Full decode: the (H, W, 3) u8 numpy array."""
    return decode_jpeg_to_device(data, device).permute(1, 2, 0).cpu().numpy()


def score_jpeg_files(
    ref_u8: np.ndarray,
    candidates: Sequence[bytes],
    metrics: Sequence[str] = METRICS,
    parse_pool: Optional[ThreadPoolExecutor] = None,
    device="cuda",
) -> List[Dict[str, float]]:
    """Score same-shape .jpg candidates against one (H, W, 3) u8 reference
    with the decode on ``device``: per candidate the host runs only the
    Huffman parse; each group of one decode configuration (subsampling,
    colorspace, block grid) decodes as one batch and is scored as one chunk
    by the batch scorer's stages.  Returns one {metric: score} per
    candidate, in input order."""
    from ..engine.scoring import build_precompute, fetch_scores, metric_config, score_chunk
    from ..errors import DimensionMismatch

    dev = resolve_device(device)
    h, w = ref_u8.shape[:2]
    config = metric_config(metrics)
    parsed = (list(parse_pool.map(parse_jpeg, candidates)) if parse_pool is not None
              else [parse_jpeg(d) for d in candidates])
    for p in parsed:
        if (p["height"], p["width"]) != (h, w):
            raise DimensionMismatch((w, h), (p["width"], p["height"]))

    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(parsed):
        groups.setdefault((p["subsampling"], _colorspace_of(p), p["y"].shape[:2]), []).append(i)

    pre = build_precompute(torch.from_numpy(np.require(ref_u8, np.uint8, "CW")).to(dev), config)
    out: List[Optional[Dict[str, float]]] = [None] * len(parsed)
    for idxs in groups.values():
        batch = _decode_parsed([parsed[i] for i in idxs], dev)
        scores = fetch_scores(score_chunk(pre, batch, config))
        for j, i in enumerate(idxs):
            out[i] = {k: float(v[j]) for k, v in scores.items()}
    return out  # type: ignore[return-value]
