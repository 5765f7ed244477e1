"""codec-eval-tpu's scoring path in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``codec_eval_tpu``, which stays the reference;
this package imports nothing from it.  Every function here is f32 end to
end: TF32 is switched off for matmuls and convolutions at import, because a
reduced-precision product in the metric math costs ~0.5% per value.

Quick start::

    import codec_eval_tpu_torch as ce
    config = (ce.EvalConfig.builder().report_dir("reports")
              .metrics(ce.MetricConfig.all()).quality_levels([50, 75, 95]).build())
    session = ce.EvalSession(config)   # on the card; device="cpu" for the host
    session.add_codec_with_decode("my-codec", "1.0", encode, decode)
    report = session.evaluate_image("img", ce.ImageData.rgb8(pixels))
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402
from .engine import (  # noqa: E402
    BatchScorer,
    CodecResult,
    CorpusReport,
    EncodeRequest,
    EvalConfig,
    EvalConfigBuilder,
    EvalSession,
    ImageData,
    ImageReport,
    assert_perception_level,
    assert_quality,
    evaluate_single,
)
from .errors import (  # noqa: E402
    CodecError,
    CodecEvalError,
    DimensionMismatch,
    QualityBelowThreshold,
)
from .metrics import MetricConfig, MetricResult, PerceptionLevel  # noqa: E402
from .stats.pareto import ParetoFront, RDPoint  # noqa: E402
from .stats.summary import (  # noqa: E402
    Summary,
    bd_rate,
    iqr,
    mean,
    median,
    percentile,
    percentile_u32,
    std_dev,
    trimmed_mean,
)
from .viewing import (  # noqa: E402
    REFERENCE_PPD,
    SimulationMode,
    SimulationParams,
    ViewingCondition,
    presets,
)


def xyb_roundtrip(rgb_u8, width=None, height=None, device="cuda"):
    """sRGB u8 -> quantized-XYB -> sRGB u8 roundtrip on ``device`` (the card
    unless the caller asks for the CPU).

    Accepts an (H, W, 3) array, or flat bytes plus width/height for parity
    with the reference signature (reference: src/metrics/xyb.rs:225).
    """
    import numpy as np

    from .kernels import color as _kc

    dev = resolve_device(device)
    if width is not None:
        arr = np.frombuffer(bytes(rgb_u8), dtype=np.uint8).reshape(height, width, 3)
        out = _kc.xyb_roundtrip(torch.from_numpy(arr.copy()).to(dev))
        return out.cpu().numpy().reshape(-1).tobytes()
    arr = np.ascontiguousarray(np.asarray(rgb_u8))
    return _kc.xyb_roundtrip(torch.from_numpy(arr).to(dev)).cpu().numpy()


__all__ = [
    "BatchScorer",
    "CodecError",
    "CodecEvalError",
    "CodecResult",
    "CorpusReport",
    "DimensionMismatch",
    "EncodeRequest",
    "EvalConfig",
    "EvalConfigBuilder",
    "EvalSession",
    "ImageData",
    "ImageReport",
    "MetricConfig",
    "MetricResult",
    "ParetoFront",
    "PerceptionLevel",
    "QualityBelowThreshold",
    "RDPoint",
    "REFERENCE_PPD",
    "SimulationMode",
    "SimulationParams",
    "Summary",
    "ViewingCondition",
    "assert_perception_level",
    "assert_quality",
    "bd_rate",
    "evaluate_single",
    "iqr",
    "mean",
    "median",
    "percentile",
    "percentile_u32",
    "presets",
    "std_dev",
    "trimmed_mean",
    "xyb_roundtrip",
]
