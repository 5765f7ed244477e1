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
    session = ce.EvalSession(config, device="cuda")   # or "cpu"
    session.add_codec_with_decode("my-codec", "1.0", encode, decode)
    report = session.evaluate_image("img", ce.ImageData.rgb8(pixels))
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .engine import (  # noqa: E402
    BatchScorer,
    CodecResult,
    EncodeRequest,
    EvalConfig,
    EvalConfigBuilder,
    EvalSession,
    ImageData,
    ImageReport,
)
from .errors import CodecError, CodecEvalError, DimensionMismatch  # noqa: E402
from .metrics import MetricConfig, MetricResult, PerceptionLevel  # noqa: E402

__all__ = [
    "BatchScorer",
    "CodecError",
    "CodecEvalError",
    "CodecResult",
    "DimensionMismatch",
    "EncodeRequest",
    "EvalConfig",
    "EvalConfigBuilder",
    "EvalSession",
    "ImageData",
    "ImageReport",
    "MetricConfig",
    "MetricResult",
    "PerceptionLevel",
]
