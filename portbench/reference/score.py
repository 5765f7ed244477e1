"""The plain reference scorer: one reference image against N decoded u8
candidates, all four metrics, as ``codec_eval_tpu_torch``'s
``BatchScorer.score_batch`` defines them (commit 80b80d3): a candidate equal
to the reference scores SSIMULACRA2 100, DSSIM 0, Butteraugli 0 and PSNR
+inf.  It imports nothing of the program and takes only the pixels.

``control=True`` computes every metric one precision step below the one the
port states: SSIMULACRA2 and PSNR in bfloat16 (stated f32), DSSIM's Lab
planes in f32 (stated f64), Butteraugli's operator products in TF32 (stated
f32 with TF32 off)."""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from . import butteraugli, dssim, psnr, ssimulacra2
from .color import srgb_u8_to_linear

METRICS = ("dssim", "ssimulacra2", "butteraugli", "psnr")


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 on or off for matmuls, restored after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def score_ladder(
    reference_u8: np.ndarray,
    candidates_u8: np.ndarray,
    metrics=METRICS,
    device="cpu",
    control: bool = False,
    chunk: int = 8,
) -> Dict[str, np.ndarray]:
    """reference (H, W, 3) u8, candidates (N, H, W, 3) u8 -> {metric: (N,)
    f64}, scored ``chunk`` candidates at a time on ``device``."""
    s2_dtype = torch.bfloat16 if control else torch.float32
    lab_dtype = torch.float32 if control else torch.float64
    out: Dict[str, list] = {k: [] for k in metrics}
    with torch.no_grad(), _tf32(control):
        ref = torch.from_numpy(np.ascontiguousarray(reference_u8)).to(device)
        ref_planar = torch.movedim(ref, -1, 0).contiguous()
        lin_ref = torch.movedim(srgb_u8_to_linear(ref), -1, 0).contiguous()
        pre_s2 = (ssimulacra2.precompute_reference(lin_ref.to(s2_dtype))
                  if "ssimulacra2" in metrics else None)
        pre_ds = (dssim.precompute_dssim_reference(lin_ref, lab_dtype)
                  if "dssim" in metrics else None)
        pre_ba = (butteraugli.precompute_butteraugli_reference(lin_ref)
                  if "butteraugli" in metrics else None)
        for start in range(0, candidates_u8.shape[0], chunk):
            block = np.ascontiguousarray(np.moveaxis(candidates_u8[start:start + chunk], -1, 1))
            batch = torch.from_numpy(block).to(device)
            identical = (batch == ref_planar).flatten(1).all(dim=1)
            lin = srgb_u8_to_linear(batch)
            vals = {}
            if "psnr" in metrics:
                vals["psnr"] = psnr.psnr(ref_planar, batch, s2_dtype)
            if "dssim" in metrics:
                v = dssim.dssim_against_reference(pre_ds, lin)
                vals["dssim"] = torch.where(identical, torch.zeros_like(v), v)
            if "ssimulacra2" in metrics:
                vals["ssimulacra2"] = ssimulacra2.ssimulacra2_batch(
                    pre_s2, ref_planar, batch, lin.to(s2_dtype))
            if "butteraugli" in metrics:
                v = butteraugli.butteraugli_batch(pre_ba, lin)
                vals["butteraugli"] = torch.where(identical, torch.zeros_like(v), v)
            for k, v in vals.items():
                out[k].append(v.to(torch.float32).cpu().numpy().astype(np.float64))
    return {k: np.concatenate(v) if v else np.zeros(0) for k, v in out.items()}
