"""K4: Butteraugli Malta directional sweeps, batched.

``malta_ac_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/malta.py:malta_ac_batch_pallas``, with the
same arguments: (B, 6, H, W) asymmetric diff planes and the two line-pattern
tables -> (B, 2, H, W) accumulators (ac0 = X, ac1 = Y).  On a CUDA tensor it
launches the hand-written kernel (``csrc/malta.cu``); on a CPU tensor it runs
the plain PyTorch sweeps beside it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib

RADIUS = 4
#: (dest accumulator, pattern kind) per input plane: uhf_y, uhf_x, hf_y,
#: hf_x, mf_y, mf_x (the call order of ``_diffmap_psycho``).
CHANNEL_SPEC = ((1, "full"), (0, "full"), (1, "lf"), (0, "lf"), (1, "lf"), (0, "lf"))

_MAX_LINES = 16
_MAX_SAMPLES = 9


def malta_sweep(plane: torch.Tensor, lines) -> torch.Tensor:
    """Sum over oriented lines of weight * (line sum)^2 on ``(..., H, W)``,
    reading 0 outside the image."""
    h, w = plane.shape[-2], plane.shape[-1]
    pad = F.pad(plane, (RADIUS, RADIUS, RADIUS, RADIUS))
    acc = torch.zeros_like(plane)
    for weight, line in lines:
        s = None
        for dy, dx in line:
            piece = pad[..., RADIUS + dy : RADIUS + dy + h, RADIUS + dx : RADIUS + dx + w]
            s = piece if s is None else s + piece
        acc = acc + weight * (s * s)
    return acc


def malta_ac_plain(diffs: torch.Tensor, lines_full, lines_lf) -> torch.Tensor:
    acc = [None, None]
    for i, (dest, kind) in enumerate(CHANNEL_SPEC):
        term = malta_sweep(diffs[:, i], lines_full if kind == "full" else lines_lf)
        acc[dest] = term if acc[dest] is None else acc[dest] + term
    return torch.stack(acc, dim=1)


@functools.lru_cache(maxsize=4)
def _tables(lines_full, lines_lf):
    """Flatten the line tables for the kernel's constant memory: weights
    (2, 16) f32 and geometry (2, 16, 19) i32 = (count, dy[9], dx[9])."""
    weights = np.zeros((2, _MAX_LINES), np.float32)
    geom = np.zeros((2, _MAX_LINES, 1 + 2 * _MAX_SAMPLES), np.int32)
    for kind, lines in enumerate((lines_full, lines_lf)):
        if len(lines) > _MAX_LINES:
            raise ValueError(f"at most {_MAX_LINES} lines per pattern")
        for l, (weight, line) in enumerate(lines):
            if len(line) > _MAX_SAMPLES:
                raise ValueError(f"at most {_MAX_SAMPLES} samples per line")
            if any(max(abs(dy), abs(dx)) > RADIUS for dy, dx in line):
                raise ValueError(f"line samples must lie within radius {RADIUS}")
            weights[kind, l] = weight
            geom[kind, l, 0] = len(line)
            for q, (dy, dx) in enumerate(line):
                geom[kind, l, 1 + q] = dy
                geom[kind, l, 1 + _MAX_SAMPLES + q] = dx
    return weights, geom


def malta_ac_batch(diffs: torch.Tensor, lines_full, lines_lf) -> torch.Tensor:
    """K4.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if diffs.device.type == "cpu":
        return malta_ac_plain(diffs, lines_full, lines_lf)
    _lib.require_cuda("diffs", diffs, (None, 6, None, None))
    b, _, h, w = diffs.shape
    weights, geom = _tables(tuple(lines_full), tuple(lines_lf))
    dev = diffs.device
    out = torch.empty((b, 2, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_malta_ac(
            _lib.ptr(diffs), _lib.ptr(out), b, h, w, _lib.ptr(weights), _lib.ptr(geom),
            len(lines_full), len(lines_lf), _lib.stream(dev),
        )
    _lib.check(rc, "ce_malta_ac")
    malta_ac_batch.launches += 1
    return out


malta_ac_batch.launches = 0
malta_ac_batch.source = "codec_eval_tpu_torch/csrc/malta.cu"
malta_ac_batch.replaces = "codec_eval_tpu/kernels/pallas/malta.py:471"
