"""K4 and K5: Butteraugli Malta directional sweeps, batched.

``malta_ac_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/malta.py:malta_ac_batch_pallas``, with the
same arguments: (B, 6, H, W) asymmetric diff planes and the two line-pattern
tables -> (B, 2, H, W) accumulators (ac0 = X, ac1 = Y).

``malta_diffmap_batch`` is the counterpart of ``malta_diffmap_batch_pallas``,
the whole-diffmap kernel, with its arguments: the six Malta band planes of
the candidates and the reference, their mf_b and LF planes, the candidate
masking term, the reference masks, the line tables and the constants that
``butteraugli._fused_diffmap_consts`` resolves -> the (B, H, W) diffmap.

On a CUDA tensor each launches its hand-written kernel (``csrc/malta.cu``),
which has ``LINES_FULL`` and ``LINES_LF`` compiled in and refuses other
tables; on a CPU tensor it runs the plain PyTorch version beside it, which
takes any tables.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..color import rdiv
from . import _lib

RADIUS = 4
#: (dest accumulator, pattern kind) per input plane: uhf_y, uhf_x, hf_y,
#: hf_x, mf_y, mf_x (the call order of ``_diffmap_psycho``).
CHANNEL_SPEC = ((1, "full"), (0, "full"), (1, "lf"), (0, "lf"), (1, "lf"), (0, "lf"))

# Malta line patterns (dy, dx), the JAX package's _MALTA_LINES_FULL and
# _MALTA_LINES_LF, compiled into csrc/malta.cu.  Full variant: the slope-4 /
# slope-1/4 lines appear twice in the model's unrolled sum, hence weight 2.
LINES_FULL: Tuple[Tuple[float, Tuple[Tuple[int, int], ...]], ...] = (
    (1.0, tuple((k, k) for k in range(-3, 4))),
    (1.0, tuple((k, -k) for k in range(-3, 4))),
    (2.0, ((-4, -1), (-3, -1), (-2, -1), (-1, 0), (0, 0), (1, 0), (2, 1), (3, 1), (4, 1))),
    (2.0, ((-4, 1), (-3, 1), (-2, 1), (-1, 0), (0, 0), (1, 0), (2, -1), (3, -1), (4, -1))),
    (2.0, ((-1, -4), (-1, -3), (-1, -2), (0, -1), (0, 0), (0, 1), (1, 2), (1, 3), (1, 4))),
    (2.0, ((-1, 2), (-1, 3), (-1, 4), (0, -1), (0, 0), (0, 1), (1, -4), (1, -3), (1, -2))),
    (1.0, tuple((k, 0) for k in range(-4, 5))),
    (1.0, tuple((0, k) for k in range(-4, 5))),
    (1.0, ((-3, -2), (-2, -1), (-1, -1), (0, 0), (1, 1), (2, 1), (3, 2))),
    (1.0, ((-3, 2), (-2, 1), (-1, 1), (0, 0), (1, -1), (2, -1), (3, -2))),
    (1.0, ((-2, -3), (-1, -2), (-1, -1), (0, 0), (1, 1), (1, 2), (2, 3))),
    (1.0, ((-2, 3), (-1, 1), (-1, 2), (0, 0), (1, -2), (1, -1), (2, -3))),
)

LINES_LF: Tuple[Tuple[float, Tuple[Tuple[int, int], ...]], ...] = (
    (1.0, ((-4, -2), (-2, -1), (0, 0), (2, 1), (4, 2))),
    (1.0, ((-4, 2), (-2, 1), (0, 0), (2, -1), (4, -2))),
    (1.0, ((-2, -4), (-1, -2), (0, 0), (1, 2), (2, 4))),
    (1.0, ((-2, 4), (-1, 2), (0, 0), (1, -2), (2, -4))),
    (1.0, ((-3, -3), (-2, -2), (0, 0), (2, 2), (3, 3))),
    (1.0, ((-3, 3), (-2, 2), (0, 0), (2, -2), (3, -3))),
    (1.0, ((-4, -1), (-2, -1), (0, 0), (2, 1), (4, 1))),
    (1.0, ((-4, 1), (-2, 1), (0, 0), (2, -1), (4, -1))),
    (1.0, ((-1, -4), (-1, -2), (0, 0), (1, 2), (1, 4))),
    (1.0, ((-1, 2), (-1, 4), (0, 0), (1, -4), (1, -2))),
    (1.0, ((-4, 0), (-2, 0), (0, 0), (2, 0), (4, 0))),
    (1.0, ((0, -4), (0, -2), (0, 0), (0, 2), (0, 4))),
    (1.0, ((-3, -2), (-2, -1), (0, 0), (2, 1), (3, 2))),
    (1.0, ((-3, 2), (-2, 1), (0, 0), (2, -1), (3, -2))),
    (1.0, ((-2, -3), (-1, -2), (0, 0), (1, 2), (2, 3))),
    (1.0, ((-2, 3), (-1, 2), (0, 0), (1, -2), (2, -3))),
)


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


def check_tables(lines_full, lines_lf) -> None:
    """Raise ``ValueError`` unless the tables are the ones compiled into the
    kernels: ``LINES_FULL`` and ``LINES_LF``, every weight and every
    ``(dy, dx)`` in order."""
    if lines_full is LINES_FULL and lines_lf is LINES_LF:
        return

    def table(lines):
        return tuple((weight, tuple(map(tuple, line))) for weight, line in lines)

    if (table(lines_full), table(lines_lf)) != (LINES_FULL, LINES_LF):
        raise ValueError(
            "the Malta kernels are compiled for LINES_FULL and LINES_LF only; "
            "other line tables run on CPU tensors"
        )


def malta_ac_batch(diffs: torch.Tensor, lines_full, lines_lf) -> torch.Tensor:
    """K4.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if diffs.device.type == "cpu":
        return malta_ac_plain(diffs, lines_full, lines_lf)
    _lib.require_cuda("diffs", diffs, (None, 6, None, None))
    check_tables(lines_full, lines_lf)
    b, _, h, w = diffs.shape
    dev = diffs.device
    out = torch.empty((b, 2, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_malta_ac(
            _lib.ptr(diffs), _lib.ptr(out), b, h, w, _lib.stream(dev)
        )
    _lib.check(rc, "ce_malta_ac")
    malta_ac_batch.launches += 1
    return out


malta_ac_batch.launches = 0
malta_ac_batch.source = "codec_eval_tpu_torch/csrc/malta.cu"
malta_ac_batch.replaces = "codec_eval_tpu/kernels/pallas/malta.py:471"


# --------------------------------------------------------------------- K5


def malta_prologue(l0, l1, n2g: float, n2l: float, n1: float) -> torch.Tensor:
    """The asymmetric diff plane of reference ``l0`` and candidate ``l1``
    that a Malta sweep consumes, with the scalar weights resolved by the
    caller: n2g and n2l are ``mulli*sqrt(W*w)/(2*len+1)*norm1`` for the
    two asymmetry branches."""
    diff = l0 - l1
    denom = n1 + 0.5 * (torch.abs(l0) + torch.abs(l1))
    diffs = rdiv(n2g, denom) * diff
    scaler2 = rdiv(n2l, denom)
    fabs0 = torch.abs(l0)
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    zero = torch.zeros_like(diff)
    impact_pos = torch.where(
        l1 < too_small,
        scaler2 * (too_small - l1),
        torch.where(l1 > too_big, -scaler2 * (l1 - too_big), zero),
    )
    impact_neg = torch.where(
        l1 > -too_small,
        -scaler2 * (l1 + too_small),
        torch.where(l1 < -too_big, scaler2 * (-l1 - too_big), zero),
    )
    return diffs + torch.where(l0 >= 0, impact_pos, impact_neg)


def l2_asymmetric(v0, v1, k_gt: float, k_lt: float) -> torch.Tensor:
    """Butteraugli's asymmetric L2 of the HF bands; ``k_gt`` and ``k_lt``
    are the two weights with the 0.8 already applied."""
    d = v0 - v1
    total = k_gt * d * d
    fabs0 = torch.abs(v0)
    too_small = 0.4 * fabs0
    zero = torch.zeros_like(d)
    pos = torch.where(
        v1 < too_small, too_small - v1, torch.where(v1 > fabs0, v1 - fabs0, zero)
    )
    neg = torch.where(
        v1 > -too_small, v1 + too_small, torch.where(v1 < -fabs0, -v1 - fabs0, zero)
    )
    v = torch.where(v0 < 0, neg, pos)
    return total + k_lt * v * v


def malta_diffmap_plain(
    cand6, ref6, cand_rest, ref_rest, dac, masks, lines_full, lines_lf, ch_consts, epi
) -> torch.Tensor:
    """The (B, H, W) diffmap, in the Pallas kernel's order of sums."""
    diffs = torch.stack(
        [malta_prologue(ref6[c], cand6[:, c], *ch_consts[c]) for c in range(6)], dim=1
    )
    ac = malta_ac_plain(diffs, lines_full, lines_lf)
    (l2x_g, l2x_l, l2y_g, l2y_l, w_mfx, w_mfy, w_mfb, w_lfx, w_lfy, w_lfb, xmul) = epi
    # Six-plane order: uhf_y, uhf_x, hf_y, hf_x, mf_y, mf_x.
    ac0 = ac[:, 0] + l2_asymmetric(ref6[3], cand6[:, 3], 0.8 * l2x_g, 0.8 * l2x_l)
    ac1 = ac[:, 1] + l2_asymmetric(ref6[2], cand6[:, 2], 0.8 * l2y_g, 0.8 * l2y_l)
    d_mfx = ref6[5] - cand6[:, 5]
    ac0 = ac0 + w_mfx * d_mfx * d_mfx
    d_mfy = ref6[4] - cand6[:, 4]
    ac1 = ac1 + w_mfy * d_mfy * d_mfy
    # Rest order: mf_b, lf_x, lf_y, lf_b.
    d_mfb = ref_rest[0] - cand_rest[:, 0]
    ac2 = w_mfb * d_mfb * d_mfb
    ac1 = ac1 + dac
    d_lfx = ref_rest[1] - cand_rest[:, 1]
    d_lfy = ref_rest[2] - cand_rest[:, 2]
    d_lfb = ref_rest[3] - cand_rest[:, 3]
    dc = xmul * (w_lfx * d_lfx * d_lfx) + w_lfy * d_lfy * d_lfy + w_lfb * d_lfb * d_lfb
    total = masks[1] * dc + masks[0] * (xmul * ac0 + ac1 + ac2)
    return torch.sqrt(torch.clamp(total, min=0.0))


@functools.lru_cache(maxsize=4)
def _diffmap_args(ch_consts, epi):
    """The kernel's constants as f32: (6, 3) per-channel prologue constants
    and the 11 epilogue weights, the L2 pair weights times 0.8 as the plain
    version forms them (in double, rounded once)."""
    if len(ch_consts) != 6 or len(epi) != 11:
        raise ValueError("the diffmap kernel takes 6 channel triples and 11 weights")
    ch = np.asarray(ch_consts, np.float64).reshape(18).astype(np.float32)
    ep = np.asarray([0.8 * v for v in epi[:4]] + list(epi[4:]), np.float32)
    return ch, ep


def malta_diffmap_batch(
    cand6, ref6, cand_rest, ref_rest, dac, masks, lines_full, lines_lf, ch_consts, epi
) -> torch.Tensor:
    """K5.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if cand6.device.type == "cpu":
        return malta_diffmap_plain(
            cand6, ref6, cand_rest, ref_rest, dac, masks, lines_full, lines_lf, ch_consts, epi
        )
    _lib.require_cuda("cand6", cand6, (None, 6, None, None))
    b, _, h, w = cand6.shape
    dev = cand6.device
    for name, t, shape in (
        ("ref6", ref6, (6, h, w)), ("cand_rest", cand_rest, (b, 4, h, w)),
        ("ref_rest", ref_rest, (4, h, w)), ("dac", dac, (b, h, w)), ("masks", masks, (2, h, w)),
    ):
        _lib.require_cuda(name, t, shape)
        if t.device != dev:
            raise ValueError(f"{name} and cand6 must be on one device")
    check_tables(lines_full, lines_lf)
    ch, ep = _diffmap_args(tuple(tuple(c) for c in ch_consts), tuple(epi))
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_malta_diffmap(
            _lib.ptr(cand6), _lib.ptr(ref6), _lib.ptr(cand_rest), _lib.ptr(ref_rest),
            _lib.ptr(dac), _lib.ptr(masks), _lib.ptr(out), b, h, w, _lib.ptr(ch),
            _lib.ptr(ep), _lib.stream(dev),
        )
    _lib.check(rc, "ce_malta_diffmap")
    malta_diffmap_batch.launches += 1
    return out


malta_diffmap_batch.launches = 0
malta_diffmap_batch.source = "codec_eval_tpu_torch/csrc/malta.cu"
malta_diffmap_batch.replaces = "codec_eval_tpu/kernels/pallas/malta.py:347"
