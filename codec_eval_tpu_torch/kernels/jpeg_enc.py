"""The tpujpeg encoder's device half: colour transform, 8x8 DCTs, the
activity field, and the whole-ladder quantize / reconstruct; plus the host
quantizers and the trellis DP.

Port of ``codec_eval_tpu/kernels/jpeg_enc.py``.  The JAX module builds one
jitted program per shape (``build_transform``, ``build_reconstruct_sweep``,
``build_jpeg_decode``); PyTorch runs eagerly, so here they are plain
functions of tensors that run on their input's device, with the quality
axis as a leading batch dimension where JAX uses ``vmap``.  Every product
is f32 (TF32 is off at package import): quantized coefficients are integer
decisions, and a reduced-precision DCT would move them at .5 boundaries.

The DCT is one (blocks, 64) x (64, 64) product per plane against the fused
DCT-and-zigzag operator.  Chroma upsampling on decode is libjpeg's "fancy"
triangle filter written elementwise (0.75 / 0.25 of the two nearest
samples), where JAX multiplies by a sparse operator matrix.  The trellis DP
runs once per plane over every block of every quality: on the card as one
launch of the hand-written K10 (``csrc/jpeg_trellis.cu``), where JAX
scans; its plain version's rate lookup is a gather from the static (run,
size) table, where JAX uses a one-hot matmul.

The host quantizers, the Huffman rate models and the numpy trellis are
copies of the JAX module's code.

``reconstruct_sweep`` spans its steps (``ce.jpeg.transform``,
``ce.jpeg.trellis`` or ``ce.jpeg.quantize``, ``ce.jpeg.reconstruct``), which
record only while a profiler records (``utils.profiling``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import span
from .cuda import jpeg_trellis

__all__ = [
    "ZIGZAG",
    "ac_code_lengths",
    "ac_symbol_histogram",
    "dct8_matrix",
    "huffman_code_lengths",
    "jpeg_decode",
    "jpeg_transform",
    "qtabs_for",
    "quality_to_qtables",
    "quantize_blocks",
    "reconstruct_sweep",
    "transform",
    "trellis_quantize_blocks",
    "trellis_quantize_dev",
    "trellis_quantize_plain",
]

#: Natural-order index of each coefficient in zigzag scan order
#: (identical to libjpeg's jpeg_natural_order; ITU T.81 Figure 5).
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

#: ITU T.81 Annex K.1 example quantization tables (natural row-major order).
ANNEX_K_LUMA = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.float64,
)

ANNEX_K_CHROMA = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.float64,
)

#: Base quantization tables of the XYB mode (channel order Y, X, B-Y after
#: the [0, 255] range scaling): the square root of Annex K luma rescaled to
#: its DC step, the chroma table 1.6x that (the JAX module records the
#: BD-rate scan that chose them).
XYB_LUMA_BASE = np.clip(np.sqrt(ANNEX_K_LUMA) * 4.0, 1.0, 255.0).astype(np.float64)
XYB_CHROMA_BASE = np.clip(XYB_LUMA_BASE * 1.6, 1.0, 255.0).astype(np.float64)

#: [0, 255] scaling ranges of the XYB-mode channels in bitstream order
#: (Y, X, B-Y); B is stored decorrelated as B-Y, jpegli's layout.
XYB_ENC_RANGES = np.array([[0.0, 0.846], [-0.016, 0.029], [-0.29, 0.40]], dtype=np.float32)

# The f32 factors of the XYB channels' [0, 255] scaling, folded as XLA
# folds the JAX module's constant divisions and products ((a - lo) / span
# * 255 becomes (a - lo) * (255 / span)), so that the port rounds as the
# reference does.
_XYB_SPAN = XYB_ENC_RANGES[:, 1] - XYB_ENC_RANGES[:, 0]
_XYB_LO = [float(v) for v in XYB_ENC_RANGES[:, 0]]
_XYB_TO_U8 = [float(np.float32(1.0) / s * np.float32(255.0)) for s in _XYB_SPAN]
_XYB_FROM_U8 = [float(np.float32(1.0 / 255.0) * s) for s in _XYB_SPAN]

#: Static (16 run, 11 size) AC bit-length models of the trellis rate term
#: (optimized-Huffman fits to pooled round-to-nearest statistics; entries
#: above 16 are unlimited-depth estimates, a rate model, not emitted codes).
DEFAULT_AC_LENGTHS_LUMA = np.array(
    [
        [3, 2, 3, 3, 4, 4, 5, 6, 12, 16, 16],
        [16, 4, 5, 7, 8, 10, 12, 14, 16, 16, 16],
        [16, 5, 7, 8, 11, 15, 19, 16, 16, 16, 16],
        [16, 6, 9, 11, 15, 16, 16, 16, 16, 16, 16],
        [16, 7, 10, 14, 16, 16, 16, 16, 16, 16, 16],
        [16, 7, 12, 15, 15, 16, 16, 16, 16, 16, 16],
        [16, 7, 13, 14, 19, 16, 16, 16, 16, 16, 16],
        [16, 10, 14, 15, 19, 16, 16, 16, 16, 16, 16],
        [16, 10, 15, 19, 16, 16, 16, 16, 16, 16, 16],
        [16, 8, 13, 18, 16, 16, 16, 16, 16, 16, 16],
        [16, 9, 14, 17, 18, 16, 16, 16, 16, 16, 16],
        [16, 11, 14, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 12, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 12, 14, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 13, 17, 16, 16, 16, 16, 16, 16, 16, 16],
        [13, 15, 16, 16, 16, 16, 16, 16, 16, 16, 16],
    ],
    dtype=np.float32,
)

DEFAULT_AC_LENGTHS_CHROMA = np.array(
    [
        [2, 2, 2, 4, 9, 16, 16, 16, 16, 16, 16],
        [16, 3, 6, 8, 14, 16, 16, 16, 16, 16, 16],
        [16, 6, 9, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 7, 13, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 7, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 8, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 9, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 10, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 11, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 13, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 14, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 15, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
    ],
    dtype=np.float32,
)

SUBSAMPLINGS = ("420", "444", "422", "440")


def dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix C with C[u, x] = s(u) cos((2x+1)u pi/16)
    (T.81 A.3.3: s(0) = sqrt(1/8), s(u>0) = 1/2)."""
    u = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    c = np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    c[0, :] *= np.sqrt(0.5)
    return (c * 0.5).astype(np.float32)


def quality_to_qtables(
    quality: float,
    base_luma: np.ndarray = ANNEX_K_LUMA,
    base_chroma: np.ndarray = ANNEX_K_CHROMA,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scale base tables by libjpeg's jpeg_quality_scaling (5000/q below 50,
    else 200 - 2q); uint16 natural-order tables clamped to [1, 255]."""
    q = float(min(max(quality, 1.0), 100.0))
    scale = 5000.0 / q if q < 50.0 else 200.0 - 2.0 * q

    def scaled(base: np.ndarray) -> np.ndarray:
        t = np.floor((base * scale + 50.0) / 100.0)
        return np.clip(t, 1.0, 255.0).astype(np.uint16)

    return scaled(np.asarray(base_luma)), scaled(np.asarray(base_chroma))


def qtabs_for(qualities, colorspace: str = "ycbcr") -> np.ndarray:
    """(n_q, 2, 64) natural-order f32 steps of each quality: the tables a
    ladder's ``reconstruct_sweep`` takes (XYB's bases for ``"xyb"``)."""
    if colorspace == "xyb":
        bases = (XYB_LUMA_BASE, XYB_CHROMA_BASE)
    else:
        bases = (ANNEX_K_LUMA, ANNEX_K_CHROMA)
    return np.stack(
        [np.stack(quality_to_qtables(q, *bases)).astype(np.float32) for q in qualities]
    )


@functools.lru_cache(maxsize=1)
def _zigzag_dct_matrix() -> np.ndarray:
    """The fused 2-D DCT and zigzag as one orthonormal 64 x 64 matrix W:
    W[k, x*8+y] = C[u_k, x] C[v_k, y] for the natural position (u_k, v_k)
    of zigzag index k.  Forward: F_zz = f_flat @ W.T; inverse: f_flat =
    F_zz @ W.  Computed in f64, applied in f32."""
    c = dct8_matrix().astype(np.float64)
    w = np.zeros((64, 64), dtype=np.float64)
    for k in range(64):
        u, v = divmod(int(ZIGZAG[k]), 8)
        for x in range(8):
            for y in range(8):
                w[k, x * 8 + y] = c[u, x] * c[v, y]
    w = w.astype(np.float32)
    w.flags.writeable = False
    return w


def _wmat(device) -> torch.Tensor:
    return torch.from_numpy(_zigzag_dct_matrix().copy()).to(device)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 0-d tensor on ``like``'s device.  Dividing by it is a true
    division; dividing by a Python float may be done as a multiplication by
    its reciprocal, which rounds differently."""
    return torch.tensor(np.float32(value), device=like.device)


def _blockify(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H/8, W/8, 8, 8)."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)


def _unblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(..., by, bx, 8, 8) -> (..., by*8, bx*8)."""
    *lead, by, bx, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, by * 8, bx * 8)


def _factors(subsampling: str) -> Tuple[int, int]:
    """(horizontal, vertical) chroma subsampling factors."""
    return (2 if subsampling in ("420", "422") else 1, 2 if subsampling in ("420", "440") else 1)


def _activity_field(y_plane: torch.Tensor) -> torch.Tensor:
    """Per-block activity in [0, 1] from the padded Y plane: log1p of half
    the block's standard deviation (0..255 units), normalized by
    log1p(20).  The host maps it to a per-block rounding bias (the
    standard-decodable form of jpegli-style adaptive quantization)."""
    blocks = _blockify(y_plane)
    mean = torch.mean(blocks, dim=(-1, -2), keepdim=True)
    var = torch.mean((blocks - mean) ** 2, dim=(-1, -2))
    sd = torch.sqrt(var + 1e-6)
    act = torch.log1p(sd * 0.5) / _scalar(np.log1p(20.0), sd)
    return torch.clamp(act, 0.0, 1.0)


def transform(
    rgb_u8: torch.Tensor, subsampling: str = "420", colorspace: str = "ycbcr"
) -> Dict[str, torch.Tensor]:
    """Quality-independent JPEG analysis of one (H, W, 3) u8 image, on its
    device.  Returns
      dct_y (byY, bxY, 64) f32 zigzag-order DCT coefficients,
      dct_cb / dct_cr (byC, bxC, 64),
      act_y (byY, bxY) activity in [0, 1],
      act_c (byC, bxC) activity of the chroma block grid (from Y).
    Block grids are padded to whole MCUs by edge replication.

    colorspace="xyb": the channels are the opsin XYB values scaled to
    [0, 255] (``XYB_ENC_RANGES``) in (Y, X, B-Y) order, 4:4:4 only.
    """
    if subsampling not in SUBSAMPLINGS:
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    if colorspace not in ("ycbcr", "xyb"):
        raise ValueError(f"unsupported colorspace {colorspace!r}")
    if colorspace == "xyb" and subsampling != "444":
        raise ValueError("xyb colorspace requires 4:4:4")
    if colorspace == "xyb":
        from .color import linear_rgb_to_xyb, srgb_u8_to_linear

        xyb = linear_rgb_to_xyb(srgb_u8_to_linear(rgb_u8))
        y = (xyb[..., 1] - _XYB_LO[0]) * _XYB_TO_U8[0]
        cb = (xyb[..., 0] - _XYB_LO[1]) * _XYB_TO_U8[1]
        cr = (xyb[..., 2] - xyb[..., 1] - _XYB_LO[2]) * _XYB_TO_U8[2]
    else:
        rgb = rgb_u8.to(torch.float32)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        # JFIF YCbCr (BT.601 full range), T.871 section 7.
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0

    sh, sv = _factors(subsampling)

    def pad(p: torch.Tensor) -> torch.Tensor:
        hp, wp = -p.shape[0] % (8 * sv), -p.shape[1] % (8 * sh)
        if hp or wp:
            p = torch.nn.functional.pad(p[None, None], (0, wp, 0, hp), mode="replicate")[0, 0]
        return p

    y, cb, cr = pad(y), pad(cb), pad(cr)

    def down(p: torch.Tensor) -> torch.Tensor:
        # Box downsample (libjpeg's h2v2 / h2v1 without its smoothing pass).
        if sv == 2:
            p = 0.5 * (p[0::2, :] + p[1::2, :])
        if sh == 2:
            p = 0.5 * (p[:, 0::2] + p[:, 1::2])
        return p

    cb, cr = down(cb), down(cr)
    wmat = _wmat(y.device)

    def coeffs(plane: torch.Tensor) -> torch.Tensor:
        blocks = _blockify(plane - 128.0)
        return blocks.reshape(*blocks.shape[:2], 64) @ wmat.T

    act_y = _activity_field(y)
    act_c = act_y
    if sv == 2:
        act_c = act_c.reshape(act_c.shape[0] // 2, 2, act_c.shape[1]).amax(dim=1)
    if sh == 2:
        act_c = act_c.reshape(act_c.shape[0], act_c.shape[1] // 2, 2).amax(dim=2)
    return {"dct_y": coeffs(y), "dct_cb": coeffs(cb), "dct_cr": coeffs(cr),
            "act_y": act_y, "act_c": act_c}


def jpeg_transform(
    rgb_u8: np.ndarray, subsampling: str = "420", colorspace: str = "ycbcr", device="cuda"
) -> Dict[str, np.ndarray]:
    """Host entry: ``transform`` on ``device`` (the card unless the caller
    asks for the CPU), the planes fetched to numpy."""
    rgb = torch.from_numpy(np.require(rgb_u8, np.uint8, "CW")).to(resolve_device(device))
    return {k: v.cpu().numpy() for k, v in transform(rgb, subsampling, colorspace).items()}


# -- reconstruction (decode) -----------------------------------------------------


def _reconstruct_plane(coef_zz: torch.Tensor, q_zz: torch.Tensor) -> torch.Tensor:
    """Dequantize and inverse-DCT (..., by, bx, 64) zigzag coefficients with
    (..., 1, 1, 64) steps -> (..., by*8, bx*8) samples."""
    flat = (coef_zz * q_zz) @ _wmat(coef_zz.device)
    return _unblockify(flat.reshape(*flat.shape[:-1], 8, 8)) + 128.0


def _triangle_up(p: torch.Tensor, dim: int) -> torch.Tensor:
    """2x triangle ("fancy") upsample along ``dim`` with the edge clamped:
    out[2i] = .75 in[i] + .25 in[i-1], out[2i+1] = .75 in[i] + .25 in[i+1]."""
    n = p.shape[dim]
    left = torch.cat([p.narrow(dim, 0, 1), p.narrow(dim, 0, n - 1)], dim)
    right = torch.cat([p.narrow(dim, 1, n - 1), p.narrow(dim, n - 1, 1)], dim)
    near = 0.75 * p
    out = torch.stack([near + 0.25 * left, near + 0.25 * right], dim + 1 if dim >= 0 else dim)
    shape = list(p.shape)
    shape[dim] = 2 * n
    return out.reshape(shape)


def _upsample_chroma(cb, cr, subsampling: str) -> tuple:
    sh, sv = _factors(subsampling)
    if sh == 2:
        cb, cr = _triangle_up(cb, -1), _triangle_up(cr, -1)
    if sv == 2:
        cb, cr = _triangle_up(cb, -2), _triangle_up(cr, -2)
    return cb, cr


def _scaled_xyb_to_rgb_u8(y, x, bmy) -> torch.Tensor:
    """The [0, 255]-scaled (Y, X, B-Y) planes (..., H, W) -> (..., 3, H, W) sRGB u8."""
    from .color import linear_to_srgb_u8, xyb_to_linear_rgb

    yv = y * _XYB_FROM_U8[0] + _XYB_LO[0]
    xv = x * _XYB_FROM_U8[1] + _XYB_LO[1]
    bv = bmy * _XYB_FROM_U8[2] + _XYB_LO[2] + yv
    out = linear_to_srgb_u8(xyb_to_linear_rgb(torch.stack([xv, yv, bv], dim=-1)))
    return torch.movedim(out, -1, -3)


def _ycbcr_to_rgb_u8(y, cb, cr) -> torch.Tensor:
    """JFIF (BT.601 full-range) inverse -> (..., 3, H, W) u8, rounding half
    to even as ``jnp.round`` does."""
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return torch.clamp(torch.round(torch.stack([r, g, b], dim=-3)), 0.0, 255.0).to(torch.uint8)


def _to_rgb(y, cb, cr, subsampling: str, colorspace: str, height: int, width: int):
    cb, cr = _upsample_chroma(cb, cr, subsampling)
    if colorspace == "xyb":
        rgb = _scaled_xyb_to_rgb_u8(y, cb, cr)
    else:
        rgb = _ycbcr_to_rgb_u8(y, cb, cr)
    return rgb[..., :height, :width]


def jpeg_decode(
    cy: torch.Tensor,
    ccb: torch.Tensor,
    ccr: torch.Tensor,
    qtab_luma_zz: torch.Tensor,
    qtab_chroma_zz: torch.Tensor,
    height: int,
    width: int,
    subsampling: str = "420",
    colorspace: str = "ycbcr",
) -> torch.Tensor:
    """Device JPEG decode from entropy-decoded coefficients, on their device:
    dequantization, the float inverse DCT and libjpeg's fancy chroma
    upsampling.  cy (..., byY, bxY, 64) zigzag, ccb / ccr (..., byC, bxC,
    64), steps (..., 64) -> planar (..., 3, H, W) u8; leading dimensions
    decode a batch.  colorspace="xyb" inverts tpujpeg's Adobe-transform-0
    opsin container.  subsampling "400" decodes grayscale (the chroma
    arguments are unused and the luma fills all three channels)."""
    if subsampling not in (*SUBSAMPLINGS, "400"):
        raise ValueError(f"unsupported subsampling {subsampling!r}")

    def rp(coef, q):
        return _reconstruct_plane(coef.to(torch.float32), q.to(torch.float32)[..., None, None, :])

    y = rp(cy, qtab_luma_zz)
    if subsampling == "400":
        g = torch.clamp(torch.round(y), 0.0, 255.0).to(torch.uint8)
        return torch.stack([g, g, g], dim=-3)[..., :height, :width]
    return _to_rgb(y, rp(ccb, qtab_chroma_zz), rp(ccr, qtab_chroma_zz), subsampling, colorspace,
                   height, width)


def _quantize_dev(dct_zz: torch.Tensor, q_zz: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """sign(F) * min(floor(|F| / q + b), 1023) with b = 0.5 at DC and the
    per-block bias elsewhere; f32 (the reconstruction consumes it)."""
    scaled = torch.abs(dct_zz) / q_zz
    dc = torch.arange(64, device=dct_zz.device) == 0
    b = torch.where(dc, torch.full_like(bias[..., None], 0.5), bias[..., None])
    qc = torch.clamp(torch.floor(scaled + b), max=1023.0)
    return torch.sign(dct_zz) * qc


def reconstruct_sweep(
    rgb_u8: torch.Tensor,
    qtabs: torch.Tensor,
    aq_strength: float,
    subsampling: str = "420",
    colorspace: str = "ycbcr",
    with_coefs: bool = True,
    trellis_lambda: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode and decode a whole quality ladder on the image's device.

    rgb_u8 (H, W, 3) u8; qtabs (n_q, 2, 64) natural-order f32 steps;
    aq_strength the activity-driven rounding bias (0 rounds to nearest).
    Returns (candidates (n_q, 3, H, W) u8 planar, the layout the batch
    scorer takes; {"y", "cb", "cr": (n_q, by, bx, 64) int16 zigzag}, or
    {} with with_coefs=False).  The candidates are what ``jpeg_decode``
    gives for the bytes the host entropy coder writes from those
    coefficients.  trellis_lambda > 0 replaces the AQ bias with the trellis
    DP under the static rate tables.
    """
    h, w = rgb_u8.shape[:2]
    with span("ce.jpeg.transform"):
        planes = transform(rgb_u8, subsampling, colorspace)
    zz = torch.from_numpy(ZIGZAG.astype(np.int64)).to(rgb_u8.device)
    q_zz = qtabs.to(torch.float32)[:, :, zz][:, :, None, None, :]  # (n_q, 2, 1, 1, 64)
    ql, qc = q_zz[:, 0], q_zz[:, 1]
    if trellis_lambda > 0.0:
        with span("ce.jpeg.trellis"):
            cy = trellis_quantize_dev(planes["dct_y"], ql, DEFAULT_AC_LENGTHS_LUMA,
                                      trellis_lambda)
            chroma = torch.stack([planes["dct_cb"], planes["dct_cr"]], dim=1)  # (by, 2, bx, 64)
            cc = trellis_quantize_dev(chroma, qc[:, :, None], DEFAULT_AC_LENGTHS_CHROMA,
                                      trellis_lambda)
            ccb, ccr = cc[:, :, 0], cc[:, :, 1]
    else:
        with span("ce.jpeg.quantize"):
            s = _scalar(aq_strength, rgb_u8)
            bias_y = torch.clamp(0.5 - s * planes["act_y"], 0.2, 0.5)
            bias_c = torch.clamp(0.5 - s * planes["act_c"], 0.2, 0.5)
            cy = _quantize_dev(planes["dct_y"], ql, bias_y)
            ccb = _quantize_dev(planes["dct_cb"], qc, bias_c)
            ccr = _quantize_dev(planes["dct_cr"], qc, bias_c)
    with span("ce.jpeg.reconstruct"):
        cands = _to_rgb(_reconstruct_plane(cy, ql), _reconstruct_plane(ccb, qc),
                        _reconstruct_plane(ccr, qc), subsampling, colorspace, h, w)
    if not with_coefs:
        return cands, {}
    return cands, {"y": cy.to(torch.int16), "cb": ccb.to(torch.int16), "cr": ccr.to(torch.int16)}


# -- host quantizers (copies of the JAX module's numpy code) ---------------------


def quantize_blocks(
    dct_zz: np.ndarray,
    qtable_natural: np.ndarray,
    bias: np.ndarray | float = 0.5,
) -> np.ndarray:
    """Deadzone-quantize zigzag-order DCT blocks on the host:
    sign(F) * floor(|F| / q + bias), bias per block ((by, bx)) or scalar,
    DC always rounding to nearest."""
    q = np.asarray(qtable_natural, dtype=np.float32)[ZIGZAG]
    scaled = np.abs(dct_zz) / q
    b = np.broadcast_to(
        np.float32(bias)[..., None]
        if isinstance(bias, np.ndarray)
        else np.float32(bias),
        scaled.shape,
    ).copy()
    b[..., 0] = 0.5
    qc = np.floor(scaled + b)
    # Baseline Huffman caps AC magnitude categories at 10 bits.
    qc = np.minimum(qc, 1023.0)
    return (np.sign(dct_zz) * qc).astype(np.int16)


def _ac_bit_sizes(mag: np.ndarray) -> np.ndarray:
    """JPEG magnitude category (bit length) of non-negative int magnitudes."""
    out = np.zeros(mag.shape, dtype=np.int64)
    m = mag.astype(np.int64)
    while np.any(m):
        nz = m > 0
        out[nz] += 1
        m >>= 1
    return out


def ac_symbol_histogram(qz: np.ndarray, hist: "np.ndarray | None" = None) -> np.ndarray:
    """Histogram of baseline AC (run, size) symbols (256 bins, run<<4|size)
    produced by run-length coding the given zigzag quantized blocks."""
    if hist is None:
        hist = np.zeros(256, dtype=np.int64)
    q = np.abs(qz.reshape(-1, 64).astype(np.int64))
    run = np.zeros(q.shape[0], dtype=np.int64)
    for k in range(1, 64):
        c = q[:, k]
        nz = c > 0
        if np.any(nz):
            r = run[nz]
            hist[0xF0] += int((r // 16).sum())
            sizes = _ac_bit_sizes(c[nz])
            np.add.at(hist, ((r % 16) << 4) | sizes, 1)
            run[nz] = 0
        run[~nz] += 1
    hist[0x00] += int((run > 0).sum())  # EOB for blocks with a zero tail
    return hist


def huffman_code_lengths(freq: np.ndarray, default: int = 16) -> np.ndarray:
    """Huffman code length per symbol for the given frequencies (unseen
    symbols get ``default``): unlimited-depth lengths, a rate model."""
    import heapq

    idx = np.flatnonzero(freq)
    lengths = np.full(freq.shape[0], float(default), dtype=np.float32)
    if idx.size == 0:
        return lengths
    if idx.size == 1:
        lengths[idx[0]] = 1.0
        return lengths
    depth = np.zeros(freq.shape[0], dtype=np.float32)
    heap = [(int(freq[i]), int(i), [int(i)]) for i in idx]
    heapq.heapify(heap)
    tiebreak = int(freq.shape[0])
    while len(heap) > 1:
        fa, _, la = heapq.heappop(heap)
        fb, _, lb = heapq.heappop(heap)
        merged = la + lb
        depth[merged] += 1.0
        heapq.heappush(heap, (fa + fb, tiebreak, merged))
        tiebreak += 1
    lengths[idx] = depth[idx]
    return lengths


def ac_code_lengths(planes) -> np.ndarray:
    """(16, 11) bit-length model for AC (run, size) symbols, from an
    optimized-Huffman fit to the given quantized planes (a list of zigzag
    int16 block arrays of one table class)."""
    hist = np.zeros(256, dtype=np.int64)
    for qz in planes:
        ac_symbol_histogram(qz, hist)
    lengths = huffman_code_lengths(hist)
    table = np.full((16, 11), 16.0, dtype=np.float32)
    for run in range(16):
        for size in range(11):
            sym = (run << 4) | size
            if size > 0 or run in (0, 15):  # valid symbols: EOB, ZRL, (r,s>0)
                table[run, size] = lengths[sym]
    return table


def trellis_quantize_blocks(
    dct_zz: np.ndarray,
    qtable_natural: np.ndarray,
    ac_lengths: np.ndarray,
    lmbda: "float | np.ndarray" = 0.35,
) -> np.ndarray:
    """Rate-distortion-optimal quantization of zigzag-order DCT blocks:
    per block, the AC values minimizing sum (|F|/q - c)^2 + lmbda * bits
    by a dynamic program over the 63 AC positions (state: the previous
    nonzero position; candidates: round-to-nearest and one step toward
    zero).  ``lmbda`` may be a per-block array.  DC rounds to nearest.
    A scalar ``lmbda`` runs the C++ DP (native/jpeg_trellis.cpp), which
    mirrors the numpy DP below operation for operation."""
    q = np.asarray(qtable_natural, dtype=np.float32)[ZIGZAG]
    lam = np.asarray(lmbda, dtype=np.float32)
    if lam.ndim == 0:
        from ..utils.native import trellis_quantize_native

        return trellis_quantize_native(dct_zz, q, ac_lengths, float(lam))
    lead = dct_zz.shape[:-1]
    F = dct_zz.reshape(-1, 64).astype(np.float32)
    B = F.shape[0]
    lam_b = lam.reshape(B)
    x = np.abs(F) / q  # (B, 64)
    sign = np.sign(F)

    c0 = np.minimum(np.floor(x + 0.5), 1023.0)  # round-to-nearest magnitude
    c1 = np.maximum(c0 - 1.0, 0.0)  # one step toward zero
    cands = np.stack([c0, c1])  # (2, B, 64)
    csize = _ac_bit_sizes(cands.astype(np.int64)).astype(np.int64)  # (2,B,64)

    L = np.asarray(ac_lengths, dtype=np.float32)  # (16, 11)
    l_zrl = float(L[15, 0])
    l_eob = float(L[0, 0])

    # Zero-distortion prefix sums over AC: P[:, j] = sum_{1<=i<=j} x_i^2.
    P = np.zeros((B, 64), dtype=np.float32)
    np.cumsum(x[:, 1:] ** 2, axis=1, out=P[:, 1:])

    NEG = np.float32(np.inf)
    best = np.full((B, 64), NEG, dtype=np.float32)
    best[:, 0] = 0.0  # state 0: no nonzero AC yet
    prev = np.zeros((B, 64), dtype=np.int8)
    vals = np.zeros((B, 64), dtype=np.int16)

    for k in range(1, 64):
        j = np.arange(k)  # previous nonzero position (0 = none yet)
        r = k - 1 - j  # zero-run length, (k,)
        runbits = (r // 16).astype(np.float32) * l_zrl  # ZRL chain
        Lr = L[r % 16]  # (k, 11)
        dist_zero = P[:, k - 1][None, :] - P[:, j].T  # (k, B)
        base = best[:, :k].T + dist_zero  # (k, B)
        total = np.full((2, k, B), NEG, dtype=np.float32)
        for ci in range(2):
            c = cands[ci, :, k]  # (B,)
            valid = c > 0
            if not np.any(valid):
                continue
            s = csize[ci, :, k]  # (B,)
            sym_bits = Lr[:, s] + s.astype(np.float32)[None, :]  # (k, B)
            d = (x[:, k] - c) ** 2  # (B,)
            t = base + lam_b[None, :] * (runbits[:, None] + sym_bits) + d[None, :]
            total[ci] = np.where(valid[None, :], t, NEG)
        flat = total.reshape(2 * k, B)
        pick = np.argmin(flat, axis=0)  # (B,)
        best[:, k] = flat[pick, np.arange(B)]
        prev[:, k] = (pick % k).astype(np.int8)
        vals[:, k] = cands[pick // k, np.arange(B), k].astype(np.int16)

    # Terminate: zero tail after last nonzero j, EOB unless j == 63.
    j = np.arange(64)
    tail = P[:, 63][:, None] - P[:, j][None, :].reshape(B, 64)
    end_bits = np.where(j < 63, l_eob, 0.0).astype(np.float32)
    totals = best + tail + lam_b[:, None] * end_bits[None, :]
    jlast = np.argmin(totals, axis=1)  # (B,)

    out = np.zeros((B, 64), dtype=np.int16)
    out[:, 0] = (sign[:, 0] * np.minimum(np.floor(x[:, 0] + 0.5), 2047.0)).astype(np.int16)
    cur = jlast.astype(np.int64)
    for k in range(63, 0, -1):
        on = cur == k
        if np.any(on):
            out[on, k] = (sign[on, k] * vals[on, k]).astype(np.int16)
            cur[on] = prev[on, k]
    return out.reshape(*lead, 64)


# -- the device trellis DP ---------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _run_table(lengths_bytes: bytes) -> np.ndarray:
    """RT[r, s]: ZRL-chain bits + symbol bits + appended magnitude bits for
    a zero-run r before a size-s coefficient, (63, 11) f32, as the JAX DP
    computes it."""
    lengths = np.frombuffer(lengths_bytes, dtype=np.float32).reshape(16, 11)
    r = np.arange(63)
    rt = ((r // 16).astype(np.float32)[:, None] * lengths[15, 0] + lengths[r % 16]
          + np.arange(11, dtype=np.float32)[None, :])
    rt.flags.writeable = False
    return rt


@functools.lru_cache(maxsize=8)
def _rate_table(lengths_bytes: bytes, lmbda: float) -> np.ndarray:
    """lam * RT as K10 takes it: the f32 products the plain version's
    ``lam * by_size`` forms, laid out (11 sizes, 63 runs)."""
    rt = np.float32(lmbda) * _run_table(lengths_bytes)
    out = np.ascontiguousarray(rt.T, dtype=np.float32)
    out.flags.writeable = False
    return out


def trellis_quantize_dev(
    dct_zz: torch.Tensor,
    q_zz: torch.Tensor,
    ac_lengths: np.ndarray,
    lmbda: float,
) -> torch.Tensor:
    """The trellis DP of ``trellis_quantize_blocks`` on the coefficients'
    device, with one static rate table: ``trellis_quantize_plain`` on CPU
    tensors, K10 (``kernels/cuda/jpeg_trellis.py`` ``trellis_dp``, one
    launch, bit for bit the plain version) on CUDA tensors.  dct_zz
    (..., 64) zigzag f32; q_zz (n_q, 1, ..., 1, 64), a ladder of steps,
    gives (n_q, ..., 64) back, and one quality's (64,) or (1, ..., 1, 64)
    steps of at most dct_zz's rank give its shape (on the CPU any broadcast against dct_zz; on
    the card these alone).  Returns f32 signed quantized values."""
    if dct_zz.device.type == "cpu":
        return trellis_quantize_plain(dct_zz, q_zz, ac_lengths, lmbda)
    lengths = np.ascontiguousarray(ac_lengths, dtype=np.float32)
    eob = float(np.float32(lmbda) * lengths[0, 0])
    return jpeg_trellis.trellis_dp(dct_zz.contiguous(), q_zz,
                                   _rate_table(lengths.tobytes(), lmbda), eob)


def trellis_quantize_plain(
    dct_zz: torch.Tensor,
    q_zz: torch.Tensor,
    ac_lengths: np.ndarray,
    lmbda: float,
) -> torch.Tensor:
    """The plain version of ``trellis_quantize_dev`` (and of K10): the JAX
    DP's ``scan`` as a loop of eager ops on the coefficients' device.
    q_zz broadcasts against dct_zz (a ladder passes (n_q, 1, 1, 64) steps
    and gets (n_q, ..., 64) back): every block of every quality runs in one
    DP of 63 steps.  Returns f32 signed quantized values.

    The DP state of a block is the position j of its previous nonzero AC
    coefficient: best[j] the least cost so far, prev / vals the choice at
    each position.  Step k prices both candidates (round to nearest, one
    step toward zero) after every state j < k; states j >= k are still
    +inf.  The first minimum wins, as in the JAX and C++ DPs.  The prefix
    sums add one column at a time so that they round as the sequential f32
    sums of the host DPs do."""
    lengths = np.ascontiguousarray(ac_lengths, dtype=np.float32)
    dev = dct_zz.device
    rt = torch.from_numpy(_run_table(lengths.tobytes()).copy()).to(dev)  # (63, 11)
    lam = _scalar(lmbda, dct_zz)
    l_eob = float(lengths[0, 0])

    x = torch.abs(dct_zz) / q_zz
    sgn = torch.sign(dct_zz).expand(x.shape)
    lead = x.shape[:-1]
    x = x.reshape(-1, 64)
    sgn = sgn.reshape(-1, 64)
    n = x.shape[0]
    c0 = torch.clamp(torch.floor(x + 0.5), max=1023.0)
    c1 = torch.clamp(c0 - 1.0, min=0.0)
    cands = (c0, c1)
    sizes = [torch.zeros(c.shape, dtype=torch.int64, device=dev) for c in cands]
    for s, c in zip(sizes, cands):
        for b in range(11):
            s += (c >= float(1 << b)).to(torch.int64)

    x2 = x * x
    P = torch.zeros_like(x)
    P[:, 1] = x2[:, 1]
    for j in range(2, 64):
        P[:, j] = P[:, j - 1] + x2[:, j]

    inf = torch.tensor(float("inf"), device=dev)
    best = torch.full((n, 64), float("inf"), device=dev)
    best[:, 0] = 0.0
    prev = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    vals = torch.zeros((n, 64), device=dev)
    j = torch.arange(64, device=dev)
    for k in range(1, 64):
        # The (11, 64) bits of each size after each state j: RT[k - 1 - j].
        # Columns j >= k hold any finite value, since best[:, j] is +inf there.
        by_size = rt[torch.clamp(k - 1 - j, min=0)].T
        zero_run = best + (P[:, k - 1:k] - P)
        costs = []
        for c, s in zip(cands, sizes):
            d = (x[:, k] - c[:, k]) ** 2
            cost = zero_run + lam * by_size[s[:, k]] + d[:, None]
            costs.append(torch.where(c[:, k:k + 1] > 0.0, cost, inf))
        both = torch.cat(costs, dim=1)  # (n, 128)
        pick = torch.argmin(both, dim=1)
        best[:, k] = torch.gather(both, 1, pick[:, None])[:, 0]
        prev[:, k] = pick % 64
        vals[:, k] = torch.where(pick < 64, c0[:, k], c1[:, k])

    end = (torch.arange(64, device=dev) < 63).to(torch.float32)
    totals = best + (P[:, 63:64] - P) + lam * l_eob * end[None, :]
    cur = torch.argmin(totals, dim=1)
    out = torch.zeros_like(x)
    for k in range(63, 0, -1):
        on = cur == k
        out[:, k] = torch.where(on, sgn[:, k] * vals[:, k], torch.zeros_like(vals[:, k]))
        cur = torch.where(on, prev[:, k], cur)
    out[:, 0] = sgn[:, 0] * torch.clamp(torch.floor(x[:, 0] + 0.5), max=2047.0)
    return out.reshape(*lead, 64)
