"""Viewing-simulation resampling on tensors.

Port of ``codec_eval_tpu/kernels/resize.py``: sRGB u8 -> linear light, an
antialiased separable resize, -> sRGB u8.  The JAX package resizes with
``jax.image.resize(..., antialias=True)``, which is XLA code, not a Pallas
kernel.  Here the same scale-and-translate weights are built as one f32
matrix per resized axis (a copy of ``compute_weight_mat`` and its kernels
in JAX's ``jax/_src/image/scale.py``, since the card's machine has no JAX)
and applied as two f32 matrix products, H first, then W, as JAX's einsum
contracts them.  ``F.interpolate(antialias=True)`` is another filter and is
not used.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from .color import linear_to_srgb_u8, srgb_u8_to_linear

# The method names ``jax.image.resize`` accepts (``ResizeMethod.from_string``).
METHODS = {
    "nearest": "nearest",
    "linear": "linear", "bilinear": "linear", "trilinear": "linear", "triangle": "linear",
    "lanczos3": "lanczos3",
    "lanczos5": "lanczos5",
    "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
}


def canonical_method(method: str) -> str:
    try:
        return METHODS[method]
    except KeyError:
        raise ValueError(f'Unknown resize method "{method}"') from None


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float, x: torch.Tensor) -> torch.Tensor:
    # XLA folds ``pi * x / radius`` into ``x * (pi / radius)``, in f32.
    pi_over_radius = float(np.float32(np.pi) / np.float32(radius))
    y = radius * torch.sin(math.pi * x) * torch.sin(x * pi_over_radius)
    denom = torch.where(x != 0, math.pi**2 * x**2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / denom, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


# The kernels whose sample positions XLA's CPU backend rounds once, as one
# fused multiply-add ``fma(i + 0.5, inv_scale, -0.5)``: Lanczos's weight
# loops at every size tried; the triangle's and the cubic's round twice on
# axes of up to about 90 outputs and fuse beyond.  Both are scale.py's
# formula and differ by at most one f32 ulp of a position.  This models
# XLA's CPU code generation, the reference the port is held to on the CPU
# (without it Lanczos outputs drift past the 1e-6 of that comparison), not
# the code XLA makes for any other backend; the viewing path's "linear"
# never takes it.
FUSED_SAMPLES = frozenset({"lanczos3", "lanczos5"})

_KERNELS = {
    "linear": _triangle,
    "cubic": _keys_cubic,
    "lanczos3": functools.partial(_lanczos, 3.0),
    "lanczos5": functools.partial(_lanczos, 5.0),
}


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str, device: torch.device) -> torch.Tensor:
    """The (n_in, n_out) f32 antialiased resampling matrix of one axis, on
    ``device``: ``compute_weight_mat`` of ``jax.image.resize`` with scale
    n_out / n_in, translation 0 and ``antialias=True``."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    centers = torch.arange(n_out, dtype=f32, device=device) + 0.5
    if method in FUSED_SAMPLES:
        # One fused multiply-add: the f32 product is exact in f64, so one
        # f64 step and a rounding to f32 give the same sample positions.
        sample_f = (centers.double() * float(np.float32(inv_scale)) - 0.5).to(f32)
    else:
        sample_f = centers * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None])
    x = x / torch.full_like(x, kernel_scale)  # a true division, as XLA's
    weights = _KERNELS[method](x)
    total = torch.sum(weights, dim=0, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / safe,
        torch.zeros_like(weights),
    )
    # Zero the columns whose sample lies wholly outside the input.
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).contiguous()


def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    offsets = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(offsets).to(torch.int64)


def resize_linear(planes: torch.Tensor, target_h: int, target_w: int,
                  method: str = "linear") -> torch.Tensor:
    """Resize planar (..., H, W) f32 as ``jax.image.resize(..., method,
    antialias=True)`` resizes its spatial axes.  An axis whose size does not
    change is left alone; otherwise H is contracted first, then W."""
    method = canonical_method(method)
    h, w = planes.shape[-2:]
    out = planes
    if method == "nearest":
        if target_h != h:
            out = out.index_select(-2, _nearest_index(h, target_h, out.device))
        if target_w != w:
            out = out.index_select(-1, _nearest_index(w, target_w, out.device))
        return out
    if target_h != h:
        out = torch.matmul(weight_matrix(h, target_h, method, out.device).T, out)
    if target_w != w:
        out = torch.matmul(out, weight_matrix(w, target_w, method, out.device))
    return out


def resize_u8(image_u8, target_h: int, target_w: int, method: str = "linear",
              device="cuda") -> torch.Tensor:
    """Resize (H, W, 3) u8 sRGB to (target_h, target_w, 3) on ``device``.

    Resampling happens in linear light (gamma-correct scaling, the behavior
    browsers approximate), then re-encodes to sRGB u8.  Takes numpy or a
    tensor; returns a tensor on ``device``.
    """
    dev = resolve_device(device)
    if not isinstance(image_u8, torch.Tensor):
        image_u8 = torch.from_numpy(np.ascontiguousarray(image_u8))
    planar = torch.movedim(image_u8.to(dev), -1, 0)
    linear = srgb_u8_to_linear(planar)
    resized = resize_linear(linear, int(target_h), int(target_w), method)
    return torch.movedim(linear_to_srgb_u8(resized), 0, -1).contiguous()


def simulate_viewing(image_u8, params, method: str = "linear", device="cuda"):
    """Apply a ``SimulationParams`` transform to pixels.

    Returns the image rescaled to (target_height, target_width) when the
    simulation requires scaling, otherwise the input object itself.  Numpy
    in, numpy out; a tensor in, a tensor on ``device`` out.
    """
    if not params.requires_scaling():
        return image_u8
    out = resize_u8(image_u8, int(params.target_height), int(params.target_width),
                    method=method, device=device)
    return out.cpu().numpy() if isinstance(image_u8, np.ndarray) else out
