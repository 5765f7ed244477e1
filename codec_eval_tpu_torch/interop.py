"""Carry the JAX package's state into the port.

The system has no learned weights: its state is the per-image reference
precompute (the SSIMULACRA2 pyramid, the DSSIM Lab pyramid and window
moments, the Butteraugli psycho images and masks).  ``references_from_numpy``
takes the dict that ``codec_eval_tpu.engine.scoring._build_precompute``
returns, with every array converted to numpy (its NamedTuples kept, e.g.
``jax.tree_util.tree_map(np.asarray, pre)``), and returns the port's
precompute dict for ``engine.scoring.score_chunk``.  This module imports
neither JAX nor the JAX package: it reads the structure by position.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .kernels.butteraugli import ButteraugliParams, ButteraugliReference, PsychoImage
from .kernels.dssim import DssimReference
from .kernels.ssimulacra2 import Ssimulacra2Reference


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def _psycho(pi, device) -> Optional[PsychoImage]:
    if pi is None:
        return None
    uhf, hf, mf, lf = pi
    return PsychoImage(uhf=_t(uhf, device), hf=_t(hf, device), mf=_t(mf, device), lf=_t(lf, device))


def _masks(m, device):
    return None if m is None else tuple(_t(a, device) for a in m)


def references_from_numpy(pre: Dict[str, object], device="cuda") -> Dict[str, object]:
    """JAX precompute (numpy leaves) -> the port's precompute dict, on the
    card unless the caller asks for the CPU (``resolve_device``)."""
    device = resolve_device(device)
    ref_u8 = _t(pre["ref_u8"], device)
    out: Dict[str, object] = {"ref_u8": ref_u8}
    if "s2" in pre:
        xyb, mu, sq = pre["s2"]
        out["s2"] = Ssimulacra2Reference(
            [_t(a, device) for a in xyb], [_t(a, device) for a in mu], [_t(a, device) for a in sq]
        )
    if "dssim" in pre:
        planes, mu, sq = pre["dssim"]

        def pairs(seq):
            return [(_t(luma, device), _t(chroma, device)) for luma, chroma in seq]

        out["dssim"] = DssimReference(pairs(planes), pairs(mu), pairs(sq))
    if "ba" in pre:
        pi0_full, pi0_sub, mask_full, mask_sub = pre["ba"]
        h, w = ref_u8.shape[0], ref_u8.shape[1]
        out["ba"] = ButteraugliReference(
            pi0_full=_psycho(pi0_full, device),
            pi0_sub=_psycho(pi0_sub, device),
            params=ButteraugliParams(),
            shape=(h, w),
            mask_full=_masks(mask_full, device),
            mask_sub=_masks(mask_sub, device),
        )
    return out
