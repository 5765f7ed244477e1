"""Which device a call runs on.

A leaf module: it imports only ``torch``, so the kernels, the metrics, the
engine and the layers above them all take ``resolve_device`` from here.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The scorer's device: "cpu" or a CUDA device that exists.  Nothing
    falls back: asking for CUDA without a card is an error."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev
