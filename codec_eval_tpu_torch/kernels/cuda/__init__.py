"""Hand-written Hopper kernels (``csrc/*.cu``) and their PyTorch wrappers.

Each wrapper launches its kernel on CUDA tensors, runs its plain PyTorch
version on CPU tensors, raises on any other device, and counts its launches
in a ``launches`` attribute.  ``source`` names its CUDA file and
``replaces`` the Pallas kernel of the JAX package it ports.
"""

from .freqsep import bands_batch, opsin_xyb_batch
from .malta import malta_ac_batch
from .scale_features import scale_features_batch

#: Every kernel wrapper of the port, by kernel name.
WRAPPERS = {
    "scale_features": scale_features_batch,
    "opsin_xyb": opsin_xyb_batch,
    "bands": bands_batch,
    "malta_ac": malta_ac_batch,
}
