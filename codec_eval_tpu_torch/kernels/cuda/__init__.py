"""Hand-written Hopper kernels (``csrc/*.cu``) and their PyTorch wrappers.

Each wrapper launches its kernel on CUDA tensors, runs its plain PyTorch
version on CPU tensors, raises on any other device, and counts its launches
in a ``launches`` attribute.  ``source`` names its CUDA file and
``replaces`` the Pallas kernel of the JAX package it ports.
"""

from .blur import blur_batch
from .freqsep import bands_batch, opsin_xyb_batch
from .malta import malta_ac_batch, malta_diffmap_batch
from . import scale_features  # the module: K8's wrapper shares its name
from .maskac import mask_diff_ac_batch
from .moments import candidate_moments
from .scale_features import scale_features_batch

#: Every kernel wrapper of the port, by kernel name.
WRAPPERS = {
    "scale_features": scale_features_batch,
    "opsin_xyb": opsin_xyb_batch,
    "bands": bands_batch,
    "malta_ac": malta_ac_batch,
    "malta_diffmap": malta_diffmap_batch,
    "blur": blur_batch,
    "mask_diff_ac": mask_diff_ac_batch,
    "scale_features_pair": scale_features.scale_features,
    "candidate_moments": candidate_moments,
}
