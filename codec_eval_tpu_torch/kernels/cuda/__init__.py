"""Hand-written Hopper kernels (``csrc/*.cu``) and their PyTorch wrappers.

Each wrapper launches its kernel on CUDA tensors, runs its plain PyTorch
version on CPU tensors, raises on any other device, and counts its launches
in a ``launches`` attribute.  ``source`` names its CUDA file and
``replaces`` the Pallas kernel of the JAX package it ports.

K10 (``jpeg_trellis.trellis_dp``, the device JPEG encoder's trellis DP)
replaces no Pallas kernel, so it is not in ``WRAPPERS``: it launches on
CUDA tensors alone, and ``kernels.jpeg_enc.trellis_quantize_dev`` takes
it or the plain version beside it by device.  ``LAUNCHERS`` holds every
launch counter, K10's with the wrappers'.
"""

from .blur import blur_batch
from .freqsep import bands_batch, opsin_xyb_batch
from .jpeg_trellis import trellis_dp
from .malta import malta_ac_batch, malta_diffmap_batch
from . import scale_features  # the module: K8's wrapper shares its name
from .maskac import mask_diff_ac_batch
from .moments import candidate_moments, reference_moments
from .scale_features import scale_features_batch

#: Every kernel wrapper of the port, by kernel name.  Two are a second form
#: of another's kernel: K8 (K1 at N = 1) and K9's one-input reference form.
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
    "reference_moments": reference_moments,
}

#: Every launcher of a hand-written kernel, by kernel name: the wrappers
#: and K10's, with a ``launches`` counter and a ``source`` each.
LAUNCHERS = {**WRAPPERS, "trellis_dp": trellis_dp}
