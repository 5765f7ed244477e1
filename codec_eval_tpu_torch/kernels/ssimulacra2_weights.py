"""SSIMULACRA2 v2.1 feature weights (a copy of the JAX package's table;
``tests/test_torch_package.py`` holds the two equal).

The score is a weighted sum of 108 features: 3 channels (X, Y, B) x 6 scales
x 2 norms (1-norm mean, 4-norm) x 3 maps (ssim, ringing-artifact,
detail-loss), indexed channel-major exactly as the public SSIMULACRA 2.1
scorer does:

    i = 0
    for c in range(3):
      for scale in range(6):
        for n in range(2):
          w[i] * |ssim[c, scale, n]|       ; i += 1
          w[i] * |artifact[c, scale, n]|   ; i += 1
          w[i] * |detail_lost[c, scale, n]|; i += 1

This table is a reconstruction of the published SSIMULACRA 2.1 weight vector
(public algorithm, Cloudinary/libjxl tools).  The dominant-mass entries are
faithful; low-magnitude tail entries marked below are approximate (see
``codec_eval_tpu/kernels/ssimulacra2_weights.py`` for their history).  A
refinement edits both tables together.  The framework-level contract (identical
images score exactly 100.0, monotone degradation, range (-inf, 100]) holds
for any weight table.

reference (wrapper being replaced): src/metrics/ssimulacra2.rs:59-133.
"""

from __future__ import annotations

import numpy as np

# fmt: off
WEIGHTS_V21 = np.array([
    # ---- channel 0 (X) ----
    # scale 0
    0.0,                      # ssim     1-norm
    0.0007376606707406586,    # artifact 1-norm
    0.0,                      # detail   1-norm
    0.0,                      # ssim     4-norm
    0.0007793481682867309,    # artifact 4-norm
    0.0,                      # detail   4-norm
    # scale 1
    0.0,
    0.0004371155730107379,
    0.0,
    1.1041726426657346,
    0.00066284834129271,
    0.00015231632783718752,
    # scale 2
    0.0,
    0.0016406437456599754,
    0.0,
    1.8422455520539298,
    11.441172603757666,
    0.0,
    # scale 3
    0.0007989109436015163,
    0.000176816438078653,
    0.0,
    1.8787594979546387,
    10.94906990605142,
    0.0,
    # scale 4
    0.0007289346991508072,
    0.9677937080626833,
    0.0,
    0.0007407319987237005,    # (approx)
    0.9981766977854967,
    0.00031949755934435053,
    # scale 5
    0.0004550992113792063,
    0.0,
    0.0,
    0.0013648766163243398,
    0.0,
    0.0,
    # ---- channel 1 (Y) ----
    # scale 0
    0.0,
    0.0,
    0.0,
    0.0,
    7.466890328078848,
    0.0,
    # scale 1
    17.445833984131262,
    0.0006235601894272942,
    0.0,
    0.0,
    0.0,
    0.0,
    # scale 2
    0.0005916859736558598,
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    # scale 3
    0.0012910984319732507,    # (approx)
    0.0,
    0.0,
    2.8907847499812938,       # (approx magnitude; Y mid-scale 4-norm ssim)
    0.0,
    0.0,
    # scale 4
    0.0,
    0.0,
    0.0,
    1.0238417958609432,       # (approx)
    0.0,
    0.0,
    # scale 5
    0.0,
    0.0005095721538896831,
    0.0,
    0.0,
    0.0,
    0.0,
    # ---- channel 2 (B) ----
    # scale 0
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    # scale 1
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    # scale 2
    0.0008849696862167632,    # (approx)
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    # scale 3
    0.0,
    0.0,
    0.0,
    0.9234545885486922,       # (approx)
    0.0,
    0.0,
    # scale 4
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    0.0,
    # scale 5
    0.0,
    0.0012156797418836198,    # (approx)
    0.0,
    0.0,
    0.0,
    0.0,
], dtype=np.float64)
# fmt: on

if WEIGHTS_V21.shape != (108,):
    raise ValueError(f"WEIGHTS_V21 must hold 108 weights, has {WEIGHTS_V21.shape}")

#: Enumerated provenance of every approximate entry (index into WEIGHTS_V21,
#: feature it scales, measured score sensitivity).  All other nonzero entries
#: are believed faithful to the published v2.1 table; all zero entries are
#: structural (the published table zeroes most features).  Sensitivity is the
#: measured max |d score| for a +10% weight perturbation over JPEG q75/q90
#: pairs on 4 synthetic bases at 256px (tools/weight_sensitivity.py) — the
#: parity error each approximation can plausibly contribute scales linearly
#: with its relative error (e.g. a 2x-wrong w[57] shifts scores ~0.08 pts).
APPROX_ENTRIES = (
    # (index, "channel scale norm map", measured |dscore| @ +10%)
    (27, "X s4 4-norm ssim", "3e-6"),
    (54, "Y s3 1-norm ssim", "2e-6"),
    (57, "Y s3 4-norm ssim", "7.9e-3 (largest)"),
    (63, "Y s4 4-norm ssim", "4.9e-4"),
    (84, "B s2 1-norm ssim", "2.4e-5"),
    (93, "B s3 4-norm ssim", "7.7e-3"),
    (103, "B s5 1-norm artifact", "1e-6"),
)

# Final nonlinear mapping constants of the public v2.1 scorer:
#   s   = SCALE_FACTOR * sum_i w_i * |f_i|
#   v   = CUBIC_A*s^3 + CUBIC_B*s^2 + CUBIC_C*s
#   out = 100 - 10 * v^POWER   (v > 0, else 100)
SCALE_FACTOR = 0.9562382616834844
CUBIC_A = 6.248496625763138e-05
CUBIC_B = -0.020884521182843837
CUBIC_C = 2.326765642916932
POWER = 0.6276336467831387
