"""The row-streamed strip kernels' grid and compile-time shapes, on the CPU.

K1 (``csrc/scale_features.cu``, and K8, the same kernel at N = 1) and K3
(``csrc/freqsep.cu`` ``bands_kernel``) give each block a strip of
``_lib.STRIP`` output columns and a segment of rows that the wrapper
chooses.  No ``nvcc`` or card is needed to check that:

- the blocks of a plane, in the kernels' block order (segment-major, then
  strip) for the segment lengths the wrappers choose, cover every output
  pixel once, for ragged sizes and for B = 1;
- K3's segments keep two waves of blocks where the image allows it, and
  K1's depend on the plane's height only, so its partial sums (one set per
  block) do not depend on the number of candidates;
- the radii and strip widths compiled into the sources equal the taps the
  wrappers pass (``_taps(SIGMA_MF)``, ``_taps(SIGMA_UHF)``,
  ``gaussian_taps(1.5)``) and ``_lib.STRIP``;
- K1's wrapper leaves the sums and norms to the kernel.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels.ssimulacra2 import NUM_SCALES
from codec_eval_tpu_torch.kernels.cuda import _lib
from codec_eval_tpu_torch.kernels.cuda import freqsep as tfs
from codec_eval_tpu_torch.kernels.cuda import scale_features as tsf

H100_SMS = 132
SHAPES = [(37, 53), (67, 653), (36, 52), (101, 300), (261, 131), (16, 16), (8, 8),
          (512, 512), (1365, 2048), (2048, 2048)]


def constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (_lib.CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def strip_tiles(h: int, w: int, seg: int) -> list:
    """The output rectangles ``(y0, y1, x0, x1)`` of one plane's blocks, as
    the kernels decode a block index: segment-major, then strip."""
    segments, strips = -(-h // seg), -(-w // _lib.STRIP)
    tiles = []
    for blk in range(segments * strips):
        y0, x0 = blk // strips * seg, blk % strips * _lib.STRIP
        tiles.append((y0, min(y0 + seg, h), x0, min(x0 + _lib.STRIP, w)))
    return tiles


def assert_tiles_cover(h: int, w: int, seg: int) -> None:
    covered = np.zeros((h, w), np.int32)
    for y0, y1, x0, x1 in strip_tiles(h, w, seg):
        assert 0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w
        assert y1 - y0 <= seg and x1 - x0 <= _lib.STRIP
        covered[y0:y1, x0:x1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("b", [1, 2, 10, 25])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bands_blocks_cover_each_pixel_once(shape, b):
    h, w = shape
    seg = tfs.bands_segment_rows(b, h, w, H100_SMS)
    assert seg in tfs.BANDS_SEGMENTS
    assert_tiles_cover(h, w, seg)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scale_features_blocks_cover_each_pixel_once(shape):
    h, w = shape
    seg = tsf.segment_rows(h)
    assert 16 <= seg <= 128
    assert_tiles_cover(h, w, seg)
    assert tsf.grid_blocks(h, w) == len(strip_tiles(h, w, seg))


def test_bands_segments_keep_two_waves_where_they_can():
    min_blocks = tfs.BANDS_WAVES * tfs.BANDS_BLOCKS_PER_SM * H100_SMS

    def blocks(b, h, w):
        return b * len(strip_tiles(h, w, tfs.bands_segment_rows(b, h, w, H100_SMS)))

    # The 2048 px batch of 10 takes the longest segments and still fills the card.
    assert tfs.bands_segment_rows(10, 2048, 2048, H100_SMS) == 256
    assert blocks(10, 2048, 2048) >= min_blocks
    assert blocks(25, 512, 512) >= min_blocks
    # One 512 px image (the reference side, a single pair) takes the
    # shortest segments, not a handful of blocks.
    assert tfs.bands_segment_rows(1, 512, 512, H100_SMS) == 32
    assert blocks(1, 512, 512) == 64
    # Longer segments only where the grid stays at least as large.
    for b, h, w in ((10, 1024, 1024), (25, 256, 256), (2, 261, 131)):
        seg = tfs.bands_segment_rows(b, h, w, H100_SMS)
        assert seg == 32 or blocks(b, h, w) >= min_blocks


def test_bands_segments_take_the_longest_choice_that_fills_the_grid():
    # 2048 px, B=10: 160 blocks per band of segments.
    assert tfs.bands_segment_rows(10, 2048, 2048, 132) == 256  # 1280 blocks
    assert tfs.bands_segment_rows(10, 2048, 2048, 214) == 128  # needs 1284
    assert tfs.bands_segment_rows(1, 100, 100, 132) == 32  # never enough
    assert tfs.bands_segment_rows(1, 400, 100, 1) == 64  # 7 of the 6 blocks needed


def test_scale_features_segments_depend_on_the_height_only():
    params = inspect.signature(tsf.segment_rows).parameters
    assert list(params) == ["h"]
    assert [tsf.segment_rows(h) for h in (8, 16, 64, 256, 512, 1024, 2048)] == [
        16, 16, 16, 32, 64, 128, 128]


@pytest.mark.parametrize("side", [2048, 512])
def test_scale_features_partials_follow_the_pyramid(side):
    """Six SSIMULACRA2 scales, halving down to 64 or 16 px: every scale gets
    at least one block per plane, and the top scale many."""
    sizes = [-(-side // 2 ** s) for s in range(NUM_SCALES)]
    blocks = [tsf.grid_blocks(n, n) for n in sizes]
    assert blocks[-1] >= 1 and blocks == sorted(blocks, reverse=True)
    assert blocks[0] == -(-side // _lib.STRIP) * -(-side // tsf.segment_rows(side))


def test_compiled_radii_equal_the_wrappers_taps():
    assert 2 * constant("freqsep.cu", "R1") + 1 == len(tfs._taps(tfs.SIGMA_MF))
    assert 2 * constant("freqsep.cu", "R2") + 1 == len(tfs._taps(tfs.SIGMA_UHF))
    assert 2 * constant("moments.cuh", "R") + 1 == len(tsf.gaussian_taps(tsf.SIGMA))
    assert tsf.SIGMA == 1.5


def test_compiled_strip_equals_the_wrappers_strip():
    assert constant("common.cuh", "kStrip") == _lib.STRIP == tsf.STRIP
    threads = constant("common.cuh", "kStripThreads")
    # One thread per grown column in the vertical passes, and K1's
    # quarter-interleaved rows wide enough for its grown strip.
    halo3 = constant("freqsep.cu", "R1") + constant("freqsep.cu", "R2")
    grown3 = _lib.STRIP + 2 * halo3
    grown1 = _lib.STRIP + 2 * constant("moments.cuh", "R")
    quad = constant("scale_features.cu", "QUAD")
    assert threads % 32 == 0 and max(grown3, grown1) <= threads
    assert grown1 <= quad * constant("scale_features.cu", "kQuarter")
    assert _lib.STRIP % quad == 0


def test_scale_features_wrapper_leaves_sums_and_norms_to_the_kernel():
    launch = inspect.getsource(tsf._launch)
    assert "ce_scale_features" in launch
    assert ".sum(" not in launch and "sqrt" not in launch
    assert not hasattr(tsf, "_norms")


def test_block_counters_are_cached_per_device_and_grow():
    dev = torch.device("meta")
    tsf._counters.pop(dev, None)
    first = tsf._counter(dev, 6)
    assert first.dtype == torch.int32 and first.numel() == 6
    assert tsf._counter(dev, 3) is first
    grown = tsf._counter(dev, 30)
    assert grown.numel() == 30 and tsf._counter(dev, 12) is grown
    tsf._counters.pop(dev)


def test_cpu_wrappers_run_the_plain_versions():
    rng = np.random.default_rng(7)
    xyb1 = torch.from_numpy(rng.random((3, 20, 24), np.float32))
    mu1 = tsf.blur_separable(xyb1, tsf.SIGMA)
    s11 = tsf.blur_separable(xyb1 * xyb1, tsf.SIGMA)
    xyb2 = xyb1 + 0.05 * torch.from_numpy(rng.random((2, 3, 20, 24), np.float32))
    before = (tsf.scale_features_batch.launches, tsf.scale_features.launches)
    assert torch.equal(tsf.scale_features_batch(xyb1, mu1, s11, xyb2),
                       tsf.scale_features_plain(xyb1, mu1, s11, xyb2))
    assert torch.equal(tsf.scale_features(xyb1, mu1, s11, xyb2[1]),
                       tsf.scale_features_plain(xyb1, mu1, s11, xyb2[1]))
    assert (tsf.scale_features_batch.launches, tsf.scale_features.launches) == before
