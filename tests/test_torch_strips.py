"""The row-streamed strip kernels' grid and compile-time shapes, on the CPU.

K1 (``csrc/scale_features.cu``, and K8, the same kernel at N = 1), K2 and
K3 (``csrc/freqsep.cu`` ``opsin_kernel``, ``bands_kernel``) and K9
(``csrc/moments.cu``, on K1's walk in ``moments.cuh``) give each block a
strip of ``_lib.STRIP`` output columns and a segment of rows that the
wrapper chooses.  No ``nvcc`` or card is needed to check that:

- the blocks of a plane, in the kernels' block order (segment-major, then
  strip; K9 strip fastest, then plane, then segment, or its tile grid for
  small launches) for the segment lengths the wrappers choose, cover every
  output pixel once, for ragged sizes and for B = 1;
- K2's, K3's and K9's segments keep two waves of blocks where the image
  allows it, and K1's depend on the plane's height only, so its partial
  sums (one set per block) do not depend on the number of candidates;
- K9's values do not depend on its segment: a model of its walk (steps,
  row groups, register windows, quads) in numpy equals the plain version
  bit for bit for every segment length;
- the radii and strip widths compiled into the sources equal the taps the
  wrappers pass (``_taps(SIGMA_SURROUND)``, ``_taps(SIGMA_MF)``,
  ``_taps(SIGMA_UHF)``, ``gaussian_taps(1.5)``) and ``_lib.STRIP``;
- K1's wrapper leaves the sums and norms to the kernel;
- K6 and K7 (``csrc/blur.cu``), on the same walk at the blur's radius:
  their blocks cover every output once, every row of a segment is made
  once at radii 1 to 16, their segments fill the card on the path and
  depend on the launch only, a numpy model of their walk equals the plain
  versions bit for bit at every segment length and radius, the radii
  compiled into the source cover the wrappers' taps, and the wrappers
  refuse bad arguments before touching the library.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels.ssimulacra2 import NUM_SCALES
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels.cuda import _lib
from codec_eval_tpu_torch.kernels.cuda import blur as tbl
from codec_eval_tpu_torch.kernels.cuda import freqsep as tfs
from codec_eval_tpu_torch.kernels.cuda import maskac as tmk
from codec_eval_tpu_torch.kernels.cuda import moments as tmo
from codec_eval_tpu_torch.kernels.cuda import scale_features as tsf

H100_SMS = 132
SHAPES = [(37, 53), (67, 653), (36, 52), (101, 300), (261, 131), (16, 16), (8, 8),
          (512, 512), (1365, 2048), (2048, 2048)]


RAGGED = [(101, 300), (261, 131), (16, 16), (8, 8)]


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


def opsin_tiles(b: int, h: int, w: int, seg: int) -> list:
    """K2's output rectangles ``(img, y0, y1, x0, x1)`` in its block order:
    image fastest, then strip, then segment."""
    strips, segments = -(-w // _lib.STRIP), -(-h // seg)
    tiles = []
    for bid in range(b * strips * segments):
        img, tile = bid % b, bid // b
        y0, x0 = tile // strips * seg, tile % strips * _lib.STRIP
        tiles.append((img, y0, min(y0 + seg, h), x0, min(x0 + _lib.STRIP, w)))
    return tiles


def moments_tiles(planes: int, h: int, w: int, walk: int, seg: int = 0) -> list:
    """K9's output rectangles ``(plane, y0, y1, x0, x1)`` in its block
    order: the strip walk runs strip fastest, then plane, then segment of
    ``seg`` rows; the tile walk takes a 32x16 tile per block, planes last."""
    tiles = []
    if walk == tmo.TILE_WALK:
        tw, th = constant("moments.cu", "TW"), constant("moments.cu", "TH")
        for p in range(planes):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    tiles.append((p, y0, min(y0 + th, h), x0, min(x0 + tw, w)))
        return tiles
    strips, segments = -(-w // _lib.STRIP), -(-h // seg)
    for bid in range(planes * strips * segments):
        strip, p, segment = bid % strips, bid // strips % planes, bid // strips // planes
        y0, x0 = segment * seg, strip * _lib.STRIP
        tiles.append((p, y0, min(y0 + seg, h), x0, min(x0 + _lib.STRIP, w)))
    return tiles


def assert_planes_covered(tiles: list, planes: int, h: int, w: int, rows: int, cols: int):
    by_plane = {}
    for p, y0, y1, x0, x1 in tiles:
        assert 0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w
        assert y1 - y0 <= rows and x1 - x0 <= cols
        by_plane.setdefault(p, []).append((y0, y1, x0, x1))
    assert sorted(by_plane) == list(range(planes))
    for rects in by_plane.values():
        covered = np.zeros((h, w), np.int8)
        for y0, y1, x0, x1 in rects:
            covered[y0:y1, x0:x1] += 1
        assert (covered == 1).all()


LAYOUT_SHAPES = RAGGED + [(512, 512), (1365, 2048)]


@pytest.mark.parametrize("b", [1, 2, 10, 25])
@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_opsin_blocks_cover_each_pixel_once(shape, b):
    h, w = shape
    seg = tfs.opsin_segment_rows(b, h, w, H100_SMS)
    assert seg in tfs.OPSIN_SEGMENTS
    assert_planes_covered(opsin_tiles(b, h, w, seg), b, h, w, seg, _lib.STRIP)


@pytest.mark.parametrize("b", [1, 2, 10, 25])
@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moments_blocks_cover_each_pixel_once(shape, b):
    h, w = shape
    planes = 3 * b
    walk = tmo.launch_walk(planes, h, w)
    assert (walk == tmo.TILE_WALK) == (planes * h * w <= tmo.TILE_MAX_WORK)
    for walk, seg, rows, cols in ((tmo.STRIP_WALK, tmo.segment_rows(planes, h, w, H100_SMS),
                                   None, _lib.STRIP), (tmo.TILE_WALK, 0, 16, 32)):
        assert walk == tmo.TILE_WALK or seg in tmo.SEGMENTS
        assert_planes_covered(moments_tiles(planes, h, w, walk, seg), planes, h, w,
                              rows or seg, cols)


def group_steps(radius: int, rows_per_group: int, seg: int, h: int, y0: int) -> list:
    """The output rows that a strip walk's steps complete, in order: step s
    of the segment at y0 reads input row y0 - radius + s and completes
    output row y0 - 2 * radius + s, kept where it lies in the segment."""
    steps = seg + 2 * radius
    groups = -(-steps // rows_per_group)
    y_end = min(y0 + seg, h)
    out = []
    for s in range(groups * rows_per_group):
        y = y0 - 2 * radius + s
        if y0 <= y < y_end:
            out.append(y)
    return out


@pytest.mark.parametrize("seg", [1, 4, 8, 16, 32, 64, 128])
def test_walks_complete_each_row_of_a_segment_once(seg):
    """K2 (radius 2, groups of RG2 rows) and K1/K9 (radius 7, groups of RG
    rows): every row of every segment once, in order, for ragged heights."""
    rg2 = constant("common.cuh", "kStripThreads") // 32
    for radius, rg in ((constant("freqsep.cu", "OR"), rg2),
                       (constant("moments.cuh", "R"), constant("moments.cuh", "RG"))):
        for h in (8, 37, 261, 300):
            for y0 in range(0, h, seg):
                assert group_steps(radius, rg, seg, h, y0) == list(range(y0, min(y0 + seg, h)))


def test_opsin_stage_b_takes_each_output_of_a_group_once():
    """One row of the group per warp (RG2 = kStripThreads / 32), each lane
    the columns lane + 32 k."""
    src = (_lib.CSRC / "freqsep.cu").read_text()
    assert "constexpr int RG2 = ce::kStripThreads / 32;" in src
    assert "constexpr int PIX2 = ce::kStrip / 32;" in src
    threads = constant("common.cuh", "kStripThreads")
    rg, pix = threads // 32, _lib.STRIP // 32
    taken = [(tid // 32, tid % 32 + 32 * k) for tid in range(threads) for k in range(pix)]
    assert sorted(taken) == [(i, o) for i in range(rg) for o in range(_lib.STRIP)]


def test_moments_stage_b_takes_each_output_of_a_group_once():
    quad, parts, rg = (constant("moments.cuh", n) for n in ("QUAD", "PARTS", "RG"))
    quads = _lib.STRIP // quad
    taken = [(i, quad * (tid % quads) + p) for tid in range(parts * quads)
             for i in range(tid // quads, rg, parts) for p in range(quad)]
    assert sorted(taken) == [(i, o) for i in range(rg) for o in range(_lib.STRIP)]


def test_opsin_segments_fill_the_card():
    min_blocks = tfs.OPSIN_MIN_BLOCKS_PER_SM * H100_SMS

    def blocks(b, h, w):
        return len(opsin_tiles(b, h, w, tfs.opsin_segment_rows(b, h, w, H100_SMS)))

    # The batch path (2048 px B=10, 1024 and 512 px) and one 2048 px image
    # take the longest segments and still fill the card.
    for b, h, w in ((10, 2048, 2048), (10, 1024, 1024), (25, 512, 512), (1, 2048, 2048)):
        assert tfs.opsin_segment_rows(b, h, w, H100_SMS) == tfs.OPSIN_SEGMENTS[0]
        assert blocks(b, h, w) >= min_blocks
    # One 512 px image (a single pair) takes short segments, and its
    # 256 px half one-row segments: more blocks than SMs, where the longest
    # segments would give four and two.
    assert tfs.opsin_segment_rows(1, 512, 512, H100_SMS) == 4
    assert blocks(1, 512, 512) >= min_blocks
    assert tfs.opsin_segment_rows(1, 256, 256, H100_SMS) == tfs.OPSIN_SEGMENTS[-1] == 1
    assert blocks(1, 256, 256) >= min_blocks
    # Each choice is the longest that fills the card, or the shortest.
    for b, h, w in ((25, 256, 256), (1, 1024, 1024), (2, 261, 131), (1, 256, 256)):
        seg = tfs.opsin_segment_rows(b, h, w, H100_SMS)
        longer = [r for r in tfs.OPSIN_SEGMENTS if r > seg]
        assert all(len(opsin_tiles(b, h, w, r)) < min_blocks for r in longer)
        assert seg == tfs.OPSIN_SEGMENTS[-1] or blocks(b, h, w) >= min_blocks


def test_moments_segments_fill_the_card_and_depend_on_the_launch_only():
    assert list(inspect.signature(tmo.segment_rows).parameters) == ["planes", "h", "w", "sms"]
    assert list(inspect.signature(tmo.launch_walk).parameters) == ["planes", "h", "w"]
    min_blocks = tmo.MIN_BLOCKS_PER_SM * H100_SMS

    def blocks(planes, h, w, seg):
        return len(moments_tiles(planes, h, w, tmo.STRIP_WALK, seg))

    # The masked path's top scales take the strip walk's longest segments
    # and fill the card: the 2048x2048 and 2048x1408 buckets (N = 2), the
    # 512 bucket (N = 8).
    for planes, h, w in ((6, 2048, 2048), (6, 2048, 1408), (24, 512, 512), (6, 1024, 1024)):
        seg = tmo.segment_rows(planes, h, w, H100_SMS)
        assert tmo.launch_walk(planes, h, w) == tmo.STRIP_WALK
        assert seg == tmo.SEGMENTS[0] and blocks(planes, h, w, seg) >= min_blocks
    # Smaller launches: the longest segment that fills the card.
    for planes, h, w in ((6, 512, 512), (24, 256, 256), (6, 896, 896), (6, 384, 640)):
        seg = tmo.segment_rows(planes, h, w, H100_SMS)
        assert tmo.launch_walk(planes, h, w) == tmo.STRIP_WALK
        assert seg in tmo.SEGMENTS and blocks(planes, h, w, seg) >= min_blocks
        assert all(blocks(planes, h, w, r) < min_blocks for r in tmo.SEGMENTS if r > seg)
    # The smallest launches take the tile walk.
    for planes, h, w in ((6, 256, 256), (24, 128, 128), (24, 16, 16), (6, 64, 64)):
        assert planes * h * w <= tmo.TILE_MAX_WORK
        assert tmo.launch_walk(planes, h, w) == tmo.TILE_WALK
    assert tmo.segment_rows(6, 128, 128, H100_SMS) == tmo.SEGMENTS[-1]


@pytest.mark.parametrize("blocks_per_segment, h, want", [
    (10, 64, 64),   # one segment of 10 blocks fills 2.5 x 4: the longest
    (10, 100, 64),
    (4, 100, 32),   # 8 blocks with 64 rows, 16 with 32
    (2, 80, 16),    # 6 blocks with 32 rows, 10 with 16
    (2, 64, 8),     # 8 blocks with 16 rows, 16 with 8
    (1, 40, 8),     # never enough: the shortest
])
def test_segment_rule_takes_the_longest_choice_that_fills_the_card(blocks_per_segment, h, want):
    assert _lib.segment_rows(blocks_per_segment, h, (64, 32, 16, 8), 2.5, 4) == want


def test_k2_k3_and_k9_share_one_segment_rule():
    for fn in (tfs.opsin_segment_rows, tfs.bands_segment_rows, tmo.segment_rows):
        assert "_lib.segment_rows(" in inspect.getsource(fn), fn.__name__
    for b, h, w in ((10, 2048, 2048), (1, 512, 512), (2, 261, 131)):
        strips = b * -(-w // _lib.STRIP)
        assert tfs.opsin_segment_rows(b, h, w, H100_SMS) == _lib.segment_rows(
            strips, h, tfs.OPSIN_SEGMENTS, tfs.OPSIN_MIN_BLOCKS_PER_SM, H100_SMS)
        assert tfs.bands_segment_rows(b, h, w, H100_SMS) == _lib.segment_rows(
            strips, h, tfs.BANDS_SEGMENTS, tfs.BANDS_WAVES * tfs.BANDS_BLOCKS_PER_SM, H100_SMS)
        assert tmo.segment_rows(3 * b, h, w, H100_SMS) == _lib.segment_rows(
            3 * strips, h, tmo.SEGMENTS, tmo.MIN_BLOCKS_PER_SM, H100_SMS)


def test_compiled_walks_equal_the_wrappers_walks():
    src = (_lib.CSRC / "moments.cu").read_text()
    m = re.search(r"enum Walk : int \{ kStripWalk = (\d+), kTileWalk = (\d+) \};", src)
    assert m and (int(m.group(1)), int(m.group(2))) == (tmo.STRIP_WALK, tmo.TILE_WALK)
    # seg means rows per segment of the strip walk and nothing else.
    assert "seg == 0" not in src and "seg <= 0" in src


def k9_walk_model(x1: np.ndarray, x2, seg: int) -> np.ndarray:
    """K9's strip walk on one (h, w) plane, in numpy f32: per block the
    steps and row groups, the 15-row windows of the moments per grown
    column, and the horizontal pass at the block's outputs.  ``x2`` None:
    the reference form."""
    taps = [np.float32(t) for t in tmo.gaussian_taps(tmo.SIGMA)]
    r, rg, strip = constant("moments.cuh", "R"), constant("moments.cuh", "RG"), _lib.STRIP
    k = 2 * r + 1
    h, w = x1.shape
    nm = 2 if x2 is None else 3
    out = np.full((nm, h, w), np.nan, np.float32)

    def fir(x, n):
        """n outputs along axis 1 of (nm, k + n - 1, ...), taps in order."""
        acc = taps[0] * x[:, 0:n]
        for i in range(1, k):
            acc = acc + taps[i] * x[:, i : i + n]
        return acc

    for y0 in range(0, h, seg):
        y_end = min(y0 + seg, h)
        for x0 in range(0, w, strip):
            x_end = min(x0 + strip, w)
            gx = x0 - r + np.arange(strip + 2 * r)
            col_in = (gx >= 0) & (gx < w)
            win = np.zeros((nm, k, strip + 2 * r), np.float32)
            groups = -(-(seg + 2 * r) // rg)
            for s in range(groups * rg):
                row = y0 - r + s
                inside = col_in & (0 <= row < h)
                src = np.clip(gx, 0, w - 1)
                xa = np.where(inside, x1[min(max(row, 0), h - 1), src], np.float32(0))
                if x2 is None:
                    new = [xa, xa * xa]
                else:
                    xb = np.where(inside, x2[min(max(row, 0), h - 1), src], np.float32(0))
                    new = [xb, xb * xb, xa * xb]
                win[:, :-1] = win[:, 1:]
                win[:, -1] = new
                v = fir(win, 1)[:, 0]  # (nm, grown columns)
                y = y0 - 2 * r + s
                if y0 <= y < y_end:
                    out[:, y, x0:x_end] = fir(v, strip)[:, : x_end - x0]
    return out


@pytest.mark.parametrize("shape", [(37, 53), (70, 150)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_moments_values_do_not_depend_on_the_segment(shape):
    rng = np.random.default_rng(sum(shape))
    x1 = rng.random((3,) + shape, dtype=np.float32)
    x2 = rng.random((3,) + shape, dtype=np.float32)
    cand = torch.stack(tmo.candidate_moments_plain(torch.from_numpy(x1), torch.from_numpy(x2)))
    ref = torch.stack(tmo.reference_moments_plain(torch.from_numpy(x1)))
    for seg in tmo.SEGMENTS:
        for c in range(3):
            got = k9_walk_model(x1[c], x2[c], seg)
            np.testing.assert_array_equal(got, cand[:, c].numpy())
            got = k9_walk_model(x1[c], None, seg)
            np.testing.assert_array_equal(got, ref[:, c].numpy())


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
    assert 2 * constant("freqsep.cu", "OR") + 1 == len(tfs._taps(tfs.SIGMA_SURROUND))
    assert 2 * constant("freqsep.cu", "R1") + 1 == len(tfs._taps(tfs.SIGMA_MF))
    assert 2 * constant("freqsep.cu", "R2") + 1 == len(tfs._taps(tfs.SIGMA_UHF))
    assert 2 * constant("moments.cuh", "R") + 1 == len(tsf.gaussian_taps(tsf.SIGMA))
    assert 2 * constant("moments.cuh", "R") + 1 == len(tmo.gaussian_taps(tmo.SIGMA))
    assert tsf.SIGMA == tmo.SIGMA == 1.5
    # K9's tile walk for small launches.
    assert (constant("moments.cu", "TW"), constant("moments.cu", "TH")) == (32, 16)


def test_compiled_strip_equals_the_wrappers_strip():
    assert constant("common.cuh", "kStrip") == _lib.STRIP == tsf.STRIP
    threads = constant("common.cuh", "kStripThreads")
    # One thread per grown column in the vertical passes, and K1's
    # quarter-interleaved rows wide enough for its grown strip.
    halo3 = constant("freqsep.cu", "R1") + constant("freqsep.cu", "R2")
    grown3 = _lib.STRIP + 2 * halo3
    grown1 = _lib.STRIP + 2 * constant("moments.cuh", "R")
    grown2 = _lib.STRIP + 2 * constant("freqsep.cu", "OR")
    quad = constant("moments.cuh", "QUAD")
    assert threads % 32 == 0 and max(grown3, grown1, grown2) <= threads
    assert grown1 <= quad * constant("moments.cuh", "kQuarter")
    assert _lib.STRIP % quad == 0
    # K2's stage B: one row of a group per warp, four columns per lane.
    assert _lib.STRIP % 32 == 0
    # K1's and K9's stage B: four parts of the group's rows, 32 quads each.
    parts = constant("moments.cuh", "PARTS")
    assert constant("moments.cuh", "RG") % parts == 0
    assert parts * _lib.STRIP // quad <= threads


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


# ------------------------------------------------ K6 and K7 on the strip walk
#
# K6 (``blur_kernel``) and K7 (``mask_diff_ac_kernel``) in ``csrc/blur.cu``
# run the walk of ``moments.cuh`` at the blur's radius (form kBlur): the
# block order of K9's strip walk (strip fastest, then plane, then segment),
# the segment chosen by ``blur.segment_rows`` from the launch alone.

BLUR_KERNELS = [("K6", 1), ("K6", 3), ("K7", 1)]  # (kernel, channels per image)
BLUR_RADII = [1, 6, 7, 16]


def blur_source() -> str:
    return (_lib.CSRC / "blur.cu").read_text()


@pytest.mark.parametrize("b", [1, 2, 10, 25])
@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kernel, channels", BLUR_KERNELS, ids=lambda k: str(k))
def test_blur_blocks_cover_each_pixel_once(kernel, channels, shape, b):
    h, w = shape
    planes = b * channels
    seg = tbl.segment_rows(planes, h, w, H100_SMS)
    assert seg in tbl.SEGMENTS
    assert_planes_covered(moments_tiles(planes, h, w, tmo.STRIP_WALK, seg), planes, h, w, seg,
                          _lib.STRIP)


def test_blur_kernels_decode_blocks_as_the_strip_walk():
    """One block per (strip, plane, segment), strip fastest: the decode that
    ``moments_tiles`` models, and a grid of exactly that many blocks."""
    src = blur_source()
    for line in ("const int strip = blockIdx.x % strips;",
                 "const int p = blockIdx.x / strips % planes;",
                 "const int segment = blockIdx.x / strips / planes;",
                 "const int x0 = strip * ce::kStrip, y0 = segment * seg;"):
        assert line in src
    assert ("(long long)planes * ((w + ce::kStrip - 1) / ce::kStrip) *\n"
            "                           ((h + seg - 1) / seg);") in src
    assert src.count("strip_walk<kBlur>(") == 1  # K6 and K7 share one block body


@pytest.mark.parametrize("seg", tbl.SEGMENTS)
@pytest.mark.parametrize("radius", BLUR_RADII)
def test_blur_walk_completes_each_row_of_a_segment_once(radius, seg):
    """The walk at radius R (groups of RG rows): every row of every segment
    once, in order, for ragged heights."""
    rg = constant("moments.cuh", "RG")
    for h in (8, 37, 261, 300):
        for y0 in range(0, h, seg):
            assert group_steps(radius, rg, seg, h, y0) == list(range(y0, min(y0 + seg, h)))


#: The launches of the path: K6 on the batch path's 2048 and 1024 px masks
#: (B = 10), K7 on one pair at 2048, 1024, 512 and 256 px.
BLUR_PATH_LAUNCHES = [(10, 2048, 2048), (10, 1024, 1024), (1, 2048, 2048), (1, 1024, 1024),
                      (1, 512, 512), (1, 256, 256)]


@pytest.mark.parametrize("planes, h, w", BLUR_PATH_LAUNCHES, ids=lambda v: str(v))
def test_blur_segments_fill_the_card_on_the_path(planes, h, w):
    """Each launch of the path takes the longest segment whose grid gives
    every SM MIN_BLOCKS_PER_SM blocks, or the shortest segment where none
    does (one 256 px plane: 128 blocks of 4 rows)."""
    seg = tbl.segment_rows(planes, h, w, H100_SMS)
    min_blocks = tbl.MIN_BLOCKS_PER_SM * H100_SMS

    def blocks(rows):
        return len(moments_tiles(planes, h, w, tmo.STRIP_WALK, rows))

    assert seg == tbl.SEGMENTS[-1] or blocks(seg) >= min_blocks
    assert all(blocks(r) < min_blocks for r in tbl.SEGMENTS if r > seg)


def test_blur_segments_of_the_path():
    """The choices measured on the card: K6's 2048 and 1024 px batches of
    10 take 256- and 128-row segments; one image (K7) takes 64 rows at
    2048 px down to 4 at 512 and 256 px, and from 512 px up its grid gives
    every SM at least two blocks."""
    assert tbl.MIN_BLOCKS_PER_SM >= 2
    want = {(10, 2048, 2048): 256, (10, 1024, 1024): 128, (1, 2048, 2048): 64,
            (1, 1024, 1024): 16, (1, 512, 512): 4, (1, 256, 256): 4}
    assert {launch: tbl.segment_rows(*launch, H100_SMS) for launch in want} == want
    for planes, h, w in ((1, 2048, 2048), (1, 1024, 1024), (1, 512, 512)):
        seg = tbl.segment_rows(planes, h, w, H100_SMS)
        assert len(moments_tiles(planes, h, w, tmo.STRIP_WALK, seg)) >= 2 * H100_SMS


def test_blur_segments_depend_on_the_launch_only():
    assert list(inspect.signature(tbl.segment_rows).parameters) == ["planes", "h", "w", "sms"]
    assert "_lib.segment_rows(" in inspect.getsource(tbl.segment_rows)
    assert list(tbl.SEGMENTS) == sorted(tbl.SEGMENTS, reverse=True) and tbl.SEGMENTS[-1] >= 1
    for planes, h, w in ((10, 2048, 2048), (1, 512, 512), (2, 261, 131), (75, 1365, 2048)):
        assert tbl.segment_rows(planes, h, w, H100_SMS) == _lib.segment_rows(
            planes * -(-w // _lib.STRIP), h, tbl.SEGMENTS, tbl.MIN_BLOCKS_PER_SM, H100_SMS)
    # The wrappers take it from the plan of the launch: planes, h, w, sigma, device.
    assert list(inspect.signature(tbl.plan).parameters) == [
        "entry", "planes", "h", "w", "sigma", "device"]
    for fn in (tbl._launch, tmk._launch):
        assert "plan(" in inspect.getsource(fn)


def compiled_blur_radii() -> list:
    block = re.search(r"#define CE_RADIUS_CASES\(CALL\)(.*?)return \(int\)cudaErrorInvalidValue;",
                      blur_source(), re.S)
    assert block
    cases = [int(c) for c in re.findall(r"case (\d+): return \(int\)CALL\(\1\);", block.group(1))]
    assert cases and cases == sorted(set(cases))
    return cases


@pytest.mark.parametrize("sigma", [0.5, tba.SIGMA_MASK, tba.SIGMA_LF])
def test_compiled_blur_radii_equal_the_wrappers_taps(sigma):
    """K6 and K7 are instantiated at every radius 1..16; the path's sigma
    2.7 takes radius 6 and the largest sigma the kernel takes (7.16, the LF
    blur) radius 16, which the walk's static_asserts admit."""
    radii = compiled_blur_radii()
    assert radii == list(range(1, constant("blur.cu", "kMaxRadius") + 1))
    assert 2 * radii[-1] + 1 == tbl.MAX_TAPS
    assert len(tbl._host_taps(sigma)) // 2 in radii
    assert len(tbl._host_taps(tba.SIGMA_MASK)) == 2 * 6 + 1


def test_radius_16_meets_the_walks_static_asserts():
    src = (_lib.CSRC / "moments.cuh").read_text()
    assert "static constexpr int G = kStrip + 2 * RAD;" in src
    assert "static_assert(RAD >= 1 && G <= kStripThreads && G <= QUAD * kQuarter, \"\");" in src
    assert "static_assert(Radius<kMaxRadius>::G <= ce::kStripThreads" in blur_source()
    grown = constant("common.cuh", "kStrip") + 2 * constant("blur.cu", "kMaxRadius")
    assert grown <= constant("common.cuh", "kStripThreads")
    assert grown <= constant("moments.cuh", "QUAD") * constant("moments.cuh", "kQuarter")
    # K1 and K9 keep radius 7.
    assert constant("moments.cuh", "R") == 7
    assert "template <int FORM, int RAD = R>\nstruct StripSmem" in src


def blur_walk_model(x: np.ndarray, sigma: float, seg: int) -> np.ndarray:
    """K6's strip walk on one (h, w) plane, in numpy f32: per block the
    steps and row groups, each grown column's window of 2R + 1 input rows,
    the horizontal pass at the block's outputs, times the reciprocal plane."""
    taps = [np.float32(t) for t in tbl._host_taps(sigma)]
    k = len(taps)
    r, rg, strip = k // 2, constant("moments.cuh", "RG"), _lib.STRIP
    h, w = x.shape
    recip = tfs._recip_norm_np(h, w, sigma)
    out = np.full((h, w), np.nan, np.float32)

    def fir(v, n):
        """n outputs along axis 0 of (k + n - 1, ...), taps in order."""
        acc = taps[0] * v[0:n]
        for i in range(1, k):
            acc = acc + taps[i] * v[i : i + n]
        return acc

    for y0 in range(0, h, seg):
        y_end = min(y0 + seg, h)
        for x0 in range(0, w, strip):
            x_end = min(x0 + strip, w)
            gx = x0 - r + np.arange(strip + 2 * r)
            col_in = (gx >= 0) & (gx < w)
            src = np.clip(gx, 0, w - 1)
            win = np.zeros((k, strip + 2 * r), np.float32)
            for s in range(-(-(seg + 2 * r) // rg) * rg):
                row = y0 - r + s
                win[:-1] = win[1:]
                win[-1] = np.where(col_in & (0 <= row < h), x[min(max(row, 0), h - 1), src],
                                   np.float32(0))
                y = y0 - 2 * r + s
                if y0 <= y < y_end:
                    v = fir(win, 1)[0]
                    out[y, x0:x_end] = fir(v, strip)[: x_end - x0] * recip[y, x0:x_end]
    return out


@pytest.mark.parametrize("shape", [(37, 53), (70, 150)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sigma", [0.5, tba.SIGMA_MASK, tba.SIGMA_LF])
def test_blur_values_do_not_depend_on_the_segment(sigma, shape):
    """The walk gives K6's plain version bit for bit at every segment
    length, and K7's mask term on it is K7's plain version."""
    rng = np.random.default_rng(sum(shape) + int(10 * sigma))
    x = (rng.random((2,) + shape, dtype=np.float32) * 10).astype(np.float32)
    b0 = torch.from_numpy(rng.random(shape, dtype=np.float32) * 10)
    want = tbl.blur_batch_plain(torch.from_numpy(x)[:, None], sigma)[:, 0]
    mask = tmk.mask_diff_ac_plain(torch.from_numpy(x), b0, tba._MASK_DIFF_AC_MUL, sigma)
    for seg in tbl.SEGMENTS:
        got = torch.from_numpy(np.stack([blur_walk_model(p, sigma, seg) for p in x]))
        assert torch.equal(got, want), seg
        d = b0 - got
        assert torch.equal((tba._MASK_DIFF_AC_MUL * d) * d, mask), seg


class FakeCuda:
    """A tensor that claims to lie on the first CUDA device."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.float32, contiguous=True):
        self.shape, self.dtype, self._contiguous = torch.Size(shape), dtype, contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous

    def get_device(self):
        return 0


@pytest.mark.parametrize("call, error, match", [
    (lambda: tbl.blur_batch(FakeCuda((2, 16, 16)), 2.7), ValueError, "shape"),
    (lambda: tbl.blur_batch(FakeCuda((2, 1, 16, 16), torch.float64), 2.7), TypeError, "float32"),
    (lambda: tbl.blur_batch(FakeCuda((2, 1, 16, 16), contiguous=False), 2.7), ValueError,
     "contiguous"),
    (lambda: tbl.blur_batch(FakeCuda((2, 1, 16, 16)), 7.6), ValueError, "at most 33 taps"),
    (lambda: tmk.mask_diff_ac_batch(FakeCuda((1, 16, 16)), FakeCuda((16, 17)), 1.0),
     ValueError, "shape"),
    (lambda: tmk.mask_diff_ac_batch(FakeCuda((16, 16)), FakeCuda((16, 16)), 1.0), ValueError,
     "shape"),
    (lambda: tmk.mask_diff_ac_batch(FakeCuda((1, 16, 16), torch.float16), FakeCuda((16, 16)),
                                    1.0), TypeError, "float32"),
    (lambda: tmk.mask_diff_ac_batch(FakeCuda((1, 16, 16)), torch.empty(16, 16, device="meta"),
                                    1.0), ValueError, "CUDA"),
    (lambda: tmk.mask_diff_ac_batch(FakeCuda((1, 16, 16)), FakeCuda((16, 16)), 1.0, 16.0),
     ValueError, "at most 33 taps"),
], ids=["k6-rank", "k6-dtype", "k6-layout", "k6-taps", "k7-b0-shape", "k7-rank", "k7-dtype",
        "k7-b0-device", "k7-taps"])
def test_blur_wrappers_refuse_bad_arguments(monkeypatch, call, error, match):
    """Each check raises before the library is built or loaded, and no
    launch is counted."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_lib, "load", no_library)
    before = (tbl.blur_batch.launches, tmk.mask_diff_ac_batch.launches)
    with pytest.raises(error, match=match):
        call()
    assert (tbl.blur_batch.launches, tmk.mask_diff_ac_batch.launches) == before
