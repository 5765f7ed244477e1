"""Device rate accounting for the tpujpeg entropy coder.

Port of ``codec_eval_tpu/kernels/jpeg_rate.py``.  For a two-pass
optimized-Huffman scan (native/jpeg_entropy.cpp) the DC-category and AC
(run, size) symbol histograms fix the coder's Huffman tables (the host
rebuilds them with the same ITU T.81 K.2 construction) and the appended
bits (a DC symbol s carries s bits, an AC symbol ``sym & 15``), so the
entropy-coded size of a quality needs only its histograms off the device:
544 counts (1056 for the progressive script) instead of its coefficient
planes.  The one term they cannot give is 0xFF byte stuffing, estimated at
scan_bytes / 368, which leaves file sizes exact to about +-0.15% on average
(one file's stuffing varies more: up to ~0.45% on 512 px photo-like ladders).

The device half runs on the coefficients' device over a leading quality
axis: run lengths from a cumulative max over zigzag positions, and the
histograms counted in int64 with ``scatter_add_`` (JAX counts with an f32
one-hot matmul).  The host half is a copy of the JAX module's code, but
for baseline scan sizes, whose four tables per scan the port's host library
builds (``utils.native.jpeg_baseline_scan_bits``, one call for any number
of scans); ``t81_code_sizes``, the Python construction, sizes the
progressive script and is the tests' reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "PACKED_STATS_WIDTH",
    "PACKED_STATS_WIDTH_PROGRESSIVE",
    "ladder_rate_stats",
    "progressive_ladder_rate_stats",
    "t81_code_sizes",
    "scan_bits_from_hists",
    "baseline_size_estimate",
    "progressive_size_estimate",
    "progressive_size_estimates_from_packed",
    "size_estimates_from_packed",
]

#: Layout of one quality's packed rate statistics:
#: [dc_y (16) | dc_c (16) | ac_y (256) | ac_c (256)] = 544 counts.
PACKED_STATS_WIDTH = 544

#: Progressive layout: [dc_y 16 | dc_c 16 | ac_y_low 256 | ac_cb 256 |
#: ac_cr 256 | ac_y_high 256] = 1056 (Cb and Cr are separate scans that
#: share a table, so their histograms stay separate for per-scan bits).
PACKED_STATS_WIDTH_PROGRESSIVE = 1056


# -- device half --------------------------------------------------------------


def _category(v_abs: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude category (bit length) by exact integer compares."""
    c = torch.zeros(v_abs.shape, dtype=torch.int64, device=v_abs.device)
    for j in range(15):
        c += (v_abs >= (1 << j)).to(torch.int64)
    return c


def _count(values: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-row histogram of (n_q, ...) int64 values in [0, bins]; the value
    ``bins`` is the discard bin and is dropped."""
    flat = values.reshape(values.shape[0], -1)
    out = torch.zeros((flat.shape[0], bins + 1), dtype=torch.int64, device=values.device)
    out.scatter_add_(1, flat, torch.ones_like(flat))
    return out[:, :bins]


def _dc_hist(dc_plane: torch.Tensor, sv: int, sh: int) -> torch.Tensor:
    """(n_q, 16) histograms of DC difference categories of (n_q, by, bx)
    DC planes, in the scan's interleaved MCU order (block (my*sv+v,
    mx*sh+h) of MCU (my, mx)) so that the prediction chain is the coder's."""
    n_q, by, bx = dc_plane.shape
    d = dc_plane.to(torch.int64).reshape(n_q, by // sv, sv, bx // sh, sh)
    seq = d.permute(0, 1, 3, 2, 4).reshape(n_q, -1)
    diff = torch.cat([seq[:, :1], seq[:, 1:] - seq[:, :-1]], dim=1)
    return _count(_category(torch.abs(diff)), 16)


def _run_size_hist(band_abs: torch.Tensor, lo_pos: int, hi_pos: int) -> tuple:
    """(n_q, 256) histograms of (run<<4 | size) symbols plus ZRLs of
    (n_q, blocks, positions) magnitudes occupying zigzag positions
    [lo_pos, hi_pos], runs counted from lo_pos - 1.  Returns (hist, nz)."""
    dev = band_abs.device
    nz = band_abs > 0
    pos = torch.arange(lo_pos, hi_pos + 1, dtype=torch.int64, device=dev)
    marked = torch.where(nz, pos, torch.full_like(pos, lo_pos - 1))
    prev_inc = torch.cummax(marked, dim=-1).values
    prev = torch.cat([torch.full_like(prev_inc[..., :1], lo_pos - 1), prev_inc[..., :-1]], dim=-1)
    run = pos - prev - 1  # valid where nz
    zrl = torch.where(nz, run >> 4, torch.zeros_like(run)).reshape(run.shape[0], -1).sum(dim=1)
    sym = torch.where(nz, ((run & 15) << 4) | _category(band_abs), torch.full_like(run, 256))
    hist = _count(sym, 256)
    hist[:, 0xF0] += zrl
    return hist, nz


def _ac_hist(coefs_zz: torch.Tensor) -> torch.Tensor:
    """(n_q, 256) histograms of baseline AC symbols, ZRL (0xF0) and EOB
    (0x00) included, over every block of (n_q, by, bx, 64) planes."""
    ac = torch.abs(coefs_zz.to(torch.int64)).reshape(coefs_zz.shape[0], -1, 64)[..., 1:]
    hist, _ = _run_size_hist(ac, 1, 63)
    hist[:, 0x00] += (ac[..., -1] == 0).sum(dim=1)
    return hist


def _factors(subsampling: str) -> Tuple[int, int]:
    if subsampling not in ("420", "444", "422", "440"):
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    return (2 if subsampling in ("420", "422") else 1, 2 if subsampling in ("420", "440") else 1)


def ladder_rate_stats(
    cy: torch.Tensor, ccb: torch.Tensor, ccr: torch.Tensor, subsampling: str = "420"
) -> torch.Tensor:
    """Rate statistics of a whole ladder's quantized planes, on their
    device: cy (n_q, byY, bxY, 64), ccb / ccr (n_q, byC, bxC, 64) zigzag
    integers -> (n_q, 544) int64, the four histograms packed so that the
    ladder costs one device-to-host copy (``size_estimates_from_packed``
    unpacks it).  Cb and Cr keep separate DC chains but share the chroma
    tables, as the coder does."""
    sh, sv = _factors(subsampling)
    return torch.cat([
        _dc_hist(cy[..., 0], sv, sh),
        _dc_hist(ccb[..., 0], 1, 1) + _dc_hist(ccr[..., 0], 1, 1),
        _ac_hist(cy),
        _ac_hist(ccb) + _ac_hist(ccr),
    ], dim=1)


def _ac_band_stats(coefs_zz: torch.Tensor, ny: int, nx: int, ss: int, se: int) -> torch.Tensor:
    """(n_q, 256) symbol histograms of one non-interleaved progressive AC
    scan (T.81 G.1.2.2): band [ss, se] over the true (ny, nx) block
    subgrid, with in-band run-size symbols, ZRL, and EOBRUN symbols (n<<4
    for a run of 2^n..2^(n+1)-1 end-of-band blocks, 0x7FFF cap).

    An EOB run spans blocks: a coded block whose band ends in zeros joins
    the following all-zero-band blocks into one run, flushed by the next
    coded block or the scan's end.  Run lengths are differences of an
    exclusive cumulative sum at the flush points, read through a cumulative
    max of that sum masked to the coded blocks."""
    n_q = coefs_zz.shape[0]
    q = torch.abs(coefs_zz[:, :ny, :nx].to(torch.int64)).reshape(n_q, -1, 64)
    band = q[..., ss:se + 1]
    hist, nz = _run_size_hist(band, ss, se)
    has_nz = nz.any(dim=-1)  # (n_q, B) coded blocks

    ends_zero = band[..., -1] == 0
    c = torch.where(has_nz, ends_zero, torch.ones_like(ends_zero)).to(torch.int64)
    cum = torch.cumsum(c, dim=1)
    excl = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    neg = -(1 << 30)
    f = torch.where(has_nz, excl, torch.full_like(excl, neg))
    fmax = torch.cummax(f, dim=1).values
    prev_e = torch.cat([torch.full_like(fmax[:, :1], neg), fmax[:, :-1]], dim=1)
    runs = torch.where(has_nz, excl - torch.clamp(prev_e, min=0), torch.zeros_like(excl))
    any_coded = has_nz.any(dim=1)
    end_run = cum[:, -1] - torch.where(any_coded, torch.clamp(fmax[:, -1], min=0),
                                       torch.zeros_like(cum[:, -1]))
    runs = torch.cat([runs, end_run[:, None]], dim=1)

    # EOBRUN(32767) symbols from the 0x7FFF cap, then log2 buckets of the
    # remainders (rem < 32768, so n <= 14).
    n_full = (runs // 32767).sum(dim=1)
    rem = runs % 32767
    nbits = torch.zeros_like(rem)
    for j in range(1, 15):
        nbits += (rem >= (1 << j)).to(torch.int64)
    counts = _count(torch.where(rem > 0, nbits, torch.full_like(nbits, 15)), 15)
    eob = torch.zeros_like(hist)
    eob[:, torch.arange(15, device=eob.device) << 4] = counts
    eob[:, 0xE0] += n_full
    return hist + eob


def progressive_ladder_rate_stats(
    cy: torch.Tensor, ccb: torch.Tensor, ccr: torch.Tensor, height: int, width: int,
    subsampling: str = "420",
) -> torch.Tensor:
    """The progressive analog of ``ladder_rate_stats``: (n_q, 1056) int64.
    The non-interleaved AC scans cover the ceil(dim / 8) blocks of the true
    image (the padded MCU grid's extra rows and columns are left out), so
    the image's height and width are arguments."""
    sh, sv = _factors(subsampling)
    ny_y, nx_y = (height + 7) // 8, (width + 7) // 8
    ny_c = ((height + 1) // 2 + 7) // 8 if sv == 2 else ny_y
    nx_c = ((width + 1) // 2 + 7) // 8 if sh == 2 else nx_y
    return torch.cat([
        _dc_hist(cy[..., 0], sv, sh),
        _dc_hist(ccb[..., 0], 1, 1) + _dc_hist(ccr[..., 0], 1, 1),
        _ac_band_stats(cy, ny_y, nx_y, 1, 5),
        _ac_band_stats(ccb, ny_c, nx_c, 1, 63),
        _ac_band_stats(ccr, ny_c, nx_c, 1, 63),
        _ac_band_stats(cy, ny_y, nx_y, 6, 63),
    ], dim=1)


# -- host half -------------------------------------------------------------------


def size_estimates_from_packed(
    packed: np.ndarray, app_mode: int = 0
) -> list:
    """Byte-size estimates for packed (rows, 544) statistics (a ladder's
    qualities, or a chunk's images x qualities): ``baseline_size_estimate``
    of every row, in one native call."""
    from ..utils.native import jpeg_baseline_scan_bits

    bits, nsyms = jpeg_baseline_scan_bits(packed)
    return [_baseline_file_bytes(int(b), int(n), app_mode) for b, n in zip(bits, nsyms)]


def _progressive_ac_extra_bits() -> np.ndarray:
    """Appended bits per progressive AC symbol: size for (run, size>0),
    0 for ZRL, n for EOBRUN symbols (n<<4)."""
    sym = np.arange(256, dtype=np.int64)
    lo = sym & 15
    hi = sym >> 4
    return np.where(lo > 0, lo, np.where(sym == 0xF0, 0, hi))


def progressive_size_estimate(
    dc_y: np.ndarray,
    dc_c: np.ndarray,
    ac_y_low: np.ndarray,
    ac_cb: np.ndarray,
    ac_cr: np.ndarray,
    ac_y_high: np.ndarray,
    app_mode: int = 0,
) -> int:
    """Estimated .jpg size for the SOF2 spectral-selection scan script
    (ce_jpeg_encode_progressive): interleaved DC; Y 1-5; Cb 1-63; Cr 1-63;
    Y 6-63.  Tables: 2 DC + 3 AC (Y low / chroma shared by Cb+Cr / Y
    high); every scan is flush-padded separately.  Exact except stuffing
    (calibrated scan/368)."""
    dc_extra = np.arange(16, dtype=np.int64)
    ac_extra = _progressive_ac_extra_bits()

    def dfreq(h16):
        out = np.zeros(256, dtype=np.int64)
        out[:16] = np.asarray(np.rint(h16), dtype=np.int64)
        return out

    f_dc_y, f_dc_c = dfreq(dc_y), dfreq(dc_c)
    f_low = np.asarray(np.rint(ac_y_low), dtype=np.int64)
    f_cb = np.asarray(np.rint(ac_cb), dtype=np.int64)
    f_cr = np.asarray(np.rint(ac_cr), dtype=np.int64)
    f_high = np.asarray(np.rint(ac_y_high), dtype=np.int64)

    s_dc0, n_dc0 = t81_code_sizes(f_dc_y)
    s_dc1, n_dc1 = t81_code_sizes(f_dc_c)
    s_ac0, n_ac0 = t81_code_sizes(f_low)
    s_ac1, n_ac1 = t81_code_sizes(f_cb + f_cr)
    s_ac2, n_ac2 = t81_code_sizes(f_high)

    scan_bits = [
        int((f_dc_y[:16] * (s_dc0[:16] + dc_extra)).sum())
        + int((f_dc_c[:16] * (s_dc1[:16] + dc_extra)).sum()),
        int((f_low * (s_ac0 + ac_extra)).sum()),
        int((f_cb * (s_ac1 + ac_extra)).sum()),
        int((f_cr * (s_ac1 + ac_extra)).sum()),
        int((f_high * (s_ac2 + ac_extra)).sum()),
    ]
    scan_bytes = sum((b + 7) // 8 for b in scan_bits)
    nsyms = n_dc0 + n_dc1 + n_ac0 + n_ac1 + n_ac2
    app = 16 if app_mode == 1 else 18
    # SOI, APP, 2xDQT, SOF2 (19), 5 DHT, SOS 3-comp (14) + 4x SOS 1-comp
    # (10 each), EOI.
    header = 2 + app + 2 * 69 + 19 + (5 * 21 + nsyms) + 14 + 4 * 10 + 2
    stuffed = int(round(scan_bytes / 368.0))
    return header + scan_bytes + stuffed


def progressive_size_estimates_from_packed(
    packed: np.ndarray, app_mode: int = 0
) -> list:
    """Byte-size estimates for a ladder's packed (n_q, 1056) progressive
    statistics."""
    packed = np.asarray(packed)
    return [
        progressive_size_estimate(
            row[:16], row[16:32], row[32:288], row[288:544],
            row[544:800], row[800:1056], app_mode=app_mode,
        )
        for row in packed
    ]


def t81_code_sizes(freq256: np.ndarray) -> Tuple[np.ndarray, int]:
    """Optimal length-limited Huffman code sizes, ITU T.81 Annex K.2.

    Exact port of native/jpeg_entropy.cpp build_optimal_table (including
    its tie-breaking: the HIGHEST index among minimal nonzero frequencies
    wins each merge, via the ``<=`` scan) so the host reproduces the
    entropy coder's tables bit-for-bit from fetched histograms.  Returns
    (size per symbol — 0 for absent symbols, number of coded symbols).
    """
    import heapq

    freq = [0] * 257
    for i, f in enumerate(np.asarray(freq256, dtype=np.int64)):
        freq[i] = int(f)
    freq[256] = 1  # reserved: keeps the all-ones code unused
    codesize = [0] * 257
    others = [-1] * 257

    # The C++ scans pick the minimal nonzero frequency, ties resolved to
    # the HIGHEST index (its `<=` keeps updating); the merged tree keeps
    # c1's index and frequency slot.  A heap keyed (freq, -index) pops in
    # exactly that order.
    heap = [(f, -i) for i, f in enumerate(freq) if f]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, ni1 = heapq.heappop(heap)
        f2, ni2 = heapq.heappop(heap)
        c1, c2 = -ni1, -ni2
        heapq.heappush(heap, (f1 + f2, ni1))
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1

    bits = np.zeros(33, dtype=np.int64)
    for i in range(257):
        if codesize[i]:
            bits[min(int(codesize[i]), 32)] += 1

    # Limit code lengths to 16 (Figure K.3).
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while i > 0 and bits[i] == 0:
        i -= 1
    if i > 0:
        bits[i] -= 1  # drop the reserved symbol from the longest length

    # Canonical size assignment: symbols ordered by (pre-limit codesize,
    # symbol value), filling the adjusted per-length counts.
    cs = np.asarray(codesize[:256])
    idx = np.flatnonzero(cs > 0)
    order = idx[np.argsort(cs[idx], kind="stable")].tolist()
    sizes = np.zeros(256, dtype=np.int64)
    k = 0
    for l in range(1, 17):
        for _ in range(int(bits[l])):
            sizes[order[k]] = l
            k += 1
    return sizes, len(order)


def scan_bits_from_hists(
    dc_y: np.ndarray, dc_c: np.ndarray, ac_y: np.ndarray, ac_c: np.ndarray
) -> Tuple[int, int]:
    """(exact entropy-coded scan bits, total DHT symbol count) for a
    baseline interleaved scan with optimized tables built from these
    histograms.  Appended bits are derivable from the histograms alone:
    DC symbol s carries s bits, AC symbol carries (sym & 15).  The tables
    are built natively (``utils.native.jpeg_baseline_scan_bits``)."""
    from ..utils.native import jpeg_baseline_scan_bits

    row = np.concatenate([np.rint(np.asarray(h, dtype=np.float64)).astype(np.int64)
                          for h in (dc_y, dc_c, ac_y, ac_c)])
    bits, nsyms = jpeg_baseline_scan_bits(row[None])
    return int(bits[0]), int(nsyms[0])


def baseline_size_estimate(
    dc_y: np.ndarray,
    dc_c: np.ndarray,
    ac_y: np.ndarray,
    ac_c: np.ndarray,
    app_mode: int = 0,
) -> int:
    """Estimated total .jpg byte size from device rate statistics.

    Exact except for 0xFF byte stuffing, estimated at the calibrated
    scan_bytes/368 (module docstring).  Header accounting mirrors
    ce_jpeg_encode_baseline2 byte for byte: SOI 2, APP0 18 (JFIF) /
    APP14 16 (Adobe), 2 DQT x 69, SOF0 19, 4 DHT x (21 + n_symbols),
    SOS 14, scan, EOI 2.
    """
    bits, nsyms = scan_bits_from_hists(dc_y, dc_c, ac_y, ac_c)
    return _baseline_file_bytes(bits, nsyms, app_mode)


def _baseline_file_bytes(bits: int, nsyms: int, app_mode: int) -> int:
    """Headers, the flush-padded scan, the stuffing estimate and EOI."""
    scan_bytes = (bits + 7) // 8
    app = 16 if app_mode == 1 else 18
    header = 2 + app + 2 * 69 + 19 + (4 * 21 + nsyms) + 14
    stuffed = int(round(scan_bytes / 368.0))
    return header + scan_bytes + stuffed + 2
