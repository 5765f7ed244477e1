"""A plain baseline-JPEG quality ladder: tpujpeg's trellis encode at 4:2:0,
its decode, and an exact baseline file-size count, in plain PyTorch (f32
products, TF32 off) and numpy.  It imports neither JAX nor the port.

It follows the published description of each step:

- colour: JFIF YCbCr (ITU-T T.871 section 7), as a 3 x 3 product;
- 4:2:0: each plane edge-padded to whole 16 x 16 MCUs, chroma averaged
  over 2 x 2 (tpujpeg's downsampling: libjpeg's h2v2 box without its
  smoothing pass);
- the orthonormal 8 x 8 DCT-II (T.81 A.3.3), C f C^T, as one product of
  each block's 64 samples with the 64 x 64 separable basis, then zigzag
  order; the inverse with the same basis;
- quantization tables: the Annex K examples scaled by libjpeg's
  ``jpeg_quality_scaling``, clamped to [1, 255];
- the trellis as tpujpeg's ``trellis_quantize_blocks`` states it: per
  block, the AC values minimizing sum (|F|/q - c)^2 + lambda * bits over
  the 63 AC positions by a dynamic program whose state is the previous
  nonzero position; candidates round-to-nearest and one step toward zero;
  bits from static (run, size) length tables plus ZRL chains, appended
  magnitude bits and an EOB; the first minimum wins; DC rounds to nearest;
- decode: dequantization, the inverse DCT, libjpeg's "fancy" triangle
  upsampling of chroma (0.75 / 0.25 of the two nearest samples,
  horizontally then vertically), YCbCr -> RGB as a 3 x 3 product,
  rounding half to even into [0, 255];
- the size count: DC differences per component and AC run/size symbols
  with ZRL and EOB in the interleaved MCU order (Y0-Y3, Cb, Cr), optimal
  code lengths by T.81 Annex K.2 (Figures K.1-K.3, ties to the highest
  symbol as libjpeg's ``jpeg_gen_optimal_table``), canonical codes (Annex
  C), the scan packed bit by bit with one-bit padding, a 0x00 after each
  0xFF byte, and the headers of a JFIF baseline file.

Departures from a textbook JPEG encoder, each tpujpeg's own: the trellis
prices symbols with static tables rather than the file's own codes, and
the file always carries optimized tables.
"""

from __future__ import annotations

import contextlib
import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ANNEX_K_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.float64)
ANNEX_K_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.float64)

#: tpujpeg's static (16 run, 11 size) AC bit lengths of the trellis's rate
#: term, luma and chroma.
AC_LENGTHS_LUMA = np.array([
    [3, 2, 3, 3, 4, 4, 5, 6, 12, 16, 16], [16, 4, 5, 7, 8, 10, 12, 14, 16, 16, 16],
    [16, 5, 7, 8, 11, 15, 19, 16, 16, 16, 16], [16, 6, 9, 11, 15, 16, 16, 16, 16, 16, 16],
    [16, 7, 10, 14, 16, 16, 16, 16, 16, 16, 16], [16, 7, 12, 15, 15, 16, 16, 16, 16, 16, 16],
    [16, 7, 13, 14, 19, 16, 16, 16, 16, 16, 16], [16, 10, 14, 15, 19, 16, 16, 16, 16, 16, 16],
    [16, 10, 15, 19, 16, 16, 16, 16, 16, 16, 16], [16, 8, 13, 18, 16, 16, 16, 16, 16, 16, 16],
    [16, 9, 14, 17, 18, 16, 16, 16, 16, 16, 16], [16, 11, 14, 16, 16, 16, 16, 16, 16, 16, 16],
    [16, 12, 16, 16, 16, 16, 16, 16, 16, 16, 16], [16, 12, 14, 16, 16, 16, 16, 16, 16, 16, 16],
    [16, 13, 17, 16, 16, 16, 16, 16, 16, 16, 16], [13, 15, 16, 16, 16, 16, 16, 16, 16, 16, 16],
], dtype=np.float32)
AC_LENGTHS_CHROMA = np.array(
    [[2, 2, 2, 4, 9, 16, 16, 16, 16, 16, 16], [16, 3, 6, 8, 14, 16, 16, 16, 16, 16, 16],
     [16, 6, 9, 16, 16, 16, 16, 16, 16, 16, 16], [16, 7, 13, 16, 16, 16, 16, 16, 16, 16, 16],
     [16, 7, 16, 16, 16, 16, 16, 16, 16, 16, 16], [16, 8, 16, 16, 16, 16, 16, 16, 16, 16, 16],
     [16, 9, 16, 16, 16, 16, 16, 16, 16, 16, 16], [16, 10, 16, 16, 16, 16, 16, 16, 16, 16, 16],
     [16, 11, 16, 16, 16, 16, 16, 16, 16, 16, 16], [16, 13, 16, 16, 16, 16, 16, 16, 16, 16, 16],
     [16, 14, 16, 16, 16, 16, 16, 16, 16, 16, 16], [16, 15, 16, 16, 16, 16, 16, 16, 16, 16, 16]]
    + [[16] * 11] * 4, dtype=np.float32)

RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                       [-0.168735892, -0.331264108, 0.5],
                       [0.5, -0.418687589, -0.081312411]], dtype=np.float32)
YCC_TO_RGB = np.array([[1.0, 0.0, 1.402],
                       [1.0, -0.344136286, -0.714136286],
                       [1.0, 1.772, 0.0]], dtype=np.float32)

#: JFIF baseline headers: SOI 2, APP0 18, two DQT 69 each, SOF0 19, SOS 14;
#: each DHT is 21 bytes plus its symbols; EOI 2.
FIXED_HEADER_BYTES = 2 + 18 + 2 * 69 + 19 + 14
EOI_BYTES = 2


def zigzag() -> np.ndarray:
    """Natural (row * 8 + column) index of each zigzag position (T.81
    Figure 5): anti-diagonals in turn, the even ones walked up and right."""
    order = []
    for s in range(15):
        rows = range(min(s, 7), max(0, s - 7) - 1, -1) if s % 2 == 0 else range(max(0, s - 7),
                                                                               min(s, 7) + 1)
        order.extend(r * 8 + (s - r) for r in rows)
    return np.array(order, dtype=np.int64)


def dct_matrix() -> np.ndarray:
    """C[u, x] = s(u) cos((2x + 1) u pi / 16), s(0) = sqrt(1/8), s(u) = 1/2."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    c[0] *= np.sqrt(0.5)
    return c.astype(np.float32)


def dct_basis() -> np.ndarray:
    """B[u * 8 + v, x * 8 + y] = C[u, x] C[v, y]: the 2-D DCT of a block's
    row-major samples f is B f, and its inverse B^T F (the f32 1-D basis
    multiplied in f64, rounded once to f32)."""
    c = dct_matrix().astype(np.float64)
    return np.kron(c, c).astype(np.float32)


def qtables(quality: float) -> Tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) natural-order steps of ``quality``."""
    q = min(max(float(quality), 1.0), 100.0)
    scale = 5000.0 / q if q < 50.0 else 200.0 - 2.0 * q
    return tuple(np.clip(np.floor((t * scale + 50.0) / 100.0), 1.0, 255.0)
                 for t in (ANNEX_K_LUMA, ANNEX_K_CHROMA))


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for matmuls on or off, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def _unblocks(blocks: torch.Tensor) -> torch.Tensor:
    """(..., by, bx, 8, 8) -> (..., by*8, bx*8)."""
    *lead, by, bx, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, by * 8, bx * 8)


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of non-negative integers (JPEG's magnitude category)."""
    n = torch.zeros_like(v)
    for b in range(16):
        n += (v >= (1 << b)).to(v.dtype)
    return n


def trellis(dct_zz: torch.Tensor, q_zz: torch.Tensor, lengths: np.ndarray,
            lmbda: float) -> torch.Tensor:
    """Quantized values of (N, 64) zigzag DCT blocks under (N, 64) steps."""
    dev = dct_zz.device
    lam = torch.tensor(np.float32(lmbda), device=dev)
    L = torch.from_numpy(lengths).to(dev)
    x = dct_zz.abs() / q_zz
    n = x.shape[0]
    c0 = torch.clamp(torch.floor(x + 0.5), max=1023.0)
    c1 = torch.clamp(c0 - 1.0, min=0.0)
    # Zero-distortion prefix sums over AC, P[:, j] = sum_{1<=i<=j} x_i^2,
    # added in order.
    P = torch.zeros_like(x)
    for j in range(1, 64):
        P[:, j] = P[:, j - 1] + x[:, j] * x[:, j]
    best = torch.full((n, 64), float("inf"), device=dev)
    best[:, 0] = 0.0
    prev = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    value = torch.zeros((n, 64), device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for k in range(1, 64):
        run = torch.arange(k - 1, -1, -1, device=dev)  # zeros between state j and k
        base = best[:, :k] + (P[:, k - 1:k] - P[:, :k])
        costs = []
        for c in (c0[:, k], c1[:, k]):
            size = _bit_length(c.to(torch.int64))
            bits = ((run // 16).to(torch.float32) * L[15, 0])[None, :] \
                + L[run % 16][:, size].T + size.to(torch.float32)[:, None]
            cost = base + lam * bits + ((x[:, k] - c) ** 2)[:, None]
            costs.append(torch.where((c > 0)[:, None], cost, inf))
        both = torch.cat(costs, dim=1)
        pick = torch.argmin(both, dim=1)
        best[:, k] = both.gather(1, pick[:, None])[:, 0]
        prev[:, k] = pick % k
        value[:, k] = torch.where(pick < k, c0[:, k], c1[:, k])
    j = torch.arange(64, device=dev)
    end = best + (P[:, 63:64] - P) + lam * torch.where(j < 63, L[0, 0], 0.0)[None, :]
    last = torch.argmin(end, dim=1)
    out = torch.zeros_like(x)
    rows = torch.arange(n, device=dev)
    for k in range(63, 0, -1):
        on = last == k
        out[on, k] = value[on, k]
        last = torch.where(on, prev[rows, k], last)
    out[:, 0] = torch.clamp(torch.floor(x[:, 0] + 0.5), max=2047.0)
    return torch.sign(dct_zz) * out


def encode_ladder(rgb_u8: np.ndarray, qualities: Sequence[float], lmbda: float = 0.10,
                  device="cpu", use_tf32: bool = False) -> Dict[str, np.ndarray]:
    """One (H, W, 3) u8 image at each quality: {"y": (n_q, byY, bxY, 64),
    "cb", "cr": (n_q, byC, bxC, 64) int16 zigzag coefficients, "candidates":
    (n_q, H, W, 3) u8 decoded pixels}.  ``use_tf32`` computes the colour
    and DCT products in TF32 (on a card), a precision step below f32."""
    h, w = rgb_u8.shape[:2]
    zz = torch.from_numpy(zigzag()).to(device)
    B = torch.from_numpy(dct_basis()).to(device)
    with torch.no_grad(), tf32(use_tf32):
        rgb = torch.from_numpy(np.ascontiguousarray(rgb_u8)).to(device).to(torch.float32)
        ycc = rgb @ torch.from_numpy(RGB_TO_YCC).to(device).T
        ycc = ycc + torch.tensor([0.0, 128.0, 128.0], device=device)
        hp, wp = -h % 16, -w % 16
        ycc = torch.nn.functional.pad(ycc.permute(2, 0, 1)[None], (0, wp, 0, hp),
                                      mode="replicate")[0]
        H, W = h + hp, w + wp
        planes = [ycc[0]] + [p.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3)) for p in ycc[1:]]

        coefs, recon = {}, []
        q = np.stack([np.stack([t[zigzag()] for t in qtables(qq)]) for qq in qualities])
        q = torch.from_numpy(q.astype(np.float32)).to(device)  # (n_q, 2, 64)
        for name, plane, cls, lengths in (("y", planes[0], 0, AC_LENGTHS_LUMA),
                                          ("cb", planes[1], 1, AC_LENGTHS_CHROMA),
                                          ("cr", planes[2], 1, AC_LENGTHS_CHROMA)):
            blocks = _blocks(plane - 128.0)
            F = (blocks.reshape(*blocks.shape[:2], 64) @ B.T)[..., zz]  # (by, bx, 64)
            by, bx = F.shape[:2]
            steps = q[:, cls][:, None, None, :].expand(len(qualities), by, bx, 64)
            Fq = F[None].expand(len(qualities), by, bx, 64)
            c = trellis(Fq.reshape(-1, 64), steps.reshape(-1, 64), lengths, lmbda)
            c = c.reshape(len(qualities), by, bx, 64)
            coefs[name] = c.to(torch.int16).cpu().numpy()
            natural = torch.zeros_like(c)
            natural[..., zz] = c * steps
            recon.append(_unblocks((natural @ B).reshape(*c.shape[:3], 8, 8)) + 128.0)

        y, cb, cr = recon
        for axis in (-1, -2):
            cb, cr = _triangle_up(cb, axis), _triangle_up(cr, axis)
        ycc_out = torch.stack([y, cb - 128.0, cr - 128.0], dim=-1)
        rgb_out = ycc_out @ torch.from_numpy(YCC_TO_RGB).to(device).T
        cands = torch.clamp(torch.round(rgb_out), 0.0, 255.0).to(torch.uint8)[:, :h, :w]
    return {**coefs, "candidates": cands.cpu().numpy()}


def _triangle_up(p: torch.Tensor, axis: int) -> torch.Tensor:
    """2x along ``axis``: out[2i] = .75 p[i] + .25 p[i-1], out[2i+1] =
    .75 p[i] + .25 p[i+1], the edge sample repeated."""
    n = p.shape[axis]
    left = torch.cat([p.narrow(axis, 0, 1), p.narrow(axis, 0, n - 1)], axis)
    right = torch.cat([p.narrow(axis, 1, n - 1), p.narrow(axis, n - 1, 1)], axis)
    even, odd = 0.75 * p + 0.25 * left, 0.75 * p + 0.25 * right
    out = torch.stack([even, odd], dim=axis % p.dim() + 1)
    shape = list(p.shape)
    shape[axis] *= 2
    return out.reshape(shape)


# -- the size count ------------------------------------------------------------


def huffman_table(freq: np.ndarray) -> Tuple[List[int], List[int]]:
    """T.81 Annex K.2: the optimal table of at most 16 bits for 256
    symbols' ``freq``, with a reserved 257th symbol so that no code is all
    ones, as (HUFFVAL, the code length of each of its symbols)."""
    f = [int(v) for v in freq] + [1]
    codesize = [0] * 257
    others = [-1] * 257
    # Figure K.1: merge the two least frequencies, V1 the larger index of
    # the least and V2 of the next least; a heap on (freq, -index) pops them
    # in that order.
    heap = [(v, -i) for i, v in enumerate(f) if v]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        v1, v2 = -n1, -n2
        heapq.heappush(heap, (f1 + f2, n1))
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = others[v2]
            codesize[v2] += 1
    # Figure K.2: count codes per length.
    bits = [0] * 33
    for size in codesize:
        if size:
            bits[min(size, 32)] += 1
    # Figure K.3: fold lengths above 16, then drop the reserved code.
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
        bits[i] -= 1
    # Section K.2's sort: symbols by code size, then value, take the
    # adjusted lengths in that order.
    huffval = sorted((s for s in range(256) if codesize[s]), key=lambda s: (codesize[s], s))
    sizes = [length for length in range(1, 17) for _ in range(bits[length])]
    return huffval, sizes


def code_tables(freq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(EHUFSI, EHUFCO) of ``freq``'s table: each symbol's code length (0
    for an absent symbol) and code, generated in HUFFVAL order (Annex C,
    Figures C.1-C.3): codes count up within a length and double between
    lengths."""
    huffval, sizes = huffman_table(freq)
    ehufsi = np.zeros(256, dtype=np.int64)
    ehufco = np.zeros(256, dtype=np.int64)
    code, length = 0, sizes[0] if sizes else 0
    for s, size in zip(huffval, sizes):
        code <<= size - length
        length = size
        ehufsi[s], ehufco[s] = size, code
        code += 1
    return ehufsi, ehufco


def _scan_blocks(cy: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> tuple:
    """(blocks (M*6, 64) in interleaved 4:2:0 order, component of each
    block (0 Y, 1 Cb, 2 Cr))."""
    byc, bxc = cb.shape[:2]
    y = cy.reshape(byc, 2, bxc, 2, 64).permute(0, 2, 1, 3, 4).reshape(byc * bxc, 4, 64)
    mcus = torch.cat([y, cb.reshape(-1, 1, 64), cr.reshape(-1, 1, 64)], dim=1)
    comp = torch.tensor([0, 0, 0, 0, 1, 2], device=cy.device).repeat(byc * bxc)
    return mcus.reshape(-1, 64).to(torch.int64), comp


def _items(blocks: torch.Tensor, comp: torch.Tensor) -> dict:
    """Every symbol of the scan, one slot per (block, place) in scan order:
    places 0-1 the DC symbol and its bits; then per AC position three ZRL
    places, the run/size symbol and its bits; the EOB last.  Returns the
    symbol of each place (-1 where none), its table (0 luma, 1 chroma, DC
    tables 0-1 and AC tables 2-3), and its appended bits' value and count."""
    dev = blocks.device
    n = blocks.shape[0]
    dc = blocks[:, 0]
    diff = torch.zeros_like(dc)
    for c in range(3):
        on = comp == c
        chain = dc[on]
        diff[on] = chain - torch.cat([chain.new_zeros(1), chain[:-1]])
    dc_size = _bit_length(diff.abs())
    dc_bits = torch.where(diff < 0, diff + (1 << dc_size) - 1, diff)

    ac = blocks[:, 1:]
    nz = ac != 0
    pos = torch.arange(1, 64, device=dev)
    last = torch.cummax(torch.where(nz, pos, torch.zeros_like(pos)), dim=1).values
    prev = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], dim=1)
    run = pos - prev - 1
    size = _bit_length(ac.abs())
    sym = torch.where(nz, ((run % 16) << 4) | size, torch.full_like(run, -1))
    zrl = [torch.where(nz & (run >= 16 * (z + 1)), 0xF0, -1) for z in range(3)]
    ac_bits = torch.where(ac < 0, ac + (1 << size) - 1, ac)
    eob = torch.where(blocks[:, 63] == 0, 0x00, -1)

    none = torch.full((n, 63), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(none)
    ac_sym = torch.stack([zrl[2], zrl[1], zrl[0], sym, none], dim=2).reshape(n, -1)
    ac_val = torch.stack([zero, zero, zero, zero, ac_bits], dim=2).reshape(n, -1)
    ac_len = torch.stack([zero, zero, zero, zero, size], dim=2).reshape(n, -1)
    syms = torch.cat([dc_size[:, None], torch.full_like(dc[:, None], -1), ac_sym, eob[:, None]], 1)
    vals = torch.cat([torch.zeros_like(dc[:, None]), dc_bits[:, None], ac_val,
                      torch.zeros_like(dc[:, None])], 1)
    lens = torch.cat([torch.zeros_like(dc[:, None]), dc_size[:, None], ac_len,
                      torch.zeros_like(dc[:, None])], 1)
    chroma = (comp > 0).to(torch.int64)[:, None]
    table = torch.cat([chroma, chroma, (chroma + 2).expand(n, 63 * 5), chroma + 2], 1)
    return {"sym": syms, "table": table, "val": vals, "len": lens}


def count_candidate(cy: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> dict:
    """One 4:2:0 candidate's (byY, bxY, 64), (byC, bxC, 64) zigzag
    coefficients -> {"scan_bits": codes and appended bits, "nsyms": the
    four tables' symbols, "stuffed": 0x00 bytes after 0xFF in the padded
    scan, "exact": the file's bytes, "estimate": tpujpeg's documented
    estimate, header + scan bytes + round(scan bytes / 368) + EOI}."""
    blocks, comp = _scan_blocks(cy, cb, cr)
    it = _items(blocks, comp)
    sym, table = it["sym"].reshape(-1), it["table"].reshape(-1)
    used = sym >= 0
    hist = torch.zeros(4 * 256, dtype=torch.int64, device=sym.device)
    hist.index_add_(0, (table * 256 + sym)[used], torch.ones_like(sym[used]))
    hist = hist.reshape(4, 256).cpu().numpy()
    lengths, codes = (np.stack(t) for t in zip(*(code_tables(h) for h in hist)))
    nsyms = int((lengths > 0).sum())
    lut_len = torch.from_numpy(lengths.reshape(-1)).to(sym.device)
    lut_code = torch.from_numpy(codes.reshape(-1)).to(sym.device)
    key = torch.where(used, table * 256 + sym, torch.zeros_like(sym))
    code_len = torch.where(used, lut_len[key], 0)
    code_val = torch.where(used, lut_code[key], 0)
    # The scan as (value, bit count) items in order: each place's code, then
    # its appended bits.
    vals = torch.stack([code_val, it["val"].reshape(-1)], 1).reshape(-1)
    lens = torch.stack([code_len, it["len"].reshape(-1)], 1).reshape(-1)
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    scan_bits = int(lens.sum())
    starts = torch.cumsum(lens, 0) - lens
    owner = torch.repeat_interleave(torch.arange(len(lens), device=lens.device), lens)
    shift = lens[owner] - 1 - (torch.arange(scan_bits, device=lens.device) - starts[owner])
    stream = (vals[owner] >> shift) & 1
    pad = -scan_bits % 8
    stream = torch.cat([stream, torch.ones(pad, dtype=stream.dtype, device=stream.device)])
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=stream.device)
    scan = (stream.reshape(-1, 8) * weights).sum(dim=1)
    scan_bytes = int(scan.numel())
    stuffed = int((scan == 0xFF).sum())
    header = FIXED_HEADER_BYTES + 4 * 21 + nsyms
    return {"scan_bits": scan_bits, "nsyms": nsyms, "stuffed": stuffed,
            "exact": header + scan_bytes + stuffed + EOI_BYTES,
            "estimate": header + scan_bytes + int(round(scan_bytes / 368.0)) + EOI_BYTES}


def count_ladder(coefs: Dict[str, np.ndarray], device="cpu") -> Dict[str, List[int]]:
    """``count_candidate`` of every quality of ``encode_ladder``'s
    coefficients: {key: per-quality values}."""
    out: Dict[str, List[int]] = {}
    for i in range(coefs["y"].shape[0]):
        got = count_candidate(*(torch.from_numpy(np.ascontiguousarray(coefs[k][i])).to(device)
                                for k in ("y", "cb", "cr")))
        for k, v in got.items():
            out.setdefault(k, []).append(v)
    return out
