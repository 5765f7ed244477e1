"""Host helpers of ``codec_eval_tpu/utils/native.py``.

Two halves:

- sRGB decoding for staging, the FNV-1a file checksum, and binary PPM
  reading and writing for codec-iter's source cache, in their pure-Python
  forms (a numpy lookup table, ``corpus.checksum``'s streaming hash, and the
  JAX module's Python branch of ``read_ppm`` and ``write_ppm``);
- the JPEG half: a ctypes binding of the repository's native host library
  (``native/*.cpp``: the optimized-Huffman entropy coder, baseline and
  progressive, its scan statistics, the Huffman parser behind device
  decoding, the trellis DP, and FNV-1a over memory) and of the port's own
  host sources beside it (``codec_eval_tpu_torch/csrc/*.cpp``: scan sizes
  from packed symbol counts).

The library is compiled from both at first use with ``g++`` and
``native/Makefile``'s flags into ``build/native/<key>/``, where the key
hashes the sources, the flags, the compiler and the host, so a checkout
never loads a library built from other sources or for another machine.
``native/`` itself is never written.  Concurrent processes (test
workers) build once: the build runs under an exclusive ``fcntl`` lock and
lands with an atomic ``os.replace``.  A failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_NATIVE_SRC = _REPO / "native"
_PORT_SRC = _REPO / "codec_eval_tpu_torch" / "csrc"
_BUILD = _REPO / "build" / "native"
#: native/Makefile's CXXFLAGS, plus -shared.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")
_LIB_NAME = "libcodec_eval_native.so"
_SUBSAMPLING_CODE = {"444": 0, "420": 1, "422": 2, "440": 3}


@functools.lru_cache(maxsize=1)
def _lut() -> np.ndarray:
    """The 256 linear values of the sRGB u8 codes, computed in f64 and
    rounded once to f32."""
    v = np.arange(256, dtype=np.float64) / 255.0
    lut = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)
    lut.flags.writeable = False
    return lut


def srgb_to_linear_host(u8: np.ndarray) -> np.ndarray:
    """sRGB u8 -> linear f32, any shape."""
    return _lut()[np.ascontiguousarray(u8)]


def fnv1a64_file(path) -> int:
    """FNV-1a 64-bit hash of a file's bytes; raises if it cannot be read."""
    from ..corpus.checksum import fnv1a_64_file

    return fnv1a_64_file(Path(path))


def write_ppm(path, rgb: np.ndarray) -> None:
    """(H, W, 3) u8 -> a binary P6 file with maxval 255."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb).tobytes())


def read_ppm(path) -> np.ndarray:
    """A binary P6 file with maxval 255, as ``write_ppm`` writes it -> (H, W, 3) u8."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P6":
            raise IOError(f"not a P6 PPM: {path}")
        dims = f.readline().split()
        w_, h_ = int(dims[0]), int(dims[1])
        if int(f.readline()) != 255:
            raise IOError(f"not an 8-bit PPM: {path}")
        data = np.frombuffer(f.read(w_ * h_ * 3), dtype=np.uint8)
        return data.reshape(h_, w_, 3).copy()


# -- the native library ----------------------------------------------------------

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(_NATIVE_SRC.glob("*.cpp")) + sorted(_PORT_SRC.glob("*.cpp"))


def _build_key(compiler: str) -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    version = subprocess.run([compiler, "--version"], capture_output=True, text=True,
                             check=True).stdout
    for part in (*CXXFLAGS, version, platform.machine(), platform.node()):
        h.update(part.encode() + b"\0")
    return h.hexdigest()[:16]


def library_path() -> Path:
    """The built library, compiling it first if this checkout and host have
    none yet."""
    import fcntl
    import os

    compiler = "g++"
    out_dir = _BUILD / _build_key(compiler)
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
            sources = [str(p) for p in _sources()]
            run = subprocess.run([compiler, *CXXFLAGS, "-o", str(tmp), *sources],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building the native host library failed ({compiler} exit "
                    f"{run.returncode}):\n{run.stderr}")
            os.replace(tmp, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.ce_fnv1a64.restype = c.c_uint64
    lib.ce_fnv1a64.argtypes = [c.c_void_p, c.c_size_t]
    lib.ce_trellis_quantize.restype = c.c_int64
    lib.ce_trellis_quantize.argtypes = [
        c.c_void_p, c.c_size_t, c.c_void_p, c.c_void_p, c.c_float, c.c_void_p]
    for fn in (lib.ce_jpeg_encode_baseline2, lib.ce_jpeg_encode_progressive):
        fn.restype = c.c_int64
        fn.argtypes = [
            c.c_uint16, c.c_uint16, c.c_int,
            c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32,
            c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_size_t, c.c_int,
        ]
    lib.ce_jpeg_scan_stats.restype = c.c_int64
    lib.ce_jpeg_scan_stats.argtypes = [
        c.c_int,
        c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32,
        c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_size_t,
        c.c_void_p, c.c_void_p,
    ]
    lib.ce_jpeg_scan_stats_progressive.restype = c.c_int64
    lib.ce_jpeg_scan_stats_progressive.argtypes = [
        c.c_uint16, c.c_uint16, c.c_int,
        c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32,
        c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_size_t,
        c.c_void_p, c.c_void_p,
    ]
    lib.ce_jpeg_baseline_scan_bits.restype = c.c_int64
    lib.ce_jpeg_baseline_scan_bits.argtypes = [c.c_void_p, c.c_size_t, c.c_void_p, c.c_void_p]
    lib.ce_jpeg_parse.restype = c.c_int64
    lib.ce_jpeg_parse.argtypes = [
        c.c_void_p, c.c_size_t, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
    ]


def load() -> ctypes.CDLL:
    """The native library, built at first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            _declare(lib)
            _lib = lib
        return _lib


def fnv1a64(data: "bytes | np.ndarray") -> int:
    """FNV-1a 64-bit hash of bytes, or of an array's contiguous bytes."""
    lib = load()
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        return int(lib.ce_fnv1a64(arr.ctypes.data, arr.nbytes))
    return int(lib.ce_fnv1a64(data, len(data)))


def jpeg_entropy_available() -> bool:
    """True once the entropy coder is loaded; a failed build raises."""
    return load() is not None


def _planes(y_coeffs, cb_coeffs, cr_coeffs) -> tuple:
    return tuple(np.ascontiguousarray(p, dtype=np.int16) for p in (y_coeffs, cb_coeffs, cr_coeffs))


def jpeg_encode_baseline(
    width: int,
    height: int,
    subsampling: str,
    y_coeffs: np.ndarray,
    cb_coeffs: np.ndarray,
    cr_coeffs: np.ndarray,
    qtab_luma_zz: np.ndarray,
    qtab_chroma_zz: np.ndarray,
    app_mode: int = 0,
    progressive: bool = False,
) -> bytes:
    """Entropy-code quantized zigzag coefficient planes into a JPEG stream
    with optimized Huffman tables (native/jpeg_entropy.cpp).

    Coefficient planes are int16 (by, bx, 64); qtables are uint16[64] in
    zigzag order.  app_mode 0 emits a JFIF (YCbCr) container; 1 emits Adobe
    APP14 transform 0 (channels pass through undecoded: the XYB mode).
    ``progressive`` writes the SOF2 spectral-selection script.
    """
    lib = load()
    y, cb, cr = _planes(y_coeffs, cb_coeffs, cr_coeffs)
    ql = np.ascontiguousarray(qtab_luma_zz, dtype=np.uint16)
    qc = np.ascontiguousarray(qtab_chroma_zz, dtype=np.uint16)
    # A dense plane of large magnitudes costs up to ~27 bits per
    # coefficient: twice the raw int16 bytes plus headers covers it.
    cap = 2 * (y.nbytes + cb.nbytes + cr.nbytes) + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    entry = lib.ce_jpeg_encode_progressive if progressive else lib.ce_jpeg_encode_baseline2
    n = entry(
        width, height, _SUBSAMPLING_CODE[subsampling],
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
        y.shape[0], y.shape[1], cb.shape[0], cb.shape[1],
        ql.ctypes.data, qc.ctypes.data,
        out.ctypes.data, cap, int(app_mode),
    )
    if n < 0:
        raise RuntimeError("jpeg entropy coder failed (buffer/args)")
    return out[:n].tobytes()


def _scan_stats(entry, lead: tuple, n_ac: int, y_coeffs, cb_coeffs, cr_coeffs) -> dict:
    y, cb, cr = _planes(y_coeffs, cb_coeffs, cr_coeffs)
    dc_freq = np.zeros((2, 256), dtype=np.uint32)
    ac_freq = np.zeros((n_ac, 256), dtype=np.uint32)
    cap = 2 * (y.nbytes + cb.nbytes + cr.nbytes) + (1 << 16)
    scratch = np.empty(cap, dtype=np.uint8)
    scan_bytes = ctypes.c_int64()
    stuffed = ctypes.c_int64()
    rc = entry(
        *lead,
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
        y.shape[0], y.shape[1], cb.shape[0], cb.shape[1],
        dc_freq.ctypes.data, ac_freq.ctypes.data,
        scratch.ctypes.data, cap,
        ctypes.byref(scan_bytes), ctypes.byref(stuffed),
    )
    if rc != 0:
        raise RuntimeError("jpeg scan stats failed (buffer/args)")
    return {"dc_freq": dc_freq, "ac_freq": ac_freq, "scan_bytes": int(scan_bytes.value),
            "stuffed": int(stuffed.value)}


def jpeg_scan_stats(subsampling: str, y_coeffs, cb_coeffs, cr_coeffs) -> dict:
    """Exact baseline-scan statistics from the C++ entropy coder: the oracle
    of the device rate accounting (``kernels/jpeg_rate.py``).

    Returns {"dc_freq": (2, 256) u32, "ac_freq": (2, 256) u32,
    "scan_bytes": int (flush-padded, headers/EOI excluded),
    "stuffed": int (0x00 bytes inserted after 0xFF)}.
    """
    return _scan_stats(load().ce_jpeg_scan_stats, (_SUBSAMPLING_CODE[subsampling],), 2,
                       y_coeffs, cb_coeffs, cr_coeffs)


def jpeg_scan_stats_progressive(
    width: int, height: int, subsampling: str, y_coeffs, cb_coeffs, cr_coeffs
) -> dict:
    """Progressive (SOF2 spectral-selection) analog of ``jpeg_scan_stats``:
    2 DC + 3 AC table-class histograms (Y low band / chroma / Y high band),
    total entropy bytes over the 5 scans, and total stuffed bytes."""
    return _scan_stats(load().ce_jpeg_scan_stats_progressive,
                       (width, height, _SUBSAMPLING_CODE[subsampling]), 3,
                       y_coeffs, cb_coeffs, cr_coeffs)


def jpeg_baseline_scan_bits(packed: np.ndarray) -> tuple:
    """(scan bits, DHT symbol count), each (rows,) int64, of the baseline
    scans whose (rows, 544) packed symbol counts are given (the layout of
    ``kernels.jpeg_rate.ladder_rate_stats``): the four optimized tables of
    each row built by the entropy coder's T.81 K.2 construction
    (``csrc/jpeg_scan_bits.cpp``), in one call.  The bits are the codes' and the appended bits', without flush
    padding or 0xFF stuffing."""
    p = np.asarray(packed)
    if p.ndim != 2 or p.shape[1] != 544 or not np.issubdtype(p.dtype, np.integer):
        raise ValueError(f"packed statistics must be (rows, 544) integers, got {p.shape} {p.dtype}")
    p = np.ascontiguousarray(p, dtype=np.int64)
    bits = np.empty(p.shape[0], dtype=np.int64)
    nsyms = np.empty(p.shape[0], dtype=np.int64)
    rc = load().ce_jpeg_baseline_scan_bits(p.ctypes.data, p.shape[0], bits.ctypes.data,
                                           nsyms.ctypes.data)
    if rc != 0:
        raise ValueError("packed statistics hold a negative count or a table over 2^32 - 1")
    return bits, nsyms


def jpeg_parse_coefficients(data: bytes) -> dict:
    """Entropy-decode a JPEG stream to quantized zigzag coefficient planes
    (native/jpeg_huff_decode.cpp): the host half of device JPEG decoding.
    Baseline (SOF0/SOF1) and progressive (SOF2) 8-bit Huffman streams with
    three components or one (grayscale), restart markers included.

    Returns {"width", "height", "subsampling" ("444"/"420"/"422"/"440", or
    "400" for grayscale, whose chroma planes are then 1x1 dummies),
    "progressive" bool, "adobe_transform" (None or int),
    "y"/"cb"/"cr": (by, bx, 64) int16 zigzag on the padded MCU grid,
    "qtab_luma_zz"/"qtab_chroma_zz": uint16[64]}.

    Raises UnsupportedFormat for streams outside that envelope (CMYK,
    12-bit, arithmetic, hierarchical), ValueError on corrupt data.
    """
    from ..errors import UnsupportedFormat

    lib = load()
    buf = np.frombuffer(data, dtype=np.uint8)
    hdr = np.zeros(16, dtype=np.uint32)
    rc = lib.ce_jpeg_parse(buf.ctypes.data, buf.nbytes, hdr.ctypes.data,
                           None, None, None, None, None)
    if rc == -2:
        raise UnsupportedFormat(
            "JPEG stream outside the supported envelope "
            "(need 8-bit Huffman, 3-component 444/420/422/440 or grayscale)"
        )
    if rc != 0:
        raise ValueError("corrupt JPEG stream")
    w, h = int(hdr[0]), int(hdr[1])
    by_y, bx_y, by_c, bx_c = (int(x) for x in hdr[5:9])
    sh, sv = int(hdr[3]), int(hdr[4])
    gray = int(hdr[2]) == 1
    if w < 1 or h < 1:
        raise ValueError("corrupt JPEG stream (zero dimensions)")
    # A corrupt SOF can claim 65535 x 65535: reject before allocating planes.
    if w * h > 64 * 1024 * 1024:
        raise ValueError(f"JPEG dimensions {w}x{h} exceed the 64-megapixel sanity cap")
    sub = "400" if gray else {(1, 1): "444", (2, 2): "420", (2, 1): "422", (1, 2): "440"}[(sh, sv)]
    y = np.zeros((by_y, bx_y, 64), dtype=np.int16)
    # Grayscale streams have no chroma planes; 1x1 dummies keep one signature.
    cb = np.zeros((max(by_c, 1), max(bx_c, 1), 64), dtype=np.int16)
    cr = np.zeros_like(cb)
    ql = np.zeros(64, dtype=np.uint16)
    qc = np.zeros(64, dtype=np.uint16)
    rc = lib.ce_jpeg_parse(
        buf.ctypes.data, buf.nbytes, hdr.ctypes.data, y.ctypes.data,
        None if gray else cb.ctypes.data, None if gray else cr.ctypes.data,
        ql.ctypes.data, qc.ctypes.data,
    )
    if rc != 0:
        raise ValueError("corrupt JPEG stream (entropy decode failed)")
    return {
        "width": w, "height": h, "subsampling": sub, "progressive": bool(hdr[9]),
        "adobe_transform": int(hdr[10]) - 1 if hdr[10] else None,
        "y": y, "cb": cb, "cr": cr, "qtab_luma_zz": ql, "qtab_chroma_zz": qc,
    }


def trellis_quantize_native(
    dct_zz: np.ndarray, q_zz: np.ndarray, ac_lengths: np.ndarray, lmbda: float
) -> np.ndarray:
    """The C++ trellis DP (native/jpeg_trellis.cpp), an exact mirror of the
    numpy DP of ``kernels.jpeg_enc.trellis_quantize_blocks``."""
    lib = load()
    lead = dct_zz.shape[:-1]
    flat = np.ascontiguousarray(dct_zz.reshape(-1, 64), dtype=np.float32)
    q = np.ascontiguousarray(q_zz, dtype=np.float32)
    lengths = np.ascontiguousarray(ac_lengths, dtype=np.float32)
    if q.shape != (64,) or lengths.shape != (16, 11):
        raise ValueError(f"q_zz {q.shape} must be (64,) and ac_lengths {lengths.shape} (16, 11)")
    out = np.empty(flat.shape, dtype=np.int16)
    rc = lib.ce_trellis_quantize(flat.ctypes.data, flat.shape[0], q.ctypes.data,
                                 lengths.ctypes.data, ctypes.c_float(float(lmbda)),
                                 out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"native trellis DP failed ({rc})")
    return out.reshape(*lead, 64)
