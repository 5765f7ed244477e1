"""Build and load the hand-written Hopper kernels.

At first use, ``nvcc`` compiles every ``codec_eval_tpu_torch/csrc/*.cu`` (one
process per source, all started together) and links the objects into one
shared library with a plain C interface under ``build/kernels/`` at the
repository root.  The library's name carries a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never loaded.
It is bound with ``ctypes``: every pointer and the CUDA stream travel as
``c_void_p``, every size as ``c_int``, a scalar weight as ``c_float``, and every entry point returns the
``cudaError_t`` of its launch, which ``check`` turns into an exception.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: ``-fmad=false`` keeps every multiply and add separately rounded, as
#: PyTorch's elementwise ops are, so a kernel's stencil arithmetic matches
#: its plain version bit for bit wherever the summation order is the same.
#: Most kernels are bound by memory traffic; the Malta sweeps (K4, K5) are
#: bound by operations, and without FMA the card issues half the f32
#: operations per clock that its peak counts.  ``-Xptxas -v`` reports each
#: kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

#: C entry points: name -> argtypes.  Each returns ``int`` (cudaError_t).
SIGNATURES = {
    # x1, mu1, s11, x2, partial, counter, out, n, h, w, seg, row_lo, row_hi, taps, stream
    "ce_scale_features": (P, P, P, P, P, P, P, I, I, I, I, I, I, P, P),
    # lin, recip, out, b, h, w, seg, consts, taps, stream
    "ce_opsin_xyb": (P, P, P, I, I, I, I, P, P, P),
    # xyb, lf, recip332, recip156, out, b, h, w, seg, consts, taps332, taps156, stream
    "ce_bands": (P, P, P, P, P, I, I, I, I, P, P, P, P),
    # diffs, out, b, h, w, stream
    "ce_malta_ac": (P, P, I, I, I, P),
    # cand6, ref6, cand_rest, ref_rest, dac, masks, out, b, h, w, ch, epi, stream
    "ce_malta_diffmap": (P, P, P, P, P, P, P, I, I, I, P, P, P),
    # planes, recip, out, n, h, w, seg, taps, ntaps, stream
    "ce_blur": (P, P, P, I, I, I, I, P, I, P),
    # d1, b0, recip, out, b, h, w, seg, taps, ntaps, ac_mul, stream
    "ce_mask_diff_ac": (P, P, P, P, I, I, I, I, P, I, F, P),
    # x1, x2, out, planes, h, w, walk, seg, taps, stream
    "ce_candidate_moments": (P, P, P, I, I, I, I, I, P, P),
    # x1, out, planes, h, w, walk, seg, taps, stream
    "ce_reference_moments": (P, P, I, I, I, I, I, P, P),
    # dct, q, out, n_q, n_blocks, q_stride, grid, rates, eob, stream
    "ce_trellis_dp": (P, P, P, I, I, I, I, P, F, P),
}


#: Output columns per block of the row-streamed strip kernels, K1, K2, K3,
#: K6, K7 and K9 (``csrc/common.cuh`` ``kStrip``).  Each block also owns a segment of rows,
#: whose length the kernel's wrapper chooses.
STRIP = 128


def segment_rows(blocks_per_segment: int, h: int, choices: tuple, blocks_per_sm: float,
                 sms: int) -> int:
    """Rows per segment of a strip kernel's grid: the longest of ``choices``
    (longest first) for which ``blocks_per_segment`` blocks per segment of
    rows, over ``h`` rows, still give each of ``sms`` SMs ``blocks_per_sm``
    blocks; else the shortest.  A longer segment re-reads fewer halo rows,
    a shorter one spreads a small launch over more of the card."""
    for rows in choices:
        if blocks_per_segment * -(-h // rows) >= blocks_per_sm * sms:
            return rows
    return choices[-1]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(candidate)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcodec_eval_kernels-{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile the sources unless a library for their hash exists; the
    compiler's output goes to ``build_log_path()``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{p.args[-1]}:\n{log}" for p, log in zip(procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        # Link to a private name, then rename: a concurrent build never sees
        # a half-written library.
        lib = Path(tmp) / out.name
        proc = subprocess.run(
            [nvcc, "-shared", *ARCH, "-o", str(lib), *objs],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        log = Path(tmp) / "build.log"
        log.write_text("".join(f"{p.args[-1]}:\n{text}" for p, text in zip(procs, logs)))
        os.replace(log, build_log_path())
        os.replace(lib, out)
    return out


def ptxas_report(kernel: str) -> list[str]:
    """The ``-Xptxas -v`` lines of the build log (registers, shared memory,
    spills) for each entry function whose name contains ``kernel``."""
    lines, keep = [], False
    for line in build_log_path().read_text().splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        elif not line.startswith(("ptxas", " ", "\t")):
            keep = False
        if keep:
            lines.append(line.strip())
    return lines


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")


def require_cuda(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (``None`` entries match any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def ptr(t) -> int:
    """Device pointer of a tensor, or host address of a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.data_ptr()
    return t.ctypes.data


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(fn, device: int, *args) -> int:
    """Call the C entry point ``fn`` with ``args`` and the current stream
    of CUDA device ``device`` (an index), and return its ``cudaError_t``.
    A kernel launches on the current device, so the call enters
    ``device``'s context only when another device is current."""
    if device == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
