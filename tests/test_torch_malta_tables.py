"""The Malta kernels' compiled line tables and the C interface, on the CPU.

K4 and K5 (``codec_eval_tpu_torch/csrc/malta.cu``) compile the two line
patterns in, so no ``nvcc`` or card is needed to check that:

- the ``constexpr`` tables in the source, read as text, equal the port's
  ``LINES_FULL`` / ``LINES_LF`` and the JAX package's ``_MALTA_LINES_FULL`` /
  ``_MALTA_LINES_LF``: every weight and every ``(dy, dx)``, in order;
- the wrappers' table check accepts those tables and refuses any other,
  while a CPU tensor runs the plain version, which takes any tables;
- every C entry point in ``csrc/*.cu`` takes the arguments that
  ``_lib.SIGNATURES`` binds, and the Malta source has no runtime table;
- the build keeps the compiler's ``-Xptxas -v`` report beside the library.
"""

import re
import sys

import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels import butteraugli as jba
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels.cuda import _lib
from codec_eval_tpu_torch.kernels.cuda import malta as tml

SOURCE = (_lib.CSRC / "malta.cu").read_text()


def compiled_table(name: str):
    """The ``constexpr Line <name>[...] = {...};`` table of malta.cu as
    ``((weight, ((dy, dx), ...)), ...)``, checking each line's count."""
    body = re.search(rf"constexpr Line {name}\[\w+\] = \{{(.*?)\n\}};", SOURCE, re.S)
    assert body, f"{name} not found in malta.cu"
    lines = []
    rows = re.findall(r"^\s*\{(-?\d+), (\d+), \{(.*)\}\},?$", body.group(1), re.M)
    for weight, count, samples in rows:
        pairs = tuple(
            (int(dy), int(dx)) for dy, dx in re.findall(r"\{(-?\d+), (-?\d+)\}", samples)
        )
        assert int(count) == len(pairs), f"{name}: count {count} for {len(pairs)} samples"
        lines.append((float(weight), pairs))
    size = re.search(rf"constexpr Line {name}\[(\w+)\]", SOURCE).group(1)
    declared = int(re.search(rf"constexpr int {size} = (\d+);", SOURCE).group(1))
    assert declared == len(lines), f"{name}: {size} = {declared} for {len(lines)} lines"
    return tuple(lines)


@pytest.mark.parametrize(
    "name, port, jax_table",
    [
        ("kLinesFull", tml.LINES_FULL, jba._MALTA_LINES_FULL),
        ("kLinesLf", tml.LINES_LF, jba._MALTA_LINES_LF),
    ],
)
def test_compiled_tables_equal_port_and_jax(name, port, jax_table):
    table = compiled_table(name)
    assert table == port == jax_table
    assert [type(w) for w, _ in port] == [float] * len(port)


def test_port_butteraugli_uses_the_compiled_tables():
    assert tba._MALTA_LINES_FULL is tml.LINES_FULL
    assert tba._MALTA_LINES_LF is tml.LINES_LF


def _changed(which: str):
    full, lf = list(tml.LINES_FULL), list(tml.LINES_LF)
    if which == "weight":
        full[2] = (1.0, full[2][1])
    elif which == "offset":
        weight, line = lf[5]
        lf[5] = (weight, line[:1] + ((line[1][0], line[1][1] + 1),) + line[2:])
    elif which == "dropped line":
        lf = lf[:-1]
    elif which == "sample order":
        weight, line = full[7]
        full[7] = (weight, line[1:] + line[:1])
    elif which == "patterns swapped":
        full, lf = lf, full
    return tuple(full), tuple(lf)


def test_check_tables_accepts_the_compiled_tables():
    tml.check_tables(tml.LINES_FULL, tml.LINES_LF)
    tml.check_tables(jba._MALTA_LINES_FULL, jba._MALTA_LINES_LF)
    # Equal tables in other containers and number types are the same tables.
    as_lists = [[[w, [list(s) for s in line]] for w, line in t]
                for t in (tml.LINES_FULL, tml.LINES_LF)]
    tml.check_tables(*as_lists)
    ints = tuple((int(w), line) for w, line in tml.LINES_FULL)
    tml.check_tables(ints, tml.LINES_LF)


@pytest.mark.parametrize(
    "which", ["weight", "offset", "dropped line", "sample order", "patterns swapped"]
)
def test_check_tables_refuses_other_tables(which):
    with pytest.raises(ValueError, match="compiled for LINES_FULL and LINES_LF"):
        tml.check_tables(*_changed(which))


@pytest.mark.parametrize("which", ["weight", "offset", "dropped line"])
def test_cpu_wrappers_take_any_tables(which):
    """On CPU tensors both wrappers run their plain versions, with whatever
    tables they are given, and launch nothing."""
    rng = np.random.default_rng(7)
    b, h, w = 2, 13, 11

    def planes(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    lines = _changed(which)
    diffs = planes(b, 6, h, w)
    got = tml.malta_ac_batch(diffs, *lines)
    torch.testing.assert_close(got, tml.malta_ac_plain(diffs, *lines), rtol=0, atol=0)
    assert not torch.equal(got, tml.malta_ac_plain(diffs, tml.LINES_FULL, tml.LINES_LF))
    k5 = (planes(b, 6, h, w), planes(6, h, w), planes(b, 4, h, w), planes(4, h, w),
          planes(b, h, w).abs(), planes(2, h, w).abs(), *lines,
          *tba._fused_diffmap_consts(0.8, 1.0))
    torch.testing.assert_close(tml.malta_diffmap_batch(*k5), tml.malta_diffmap_plain(*k5),
                               rtol=0, atol=0)
    assert tml.malta_ac_batch.launches == 0 and tml.malta_diffmap_batch.launches == 0


def test_malta_source_has_no_runtime_tables():
    assert "__constant__" not in SOURCE
    assert "cudaMemcpyToSymbol" not in SOURCE


def _c_params(name: str) -> list:
    """The parameter types of ``extern "C" int <name>(...)`` in csrc/*.cu."""
    for src in _lib.CSRC.glob("*.cu"):
        m = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src.read_text(), re.S)
        if m:
            return [re.sub(r"\s*\b\w+$", "", p.strip()) for p in m.group(1).split(",")]
    raise AssertionError(f"{name} is not defined in csrc/*.cu")


@pytest.mark.parametrize("name", sorted(_lib.SIGNATURES))
def test_c_entry_points_match_their_ctypes_signatures(name):
    kinds = {_lib.P: "pointer", _lib.I: "int", _lib.F: "float"}
    want = [kinds[t] for t in _lib.SIGNATURES[name]]
    got = ["pointer" if p.endswith("*") else p.replace("const ", "") for p in _c_params(name)]
    assert got == want


PTXAS_LOG = """\
/src/malta.cu:
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120malta_diffmap_kernelILi4EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120malta_diffmap_kernelILi4EEEvPKf
    72 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 25600 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110blur_kernelEPKf' for 'sm_90a'
ptxas info    : Used 40 registers, 6400 bytes smem
/src/moments.cu:
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112malta_kernelILi1EEEvPKfPfii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 12800 bytes smem
"""


def test_ptxas_report_keeps_the_named_kernels(monkeypatch, tmp_path):
    log = tmp_path / "build.log"
    log.write_text(PTXAS_LOG)
    monkeypatch.setattr(_lib, "build_log_path", lambda: log)
    report = _lib.ptxas_report("malta")
    assert len(report) == 7
    assert sum("Used 80 registers" in line for line in report) == 2
    assert not any("blur" in line or "gmem" in line or line.endswith(".cu:") for line in report)
    assert _lib.ptxas_report("blur") == [
        line.strip() for line in PTXAS_LOG.splitlines()[6:8]
    ]


FAKE_NVCC = """\
import sys
from pathlib import Path
args = sys.argv[1:]
out = Path(args[args.index("-o") + 1])
out.write_bytes(b"")
if "-c" in args:
    print("ptxas info    : Compiling entry function '_Z" + out.stem + "_kernel' for 'sm_90a'")
    print("ptxas info    : Used 32 registers, 0 bytes smem")
"""


def test_build_writes_the_compiler_report(monkeypatch, tmp_path):
    """The build with a stand-in compiler: one process per source, then the
    link; the library's log holds each source's ``-Xptxas -v`` lines."""
    script = tmp_path / "nvcc.py"
    script.write_text(FAKE_NVCC)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_lib, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "kernels")
    lib = _lib.build()
    assert lib.exists() and lib.parent == tmp_path / "kernels"
    assert "-Xptxas" in _lib.NVCC_FLAGS and "-fmad=false" in _lib.NVCC_FLAGS
    assert _lib.ptxas_report("malta_kernel") == [
        "ptxas info    : Compiling entry function '_Zmalta_kernel' for 'sm_90a'",
        "ptxas info    : Used 32 registers, 0 bytes smem",
    ]
    assert _lib.build() == lib  # built once per hash of sources and flags
