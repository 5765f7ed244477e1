"""Time this checkout's kernels beside another checkout's, in one process.

    python3 -m codec_eval_tpu_torch.kernels.cuda.compare DIR

DIR holds another checkout of the repository, such as the parent commit
unpacked there with ``git archive``.  Its port is imported from its own
files under the name ``parent_port``, so its wrappers launch the kernels
that its own build module builds from its own sources (into
``DIR/build/kernels``).  It first says whether the two libraries hold the
same machine code (``cuobjdump -sass``) for each kernel of ``SAME_SASS``.
For each case of ``cases`` (K1, K2 and both forms of K9 at the shapes of
the batch scorer, the single pair and the masked corpus's 512 and 2048 px
buckets; K6 at the batch path's 2048 and 1024 px, K7 at B = 1 from 2048
down to 256 px; on inputs made from a seed) it prints the largest
difference between the two checkouts' outputs, the mean time of 10 calls
through each wrapper in turns (parent, change, change, parent; CUDA
events) and the device time per call of the kernels that each call
launched (``torch.profiler``).  A wrapper that DIR lacks is timed through
its stand-in in ``STAND_INS``.  For K2, K6, K7 and K9 it also times this
checkout's kernel alone at every segment length and walk, what
``OPSIN_SEGMENTS``, ``blur.SEGMENTS``, ``moments.SEGMENTS`` and
``TILE_MAX_WORK`` were chosen from.  The last line of the output is a JSON
list of every row.  It needs a CUDA device.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SEED = 20240607
CALLS = 10

#: A wrapper that an older checkout lacks -> (the wrapper it has, its
#: arguments from the missing one's, the missing one's outputs from its):
#: K9's reference form is its candidate form with x1 as both inputs, whose
#: mu2 and s22 are mu1 and s11.
STAND_INS = {
    "reference_moments": ("candidate_moments", lambda x1: (x1, x1), lambda out: out[:2]),
}


#: Kernels whose machine code a change of a shared header must leave as it
#: was: K1's and K9's, on the strip walk that K6 and K7 now share.
SAME_SASS = ("scale_features_kernel", "candidate_moments_kernel", "moments_tile_kernel")


def _uniform(rng, shape, scale, device) -> torch.Tensor:
    return torch.from_numpy(rng.random(shape, np.float32) * scale).to(device)


def _opsin(b: int, side: int, device):
    from ..butteraugli import _OPSIN_CONSTS

    def make():
        rng = np.random.default_rng(SEED)
        return [(_uniform(rng, (b, 3, side, side), 80.0, device), _OPSIN_CONSTS)]

    return f"{side} px, B={b}", make


def _features(n: int, side: int, device):
    from ..blur import blur_separable
    from .scale_features import SIGMA

    def make():
        rng = np.random.default_rng(SEED)
        calls = []
        for scale in range(6):
            s = -(-side // 2 ** scale)
            x1 = _uniform(rng, (3, s, s), 1.0, device)
            x2 = (x1 + 0.05 * (_uniform(rng, (n, 3, s, s), 1.0, device) - 0.5)).contiguous()
            calls.append((x1, blur_separable(x1, SIGMA).contiguous(),
                          blur_separable(x1 * x1, SIGMA).contiguous(), x2))
        return calls

    return f"{side} px, B={n}, six scales", make


def _moments(n: int, side: int, inputs: int, device):
    def make():
        rng = np.random.default_rng(SEED)
        return [tuple(_uniform(rng, (n, 3, side, side), 1.0, device) for _ in range(inputs))]

    return f"{side}x{side}, N={n}", make


def _blur(b: int, side: int, device):
    from ..butteraugli import SIGMA_MASK

    def make():
        rng = np.random.default_rng(SEED)
        return [(_uniform(rng, (b, 1, side, side), 10.0, device), SIGMA_MASK)]

    return f"{side} px, B={b}", make


def _mask(side: int, device):
    from ..butteraugli import _MASK_DIFF_AC_MUL, SIGMA_MASK

    def make():
        rng = np.random.default_rng(SEED)
        d1 = _uniform(rng, (1, side, side), 10.0, device)
        b0 = _uniform(rng, (side, side), 10.0, device)
        return [(d1, b0, _MASK_DIFF_AC_MUL, SIGMA_MASK)]

    return f"{side} px, B=1", make


def cases(device) -> dict:
    """{wrapper name: [(label, make)]}: ``make()`` gives the argument
    tuples of one call, each passed to the wrapper in turn."""
    masked = [(n, top // 2 ** s) for n, top in ((8, 512), (2, 2048)) for s in range(6)]
    return {
        "opsin_xyb": [_opsin(b, side, device) for b, side in (
            (25, 512), (25, 256), (10, 2048), (10, 1024), (1, 512), (1, 256), (1, 2048),
            (1, 1024))],
        "scale_features": [_features(25, 512, device), _features(10, 2048, device)],
        "candidate_moments": [_moments(n, side, 2, device) for n, side in masked],
        "reference_moments": [_moments(n, side, 1, device) for n, side in masked],
        "blur": [_blur(10, side, device) for side in (2048, 1024)],
        "mask_diff_ac": [_mask(side, device) for side in (2048, 1024, 512, 256)],
    }


def load_checkout(root: Path, name: str = "parent_port"):
    """The ``kernels.cuda`` package of the port in the checkout at ``root``,
    imported from its own files under ``name``."""
    init = root / "codec_eval_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.kernels.cuda")


def _outputs(result) -> list:
    if isinstance(result, torch.Tensor):
        return [result]
    return [t for r in result for t in _outputs(r)]


def _call(fn, calls: list, args_from=None, out_from=None) -> list:
    outs = [fn(*(args_from(*a) if args_from else a)) for a in calls]
    return [out_from(o) for o in outs] if out_from else outs


def time_ms(fn) -> float:
    """Mean time of one call over ``CALLS`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def launches_per_call(fn, kernels) -> int:
    """Kernel launches of one call of ``fn``, read from the launch counters
    of the ``kernels`` package (``LAUNCHERS``, or ``WRAPPERS`` in a
    checkout that predates K10) that ``fn`` calls into."""
    launchers = getattr(kernels, "LAUNCHERS", kernels.WRAPPERS).values()
    before = sum(w.launches for w in launchers)
    fn()
    return sum(w.launches for w in launchers) - before


def device_ms(fn, per_call: int) -> float | None:
    """Device time per call of the kernels that ``fn`` launches,
    ``per_call`` of them (``torch.profiler`` over ``CALLS`` calls).  The
    profiler may drop launches: a call of one launch takes the mean over
    those it recorded if that is at least half of them; a call of several
    (K1's six scales, of unequal size) needs every one.  Up to three
    tries; None if none is complete."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(("Activity Buffer", "Memcpy", "Memset"))]
        launches = sum(e.count for e in seen)
        if launches == CALLS * per_call or (per_call == 1 and 2 * launches >= CALLS):
            us = sum(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) for e in seen)
            return us / 1e3 / launches * per_call
    return None


def sweep(name: str, calls: list) -> dict:
    """This checkout's K2, K6, K7 or K9 kernel alone at every segment
    length of its strip walk (and K9's tile walk) on one call's
    arguments."""
    from . import blur, freqsep, maskac, moments

    (args,) = calls
    if name in ("blur", "mask_diff_ac"):
        launch = blur._launch if name == "blur" else maskac._launch
        return {f"{seg} rows": device_ms(functools.partial(launch, *args, seg=seg), 1)
                for seg in blur.SEGMENTS}
    if name == "opsin_xyb":
        return {f"{seg} rows": device_ms(functools.partial(freqsep._opsin_launch, *args, seg), 1)
                for seg in freqsep.OPSIN_SEGMENTS}
    form = "candidate" if name == "candidate_moments" else "reference"
    out = {f"{seg} rows": device_ms(functools.partial(
        moments._launch, form, args, moments.STRIP_WALK, seg), 1) for seg in moments.SEGMENTS}
    out["tile"] = device_ms(
        functools.partial(moments._launch, form, args, moments.TILE_WALK, 0), 1)
    return out


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def sass(library: Path, kernel: str) -> list:
    """The instructions of each function of a built library whose name
    contains ``kernel`` (``cuobjdump -sass``, addresses and encodings
    dropped), in name order.  The names themselves carry a hash of the
    source's path, so they are left out."""
    from . import _lib

    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = []
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name, rest = body.split("\n", 1)
        if kernel in name:
            out.append((re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", name.strip()),
                        re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", rest)))
    return [code for _, code in sorted(out)]


def same_sass(parent) -> dict:
    """{kernel: whether both checkouts' libraries compile each of its
    functions to the same instructions} for the kernels of ``SAME_SASS``."""
    from . import _lib

    out = {}
    for kernel in SAME_SASS:
        old, new = sass(parent._lib.library_path(), kernel), sass(_lib.library_path(), kernel)
        out[kernel] = bool(new) and old == new
        print(f"{kernel}: {len(new)} functions, {sum(map(len, new))} instructions, "
              f"{'the same machine code as' if out[kernel] else 'other machine code than'} "
              f"the parent's ({sum(map(len, old))} instructions)")
    return out


def compare(parent) -> list:
    change = importlib.import_module(__package__)
    WRAPPERS = change.WRAPPERS
    device = torch.device("cuda", 0)
    rows = []
    for name, todo in cases(device).items():
        fn, args_from, out_from = WRAPPERS[name], None, None
        if name in parent.WRAPPERS:
            old = parent.WRAPPERS[name]
        else:
            stand_in, args_from, out_from = STAND_INS[name]
            old = parent.WRAPPERS[stand_in]
        for label, make in todo:
            calls = make()
            new_call = functools.partial(_call, fn, calls)
            old_call = functools.partial(_call, old, calls, args_from, out_from)
            got, want = _outputs(new_call()), _outputs(old_call())
            if len(got) != len(want):
                raise AssertionError(f"{name} {label}: {len(got)} outputs, "
                                     f"the parent's {len(want)}")
            diff = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
            p1, n1, n2, p2 = (time_ms(f) for f in (old_call, new_call, new_call, old_call))
            row = {"kernel": name, "case": label, "max_abs_diff": diff,
                   "ms": (n1 + n2) / 2, "parent_ms": (p1 + p2) / 2,
                   "alone_ms": device_ms(new_call, launches_per_call(new_call, change)),
                   "parent_alone_ms": device_ms(old_call, launches_per_call(old_call, parent))}
            if name in ("opsin_xyb", "candidate_moments", "reference_moments", "blur",
                        "mask_diff_ac"):
                row["alone_ms_by_walk"] = sweep(name, calls)
            walks = row.get("alone_ms_by_walk", {})
            print(f"{name} {label}: change {row['ms']:.4f} ms (alone {_ms(row['alone_ms'])}), "
                  f"parent {row['parent_ms']:.4f} ms (alone {_ms(row['parent_alone_ms'])}), "
                  f"max |difference| {diff:.3e}"
                  + "".join(f"; {k} {_ms(v)}" for k, v in walks.items()))
            rows.append(row)
            del calls, got, want
    return rows


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    parent = load_checkout(Path(argv[0]).resolve())
    parent._lib.load()  # built before anything is timed
    importlib.import_module(__package__)._lib.load()
    sass_rows = [{"kernel": k, "same_sass": v} for k, v in same_sass(parent).items()]
    rows = compare(parent)
    print(json.dumps(sass_rows + rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
