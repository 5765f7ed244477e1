"""The port's command-line tools against the JAX package's, on the CPU.

The cases of ``tests/test_cli.py`` and ``tests/test_cli_values.py`` run
through both packages' ``main`` on the same inputs, the port's commands
that do device work with ``--device cpu``:

- exit codes, and the printed text with every number in place: integers
  equal, each printed decimal within one unit of its last digit plus the
  loosest score tier (5e-4 relative), timings masked;
- the written files: the same names, CSV headers and key columns, JSON
  keys; full-precision scores at the port's tiers (SSIMULACRA2 rtol 1e-5,
  DSSIM rtol 1e-5 with atol 1e-5 against JAX's f32 form, Butteraugli rtol
  5e-4);
- the JAX tests' own value checks, on the port's output.

Both sessions decode an adapter's JPEG streams with their device JPEG
decoders (the port's on the CPU here).  The device JPEG ladder's paths
(``--format tpujpeg``, ``--device-sweep``, ``target``, and the zenjpeg
slot of ``--formats jpeg|all``) run in both packages and write the same
files.
"""

import csv
import json
import re
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import codec_eval_tpu.cli.codec_analyze as j_analyze
import codec_eval_tpu.cli.codec_compare as j_compare
import codec_eval_tpu.cli.codec_eval as j_eval
import codec_eval_tpu.cli.codec_iter as j_iter
import codec_eval_tpu.cli.rd_calibrate as j_rd
import codec_eval_tpu_torch.cli.codec_analyze as t_analyze
import codec_eval_tpu_torch.cli.codec_compare as t_compare
import codec_eval_tpu_torch.cli.codec_eval as t_eval
import codec_eval_tpu_torch.cli.codec_iter as t_iter
import codec_eval_tpu_torch.cli.rd_calibrate as t_rd
from test_torch_dssim import jax_dssim_x64

REPO = Path(__file__).resolve().parent.parent
TIERS = {
    "ssimulacra2": dict(rtol=1e-5, atol=0.0),
    "dssim": dict(rtol=1e-5, atol=1e-5),
    "butteraugli": dict(rtol=5e-4, atol=0.0),
}
CSV_ROWS = (
    "image,codec,quality,bpp,ssimulacra2\n"
    "a,x,50,1.0,70\na,x,90,2.0,90\na,y,50,0.9,72\na,y,90,1.8,91\n"
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_cli.py``'s two 48 x 48 images."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(4)
    for i in range(2):
        y, x = np.mgrid[0:48, 0:48]
        base = 110 + 20 * i + 50 * np.sin(x / (5 + i)) + 40 * np.cos(y / 7)
        img = np.clip(
            np.stack([base, base * 0.9, base * 0.8], -1)
            + rng.normal(0, 6, (48, 48, 3)),
            0,
            255,
        ).astype(np.uint8)
        Image.fromarray(img).save(root / f"im{i}.png")
    return root


@dataclass
class Run:
    rc: int
    out: str
    err: str
    dir: Path


def run_both(capsys, tmp_path, jax_mod, port_mod, argv, device=True):
    """``argv(d)`` through the JAX tool and the port's (with ``--device
    cpu`` where the command scores), each writing under its own directory
    ``d``; paths to ``d`` in the output read ``<dir>``."""
    runs = []
    port_extra = ["--device", "cpu"] if device else []
    for side, mod, extra in (("jax", jax_mod, []), ("port", port_mod, port_extra)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        rc = mod.main([str(a) for a in argv(d)] + extra)
        cap = capsys.readouterr()
        runs.append(Run(rc, cap.out.replace(str(d), "<dir>"), cap.err.replace(str(d), "<dir>"), d))
    return runs


NUM = re.compile(r"[-+]?\d+(?:\.\d+)?")


def assert_same_text(got: str, want: str, masks=(), rtol: float = 5e-4, atol: float = 0.0) -> None:
    """The same text with the numbers in place: integers equal, decimals
    within one unit of the printed last digit plus ``rtol`` relative and
    ``atol``."""
    for pattern in masks:
        got = re.sub(pattern, "#", got, flags=re.M)
        want = re.sub(pattern, "#", want, flags=re.M)
    assert NUM.split(got) == NUM.split(want), (got, want)
    for g, w in zip(NUM.findall(got), NUM.findall(want)):
        if "." not in w:
            assert g == w, (g, w)
        else:
            unit = 10.0 ** -len(w.split(".")[1])
            bound = 1.0001 * unit + rtol * abs(float(w)) + atol
            assert abs(float(g) - float(w)) <= bound, (g, w)


def assert_scores(got: dict, want: dict, keys=TIERS) -> None:
    for k in keys:
        if want.get(k) is None:
            assert got.get(k) is None, k
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TIERS[k])


def files_under(d: Path) -> list:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def read_csv(path: Path) -> list:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def assert_same_csv(got: Path, want: Path, timings=()) -> None:
    """The same header and rows, numbers as ``assert_same_text`` has them;
    the columns named in ``timings`` are left out."""
    got_rows, want_rows = read_csv(got), read_csv(want)
    assert got_rows[0] == want_rows[0] and len(got_rows) == len(want_rows)
    keep = [i for i, name in enumerate(want_rows[0]) if name not in timings]
    for g, w in zip(got_rows[1:], want_rows[1:]):
        assert_same_text(",".join(g[i] for i in keep), ",".join(w[i] for i in keep))


def json_keys(obj):
    """The structure of a JSON value: its keys and lengths, not its numbers."""
    if isinstance(obj, dict):
        return {k: json_keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [json_keys(v) for v in obj]
    return type(obj).__name__


# -- codec-iter -------------------------------------------------------------

TOTAL_MS = r"^total: \d+ ms$"
ENC_MS_COLUMN = r"(?<=\d) +\d+$"  # the first-run table's last column, encode ms


def test_codec_iter_eval_and_baseline_delta_columns(corpus, tmp_path, capsys):
    """``tests/test_cli.py::test_codec_iter_eval`` and
    ``tests/test_cli_values.py::test_codec_iter_baseline_delta_columns``."""
    def argv(d):
        return ["eval", "--corpus", corpus, "--limit", "2", "--preset", "quick",
                "--baseline-dir", d / "baselines"]

    first = run_both(capsys, tmp_path, j_iter, t_iter, argv)
    second = run_both(capsys, tmp_path, j_iter, t_iter, argv)
    for jax_run, port_run in (first, second):
        assert jax_run.rc == port_run.rc == 0
        assert port_run.err == jax_run.err == ""
    assert_same_text(first[1].out, first[0].out, masks=(TOTAL_MS, ENC_MS_COLUMN))
    assert_same_text(second[1].out, second[0].out, masks=(TOTAL_MS,))

    name = "baselines/jpeg-420-ycbcr-prog.json"
    want = json.loads((first[0].dir / name).read_text())
    got = json.loads((first[1].dir / name).read_text())
    assert json_keys(got) == json_keys(want)
    assert got["config_summary"] == want["config_summary"] == "jpeg-420-ycbcr-prog"
    assert len(got["points"]) == 2 * 3
    for g, w in zip(got["points"], want["points"]):
        for k in ("image", "quality", "bpp", "size_bytes"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["ssim2"], w["ssim2"], **TIERS["ssimulacra2"])

    # The JAX test's own checks, on the port's output: the first run prints
    # the per-quality means of the saved points, the second zero deltas.
    by_q = {}
    for pt in got["points"]:
        by_q.setdefault(pt["quality"], []).append(pt)
    for q, pts in by_q.items():
        bpp = sum(p["bpp"] for p in pts) / len(pts)
        s2 = sum(p["ssim2"] for p in pts) / len(pts)
        assert re.search(rf"^\s*{q}\s+{bpp:.3f}\s+{s2:.2f}\b", first[1].out, re.M)
    rows = re.findall(
        r"^\s*\d+\s+[\d.]+\s+[\d.]+\s+([+-][\d.]+)\s+([+-][\d.]+)\s+([+-][\d.]+)\s*$",
        second[1].out, re.M,
    )
    assert len(rows) == 3
    assert all(float(v) == 0.0 for row in rows for v in row)


def test_codec_iter_sweep_and_baseline_save_show(corpus, tmp_path, capsys):
    sweep = run_both(capsys, tmp_path, j_iter, t_iter, lambda d: [
        "sweep", "--corpus", corpus, "--limit", "2", "--preset", "quick"])
    assert sweep[0].rc == sweep[1].rc == 0
    assert "Sweep over 4 configs" in sweep[1].out
    assert_same_text(sweep[1].out, sweep[0].out, masks=(r" +\d+ms", ))

    def save(d):
        return ["baseline", "save", "--corpus", corpus, "--limit", "1", "--format", "webp",
                "--baseline-dir", d / "b"]

    saved = run_both(capsys, tmp_path, j_iter, t_iter, save)
    assert saved[0].rc == saved[1].rc == 0
    assert saved[1].out == saved[0].out == "baseline saved: <dir>/b/webp-m4.json\n"
    shown = run_both(capsys, tmp_path, j_iter, t_iter, lambda d: [
        "baseline", "show", "webp-m4", "--baseline-dir", d / "b"], device=False)
    assert shown[0].rc == shown[1].rc == 0
    assert_same_text(shown[1].out, shown[0].out,
                     masks=(r"created \S+,", ENC_MS_COLUMN))
    missing = run_both(capsys, tmp_path, j_iter, t_iter, lambda d: [
        "baseline", "show", "nothing", "--baseline-dir", d / "b"], device=False)
    assert missing[0].rc == missing[1].rc == 1 and missing[1].out == missing[0].out


def test_codec_iter_device_ladder_paths_equal_jax(corpus, tmp_path, capsys):
    """``tpujpeg``, ``eval --device-sweep`` and ``target`` run on the device
    JPEG ladder in both packages: the same exit codes, tables and baseline
    files; the argument errors exit 2 as in JAX."""
    base = ["--corpus", str(corpus), "--limit", "2", "--preset", "quick"]
    cases = [
        (["eval", *base, "--format", "tpujpeg"], (TOTAL_MS, ENC_MS_COLUMN)),
        (["eval", *base, "--format", "tpujpeg", "--device-sweep"], (TOTAL_MS, ENC_MS_COLUMN)),
        (["eval", *base, "--format", "tpujpeg", "--device-sweep", "--size-mode", "device",
          "--trellis"], (TOTAL_MS, ENC_MS_COLUMN)),
        (["sweep", *base, "--format", "tpujpeg"], (r" +\d+ms", )),
        (["baseline", "save", *base, "--format", "tpujpeg", "--xyb"], ()),
        (["target", *base, "--min-ssim2", "75", "--max-bpp", "3"], ()),
    ]
    for argv, masks in cases:
        runs = run_both(capsys, tmp_path, j_iter, t_iter,
                        lambda d, a=argv: a + ["--baseline-dir", d / "b"]
                        if a[0] != "target" else a + ["--out", d / "out"])
        assert runs[0].rc == runs[1].rc == 0, (argv, runs[1].err)
        assert runs[1].err == runs[0].err == ""
        assert_same_text(runs[1].out, runs[0].out, masks=masks)
        assert files_under(runs[1].dir) == files_under(runs[0].dir)
    # The baselines' points and the target's files.
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    for name in files_under(port / "b"):
        got = json.loads((port / "b" / name).read_text())
        want = json.loads((jax_dir / "b" / name).read_text())
        assert got["config_summary"] == want["config_summary"]
        for g, w in zip(got["points"], want["points"], strict=True):
            assert (g["image"], g["quality"], g["size_bytes"]) == (
                w["image"], w["quality"], w["size_bytes"])
            np.testing.assert_allclose(g["ssim2"], w["ssim2"], **TIERS["ssimulacra2"])
    assert {"tpujpeg-420-aq-device.json", "tpujpeg-420-trellis-device.json",
            "tpujpeg-xyb-aq-prog.json", "tpujpeg-420-aq-prog.json"} <= set(files_under(port / "b"))
    for name in files_under(port / "out"):
        assert (port / "out" / name).read_bytes() == (jax_dir / "out" / name).read_bytes()
    assert len(files_under(port / "out")) == 2

    # Argument errors, as in JAX: --device-sweep without tpujpeg, target
    # without a floor (tests/test_cli.py, tests/test_cli_values.py).
    for argv in (["eval", *base, "--format", "jpeg", "--device-sweep"], ["target", *base]):
        runs = run_both(capsys, tmp_path, j_iter, t_iter, lambda d, a=argv: a)
        assert runs[0].rc == runs[1].rc == 2
        assert (runs[1].out, runs[1].err) == (runs[0].out, runs[0].err)


# -- codec-eval ---------------------------------------------------------------


def test_codec_eval_corpus_and_stats(corpus, tmp_path, capsys):
    """``tests/test_cli.py::test_codec_eval_corpus_and_stats``."""
    results = tmp_path / "r.csv"
    results.write_text(CSV_ROWS)
    for argv in (
        lambda d: ["corpus", "discover", corpus],
        lambda d: ["corpus", "info", corpus],
        lambda d: ["corpus", "list", corpus],
        lambda d: ["import", results, "--output", d / "r.json"],
        lambda d: ["import", results],
        lambda d: ["pareto", results, "--per-codec", "--metric", "ssimulacra2"],
        lambda d: ["stats", results, "--by-image"],
        lambda d: ["stats", results, "--metric", "dssim"],
    ):
        runs = run_both(capsys, tmp_path, j_eval, t_eval, argv, device=False)
        assert runs[0].rc == runs[1].rc
        assert (runs[1].out, runs[1].err) == (runs[0].out, runs[0].err)
    assert "2 images" in run_both(capsys, tmp_path, j_eval, t_eval,
                                  lambda d: ["corpus", "discover", corpus], device=False)[1].out
    got = json.loads((tmp_path / "port" / "r.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "r.json").read_text())
    assert got[0]["codec"] == "x"


def test_pareto_front_points_pinned(tmp_path, capsys):
    """``tests/test_cli_values.py::test_pareto_front_points_pinned``."""
    f = tmp_path / "r.csv"
    f.write_text(CSV_ROWS)
    runs = run_both(capsys, tmp_path, j_eval, t_eval, lambda d: ["pareto", f], device=False)
    assert runs[0].rc == runs[1].rc == 0 and runs[1].out == runs[0].out
    out = runs[1].out
    assert "2 of 4 points" in out
    assert re.search(r"y\s+q=50\s+bpp=0\.9000\s+ssimulacra2=72\.0000", out)
    assert re.search(r"y\s+q=90\s+bpp=1\.8000\s+ssimulacra2=91\.0000", out)
    assert "q=50     bpp=1.0000" not in out


def test_stats_table_values_pinned(tmp_path, capsys):
    """``tests/test_cli_values.py::test_stats_table_values_pinned``."""
    f = tmp_path / "r.csv"
    f.write_text(CSV_ROWS)
    runs = run_both(capsys, tmp_path, j_eval, t_eval, lambda d: ["stats", f], device=False)
    assert runs[0].rc == runs[1].rc == 0 and runs[1].out == runs[0].out
    out = runs[1].out
    assert "mean=80.7500" in out and "median=81.0000" in out
    assert "p5=70.3000" in out and "p95=90.8500" in out
    assert re.search(r"x\s+n=2\s+mean=80\.0000", out)
    assert re.search(r"y\s+n=2\s+mean=81\.5000", out)


def test_sparse_clone_set_fetch_cli(tmp_path, capsys):
    """``tests/test_cli_values.py::test_sparse_clone_set_fetch_cli`` through
    the port: the printed file counts track the sparse patterns."""
    origin = tmp_path / "origin"
    origin.mkdir()
    env = {
        "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
        "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
        "HOME": str(tmp_path), "PATH": "/usr/bin:/bin:/usr/local/bin",
    }

    def git(cwd, *args):
        subprocess.run(["git", *args], cwd=cwd, check=True, capture_output=True, env=env)

    git(origin, "init", "-q", "-b", "main")
    (origin / "photo").mkdir()
    (origin / "photo" / "a.png").write_bytes(b"a")
    (origin / "photo" / "b.png").write_bytes(b"b")
    (origin / "art").mkdir()
    (origin / "art" / "c.png").write_bytes(b"c")
    git(origin, "add", "-A")
    git(origin, "commit", "-q", "-m", "init")

    def status(d):
        assert t_eval.main(["sparse", "status", str(d)]) == 0
        m = re.search(r"enabled: True; files: (\d+)/(\d+)", capsys.readouterr().out)
        assert m
        return int(m.group(1)), int(m.group(2))

    target = tmp_path / "clone"
    assert t_eval.main(["sparse", "clone", f"file://{origin}", str(target)]) == 0
    assert "cloned" in capsys.readouterr().out
    assert t_eval.main(["sparse", "set", str(target), "photo"]) == 0
    capsys.readouterr()
    assert status(target) == (2, 3)
    (origin / "photo" / "d.png").write_bytes(b"d")
    git(origin, "add", "-A")
    git(origin, "commit", "-q", "-m", "more")
    assert t_eval.main(["sparse", "fetch", str(target)]) == 0
    assert t_eval.main(["sparse", "pull", str(target)]) == 0
    capsys.readouterr()
    assert status(target) == (3, 4)


# -- codec-compare ----------------------------------------------------------

STATS_ENC_MS = r"(?<=\d) +\d+\.\d(?= +(?:baseline|n/a|[-+]?\d))"  # the stats table's enc ms


def _corpus_results(path: Path) -> list:
    data = json.loads(path.read_text())
    return [(img["name"], r) for img in data["images"] for r in img["results"]]


def test_codec_compare_run_equals_jax(corpus, tmp_path, capsys):
    """``tests/test_cli.py::test_codec_compare_run`` with ``jpeg,webp``, all
    perceptual metrics."""
    runs = run_both(capsys, tmp_path, j_compare, t_compare, lambda d: [
        "run", corpus, "--formats", "jpeg,webp", "--qualities", "60,90",
        "--output", d / "reports", "--name", "smoke"])
    jax_run, port_run = runs
    assert jax_run.rc == port_run.rc == 0
    assert_same_text(port_run.out, jax_run.out, masks=(STATS_ENC_MS,))
    assert "comparing 5 codecs on 2 images" in port_run.out
    assert files_under(port_run.dir) == files_under(jax_run.dir)

    rows = read_csv(port_run.dir / "reports" / "smoke.csv")
    assert len(rows) == 1 + 2 * 5 * 2  # 2 images x (4 jpeg + webp) x 2 qualities
    got = _corpus_results(port_run.dir / "reports" / "smoke.json")
    want = _corpus_results(jax_run.dir / "reports" / "smoke.json")
    assert len(got) == len(want) == 20
    for (name, g), (jname, w) in zip(got, want):
        assert (name, g["codec_id"], g["quality"], g["file_size"], g["bits_per_pixel"]) == (
            jname, w["codec_id"], w["quality"], w["file_size"], w["bits_per_pixel"])
        assert json_keys(g) == json_keys(w)
        assert_scores(g["metrics"], w["metrics"])
    for name in ("stats.json", "pareto.json"):
        g = json.loads((port_run.dir / "reports" / name).read_text())
        assert json_keys(g) == json_keys(json.loads((jax_run.dir / "reports" / name).read_text()))

    # The written DSSIM against JAX's f64 form, on the same candidates: each
    # adapter's stream again (the same size as the written one), decoded as
    # the session decodes it (JPEG streams on the device).
    from codec_eval_tpu_torch.codecs import (
        CodecRegistry,
        CompareConfig,
        FormatSelection,
        decode_jpeg_device,
    )
    from codec_eval_tpu_torch.engine.image import ImageData
    from codec_eval_tpu_torch.engine.session import EncodeRequest

    registry = CodecRegistry(CompareConfig.new(tmp_path / "unused").with_formats(
        FormatSelection(jpeg=True, webp=True)), device="cpu")
    registry.register_all()
    impls = {c.id(): c for c in registry.codecs}
    for image in ("im0", "im1"):
        data = ImageData.open(corpus / f"{image}.png")
        ref = np.array(data.to_rgb8_srgb())
        cells = [r for name, r in got if name == image]
        cands = []
        for r in cells:
            impl = impls[r["codec_id"]]
            stream = impl.encode(data, EncodeRequest(quality=r["quality"]))
            assert len(stream) == r["file_size"]
            cands.append(decode_jpeg_device(stream, device="cpu") if impl.format() == "jpg"
                         else impl.decode(stream).to_rgb8_srgb())
        np.testing.assert_allclose([r["metrics"]["dssim"] for r in cells],
                                   jax_dssim_x64(ref, np.stack(cands)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("formats", ["jpeg", "all"])
@pytest.mark.parametrize("cmd", ["run", "list"])
def test_codec_compare_zenjpeg_presets_equal_jax(corpus, tmp_path, capsys, formats, cmd):
    """``--formats jpeg`` and ``all`` select zenjpeg, tpujpeg's eight
    presets, whose ladders run on the device in both packages: the same
    listing, table and reports."""
    runs = run_both(capsys, tmp_path, j_compare, t_compare, lambda d: (
        [cmd] + ([corpus, "--qualities", "60,90", "--fast-metrics", "--name", "z"]
                 if cmd == "run" else []) + ["--formats", formats, "--output", d / "reports"]),
        device=cmd == "run")
    jax_run, port_run = runs
    assert jax_run.rc == port_run.rc == 0
    assert port_run.err == jax_run.err
    assert_same_text(port_run.out, jax_run.out, masks=(STATS_ENC_MS,))
    assert "tpujpeg-420-aq" in port_run.out and "tpujpeg-xyb-trellis" in port_run.out
    assert files_under(port_run.dir) == files_under(jax_run.dir)
    if cmd == "run":
        got = _corpus_results(port_run.dir / "reports" / "z.json")
        want = _corpus_results(jax_run.dir / "reports" / "z.json")
        assert len(got) == len(want) >= 2 * 12 * 2  # 4 PIL JPEG + 8 tpujpeg codecs
        for (name, g), (jname, w) in zip(got, want, strict=True):
            assert (name, g["codec_id"], g["quality"], g["file_size"]) == (
                jname, w["codec_id"], w["quality"], w["file_size"])
            assert_scores(g["metrics"], w["metrics"])


def test_codec_compare_single_and_report_values(corpus, tmp_path, capsys):
    """``tests/test_cli_values.py::test_codec_compare_single_and_report_values``
    with ``jpeg,webp``: ``single``'s table and JSON equal JAX's, and
    ``report`` regenerates the same statistics from the saved corpus JSON."""
    single = run_both(capsys, tmp_path, j_compare, t_compare, lambda d: [
        "single", corpus / "im0.png", "--formats", "jpeg,webp", "--qualities", "60,90",
        "--fast-metrics", "--output", d / "single"])
    assert single[0].rc == single[1].rc == 0
    assert_same_text(single[1].out, single[0].out)
    rows = re.findall(r"^(jpeg-\S+|webp)\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+", single[1].out, re.M)
    assert len(rows) == 10  # (4 jpeg variants + webp) x 2 qualities
    by_codec = {}
    for codec, q, bpp, s2 in rows:
        by_codec.setdefault(codec, {})[int(q)] = (float(bpp), float(s2))
    for codec, pts in by_codec.items():
        assert pts[90][0] > pts[60][0] and pts[90][1] > pts[60][1], (codec, pts)
    data = json.loads((single[1].dir / "single" / "im0.json").read_text())
    jdata = json.loads((single[0].dir / "single" / "im0.json").read_text())
    assert json_keys(data) == json_keys(jdata)
    for r, j in zip(data["results"], jdata["results"]):
        assert (r["codec_id"], r["quality"], r["file_size"]) == (
            j["codec_id"], j["quality"], j["file_size"])
        assert_scores(r["metrics"], j["metrics"])
    want = {(r["codec_id"], int(r["quality"])): r["metrics"]["ssimulacra2"]
            for r in data["results"]}
    for codec, q, _, s2 in rows:
        assert float(s2) == pytest.approx(want[(codec, int(q))], abs=5.1e-3)

    runs = run_both(capsys, tmp_path, j_compare, t_compare, lambda d: [
        "run", corpus, "--formats", "jpeg,webp", "--qualities", "60,90", "--fast-metrics",
        "--output", d / "run", "--name", "rpt"])
    assert runs[0].rc == runs[1].rc == 0
    report = run_both(capsys, tmp_path, j_compare, t_compare, lambda d: [
        "report", d / "run" / "rpt.json", "--output", d / "regen"], device=False)
    assert report[0].rc == report[1].rc == 0
    assert_same_text(report[1].out, report[0].out, masks=(STATS_ENC_MS,))
    stats = json.loads((report[1].dir / "regen" / "stats.json").read_text())
    bpps = {}
    for _, r in _corpus_results(runs[1].dir / "run" / "rpt.json"):
        bpps.setdefault(r["codec_id"], []).append(r["bits_per_pixel"])
    for codec_stats in stats["codecs"]:
        cid = codec_stats["codec_id"]
        assert codec_stats["avg_bpp"] == pytest.approx(sum(bpps[cid]) / len(bpps[cid]), rel=1e-6)
        assert re.search(rf"{re.escape(cid)}\s", report[1].out)
    assert (report[1].dir / "regen" / "pareto.svg").exists()
    assert files_under(report[1].dir / "regen") == files_under(report[0].dir / "regen")


def test_codec_compare_csv_matches_direct_kernel(corpus, tmp_path, capsys):
    """``tests/test_cli_values.py::test_codec_compare_csv_matches_direct_kernel``:
    a CSV row of the port's ``run`` against the port's single-pair
    SSIMULACRA2 and the JAX package's on the same pair, decoded as the
    session decodes it (the device JPEG decode, within one code value of
    JAX's)."""
    import io

    import jax.numpy as jnp

    from codec_eval_tpu.kernels.ssimulacra2 import ssimulacra2 as jax_ssimulacra2
    from codec_eval_tpu_torch.metrics import calculate_ssimulacra2

    out = tmp_path / "reports"
    assert t_compare.main(["run", str(corpus), "--formats", "jpeg,webp", "--qualities", "85",
                           "--output", str(out), "--name", "vals", "--device", "cpu"]) == 0
    capsys.readouterr()
    with open(out / "vals.csv") as f:
        rows = list(csv.DictReader(f))
    row = next(r for r in rows if r["image"] == "im0" and r["codec"] == "jpeg-420-prog"
               and float(r["quality"]) == 85.0)
    ref = np.asarray(Image.open(corpus / "im0.png").convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(ref).save(buf, "JPEG", quality=85, subsampling=2, progressive=True,
                              optimize=True)
    from codec_eval_tpu.codecs.jpeg_device import decode_jpeg_device as jax_decode
    from codec_eval_tpu_torch.codecs import decode_jpeg_device
    from test_torch_jpeg_enc import assert_candidates_close

    dec = decode_jpeg_device(buf.getvalue(), device="cpu")
    assert_candidates_close(dec, jax_decode(buf.getvalue()))
    mine = calculate_ssimulacra2(ref, dec, device="cpu")
    want = float(jax_ssimulacra2(jnp.asarray(ref), jnp.asarray(dec)))
    assert mine == pytest.approx(want, rel=1e-5)
    assert float(row["ssimulacra2"]) == pytest.approx(mine, abs=5.1e-3)
    assert float(row["bpp"]) == pytest.approx(len(buf.getvalue()) * 8.0 / (48 * 48), abs=1e-4)


# -- codec-analyze ----------------------------------------------------------


def test_codec_analyze_pipeline_equals_jax(corpus, tmp_path, capsys):
    """``tests/test_cli.py::test_codec_analyze_pipeline``: the comparison
    CSV, the heuristics CSV, and every analysis printed from them, with the
    JSONL checkpoint resumed on a second run."""
    def full(d):
        return ["full-comparison", corpus, "--codec-a", "jpeg:420", "--codec-b", "jpeg:444",
                "--q-min", "50", "--q-max", "90", "--q-step", "20", "--output", d / "fc.csv",
                "--checkpoint", d / "ck.jsonl"]

    runs = run_both(capsys, tmp_path, j_analyze, t_analyze, full)
    assert runs[0].rc == runs[1].rc == 0
    assert runs[1].out == runs[0].out
    assert_same_csv(runs[1].dir / "fc.csv", runs[0].dir / "fc.csv", timings=("encode_ms",))
    assert len(read_csv(runs[1].dir / "fc.csv")) == 1 + 2 * 2 * 3
    first = (runs[1].dir / "fc.csv").read_text()
    again = run_both(capsys, tmp_path, j_analyze, t_analyze, full)
    assert again[1].rc == 0 and again[1].out == again[0].out
    assert "resumed 4 completed units" in again[1].out
    assert (again[1].dir / "fc.csv").read_text() == first

    heur = run_both(capsys, tmp_path, j_analyze, t_analyze,
                    lambda d: ["heuristics", corpus, "--output", d / "h.csv"])
    assert heur[0].rc == heur[1].rc == 0 and heur[1].out == heur[0].out
    assert_same_csv(heur[1].dir / "h.csv", heur[0].dir / "h.csv")

    for argv, device in (
        (lambda d: ["find-outliers", d / "fc.csv"], False),
        (lambda d: ["find-outliers", d / "fc.csv", "--format", "json", "--top", "1"], False),
        (lambda d: ["find-outliers", d / "fc.csv", "--format", "csv"], False),
        (lambda d: ["rd-compare", d / "fc.csv", "--targets", "1.0,2.0,2.5,3.0"], False),
        (lambda d: ["rd-compare", d / "fc.csv", "--targets", "1.0"], False),
        (lambda d: ["build-predictor", d / "fc.csv", d / "h.csv"], False),
        (lambda d: ["analyze-image", corpus / "im1.png"], True),
    ):
        runs = run_both(capsys, tmp_path, j_analyze, t_analyze, argv, device=device)
        assert runs[0].rc == runs[1].rc == 0
        # The analyses read the comparison CSV: a value there rounded the
        # other way moves what they print by up to its step (1e-4 for
        # Butteraugli, the finest score column they read).
        assert_same_text(runs[1].out, runs[0].out, atol=1e-4)


@pytest.mark.parametrize("spec", ["tpujpeg", "tpujpeg:xyb", "tpujpeg:trellis:444"])
def test_codec_analyze_tpujpeg_specs_equal_jax(corpus, tmp_path, capsys, spec):
    """``tpujpeg`` specs run in both packages: the same comparison CSV."""
    runs = run_both(capsys, tmp_path, j_analyze, t_analyze, lambda d: [
        "full-comparison", corpus, "--codec-b", spec, "--q-min", "40", "--q-max", "90",
        "--q-step", "25", "--output", d / "fc.csv"])
    assert runs[0].rc == runs[1].rc == 0
    assert_same_text(runs[1].out, runs[0].out)
    got, want = read_csv(runs[1].dir / "fc.csv"), read_csv(runs[0].dir / "fc.csv")
    assert got[0] == want[0] and len(got) == len(want) == 1 + 2 * 2 * 3
    assert_same_csv(runs[1].dir / "fc.csv", runs[0].dir / "fc.csv", timings=("encode_ms",))


# -- rd-calibrate -------------------------------------------------------------

#: ``tests/test_cli_values.py``'s pinned knee: (bpp, ssimulacra2, degrees).
PINNED_S2_KNEE = (2.8715, 93.42, 76.5)


def test_rd_calibrate_knee_geometry_equals_jax(corpus, tmp_path, capsys):
    """``tests/test_cli.py::test_rd_calibrate`` and
    ``tests/test_cli_values.py::test_rd_calibrate_knee_geometry``."""
    runs = run_both(capsys, tmp_path, j_rd, t_rd, lambda d: [
        corpus, "--range", "30:10:90", "--output", d / "cal"])
    jax_run, port_run = runs
    assert jax_run.rc == port_run.rc == 0
    assert_same_text(port_run.out, jax_run.out, masks=(r"^sweep complete in [\d.]+s$",))
    assert files_under(port_run.dir) == files_under(jax_run.dir) == [
        "cal/calibration.json", "cal/calibration.py", "cal/rd_curve.svg"]
    assert "RDCalibration" in (port_run.dir / "cal" / "calibration.py").read_text()
    assert_same_text((port_run.dir / "cal" / "calibration.py").read_text(),
                     (jax_run.dir / "cal" / "calibration.py").read_text())
    got = json.loads((port_run.dir / "cal" / "calibration.json").read_text())
    want = json.loads((jax_run.dir / "cal" / "calibration.json").read_text())
    assert json_keys(got) == json_keys(want)
    assert (got["corpus"], got["codec"], got["image_count"]) == (
        want["corpus"], want["codec"], want["image_count"])
    for metric, tier in (("ssimulacra2", 1e-5), ("butteraugli", 5e-4)):
        assert got[metric]["bpp"] == want[metric]["bpp"]
        np.testing.assert_allclose(got[metric]["score"], want[metric]["score"], rtol=tier)
        np.testing.assert_allclose(got[metric]["angle"], want[metric]["angle"], rtol=1e-4)

    m = re.search(r"s2 knee: ([\d.]+) bpp @ ([\d.]+) \(([\d.]+) deg\)", port_run.out)
    s2_bpp, s2_val, s2_angle = map(float, m.groups())
    assert s2_bpp == pytest.approx(PINNED_S2_KNEE[0], abs=0.08)
    assert s2_val == pytest.approx(PINNED_S2_KNEE[1], abs=1.5)
    assert s2_angle == pytest.approx(PINNED_S2_KNEE[2], abs=1.0)
    assert f"bpp={s2_bpp:.4f}" in (port_run.dir / "cal" / "calibration.py").read_text()


@pytest.mark.parametrize("extra", [["--device-sweep"], ["--device-sweep", "--size-mode", "device",
                                                     "--trellis"], []],
                         ids=["device-sweep", "device-sizes-trellis", "host-ladder"])
def test_rd_calibrate_device_sweep_equals_jax(corpus, tmp_path, capsys, extra):
    """``--device-sweep`` without tpujpeg is an argument error (2) as in
    JAX; with ``--format tpujpeg`` (on the device ladder or through the
    codec on the host) both packages write the same calibration."""
    runs = run_both(capsys, tmp_path, j_rd, t_rd, lambda d: [
        corpus, "--device-sweep", "--output", d / "bad"])
    assert runs[0].rc == runs[1].rc == 2
    assert (runs[1].out, runs[1].err) == (runs[0].out, runs[0].err)
    runs = run_both(capsys, tmp_path, j_rd, t_rd, lambda d: [
        corpus, "--format", "tpujpeg", "--range", "30:10:90", *extra, "--output", d / "cal"])
    jax_run, port_run = runs
    assert jax_run.rc == port_run.rc == 0, port_run.err
    assert_same_text(port_run.out, jax_run.out, masks=(r"^sweep complete in [\d.]+s$",))
    assert files_under(port_run.dir) == files_under(jax_run.dir) == [
        "cal/calibration.json", "cal/calibration.py", "cal/rd_curve.svg"]
    got = json.loads((port_run.dir / "cal" / "calibration.json").read_text())
    want = json.loads((jax_run.dir / "cal" / "calibration.json").read_text())
    assert (got["codec"], got["image_count"]) == (want["codec"], want["image_count"])
    for metric, tier in (("ssimulacra2", 1e-5), ("butteraugli", 5e-4)):
        assert got[metric]["bpp"] == want[metric]["bpp"]
        np.testing.assert_allclose(got[metric]["score"], want[metric]["score"], rtol=tier)


# -- every tool ---------------------------------------------------------------


def test_clis_score_on_the_card_by_default(corpus, tmp_path, monkeypatch):
    """No ``--device``: the card, and without one an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        (t_iter, ["eval", "--corpus", str(corpus), "--limit", "1",
                  "--baseline-dir", str(tmp_path / "b")]),
        (t_rd, [str(corpus), "--range", "50:20:90", "--output", str(tmp_path / "cal")]),
        (t_analyze, ["heuristics", str(corpus), "--output", str(tmp_path / "h.csv")]),
        (t_analyze, ["full-comparison", str(corpus), "--output", str(tmp_path / "fc.csv")]),
        (t_compare, ["single", str(corpus / "im0.png"), "--formats", "webp",
                     "--output", str(tmp_path / "r")]),
    ]
    for mod, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)


@pytest.mark.parametrize("name", ["codec_iter", "codec_eval", "codec_compare", "rd_calibrate",
                                  "codec_analyze"])
def test_cli_runs_as_a_module(name, tmp_path):
    """``python -m codec_eval_tpu_torch.cli.<name>``."""
    run = subprocess.run([sys.executable, "-m", f"codec_eval_tpu_torch.cli.{name}", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith(f"usage: {name.replace('_', '-')} ")
    if name == "codec_eval":
        f = tmp_path / "r.csv"
        f.write_text(CSV_ROWS)
        run = subprocess.run([sys.executable, "-m", "codec_eval_tpu_torch.cli.codec_eval",
                              "stats", str(f)],
                             cwd=REPO, capture_output=True, text=True, timeout=120)
        assert run.returncode == 0 and "mean=80.7500" in run.stdout, run.stderr


#: Each leaf command of the port's tools, and whether it scores or computes
#: heuristics, and so takes ``--device``.
LEAF_COMMANDS = [
    (t_iter, ["eval"], True),
    (t_iter, ["sweep"], True),
    (t_iter, ["baseline", "save"], True),
    (t_iter, ["target"], True),
    (t_iter, ["baseline", "show"], False),
    (t_rd, [], True),
    (t_compare, ["run"], True),
    (t_compare, ["single"], True),
    (t_compare, ["list"], False),
    (t_compare, ["report"], False),
    (t_analyze, ["full-comparison"], True),
    (t_analyze, ["brute-force-sweep"], True),
    (t_analyze, ["heuristics"], True),
    (t_analyze, ["analyze-image"], True),
    (t_analyze, ["find-outliers"], False),
    (t_analyze, ["rd-compare"], False),
    (t_analyze, ["build-predictor"], False),
    (t_eval, ["pareto"], False),
    (t_eval, ["stats"], False),
    (t_eval, ["import"], False),
    (t_eval, ["corpus", "info"], False),
    (t_eval, ["sparse", "status"], False),
]


@pytest.mark.parametrize("mod, cmd, takes_device", LEAF_COMMANDS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}-{'-'.join(c) or 'main'}"
                              for m, c, _ in LEAF_COMMANDS])
def test_device_option_only_on_scoring_commands(mod, cmd, takes_device, capsys):
    """``--device`` (``cuda`` by default) on the commands that do device
    work, and on no other."""
    with pytest.raises(SystemExit) as done:
        mod.main(cmd + ["--help"])
    assert done.value.code == 0
    assert ("--device DEVICE" in capsys.readouterr().out) == takes_device
