"""The frozen reference and inputs against the port's plain routes on the
CPU, and the benchmark's isolation from JAX and the JAX package."""

import ast
import subprocess
import sys

import numpy as np
import pytest

from portbench import guard, inputs
from portbench.harness import HERE, ROOT
from portbench.reference.score import METRICS, score_ladder


@pytest.mark.parametrize("shape", [(64, 64), (72, 88)])
def test_reference_equals_the_ports_plain_routes(shape):
    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch.engine.scoring import BatchScorer

    image = inputs.photo_image(2**31 + 3, 0, *shape)
    cands = np.stack([inputs.jpeg_candidate(image, q, "4:2:0")[1] for q in (10, 50, 90)]
                     + [image])
    ref = score_ladder(image, cands, chunk=3)
    got = BatchScorer(ce.MetricConfig.all(), device="cpu").score_batch(image, cands)
    for m in METRICS:
        np.testing.assert_array_equal(ref[m], [getattr(r, m) for r in got], err_msg=m)


def test_generator_equals_the_ports_synthetic_photo_corpus():
    from codec_eval_tpu_torch.iter.source import photo_sources

    for seed in (2026, 2**31 + 11):
        for i, src in enumerate(photo_sources(2, 96, seed)):
            np.testing.assert_array_equal(inputs.photo_image(seed, i, 96, 96), src.rgb)
    assert inputs.photo_image(5, 1, 48, 80).shape == (48, 80, 3)


def test_guard_compares_whole_top_level_names():
    names = ["codec_eval_tpu_torch", "codec_eval_tpu_torch.kernels", "codec_eval_tpu",
             "codec_eval_tpu.engine", "jax", "jax.numpy", "jaxlib", "flax.linen", "jaxtyping",
             "flaxen"]
    assert guard.forbidden_modules(names) == ["codec_eval_tpu", "codec_eval_tpu.engine",
                                              "flax.linen", "jax", "jax.numpy", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_jax_nor_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in {"jax", "jaxlib", "flax", "codec_eval_tpu",
                                              "codec_eval_tpu_torch"}, (path.name, name)
    code = ("import sys, portbench.reference.score as s; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'codec_eval_tpu', 'codec_eval_tpu_torch'}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr


def test_a_run_loads_no_jax():
    code = ("import time, sys; from portbench.guard import forbidden_modules; "
            "sys.path.insert(0, 'portbench/tests'); from portbench_tiny import tiny_run; "
            "out = tiny_run('clic2025-2048.masked-corpus', trace=True); "
            "assert out['correct']; print(forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "[]", proc.stderr
