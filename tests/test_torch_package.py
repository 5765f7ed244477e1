"""Package-level checks of the PyTorch port ``codec_eval_tpu_torch``.

- (a) no module of the port imports JAX or the JAX package.  This is a static
  check: the test process has JAX loaded already (``tests/conftest.py``), so
  ``sys.modules`` cannot tell who imported it;
- (b) the constant tables the port copied equal the JAX package's exactly;
- (c) on CPU tensors no kernel wrapper launches its kernel;
- (d) the card is the default device; asking for CUDA without a card is an
  error, never a CPU fallback, and a kernel wrapper given a tensor on any
  other device than the CPU raises unless it is a CUDA tensor;
- (e) every Pallas kernel of the JAX package (K1-K9) has its wrapper.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import codec_eval_tpu_torch as port
from codec_eval_tpu.kernels import butteraugli as jba
from codec_eval_tpu.kernels import dssim as jd
from codec_eval_tpu.kernels import ssimulacra2_weights as jw
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels import dssim as td
from codec_eval_tpu_torch.kernels import ssimulacra2_weights as tw
from codec_eval_tpu_torch.kernels.cuda import WRAPPERS, _lib
from codec_eval_tpu_torch.kernels.cuda import blur as tbl
from codec_eval_tpu_torch.kernels.cuda import freqsep as tfs
from codec_eval_tpu_torch.kernels.cuda import malta as tml
from codec_eval_tpu_torch.kernels.cuda import maskac as tmk
from codec_eval_tpu_torch.kernels.cuda import moments as tmo
from codec_eval_tpu_torch.kernels.cuda import scale_features as tsf

PACKAGE = Path(port.__file__).parent
REPO = PACKAGE.parent
FORBIDDEN = ("jax", "jaxlib", "codec_eval_tpu")


def _forbidden(module: str) -> bool:
    """True for ``jax``, ``jax.numpy``, ``codec_eval_tpu.x`` and the like,
    matched by whole dotted name, so ``codec_eval_tpu_torch`` passes."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_matches_whole_names():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("codec_eval_tpu") and _forbidden("codec_eval_tpu.engine.scoring")
    assert not _forbidden("codec_eval_tpu_torch")
    assert not _forbidden("codec_eval_tpu_torch.kernels") and not _forbidden("jaxtyping")


def test_port_imports_no_jax():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 15
    walked = {str(f.relative_to(PACKAGE)) for f in files}
    assert {"color.py", "utils/native.py", "kernels/cuda/maskac.py", "metrics/calculate.py",
            "metrics/prelude.py", "iter/eval.py", "iter/sweep.py", "iter/baseline.py"} <= walked
    bad = [(str(f.relative_to(PACKAGE)), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("module", ["kernels/masked.py", "kernels/cuda/moments.py",
                                    "parallel/mesh.py", "parallel/corpus_runner.py",
                                    "parallel/__init__.py"])
def test_mixed_size_modules_import_no_jax(module):
    path = PACKAGE / module
    assert path.is_file()
    assert [m for m in _imports(path) if _forbidden(m)] == []


def test_parallel_exports_mesh_and_corpus_runner_only():
    import codec_eval_tpu_torch.parallel as par

    assert set(par.__all__) == {
        "CorpusScores", "Mesh", "StagedPairs", "make_mesh", "score_pairs_sharded", "score_staged",
        "shard_batch", "sharded_masked_score_fn", "sharded_score_fn", "stage_pairs_sharded",
    }
    assert not hasattr(par, "multihost") and not hasattr(par, "ladder_runner")


def test_chip_smoke_imports_no_jax():
    script = REPO / "chip_smoke.py"
    assert [m for m in _imports(script) if _forbidden(m)] == []


def test_ssimulacra2_weights_equal_jax():
    np.testing.assert_array_equal(tw.WEIGHTS_V21, jw.WEIGHTS_V21)
    assert tw.WEIGHTS_V21.dtype == jw.WEIGHTS_V21.dtype
    for name in ("SCALE_FACTOR", "CUBIC_A", "CUBIC_B", "CUBIC_C", "POWER", "APPROX_ENTRIES"):
        assert getattr(tw, name) == getattr(jw, name), name


@pytest.mark.parametrize(
    "name",
    ["_OPSIN_CONSTS", "_BAND_CONSTS", "_MALTA_CALLS", "_MALTA_LINES_FULL", "_MALTA_LINES_LF",
     "_WMUL", "_MASKY", "_MASKDCY", "_MASK_GLOBAL_SCALE", "SIGMA_LF", "SIGMA_MASK"],
)
def test_butteraugli_tables_equal_jax(name):
    assert getattr(tba, name) == getattr(jba, name)


def test_kernel_blur_sigmas_equal_jax():
    assert (tfs.SIGMA_SURROUND, tfs.SIGMA_MF, tfs.SIGMA_UHF) == (
        jba.SIGMA_SURROUND, jba.SIGMA_MF, jba.SIGMA_UHF
    )
    assert tsf.SIGMA == 1.5


def test_butteraugli_params_equal_jax():
    p, q = tba.ButteraugliParams(), jba.ButteraugliParams.default()
    assert (p.hf_asymmetry, p.xmul, p.intensity_target) == (
        q.hf_asymmetry, q.xmul, q.intensity_target
    )


def test_dssim_constants_equal_jax():
    for name in ("SCALE_WEIGHTS", "CHROMA_WEIGHT", "C1", "C2", "_BLUR_TAPS", "_EPSILON",
                 "_KAPPA_116"):
        assert getattr(td, name) == getattr(jd, name), name


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_names_its_source_and_the_pallas_kernel(name):
    fn = WRAPPERS[name]
    assert (REPO / fn.source).is_file() and fn.source.endswith(".cu")
    path, line = fn.replaces.split(":")
    text = (REPO / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def ") and text.split("(")[0].endswith("_pallas_batch" if name ==
        "scale_features" else "_pallas")


def test_nine_wrappers_one_per_pallas_kernel():
    """K1-K9: nine wrappers, each replacing a different ``pl.pallas_call``
    function of the JAX package, at a path and line that exist."""
    assert len(WRAPPERS) == 9
    replaced = [fn.replaces for fn in WRAPPERS.values()]
    assert len(set(replaced)) == 9
    for where in replaced:
        path, line = where.split(":")
        assert path.startswith("codec_eval_tpu/kernels/pallas/")
        assert int(line) <= len((REPO / path).read_text().splitlines())


def _gradient(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (h + w)], -1).astype(np.uint8)


def test_cpu_scoring_launches_no_kernel():
    for fn in WRAPPERS.values():
        fn.launches = 0
    ref = _gradient(24, 32)
    cands = np.stack([ref // 2 + 10, ref])
    res = port.BatchScorer(port.MetricConfig.all(), device="cpu").score_batch(ref, cands)
    assert res[1].ssimulacra2 == 100.0 and res[1].butteraugli == 0.0
    assert np.isfinite(res[0].butteraugli) and res[0].butteraugli > 0.0
    assert [fn.launches for fn in WRAPPERS.values()] == [0] * len(WRAPPERS)


def test_cuda_device_without_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.BatchScorer(port.MetricConfig.all(), device="cuda")
    config = port.EvalConfig.builder().report_dir("unused").build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.EvalSession(config, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        port.BatchScorer(port.MetricConfig.all(), device="meta")


def test_default_device_is_the_card(monkeypatch):
    """With no ``device`` the scorer and the session take the card: without
    one they raise, and ``device="cpu"`` still works."""
    config = port.EvalConfig.builder().report_dir("unused").build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.BatchScorer(port.MetricConfig.all())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.EvalSession(config)
    assert port.BatchScorer(port.MetricConfig.all(), device="cpu").device.type == "cpu"
    assert port.EvalSession(config, device="cpu")._scorer.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port.BatchScorer(port.MetricConfig.all()).device == torch.device("cuda")
    assert port.EvalSession(config)._scorer.device == torch.device("cuda")


def test_default_device_raises_on_this_host():
    """No monkeypatching: the test host has no card, so the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.BatchScorer(port.MetricConfig.all())


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; anything else
    must be a CUDA tensor, or it raises before touching the library."""
    m = torch.device("meta")
    cases = [
        lambda: tsf.scale_features_batch(
            *(torch.empty(3, 16, 16, device=m) for _ in range(3)),
            torch.empty(2, 3, 16, 16, device=m),
        ),
        lambda: tfs.opsin_xyb_batch(torch.empty(2, 3, 16, 16, device=m), tba._OPSIN_CONSTS),
        lambda: tfs.bands_batch(
            torch.empty(2, 3, 16, 16, device=m), torch.empty(2, 3, 16, 16, device=m),
            tba._BAND_CONSTS,
        ),
        lambda: tml.malta_ac_batch(
            torch.empty(2, 6, 16, 16, device=m), tba._MALTA_LINES_FULL, tba._MALTA_LINES_LF
        ),
        lambda: tml.malta_diffmap_batch(
            torch.empty(2, 6, 16, 16, device=m), torch.empty(6, 16, 16, device=m),
            torch.empty(2, 4, 16, 16, device=m), torch.empty(4, 16, 16, device=m),
            torch.empty(2, 16, 16, device=m), torch.empty(2, 16, 16, device=m),
            tba._MALTA_LINES_FULL, tba._MALTA_LINES_LF, *tba._fused_diffmap_consts(0.8, 1.0),
        ),
        lambda: tbl.blur_batch(torch.empty(2, 1, 16, 16, device=m), tba.SIGMA_MASK),
        lambda: tmk.mask_diff_ac_batch(
            torch.empty(1, 16, 16, device=m), torch.empty(16, 16, device=m), 10.0
        ),
        lambda: tsf.scale_features(*(torch.empty(3, 16, 16, device=m) for _ in range(4))),
        lambda: tmo.candidate_moments(*(torch.empty(2, 3, 16, 16, device=m) for _ in range(2))),
    ]
    for case in cases:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            case()
    assert [fn.launches for fn in WRAPPERS.values()] == [0] * len(WRAPPERS)


def test_require_cuda_checks_dtype_shape_and_layout():
    t = torch.empty(2, 3, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        _lib.require_cuda("t", t, (None, 3, None, None))
    # The remaining checks run on tensors that claim a CUDA device.
    class Fake:
        device = torch.device("cuda")
        dtype = torch.float64
        shape = (2, 3, 4, 5)

        def dim(self):
            return 4

        def is_contiguous(self):
            return False

    with pytest.raises(TypeError, match="float32"):
        _lib.require_cuda("t", Fake(), (None, 3, None, None))
    Fake.dtype = torch.float32
    with pytest.raises(ValueError, match="shape"):
        _lib.require_cuda("t", Fake(), (None, 6, None, None))
    with pytest.raises(ValueError, match="contiguous"):
        _lib.require_cuda("t", Fake(), (None, 3, None, None))


def test_build_names_the_sources_and_needs_nvcc(monkeypatch, tmp_path):
    names = {p.name for p in _lib.sources()}
    assert {"scale_features.cu", "freqsep.cu", "malta.cu", "blur.cu"} <= names
    assert {fn.source.rsplit("/", 1)[1] for fn in WRAPPERS.values()} <= names
    first = _lib.library_path()
    assert first == _lib.library_path() and first.parent == _lib.BUILD_DIR
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib._nvcc()


def test_references_from_numpy_defaults_to_the_card(monkeypatch):
    """With no ``device`` the JAX precompute goes to the card: without one it
    raises instead of staying on the host; ``device="cpu"`` still works."""
    from codec_eval_tpu_torch import interop

    pre = {"ref_u8": np.zeros((8, 8, 3), np.uint8)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.references_from_numpy(pre)
    assert interop.references_from_numpy(pre, device="cpu")["ref_u8"].device.type == "cpu"
