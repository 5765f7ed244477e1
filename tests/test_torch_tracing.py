"""The port's tracing (``utils/profiling.py``) on the CPU: spans and
counters at the layer boundaries, recorded only while a ``torch.profiler``
session records on the calling thread.

- With no profiler, ``span`` is one shared no-op and ``count`` counts
  nothing; a profiler on another thread records none of this thread's.
- Under the profiler, ``evaluate_image``, ``assert_quality``,
  ``score_ladder`` and the corpus runner emit their spans, nested under
  their call's top span, and count the staging buffer's allocations and
  reuses, its bytes and reference precomputes; the corpus runner stages
  and issues each chunk under its own spans, fetches once per call and
  counts its host slots' allocations and reuses.
- ``device_trace``'s Chrome trace holds the spans.
- The span form is not a user annotation, so the profiler gives it no
  range on the device timeline.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import codec_eval_tpu_torch as ce
from codec_eval_tpu_torch.engine.scoring import score_ladder
from codec_eval_tpu_torch.errors import QualityBelowThreshold
from codec_eval_tpu_torch.parallel import make_mesh, score_pairs_sharded
from codec_eval_tpu_torch.utils import profiling

H, W = 24, 32
QUALITIES = (5, 10, 20)
SCORER_STEPS = ("ce.scorer.precompute", "ce.scorer.stage", "ce.scorer.psnr", "ce.scorer.dssim",
                "ce.scorer.ssimulacra2", "ce.scorer.butteraugli", "ce.scorer.fetch")


@pytest.fixture(autouse=True)
def _clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _image(seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _noisy(img, amount, seed=1):
    noise = np.random.default_rng(seed).integers(-amount, amount + 1, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def _session(img, tmp_path):
    cands = {q: _noisy(img, q, seed=q) for q in QUALITIES}

    def encode(image, request):
        return bytes([int(request.quality)])

    def decode(data):
        return ce.ImageData.rgb8(cands[data[0]])

    config = (ce.EvalConfig.builder().report_dir(tmp_path).metrics(ce.MetricConfig.all())
              .quality_levels(list(QUALITIES)).build())
    session = ce.EvalSession(config, device="cpu")
    session.add_codec_with_decode("noise", "1", encode, decode)
    return session


def _traced(fn):
    """Run ``fn`` under a CPU profiler: (its result, [(name, start, end)] of
    the ``ce.*`` host events in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("ce.")), key=lambda s: (s[1], -s[2]))
    return out, spans


def _names(spans):
    return [n for n, _, _ in spans]


def _inside(spans, parent):
    """Names of the spans that lie inside each span ``parent``, one list per
    ``parent`` span."""
    out = []
    for name, lo, hi in spans:
        if name == parent:
            out.append([n for n, s, e in spans if n != parent and lo <= s and e <= hi])
    return out


def test_without_a_profiler_span_is_the_shared_no_op_and_nothing_counts(tmp_path):
    assert profiling.span("ce.a") is profiling.span("ce.b")
    with profiling.span("ce.a"):
        profiling.count("x", 3)
    assert profiling.counters() == {}
    img = _image()
    _session(img, tmp_path).evaluate_image("a", ce.ImageData.rgb8(img))
    ce.assert_quality(img, img, min_ssimulacra2=10.0, device="cpu")
    assert profiling.counters() == {}


def test_a_profiler_on_another_thread_records_no_span_or_count():
    def work():
        with profiling.span("ce.thread.work"):
            profiling.count("thread.items")
            torch.ones(3).add(1)

    def traced_elsewhere():
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        with profiling.span("ce.main.work"):
            profiling.count("main.items", 2)

    _, spans = _traced(traced_elsewhere)
    assert _names(spans) == ["ce.main.work"]
    assert profiling.counters() == {"main.items": 2}


def test_counters_are_a_copy_and_reset():
    def counting():
        profiling.count("a")
        profiling.count("a", 4)
        profiling.count("b", 0)

    _traced(counting)
    got = profiling.counters()
    assert got == {"a": 5, "b": 0}
    got["a"] = 0
    assert profiling.counters()["a"] == 5
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_evaluate_image_spans_nest_under_the_image_span(tmp_path):
    img = _image()
    session = _session(img, tmp_path)
    report, spans = _traced(lambda: session.evaluate_image("a", ce.ImageData.rgb8(img)))
    assert len(report.results) == len(QUALITIES)
    assert _names(spans) == ["ce.session.image", "ce.session.codecs", "ce.session.batch",
                             "ce.scorer.score_batch", *SCORER_STEPS, "ce.session.report"]
    (inner,) = _inside(spans, "ce.session.image")
    assert inner == _names(spans)[1:]
    (inner,) = _inside(spans, "ce.scorer.score_batch")
    assert inner == list(SCORER_STEPS)


def test_evaluate_image_counts_staging_bytes_and_one_miss(tmp_path):
    img = _image()
    session = _session(img, tmp_path)
    _traced(lambda: session.evaluate_image("a", ce.ImageData.rgb8(img)))
    # The scorer's staging buffer, allocated once; nothing is copied to a
    # device on the CPU.
    assert profiling.counters() == {"staging.host_bytes": len(QUALITIES) * H * W * 3,
                                    "staging.buffer_alloc": 1, "scorer.precompute_miss": 1}


def test_a_second_call_reuses_the_staging_buffer(tmp_path):
    img, other = _image(), _image(seed=5)
    session = _session(img, tmp_path)
    session.evaluate_image("a", ce.ImageData.rgb8(img))
    _traced(lambda: session.evaluate_image("b", ce.ImageData.rgb8(other)))
    assert profiling.counters() == {"staging.host_bytes": 0, "staging.buffer_reuse": 1,
                                    "scorer.precompute_miss": 1}


def test_a_second_call_on_the_same_image_hits_the_precompute(tmp_path):
    img = _image()
    session = _session(img, tmp_path)
    session.evaluate_image("a", ce.ImageData.rgb8(img))
    _traced(lambda: session.evaluate_image("a", ce.ImageData.rgb8(img)))
    got = profiling.counters()
    assert got["scorer.precompute_hit"] == 1 and "scorer.precompute_miss" not in got


def test_assert_quality_builds_one_precompute_per_call():
    img = _image()
    pairs = [(img, _noisy(img, 2)), (img, _noisy(img, 60)), (img, img)]

    def gate_calls():
        verdicts = []
        for ref, dist in pairs:
            try:
                ce.assert_quality(ref, dist, min_ssimulacra2=50.0, max_dssim=0.01, device="cpu")
                verdicts.append(True)
            except QualityBelowThreshold:
                verdicts.append(False)
        return verdicts

    verdicts, spans = _traced(gate_calls)
    assert False in verdicts and True in verdicts
    # A new scorer per call, so a staging buffer of one pair per call.
    assert profiling.counters() == {"scorer.precompute_miss": len(pairs),
                                    "staging.host_bytes": len(pairs) * H * W * 3,
                                    "staging.buffer_alloc": len(pairs)}
    steps = ["ce.gate.evaluate_single", "ce.scorer.score_batch", "ce.scorer.precompute",
             "ce.scorer.stage", "ce.scorer.dssim", "ce.scorer.ssimulacra2", "ce.scorer.fetch"]
    assert _inside(spans, "ce.gate.assert_quality") == [steps] * len(pairs)
    assert _inside(spans, "ce.gate.evaluate_single") == [[]] * len(pairs)
    assert _names(spans) == ["ce.gate.assert_quality", *steps] * len(pairs)


def test_score_ladder_spans_and_counts():
    img = _image()
    cands = np.stack([_noisy(img, q, seed=q) for q in QUALITIES])
    config = ce.MetricConfig(dssim=True, psnr=True)
    scores, spans = _traced(lambda: score_ladder(img, cands, config, device="cpu"))
    assert sorted(scores) == ["dssim", "psnr"]
    assert _names(spans) == ["ce.scorer.precompute", "ce.scorer.stage", "ce.scorer.psnr",
                             "ce.scorer.dssim", "ce.scorer.fetch"]
    assert profiling.counters() == {"scorer.precompute_miss": 1,
                                    "staging.host_bytes": cands.nbytes,
                                    "staging.buffer_alloc": 1}


@pytest.mark.parametrize("masked", [True, False])
def test_corpus_runner_spans_one_bucket_and_fetch_per_chunk(masked):
    # Masked (granularity 32, two pairs per chunk): a 32 x 32 bucket of
    # three pairs (two chunks) and a 32 x 64 bucket of one; exact shapes:
    # one chunk per shape.  Each chunk is staged, then issued, and the call
    # ends with one fetch of every chunk's scores; a second call reuses the
    # runner's two host slots, one per staged chunk.
    shapes = [(20, 30), (32, 32), (17, 29), (24, 40)]
    pairs = [(_image(k, h, w), _noisy(_image(k, h, w), 8, seed=k))
             for k, (h, w) in enumerate(shapes)]
    mesh = make_mesh(devices=[torch.device("cpu")])
    chunks = 3 if masked else len(shapes)
    for call in range(2):
        profiling.reset_counters()
        result, spans = _traced(lambda: score_pairs_sharded(pairs, mesh=mesh, masked=masked,
                                                            granularity=32, batch=2))
        assert len(result.per_pair) == len(pairs)
        names = _names(spans)
        assert [n for n in names if n.startswith("ce.runner.")] == (
            ["ce.runner.score_pairs"] + ["ce.runner.stage", "ce.runner.bucket"] * chunks
            + ["ce.runner.fetch"])
        assert names.count("ce.masked.butteraugli") == (chunks if masked else 0)
        (inner,) = _inside(spans, "ce.runner.score_pairs")
        assert inner == names[1:]
        assert _inside(spans, "ce.runner.stage") == [[]] * chunks
        if masked:
            assert _inside(spans, "ce.runner.bucket") == [
                ["ce.masked.ssimulacra2", "ce.masked.dssim", "ce.masked.butteraugli",
                 "ce.masked.psnr"]] * chunks
        got = profiling.counters()
        if call:
            assert got == {"runner.buffer_reuse": chunks}
        else:
            assert set(got) <= {"runner.buffer_alloc", "runner.buffer_reuse"}
            assert sum(got.values()) == chunks


def test_device_trace_writes_the_spans(tmp_path):
    img = _image()
    session = _session(img, tmp_path)
    with profiling.device_trace(tmp_path / "trace"):
        session.evaluate_corpus([("a", ce.ImageData.rgb8(img))])
    (path,) = (tmp_path / "trace").iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"ce.session.image", "ce.session.batch", "ce.session.report",
            "ce.scorer.score_batch", *SCORER_STEPS} <= names


def test_spans_are_not_user_annotations():
    """``record_function`` ranges are user annotations, which the profiler
    mirrors as ``gpu_user_annotation`` ranges over the CUDA kernels they
    launch; the port's spans must add no event to the device timeline."""
    def both():
        with profiling.span("ce.test.span"):
            torch.ones(4).sum()
        with record_function("ce.test.annotation"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        both()
    flags = {e.name: e.is_user_annotation for e in prof.events() if e.name.startswith("ce.")}
    assert flags == {"ce.test.span": False, "ce.test.annotation": True}
