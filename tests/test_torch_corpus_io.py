"""The port's host IO layer: ``corpus/``, ``importers/`` and ``decode.py``.

- each module of the three is the JAX file's code, docstrings aside
  (``assert_jax_code``, which the other port tests of host copies share);
- the cases of ``tests/test_corpus_import.py`` and
  ``tests/test_corpus_download.py`` (``file://`` fixtures, no network), run
  against the port;
- ``decode.decode_jpeg_with_icc`` and an ICC-tagged ``ImageData`` through
  both packages: the same pixels, profile and sRGB transform.
"""

import ast
import hashlib
import importlib
import inspect
import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from codec_eval_tpu_torch.corpus import (
    Corpus,
    ImageCategory,
    SparseFilter,
    checksum_hex,
    fnv1a_64,
    matches_pattern,
)
from codec_eval_tpu_torch.corpus.discovery import (
    parse_jpeg_dimensions,
    parse_png_dimensions,
    parse_webp_dimensions,
)
from codec_eval_tpu_torch.corpus.download import fetch_dataset
from codec_eval_tpu_torch.errors import CorpusError, CsvImportError
from codec_eval_tpu_torch.importers import CsvImporter, CsvSchema


def _code(source: str) -> str:
    """The AST of a module's source with every docstring taken out: the
    module's, each class's and each function's."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


def assert_jax_code(name: str) -> None:
    """``codec_eval_tpu_torch.<name>`` is ``codec_eval_tpu.<name>``'s code."""
    jax_mod = importlib.import_module(f"codec_eval_tpu.{name}")
    port_mod = importlib.import_module(f"codec_eval_tpu_torch.{name}")
    assert _code(inspect.getsource(port_mod)) == _code(inspect.getsource(jax_mod)), name


COPIES = ["decode", "corpus", "corpus.category", "corpus.checksum", "corpus.discovery",
          "corpus.model", "corpus.sparse", "corpus.download", "importers",
          "importers.csv_import"]


@pytest.mark.parametrize("name", COPIES)
def test_host_io_module_is_the_jax_code(name):
    assert_jax_code(name)


def test_code_comparison_ignores_only_docstrings():
    doc = '"""module"""\nclass A:\n    """doc"""\n    def f(self):\n        """doc"""\n        return 1\n'
    bare = "class A:\n    def f(self):\n        return 1\n"
    assert _code(doc) == _code(bare)
    assert _code(bare) != _code(bare.replace("return 1", "return 2"))
    assert _code("def f():\n    'only a docstring'\n") == _code("def f():\n    pass\n")


# -- the cases of tests/test_corpus_import.py ----------------------------


def _write_image(path, w=20, h=10, fmt="PNG"):
    img = np.random.default_rng(0).integers(0, 256, (h, w, 3)).astype(np.uint8)
    Image.fromarray(img).save(path, fmt)


# -- discovery ------------------------------------------------------------


def test_discover(tmp_path):
    _write_image(tmp_path / "a.png")
    (tmp_path / "photo").mkdir()
    _write_image(tmp_path / "photo" / "b.jpg", fmt="JPEG")
    (tmp_path / ".hidden").mkdir()
    _write_image(tmp_path / ".hidden" / "c.png")
    (tmp_path / "notes.txt").write_text("not an image")

    corpus = Corpus.discover(tmp_path)
    assert len(corpus) == 2
    paths = {i.relative_path for i in corpus.images}
    assert paths == {"a.png", "photo/b.jpg"}
    by_path = {i.relative_path: i for i in corpus.images}
    assert by_path["a.png"].width == 20 and by_path["a.png"].height == 10
    # Category inferred from directory name.
    assert by_path["photo/b.jpg"].category == ImageCategory.PHOTO


def test_discover_missing_path(tmp_path):
    with pytest.raises(CorpusError):
        Corpus.discover(tmp_path / "nope")


def test_header_parsers():
    # PNG via real encoder bytes.
    buf = io.BytesIO()
    Image.new("RGB", (33, 17)).save(buf, "PNG")
    assert parse_png_dimensions(buf.getvalue()) == (33, 17)
    # JPEG.
    buf = io.BytesIO()
    Image.new("RGB", (48, 32)).save(buf, "JPEG")
    assert parse_jpeg_dimensions(buf.getvalue()) == (48, 32)
    # Progressive JPEG (SOF2).
    buf = io.BytesIO()
    Image.new("RGB", (64, 24)).save(buf, "JPEG", progressive=True)
    assert parse_jpeg_dimensions(buf.getvalue()) == (64, 24)
    # WebP (lossy VP8 or VP8X container).
    buf = io.BytesIO()
    Image.new("RGB", (40, 30)).save(buf, "WEBP", quality=80)
    assert parse_webp_dimensions(buf.getvalue()) == (40, 30)
    # Lossless WebP (VP8L).
    buf = io.BytesIO()
    Image.new("RGB", (25, 15)).save(buf, "WEBP", lossless=True)
    assert parse_webp_dimensions(buf.getvalue()) == (25, 15)
    # Garbage.
    assert parse_png_dimensions(b"garbage") is None
    assert parse_jpeg_dimensions(b"\x00\x01") is None
    assert parse_webp_dimensions(b"RIFFxxxx") is None


# -- categories -----------------------------------------------------------


def test_category_aliases():
    assert ImageCategory.from_str_loose("Photograph") == ImageCategory.PHOTO
    assert ImageCategory.from_str_loose("TEXTURES") == ImageCategory.HIGH_FREQUENCY
    assert ImageCategory.from_str_loose("3d") == ImageCategory.CGI
    assert ImageCategory.from_str_loose("bogus") is None
    assert len(ImageCategory.all()) == 11
    assert str(ImageCategory.LOW_FREQUENCY) == "low_frequency"


# -- checksums ------------------------------------------------------------


def test_fnv1a():
    # Standard FNV-1a test vectors.
    assert fnv1a_64(b"") == 0xCBF29CE484222325
    assert fnv1a_64(b"a") == 0xAF63DC4C8601EC8C
    assert checksum_hex(fnv1a_64(b"a")) == "af63dc4c8601ec8c"


def test_native_file_checksum_matches_jax(tmp_path):
    """``utils.native.fnv1a64_file`` returns what the JAX package's does
    (its C library where built, else the same Python hash) and raises for
    a file it cannot read."""
    from codec_eval_tpu.utils import native as jax_native
    from codec_eval_tpu_torch.utils import native

    p = tmp_path / "data.bin"
    p.write_bytes(bytes(range(256)) * 11)
    assert native.fnv1a64_file(p) == jax_native.fnv1a64_file(p) == fnv1a_64(p.read_bytes())
    with pytest.raises(FileNotFoundError):
        native.fnv1a64_file(tmp_path / "missing.bin")


def test_checksums_split_duplicates(tmp_path):
    _write_image(tmp_path / "a.png")
    _write_image(tmp_path / "b.png")  # same rng seed -> identical bytes? no: PNG same content
    corpus = Corpus.discover(tmp_path)
    assert corpus.compute_checksums() == 2
    # a and b have identical pixel content -> identical files -> duplicates.
    dups = corpus.find_duplicates()
    assert len(dups) == 1 and len(dups[0]) == 2
    train, val = corpus.split(1.0)
    assert len(train) == 2 and len(val) == 0
    # Deterministic.
    t2, v2 = corpus.split(0.5)
    t3, v3 = corpus.split(0.5)
    assert [i.relative_path for i in t2] == [i.relative_path for i in t3]


def test_manifest_roundtrip(tmp_path):
    _write_image(tmp_path / "a.png")
    corpus = Corpus.discover(tmp_path)
    corpus.save_manifest(tmp_path / "manifest.json")
    loaded = Corpus.load_manifest(tmp_path / "manifest.json")
    assert loaded.name == corpus.name
    assert len(loaded) == 1
    assert loaded.images[0].width == 20


def test_stats(tmp_path):
    _write_image(tmp_path / "a.png", w=20, h=10)
    _write_image(tmp_path / "b.png", w=40, h=30)
    s = Corpus.discover(tmp_path).stats()
    assert s.image_count == 2
    assert s.total_pixels == 20 * 10 + 40 * 30
    assert s.min_width == 20 and s.max_width == 40


def test_get_dataset_unknown():
    with pytest.raises(CorpusError, match="Unknown dataset"):
        Corpus.get_dataset("nonexistent-set")


# -- sparse ---------------------------------------------------------------


def test_sparse_filter_patterns():
    assert SparseFilter.directory("images/kodak").to_patterns() == [
        "images/kodak/",
        "images/kodak/**",
    ]
    assert SparseFilter.format(".png").to_patterns() == ["**/*.png"]
    assert SparseFilter.category("photo").to_patterns() == [
        "**/photo/",
        "**/photo/**",
        "photo/",
        "photo/**",
    ]
    assert SparseFilter.min_size(512, 512).to_patterns() == ["**/*"]
    assert SparseFilter.paths(["a.png", "b.png"]).to_patterns() == ["a.png", "b.png"]


def test_matches_pattern():
    assert matches_pattern("dir/sub/file.png", "**/*.png")
    assert matches_pattern("file.png", "*.png")
    assert not matches_pattern("dir/file.jpg", "**/*.png")
    assert matches_pattern("photo/x.png", "photo/")
    assert matches_pattern("a/photo/x.png", "**/photo/**")


# -- CSV import -----------------------------------------------------------


def test_csv_auto_detect(tmp_path):
    p = tmp_path / "results.csv"
    p.write_text(
        "Filename,Encoder,Q,Bytes,SSIM2,butter,encode_ms\n"
        "a.png,mozjpeg,75,1000,85.5,2.1,12.5\n"
        "b.png,webp,80,900,88.0,1.8,\n"
    )
    rows = CsvImporter.auto_detect().import_file(p)
    assert len(rows) == 2
    assert rows[0].image_name == "a.png"
    assert rows[0].codec == "mozjpeg"
    assert rows[0].quality_setting == 75.0
    assert rows[0].file_size == 1000
    assert rows[0].ssimulacra2 == 85.5
    assert rows[0].butteraugli == 2.1
    assert rows[0].encode_time_ms == 12.5
    assert rows[1].encode_time_ms is None


def test_csv_explicit_schema(tmp_path):
    p = tmp_path / "weird.csv"
    p.write_text("pic,method,level\nx.png,av1,30\n")
    schema = (
        CsvSchema.builder()
        .image_column("pic")
        .codec_column("method")
        .quality_column("level")
        .build()
    )
    rows = CsvImporter(schema).import_file(p)
    assert rows[0].image_name == "x.png"
    assert rows[0].quality_setting == 30.0


def test_csv_missing_required(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("foo,bar\n1,2\n")
    with pytest.raises(CsvImportError, match="image/filename"):
        CsvImporter.auto_detect().import_file(p)


def test_csv_skips_empty_rows(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("image,codec\n,missing\nok.png,jpeg\n")
    rows = CsvImporter.auto_detect().import_file(p)
    assert len(rows) == 1 and rows[0].image_name == "ok.png"


def test_dssim_alias_ssim(tmp_path):
    """dssim column auto-detects from ssim/ms-ssim aliases
    (reference: src/import/mod.rs:304-308)."""
    p = tmp_path / "s.csv"
    p.write_text("image,codec,ms-ssim\nx.png,jpeg,0.002\n")
    rows = CsvImporter.auto_detect().import_file(p)
    assert rows[0].dssim == 0.002


def test_sparse_checkout_local_repo(tmp_path):
    """Drive the git subprocess wrapper against a real local repository."""
    import subprocess

    from codec_eval_tpu_torch.corpus import SparseCheckout

    repo = tmp_path / "repo"
    repo.mkdir()

    def git(*args):
        subprocess.run(
            ["git", *args], cwd=repo, check=True, capture_output=True,
            env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
                 "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
                 "HOME": str(tmp_path), "PATH": "/usr/bin:/bin:/usr/local/bin"},
        )

    git("init", "-q")
    (repo / "photo").mkdir()
    (repo / "photo" / "a.png").write_bytes(b"x")
    (repo / "docs").mkdir()
    (repo / "docs" / "readme.md").write_text("hi")
    git("add", "-A")
    git("commit", "-q", "-m", "init")

    sc = SparseCheckout.init(repo)
    sc.set_paths(["photo"])
    patterns = sc.list_patterns()
    assert "photo" in patterns
    status = sc.status()
    assert status.enabled
    assert status.total_files == 2
    preview = sc.preview_patterns(["**/*.png"])
    assert preview == ["photo/a.png"]
    sc.disable()
    assert not sc.status().enabled


def test_sparse_open_not_a_repo(tmp_path):
    from codec_eval_tpu_torch.corpus import SparseCheckout

    with pytest.raises(CorpusError, match="Not a git repository"):
        SparseCheckout.open(tmp_path)


def test_corpus_image_name_unique_across_subdirs():
    """Same filename in two category folders must yield distinct report
    names (per-image JSON reports would silently overwrite otherwise)."""
    from codec_eval_tpu_torch.corpus import CorpusImage

    a = CorpusImage(relative_path="photo/0001.png")
    b = CorpusImage(relative_path="illustration/0001.png")
    assert a.name() != b.name()
    assert a.name() == "photo__0001"
    assert CorpusImage(relative_path="0001.png").name() == "0001"


def test_sparse_status_percentage():
    """reference: src/corpus/sparse.rs:317-325."""
    from codec_eval_tpu_torch.corpus import SparseStatus

    assert SparseStatus(True, [], 5, 10).percentage() == 50.0
    assert SparseStatus(True, [], 0, 0).percentage() == 100.0
    assert SparseStatus(True, [], 5, None).percentage() is None


def test_corpus_legacy_discovery_api(tmp_path):
    """discover_or_download / get_or_download / download_dataset parity.
    reference: src/corpus/mod.rs:179-305."""
    from codec_eval_tpu_torch.corpus import Corpus

    # Existing corpus directory: both legacy entry points discover it.
    root = tmp_path / "corp"
    (root / "photo").mkdir(parents=True)
    import numpy as np
    from PIL import Image

    Image.fromarray(
        np.full((8, 8, 3), 128, np.uint8)
    ).save(root / "photo" / "a.png")
    corpus = Corpus.discover_or_download(root)
    assert len(corpus) == 1
    corpus = Corpus.get_or_download(root)
    assert len(corpus) == 1

    # Missing path errors with a get_dataset pointer, like the reference.
    with pytest.raises(CorpusError, match="get_dataset"):
        Corpus.discover_or_download(tmp_path / "nope")
    with pytest.raises(CorpusError, match="get_dataset"):
        Corpus.get_or_download(tmp_path / "nope")

    # download_dataset is the get_dataset alias (unknown name error path).
    with pytest.raises(CorpusError, match="Unknown dataset"):
        Corpus.download_dataset("definitely-not-a-dataset")


# -- the cases of tests/test_corpus_download.py --------------------------


@pytest.fixture
def mirror(tmp_path):
    """A file:// mirror hosting kodak.tar.gz with 3 tiny PNGs."""
    mirror_dir = tmp_path / "mirror"
    mirror_dir.mkdir()
    rng = np.random.default_rng(3)
    archive = mirror_dir / "kodak.tar.gz"
    with tarfile.open(archive, "w:gz") as t:
        for i in range(3):
            img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "PNG")
            data = buf.getvalue()
            info = tarfile.TarInfo(f"kodak/kodim{i + 1:02d}.png")
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    sha = hashlib.sha256(archive.read_bytes()).hexdigest()
    return f"file://{mirror_dir}", sha


def test_fetch_populates_empty_cache(mirror, tmp_path):
    base, sha = mirror
    dest = tmp_path / "cache" / "kodak"
    fetch_dataset("kodak", dest, mirror=base, expected_sha256=sha)
    assert sorted(p.name for p in dest.iterdir()) == [
        "kodim01.png",
        "kodim02.png",
        "kodim03.png",
    ]


def test_checksum_mismatch_refuses_to_populate(mirror, tmp_path):
    base, _ = mirror
    dest = tmp_path / "cache" / "kodak"
    with pytest.raises(CorpusError, match="Checksum mismatch"):
        fetch_dataset("kodak", dest, mirror=base, expected_sha256="0" * 64)
    assert not dest.exists()


def test_unknown_dataset_and_missing_mirror_errors(tmp_path):
    with pytest.raises(CorpusError, match="No archive source"):
        fetch_dataset("not-a-dataset", tmp_path / "x", mirror="file:///nowhere")
    with pytest.raises(CorpusError, match="Failed to fetch"):
        fetch_dataset("kodak", tmp_path / "x", mirror="file:///nowhere")


def test_get_dataset_end_to_end(mirror, tmp_path, monkeypatch):
    """Corpus.get_dataset('kodak') populates an empty cache from the mirror
    (the VERDICT round-1 'done' criterion), then reuses the cache."""
    base, _ = mirror
    cache = tmp_path / "corpus-cache"
    monkeypatch.setenv("CODEC_CORPUS_DIR", str(cache))
    monkeypatch.setenv("CODEC_CORPUS_MIRROR", base)

    corpus = Corpus.get_dataset("kodak")
    assert corpus.name == "kodak"
    assert len(corpus) == 3
    assert all(img.width == 24 and img.height == 16 for img in corpus.images)

    # Second resolution is a pure cache hit: break the mirror, still works.
    monkeypatch.setenv("CODEC_CORPUS_MIRROR", "file:///nowhere")
    assert len(Corpus.get_dataset("kodak")) == 3


def test_get_dataset_without_mirror_is_actionable(tmp_path, monkeypatch):
    monkeypatch.setenv("CODEC_CORPUS_DIR", str(tmp_path / "empty-cache"))
    monkeypatch.delenv("CODEC_CORPUS_MIRROR", raising=False)
    with pytest.raises(CorpusError, match="CODEC_CORPUS_MIRROR"):
        Corpus.get_dataset("kodak")


# -- decode.py and ICC-tagged images, through both packages ------------------


def _icc_adobe_rgb() -> bytes:
    """A minimal ICC v2 matrix/TRC display profile with the Adobe RGB (1998)
    primaries (D50-adapted) and gamma 2.2: an RGB space that is not sRGB."""
    import struct

    def s15(v):
        return struct.pack(">i", round(v * 65536))

    def xyz(x, y, z):
        return b"XYZ " + bytes(4) + s15(x) + s15(y) + s15(z)

    curve = b"curv" + bytes(4) + struct.pack(">IH", 1, round(2.2 * 256)) + bytes(2)
    text = b"adobe-rgb-like\0"
    desc = (b"desc" + bytes(4) + struct.pack(">I", len(text)) + text
            + bytes(8) + bytes(3) + bytes(67))
    desc += bytes(-len(desc) % 4)
    tags = [(b"desc", desc), (b"wtpt", xyz(0.9642, 1.0, 0.8249)),
            (b"rXYZ", xyz(0.6097, 0.3111, 0.0195)), (b"gXYZ", xyz(0.2053, 0.6257, 0.0609)),
            (b"bXYZ", xyz(0.1492, 0.0632, 0.7446)),
            (b"rTRC", curve), (b"gTRC", curve), (b"bTRC", curve)]
    offset = 128 + 4 + 12 * len(tags)
    table, data = struct.pack(">I", len(tags)), b""
    for sig, body in tags:
        table += sig + struct.pack(">II", offset + len(data), len(body))
        data += body
    size = offset + len(data)
    header = (struct.pack(">I", size) + bytes(4) + struct.pack(">I", 0x02100000)
              + b"mntrRGB XYZ " + bytes(12) + b"acsp" + bytes(24)
              + struct.pack(">I", 0) + s15(0.9642) + s15(1.0) + s15(0.8249))
    header += bytes(128 - len(header))
    return header + table + data


ICC = _icc_adobe_rgb()


def _jpeg(arr, **save):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=90, **save)
    return buf.getvalue()


def _photo(seed=8, h=24, w=40):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // w, y * 255 // h, 255 - x * 255 // w], -1)
    return np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


def test_icc_tagged_image_to_srgb_equals_jax():
    """The port no longer refuses an ICC-tagged image: it brings it to sRGB
    through lcms2 as the JAX package does, to the same pixels."""
    import codec_eval_tpu as jce
    import codec_eval_tpu_torch as ce

    arr = _photo()
    port_img = ce.ImageData.rgb_slice_with_icc(arr.tobytes(), 40, 24, ICC)
    jax_img = jce.ImageData.rgb_slice_with_icc(arr.tobytes(), 40, 24, ICC)
    got, want = port_img.to_rgb8_srgb(), jax_img.to_rgb8_srgb()
    assert got.shape == (24, 40, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert np.abs(got.astype(int) - arr).max() > 5  # a real transform, not the identity
    assert port_img.color_profile().icc_data == ICC
    np.testing.assert_array_equal(port_img.to_rgb8(), arr)


def test_decode_jpeg_with_icc_equals_jax():
    from codec_eval_tpu.decode import decode_jpeg_with_icc as jax_decode
    from codec_eval_tpu_torch.decode import decode_jpeg_with_icc, jpeg_decode_callback

    assert jpeg_decode_callback() is decode_jpeg_with_icc
    data = _jpeg(_photo(), icc_profile=ICC)
    got, want = decode_jpeg_with_icc(data), jax_decode(data)
    assert got.icc_profile == want.icc_profile == ICC
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.to_rgb8_srgb(), want.to_rgb8_srgb())
    plain = decode_jpeg_with_icc(_jpeg(_photo()))
    assert plain.icc_profile is None and plain.color_profile().is_srgb


def test_decode_grayscale_jpeg():
    from codec_eval_tpu_torch.decode import decode_jpeg_with_icc

    gray = np.random.default_rng(3).integers(0, 256, (16, 16)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(gray, mode="L").save(buf, "JPEG")
    rgb = decode_jpeg_with_icc(buf.getvalue()).to_rgb8()
    assert rgb.shape == (16, 16, 3)
    assert np.array_equal(rgb[..., 0], rgb[..., 1])


def test_decode_refuses_cmyk_and_other_formats():
    from codec_eval_tpu_torch.decode import decode_jpeg_with_icc
    from codec_eval_tpu_torch.errors import CodecError

    buf = io.BytesIO()
    Image.new("CMYK", (8, 8)).save(buf, "JPEG")
    with pytest.raises(CodecError, match="CMYK"):
        decode_jpeg_with_icc(buf.getvalue())
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "PNG")
    with pytest.raises(CodecError, match="not a JPEG"):
        decode_jpeg_with_icc(buf.getvalue())
    with pytest.raises(CodecError):
        decode_jpeg_with_icc(b"garbage")


def test_image_open_keeps_the_profile(tmp_path):
    import codec_eval_tpu as jce
    import codec_eval_tpu_torch as ce

    path = tmp_path / "tagged.jpg"
    path.write_bytes(_jpeg(_photo(), icc_profile=ICC))
    got, want = ce.ImageData.open(path), jce.ImageData.open(path)
    assert got.icc_profile == want.icc_profile == ICC
    np.testing.assert_array_equal(got.to_rgb8_srgb(), want.to_rgb8_srgb())
    rgba = np.dstack([_photo(), np.full((24, 40), 200, np.uint8)])
    Image.fromarray(rgba).save(tmp_path / "alpha.png")
    opened = ce.ImageData.open(tmp_path / "alpha.png")
    assert opened.data.shape == (24, 40, 4) and opened.icc_profile is None
    with pytest.raises(ce.errors.ImageLoadError):
        ce.ImageData.open(tmp_path / "missing.png")


def test_session_scores_an_icc_tagged_decode_like_jax(tmp_path):
    """A codec whose decode carries an ICC profile: the session scores the
    decode after its sRGB transform, in both packages."""
    import codec_eval_tpu as jce
    import codec_eval_tpu_torch as ce
    from codec_eval_tpu.decode import decode_jpeg_with_icc as jax_decode
    from codec_eval_tpu_torch.decode import decode_jpeg_with_icc

    ref = _photo(9, 32, 32)

    def encode(image, request):
        return _jpeg(image.to_rgb8(), icc_profile=ICC)

    rows = {}
    for pkg, decode, kw in ((jce, jax_decode, {}), (ce, decode_jpeg_with_icc, {"device": "cpu"})):
        config = (pkg.EvalConfig.builder().report_dir(tmp_path / pkg.__name__)
                  .metrics(pkg.MetricConfig(ssimulacra2=True, psnr=True)).quality_levels([90])
                  .build())
        session = pkg.EvalSession(config, **kw)
        session.add_codec_with_decode("jpeg-icc", "1", encode, decode)
        rows[pkg.__name__] = session.evaluate_image("x", pkg.ImageData.rgb8(ref)).results[0]
    got, want = rows["codec_eval_tpu_torch"], rows["codec_eval_tpu"]
    assert got.file_size == want.file_size
    assert got.metrics.ssimulacra2 == pytest.approx(want.metrics.ssimulacra2, rel=1e-5)
    assert got.metrics.psnr == pytest.approx(want.metrics.psnr, rel=1e-5)
    assert got.metrics.ssimulacra2 < 90.0  # scored after the profile's transform

