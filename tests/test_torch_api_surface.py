"""The port's public surface against the JAX package's committed snapshot.

``docs/public-api/codec_eval_tpu.txt`` lists every public name of the JAX
package by module.  Under the headings of the modules the port has, each
``class``, ``fn``, ``reexport`` and ``const`` must exist at the same dotted
path in ``codec_eval_tpu_torch``, and each ``method`` and ``property`` of a
class the port has must exist on the port's class, unless it is listed in
``WAITING`` with the ROADMAP Queue 1 item that ports it.  The snapshot is
read as text: this test imports no JAX.
"""

import importlib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SNAPSHOT = REPO / "docs" / "public-api" / "codec_eval_tpu.txt"
ROADMAP = REPO / "ROADMAP.md"
# The modules the port has: "" is the package root.
PORTED = ("", "engine", "metrics", "viewing", "stats", "kernels", "errors", "color", "iter",
          "parallel", "corpus", "importers", "codecs", "decode", "analysis")

# Each name of the snapshot that the port lacks -> the ROADMAP Queue 1 item
# that ports it, or "out of scope" for the TPU-only names the ROADMAP sets
# aside.  Keys drop the module heading: "ImageData.open" stands for both
# ``codec_eval_tpu.ImageData.open`` and ``codec_eval_tpu.engine.ImageData.open``.
WAITING = {
    # The JAX sharding objects (ROADMAP, "Out of scope this round").
    "pair_sharding": "out of scope",
    "scalar_sharding": "out of scope",
}
_LINE = re.compile(r"^(\s*)(class|fn|reexport|const|method|property) (codec_eval_tpu[\w.]*)")


def _entries():
    """(heading, kind, key) for every entry under a ported heading; the key
    is the dotted name below the heading's module."""
    heading, out = None, []
    for line in SNAPSHOT.read_text().splitlines():
        head = re.match(r"^## codec_eval_tpu(?:\.(\S+))?$", line)
        if head:
            heading = head.group(1) or ""
            continue
        m = _LINE.match(line)
        if m and heading in PORTED:
            prefix = "codec_eval_tpu" + (f".{heading}" if heading else "") + "."
            assert m.group(3).startswith(prefix), line
            out.append((heading, m.group(2), m.group(3)[len(prefix):]))
    return out


ENTRIES = _entries()


def _resolve(heading, key):
    obj = importlib.import_module("codec_eval_tpu_torch" + (f".{heading}" if heading else ""))
    for part in key.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _member_of_missing_class(heading, key):
    return "." in key and not _resolve(heading, key.rsplit(".", 1)[0])


def test_snapshot_has_every_ported_heading():
    assert {h for h, _k, _n in ENTRIES} == set(PORTED)
    assert len(ENTRIES) > 250


@pytest.mark.parametrize("heading", PORTED, ids=lambda h: h or "root")
def test_every_snapshot_name_exists_or_waits(heading):
    missing = sorted({key for h, _kind, key in ENTRIES
                      if h == heading and not _resolve(h, key)
                      and not _member_of_missing_class(h, key)})
    assert [k for k in missing if k not in WAITING] == []


def test_waiting_names_are_still_missing():
    """A name that the port gains leaves ``WAITING`` in the same change."""
    keys = {key for _h, _kind, key in ENTRIES}
    for name in WAITING:
        assert name in keys, name
        assert not any(_resolve(h, key) for h, _kind, key in ENTRIES if key == name), name


def test_no_root_name_waits():
    root = sorted(key for h, kind, key in ENTRIES
                  if h == "" and kind in ("class", "fn", "reexport", "const")
                  and not _resolve(h, key))
    assert root == []


@pytest.mark.parametrize("heading", ["corpus", "importers", "codecs", "decode"])
def test_host_io_and_codec_names_all_exist_but_the_device_jpeg_codec(heading):
    """Every name, the device JPEG codec (``TpuJpegCodec``,
    ``decode_jpeg_device``, ``score_jpeg_files``) included."""
    missing = {key for h, _kind, key in ENTRIES if h == heading and not _resolve(h, key)}
    assert missing == set()
    if heading == "codecs":
        assert {"TpuJpegCodec", "TpuJpegCodec.device_sweep", "decode_jpeg_device",
                "score_jpeg_files"} <= {key for h, _kind, key in ENTRIES if h == heading}


def test_waiting_items_are_in_the_roadmap():
    text = ROADMAP.read_text()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    items = {int(n) for n in re.findall(r"^(\d+)\. \*\*", queue, flags=re.M)}
    out_of_scope = text[text.index("**Out of scope this round:**"):]
    for name, item in WAITING.items():
        if item == "out of scope":
            assert f"`{name}`" in out_of_scope, name
        else:
            assert item in items, (name, item)


def test_crate_root_names_of_this_slice():
    import codec_eval_tpu_torch as ce

    for name in ("CorpusReport", "evaluate_single", "assert_quality", "assert_perception_level",
                 "QualityBelowThreshold", "ViewingCondition", "presets", "SimulationParams",
                 "SimulationMode", "REFERENCE_PPD", "bd_rate", "ParetoFront", "RDPoint",
                 "Summary", "xyb_roundtrip"):
        assert hasattr(ce, name) and name in ce.__all__, name
