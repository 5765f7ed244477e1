"""Dataset fetch-by-name: the codec-corpus crate analog.

A copy of ``codec_eval_tpu/corpus/download.py`` (reference:
src/corpus/mod.rs:157-167): resolve a dataset name to an archive under the
mirror base URL ``$CODEC_CORPUS_MIRROR`` (``https://`` or ``file://``),
fetch it with urllib, verify its sha256 where pinned, and unpack it
atomically into the cache directory.  Nothing is fetched unless a mirror is
configured.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import tempfile
import urllib.error
import urllib.request
import zipfile
from pathlib import Path
from typing import Optional

from ..errors import CorpusError

#: Archive location (relative to the mirror base URL) and pinned sha256 per
#: dataset name.  ``None`` digest = accept any archive but print its digest
#: so deployments can pin it (the public mirrors re-compress periodically).
DATASET_ARCHIVES = {
    "kodak": ("kodak.tar.gz", None),
    "cid22": ("CID22-512.tar.gz", None),
    "cid22-training": ("CID22-training.tar.gz", None),
    "cid22-validation": ("CID22-validation.tar.gz", None),
    "clic2025": ("clic2025.tar.gz", None),
    "clic2025-training": ("clic2025-training.tar.gz", None),
    "sharpened-800px": ("sharpened-800px.tar.gz", None),
}


def mirror_base() -> Optional[str]:
    """The configured mirror base URL, or None if fetching is unavailable."""
    return os.environ.get("CODEC_CORPUS_MIRROR")


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _extract(archive: Path, dest: Path) -> None:
    """Unpack tar/zip into ``dest``, refusing path traversal."""
    dest.mkdir(parents=True, exist_ok=True)
    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as z:
            for member in z.namelist():
                target = (dest / member).resolve()
                if not str(target).startswith(str(dest.resolve())):
                    raise CorpusError(f"archive path escapes cache: {member}")
            z.extractall(dest)
        return
    with tarfile.open(archive) as t:
        for member in t.getmembers():
            target = (dest / member.name).resolve()
            if not str(target).startswith(str(dest.resolve())):
                raise CorpusError(f"archive path escapes cache: {member.name}")
        t.extractall(dest, filter="data")


def fetch_dataset(
    name: str,
    dest_dir: Path,
    mirror: Optional[str] = None,
    expected_sha256: Optional[str] = None,
) -> Path:
    """Download + verify + unpack dataset ``name`` into ``dest_dir``.

    Returns ``dest_dir``.  Raises CorpusError with an actionable message on
    any failure (no mirror configured, fetch error, checksum mismatch).
    The unpack is atomic: the archive is extracted into a sibling temp
    directory and renamed into place, so an interrupted fetch never leaves
    a half-populated dataset the cache would later trust.
    """
    key = name.lower()
    if key not in DATASET_ARCHIVES:
        raise CorpusError(
            f"No archive source for dataset '{name}'. "
            f"Known: {sorted(DATASET_ARCHIVES)}"
        )
    base = mirror or mirror_base()
    if not base:
        raise CorpusError(
            f"Dataset '{name}' is not cached and no mirror is configured. "
            f"Set CODEC_CORPUS_MIRROR to an https:// or file:// base URL "
            f"hosting the dataset archives, or populate the cache manually."
        )
    rel, pinned = DATASET_ARCHIVES[key]
    if expected_sha256 is None:
        expected_sha256 = pinned
    url = base.rstrip("/") + "/" + rel

    dest_dir = Path(dest_dir)
    dest_dir.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dest_dir.parent) as tmp:
        archive = Path(tmp) / rel
        try:
            with urllib.request.urlopen(url) as resp, open(archive, "wb") as out:
                shutil.copyfileobj(resp, out)
        except (urllib.error.URLError, OSError) as e:
            raise CorpusError(f"Failed to fetch '{url}': {e}") from e

        digest = _sha256(archive)
        if expected_sha256 is not None:
            if digest != expected_sha256:
                raise CorpusError(
                    f"Checksum mismatch for '{name}': expected "
                    f"{expected_sha256}, got {digest} — refusing to populate "
                    f"the cache from a corrupt or tampered archive."
                )
        else:
            print(f"[codec-corpus] fetched {rel} sha256={digest} (unpinned)")

        staging = Path(tmp) / "unpacked"
        _extract(archive, staging)
        # Archives may nest everything under a single top-level directory;
        # normalize so dest_dir contains the images directly.
        entries = list(staging.iterdir())
        src = entries[0] if len(entries) == 1 and entries[0].is_dir() else staging
        if dest_dir.exists():
            shutil.rmtree(dest_dir)
        shutil.move(str(src), str(dest_dir))
    return dest_dir


__all__ = ["DATASET_ARCHIVES", "fetch_dataset", "mirror_base"]
