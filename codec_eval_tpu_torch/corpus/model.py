"""Corpus model: images, manifests, filters, deterministic splits, datasets.

A copy of ``codec_eval_tpu/corpus/model.py`` (reference:
src/corpus/mod.rs:38-457).  Named datasets resolve from the local cache
directory (``$CODEC_CORPUS_DIR`` or ``~/.cache/codec-corpus``) and are
fetched from ``$CODEC_CORPUS_MIRROR`` only when missing (``download.py``).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..errors import CorpusError
from .category import ImageCategory
from .checksum import checksum_hex
from .discovery import SUPPORTED_EXTENSIONS, discover_images


def _has_image_files(root: Path) -> bool:
    """Any supported image anywhere under ``root`` (dotdirs skipped).
    reference: src/corpus/mod.rs helper used by discover_or_download."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for f in filenames:
            if f.rsplit(".", 1)[-1].lower() in SUPPORTED_EXTENSIONS:
                return True
    return False


@dataclass
class CorpusImage:
    """One image in a corpus.  reference: src/corpus/mod.rs:72-91."""

    relative_path: str
    category: Optional[ImageCategory] = None
    width: int = 0
    height: int = 0
    file_size: int = 0
    checksum: Optional[str] = None
    format: str = ""

    def name(self) -> str:
        """Unique report name: the extension-stripped relative path with
        separators sanitized, so same-named files in different category
        subdirectories don't overwrite each other's reports."""
        p = Path(self.relative_path)
        parts = [*p.parts[:-1], p.stem]
        return "__".join(parts)

    def full_path(self, root: Path) -> Path:
        return Path(root) / self.relative_path

    def pixel_count(self) -> int:
        return self.width * self.height

    def to_json(self) -> dict:
        return {
            "relative_path": self.relative_path,
            "category": str(self.category) if self.category else None,
            "width": self.width,
            "height": self.height,
            "file_size": self.file_size,
            "checksum": self.checksum,
            "format": self.format,
        }

    @classmethod
    def from_json(cls, d: dict) -> "CorpusImage":
        cat = d.get("category")
        return cls(
            relative_path=d["relative_path"],
            category=ImageCategory.from_str_loose(cat) if cat else None,
            width=d.get("width", 0),
            height=d.get("height", 0),
            file_size=d.get("file_size", 0),
            checksum=d.get("checksum"),
            format=d.get("format", ""),
        )


@dataclass
class CorpusStats:
    """reference: src/corpus/mod.rs:441-457."""

    image_count: int
    total_pixels: int
    total_bytes: int
    min_width: int
    max_width: int
    min_height: int
    max_height: int


@dataclass
class CorpusMetadata:
    description: str = ""
    source: str = ""
    category_counts: Dict[str, int] = field(default_factory=dict)


@dataclass
class Corpus:
    """A named collection of images rooted at a directory.
    reference: src/corpus/mod.rs:38-51."""

    name: str
    root_path: Path
    images: List[CorpusImage] = field(default_factory=list)
    metadata: CorpusMetadata = field(default_factory=CorpusMetadata)

    # -- discovery / datasets ---------------------------------------------
    @classmethod
    def discover(cls, path) -> "Corpus":
        """Recursive scan with header-only dimension parsing.
        reference: src/corpus/discovery.rs:15-46."""
        root = Path(path)
        corpus = cls(name=root.name or "corpus", root_path=root)
        for info in discover_images(root):
            corpus.images.append(
                CorpusImage(
                    relative_path=info["relative_path"],
                    category=info["category"],
                    width=info["width"],
                    height=info["height"],
                    file_size=info["file_size"],
                    format=info["format"],
                )
            )
        corpus.update_category_counts()
        return corpus

    #: Known dataset registry (name -> subdirectory under the cache root).
    #: Mirrors the codec-corpus crate's catalog (kodak, CID22 tiers, CLIC).
    DATASETS = {
        "kodak": "kodak",
        "cid22": "CID22/CID22-512",
        "cid22-training": "CID22/training",
        "cid22-validation": "CID22/validation",
        "clic2025": "clic2025",
        "clic2025-training": "clic2025/training",
        "sharpened-800px": "sharpened-800px",
    }

    @classmethod
    def dataset_cache_root(cls) -> Path:
        return Path(
            os.environ.get(
                "CODEC_CORPUS_DIR", Path.home() / ".cache" / "codec-corpus"
            )
        )

    @classmethod
    def get_dataset(cls, name: str) -> "Corpus":
        """Resolve a named dataset: cache hit, else fetch from the mirror.
        reference: src/corpus/mod.rs:157-167 (download+cache by name; the
        codec-corpus crate behavior, implemented in corpus/download.py)."""
        key = name.lower()
        if key not in cls.DATASETS:
            raise CorpusError(
                f"Unknown dataset '{name}'. Known: {sorted(cls.DATASETS)}"
            )
        path = cls.dataset_cache_root() / cls.DATASETS[key]
        if not path.exists():
            from .download import fetch_dataset, mirror_base

            if mirror_base() is None:
                raise CorpusError(
                    f"Dataset '{name}' not cached at {path} and no mirror "
                    f"is configured. Set CODEC_CORPUS_MIRROR (https:// or "
                    f"file:// base URL of the dataset archives), or set "
                    f"CODEC_CORPUS_DIR / place images there manually."
                )
            fetch_dataset(key, path)
        corpus = cls.discover(path)
        corpus.name = name
        return corpus

    @classmethod
    def download_dataset(cls, dataset: str) -> "Corpus":
        """Legacy alias for :meth:`get_dataset`.
        reference: src/corpus/mod.rs:249-252."""
        return cls.get_dataset(dataset)

    @classmethod
    def discover_or_download(
        cls, path, url: Optional[str] = None, subsets: Optional[List[str]] = None
    ) -> "Corpus":
        """Discover an existing on-disk corpus; error with a get_dataset
        pointer when absent.  reference: src/corpus/mod.rs:179-195 (the
        corpus-feature build: url/subsets accepted for signature parity,
        discovery only)."""
        del url, subsets
        root = Path(path)
        if root.is_dir() and _has_image_files(root):
            return cls.discover(root)
        raise CorpusError(
            f"Path {root} not found. Use Corpus.get_dataset() to download "
            f"datasets automatically."
        )

    @classmethod
    def get_or_download(cls, preferred_path) -> "Corpus":
        """Check common local locations for an existing corpus (legacy).
        reference: src/corpus/mod.rs:264-305."""
        candidates = [
            Path(preferred_path),
            Path("./codec-corpus"),
            Path("../codec-corpus"),
            Path("../codec-comparison/codec-corpus"),
        ]
        for cand in candidates:
            if cand.is_dir() and _has_image_files(cand):
                print(f"Found corpus at {cand}", file=sys.stderr)
                return cls.discover(cand)
        raise CorpusError(
            "Corpus not found at any common location. Use "
            'Corpus.get_dataset("kodak") to download automatically.'
        )

    # -- manifest ----------------------------------------------------------
    def save_manifest(self, path) -> None:
        """reference: src/corpus/mod.rs:308-319."""
        with open(path, "w") as f:
            json.dump(
                {
                    "name": self.name,
                    "root_path": str(self.root_path),
                    "images": [img.to_json() for img in self.images],
                    "metadata": {
                        "description": self.metadata.description,
                        "source": self.metadata.source,
                        "category_counts": self.metadata.category_counts,
                    },
                },
                f,
                indent=2,
            )

    @classmethod
    def load_manifest(cls, path) -> "Corpus":
        with open(path) as f:
            d = json.load(f)
        meta = d.get("metadata", {})
        return cls(
            name=d["name"],
            root_path=Path(d["root_path"]),
            images=[CorpusImage.from_json(i) for i in d.get("images", [])],
            metadata=CorpusMetadata(
                description=meta.get("description", ""),
                source=meta.get("source", ""),
                category_counts=meta.get("category_counts", {}),
            ),
        )

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.images)

    def is_empty(self) -> bool:
        return not self.images

    def filter_category(self, category: ImageCategory) -> List[CorpusImage]:
        return [img for img in self.images if img.category == category]

    def filter_format(self, fmt: str) -> List[CorpusImage]:
        fl = fmt.lower()
        return [img for img in self.images if img.format.lower() == fl]

    def filter_min_size(self, min_width: int, min_height: int) -> List[CorpusImage]:
        return [
            img
            for img in self.images
            if img.width >= min_width and img.height >= min_height
        ]

    def split(self, train_ratio: float) -> Tuple[List[CorpusImage], List[CorpusImage]]:
        """Deterministic checksum-hash train/val split.
        reference: src/corpus/mod.rs:369-389."""
        train_ratio = min(max(train_ratio, 0.0), 1.0)
        train: List[CorpusImage] = []
        val: List[CorpusImage] = []
        for i, img in enumerate(self.images):
            if img.checksum:
                h = sum(img.checksum.encode()) & 0xFFFFFFFFFFFFFFFF
            else:
                h = i
            if (h % 1000) < int(train_ratio * 1000.0):
                train.append(img)
            else:
                val.append(img)
        return train, val

    def compute_checksums(self) -> int:
        """Fill missing checksums (FNV-1a via the native lib when present).
        reference: src/corpus/mod.rs:392-407."""
        from ..utils.native import fnv1a64_file

        computed = 0
        for img in self.images:
            if img.checksum is None:
                path = img.full_path(self.root_path)
                if path.exists():
                    img.checksum = checksum_hex(fnv1a64_file(path))
                    computed += 1
        return computed

    def find_duplicates(self) -> List[List[CorpusImage]]:
        by_checksum: Dict[str, List[CorpusImage]] = {}
        for img in self.images:
            if img.checksum:
                by_checksum.setdefault(img.checksum, []).append(img)
        return [group for group in by_checksum.values() if len(group) > 1]

    def update_category_counts(self) -> None:
        counts: Dict[str, int] = {}
        for img in self.images:
            if img.category:
                counts[str(img.category)] = counts.get(str(img.category), 0) + 1
        self.metadata.category_counts = counts

    def stats(self) -> CorpusStats:
        widths = [img.width for img in self.images]
        heights = [img.height for img in self.images]
        return CorpusStats(
            image_count=len(self.images),
            total_pixels=sum(img.pixel_count() for img in self.images),
            total_bytes=sum(img.file_size for img in self.images),
            min_width=min(widths, default=0),
            max_width=max(widths, default=0),
            min_height=min(heights, default=0),
            max_height=max(heights, default=0),
        )
