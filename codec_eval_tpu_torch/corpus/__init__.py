"""The corpus layer: discovery, categories, checksums, manifests, sparse
checkout and the dataset registry; host copies of ``codec_eval_tpu/corpus``.
"""

from .category import ImageCategory
from .checksum import checksum_hex, fnv1a_64, fnv1a_64_file
from .discovery import discover_images, image_dimensions
from .model import Corpus, CorpusImage, CorpusMetadata, CorpusStats
from .sparse import SparseCheckout, SparseFilter, SparseStatus, matches_pattern

__all__ = [
    "ImageCategory",
    "checksum_hex",
    "fnv1a_64",
    "fnv1a_64_file",
    "discover_images",
    "image_dimensions",
    "Corpus",
    "CorpusImage",
    "CorpusMetadata",
    "CorpusStats",
    "SparseCheckout",
    "SparseFilter",
    "SparseStatus",
    "matches_pattern",
]
