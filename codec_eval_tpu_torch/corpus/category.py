"""Image category classification.  A copy of
``codec_eval_tpu/corpus/category.py`` (reference: src/corpus/category.rs:8-114).
"""

from __future__ import annotations

import enum
from typing import List, Optional


class ImageCategory(enum.Enum):
    PHOTO = "photo"
    ILLUSTRATION = "illustration"
    TEXT = "text"
    SCREENSHOT = "screenshot"
    HIGH_FREQUENCY = "high_frequency"
    LOW_FREQUENCY = "low_frequency"
    GRADIENT = "gradient"
    PATTERN = "pattern"
    CGI = "cgi"
    SCIENTIFIC = "scientific"
    OTHER = "other"

    @classmethod
    def all(cls) -> List["ImageCategory"]:
        return list(cls)

    @classmethod
    def from_str_loose(cls, s: str) -> Optional["ImageCategory"]:
        """Case-insensitive alias parse.  reference: src/corpus/category.rs:54-69."""
        aliases = {
            "photo": cls.PHOTO, "photograph": cls.PHOTO, "photos": cls.PHOTO,
            "illustration": cls.ILLUSTRATION, "drawing": cls.ILLUSTRATION,
            "art": cls.ILLUSTRATION, "artwork": cls.ILLUSTRATION,
            "text": cls.TEXT, "document": cls.TEXT, "docs": cls.TEXT,
            "screenshot": cls.SCREENSHOT, "screenshots": cls.SCREENSHOT,
            "ui": cls.SCREENSHOT,
            "high_frequency": cls.HIGH_FREQUENCY, "highfreq": cls.HIGH_FREQUENCY,
            "texture": cls.HIGH_FREQUENCY, "textures": cls.HIGH_FREQUENCY,
            "low_frequency": cls.LOW_FREQUENCY, "lowfreq": cls.LOW_FREQUENCY,
            "smooth": cls.LOW_FREQUENCY,
            "gradient": cls.GRADIENT, "gradients": cls.GRADIENT,
            "pattern": cls.PATTERN, "patterns": cls.PATTERN,
            "cgi": cls.CGI, "render": cls.CGI, "3d": cls.CGI,
            "scientific": cls.SCIENTIFIC, "medical": cls.SCIENTIFIC,
            "science": cls.SCIENTIFIC,
            "other": cls.OTHER, "misc": cls.OTHER, "unknown": cls.OTHER,
        }
        return aliases.get(s.lower())

    def description(self) -> str:
        return {
            ImageCategory.PHOTO: "Photographic content",
            ImageCategory.ILLUSTRATION: "Digital illustrations and artwork",
            ImageCategory.TEXT: "Text-heavy images and documents",
            ImageCategory.SCREENSHOT: "Screenshots and UI captures",
            ImageCategory.HIGH_FREQUENCY: "High-frequency detail (textures, foliage)",
            ImageCategory.LOW_FREQUENCY: "Low-frequency content (sky, gradients)",
            ImageCategory.GRADIENT: "Smooth gradients",
            ImageCategory.PATTERN: "Repeating patterns",
            ImageCategory.CGI: "Computer-generated imagery",
            ImageCategory.SCIENTIFIC: "Medical or scientific imagery",
            ImageCategory.OTHER: "Uncategorized",
        }[self]

    def __str__(self) -> str:
        return self.value
