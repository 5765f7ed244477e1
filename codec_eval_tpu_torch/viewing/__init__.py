"""Viewing-condition modelling for perceptual quality assessment.

A host copy of ``codec_eval_tpu/viewing/__init__.py`` (the port imports
nothing from the JAX package), the reference's viewing layer
(reference: src/viewing.rs:33-656): effective pixels-per-degree from device
acuity and srcset ratios, simulation parameters (accurate vs downsample-only),
PPD-relative metric-threshold adjustment, and the eight named presets.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

#: Reference PPD for threshold normalization (desktop at arm's length).
#: reference: src/viewing.rs:337
REFERENCE_PPD = 40.0


class SimulationMode(enum.Enum):
    """How to handle image scaling during viewing simulation.
    reference: src/viewing.rs:33-54."""

    ACCURATE = "accurate"  # simulate browser up/downscaling exactly
    DOWNSAMPLE_ONLY = "downsample_only"  # never upsample; adjust PPD instead


@dataclass
class SimulationParams:
    """Image transform + threshold adjustment for a viewing condition.
    reference: src/viewing.rs:308-468."""

    scale_factor: float
    target_width: int
    target_height: int
    adjusted_ppd: float
    requires_upscale: bool
    requires_downscale: bool

    def requires_scaling(self) -> bool:
        return self.requires_upscale or self.requires_downscale

    def downscale_only_factor(self) -> float:
        return min(self.scale_factor, 1.0)

    def threshold_multiplier(self) -> float:
        """1.0 at REFERENCE_PPD; >1 (lenient) at higher PPD."""
        return self.adjusted_ppd / REFERENCE_PPD

    def adjust_dssim_threshold(self, base_threshold: float) -> float:
        return base_threshold * self.threshold_multiplier()

    def adjust_butteraugli_threshold(self, base_threshold: float) -> float:
        return base_threshold * self.threshold_multiplier()

    def adjust_ssimulacra2_threshold(self, base_threshold: float) -> float:
        """SSIMULACRA2 is higher-is-better: remap toward/away from 100.
        reference: src/viewing.rs:432-445."""
        m = self.threshold_multiplier()
        if m >= 1.0:
            adjusted = base_threshold - (100.0 - base_threshold) * (1.0 - 1.0 / m)
        else:
            adjusted = base_threshold + (100.0 - base_threshold) * (1.0 / m - 1.0)
        return max(0.0, min(100.0, adjusted))

    def dssim_acceptable(self, dssim: float, base_threshold: float) -> bool:
        return dssim < self.adjust_dssim_threshold(base_threshold)

    def butteraugli_acceptable(self, butteraugli: float, base_threshold: float) -> bool:
        return butteraugli < self.adjust_butteraugli_threshold(base_threshold)

    def ssimulacra2_acceptable(self, ssimulacra2: float, base_threshold: float) -> bool:
        return ssimulacra2 > self.adjust_ssimulacra2_threshold(base_threshold)


@dataclass
class ViewingCondition:
    """Models how an image is viewed (display acuity, srcset ratios).
    reference: src/viewing.rs:74-301."""

    acuity_ppd: float
    browser_dppx: Optional[float] = None
    image_intrinsic_dppx: Optional[float] = None
    ppd: Optional[float] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def desktop(cls) -> "ViewingCondition":
        """Desktop monitor at arm's length (~40 PPD)."""
        return cls(40.0)

    @classmethod
    def laptop(cls) -> "ViewingCondition":
        """Laptop screen (~60 PPD)."""
        return cls(60.0)

    @classmethod
    def smartphone(cls) -> "ViewingCondition":
        """Smartphone at reading distance (~90 PPD)."""
        return cls(90.0)

    # -- builders ----------------------------------------------------------
    def with_browser_dppx(self, dppx: float) -> "ViewingCondition":
        self.browser_dppx = dppx
        return self

    def with_image_intrinsic_dppx(self, dppx: float) -> "ViewingCondition":
        self.image_intrinsic_dppx = dppx
        return self

    def with_ppd_override(self, ppd: float) -> "ViewingCondition":
        self.ppd = ppd
        return self

    # -- queries -----------------------------------------------------------
    def effective_ppd(self) -> float:
        """acuity * (intrinsic / browser), or the override if set.
        reference: src/viewing.rs:194-206."""
        if self.ppd is not None:
            return self.ppd
        browser = self.browser_dppx if self.browser_dppx is not None else 1.0
        intrinsic = (
            self.image_intrinsic_dppx if self.image_intrinsic_dppx is not None else 1.0
        )
        return self.acuity_ppd * (intrinsic / browser)

    def srcset_ratio(self) -> float:
        browser = self.browser_dppx if self.browser_dppx is not None else 1.0
        intrinsic = (
            self.image_intrinsic_dppx if self.image_intrinsic_dppx is not None else 1.0
        )
        return intrinsic / browser

    def simulation_params(
        self, image_width: int, image_height: int, mode: SimulationMode
    ) -> SimulationParams:
        """reference: src/viewing.rs:244-301."""
        ratio = self.srcset_ratio()
        if mode is SimulationMode.ACCURATE or ratio >= 1.0:
            return SimulationParams(
                scale_factor=ratio,
                target_width=round(image_width * ratio),
                target_height=round(image_height * ratio),
                adjusted_ppd=self.effective_ppd(),
                requires_upscale=(mode is SimulationMode.ACCURATE and ratio < 1.0),
                requires_downscale=ratio > 1.0,
            )
        # Downsample-only + undersized: keep size, reduce PPD instead.
        return SimulationParams(
            scale_factor=1.0,
            target_width=image_width,
            target_height=image_height,
            adjusted_ppd=self.acuity_ppd * ratio,
            requires_upscale=False,
            requires_downscale=False,
        )

    def to_json(self) -> dict:
        return {
            "acuity_ppd": self.acuity_ppd,
            "browser_dppx": self.browser_dppx,
            "image_intrinsic_dppx": self.image_intrinsic_dppx,
            "ppd": self.ppd,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ViewingCondition":
        return cls(
            acuity_ppd=d["acuity_ppd"],
            browser_dppx=d.get("browser_dppx"),
            image_intrinsic_dppx=d.get("image_intrinsic_dppx"),
            ppd=d.get("ppd"),
        )


class presets:
    """Named viewing presets.  reference: src/viewing.rs:495-656."""

    @staticmethod
    def native_desktop() -> ViewingCondition:
        """1x srcset on 1x desktop — most demanding (40 PPD)."""
        return ViewingCondition(40.0).with_browser_dppx(1.0).with_image_intrinsic_dppx(1.0)

    @staticmethod
    def native_laptop() -> ViewingCondition:
        """2x on 2x retina laptop (70 PPD)."""
        return ViewingCondition(70.0).with_browser_dppx(2.0).with_image_intrinsic_dppx(2.0)

    @staticmethod
    def native_phone() -> ViewingCondition:
        """3x on 3x phone (95 PPD)."""
        return ViewingCondition(95.0).with_browser_dppx(3.0).with_image_intrinsic_dppx(3.0)

    @staticmethod
    def srcset_1x_on_phone() -> ViewingCondition:
        """1x srcset upscaled on 3x phone (~32 PPD) — worst case."""
        return ViewingCondition(95.0).with_browser_dppx(3.0).with_image_intrinsic_dppx(1.0)

    @staticmethod
    def srcset_1x_on_laptop() -> ViewingCondition:
        """1x srcset on 2x laptop (35 PPD)."""
        return ViewingCondition(70.0).with_browser_dppx(2.0).with_image_intrinsic_dppx(1.0)

    @staticmethod
    def srcset_2x_on_phone() -> ViewingCondition:
        """2x srcset on 3x phone (~63 PPD)."""
        return ViewingCondition(95.0).with_browser_dppx(3.0).with_image_intrinsic_dppx(2.0)

    @staticmethod
    def srcset_2x_on_desktop() -> ViewingCondition:
        """2x srcset downscaled on 1x desktop (80 PPD)."""
        return ViewingCondition(40.0).with_browser_dppx(1.0).with_image_intrinsic_dppx(2.0)

    @staticmethod
    def srcset_2x_on_laptop_1_5x() -> ViewingCondition:
        """2x srcset on 1.5x laptop (~93 PPD)."""
        return ViewingCondition(70.0).with_browser_dppx(1.5).with_image_intrinsic_dppx(2.0)

    @staticmethod
    def srcset_3x_on_phone() -> ViewingCondition:
        return presets.native_phone()

    @staticmethod
    def all() -> List[ViewingCondition]:
        """All presets ordered most to least demanding."""
        return [
            presets.srcset_1x_on_phone(),
            presets.srcset_1x_on_laptop(),
            presets.native_desktop(),
            presets.srcset_2x_on_phone(),
            presets.native_laptop(),
            presets.srcset_2x_on_desktop(),
            presets.srcset_2x_on_laptop_1_5x(),
            presets.native_phone(),
        ]

    @staticmethod
    def key() -> List[ViewingCondition]:
        return [presets.native_desktop(), presets.native_laptop(), presets.native_phone()]

    @staticmethod
    def baseline() -> ViewingCondition:
        return presets.native_laptop()

    @staticmethod
    def demanding() -> ViewingCondition:
        return presets.native_desktop()


__all__ = [
    "REFERENCE_PPD",
    "SimulationMode",
    "SimulationParams",
    "ViewingCondition",
    "presets",
]


def simulate_viewing(image_u8, params: "SimulationParams", method: str = "linear",
                     device="cuda"):
    """Apply viewing simulation to pixels (a linear-light resize on
    ``device``, the card unless the caller asks for the CPU).

    The reference prescribes this transform but leaves resampling
    unimplemented (src/viewing.rs:244-301); see
    codec_eval_tpu_torch.kernels.resize for the PyTorch implementation.
    """
    from ..kernels.resize import simulate_viewing as _impl

    return _impl(image_u8, params, method=method, device=device)


__all__.append("simulate_viewing")
