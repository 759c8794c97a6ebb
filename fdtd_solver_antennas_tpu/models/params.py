"""Parameter models for antennas (SI internals, mm/GHz constructors).

Parity with the reference domain model (``antenna_sim/models.py:1-191``):
``Metal`` enum + conductor property table, ``PatchAntennaParams`` and
``HornAntennaParams`` with ``from_user_units`` mm/GHz constructors and the
same validation (positive fields, εr > 1), as plain dataclasses that raise
``ValueError`` on construction.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional


def _check(obj, **bounds) -> None:
    """Enforce ``field=(op, limit)`` bounds on ``obj``; ``op`` is "gt" or
    "ge". ``None`` passes (optional fields)."""
    for name, (op, limit) in bounds.items():
        val = getattr(obj, name)
        if val is None:
            continue
        ok = val > limit if op == "gt" else val >= limit
        if not ok:
            sign = ">" if op == "gt" else ">="
            raise ValueError(
                f"{type(obj).__name__}.{name} must be {sign} {limit}, "
                f"got {val!r}"
            )


class Metal(str, Enum):
    COPPER = "copper"
    ALUMINUM = "aluminum"
    GOLD = "gold"
    SILVER = "silver"
    TIN = "tin"


@dataclasses.dataclass
class MetalProperties:
    name: str
    conductivity_s_per_m: float
    thickness_m: float = 35e-6  # metal thickness (default ~1 oz copper)

    def __post_init__(self):
        _check(self, conductivity_s_per_m=("gt", 0), thickness_m=("gt", 0))

    def display(self) -> str:
        ms = self.conductivity_s_per_m / 1e7
        return f"{self.name} (σ≈{ms:.1f}×10^7 S/m, t={self.thickness_m * 1e6:.0f} µm)"


# Conductor property table (reference: models.py:27-33).
metal_defaults: dict[Metal, MetalProperties] = {
    Metal.COPPER: MetalProperties(
        name="Copper", conductivity_s_per_m=5.8e7, thickness_m=35e-6
    ),
    Metal.ALUMINUM: MetalProperties(
        name="Aluminum", conductivity_s_per_m=3.5e7, thickness_m=35e-6
    ),
    Metal.GOLD: MetalProperties(
        name="Gold", conductivity_s_per_m=4.1e7, thickness_m=2e-6
    ),
    Metal.SILVER: MetalProperties(
        name="Silver", conductivity_s_per_m=6.3e7, thickness_m=10e-6
    ),
    Metal.TIN: MetalProperties(
        name="Tin", conductivity_s_per_m=9.1e6, thickness_m=5e-6
    ),
}


def _resolve_metal(metal: str, metal_thickness_um: Optional[float]) -> MetalProperties:
    try:
        metal_enum = Metal(metal.lower())
    except ValueError:
        metal_enum = Metal.COPPER
    props = dataclasses.replace(metal_defaults[metal_enum])
    if metal_thickness_um is not None:
        props.thickness_m = max(1e-7, metal_thickness_um * 1e-6)
    return props


@dataclasses.dataclass
class PatchAntennaParams:
    """Rectangular microstrip patch antenna parameters (SI units internally).

    If ``patch_length_m``/``patch_width_m`` are omitted, they are designed
    for TM10 resonance at ``frequency_hz`` (reference: models.py:36-107).
    """

    frequency_hz: float
    eps_r: float
    h_m: float
    loss_tangent: float = 0.0
    metal: MetalProperties = dataclasses.field(
        default_factory=lambda: metal_defaults[Metal.COPPER]
    )

    patch_length_m: Optional[float] = None
    patch_width_m: Optional[float] = None

    def __post_init__(self):
        _check(
            self, frequency_hz=("gt", 0), eps_r=("gt", 1), h_m=("gt", 0),
            loss_tangent=("ge", 0), patch_length_m=("gt", 0),
            patch_width_m=("gt", 0),
        )

    @classmethod
    def from_user_units(
        cls,
        *,
        frequency_ghz: float,
        er: float,
        h_mm: float,
        L_mm: Optional[float] = None,
        W_mm: Optional[float] = None,
        metal: str = "copper",
        loss_tangent: float = 0.0,
        metal_thickness_um: Optional[float] = None,
    ) -> "PatchAntennaParams":
        return cls(
            frequency_hz=frequency_ghz * 1e9,
            eps_r=er,
            h_m=h_mm * 1e-3,
            patch_length_m=None if L_mm is None else L_mm * 1e-3,
            patch_width_m=None if W_mm is None else W_mm * 1e-3,
            metal=_resolve_metal(metal, metal_thickness_um),
            loss_tangent=loss_tangent,
        )

    @property
    def frequency_ghz(self) -> float:
        return self.frequency_hz / 1e9

    @property
    def h_mm(self) -> float:
        return self.h_m * 1e3

    @property
    def L_mm(self) -> Optional[float]:
        return None if self.patch_length_m is None else self.patch_length_m * 1e3

    @property
    def W_mm(self) -> Optional[float]:
        return None if self.patch_width_m is None else self.patch_width_m * 1e3


@dataclasses.dataclass
class HornAntennaParams:
    """Rectangular pyramidal horn antenna parameters (reference: models.py:110-191).

    TE10 polarization implied (E along b); placement/rotation is handled by
    scene instances, not here.
    """

    frequency_hz: float
    throat_a_m: float  # throat width a (m), broad dimension
    throat_b_m: float  # throat height b (m), narrow dimension
    aperture_A_m: float  # aperture width A (m)
    aperture_B_m: float  # aperture height B (m)
    length_m: float  # horn axial length L (m)
    metal: MetalProperties = dataclasses.field(
        default_factory=lambda: metal_defaults[Metal.COPPER]
    )

    def __post_init__(self):
        _check(self, **{
            k: ("gt", 0) for k in (
                "frequency_hz", "throat_a_m", "throat_b_m", "aperture_A_m",
                "aperture_B_m", "length_m",
            )
        })

    @classmethod
    def from_user_units(
        cls,
        *,
        frequency_ghz: float,
        throat_a_mm: float,
        throat_b_mm: float,
        aperture_A_mm: float,
        aperture_B_mm: float,
        length_mm: float,
        metal: str = "copper",
    ) -> "HornAntennaParams":
        return cls(
            frequency_hz=frequency_ghz * 1e9,
            throat_a_m=throat_a_mm * 1e-3,
            throat_b_m=throat_b_mm * 1e-3,
            aperture_A_m=aperture_A_mm * 1e-3,
            aperture_B_m=aperture_B_mm * 1e-3,
            length_m=length_mm * 1e-3,
            metal=_resolve_metal(metal, None),
        )

    @property
    def frequency_ghz(self) -> float:
        return self.frequency_hz / 1e9

    @property
    def throat_a_mm(self) -> float:
        return self.throat_a_m * 1e3

    @property
    def throat_b_mm(self) -> float:
        return self.throat_b_m * 1e3

    @property
    def aperture_A_mm(self) -> float:
        return self.aperture_A_m * 1e3

    @property
    def aperture_B_mm(self) -> float:
        return self.aperture_B_m * 1e3

    @property
    def length_mm(self) -> float:
        return self.length_m * 1e3
