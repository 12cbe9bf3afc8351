"""Render-algorithm registry.

The reference registers ~60 algorithm variants via a compile-time trait
table (``FractalSharkLib/RenderAlgorithm.h:81-159`` enum,
``:175-1530`` traits, ``:1593-1672`` runtime array).  Here the 60
variants collapse to a few dtype-parameterized kernel families; this
registry keeps the full reference name surface (so CLI flags and saved
files interoperate) and maps each name to {family, dtype, LA mode,
compression}.

Naming: reference "Gpu*" names are accepted verbatim and also as "Tpu*"
aliases; AUTO picks them on any accelerator platform.

dtype codes:
  f32 / f64        — native float
  2x32             — double-float (two f32, ~48-bit mantissa; reference
                     CudaDblflt, HpSharkFloatLib/CudaDblflt.h)
  hdr32 / hdr64    — HDRFloat: f32/f64 mantissa + int32 exponent
  hdr2x32          — HDRFloat over double-float mantissa
  hp               — host HighPrecision (CpuHigh)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class Family(Enum):
    DIRECT = "direct"            # plain escape iteration
    PERTURB_BLA = "bla"          # perturbation + bilinear approx tables
    PERTURB_SCALED = "scaled"    # perturbation w/ periodic rescaling
    PERTURB_LAV2 = "lav2"        # perturbation + LA (flagship deep zoom)
    AUTO = "auto"


class LAMode(Enum):
    FULL = "full"   # AT head skip + LA stages + perturbation tail
    PO = "po"       # perturbation-only tail (no LA stepping)
    LAO = "lao"     # LA-only (no perturbation tail)


@dataclass(frozen=True)
class RenderAlgorithm:
    name: str
    family: Family
    dtype: str = "f64"
    requires_accelerator: bool = False
    requires_reference: bool = False
    la_mode: LAMode | None = None
    runtime_decompression: bool = False   # "RC" variants
    test_views: tuple = field(default=())
    aliases: tuple = field(default=())

    @property
    def is_perturbed(self) -> bool:
        return self.family in (Family.PERTURB_BLA, Family.PERTURB_SCALED,
                               Family.PERTURB_LAV2)


def _lav2_block(prefix: str, dtype: str, accel: bool) -> list[RenderAlgorithm]:
    out = []
    for rc in ("", "RC"):
        for mode, suffix in ((LAMode.FULL, ""), (LAMode.PO, "PO"),
                             (LAMode.LAO, "LAO")):
            name = f"{prefix}Perturbed{rc}LAv2{suffix}"
            out.append(RenderAlgorithm(
                name=name, family=Family.PERTURB_LAV2, dtype=dtype,
                requires_accelerator=accel, requires_reference=True,
                la_mode=mode, runtime_decompression=(rc == "RC")))
    return out


def _build_registry() -> dict[str, RenderAlgorithm]:
    algs: list[RenderAlgorithm] = []

    # --- CPU (host/lockstep-JAX) algorithms -------------------------------
    algs += [
        RenderAlgorithm("CpuHigh", Family.DIRECT, "hp"),
        RenderAlgorithm("Cpu64", Family.DIRECT, "f64"),
        RenderAlgorithm("CpuHDR32", Family.DIRECT, "hdr32"),
        RenderAlgorithm("CpuHDR64", Family.DIRECT, "hdr64"),
        RenderAlgorithm("Cpu64PerturbedBLA", Family.PERTURB_BLA, "f64",
                        requires_reference=True),
        RenderAlgorithm("Cpu32PerturbedBLAHDR", Family.PERTURB_BLA, "hdr32",
                        requires_reference=True),
        RenderAlgorithm("Cpu64PerturbedBLAHDR", Family.PERTURB_BLA, "hdr64",
                        requires_reference=True),
        RenderAlgorithm("Cpu32PerturbedBLAV2HDR", Family.PERTURB_LAV2,
                        "hdr32", requires_reference=True, la_mode=LAMode.FULL),
        RenderAlgorithm("Cpu64PerturbedBLAV2HDR", Family.PERTURB_LAV2,
                        "hdr64", requires_reference=True, la_mode=LAMode.FULL),
        RenderAlgorithm("Cpu32PerturbedRCBLAV2HDR", Family.PERTURB_LAV2,
                        "hdr32", requires_reference=True, la_mode=LAMode.FULL,
                        runtime_decompression=True),
        RenderAlgorithm("Cpu64PerturbedRCBLAV2HDR", Family.PERTURB_LAV2,
                        "hdr64", requires_reference=True, la_mode=LAMode.FULL,
                        runtime_decompression=True),
    ]

    # --- accelerated direct (low zoom) -------------------------------------
    for name, dtype in [("Gpu1x32", "f32"), ("Gpu2x32", "2x32"),
                        ("Gpu4x32", "4x32"), ("Gpu1x64", "f64"),
                        ("Gpu2x64", "2x64"), ("Gpu4x64", "4x64"),
                        ("GpuHDRx32", "hdr32")]:
        algs.append(RenderAlgorithm(name, Family.DIRECT, dtype,
                                    requires_accelerator=True))

    # --- accelerated perturbation: scaled + BLA ----------------------------
    for name, dtype in [("Gpu1x32PerturbedScaled", "f32"),
                        ("Gpu2x32PerturbedScaled", "2x32"),
                        ("GpuHDRx32PerturbedScaled", "hdr32")]:
        algs.append(RenderAlgorithm(name, Family.PERTURB_SCALED, dtype,
                                    requires_accelerator=True,
                                    requires_reference=True))
    for name, dtype in [("Gpu1x64PerturbedBLA", "f64"),
                        ("GpuHDRx32PerturbedBLA", "hdr32"),
                        ("GpuHDRx64PerturbedBLA", "hdr64")]:
        algs.append(RenderAlgorithm(name, Family.PERTURB_BLA, dtype,
                                    requires_accelerator=True,
                                    requires_reference=True))

    # --- accelerated LAv2 (flagship) ----------------------------------------
    algs += _lav2_block("Gpu1x32", "f32", True)
    algs += _lav2_block("Gpu2x32", "2x32", True)
    algs += _lav2_block("Gpu1x64", "f64", True)
    algs += _lav2_block("GpuHDRx32", "hdr32", True)
    algs += _lav2_block("GpuHDRx2x32", "hdr2x32", True)
    algs += _lav2_block("GpuHDRx64", "hdr64", True)

    algs.append(RenderAlgorithm("AUTO", Family.AUTO))

    reg: dict[str, RenderAlgorithm] = {}
    for a in algs:
        reg[a.name] = a
        if a.name.startswith("Gpu"):
            reg["Tpu" + a.name[3:]] = a
    return reg


REGISTRY: dict[str, RenderAlgorithm] = _build_registry()


def get_algorithm(name: str) -> RenderAlgorithm:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown render algorithm {name!r}; known: "
            f"{', '.join(sorted(set(a.name for a in REGISTRY.values())))}")


def all_algorithms() -> list[RenderAlgorithm]:
    """Unique algorithms (canonical names), mirroring IterateRenderAlgs
    (RenderAlgorithm.h:1754-1776)."""
    seen = {}
    for a in REGISTRY.values():
        seen.setdefault(a.name, a)
    return list(seen.values())


def auto_select(zoom_exp2: int, has_accelerator: bool = True) -> RenderAlgorithm:
    """AUTO resolution: pick a family/dtype from the zoom depth.

    zoom_exp2 = |exp2(view radius)| (bits of zoom). Thresholds follow the
    dtype ranges: f64 direct to ~2^46, f64 perturbation to ~2^200 deltas,
    HDR beyond (reference picks similarly via RenderAlgorithms traits).
    """
    g = "Gpu" if has_accelerator else "Cpu"
    if zoom_exp2 < 20 and has_accelerator:
        return get_algorithm("Gpu1x32")
    if zoom_exp2 < 46:
        return get_algorithm("Gpu1x64" if has_accelerator else "Cpu64")
    if zoom_exp2 < 200:
        return get_algorithm("Gpu1x64PerturbedLAv2" if has_accelerator
                             else "Cpu64PerturbedBLAV2HDR")
    if has_accelerator:
        return get_algorithm("GpuHDRx32PerturbedLAv2")
    return get_algorithm(f"{g}32PerturbedBLAV2HDR")
