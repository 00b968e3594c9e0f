"""Roofline accounting: achieved FLOP/s and memory bandwidth vs device peaks.

`PEAKS` holds one row per device, keyed by the `device_kind` JAX reports,
with the dense (no sparsity) peak rate of each matmul precision and the
memory bandwidth, from the vendor's data sheet.  A precision maps to its
peak directly: "float32" is full f32 outside the tensor cores (what
`matmul_precision="highest"`, the solver default, asks for), "tf32" is
what `"default"` lets XLA use on the GPU.  A device that is not in the
table is an error, not a default: a roofline share against the wrong
peak is a wrong number.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    name: str
    tflops: Mapping[str, float]   # precision -> dense peak TFLOP/s
    hbm_gbps: float               # device-memory bandwidth, GB/s
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipPeaks(
        name="H100 SXM",
        tflops={"float32": 67.0, "tf32": 495.0, "bfloat16": 989.0, "float64": 67.0},
        hbm_gbps=3350.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense",
    ),
}


def peaks_for(device_kind: str) -> ChipPeaks:
    """The peak row of `device_kind` (`jax.Device.device_kind`)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak table row for device kind {device_kind!r}; known: {sorted(PEAKS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class RooflineRow:
    """One measured kernel/phase against the roofline."""

    phase: str
    flops: float             # executed FLOPs (analytic count)
    bytes_moved: float       # device-memory traffic (analytic count)
    wall_s: float
    peaks: ChipPeaks
    precision: str = "float32"

    @property
    def tflops_achieved(self) -> float:
        return self.flops / self.wall_s / 1e12 if self.wall_s else 0.0

    @property
    def gbps_achieved(self) -> float:
        return self.bytes_moved / self.wall_s / 1e9 if self.wall_s else 0.0

    @property
    def peak_tflops(self) -> float:
        return self.peaks.tflops[self.precision]

    @property
    def mfu(self) -> float:
        """Fraction of the matmul peak at this row's precision."""
        return self.tflops_achieved / self.peak_tflops

    @property
    def bw_util(self) -> float:
        return self.gbps_achieved / self.peaks.hbm_gbps

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_moved if self.bytes_moved else float("inf")

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte at which this device turns compute-bound."""
        return self.peak_tflops * 1e12 / (self.peaks.hbm_gbps * 1e9)

    @property
    def bound(self) -> str:
        return "compute" if self.arithmetic_intensity >= self.ridge_intensity else "bandwidth"

    @property
    def floor_s(self) -> float:
        """Least time the device could take: max(flops/peak, bytes/bandwidth)."""
        return max(self.flops / (self.peak_tflops * 1e12),
                   self.bytes_moved / (self.peaks.hbm_gbps * 1e9))

    @property
    def sol_frac(self) -> float:
        """Roofline share: `floor_s` / wall — 1.0 means the kernel runs at
        the hardware limit for its intensity."""
        return self.floor_s / self.wall_s if self.wall_s else 0.0

    def as_dict(self) -> dict:
        return {
            "phase": self.phase,
            "flops": self.flops,
            "bytes": self.bytes_moved,
            "wall_s": self.wall_s,
            "tflops": self.tflops_achieved,
            "gbps": self.gbps_achieved,
            "mfu": self.mfu,
            "bw_util": self.bw_util,
            "bound": self.bound,
            "sol_frac": self.sol_frac,
            "precision": self.precision,
            "chip": self.peaks.name,
        }
