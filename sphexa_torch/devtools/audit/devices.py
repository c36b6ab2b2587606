"""Device models of the static roofline cost layer (the JAX package's
devtools/audit/devices.py).

A ``DeviceModel`` is the small set of numbers a roofline needs: peak
operations a second by dtype, the memory rate and the link rate.
``costmodel.predict`` divides the per-phase FLOP and byte tallies by these
into a predicted per-phase ms table and classifies each phase against the
ridge point (peak FLOP/s / memory B/s: the arithmetic intensity above
which a phase is compute-bound).

These are MODELS, not measurements. Assumptions, in one place:

- ``h100``: the H100 SXM data sheet's peaks, the ones ``chip_smoke.py``
  and PERF.md's kernel table bound the kernels by: FP32 67 TFLOP/s
  outside the tensor cores, INT32 at half that (``default_peak``: ints
  and bools), BF16 989 TFLOP/s dense on the tensor cores, FP64 34 TFLOP/s,
  HBM3 at 3.35 TB/s. The link (the JAX model's ``ici_bytes_per_s``, kept
  under that name so that the JSON keys stay the JAX package's) is
  NVLink 4 modelled at 450 GB/s a direction (the data sheet's 900 GB/s
  a card, both directions); no collective of the one-card entries uses it.
  Its memory, JXA202's default budget a rank, is the data sheet's 80 GB
  (``memory_bytes``; ``torch.cuda.get_device_properties(0).total_memory``
  reads what the card reports, which chip_smoke.py prints beside it).
- ``cpu-smoke``: a deliberately round model of a CI host's CPU (a few
  GFLOP/s, tens of GB/s of DRAM), copied from the JAX package. It exists
  so that the calibration fixture (``python -m sphexa_torch.telemetry
  trace tests/torch_trace_fixture --predict``) has a device to predict
  against; its absolute numbers only shift every phase's ratio by a
  common factor, which the committed per-phase band absorbs.

Import-light by design (stdlib only)."""

import dataclasses
from typing import Dict, Tuple

__all__ = ["DeviceModel", "DEVICES", "get_device", "device_names"]


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Roofline parameters of one device class."""

    name: str
    description: str
    #: peak FLOP/s keyed by dtype name ("float32", "bfloat16", ...)
    peak_flops: Dict[str, float]
    #: FLOP/s charged for dtypes absent from ``peak_flops`` (ints, bools)
    default_peak: float
    #: HBM (or DRAM) bandwidth, bytes/s
    hbm_bytes_per_s: float
    #: aggregate link bandwidth between devices, bytes/s
    ici_bytes_per_s: float
    #: device memory, bytes (JXA202's default per-rank budget)
    memory_bytes: int = 0

    def peak_for(self, dtype_name: str) -> float:
        return self.peak_flops.get(dtype_name, self.default_peak)

    def ridge(self, dtype_name: str = "float32") -> float:
        """Arithmetic intensity (FLOPs/byte) at the compute/memory-bound
        boundary for ``dtype_name``."""
        return self.peak_for(dtype_name) / self.hbm_bytes_per_s


DEVICES: Dict[str, DeviceModel] = {
    "h100": DeviceModel(
        name="h100",
        description="NVIDIA H100 SXM (the port's card)",
        peak_flops={
            "bfloat16": 989e12,
            "float32": 67e12,
            "float64": 34e12,
        },
        default_peak=33.5e12,
        hbm_bytes_per_s=3.35e12,
        ici_bytes_per_s=450e9,
        memory_bytes=80 * 10**9,
    ),
    "cpu-smoke": DeviceModel(
        name="cpu-smoke",
        description="CI-host CPU (calibration fixture only)",
        peak_flops={
            "bfloat16": 4e9,
            "float32": 8e9,
            "float64": 4e9,
        },
        default_peak=8e9,
        hbm_bytes_per_s=20e9,
        ici_bytes_per_s=1e9,
        memory_bytes=16 << 30,
    ),
}


def device_names() -> Tuple[str, ...]:
    return tuple(sorted(DEVICES))


def get_device(name: str) -> DeviceModel:
    try:
        return DEVICES[name]
    except KeyError:
        raise ValueError(
            f"unknown device model {name!r} (known: {', '.join(device_names())})"
        ) from None
