"""Per-call byte accounting, roofline shares, device peaks, and a
profiler trace wrapper.

The reference has no built-in tracing; measurement is external
(BenchmarkTools in ``src/costs.jl:87-94``, ``bin/test_table.jl:40``).
Here: count the bytes one TrSpMV over a device format must move, divide
by the device's published memory rate for the least time it could take,
and compare with a measured time; plus a thin wrapper over
``jax.profiler`` for trace capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess

__all__ = ["PEAKS", "peak", "hbm_bandwidth", "stream_bytes", "roofline",
           "trace", "device_fields", "gpu_name_power_limit"]


@dataclasses.dataclass(frozen=True)
class Peak:
    hbm_bytes_per_s: float
    hbm_bytes: float
    source: str


# Keyed by ``jax.Device.device_kind``.  A device missing here is an
# error, never a default: a roofline share against a guessed peak is
# not a measurement.
PEAKS = {
    "NVIDIA H200": Peak(
        hbm_bytes_per_s=4.8e12,
        hbm_bytes=141e9,
        source="NVIDIA H200 Tensor Core GPU data sheet (SXM)",
    ),
}


def peak(device=None) -> Peak:
    """Published peaks of ``device`` (default: the first JAX device)."""
    if device is None:
        import jax

        device = jax.devices()[0]
    kind = getattr(device, "device_kind", None)
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add a row to "
            f"vbcs_tpu.utils.profile.PEAKS (known: {sorted(PEAKS)})")
    return PEAKS[kind]


def device_fields() -> dict:
    """The device every result names: platform, kind and count as JAX
    reports them."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_power_limit() -> str:
    """Each card's name and power limit as ``nvidia-smi`` reports them
    (one card per line).  A card set below its maximum power runs
    slower under load, so every time this program reports sits beside
    this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def hbm_bandwidth(device=None) -> float:
    """Published device-memory bytes/s of ``device``."""
    return peak(device).hbm_bytes_per_s


def stream_bytes(fmt) -> int:
    """Bytes one TrSpMV over a device format (``VBC1DDevice`` or
    ``VBC2DDevice``) must move at least: every class's values and index
    arrays (row or rowstart, seg, ycol), read once, plus x read and y
    written once."""
    itemsize = fmt.classes[0].val.dtype.itemsize if fmt.classes else 4
    return int(fmt.nbytes + itemsize * (fmt.m + fmt.n))


@dataclasses.dataclass(frozen=True)
class Roofline:
    bytes_moved: int
    bandwidth: float
    ideal_s: float
    measured_s: float | None
    fraction: float | None  # ideal / measured

    def __str__(self):
        s = (
            f"{self.bytes_moved/1e6:.2f} MB @ {self.bandwidth/1e9:.0f} GB/s "
            f"-> ideal {self.ideal_s*1e6:.1f} us"
        )
        if self.measured_s is not None:
            s += (
                f"; measured {self.measured_s*1e6:.1f} us "
                f"({100*self.fraction:.0f}% of roofline)"
            )
        return s


def roofline(fmt, measured_s: float | None = None, device=None) -> Roofline:
    """Roofline report for a device format (optionally vs a measurement)."""
    b = stream_bytes(fmt)
    bw = hbm_bandwidth(device)
    ideal = b / bw
    frac = (ideal / measured_s) if measured_s else None
    return Roofline(
        bytes_moved=b,
        bandwidth=bw,
        ideal_s=ideal,
        measured_s=measured_s,
        fraction=frac,
    )


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``jax.profiler`` trace (view with TensorBoard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
