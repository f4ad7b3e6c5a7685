"""Device-health preflight (port of ``pint_tpu/runtime/preflight.py``):
which device really runs the computations, and is its float64 arithmetic
IEEE double?

Two probes run in torch on the device, each operation its own launch, so
nothing contracts or reassociates them:

* the **two_sum error word** of ``1 + (2^-53 + 2^-78)``: native float64
  recovers the exact rounding error, an emulated or excess-precision one
  does not;
* the **effective mantissa bits**: the largest ``k`` in 20..79 with
  ``(1 + 2^-k) - 1 > 0`` on the device (the powers of two are made exactly
  on the host).

The :class:`DeviceProfile` rides on every fitter (``Fitter.device_profile``)
and grid run; :func:`check_device` holds it against a requested platform
(``PINT_TORCH_REQUIRE_PLATFORM`` or an argument) under the
``strict``/``warn``/``allow`` policy of :mod:`pint_torch.config`.  A CUDA
device's platform is ``"gpu"``.
"""

from __future__ import annotations

import math
import os
from dataclasses import asdict, dataclass
from typing import Optional

import torch

from pint_torch import F64, config, resolve_device
from pint_torch.exceptions import DeviceMismatchError
from pint_torch.logging import log

__all__ = ["DeviceProfile", "DeviceHealth", "device_profile",
           "device_health", "healthy_devices", "check_device",
           "platform_matches", "GPU_PLATFORMS"]

#: platform names of a CUDA device
GPU_PLATFORMS = ("gpu", "cuda")

#: fl(1 + b) rounds b = 2^-53 + 2^-78 up to 2^-52, so the exact two_sum
#: error word is b - 2^-52
_PROBE_B = 2.0 ** -53 + 2.0 ** -78
_PROBE_ERR_EXPECTED = _PROBE_B - 2.0 ** -52

#: a healthy device recovers the error word to at worst ~2^-53
_HEALTH_DEFECT_BAR = 2.0 ** -50


@dataclass(frozen=True)
class DeviceProfile:
    """The measured float64 profile of one device."""

    platform: str          #: "gpu" (a CUDA device) or "cpu"
    device_kind: str       #: the device's name (e.g. "NVIDIA H100 80GB HBM3")
    num_devices: int       #: devices of that platform visible
    f64_native: bool       #: the two_sum error word recovered exactly
    mantissa_bits: int     #: effective float64 mantissa bits on the device
    two_sum_error: float   #: |recovered - expected| of the error word
    torch_version: str

    @property
    def degraded_precision(self) -> bool:
        """Float64 below IEEE double on this device."""
        return not self.f64_native or self.mantissa_bits < 52

    @property
    def precision(self) -> str:
        return ("native-f64" if not self.degraded_precision
                else f"emulated-f64(~{self.mantissa_bits}bit)")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["precision"] = self.precision
        return d


@dataclass(frozen=True)
class DeviceHealth:
    """One device's verdict from the two_sum probe."""

    device_id: int
    platform: str
    healthy: bool
    two_sum_error: float
    error: Optional[str] = None

    def to_dict(self) -> dict:
        return asdict(self)


_profiles: dict = {}
_device_health: Optional[tuple] = None
_warned_mismatch: set = set()


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else dev.type


def _two_sum_error(dev: torch.device) -> float:
    """The two_sum error word of 1 + _PROBE_B computed on ``dev``, one
    launch an operation."""
    a = torch.ones((), dtype=F64, device=dev)
    b = torch.full((), _PROBE_B, dtype=F64, device=dev)
    s = a + b
    bb = s - a
    return float((a - (s - bb)) + (b - bb))


def _probe(dev: torch.device) -> DeviceProfile:
    err = _two_sum_error(dev)
    defect = abs(err - _PROBE_ERR_EXPECTED)
    ks = list(range(20, 80))
    pows = torch.tensor([2.0 ** -k for k in ks], dtype=F64, device=dev)
    one = torch.ones((), dtype=F64, device=dev)
    alive = ((one + pows) - one > 0).cpu().tolist()
    bits = max((k for k, a in zip(ks, alive) if a), default=0)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        kind, n = torch.cuda.get_device_name(idx), torch.cuda.device_count()
    else:
        kind, n = dev.type, 1
    return DeviceProfile(platform=_platform(dev), device_kind=str(kind),
                         num_devices=int(n), f64_native=defect < 2.0 ** -70,
                         mantissa_bits=int(bits), two_sum_error=float(defect),
                         torch_version=str(torch.__version__))


def device_profile(refresh: bool = False, device=None) -> DeviceProfile:
    """The :class:`DeviceProfile` of ``device`` (default ``"cuda"``),
    probed once a process and device (``refresh`` probes again)."""
    dev = resolve_device(device)
    key = str(dev)
    if key not in _profiles or refresh:
        prof = _profiles[key] = _probe(dev)
        if prof.degraded_precision:
            log.warning(
                f"Device preflight: {prof.platform} f64 is "
                f"{prof.precision} (two_sum defect "
                f"{prof.two_sum_error:.2e})")
    return _profiles[key]


def _probe_one(dev: torch.device, index: int) -> DeviceHealth:
    try:
        err = _two_sum_error(dev)
        defect = abs(err - _PROBE_ERR_EXPECTED)
        return DeviceHealth(device_id=index, platform=_platform(dev),
                            healthy=bool(math.isfinite(err)
                                         and defect < _HEALTH_DEFECT_BAR),
                            two_sum_error=float(defect))
    except Exception as e:  # a probe that cannot run is the verdict
        return DeviceHealth(device_id=index, platform=_platform(dev),
                            healthy=False, two_sum_error=float("inf"),
                            error=f"{type(e).__name__}: {e}")


def _visible() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_health(refresh: bool = False) -> tuple:
    """:class:`DeviceHealth` of every visible device (the CUDA devices,
    else the CPU), probed once a process (``refresh`` probes again)."""
    global _device_health
    if _device_health is None or refresh:
        _device_health = tuple(_probe_one(d, i)
                               for i, d in enumerate(_visible()))
        sick = [h for h in _device_health if not h.healthy]
        if sick:
            log.warning(
                f"Device preflight: {len(sick)}/{len(_device_health)} "
                f"device(s) failed the per-device two_sum probe (ids "
                f"{[h.device_id for h in sick]})")
    return _device_health


def healthy_devices(refresh: bool = False) -> list:
    """The visible devices that passed the probe, in order."""
    ok = {h.device_id for h in device_health(refresh=refresh) if h.healthy}
    return [d for i, d in enumerate(_visible()) if i in ok]


def platform_matches(actual: str, requested: str) -> bool:
    """Platform equality, ``gpu`` and ``cuda`` naming one platform."""
    if actual == requested:
        return True
    return actual in GPU_PLATFORMS and requested in GPU_PLATFORMS


def check_device(requested: Optional[str] = None,
                 policy: Optional[str] = None, device=None) -> DeviceProfile:
    """The profile of ``device`` (default ``"cuda"``), held against
    ``requested`` (default ``PINT_TORCH_REQUIRE_PLATFORM``; unset: no
    requirement).  On a mismatch the policy (default
    :func:`pint_torch.config.device_policy`) decides: ``strict`` raises
    :class:`DeviceMismatchError`, ``warn`` logs once per (actual,
    requested) pair, ``allow`` is silent."""
    prof = device_profile(device=device)
    if requested is None:
        requested = os.environ.get("PINT_TORCH_REQUIRE_PLATFORM") or None
    if requested is None or platform_matches(prof.platform, requested):
        return prof
    policy = policy or config.device_policy()
    msg = (f"Device preflight: computations execute on "
           f"{prof.platform!r} ({prof.precision}) but {requested!r} was "
           "required; a silent fallback would produce numbers from the "
           "wrong device")
    if policy == "strict":
        raise DeviceMismatchError(msg)
    if policy == "warn" and (prof.platform, requested) not in _warned_mismatch:
        _warned_mismatch.add((prof.platform, requested))
        log.warning(msg)
    return prof
