"""Process settings of pint_torch (port of ``pint_tpu/config.py``): the
data directory, the ingestion policy, the GLS grid chunk override and the
tuning-manifest directory, each read from a ``PINT_TORCH_*`` environment
variable and settable for the process.

The device-mismatch policy is read by the preflight device probe
(:mod:`pint_torch.runtime.preflight`).  Telemetry and the AOT-cache
directory are what ROADMAP queue A item 8 ports: the telemetry mode is
``"off"``, and asking for another mode or setting the AOT-cache directory
raises ``NotImplementedError``.
"""

from __future__ import annotations

import os

__all__ = ["datadir",
           "device_policy", "set_device_policy", "DEVICE_POLICIES",
           "ingestion_policy", "set_ingestion_policy", "INGESTION_POLICIES",
           "telemetry_mode", "set_telemetry_mode", "TELEMETRY_MODES",
           "aot_cache_dir", "set_aot_cache_dir",
           "grid_chunk", "set_grid_chunk",
           "tune_dir", "set_tune_dir"]

_ITEM8 = ("is ROADMAP queue A item 8 (telemetry and the AOT cache), not "
          "ported yet")

#: the device-mismatch policies (``PINT_TORCH_DEVICE_POLICY``) that
#: :func:`pint_torch.runtime.preflight.check_device` applies: ``strict``
#: raises, ``warn`` logs once, ``allow`` is silent
DEVICE_POLICIES = ("strict", "warn", "allow")

_device_policy = os.environ.get("PINT_TORCH_DEVICE_POLICY", "warn")
if _device_policy not in DEVICE_POLICIES:
    _device_policy = "warn"


def device_policy() -> str:
    """Current device-mismatch policy: strict | warn | allow."""
    return _device_policy


def set_device_policy(policy: str) -> None:
    """Set the device-mismatch policy for this process."""
    global _device_policy
    if policy not in DEVICE_POLICIES:
        raise ValueError(
            f"device policy must be one of {DEVICE_POLICIES}, got {policy!r}")
    _device_policy = policy


#: what TOA validation does with suspect rows
#: (``PINT_TORCH_INGESTION_POLICY``): ``strict`` raises
#: :class:`~pint_torch.exceptions.TOAIntegrityError` on the first problem,
#: ``lenient`` quarantines the offenders with a warning, ``collect``
#: quarantines them silently
INGESTION_POLICIES = ("strict", "lenient", "collect")

_ingestion_policy = os.environ.get("PINT_TORCH_INGESTION_POLICY", "strict")
if _ingestion_policy not in INGESTION_POLICIES:
    _ingestion_policy = "strict"


def ingestion_policy() -> str:
    """Current ingestion policy: strict | lenient | collect."""
    return _ingestion_policy


def set_ingestion_policy(policy: str) -> None:
    """Set the ingestion policy for this process."""
    global _ingestion_policy
    if policy not in INGESTION_POLICIES:
        raise ValueError(
            f"ingestion policy must be one of {INGESTION_POLICIES}, "
            f"got {policy!r}")
    _ingestion_policy = policy


#: the reference's telemetry modes; the port collects none
#: (``PINT_TORCH_TELEMETRY``: ``off``, or ``basic``/``full``, which raise)
TELEMETRY_MODES = ("off", "basic", "full")


def telemetry_mode() -> str:
    """Current telemetry mode: always ``"off"``.  ``PINT_TORCH_TELEMETRY``
    set to ``basic`` or ``full`` raises ``NotImplementedError``; any other
    value means ``off``, as in the reference."""
    env = os.environ.get("PINT_TORCH_TELEMETRY", "off")
    if env in TELEMETRY_MODES and env != "off":
        raise NotImplementedError(f"PINT_TORCH_TELEMETRY={env!r}: telemetry "
                                  + _ITEM8)
    return "off"


def set_telemetry_mode(mode: str) -> None:
    """Accepts ``"off"``; the other modes raise ``NotImplementedError``."""
    if mode not in TELEMETRY_MODES:
        raise ValueError(
            f"telemetry mode must be one of {TELEMETRY_MODES}, got {mode!r}")
    if mode != "off":
        raise NotImplementedError(f"telemetry mode {mode!r} " + _ITEM8)


def aot_cache_dir():
    """``None``: the port persists no compiled artifacts.
    ``PINT_TORCH_AOT_CACHE_DIR`` set raises ``NotImplementedError``."""
    if os.environ.get("PINT_TORCH_AOT_CACHE_DIR"):
        raise NotImplementedError("PINT_TORCH_AOT_CACHE_DIR: the AOT cache "
                                  + _ITEM8)
    return None


def set_aot_cache_dir(path) -> None:
    """``None`` or empty keeps persistence off; a directory raises
    ``NotImplementedError``."""
    if path:
        raise NotImplementedError("set_aot_cache_dir: the AOT cache "
                                  + _ITEM8)


#: process-wide override of the GLS grid chunk size
#: (``PINT_TORCH_GRID_CHUNK`` / :func:`set_grid_chunk`).  ``None`` lets
#: :func:`pint_torch.grid.default_gls_chunk` pick the device's static
#: default.  The environment value is validated at the first
#: :func:`grid_chunk` read, so a bad value never breaks the import.
_grid_chunk = None
_grid_chunk_env_checked = False


def _coerce_chunk(value, source: str) -> int:
    """The chunk is a batch size: a positive integer of any integral type
    (``operator.index``) or a base-10 string; anything else raises a
    typed :class:`~pint_torch.exceptions.UsageError`."""
    import operator

    from pint_torch.exceptions import UsageError

    if isinstance(value, bool):
        raise UsageError(
            f"grid chunk from {source} must be a positive integer, "
            f"got {value!r}")
    try:
        chunk = int(value, 10) if isinstance(value, str) \
            else operator.index(value)
    except (TypeError, ValueError):
        raise UsageError(
            f"grid chunk from {source} must be a positive integer, "
            f"got {value!r}") from None
    if chunk <= 0:
        raise UsageError(
            f"grid chunk from {source} must be positive, got {chunk}")
    return chunk


def grid_chunk():
    """The configured GLS grid chunk override, or ``None`` when unset.
    A malformed ``PINT_TORCH_GRID_CHUNK`` raises
    :class:`~pint_torch.exceptions.UsageError` here."""
    global _grid_chunk, _grid_chunk_env_checked
    if _grid_chunk is None and not _grid_chunk_env_checked:
        _grid_chunk_env_checked = True
        env = os.environ.get("PINT_TORCH_GRID_CHUNK")
        if env:
            _grid_chunk = _coerce_chunk(env, "PINT_TORCH_GRID_CHUNK")
    return _grid_chunk


def set_grid_chunk(chunk) -> None:
    """Set (or, with ``None``, clear) the process-wide GLS grid chunk
    override; an explicit choice wins over the environment."""
    global _grid_chunk, _grid_chunk_env_checked
    _grid_chunk_env_checked = True
    if chunk is None:
        _grid_chunk = None
        return
    _grid_chunk = _coerce_chunk(chunk, "set_grid_chunk")


#: where the tuning manifest persists decisions across processes
#: (``PINT_TORCH_TUNE_DIR`` / :func:`set_tune_dir`), keyed by workload vkey
#: and device fingerprint (:mod:`pint_torch.autotune`); ``None`` (the
#: default) turns persistence off and the tunable call sites take their
#: static defaults
_tune_dir = os.environ.get("PINT_TORCH_TUNE_DIR") or None


def tune_dir():
    """Tuning-manifest directory, or ``None`` when persistence is off.  The
    environment value is not validated at import;
    :class:`pint_torch.autotune.manifest.TuningManifest` raises the typed
    error at first use."""
    return _tune_dir


def set_tune_dir(path) -> None:
    """Set (or, with ``None``/empty, turn off) the tuning-manifest
    directory for this process.  It is created if absent; an uncreatable or
    unwritable target raises :class:`~pint_torch.exceptions.UsageError` at
    once, through the validation
    :class:`~pint_torch.autotune.manifest.TuningManifest` itself does."""
    global _tune_dir
    if not path:
        _tune_dir = None
        return
    path = os.path.abspath(str(path))
    from pint_torch.autotune.manifest import TuningManifest

    TuningManifest(path)
    _tune_dir = path


def datadir() -> str:
    """Directory holding the package's data files."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
