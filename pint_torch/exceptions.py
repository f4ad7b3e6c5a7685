"""The port's exception taxonomy: the reference's classes, names and bases
(``pint_tpu/exceptions.py``), every one under :class:`PintError`.

The modules that raise them import them from here and keep their old
names as re-exports (``pint_torch.fitter.StepProblem`` is
``pint_torch.exceptions.StepProblem``).  The port's own
``NoGPUError``, ``KernelBuildError`` and ``KernelLaunchError`` have no
counterpart in the reference: they derive from ``RuntimeError`` and live
beside the code that raises them."""

from __future__ import annotations

__all__ = [
    "PintError",
    "ModelError",
    "TimingModelError",
    "MissingParameter",
    "MissingComponent",
    "MissingTOAs",
    "UnknownParameter",
    "UnknownBinaryModel",
    "ComponentConflict",
    "MissingBinaryError",
    "PINTPrecisionError",
    "PropertyAttributeError",
    "PrefixError",
    "InvalidModelParameters",
    "AliasConflict",
    "EphemCoverageError",
    "ConvergenceFailure",
    "MaxiterReached",
    "StepProblem",
    "SingularMatrixError",
    "NonFiniteSystemError",
    "DeviceError",
    "DeviceMismatchError",
    "DeviceLostError",
    "CanaryMismatchError",
    "MeshExhaustedError",
    "CollectiveContractError",
    "CheckpointError",
    "SweepChunkFailure",
    "CorrelatedErrors",
    "DegeneracyWarning",
    "ClockCorrectionError",
    "ClockCorrectionOutOfRange",
    "NoClockCorrections",
    "PintFileError",
    "FileSyntaxError",
    "ParSyntaxError",
    "TimSyntaxError",
    "PintPickleError",
    "InvalidTOAError",
    "TOAIntegrityError",
    "UsageError",
    "PrecisionError",
]


class PintError(Exception):
    """Base class of every exception of the timing package."""


class ModelError(PintError):
    """Generic problem with a timing model."""


class TimingModelError(ModelError):
    """Invalid timing-model structure or configuration."""


class MissingParameter(ModelError):
    """A parameter required by a component is absent or unset."""

    def __init__(self, module: str = "", param: str = "", msg: str | None = None):
        self.module, self.param = module, param
        super().__init__(msg or f"{module} requires parameter {param}")


class MissingComponent(ModelError):
    """A required component is not present in the model."""


class MissingTOAs(ModelError):
    """Some mask parameter selects no TOAs."""

    def __init__(self, parameter_names=()):
        if isinstance(parameter_names, str):
            parameter_names = [parameter_names]
        self.parameter_names = list(parameter_names)
        super().__init__(f"Parameters {self.parameter_names} select no TOAs")


class UnknownParameter(ModelError):
    """A par-file key cannot be mapped to any known parameter."""


class UnknownBinaryModel(ModelError):
    """The BINARY line names a model this framework does not provide."""

    def __init__(self, message, suggestion=None):
        super().__init__(message + (f" Perhaps use {suggestion}?" if suggestion else ""))
        self.suggestion = suggestion


class ComponentConflict(ModelError, ValueError):
    """Multiple components could be selected with no way to choose
    (reference ``exceptions.py:157``)."""


class MissingBinaryError(TimingModelError):
    """BINARY parameter missing where a binary model is required
    (reference ``exceptions.py:136``)."""


class PINTPrecisionError(PintError, RuntimeError):
    """Platform/numerics cannot deliver the required time precision
    (reference ``exceptions.py:143``)."""


class PropertyAttributeError(PintError, ValueError):
    """A property raised AttributeError internally (reference
    ``exceptions.py:73``; raised by ``timing_model.property_exists``)."""


class PrefixError(ModelError):
    """Malformed prefix parameter name (e.g. F0003x)."""


class InvalidModelParameters(ModelError):
    """Parameter values are outside their physically meaningful domain."""


class AliasConflict(ModelError):
    """Two components claim the same parameter alias."""


class EphemCoverageError(PintError, ValueError):
    """Requested epochs fall outside the loaded ephemeris kernel."""


class ConvergenceFailure(PintError):
    """An iterative fitter failed to converge."""


class MaxiterReached(ConvergenceFailure):
    """Fitter hit the iteration limit before meeting tolerance."""


class StepProblem(ConvergenceFailure):
    """A fitter step failed to decrease chi2 even after lambda-halving."""


class SingularMatrixError(ConvergenceFailure):
    """Every rung of the hardened solve ladder (Cholesky, escalating
    diagonal loading) failed on a normal-equation system."""


class NonFiniteSystemError(ConvergenceFailure):
    """Residuals or normal equations contain NaN/inf — the solve would
    silently propagate garbage, so it refuses instead."""


class DeviceError(PintError):
    """Problem with the accelerator device executing the computation."""


class DeviceMismatchError(DeviceError):
    """The platform actually executing the computation differs from the
    one requested (e.g. a silent CPU fallback when a GPU was required)."""


class DeviceLostError(DeviceError):
    """A device disappeared or failed mid-computation.

    ``device_id`` (when known) names the lost device so the elastic
    supervisor can evict it from the mesh instead of degrading blindly.
    """

    def __init__(self, msg: str = "device lost", device_id: int | None = None):
        self.device_id = device_id
        super().__init__(msg)


class CanaryMismatchError(DeviceError):
    """The cross-replica canary (one replicated grid point evaluated on
    every shard) disagreed across devices — silent shard corruption.
    ``device_ids`` lists the devices whose canary value diverged from
    the ensemble (NaN or off-median)."""

    def __init__(self, msg: str, device_ids=()):
        self.device_ids = list(device_ids)
        super().__init__(msg)


class MeshExhaustedError(DeviceError):
    """The elastic degradation ladder ran out of rungs: no healthy
    device subset remains that can execute the plan."""


class CollectiveContractError(DeviceError):
    """A program's cross-device collectives violate the execution plan's
    contract (e.g. a scattered Gram build done as a full-tensor all-reduce
    instead of a reduce-scatter).  ``violations`` lists the broken
    clauses."""

    def __init__(self, msg: str, violations=()):
        self.violations = list(violations)
        super().__init__(msg)


class CheckpointError(PintError):
    """A sweep checkpoint is unusable: fingerprint mismatch, corrupt
    chunk file, or incompatible layout."""


class SweepChunkFailure(PintError):
    """A sweep chunk kept failing after every retry/backoff attempt."""


class CorrelatedErrors(PintError):
    """A fitter that assumes uncorrelated errors was given correlated noise."""

    def __init__(self, model):
        trouble = [c.__class__.__name__ for c in getattr(model, "noise_components", [])
                   if getattr(c, "introduces_correlated_errors", False)]
        super().__init__(
            f"Model has correlated errors ({trouble}); use a GLS-family fitter"
        )


class DegeneracyWarning(UserWarning):
    """The design matrix has (near-)degenerate directions."""


class ClockCorrectionError(PintError):
    """Problem applying observatory clock corrections."""


class ClockCorrectionOutOfRange(ClockCorrectionError):
    """TOAs fall outside the span of the available clock files."""


class NoClockCorrections(ClockCorrectionError):
    """No clock file is available for an observatory."""


class PintFileError(PintError):
    """Malformed par/tim/clock/ephemeris file."""


class FileSyntaxError(PintFileError, ValueError):
    """A parse failure pinned to a file location.

    Carries ``file``/``line``/``column`` (1-based, None when unknown) and
    the offending ``token``, so ingestion errors are actionable instead of
    bare messages.  Subclasses ``ValueError`` because these sites
    historically raised ``ValueError``/``PintFileError`` and callers may
    catch either.
    """

    def __init__(self, msg: str, file: str | None = None,
                 line: int | None = None, column: int | None = None,
                 token: str | None = None):
        self.file, self.line, self.column, self.token = file, line, column, token
        where = ""
        if file is not None:
            where = f"{file}:"
        if line is not None:
            where += f"{line}:"
        if column is not None:
            where += f"{column}:"
        if token is not None and token not in msg:
            msg = f"{msg} (offending token {token!r})"
        super().__init__(f"{where} {msg}" if where else msg)


class ParSyntaxError(FileSyntaxError):
    """Malformed par-file content (bad key, unparseable value/exponent)."""


class TimSyntaxError(FileSyntaxError):
    """Malformed tim-file content (bad TOA line, flag, or directive)."""


class PintPickleError(PintFileError, IOError):
    """No readable TOA pickle could be found/loaded."""


class InvalidTOAError(PintError, ValueError):
    """Invalid TOA construction or flag value (programmatic input, not a
    file-parse problem)."""


class TOAIntegrityError(PintError, ValueError):
    """``TOAs.validate()`` found quarantine-class rows under the strict
    ingestion policy.  The validation's report rides on ``.report``."""

    def __init__(self, msg: str, report=None):
        self.report = report
        super().__init__(msg)


class UsageError(PintError, ValueError):
    """Invalid argument or argument combination passed to a public API."""


class PrecisionError(PintError):
    """An operation would silently lose required time precision."""
