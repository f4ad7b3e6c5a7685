"""The resolve half of the autotuner (port of ``pint_tpu/autotune/
__init__.py:96-353``), with its records (:mod:`~pint_torch.autotune.
records`) and the tuning manifest (:mod:`~pint_torch.autotune.manifest`).

The consumers -- ``grid_chisq(chunk="auto")``, the GLS fitter's solve
ladder, the catalogue's bucket ladders, the streaming engine's block
ladder, the grid's correction dtype and the precision segments -- ask
:func:`resolve` for their tuned value and get the static default on any
manifest or fingerprint miss.  Where the reference emits the telemetry
events ``tune_applied`` and ``tune_fallback``, the port writes a
:mod:`pint_torch.logging` record (telemetry is ROADMAP queue A item 8).

Not ported here: the searches that write decisions (the reference's
``autotune/search.py``: ROADMAP queue A item 8; they raise
``NotImplementedError`` naming it) and the execution-plan resolves
(``resolve_plan_axes``, ``resolve_plan_strategy``: item 9, they raise).
The precision probes, which do write decisions, are
:func:`pint_torch.precision.tune.tune_precision_segments`.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from pint_torch import config
from pint_torch.autotune.manifest import (TuningDecision, TuningManifest,
                                          decision_key, manifest,
                                          reset_manifest_singleton)
from pint_torch.autotune.records import (AUTOTUNE_SCHEMA,
                                         TUNE_MANIFEST_SCHEMA,
                                         decision_record, sweep_record)
from pint_torch.logging import log

__all__ = ["AUTOTUNE_SCHEMA", "TUNE_MANIFEST_SCHEMA", "Candidate",
           "TuningDecision", "TuningManifest", "manifest",
           "reset_manifest_singleton", "sweep_record", "decision_record",
           "chunk_ladder", "rank_grid_chunks", "confirm_measured",
           "measured_from_sweep", "tune_grid_chunk", "tune_solve_rung",
           "tune_plan_axes", "tune_plan_strategy", "tune_bucket_ladders",
           "tune_catalog_ladders", "tune_precision",
           "autotune_workload", "resolve", "resolve_grid_chunk",
           "resolve_solve_ladder", "resolve_plan_axes",
           "resolve_plan_strategy", "resolve_serve_buckets",
           "resolve_catalog_ladders", "resolve_correction_dtype",
           "resolve_update_blocks", "tune_update_blocks",
           "grid_chunk_vkey", "solve_rung_vkey", "plan_axes_vkey",
           "plan_strategy_vkey", "serve_buckets_vkey",
           "catalog_buckets_vkey", "correction_dtype_vkey",
           "update_blocks_vkey"]


def _item8(name: str):
    def search(*args, **kwargs):
        raise NotImplementedError(
            f"autotune.{name}: the searches that write tuning decisions "
            "are ROADMAP queue A item 8, not ported yet")

    search.__name__ = search.__qualname__ = name
    search.__doc__ = (f"The reference's ``autotune.{name}`` (ROADMAP queue "
                      "A item 8): raises ``NotImplementedError``.")
    return search


(Candidate, chunk_ladder, rank_grid_chunks, confirm_measured,
 measured_from_sweep, tune_grid_chunk, tune_solve_rung, tune_plan_axes,
 tune_plan_strategy, tune_bucket_ladders, tune_catalog_ladders,
 tune_precision, tune_update_blocks, autotune_workload) = (
    _item8(n) for n in (
        "Candidate", "chunk_ladder", "rank_grid_chunks", "confirm_measured",
        "measured_from_sweep", "tune_grid_chunk", "tune_solve_rung",
        "tune_plan_axes", "tune_plan_strategy", "tune_bucket_ladders",
        "tune_catalog_ladders", "tune_precision", "tune_update_blocks",
        "autotune_workload"))


def _emit_event(name: str, **attrs) -> None:
    """The reference's tuning-lifecycle telemetry event, as a log record."""
    log.debug(f"{name}: " + " ".join(f"{k}={v}" for k, v in attrs.items()))


def _ntoas(toas) -> int:
    return int(toas.ntoas)


# ---------------------------------------------------------------------------
# workload version keys (process-stable; repr'd into the manifest key)
# ---------------------------------------------------------------------------

def grid_chunk_vkey(model, toas) -> tuple:
    """The chunk optimum is a property of the executable's shape (TOA
    count, free-parameter count, noise structure), not of parameter
    values."""
    gls = bool(model.noise_basis_by_component(toas)[0])
    return ("grid.chunk", _ntoas(toas), len(model.free_params), int(gls))


def solve_rung_vkey(ftr) -> tuple:
    """The entry rung depends on the actual Gram: the key carries the full
    parameter/mask signature, so any parameter edit falls back to the full
    ladder."""
    from pint_torch.grid import _model_param_sig

    return ("gls.solve_rung", _model_param_sig(ftr.model),
            getattr(ftr.batch, "_version", 0), _ntoas(ftr.batch))


def plan_axes_vkey(workload: str) -> tuple:
    return ("plan.axes", str(workload))


def plan_strategy_vkey(workload: str) -> tuple:
    return ("plan.strategy", str(workload))


def serve_buckets_vkey() -> tuple:
    #: the serve kernel's schema version
    return ("serve.buckets", 1)


def catalog_buckets_vkey(shapes) -> tuple:
    """One catalogue's sorted multiset of ``(n_toas, n_free)`` shapes."""
    return ("catalog.buckets",
            tuple(sorted((int(n), int(k)) for n, k in shapes)))


def update_blocks_vkey() -> tuple:
    #: the stream kernels' schema version
    return ("update.blocks", 1)


def correction_dtype_vkey(model, toas) -> tuple:
    """The precision margin depends on the actual noise Gram and residual
    scale: the full signature, as the solve rung's."""
    from pint_torch.grid import _model_param_sig

    return ("grid.correction_dtype", _model_param_sig(model),
            getattr(toas, "_version", 0), _ntoas(toas))


# ---------------------------------------------------------------------------
# the resolve layer
# ---------------------------------------------------------------------------

def resolve(name: str, vkey: Any, default: Any,
            requested: bool = True) -> Tuple[Any, str]:
    """(value, source) of one tunable: the manifest's verified tuned value
    (source ``"tuned"``, a ``tune_applied`` record) or the static
    ``default`` (source ``"static"``).  ``requested=True`` (the caller asked
    for tuning, as ``chunk="auto"`` does) logs a reasoned
    ``tune_fallback`` on every degrade path, "no manifest configured"
    included; ``requested=False`` stays silent when tuning is off."""
    m = None
    if config.tune_dir() is not None:
        try:
            m = manifest()
        except Exception as e:  # noqa: BLE001 -- a degrade, never a failure
            _emit_event("tune_fallback", decision=str(name),
                        reason=f"manifest unusable: "
                               f"{type(e).__name__}: {e}",
                        static=repr(default))
            return default, "static"
    if m is None:
        if requested:
            _emit_event("tune_fallback", decision=str(name),
                        reason="no tuning manifest configured "
                               "(PINT_TORCH_TUNE_DIR / set_tune_dir)",
                        static=repr(default))
        return default, "static"
    try:
        body, reason = m.lookup(name, vkey)
        if body is None:
            _emit_event("tune_fallback", decision=str(name),
                        reason=str(reason), static=repr(default))
            return default, "static"
        _, digest = decision_key(name, vkey, m.fingerprint())
    except Exception as e:  # noqa: BLE001 -- resolution sits on the fit path
        _emit_event("tune_fallback", decision=str(name),
                    reason=f"lookup failed: {type(e).__name__}: {e}",
                    static=repr(default))
        return default, "static"
    _emit_event("tune_applied", decision=str(name),
                value=repr(body["value"]), key=digest[:12],
                basis=str(body.get("basis", "?")))
    return body["value"], "tuned"


def resolve_grid_chunk(model, toas) -> int:
    """The tuned GLS grid chunk of this workload's shape, or the static
    default of the batch's device (``grid_chisq(chunk="auto")``)."""
    from pint_torch.exceptions import UsageError
    from pint_torch.grid import default_gls_chunk

    value, source = resolve("grid.chunk", grid_chunk_vkey(model, toas),
                            default_gls_chunk(toas.device), requested=True)
    if source == "tuned" and (not isinstance(value, int)
                              or isinstance(value, bool) or value <= 0):
        raise UsageError(
            f"tuned grid chunk is {value!r}, not a positive integer -- "
            "the manifest entry is corrupt (re-run the autotuner)")
    return int(value)


def resolve_solve_ladder(ftr):
    """The tuned jitter-ladder slice of this fitter's GLS solve, or
    ``None`` (the full ladder; also for a tuned entry rung of 0)."""
    if config.tune_dir() is None:
        return None
    from pint_torch.runtime.solve import JITTER_LADDER

    value, source = resolve("gls.solve_rung", solve_rung_vkey(ftr), 0,
                            requested=False)
    if source != "tuned":
        return None
    rung = int(value)
    if rung <= 0 or rung >= len(JITTER_LADDER):
        return None
    return JITTER_LADDER[rung:]


def resolve_plan_axes(workload: str):
    """Execution plans are ROADMAP queue A item 9: raises."""
    raise NotImplementedError(
        f"resolve_plan_axes({workload!r}): execution plans over a device "
        "mesh are ROADMAP queue A item 9")


def resolve_plan_strategy(workload: str):
    """Execution plans are ROADMAP queue A item 9: raises."""
    raise NotImplementedError(
        f"resolve_plan_strategy({workload!r}): execution plans over a "
        "device mesh are ROADMAP queue A item 9")


def _ladders(value) -> Optional[dict]:
    if not isinstance(value, dict):
        return None
    ntoa, nfree = value.get("ntoa"), value.get("nfree")
    if not (isinstance(ntoa, (list, tuple)) and ntoa
            and isinstance(nfree, (list, tuple)) and nfree):
        return None
    return {"ntoa": tuple(int(b) for b in ntoa),
            "nfree": tuple(int(b) for b in nfree)}


def resolve_serve_buckets() -> Optional[dict]:
    """Tuned serving bucket ladders (``{"ntoa": (...), "nfree": (...)}``),
    or ``None`` (the static defaults).  Its reference consumer, the serving
    service, is ROADMAP queue A item 8."""
    if config.tune_dir() is None:
        return None
    value, source = resolve("serve.buckets", serve_buckets_vkey(), None,
                            requested=False)
    return _ladders(value) if source == "tuned" else None


def resolve_catalog_ladders(shapes) -> Optional[dict]:
    """Tuned catalogue bucket ladders for this shape distribution, or
    ``None`` (learn them from the catalogue)."""
    if config.tune_dir() is None:
        return None
    value, source = resolve("catalog.buckets", catalog_buckets_vkey(shapes),
                            None, requested=False)
    return _ladders(value) if source == "tuned" else None


def resolve_update_blocks() -> Optional[Tuple[int, ...]]:
    """Tuned append-block-size ladder of the streaming engine, or ``None``
    (:data:`~pint_torch.streaming.lowrank.DEFAULT_BLOCK_BUCKETS`)."""
    if config.tune_dir() is None:
        return None
    value, source = resolve("update.blocks", update_blocks_vkey(), None,
                            requested=False)
    if source != "tuned" or not isinstance(value, (list, tuple)) \
            or not value:
        return None
    try:
        ladder = tuple(sorted(int(b) for b in value))
    except (TypeError, ValueError):
        return None
    if ladder[0] < 1:
        return None
    return ladder


def resolve_correction_dtype(model, toas) -> str:
    """Tuned dtype of the grid's Woodbury chi2-correction segment:
    ``"float32"`` only where a decision recorded it for exactly this
    system, else ``"float64"``."""
    if config.tune_dir() is None:
        return "float64"
    value, source = resolve("grid.correction_dtype",
                            correction_dtype_vkey(model, toas),
                            "float64", requested=False)
    return "float32" if (source == "tuned" and value == "float32") \
        else "float64"
