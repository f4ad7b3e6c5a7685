"""Schema-tagged autotune records: the sweep and decision wire format (port
of ``pint_tpu/autotune/records.py``).

Two document families share the ``AUTOTUNE_SCHEMA`` tag:

* **sweep records**, one JSON line per measured configuration; a failed
  configuration is a *degraded twin* of the same schema with ``error`` and
  ``failed_in`` in place of ``fits_per_sec``;
* **decision records**, one tuned decision as a standalone line (the tuning
  manifest embeds the same body per decision; the manifest document itself
  is tagged ``TUNE_MANIFEST_SCHEMA``).

The tags are the reference's strings, so that either package reads a
document the other wrote.  Everything here is plain-dict construction.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["AUTOTUNE_SCHEMA", "TUNE_MANIFEST_SCHEMA", "sweep_record",
           "decision_record"]

AUTOTUNE_SCHEMA = "pint_tpu.telemetry.autotune/1"
TUNE_MANIFEST_SCHEMA = "pint_tpu.autotune.manifest/1"


def sweep_record(platform: str, chunk: int, grid_points: int,
                 fits_per_sec: Optional[float] = None,
                 elapsed_s: Optional[float] = None,
                 compile_s: Optional[float] = None,
                 sanity_ok: Optional[bool] = None,
                 error: Optional[str] = None,
                 failed_in: Optional[str] = None,
                 error_detail: Optional[str] = None) -> dict:
    """One sweep-row document.  A successful row carries ``fits_per_sec``;
    a degraded row carries ``error`` and ``failed_in`` (``warmup_compile``
    | ``measured_run``) instead."""
    rec = {
        "schema": AUTOTUNE_SCHEMA,
        "record": "sweep",
        "metric": "gls_grid_sweep",
        "platform": str(platform),
        "chunk": int(chunk),
        "grid_points": int(grid_points),
    }
    if error is not None:
        rec["error"] = str(error)
        rec["failed_in"] = str(failed_in or "unknown")
        if error_detail is not None:
            rec["error_detail"] = str(error_detail)
    else:
        rec["fits_per_sec"] = float(fits_per_sec)
    if elapsed_s is not None:
        rec["elapsed_s"] = round(float(elapsed_s), 3)
    if compile_s is not None:
        rec["compile_s"] = round(float(compile_s), 2)
    if sanity_ok is not None:
        rec["sanity_ok"] = bool(sanity_ok)
    return rec


def decision_record(decision) -> dict:
    """A tuned decision as a standalone schema-tagged line (``decision`` is a
    :class:`pint_torch.autotune.manifest.TuningDecision` or its
    ``to_dict()``)."""
    body = decision if isinstance(decision, dict) else decision.to_dict()
    return {"schema": AUTOTUNE_SCHEMA, "record": "decision",
            "decision": body}
