"""Load the reference package's state into the port.

A snapshot is a ``.npz`` archive (or the equivalent dict) of plain numpy
arrays plus one JSON ``meta`` string.  It carries everything the port's
evaluation needs and nothing it has to compute on the host: the TOA batch
fields, the TOAs' MJDs, the ordered component list with each component's
static configuration, the parameter table (epochs as exact (hi, lo)
pairs), each component's per-TOA context (DMX windows, mask selections)
and, under ``ref/``, the reference package's own outputs on the same
inputs, so a run can be checked where the reference does not run.

This module reads snapshots only; the exporter needs the reference package
and lives with the tests (``tests/test_torch_snapshot.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple, Union

import numpy as np
import torch

from pint_torch import F64, resolve_device
from pint_torch.models import Component, Param, TimingModel
from pint_torch.toa import TOABatch

__all__ = ["load_snapshot", "read_snapshot", "SNAPSHOT_FORMAT",
           "STANDIN_PATH"]

SNAPSHOT_FORMAT = "pint_torch-snapshot-1"
#: the committed full-width B1855+09-shaped stand-in
STANDIN_PATH = Path(__file__).resolve().parent / "data" / "b1855_standin.npz"

_BATCH_KEYS = ("tdb_hi", "tdb_lo", "tdb0", "tdb_s_hi", "tdb_s_lo", "freq",
               "error_us", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
               "mjds")


def read_snapshot(path_or_dict: Union[str, Path, dict]) -> Tuple[dict, dict]:
    """(meta, arrays) of a snapshot file or dict, arrays as numpy."""
    if isinstance(path_or_dict, dict):
        arrays = dict(path_or_dict)
    else:
        with np.load(path_or_dict, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    if meta.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"not a {SNAPSHOT_FORMAT} snapshot: "
                         f"{meta.get('format')!r}")
    return meta, arrays


def _context(name: str, arrays: dict, device) -> dict:
    """The component's context: ``ctx/<component>/<key>[/<sub>]`` arrays;
    masks of noise components stay host booleans, the rest become float64
    tensors on ``device``."""
    prefix = f"ctx/{name}/"
    out: dict = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        if name in ("ScaleToaError", "EcorrNoise", "PLRedNoise"):
            val = np.asarray(arr, dtype=bool)
        else:
            val = torch.tensor(np.asarray(arr, dtype=np.float64), dtype=F64,
                               device=device)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return out


def load_snapshot(path_or_dict: Union[str, Path, dict] = STANDIN_PATH,
                  device=None) -> Tuple[TimingModel, TOABatch]:
    """``(model, batch)`` on ``device`` (default ``"cuda"``; pass
    ``device="cpu"`` to run the plain PyTorch path).  Every tensor is
    created on the device directly, in float64."""
    dev = resolve_device(device)
    meta, arrays = read_snapshot(path_or_dict)
    batch_arrays = {k: arrays[k] for k in _BATCH_KEYS}
    batch_arrays.update({k: v for k, v in arrays.items()
                         if k.startswith("planet_pos/")})
    batch = TOABatch.from_numpy(batch_arrays, dev)
    comps = []
    for c in meta["components"]:
        cls = Component.component_types.get(c["class"])
        if cls is None:
            raise NotImplementedError(
                f"component {c['class']} is not ported yet")
        comps.append(cls(c.get("config", {}), _context(c["class"], arrays,
                                                          dev)))
    params = {}
    for p in meta["params"]:
        value = p["value"]
        if p["kind"] == "mjd" and value is not None:
            value = (float(value[0]), float(value[1]))
        params[p["name"]] = Param(
            name=p["name"], component=p["component"], kind=p["kind"],
            value=value, frozen=bool(p["frozen"]), units=p.get("units", ""),
            uncertainty=p.get("uncertainty"),
            continuous=bool(p.get("continuous", True)), key=p.get("key"),
            key_value=list(p.get("key_value") or []))
    model = TimingModel(meta.get("name", ""), comps, params, dev)
    return model, batch
