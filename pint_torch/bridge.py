"""Load the reference package's state into the port.

A snapshot is a ``.npz`` archive (or the equivalent dict) of plain numpy
arrays plus one JSON ``meta`` string.  It carries everything the port's
evaluation needs and nothing it has to compute on the host: the TOA batch
fields, the TOAs' MJDs, the ordered component list with each component's
static configuration, the parameter table (epochs as exact (hi, lo)
pairs), each component's per-TOA context (DMX windows, mask selections),
for a model with an absolute phase the TZR TOA's batch row and contexts
under ``tzr/`` and, under ``ref/``, the reference package's own outputs
on the same inputs, so a run can be checked where the reference does not
run (those of the fitter, residuals, model and grid API under
``ref/api/``, those of the Bayesian timing interface and the ensemble
MCMC under ``ref/bayes/``, those of the photon fitters under
``ref/photon/``).  Photons carry their weights under ``weight``.  The optional ``meta["top_level"]`` holds the
model's own parameters (``TOP_LEVEL_PARAMS``: START and FINISH as (hi,
lo) pairs) and the TOAs' ``ephem``; a snapshot without it loads with
their defaults.

This module reads snapshots only; the exporter needs the reference package
and lives with the tests (``tests/test_torch_snapshot.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np
import torch

from pint_torch import F64, resolve_device
from pint_torch.models import Component, Param, TimingModel
from pint_torch.toa import TOABatch

__all__ = ["load_snapshot", "read_snapshot", "SNAPSHOT_FORMAT",
           "STANDIN_PATH", "DMX15_PATH", "ELL1_PATH", "ELL1H_PATH",
           "NGC_PATH", "NGC_PHOFF_PATH", "DDK_PATH", "DDGR_PATH",
           "BT_SMALL_PATH", "DDS_SMALL_PATH", "DDH_SMALL_PATH", "BW_PATH",
           "BW_WAVES_PATH", "PTA_PATH", "YOUNG_PATH", "DD_FBX_SMALL_PATH",
           "BT_PIECEWISE_SMALL_PATH", "PTA_SMALL_PATH", "YOUNG_SMALL_PATH",
           "WB_PATH", "WB_SMALL_PATH", "WB_WHITE_SMALL_PATH", "NOISE_PATH",
           "KEPLER_PATH", "PHOTON_PATH", "PHOTON_SMALL_PATH", "STREAM_PATH",
           "STREAM_SMALL_PATH", "stream_schedule", "CATALOG_PATH",
           "CATALOG_SMALL_PATH", "load_catalog_snapshot", "flow_params",
           "standin_files", "files_reference"]

SNAPSHOT_FORMAT = "pint_torch-snapshot-1"
#: the committed full-width B1855+09-shaped stand-in
STANDIN_PATH = Path(__file__).resolve().parent / "data" / "b1855_standin.npz"
#: the same stand-in with dense DMX (216 windows of 15 d): nt = 232 at the
#: M2 x SINI grid
DMX15_PATH = STANDIN_PATH.with_name("b1855_dmx15_standin.npz")
#: the committed full-width J1909-3744-shaped stand-in: ELL1 binary,
#: ecliptic astrometry, white noise only (the WLS fitters and grid), k = 88
#: at the M2 x SINI grid
ELL1_PATH = STANDIN_PATH.with_name("j1909_ell1_standin.npz")
#: the same J1909-3744-shaped stand-in with the orthometric Shapiro delay
#: (BinaryELL1H, H3/STIGMA in place of M2/SINI; exact form)
ELL1H_PATH = STANDIN_PATH.with_name("j1909_ell1h_standin.npz")
#: the NGC6440E-shaped model of the reference benchmark's secondary cell
#: (62 simulated TOAs, AbsPhase from TZRMJD; the F0 x F1 WLS grid)
NGC_PATH = STANDIN_PATH.with_name("ngc6440e_standin.npz")
#: the same with an explicit fitted PhaseOffset (PHOFF) in place of the
#: implicit offset
NGC_PHOFF_PATH = STANDIN_PATH.with_name("ngc6440e_phoff_standin.npz")
#: the J1713+0747-shaped GLS stand-in: a DDK binary (Kopeikin's
#: corrections; KIN x KOM grid), ecliptic astrometry with parallax
DDK_PATH = STANDIN_PATH.with_name("j1713_ddk_standin.npz")
#: the B1913+16-shaped WLS stand-in: a DDGR binary at ECC 0.617 (MTOT x M2
#: grid)
DDGR_PATH = STANDIN_PATH.with_name("b1913_ddgr_standin.npz")
#: the small GLS stand-in (80 TOAs) with its binary as BT, DDS and DDH
BT_SMALL_PATH = STANDIN_PATH.with_name("small_bt_standin.npz")
DDS_SMALL_PATH = STANDIN_PATH.with_name("small_dds_standin.npz")
DDH_SMALL_PATH = STANDIN_PATH.with_name("small_ddh_standin.npz")
#: the J0023+0923-shaped black widow: ELL1 on FB0..FB3 orbits (WLS; FB0 x
#: FB1 grid), and the same with ORBWAVES on an FBX base (no grid)
BW_PATH = STANDIN_PATH.with_name("j0023_bw_standin.npz")
BW_WAVES_PATH = STANDIN_PATH.with_name("j0023_bw_waves_standin.npz")
#: J1713+0747 with EPTA-DR2-style DM, chromatic and solar-wind terms (GLS;
#: KIN x KOM grid)
PTA_PATH = STANDIN_PATH.with_name("j1713_pta_standin.npz")
#: the Vela-shaped young pulsar: glitches, WAVE, troposphere (WLS;
#: GLF0D_1 x GLTD_1 grid)
YOUNG_PATH = STANDIN_PATH.with_name("vela_young_standin.npz")
#: the small stand-ins (80 TOAs, fits only): DD on ORBWAVES with a PB
#: base, BT_piecewise, the solar-wind and Fourier-basis PTA terms,
#: piecewise spindown with IFUNC
DD_FBX_SMALL_PATH = STANDIN_PATH.with_name("small_dd_fbx_standin.npz")
BT_PIECEWISE_SMALL_PATH = STANDIN_PATH.with_name(
    "small_bt_piecewise_standin.npz")
PTA_SMALL_PATH = STANDIN_PATH.with_name("small_pta_standin.npz")
YOUNG_SMALL_PATH = STANDIN_PATH.with_name("small_young_standin.npz")

#: the NANOGrav-12.5-yr-wideband-shaped B1855+09: two wideband TOAs an
#: epoch (one per Arecibo receiver) with DM measurements, DMJUMP,
#: EFAC/EQUAD and DMEFAC/DMEQUAD per receiver, red noise (the wideband
#: fitters and the joint TOA+DM noise fit)
WB_PATH = STANDIN_PATH.with_name("b1855_wb_standin.npz")
#: the small stand-in made wideband, with NE_SW (SWM 1), SWX windows,
#: DMWaveX, FDJUMPDM and a DMJUMP (the wideband fitters)
WB_SMALL_PATH = STANDIN_PATH.with_name("small_wb_standin.npz")
#: the same with white noise only (no ECORR, no red noise): the diagonal
#: wideband likelihood of the Bayesian timing interface
WB_WHITE_SMALL_PATH = STANDIN_PATH.with_name("small_wb_white_standin.npz")
#: the B1855+09 stand-in with every EFAC, EQUAD and ECORR and the red
#: noise's TNREDAMP/TNREDGAM free (the maximum-likelihood noise fit)
NOISE_PATH = STANDIN_PATH.with_name("b1855_noise_standin.npz")
#: the Kepler cores' inputs and the reference's values and Jacobians
KEPLER_PATH = STANDIN_PATH.with_name("kepler_reference.npz")
#: the Fermi-LAT-shaped J0030+0451 photons: 32768 weighted, barycentred
#: photons over twelve years with J0030's two-peak template (the photon
#: fitters and FFTFIT), and the reference photon test's 300 photons
PHOTON_PATH = STANDIN_PATH.with_name("j0030_photon_standin.npz")
PHOTON_SMALL_PATH = STANDIN_PATH.with_name("small_photon_standin.npz")
#: the J1909-3744-shaped red-noise stream (4005 TOAs, K = 150 frame
#: columns) with the serve batcher's reference outputs, and its small CPU
#: version (80 TOAs, K = 23): each carries its operation schedule
#: (:func:`stream_schedule`) and the reference's run of it
STREAM_PATH = STANDIN_PATH.with_name("j1909_stream_standin.npz")
STREAM_SMALL_PATH = STANDIN_PATH.with_name("small_stream_standin.npz")
#: the 67-pulsar catalogue (the NANOGrav 15-year GWB analysis' pulsar
#: count, 100-400 TOAs each, two members with a corrupt row) with the
#: reference's ingest, buckets, fits, joint likelihood at 14 modes and
#: chain; and its 16-pulsar CPU version (the reference catalogue test's, 3
#: modes)
CATALOG_PATH = STANDIN_PATH.with_name("pta67_catalog_standin.npz")
CATALOG_SMALL_PATH = STANDIN_PATH.with_name("small_catalog_standin.npz")



def standin_files(path: Union[str, Path]) -> Tuple[Path, Path]:
    """The par and tim files of the committed stand-in at ``path``
    (``<name>_standin.npz`` -> ``<name>.par``, ``<name>.tim``), from which
    ``pint_torch.models.get_model_and_toas`` reads it; its ``ref/files/``
    holds the reference's run on them."""
    path = Path(path)
    stem = path.name[:-len("_standin.npz")] if path.name.endswith(
        "_standin.npz") else path.stem
    return path.with_name(stem + ".par"), path.with_name(stem + ".tim")


def files_reference(path_or_dict: Union[str, Path, dict]) -> Tuple[dict,
                                                                    dict]:
    """(meta, arrays) of the reference's run on a stand-in's par and tim
    files: ``meta["reference"]["files"]`` and the ``ref/files/`` arrays
    without their prefix, laid out as a snapshot's own (the run's state
    and batch, ``ref/`` outputs, ``host/`` columns)."""
    meta, arrays = read_snapshot(path_or_dict)
    pre = "ref/files/"
    return (meta["reference"]["files"],
            {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)})


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


def _context(name: str, arrays: dict, device, noise: bool = False,
             root: str = "ctx") -> dict:
    """The component's context: ``<root>/<component>/<key>[/<sub>]``
    arrays; a noise component's stay on the host (masks as booleans, the
    chromatic and solar-wind basis scales as float64), the rest become
    float64 tensors on ``device``."""
    prefix = f"{root}/{name}/"
    out: dict = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        if noise:
            val = np.asarray(arr, dtype=bool if parts[0] == "masks"
                             else np.float64)
        else:
            val = torch.tensor(np.asarray(arr, dtype=np.float64), dtype=F64,
                               device=device)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return out


def _batch_arrays(arrays: dict, prefix: str) -> dict:
    """The batch fields stored under ``prefix`` (the model's TOAs under
    "", the TZR row under "tzr/"), keys without the prefix."""
    out = {k: arrays[prefix + k] for k in _BATCH_KEYS}
    out.update({k: arrays[prefix + k] for k in ("dm", "dm_error", "weight",
                                                 "mjd_lo", "obs")
                if prefix + k in arrays})
    out.update({k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix + "planet_pos/")})
    return out


def load_snapshot(path_or_dict: Union[str, Path, dict] = STANDIN_PATH,
                  device=None) -> Tuple[TimingModel, TOABatch]:
    """``(model, batch)`` on ``device`` (default ``"cuda"``; pass
    ``device="cpu"`` to run the plain PyTorch path).  Every tensor is
    created on the device directly, in float64."""
    dev = resolve_device(device)
    meta, arrays = read_snapshot(path_or_dict)
    top = {"PSR": meta.get("name") or None, **meta.get("top_level", {})}
    batch = TOABatch.from_numpy(_batch_arrays(arrays, ""), dev,
                                ephem=top.pop("ephem", None),
                                coverage=meta.get("coverage"))
    comps = []
    for c in meta["components"]:
        cls = Component.component_types.get(c["class"])
        if cls is None:
            raise NotImplementedError(
                f"component {c['class']} is not ported yet")
        ctx = _context(c["class"], arrays, dev, cls.kind == "noise")
        if c["class"] == "AbsPhase" and "tzr/tdb_hi" in arrays:
            ctx["tzr_batch"] = TOABatch.from_numpy(
                _batch_arrays(arrays, "tzr/"), dev, tzr=True,
                contexts={d["class"]: _context(d["class"], arrays, dev,
                                               root="tzr/ctx")
                          for d in meta["components"]})
        comps.append(cls(c.get("config", {}), ctx))
    params = {}
    for p in meta["params"]:
        value = p["value"]
        if p["kind"] in ("mjd", "pair") and value is not None:
            value = (float(value[0]), float(value[1]))
        params[p["name"]] = Param(
            name=p["name"], component=p["component"], kind=p["kind"],
            value=value, frozen=bool(p["frozen"]), units=p.get("units", ""),
            uncertainty=p.get("uncertainty"),
            continuous=bool(p.get("continuous", True)), key=p.get("key"),
            key_value=list(p.get("key_value") or []))
    model = TimingModel(meta.get("name", ""), comps, params, dev,
                        top_level=top)
    model.validate()
    return model, batch


def stream_schedule(meta: dict):
    """A stream snapshot's operations: ``(base rows, [rows of each
    append], dup, quarantine)`` -- the first ``base`` epochs, then one
    append a ``blocks`` entry of that many epochs (TOAs epoch-major,
    ``n_subbands`` an epoch), the append ``dup`` carrying a copy of its
    first row, and the ``quarantine`` rows of the last append's block."""
    s = meta["reference"]["settings"]
    st, n = s["stream"], s["n_subbands"]
    base = np.arange(st["base"] * n)
    rows, pos = [], len(base)
    for ne in st["blocks"]:
        rows.append(np.arange(pos, pos + ne * n))
        pos += ne * n
    return base, rows, st["dup"], list(st["quarantine"])


def load_catalog_snapshot(path_or_dict: Union[str, Path, dict] = CATALOG_PATH,
                          device=None) -> List[Tuple[TimingModel, TOABatch]]:
    """The ``(model, batch)`` pairs of a catalogue snapshot, on ``device``
    (default ``"cuda"``): member ``i``'s arrays under ``psr/<i>/``, each a
    snapshot of its own (:func:`load_snapshot`), its TOAs as they were
    recorded, corrupt rows included (the catalogue's gate,
    :func:`pint_torch.catalog.ingest_catalog`, quarantines them)."""
    dev = resolve_device(device)
    meta, arrays = read_snapshot(path_or_dict)
    out = []
    for i in range(int(meta["catalog"]["members"])):
        pre = f"psr/{i}/"
        out.append(load_snapshot({k[len(pre):]: v for k, v in arrays.items()
                                  if k.startswith(pre)}, device=dev))
    return out


def flow_params(tree, device=None) -> dict:
    """The reference's flow parameter tree (``{"layers": [{"W1", "b1",
    "Ws", "bs", "Wt", "bt"}, ...], "loc", "log_scale"}`` of numpy or
    array-likes) as the port's: the same dict of float64 tensors on
    ``device`` (default ``"cuda"``), each leaf bitwise."""
    dev = resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=F64,
                               device=dev)

    return {"layers": [{k: t(v) for k, v in layer.items()}
                       for layer in tree["layers"]],
            "loc": t(tree["loc"]), "log_scale": t(tree["log_scale"])}
