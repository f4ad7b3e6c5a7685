"""B1855+09-shaped stand-ins and the snapshot exporter for the port's tests.

The real NANOGrav B1855+09 par/tim files are not in the repository, so the
port is checked on synthetic stand-ins with the same structure: a DD binary
with M2/SINI, equatorial astrometry, DMX windows, FD terms, a receiver JUMP
and EFAC/EQUAD/ECORR per ``-f`` group plus power-law red noise.  TOAs are
simulated by the reference package (``make_fake_toas_fromtim`` with white
noise from a seeded generator), so both packages see identical inputs.

:func:`export_snapshot` turns the reference package's state into the
numpy-only snapshot that :func:`pint_torch.bridge.load_snapshot` reads,
together with the reference's own outputs on those inputs.  It imports
``pint_tpu``, which is why it lives with the tests and not in the port.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

#: generator settings of the full-width stand-in (recorded in the file)
FULL_SETTINGS = dict(
    seed=20260729, n_epochs=445, n_subbands=9, mjd_start=53358.0,
    mjd_end=56598.0, subband_dt_s=0.1, backend_switch_mjd=56000.0,
    n_dmx=72, dmx_days=45.0, rn_modes=45, grid_points=16, grid_niter=1,
    fit_maxiter=2, err_scale=1.0)

#: generator settings of the small CPU-test stand-in
SMALL_SETTINGS = dict(
    seed=7, n_epochs=20, n_subbands=4, mjd_start=54000.0, mjd_end=56000.0,
    subband_dt_s=0.1, backend_switch_mjd=60000.0, n_dmx=3, dmx_days=700.0,
    rn_modes=5, grid_points=4, grid_niter=1, fit_maxiter=2, err_scale=2.5)

_GROUP = {  # (receiver, backend) -> (-f flag, sub-band MHz, error us)
    ("430", "ASP"): ("ASP_430", (422.0, 3.0), 0.7),
    ("L-wide", "ASP"): ("ASP_L-wide", (1150.0, 75.0), 1.0),
    ("430", "PUPPI"): ("PUPPI_430", (422.0, 3.0), 0.5),
    ("L-wide", "PUPPI"): ("PUPPI_L-wide", (1150.0, 75.0), 0.8),
}
_NOISE = {  # -f group -> (EFAC, EQUAD us, ECORR us)
    "ASP_430": (1.08, 0.21, 0.62),
    "ASP_L-wide": (1.05, 0.33, 0.48),
    "PUPPI_430": (1.12, 0.11, 0.35),
    "PUPPI_L-wide": (1.02, 0.17, 0.29),
}


def _epochs(s):
    mjds = np.linspace(s["mjd_start"], s["mjd_end"], s["n_epochs"])
    out = []
    for i, m in enumerate(mjds):
        rcvr = "430" if i % 2 == 0 else "L-wide"
        be = "ASP" if m < s["backend_switch_mjd"] else "PUPPI"
        out.append((m, rcvr, be))
    return out


def standin_tim(s) -> str:
    """FORMAT 1 tim text: ``n_subbands`` TOAs per epoch, ``subband_dt_s``
    apart (all within 1 s, so ECORR groups each epoch)."""
    lines = ["FORMAT 1\n"]
    spread = 9 // s["n_subbands"]
    for i, (m, rcvr, be) in enumerate(_epochs(s)):
        flag, (f0, df), err = _GROUP[(rcvr, be)]
        for j in range(s["n_subbands"]):
            freq = f0 + df * j * spread
            mjd = m + j * s["subband_dt_s"] / 86400.0
            e = (err + 0.1 * (j % 3)) * s["err_scale"]
            lines.append(f"t{i:04d}_{j} {freq:.3f} {mjd:.15f} {e:.3f} ao "
                         f"-f {flag} -fe {rcvr} -be {be}\n")
    return "".join(lines)


def _groups(s):
    return sorted({_GROUP[(r, b)][0] for _, r, b in _epochs(s)})


def standin_par(s, full: bool) -> str:
    """Par text: B1855+09-like timing (full width) or the small test
    stand-in, with DMX windows covering the span."""
    if full:
        head = [
            "PSR J1855+0945", "RAJ 18:57:36.3932884 1",
            "DECJ +09:43:17.20714 1", "PMRA -2.652 1", "PMDEC -5.423 1",
            "PX 0.6 1", "POSEPOCH 54978", "F0 186.49408156698235 1",
            "F1 -6.2049e-16 1", "PEPOCH 54978", "DM 13.299393",
            "FD1 1.6e-5 1", "FD2 -1.3e-5 1", "FD3 5.0e-6 1",
            "JUMP -fe 430 0.0 1", "BINARY DD", "PB 12.32717119177539 1",
            "A1 9.230780 1", "T0 54975.51", "OM 276.54 1", "ECC 2.17e-5 1",
            "M2 0.2689 1", "SINI 0.99915 1",
        ]
    else:
        head = [
            "PSR TSTPORT", "RAJ 04:37:15.0 1", "DECJ -47:15:09.0 1",
            "F0 173.6879 1", "F1 -1.7e-15 1", "PEPOCH 55000", "DM 2.64",
            "FD1 1.0e-5 1", "FD2 -4.0e-6 1", "JUMP -fe L-wide 0.0 1",
            "BINARY DD", "PB 5.7410 1", "A1 3.3667 1", "T0 55000.0",
            "OM 1.35", "ECC 1.9e-5", "M2 0.3", "SINI 0.95",
        ]
    rng = np.random.default_rng(s["seed"] + 1)
    lines = head + [f"DMX {s['dmx_days']:.1f}"]
    lo = s["mjd_start"] - 0.5
    for k in range(s["n_dmx"]):
        r1 = lo + k * s["dmx_days"]
        r2 = r1 + s["dmx_days"] if k < s["n_dmx"] - 1 \
            else max(r1 + s["dmx_days"], s["mjd_end"] + 1.0)
        lines += [f"DMX_{k + 1:04d} {rng.normal(0.0, 5e-4):.8e} 1",
                  f"DMXR1_{k + 1:04d} {r1:.4f}", f"DMXR2_{k + 1:04d} {r2:.4f}"]
    for g in _groups(s):
        efac, equad, ecorr = _NOISE[g]
        lines += [f"EFAC -f {g} {efac}",
                  f"EQUAD -f {g} {equad * s['err_scale']:.6g}",
                  f"ECORR -f {g} {ecorr * s['err_scale']:.6g}"]
    lines += ["TNRedAmp -13.8", "TNRedGam 3.2", f"TNRedC {s['rn_modes']}",
              "UNITS TDB"]
    return "\n".join(lines) + "\n"


def make_standin(s, full: bool):
    """(model, toas) of a stand-in, TOAs simulated with seeded white noise."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_fromtim

    model = get_model(standin_par(s, full).splitlines(keepends=True))
    with tempfile.TemporaryDirectory() as d:
        tim = os.path.join(d, "standin.tim")
        with open(tim, "w") as fh:
            fh.write(standin_tim(s))
        toas = make_fake_toas_fromtim(tim, model, add_noise=True,
                                      rng=np.random.default_rng(s["seed"]))
    return model, toas


def grid_axes(model, npts: int):
    """The reference benchmark's M2 x SINI axes (``bench.py:167-172``)."""
    dm2 = 3 * (float(model.M2.uncertainty or 0.011))
    dsini = 3 * (float(model.SINI.uncertainty or 1.8e-4))
    g_m2 = np.linspace(model.M2.value - dm2, model.M2.value + dm2, npts)
    g_sini = np.linspace(model.SINI.value - dsini,
                         min(0.999999, model.SINI.value + dsini), npts)
    return g_m2, g_sini


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------
def _component_config(name, comp, model) -> dict:
    if name == "AstrometryEquatorial":
        return {"has_posepoch": comp.POSEPOCH.value is not None}
    if name == "Spindown":
        return {"num_spin_terms": comp.num_spin_terms,
                "has_pepoch": comp.PEPOCH.value is not None}
    if name == "SolarSystemShapiro":
        return {"planet_shapiro": bool(model.PLANET_SHAPIRO.value)}
    if name == "DispersionDM":
        return {"num_dm_terms": comp.num_dm_terms,
                "has_dmepoch": comp.DMEPOCH.value is not None}
    if name == "DispersionDMX":
        return {"dmx_indices": list(comp.dmx_indices)}
    if name == "PhaseJump":
        return {"jumps": list(comp.jumps)}
    if name == "FD":
        return {"num_FD_terms": comp.num_FD_terms}
    if name.startswith("Binary"):
        return {"nfb": comp._nfb, "nwaves": comp._nwaves}
    if name == "PLRedNoise":
        amp, gam, n_lin, n_log, fmr = comp.get_plc_vals()
        ts = comp.TNREDTSPAN.value
        return {"amp": float(amp), "gam": float(gam), "n_lin": int(n_lin),
                "n_log": n_log, "f_min_ratio": float(fmr),
                "tspan_s": None if ts is None else float(ts) * 365.25 * 86400}
    return {}


def _param_entry(name, comp_name, par):
    from pint_tpu.dd import dd_from_longdouble
    from pint_tpu.models.parameter import (MJDParameter, boolParameter,
                                           intParameter, maskParameter,
                                           strParameter)

    v = par.value
    if isinstance(par, MJDParameter):
        kind = "mjd"
        if v is not None:
            d = dd_from_longdouble(np.longdouble(v))
            v = [float(d.hi), float(d.lo)]
    elif isinstance(par, maskParameter):
        kind = "mask"
    elif isinstance(par, strParameter):
        kind, v = "str", None if v is None else str(v)
    elif isinstance(par, boolParameter):
        kind, v = "bool", None if v is None else bool(v)
    elif isinstance(par, intParameter):
        kind = "int"
    else:
        kind = "float"
    if kind in ("float", "mask", "int") and v is not None:
        v = float(v)
    return {"name": name, "component": comp_name, "kind": kind, "value": v,
            "frozen": bool(par.frozen), "units": str(par.units or ""),
            "uncertainty": None if par.uncertainty is None
            else float(par.uncertainty),
            "continuous": bool(par.continuous),
            "key": getattr(par, "key", None),
            "key_value": [str(x) for x in (getattr(par, "key_value", None)
                                           or [])]}


def _flatten(prefix, obj, out):
    if obj is None:
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}", v, out)
        return
    a = np.asarray(obj)
    if a.dtype == np.float64 and np.all((a == 0) | (a == 1)):
        a = a.astype(bool)
    out[prefix] = a


def export_state(model, toas) -> dict:
    """The snapshot arrays (with ``meta`` JSON) of a model and its TOAs,
    without reference outputs."""
    from pint_tpu.models.parameter import maskParameter

    b = toas.to_batch()
    arrays = {
        "tdb_hi": np.asarray(b.tdb.hi), "tdb_lo": np.asarray(b.tdb.lo),
        "tdb0": np.asarray(float(b.tdb0)),
        "tdb_s_hi": np.asarray(b.tdb_s.hi), "tdb_s_lo": np.asarray(b.tdb_s.lo),
        "freq": np.asarray(b.freq), "error_us": np.asarray(b.error_us),
        "ssb_obs_pos": np.asarray(b.ssb_obs_pos),
        "ssb_obs_vel": np.asarray(b.ssb_obs_vel),
        "obs_sun_pos": np.asarray(b.obs_sun_pos),
        "mjds": np.asarray(toas.get_mjds(), dtype=np.float64),
    }
    for k, v in b.planet_pos.items():
        arrays[f"planet_pos/{k}"] = np.asarray(v)
    comps, params = [], []
    for name, comp in model.components.items():
        comps.append({"class": name,
                      "config": _component_config(name, comp, model)})
        _flatten(f"ctx/{name}", comp.build_context(toas), arrays)
        for p in comp.params:
            par = comp._params_dict[p]
            params.append(_param_entry(p, name, par))
            if getattr(comp, "kind", "") == "noise" \
                    and isinstance(par, maskParameter) \
                    and par.value is not None:
                m = np.zeros(len(toas), dtype=bool)
                m[par.select_toa_mask(toas)] = True
                arrays[f"ctx/{name}/masks/{p}"] = m
    meta = {"format": "pint_torch-snapshot-1", "name": model.PSR.value,
            "components": comps, "params": params,
            "free_params": list(model.free_params),
            "design_params": list(model.design_param_names())}
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


def export_snapshot(model, toas, settings: dict, chunk: int = 256,
                    grid: bool = True) -> dict:
    """:func:`export_state` plus the reference's outputs: phase, delay,
    residuals and design matrix at the snapshot's values; the post-fit
    values, uncertainties and chi2 of ``GLSFitter.fit_toas(maxiter)``; and
    the M2 x SINI GLS chi2 grid (``niter``, ``chunk``) after that fit."""
    from pint_tpu.gls_fitter import GLSFitter
    from pint_tpu.grid import grid_chisq
    from pint_tpu.residuals import Residuals

    arrays = export_state(model, toas)
    meta = json.loads(str(arrays["meta"]))
    ph = model.phase(toas)
    arrays["ref/phase_int"] = np.asarray(ph.int_)
    arrays["ref/phase_frac"] = np.asarray(ph.frac)
    arrays["ref/delay"] = np.asarray(model.delay(toas))
    arrays["ref/time_resids"] = np.asarray(Residuals(toas, model).time_resids)
    M, names, _ = model.designmatrix(toas)
    arrays["ref/designmatrix"] = np.asarray(M)
    f = GLSFitter(toas, model)
    chi2 = f.fit_toas(maxiter=settings["fit_maxiter"])
    design = list(model.design_param_names())
    arrays["ref/postfit_values"] = np.array(
        [float(getattr(f.model, p).value) for p in design])
    arrays["ref/postfit_uncertainties"] = np.array(
        [float(getattr(f.model, p).uncertainty) for p in design])
    ref = {"designmatrix_names": list(names), "postfit_params": design,
           "postfit_chi2": float(chi2), "settings": dict(settings)}
    if grid:
        g_m2, g_sini = grid_axes(model, settings["grid_points"])
        c2, _ = grid_chisq(f, ("M2", "SINI"), (g_m2, g_sini),
                           niter=settings["grid_niter"], chunk=chunk)
        arrays["ref/grid_m2"] = g_m2
        arrays["ref/grid_sini"] = g_sini
        arrays["ref/grid_chi2"] = np.asarray(c2)
        arrays["ref/grid_rungs"] = np.asarray(
            f.last_grid_diagnostics["ladder_rung"])
        ref["grid_argmin"] = [int(i) for i in np.unravel_index(
            int(np.nanargmin(c2)), c2.shape)]
        ref["grid_chunk"] = int(chunk)
    meta["reference"] = ref
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays
