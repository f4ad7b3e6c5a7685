"""B1855+09-, J1909-3744- and NGC6440E-shaped stand-ins and the snapshot
exporter for the port's tests.

The real NANOGrav par/tim files are not in the repository, so the port is
checked on synthetic stand-ins with the same structure.  The B1855+09 ones
carry a DD binary with M2/SINI, equatorial astrometry, DMX windows, FD
terms, a receiver JUMP and EFAC/EQUAD/ECORR per ``-f`` group plus power-law
red noise (a GLS model).  The J1909-3744 one carries an ELL1 binary with
M2/SINI, ecliptic astrometry, DMX, FD, a receiver JUMP and EFAC/EQUAD per
``-f`` group with no correlated noise (a WLS model: the reference's
``Fitter.auto`` picks ``DownhillWLSFitter`` for it); its ELL1H variant has
the orthometric H3/STIGMA in place of M2/SINI.  The NGC6440E one is the
reference benchmark's own fallback model (``bench.py:43`` ``FALLBACK_PAR``,
an isolated pulsar with an absolute phase from TZRMJD) with 62 TOAs from
``make_fake_toas_uniform`` as ``bench.py:1409-1421`` makes them, and a
variant with an explicit fitted PHOFF.  TOAs are simulated by the
reference package (``make_fake_toas_fromtim`` or
``make_fake_toas_uniform``, white noise from a seeded generator), so both
packages see identical inputs.

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

#: the full-width stand-in with dense DMX: 216 windows of 15 d (about one
#: per two observing epochs, as NANOGrav narrowband releases fit them), so
#: nt = 232 at the M2 x SINI grid
DMX15_SETTINGS = dict(FULL_SETTINGS, n_dmx=216, dmx_days=15.0)

#: generator settings of the small CPU-test stand-in
SMALL_SETTINGS = dict(
    seed=7, n_epochs=20, n_subbands=4, mjd_start=54000.0, mjd_end=56000.0,
    subband_dt_s=0.1, backend_switch_mjd=60000.0, n_dmx=3, dmx_days=700.0,
    rn_modes=5, grid_points=4, grid_niter=1, fit_maxiter=2, err_scale=2.5)

#: the small stand-in with 130 DMX windows of 7 d, three epochs (both
#: receivers) in each: nt = 140 at the grid, past K3's former 128-row limit
SMALL_DMX_SETTINGS = dict(
    SMALL_SETTINGS, n_epochs=390, mjd_end=54000.0 + 130 * 7.0 - 1.0,
    n_dmx=130, dmx_days=7.0, grid_points=3)

#: the J1909-3744-shaped WLS stand-in: the epoch structure of
#: ``FULL_SETTINGS`` (445 epochs x 9 sub-bands = 4005 TOAs, 72 DMX windows
#: of 45 d), an ELL1 binary and no correlated noise; its M2 x SINI grid
#: refits with ``niter=4`` Gauss-Newton steps, the reference's default
ELL1_SETTINGS = dict(FULL_SETTINGS, pulsar="J1909-3744", grid_niter=4)

#: the small CPU-test version of the ELL1 stand-in (20 epochs x 4, 3 DMX
#: windows, a 4 x 4 grid)
SMALL_ELL1_SETTINGS = dict(SMALL_SETTINGS, pulsar="J1909-3744",
                           grid_niter=4)

#: the small ELL1 stand-in with one more JUMP that selects no TOA: its
#: design column is zero, so the WLS system is rank-deficient
SMALL_ELL1_EMPTY_JUMP_SETTINGS = dict(SMALL_ELL1_SETTINGS, empty_jump=True)

#: the J1909-3744-shaped stand-in with BinaryELL1H: STIGMA = SINI / (1 +
#: sqrt(1 - SINI^2)) and H3 = Tsun M2 STIGMA^3 in place of M2/SINI (the
#: exact form); its 16 x 16 grid sweeps H3 x STIGMA, 3 sigma about the WLS
#: fit, at ``niter=4``
ELL1H_SETTINGS = dict(ELL1_SETTINGS, binary="ELL1H", grid="h3stigma")

#: the small CPU-test version of the ELL1H stand-in
SMALL_ELL1H_SETTINGS = dict(SMALL_ELL1_SETTINGS, binary="ELL1H",
                            grid="h3stigma")

#: the NGC6440E-shaped WLS stand-in of the reference benchmark's secondary
#: cell (``bench.py:1409-1421,1610-1630``): ``FALLBACK_PAR`` with 62 TOAs
#: from ``make_fake_toas_uniform(53400, 54800, 62, model, error_us=20.0,
#: add_noise=True, rng=np.random.default_rng(12345))``; the 16 x 16 F0 x F1
#: grid about ``WLSFitter.fit_toas(maxiter=3)`` at ``grid_chisq``'s default
#: ``niter=4``; also both WLS fitters' Huber fits
NGC_SETTINGS = dict(pulsar="NGC6440E", seed=12345, ntoas=62,
                    mjd_start=53400.0, mjd_end=54800.0, error_us=20.0,
                    grid_points=16, grid_niter=4, fit_maxiter=3,
                    grid="f0f1", huber=True)

#: the same with an explicit fitted phase offset (``PHOFF 0 1``): no
#: implicit Offset column, so the grid's explicit offset and PHOFF make
#: every point's system rank-deficient
NGC_PHOFF_SETTINGS = dict(NGC_SETTINGS, phoff=True)

#: the J1713+0747-shaped GLS stand-in: ``FULL_SETTINGS``' epochs (445 x 9
#: = 4005 TOAs at Arecibo, 72 DMX windows of 45 d, EFAC/EQUAD/ECORR for
#: the four -f groups, 45 red-noise modes) with ecliptic astrometry (PX,
#: PMELONG/PMELAT) and a DDK binary (KIN, KOM, K96 on); its 16 x 16 GLS
#: grid sweeps KIN x KOM, 3 sigma about the GLS fit, at ``niter=1``
DDK_SETTINGS = dict(FULL_SETTINGS, pulsar="J1713+0747", grid="kinkom")

#: the small CPU-test version of the DDK stand-in: 80 epochs x 4
#: sub-bands at a tenth of the small stand-in's errors (~0.2 us; with 20
#: epochs and its errors the ~20 timing parameters and the Kopeikin terms
#: are not constrained and the reference's GLS fit diverges), a 4 x 4 KIN
#: x KOM grid.  At 2 sub-bands the timing block's condition number is
#: ~4e10 and its uncertainties move by ~1e-6 under a mere reordering of
#: the Gram sums, the size of the bar (``tests/_torch_conditioning.py``)
SMALL_DDK_SETTINGS = dict(SMALL_SETTINGS, pulsar="J1713+0747",
                          grid="kinkom", n_epochs=80, err_scale=0.25)

#: the B1913+16-shaped WLS stand-in: ``FULL_SETTINGS``' epochs at Arecibo
#: (72 DMX windows, FD1-3, a JUMP) with EFAC/EQUAD only and TOA errors 8x
#: the B1855 stand-in's (4-9 us, a 17 Hz pulsar's), no red noise; a DDGR
#: binary (ECC 0.617, MTOT, M2); ``WLSFitter.fit_toas(maxiter=3)`` and the
#: 16 x 16 MTOT x M2 WLS grid, 3 sigma about that fit, at ``niter=4``
DDGR_SETTINGS = dict(FULL_SETTINGS, pulsar="B1913+16", rn_modes=0,
                     err_scale=8.0, fit_maxiter=3, grid_niter=4,
                     grid="mtotm2")

#: the small CPU-test version of the DDGR stand-in (a 4 x 4 MTOT x M2 grid)
SMALL_DDGR_SETTINGS = dict(SMALL_SETTINGS, pulsar="B1913+16", rn_modes=0,
                           fit_maxiter=3, grid_niter=4, grid="mtotm2")

#: the small GLS stand-in with its DD binary as BT (ECC 0.17, OM fitted),
#: as DDS (SHAPMAX in place of SINI) and as DDH (H3/STIGMA in place of
#: M2/SINI), the last two at a tenth of its errors (~0.2 us, so that the
#: fitted Shapiro parameters are constrained): ``Fitter.auto``'s fit, no
#: grid
SMALL_BT_SETTINGS = dict(SMALL_SETTINGS, binary="BT")
SMALL_DDS_SETTINGS = dict(SMALL_SETTINGS, binary="DDS", err_scale=0.25)
SMALL_DDH_SETTINGS = dict(SMALL_SETTINGS, binary="DDH", err_scale=0.25)

#: the J0023+0923-shaped black-widow stand-in: ``FULL_SETTINGS``' epochs
#: at the GBT (J1909's receivers), an ELL1 binary with the orbital
#: frequency ladder FB0..FB3 in place of PB (A1 0.035 lt-s), EFAC/EQUAD
#: only (a WLS model); its 16 x 16 FB0 x FB1 WLS grid, 3 sigma about the
#: WLS fit, at ``niter=4``
BW_SETTINGS = dict(ELL1_SETTINGS, pulsar="J0023+0923", grid="fb0fb1",
                   err_scale=2.0)
#: the same with ORBWAVES on the FBX base (FB0, FB1, ORBWAVE_OM, five
#: fitted C/S pairs, ORBWAVE_EPOCH): the fits, no grid
BW_WAVES_SETTINGS = dict(BW_SETTINGS, orbwaves=5, grid=None)
#: the J1713+0747-shaped GLS stand-in of an EPTA-DR2-style noise model:
#: ``DDK_SETTINGS``' epochs and DDK binary with DMX replaced by PLDMNoise
#: (30 modes), PLChromNoise (30 modes, TNCHROMIDX 4), CM/CM1, SWX windows
#: one per conjunction year (SWXDM fitted, SWXP frozen), FDJUMP and
#: FDJUMPDM on one -f group; ``Fitter.auto`` and the 16 x 16 KIN x KOM GLS
#: grid at ``niter=1``
PTA_SETTINGS = dict(DDK_SETTINGS, pta=True, n_dmx=0)
#: the Vela-shaped young-pulsar WLS stand-in: ``FULL_SETTINGS``' epochs at
#: Parkes, an isolated pulsar (F0 11.19 Hz) with two glitches, the first
#: with a GLF0D/GLTD recovery, WAVE_OM with 10 WAVE pairs and the
#: troposphere on; its 16 x 16 GLF0D_1 x GLTD_1 WLS grid at ``niter=4``
YOUNG_SETTINGS = dict(FULL_SETTINGS, pulsar="J0835-4510", rn_modes=0,
                      n_dmx=0, err_scale=20.0, fit_maxiter=3, grid_niter=4,
                      grid="glitch")
#: the small stand-ins of this slice's forms (80 TOAs, the fits, no grid):
#: DD on ORBWAVES with a PB base; BT_piecewise with two pieces; the
#: solar-wind and Fourier-basis PTA terms (SWM 1 NE_SW with NE_SW1, SWP
#: and SWEPOCH, PLSWNoise, CMX, WaveX, DMWaveX, CMWaveX, a delay JUMP and
#: DMJUMP; its 20 epochs a quarter year apart, every fourth 10 d before a
#: conjunction, so that the solar wind is sampled); PiecewiseSpindown with
#: IFUNC (SIFUNC 2)
SMALL_DD_FBX_SETTINGS = dict(SMALL_SETTINGS, binary="DD", orbwaves=3)
SMALL_BT_PIECEWISE_SETTINGS = dict(SMALL_SETTINGS, binary="BT_piecewise")
SMALL_PTA_SETTINGS = dict(SMALL_SETTINGS, small_pta=True, err_scale=0.5,
                          mjd_start=54180.0, mjd_end=55914.9375)
SMALL_YOUNG_SETTINGS = dict(SMALL_SETTINGS, pulsar="J0835-4510",
                            rn_modes=0, n_dmx=0, err_scale=20.0,
                            fit_maxiter=3, grid_niter=4, sifunc=2)

#: the B1855+09 stand-in for the maximum-likelihood noise fit, the
#: reference's ``TestB1855JointNoiseFit`` case: ``FULL_SETTINGS``' model
#: and 4005 TOAs, simulated with their correlated noise too (ECORR epochs
#: and red noise at 20 times the amplitude, TNREDAMP -12.499 = -13.8 +
#: log10 20), EQUAD and ECORR at twice the B1855 stand-in's and each TOA
#: error times a seeded factor 10^U(-0.5, 0.5), as scintillation spreads
#: them (at the stand-in's own narrow errors EFAC and EQUAD trade off and
#: EQUADs and ECORRs fit to ~0, where the likelihood is flat and where an
#: optimizer stops depends on rounding); ``Fitter.auto``'s fit frees
#: every EFAC, EQUAD and ECORR and TNREDAMP/TNREDGAM (14 parameters), no
#: grid
NOISE_SETTINGS = dict(FULL_SETTINGS, rn_amp=-12.499, noise_scale=2.0,
                      err_spread=0.5, correlated=True,
                      noise_free=["EFAC", "EQUAD", "ECORR", "TNREDAMP",
                                  "TNREDGAM"], grid=None)

#: the NANOGrav-12.5-yr-wideband-shaped B1855+09 (Alam et al. 2021, ApJS
#: 252, 5; the reference's ``tests/test_wideband_12y.py`` target):
#: ``FULL_SETTINGS``' model (DD, 72 DMX, FD, red noise) with one wideband
#: TOA per epoch and Arecibo receiver (445 x 2 = 890), each with a DM
#: measurement (errors 1e-4 to 5e-4 pc/cm^3), EFAC/EQUAD and
#: DMEFAC/DMEQUAD per receiver, no ECORR, a fitted DMJUMP on the 430 MHz
#: receiver, FD1-3 frozen (at two frequencies they are the JUMP's
#: direction); the wideband fits, then ``Fitter.auto``'s with DMEFAC,
#: DMEQUAD and EFAC free (the joint TOA+DM noise fit), no grid
WB_SETTINGS = dict(FULL_SETTINGS, wideband=True, n_subbands=1,
                   noise_free=["DMEFAC", "DMEQUAD", "EFAC"], grid=None)

#: the small stand-in made wideband (20 epochs x 4 sub-bands, each TOA
#: with a DM measurement), near the ecliptic with SWM 1 NE_SW, two SWX
#: windows, DMWaveX, FDJUMPDM and a DMJUMP fitted: the wideband fits, no
#: grid (the epochs of ``SMALL_PTA_SETTINGS``)
SMALL_WB_SETTINGS = dict(SMALL_SETTINGS, wideband=True, small_wb=True,
                         err_scale=0.5, mjd_start=54180.0,
                         mjd_end=55914.9375)

_GROUP = {  # (receiver, backend) -> (-f flag, sub-band MHz, error us)
    ("430", "ASP"): ("ASP_430", (422.0, 3.0), 0.7),
    ("L-wide", "ASP"): ("ASP_L-wide", (1150.0, 75.0), 1.0),
    ("430", "PUPPI"): ("PUPPI_430", (422.0, 3.0), 0.5),
    ("L-wide", "PUPPI"): ("PUPPI_L-wide", (1150.0, 75.0), 0.8),
}
#: J1909-3744's receivers and backends at the GBT
_GROUP_J1909 = {
    ("Rcvr_800", "GASP"): ("Rcvr_800_GASP", (730.0, 20.0), 0.35),
    ("Rcvr1_2", "GASP"): ("Rcvr1_2_GASP", (1150.0, 75.0), 0.45),
    ("Rcvr_800", "GUPPI"): ("Rcvr_800_GUPPI", (730.0, 20.0), 0.15),
    ("Rcvr1_2", "GUPPI"): ("Rcvr1_2_GUPPI", (1150.0, 75.0), 0.2),
}
_NOISE_J1909 = {  # -f group -> (EFAC, EQUAD us); no ECORR, no red noise
    "Rcvr_800_GASP": (1.06, 0.12),
    "Rcvr1_2_GASP": (1.04, 0.15),
    "Rcvr_800_GUPPI": (1.09, 0.05),
    "Rcvr1_2_GUPPI": (1.02, 0.07),
}
_NOISE = {  # -f group -> (EFAC, EQUAD us, ECORR us)
    "ASP_430": (1.08, 0.21, 0.62),
    "ASP_L-wide": (1.05, 0.33, 0.48),
    "PUPPI_430": (1.12, 0.11, 0.35),
    "PUPPI_L-wide": (1.02, 0.17, 0.29),
}


def _j1909(s) -> bool:
    return s.get("pulsar") == "J1909-3744"


def _gbt(s) -> bool:
    """Timed at the GBT with J1909-3744's receivers and backends."""
    return s.get("pulsar") in ("J1909-3744", "J0023+0923")


def _site(s) -> str:
    return "gbt" if _gbt(s) else "pks" if s.get("pulsar") == "J0835-4510" \
        else "ao"


def _ngc(s) -> bool:
    return s.get("pulsar") == "NGC6440E"


#: the DD family's small-stand-in binary lines, by ``binary`` setting:
#: BT (no Shapiro delay; ECC 0.17 and OM fitted), DDS (SHAPMAX =
#: -log(1 - 0.95)) and DDH (STIGMA = SINI / (1 + sqrt(1 - SINI^2)) and H3
#: = Tsun M2 STIGMA^3 of M2 0.3, SINI 0.95), the latter two fitted
_STIGMA = 0.95 / (1.0 + np.sqrt(1.0 - 0.95**2))
_SMALL_BINARY = {
    "BT_piecewise": ["BINARY BT_piecewise", "PB 5.7410", "A1 3.3667",
                     "T0 55000.0", "OM 1.35 1", "ECC 0.17 1",
                     "T0X_0001 55000.0002 1", "A1X_0001 3.36672 1",
                     "XR1_0001 53990.0", "XR2_0001 55000.0",
                     "T0X_0002 54999.9999 1", "A1X_0002 3.36668 1",
                     "XR1_0002 55000.0", "XR2_0002 56010.0"],
    "BT": ["BINARY BT", "PB 5.7410 1", "A1 3.3667 1", "T0 55000.0",
           "OM 1.35 1", "ECC 0.17 1"],
    "DDS": ["BINARY DDS", "PB 5.7410 1", "A1 3.3667 1", "T0 55000.0",
            "OM 1.35", "ECC 1.9e-5", "M2 0.3 1",
            f"SHAPMAX {-np.log(1.0 - 0.95):.12f} 1"],
    "DDH": ["BINARY DDH", "PB 5.7410 1", "A1 3.3667 1", "T0 55000.0",
            "OM 1.35", "ECC 1.9e-5",
            f"H3 {4.925490947000518e-6 * 0.3 * _STIGMA**3:.10e} 1",
            f"STIGMA {_STIGMA:.12f} 1"],
}


def j1713_head(s):
    """J1713+0747-shaped timing (NANOGrav's DDK fits): ecliptic astrometry
    with parallax and proper motion, a DDK binary with KIN/KOM fitted and
    K96 on."""
    return [
        "PSR J1713+0747", "ELONG 256.668695 1", "ELAT 30.700360 1",
        "PMELONG 5.2671 1", "PMELAT -3.442 1", "PX 0.85 1", "ECL IERS2010",
        "POSEPOCH 54978", "F0 218.81184378 1", "F1 -4.0835e-16 1",
        "PEPOCH 54978", "DM 15.917", "FD1 1.2e-5 1", "FD2 -4.0e-6 1",
        "FD3 2.0e-6 1", "JUMP -fe 430 0.0 1", "BINARY DDK",
        "PB 67.8251 1", "A1 32.34242 1", "T0 54303.6", "ECC 7.494e-5 1",
        "OM 176.20 1", "M2 0.286 1", "KIN 71.69 1", "KOM 88.3 1", "K96 Y"]


def b1913_head(s):
    """B1913+16-shaped timing (the Hulse-Taylor pulsar's GR test):
    equatorial astrometry and a DDGR binary with MTOT and M2 fitted."""
    return [
        "PSR B1913+16", "RAJ 19:15:27.99942 1", "DECJ +16:06:27.3868 1",
        "POSEPOCH 54978", "F0 16.940537785677 1", "F1 -2.4733e-15 1",
        "PEPOCH 54978", "DM 168.77", "FD1 1.0e-5 1", "FD2 -4.0e-6 1",
        "FD3 2.0e-6 1", "JUMP -fe 430 0.0 1", "BINARY DDGR",
        "PB 0.322997448918 1", "A1 2.341776 1", "T0 52144.90097844",
        "ECC 0.6171340 1", "OM 292.5445 1", "MTOT 2.828378 1", "M2 1.389 1"]


def ngc_par(s) -> str:
    """``bench.py``'s ``FALLBACK_PAR`` (read from the file, so the two
    stay one text), with ``PHOFF 0 1`` where the settings ask for it."""
    import ast

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    tree = ast.parse(open(bench).read())
    par = next(node.value.value for node in tree.body
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", "") == "FALLBACK_PAR")
    if s.get("phoff"):
        par += "PHOFF 0 1\n"
    return par


def _group_table(s):
    return _GROUP_J1909 if _gbt(s) else _GROUP


def _epochs(s):
    mjds = np.linspace(s["mjd_start"], s["mjd_end"], s["n_epochs"])
    rcvrs, bes = (("Rcvr_800", "Rcvr1_2"), ("GASP", "GUPPI")) if _gbt(s) \
        else (("430", "L-wide"), ("ASP", "PUPPI"))
    out = []
    for i, m in enumerate(mjds):
        rcvr = rcvrs[i % 2]
        be = bes[0] if m < s["backend_switch_mjd"] else bes[1]
        out.append((m, rcvr, be))
    return out


def wideband_tim(s) -> str:
    """FORMAT 1 tim text of the full-width wideband stand-in: at each
    epoch one TOA per receiver, the L-wide one 0.05 d after the 430 MHz
    one, at the band's centre, its error the group's times a seeded factor
    0.5-1.5 (so that EFAC and EQUAD are told apart)."""
    rng = np.random.default_rng(s["seed"] + 4)
    lines = ["FORMAT 1\n"]
    mjds = np.linspace(s["mjd_start"], s["mjd_end"], s["n_epochs"])
    for i, m in enumerate(mjds):
        be = "ASP" if m < s["backend_switch_mjd"] else "PUPPI"
        for k, rcvr in enumerate(("430", "L-wide")):
            flag, (f0, df), err = _GROUP[(rcvr, be)]
            e = err * rng.uniform(0.5, 1.5) * s["err_scale"]
            lines.append(f"w{i:04d}_{k} {f0 + 4 * df:.3f} {m + 0.05 * k:.15f} "
                         f"{e:.3f} ao -f {flag} -fe {rcvr} -be {be}\n")
    return "".join(lines)


def standin_tim(s) -> str:
    """FORMAT 1 tim text: ``n_subbands`` TOAs per epoch, ``subband_dt_s``
    apart (all within 1 s, so ECORR groups each epoch); the full-width
    wideband stand-in's is :func:`wideband_tim`."""
    if s.get("wideband") and s.get("n_subbands") == 1:
        return wideband_tim(s)
    lines = ["FORMAT 1\n"]
    spread = 9 // s["n_subbands"]
    site = _site(s)
    rng = np.random.default_rng(s["seed"] + 5)
    for i, (m, rcvr, be) in enumerate(_epochs(s)):
        flag, (f0, df), err = _group_table(s)[(rcvr, be)]
        for j in range(s["n_subbands"]):
            freq = f0 + df * j * spread
            mjd = m + j * s["subband_dt_s"] / 86400.0
            e = (err + 0.1 * (j % 3)) * s["err_scale"]
            if s.get("err_spread"):
                e *= 10.0 ** rng.uniform(-s["err_spread"], s["err_spread"])
            lines.append(f"t{i:04d}_{j} {freq:.3f} {mjd:.15f} {e:.3f} {site} "
                         f"-f {flag} -fe {rcvr} -be {be}\n")
    return "".join(lines)


def _groups(s):
    return sorted({_group_table(s)[(r, b)][0] for _, r, b in _epochs(s)})


def _dmx_lines(s, rng):
    if not s["n_dmx"]:
        return []
    lines = [f"DMX {s['dmx_days']:.1f}"]
    lo = s["mjd_start"] - 0.5
    for k in range(s["n_dmx"]):
        r1 = lo + k * s["dmx_days"]
        r2 = r1 + s["dmx_days"] if k < s["n_dmx"] - 1 \
            else max(r1 + s["dmx_days"], s["mjd_end"] + 1.0)
        lines += [f"DMX_{k + 1:04d} {rng.normal(0.0, 5e-4):.8e} 1",
                  f"DMXR1_{k + 1:04d} {r1:.4f}", f"DMXR2_{k + 1:04d} {r2:.4f}"]
    return lines


def j1909_par(s) -> str:
    """Par text shaped like NANOGrav's J1909-3744 in its first years of
    timing, before a noise model is fitted: an ELL1 binary with M2/SINI
    (ELL1H with H3/STIGMA where the settings ask for it),
    ecliptic astrometry, DMX windows over the span, FD1-3, a receiver JUMP
    and EFAC/EQUAD per ``-f`` group, no ECORR and no red noise.  With
    ``empty_jump`` one more JUMP selects no TOA."""
    head = [
        "PSR J1909-3744", "ELONG 284.2091 1", "ELAT -15.1557 1",
        "PMELONG -13.86 1", "PMELAT -34.38 1", "PX 0.88 1", "ECL IERS2010",
        "POSEPOCH 55000", "F0 339.31568732 1", "F1 -1.6148e-15 1",
        "PEPOCH 55000", "DM 10.3912", "FD1 1.2e-5 1", "FD2 -4.0e-6 1",
        "FD3 2.0e-6 1", "JUMP -fe Rcvr_800 0.0 1", "BINARY ELL1",
        "PB 1.533449474 1", "A1 1.8979911 1", "TASC 53113.95",
        "EPS1 2.6e-8 1", "EPS2 -1.0e-7 1",
    ] + _shapiro_lines(s, 0.2067, 0.99807)
    if s.get("empty_jump"):
        head.append("JUMP -fe Rcvr_342 0.0 1")
    rng = np.random.default_rng(s["seed"] + 1)
    lines = head + _dmx_lines(s, rng)
    for g in _groups(s):
        efac, equad = _NOISE_J1909[g]
        lines += [f"EFAC -f {g} {efac}",
                  f"EQUAD -f {g} {equad * s['err_scale']:.6g}"]
    lines += ["UNITS TDB"]
    if s.get("binary") == "ELL1H":
        lines = ["BINARY ELL1H" if ln == "BINARY ELL1" else ln
                 for ln in lines]
    return "\n".join(lines) + "\n"


def _shapiro_lines(s, m2: float, sini: float):
    """M2/SINI, or for ``binary="ELL1H"`` the orthometric STIGMA = SINI /
    (1 + sqrt(1 - SINI^2)) and H3 = Tsun M2 STIGMA^3 (Freire & Wex 2010)
    with the binary line changed to match."""
    if s.get("binary") != "ELL1H":
        return [f"M2 {m2} 1", f"SINI {sini} 1"]
    stigma = sini / (1.0 + np.sqrt(1.0 - sini * sini))
    h3 = 4.925490947000518e-6 * m2 * stigma**3
    return [f"H3 {h3:.10e} 1", f"STIGMA {stigma:.12f} 1"]


def bw_par(s) -> str:
    """Par text shaped like J0023+0923, a black widow timed with an
    orbital-frequency ladder: ecliptic astrometry, an ELL1 binary with
    FB0..FB3 in place of PB (or, with ``orbwaves``, FB0, FB1 and that many
    fitted ORBWAVES C/S pairs), DMX windows, FD1-3, a receiver JUMP and
    EFAC/EQUAD per ``-f`` group."""
    head = [
        "PSR J0023+0923", "ELONG 9.2063 1", "ELAT 6.3090 1",
        "PMELONG -12.5 1", "PMELAT -5.6 1", "PX 0.8 1", "ECL IERS2010",
        "POSEPOCH 55000", "F0 327.84701549 1", "F1 -1.2283e-15 1",
        "PEPOCH 55000", "DM 14.328", "FD1 1.2e-5 1", "FD2 -4.0e-6 1",
        "FD3 2.0e-6 1", "JUMP -fe Rcvr_800 0.0 1", "BINARY ELL1",
        "FB0 8.338951e-05 1", "FB1 -4.0e-20 1", "A1 0.034841 1",
        "TASC 55000.1", "EPS1 1.5e-5 1", "EPS2 -2.0e-5 1"]
    nw = s.get("orbwaves", 0)
    if nw:
        head += _orbwave_lines(nw, 2.0 * np.pi / (1620.0 * 86400.0), 2e-4)
    else:
        head += ["FB2 1.0e-28 1", "FB3 -2.0e-36 1"]
    rng = np.random.default_rng(s["seed"] + 1)
    lines = head + _dmx_lines(s, rng)
    for g in _groups(s):
        efac, equad = _NOISE_J1909[g]
        lines += [f"EFAC -f {g} {efac}",
                  f"EQUAD -f {g} {equad * s['err_scale']:.6g}"]
    return "\n".join(lines + ["UNITS TDB"]) + "\n"


def _orbwave_lines(nw: int, om: float, amp: float):
    """ORBWAVES: ``nw`` fitted C/S pairs of decreasing amplitude about
    MJD 55000."""
    lines = [f"ORBWAVE_OM {om:.10e}", "ORBWAVE_EPOCH 55000"]
    for k in range(nw):
        a = amp / (k + 1)
        lines += [f"ORBWAVEC{k} {a * 0.8:.6e} 1",
                  f"ORBWAVES{k} {-a * 0.6:.6e} 1"]
    return lines


def _swx_lines(s):
    """One SWX window a conjunction year (the Sun at J1713+0747's
    ecliptic longitude about MJD 53345 + 365.25 k), 120 d wide, over the
    span: SWXDM fitted, SWXP 2 frozen (at J1713+0747's elongations, 30
    deg and more, SWXP's design column is ~1e-6 s per unit index against
    ~1 us errors, and the reference's GLS fit steps it below 1, where
    I_inf has no value)."""
    lines = []
    k = 0
    for c in 53345.0 + 365.25 * np.arange(12):
        r1, r2 = c - 60.0, c + 60.0
        if r2 < s["mjd_start"] or r1 > s["mjd_end"]:
            continue
        k += 1
        lines += [f"SWXDM_{k:04d} {2e-4 * (1 + 0.1 * k):.6e} 1",
                  f"SWXP_{k:04d} 2.0", f"SWXR1_{k:04d} {r1:.4f}",
                  f"SWXR2_{k:04d} {r2:.4f}"]
    return lines


def pta_lines(s):
    """The EPTA-DR2-style chromatic and solar-wind terms of the pta
    stand-in: CM/CM1 about CMEPOCH with TNCHROMIDX 4, PLDMNoise and
    PLChromNoise (30 modes each), SWX windows, FDJUMP and FDJUMPDM on
    PUPPI_L-wide."""
    return ["CM 0.0 1", "CM1 0.0 1", "CMEPOCH 54978", "TNCHROMIDX 4",
            "TNDMAMP -13.6", "TNDMGAM 2.5", "TNDMC 30",
            "TNCHROMAMP -14.2", "TNCHROMGAM 2.8", "TNCHROMC 30",
            "FD1JUMP -f PUPPI_L-wide 2.0e-7 1",
            "FDJUMPDM -f PUPPI_L-wide 1.0e-4 1"] + _swx_lines(s)


def small_pta_lines():
    """The small stand-in's solar-wind and Fourier-basis terms: SWM 1
    NE_SW with NE_SW1 fitted about SWEPOCH and SWP 2.2, PLSWNoise, three CMX
    windows, two WaveX, DMWaveX and CMWaveX terms each (the CM ones
    frozen: with DMX they would leave the chromatic directions barely
    constrained at two observing bands) and a DMJUMP (the delay JUMP is
    added to the model as a component)."""
    lines = ["NE_SW 8.0 1", "NE_SW1 0.4 1", "SWM 1", "SWP 2.2",
             "SWEPOCH 55000", "TNSWAMP -7.0", "TNSWGAM 1.5", "TNSWC 10",
             "TNCHROMIDX 4", "DMJUMP -fe 430 0.0"]
    for k, (r1, r2) in enumerate(((53999.0, 54600.0), (54600.5, 55300.0),
                                  (55300.5, 56001.0)), start=1):
        lines += [f"CMX_{k:04d} {1e-4 * k:.6e}", f"CMXR1_{k:04d} {r1}",
                  f"CMXR2_{k:04d} {r2}"]
    for pre, amp, fit in (("WX", 2e-7, " 1"), ("DMWX", 2e-4, " 1"),
                          ("CMWX", 1e-4, "")):
        lines.append(f"{pre}EPOCH 55000")
        for k, f in enumerate((1.0 / 900.0, 1.0 / 450.0), start=1):
            lines += [f"{pre}FREQ_{k:04d} {f:.10f}",
                      f"{pre}SIN_{k:04d} {amp / k:.6e}{fit}",
                      f"{pre}COS_{k:04d} {-amp / (2 * k):.6e}{fit}"]
    return lines


def small_wb_lines():
    """The small wideband stand-in's DM terms: SWM 1 NE_SW and SWP 2.2,
    SWX windows about the two conjunctions of the span's middle (SWXDM
    fitted), two DMWaveX terms, FDJUMPDM on ASP_L-wide and a DMJUMP on the
    430 MHz receiver, all fitted."""
    lines = ["NE_SW 8.0 1", "SWM 1", "SWP 2.2", "DMJUMP -fe 430 0.0 1",
             "FDJUMPDM -f ASP_L-wide 1.0e-4 1", "DMWXEPOCH 55000"]
    for k, c in enumerate((54555.25, 54920.5), start=1):
        lines += [f"SWXDM_{k:04d} {2e-4 * k:.6e} 1", f"SWXP_{k:04d} 2.0",
                  f"SWXR1_{k:04d} {c - 60.0:.4f}",
                  f"SWXR2_{k:04d} {c + 60.0:.4f}"]
    for k, f in enumerate((1.0 / 900.0, 1.0 / 450.0), start=1):
        lines += [f"DMWXFREQ_{k:04d} {f:.10f}",
                  f"DMWXSIN_{k:04d} {2e-4 / k:.6e} 1",
                  f"DMWXCOS_{k:04d} {-1e-4 / k:.6e} 1"]
    return lines


def _wideband_noise_lines(s):
    """DMEFAC/DMEQUAD per receiver; at full width EFAC/EQUAD per
    receiver too (in place of the per-group white noise and ECORR) and a
    fitted DMJUMP."""
    lines = ["DMEFAC -fe 430 1.12", "DMEQUAD -fe 430 1.5e-4",
             "DMEFAC -fe L-wide 0.94", "DMEQUAD -fe L-wide 2.5e-4"]
    if s.get("n_subbands") == 1:
        lines += ["EFAC -fe 430 1.09", "EQUAD -fe 430 0.25",
                  "EFAC -fe L-wide 1.04", "EQUAD -fe L-wide 0.3",
                  "DMJUMP -fe 430 0.0 1"]
    return lines


def vela_par(s, full: bool) -> str:
    """Par text shaped like the Vela pulsar (J0835-4510, F0 11.19 Hz) at
    Parkes: equatorial astrometry, a spin-down with F2; at full width two
    glitches (the first with a GLF0D/GLTD recovery), WAVE_OM with 10 WAVE
    pairs and the troposphere on; at small depth a piecewise spin-down
    with IFUNC (SIFUNC from the settings); EFAC/EQUAD per ``-f`` group,
    no correlated noise."""
    lines = ["PSR J0835-4510", "RAJ 08:35:20.61149 1",
             "DECJ -45:10:34.8751 1", "POSEPOCH 55000",
             "F0 11.1893414 1", "F1 -1.5566e-11 1", "F2 1.0e-21 1",
             "PEPOCH 55000", "DM 67.97", "FD1 1.0e-5 1",
             "JUMP -fe L-wide 0.0 1"]
    if full:
        lines += ["GLEP_1 54600.0", "GLPH_1 0.0 1", "GLF0_1 2.5e-5 1",
                  "GLF1_1 -1.0e-13 1", "GLF0D_1 1.0e-7 1", "GLTD_1 12.0 1",
                  "GLEP_2 55900.0", "GLPH_2 0.0 1", "GLF0_2 3.0e-5 1",
                  "GLF1_2 -1.2e-13 1", "WAVEEPOCH 55000",
                  f"WAVE_OM {2.0 * np.pi / 3240.0:.10f}",
                  "CORRECT_TROPOSPHERE Y"]
        rng = np.random.default_rng(s["seed"] + 2)
        for k in range(1, 11):
            a, b = rng.normal(0.0, 2e-3 / k, 2)
            lines.append(f"WAVE{k} {a:.6e} {b:.6e}")
    else:
        lines += ["PWEP_1 55000.0", "PWSTART_1 54600.0", "PWSTOP_1 55400.0",
                  "PWPH_1 0.0 1", "PWF0_1 1.0e-9 1", "PWF1_1 -1.0e-18 1",
                  f"SIFUNC {s.get('sifunc', 2)}"]
        for k, (m, v) in enumerate(((53900.0, 0.0), (54500.0, 2e-4),
                                    (55100.0, -1e-4), (55700.0, 3e-4),
                                    (56100.0, 0.0)), start=1):
            lines.append(f"IFUNC{k} {m} {v:.6e}")
    for g in _groups(s):
        efac, equad, _ = _NOISE[g]
        lines += [f"EFAC -f {g} {efac}",
                  f"EQUAD -f {g} {equad * s['err_scale']:.6g}"]
    return "\n".join(lines + ["UNITS TDB"]) + "\n"


def standin_par(s, full: bool) -> str:
    """Par text: B1855+09-like timing (full width) or the small test
    stand-in (its binary as BT, DDS or DDH where the settings ask), or the
    J1713+0747- or B1913+16-shaped heads (at either width), with DMX
    windows covering the span, EFAC/EQUAD and (but for B1913+16) ECORR per
    group; no red noise where ``rn_modes`` is 0, and a fitted PHOFF where
    the settings ask for it."""
    if s.get("pulsar") == "J1713+0747":
        head = j1713_head(s)
    elif s.get("pulsar") == "B1913+16":
        head = b1913_head(s)
    elif full:
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
        if s.get("binary") in _SMALL_BINARY:
            head = head[:10] + _SMALL_BINARY[s["binary"]]
        if s.get("orbwaves"):
            head += _orbwave_lines(s["orbwaves"],
                                   2.0 * np.pi / (1000.0 * 86400.0), 1e-4)
        if s.get("small_pta"):
            head = ["PSR TSTSW", "RAJ 00:23:16.88 1", "DECJ +09:23:23.86 1"] \
                + head[3:] + small_pta_lines()
        if s.get("small_wb"):
            head = ["PSR TSTWB", "RAJ 00:23:16.88 1", "DECJ +09:23:23.86 1"] \
                + head[3:] + small_wb_lines()
    if s.get("pta"):
        head = head + pta_lines(s)
    if s.get("wideband") and s.get("n_subbands") == 1:
        # two observing frequencies: the FD terms would be the receiver
        # JUMP's direction, so they stay as they are
        head = [ln[:-2] if ln.startswith("FD") else ln for ln in head]
    rng = np.random.default_rng(s["seed"] + 1)
    lines = head + _dmx_lines(s, rng)
    scale = s["err_scale"] * s.get("noise_scale", 1.0)
    for g in _groups(s) if s.get("n_subbands") != 1 else ():
        efac, equad, ecorr = _NOISE[g]
        lines += [f"EFAC -f {g} {efac}",
                  f"EQUAD -f {g} {equad * scale:.6g}"]
        if s.get("pulsar") != "B1913+16":
            lines.append(f"ECORR -f {g} {ecorr * scale:.6g}")
    if s.get("wideband"):
        lines += _wideband_noise_lines(s)
    if s["rn_modes"]:
        lines += [f"TNRedAmp {s.get('rn_amp', -13.8)}", "TNRedGam 3.2",
                  f"TNRedC {s['rn_modes']}"]
    if s.get("phoff"):
        lines.append("PHOFF 0 1")
    lines += ["UNITS TDB"]
    return "\n".join(lines) + "\n"


def make_standin(s, full: bool):
    """(model, toas) of a stand-in, TOAs simulated with seeded white noise
    (``full`` picks the B1855+09 stand-in's full-width par; the
    J1909-3744 settings carry their own)."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import (make_fake_toas_fromtim,
                                     make_fake_toas_uniform)

    if _ngc(s):
        model = get_model(ngc_par(s).splitlines(keepends=True))
        toas = make_fake_toas_uniform(
            s["mjd_start"], s["mjd_end"], s["ntoas"], model,
            error_us=s["error_us"], add_noise=True,
            rng=np.random.default_rng(s["seed"]))
        return model, toas
    if _j1909(s):
        par = j1909_par(s)
    elif s.get("pulsar") == "J0023+0923":
        par = bw_par(s)
    elif s.get("pulsar") == "J0835-4510":
        par = vela_par(s, full)
    else:
        par = standin_par(s, full)
    model = get_model(par.splitlines(keepends=True))
    if s.get("small_pta"):
        _add_delay_jump(model)
    if "PLSWNoise" in model.components:
        _patch_sw_geometry(model)
    with tempfile.TemporaryDirectory() as d:
        tim = os.path.join(d, "standin.tim")
        with open(tim, "w") as fh:
            fh.write(standin_tim(s))
        toas = make_fake_toas_fromtim(
            tim, model, add_noise=True,
            add_correlated_noise=bool(s.get("correlated")),
            rng=np.random.default_rng(s["seed"]))
    if s.get("wideband"):
        _add_wideband_dms(model, toas, s)
    return model, toas


def _add_wideband_dms(model, toas, s) -> None:
    """Each TOA's wideband DM measurement: the model's DM plus seeded noise
    at the DMEFAC/DMEQUAD-scaled error, errors drawn from 1e-4 to 5e-4
    pc/cm^3 (the unit normal draws are the reference's ``update_fake_dms``
    at ``dm_error=1``)."""
    from pint_tpu.simulation import update_fake_dms

    rng = np.random.default_rng(s["seed"] + 3)
    dme = rng.uniform(1e-4, 5e-4, len(toas))
    dm0 = np.asarray(model.total_dm(toas))
    update_fake_dms(model, toas, dm_error=1.0, add_noise=True, rng=rng)
    z = np.asarray(toas.get_dms()) - dm0
    toas.update_dms(dm0, dme)
    toas.update_dms(dm0 + z * model.scaled_dm_uncertainty(toas), dme)


def free_noise(model, prefixes) -> list:
    """Unfreeze the set noise parameters whose names start with one of
    ``prefixes`` (a whole-name match for the unindexed ones); returns
    their names."""
    out = []
    for c in model.noise_components:
        for p in c.params:
            par = c._params_dict[p]
            if par.value is None:
                continue
            if any(p == q or (p.startswith(q) and p[len(q):].isdigit())
                   for q in prefixes):
                par.frozen = False
                out.append(p)
    return out


def _add_delay_jump(model):
    """A tempo-style delay JUMP2 on the TOAs after MJD 55000 (the reference's
    model builder maps JUMP lines to phase jumps, so the DelayJump
    component is added as a component; JUMP1 is the phase jump's)."""
    from pint_tpu.models.jump import DelayJump

    from pint_tpu.models.parameter import maskParameter

    dj = DelayJump()
    dj.remove_param("JUMP1")  # the phase JUMP holds that name
    dj.add_param(maskParameter("JUMP", index=2, key="mjd",
                               key_value=["55000", "56100"], value=3.0e-6,
                               frozen=False, units="s"))
    model.add_component(dj)
    dj.setup()
    model.setup()


def _patch_sw_geometry(model):
    """PLSWNoise's basis reads ``SolarWindDispersion.solar_wind_geometry``
    (``noise_model.py:569``), which the reference package does not define;
    this gives the reference model's component that method -- the geometry
    of its own SWM at n_earth = 1 cm^-3, from its own functions -- so that
    the reference can build the basis (ROADMAP.md queue C)."""
    from pint_tpu.models import solar_wind as sw_mod

    sw = model.components["SolarWindDispersion"]

    def solar_wind_geometry(pv, batch):
        theta, r = sw._theta_r(pv, batch)
        if int(sw.SWM.value or 0) == 0:
            return sw_mod.solar_wind_geometry_spherical(r, theta)
        return sw_mod.solar_wind_geometry_pl(r, theta, pv.get("SWP", 2.0))

    sw.solar_wind_geometry = solar_wind_geometry


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
    if name in ("AstrometryEquatorial", "AstrometryEcliptic"):
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
        out = {"nfb": comp._nfb, "nwaves": comp._nwaves}
        if name == "BinaryBT_piecewise":
            out["piece_indices"] = list(comp.piece_indices)
        return out
    if name in ("PLRedNoise", "PLDMNoise", "PLChromNoise", "PLSWNoise"):
        amp, gam, n_lin, n_log, fmr = comp.get_plc_vals()
        tsp = comp._plc[5]
        ts = None if tsp is None else comp._params_dict[tsp].value
        return {"amp": float(amp), "gam": float(gam), "n_lin": int(n_lin),
                "n_log": n_log, "f_min_ratio": float(fmr),
                "tspan_s": None if ts is None else float(ts) * 365.25 * 86400}
    if name == "SolarWindDispersion":
        return {"num_ne_sw_terms": comp.num_ne_sw_terms,
                "swm": int(comp.SWM.value or 0),
                "has_swepoch": comp.SWEPOCH.value is not None}
    if name == "SolarWindDispersionX":
        return {"swx_indices": list(comp.swx_indices)}
    if name == "ChromaticCM":
        return {"num_cm_terms": comp.num_cm_terms,
                "has_cmepoch": comp.CMEPOCH.value is not None}
    if name == "ChromaticCMX":
        return {"cmx_indices": list(comp.cmx_indices)}
    if name == "DispersionJump":
        return {"dm_jumps": list(comp.dm_jumps)}
    if name == "FDJumpDM":
        return {"fdjump_dms": list(comp.fdjump_dms)}
    if name in ("FDJump", "DelayJump"):
        return {("fdjumps" if name == "FDJump" else "jumps"):
                list(comp.fdjumps if name == "FDJump" else comp.jumps)}
    if name in ("WaveX", "DMWaveX", "CMWaveX"):
        return {"indices": list(comp.indices)}
    if name == "Glitch":
        return {"glitch_indices": list(comp.glitch_indices)}
    if name == "Wave":
        return {"num_wave_terms": comp.num_wave_terms}
    if name == "PiecewiseSpindown":
        return {"pw_indices": list(comp.pw_indices)}
    if name == "IFunc":
        return {"sifunc": int(comp.SIFUNC.value)}
    return {}


def _param_entry(name, comp_name, par):
    from pint_tpu.dd import dd_from_longdouble
    from pint_tpu.models.parameter import (MJDParameter, boolParameter,
                                           intParameter, maskParameter,
                                           pairParameter, strParameter)

    v = par.value
    if isinstance(par, pairParameter):
        kind = "pair"
        if v is not None:
            v = [float(v[0]), float(v[1])]
    elif isinstance(par, MJDParameter):
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


def _export_tzr(model, arrays) -> None:
    """The TZR TOA of an absolute phase as a one-row batch under ``tzr/``,
    with each component's context for it under ``tzr/ctx/``: the
    reference builds the row on the host (``get_TZR_toas``), the port
    reads it."""
    tzr = model.components["AbsPhase"].get_TZR_toas(model)
    b = tzr.to_batch()
    arrays.update({
        "tzr/tdb_hi": np.asarray(b.tdb.hi), "tzr/tdb_lo": np.asarray(b.tdb.lo),
        "tzr/tdb0": np.asarray(float(b.tdb0)),
        "tzr/tdb_s_hi": np.asarray(b.tdb_s.hi),
        "tzr/tdb_s_lo": np.asarray(b.tdb_s.lo),
        "tzr/freq": np.asarray(b.freq), "tzr/error_us": np.asarray(b.error_us),
        "tzr/ssb_obs_pos": np.asarray(b.ssb_obs_pos),
        "tzr/ssb_obs_vel": np.asarray(b.ssb_obs_vel),
        "tzr/obs_sun_pos": np.asarray(b.obs_sun_pos),
        "tzr/mjds": np.asarray(tzr.get_mjds(), dtype=np.float64)})
    for k, v in b.planet_pos.items():
        arrays[f"tzr/planet_pos/{k}"] = np.asarray(v)
    for name, comp in model.components.items():
        if getattr(comp, "kind", "") != "noise":
            _flatten(f"tzr/ctx/{name}", comp.build_context(tzr), arrays)


def export_state(model, toas) -> dict:
    """The snapshot arrays (with ``meta`` JSON) of a model and its TOAs,
    without reference outputs; ``meta["top_level"]`` holds the model's own
    parameters and the TOAs' ephemeris (:func:`top_level_meta`)."""
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
    if toas.wideband:
        arrays["dm"] = np.asarray(toas.get_dms(), dtype=np.float64)
        arrays["dm_error"] = np.asarray(toas.get_dm_errors(),
                                        dtype=np.float64)
    for k, v in b.planet_pos.items():
        arrays[f"planet_pos/{k}"] = np.asarray(v)
    if "AbsPhase" in model.components:
        _export_tzr(model, arrays)
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
        if name in ("PLDMNoise", "PLChromNoise", "PLSWNoise"):
            # the chromatic and solar-wind basis scales, built on the host
            arrays[f"ctx/{name}/scale"] = np.asarray(
                comp._chromatic_scale(model, toas), dtype=np.float64)
    meta = {"format": "pint_torch-snapshot-1", "name": model.PSR.value,
            "components": comps, "params": params,
            "free_params": list(model.free_params),
            "design_params": list(model.design_param_names()),
            "top_level": top_level_meta(model, toas)}
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


def export_snapshot(model, toas, settings: dict, chunk: int = 256,
                    grid: bool = True) -> dict:
    """:func:`export_state` plus the reference's outputs: phase, delay,
    residuals and design matrix at the snapshot's values; the post-fit
    values, uncertainties and chi2 of ``GLSFitter.fit_toas(maxiter)``; and
    the GLS chi2 grid (``niter``, ``chunk``) after that fit: M2 x SINI, or
    the settings' ``grid`` of :data:`GRIDS` 3 sigma about the fit (its
    parameters named in ``meta["reference"]["grid_params"]``)."""
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
    _auto_outputs(model, toas, design, arrays, ref)
    if grid:
        if settings.get("grid", "m2sini") == "m2sini":
            gnames = ("M2", "SINI")
            axes = grid_axes(model, settings["grid_points"])
        else:
            gnames, axes = wls_grid_axes(f, settings)
            ref["grid_params"] = list(gnames)
        c2, _ = grid_chisq(f, gnames, axes, niter=settings["grid_niter"],
                           chunk=chunk)
        for g, a in zip(gnames, axes):
            arrays[f"ref/grid_{g.lower()}"] = a
        arrays["ref/grid_chi2"] = np.asarray(c2)
        arrays["ref/grid_rungs"] = np.asarray(
            f.last_grid_diagnostics["ladder_rung"])
        ref["grid_argmin"] = [int(i) for i in np.unravel_index(
            int(np.nanargmin(c2)), c2.shape)]
        ref["grid_chunk"] = int(chunk)
    meta["reference"] = ref
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


def _fit_outputs(fitter, design, prefix, arrays):
    """Store a fit's post-fit values and uncertainties of ``design``."""
    arrays[f"ref/{prefix}_values"] = np.array(
        [float(getattr(fitter.model, p).value) for p in design])
    arrays[f"ref/{prefix}_uncertainties"] = np.array(
        [float(getattr(fitter.model, p).uncertainty) for p in design])


def _counted_steps(fitter):
    """Count the fitter's downhill steps (its ``_solve_step`` calls) on
    ``fitter.steps``: the reference keeps no such count."""
    fitter.steps = 0
    solve = fitter._solve_step

    def counted():
        fitter.steps += 1
        return solve()

    fitter._solve_step = counted
    return fitter


def _auto_outputs(model, toas, design, arrays, ref):
    """``Fitter.auto(toas, model).fit_toas()`` from the snapshot's values:
    the class chosen, chi2, values, uncertainties, converged flag, downhill
    steps and, for a GLS fitter, the noise amplitudes by component.  Where
    the settings' ``noise_free`` frees noise parameters for this fit (its
    alternation of timing and noise fits), also each noise fit's values,
    L-BFGS-B iterations and evaluations, converged flag and lnlike, and
    the noise parameters' final values and uncertainties."""
    import copy

    from pint_tpu.fitter import Fitter

    prefixes = ref["settings"].get("noise_free")
    if prefixes:
        model = copy.deepcopy(model)
        ref["auto_noise_params"] = free_noise(model, prefixes)
    f = _counted_steps(Fitter.auto(toas, model))
    rounds = _recorded_noise_fits(f) if prefixes else []
    ref["auto_fitter"] = type(f).__name__
    if not _downhill_fit(f, {}, design, "auto", arrays, ref):
        return
    ref["auto_converged"] = bool(f.converged)
    ref["auto_iterations"] = int(f.steps)
    for comp, a in (getattr(f.resids, "noise_ampls", None) or {}).items():
        arrays[f"ref/auto_noise_ampls/{comp}"] = np.asarray(a)
    if not prefixes:
        return
    res = rounds[-1][0]
    ref["auto_noise_names"] = list(res.names)
    ref["auto_noise_rounds"] = [
        {"nit": int(nit), "nfev": int(nfev), "converged": bool(r.converged),
         "lnlike": float(r.lnlike), "message": str(r.message)}
        for r, nit, nfev in rounds]
    for i, (r, _, _) in enumerate(rounds):
        arrays[f"ref/auto_noise_round{i}_values"] = np.asarray(r.values)
    arrays["ref/auto_noise_values"] = np.array(
        [float(getattr(f.model, p).value) for p in res.names])
    arrays["ref/auto_noise_uncertainties"] = np.asarray(res.errors)


def _recorded_noise_fits(fitter) -> list:
    """Record each of the fitter's noise fits as (result, L-BFGS-B
    iterations, likelihood evaluations): the reference's result keeps
    neither count, so scipy's is read around the call."""
    import scipy.optimize as opt

    rounds = []
    fit_noise = fitter.fit_noise

    def recorded(**kw):
        minimize, seen = opt.minimize, []

        def spy(*a, **k):
            seen.append(minimize(*a, **k))
            return seen[-1]

        opt.minimize = spy
        try:
            res = fit_noise(**kw)
        finally:
            opt.minimize = minimize
        rounds.append((res, seen[-1].nit, seen[-1].nfev))
        return res

    fitter.fit_noise = recorded
    return rounds


def export_wideband_snapshot(model, toas, settings: dict) -> dict:
    """:func:`export_state` plus the reference's wideband outputs: TOA and
    DM residuals, the model's DM, the scaled DM errors, both design
    matrices and the joint chi2 at the snapshot's values; chi2, values and
    uncertainties of ``WidebandTOAFitter.fit_toas(maxiter)`` (``postfit``),
    the same with ``full_cov=True`` (``full_cov``),
    ``WidebandDownhillFitter.fit_toas()`` (``downhill``) and
    ``WidebandLMFitter.fit_toas()`` (``lm``), the last two with their
    converged flags, each from the snapshot's values; and
    ``Fitter.auto``'s fit (:func:`_auto_outputs`)."""
    from pint_tpu.wideband import (WidebandDownhillFitter, WidebandLMFitter,
                                   WidebandTOAFitter, WidebandTOAResiduals)

    arrays = export_state(model, toas)
    meta = json.loads(str(arrays["meta"]))
    wr = WidebandTOAResiduals(toas, model)
    arrays["ref/time_resids"] = np.asarray(wr.toa.time_resids)
    arrays["ref/dm_resids"] = np.asarray(wr.dm.resids)
    arrays["ref/total_dm"] = np.asarray(model.total_dm(toas))
    arrays["ref/scaled_dm_uncertainty"] = np.asarray(
        model.scaled_dm_uncertainty(toas))
    M, names, _ = model.designmatrix(toas)
    arrays["ref/designmatrix"] = np.asarray(M)
    arrays["ref/dm_designmatrix"] = np.asarray(model.dm_designmatrix(toas)[0])
    design = list(model.design_param_names())
    ref = {"designmatrix_names": list(names), "postfit_params": design,
           "combined_chi2": float(wr.calc_chi2()), "settings": dict(settings)}
    maxiter = settings["fit_maxiter"]
    for key, cls, kw in (
            ("postfit", WidebandTOAFitter, {"maxiter": maxiter}),
            ("full_cov", WidebandTOAFitter, {"maxiter": maxiter,
                                             "full_cov": True}),
            ("downhill", WidebandDownhillFitter, {}),
            ("lm", WidebandLMFitter, {})):
        f = cls(toas, model)
        if _downhill_fit(f, kw, design, key, arrays, ref) \
                and key in ("downhill", "lm"):
            ref[f"{key}_converged"] = bool(f.converged)
    _auto_outputs(model, toas, design, arrays, ref)
    meta["reference"] = ref
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


#: the Kepler snapshot's settings: per core ``n`` seeded orbits, e from 0
#: to 0.95, the first exactly circular
KEPLER_SETTINGS = dict(seed=20261017, n=48)
#: each Kepler core's elements after its orbit's (a, pb, eps1, eps2)
KEPLER_CORES = {"2d": ("t0",), "3d": ("i", "lan", "t0"),
                "two_body": ("i", "lan", "q", "x_cm", "y_cm", "z_cm",
                             "vx_cm", "vy_cm", "vz_cm", "tasc")}


def kepler_inputs(s) -> dict:
    """{core: (n, len(elements) + 1) inputs}: a, pb, eps1, eps2, the
    core's other elements, then t; seeded, e uniform in [0, 0.95] and the
    first orbit exactly circular."""
    rng = np.random.default_rng(s["seed"])
    n = s["n"]
    out = {}
    for core, extra in KEPLER_CORES.items():
        e = rng.uniform(0.0, 0.95, n)
        e[0] = 0.0
        om = rng.uniform(0.0, 2 * np.pi, n)
        cols = [rng.uniform(1.0, 30.0, n), rng.uniform(0.1, 60.0, n),
                e * np.sin(om), e * np.cos(om)]
        lo_hi = {"i": (0.0, np.pi), "lan": (0.0, 2 * np.pi), "q": (0.05, 1.5),
                 "t0": (-20.0, 20.0), "tasc": (-20.0, 20.0)}
        cols += [rng.uniform(*lo_hi.get(x, (-5.0, 5.0)), n) for x in extra]
        cols.append(rng.uniform(-500.0, 500.0, n))
        out[core] = np.stack(cols, axis=1)
    return out


def export_kepler(s) -> dict:
    """The reference's Kepler cores on :func:`kepler_inputs`: per core
    ``<core>/inputs``, ``<core>/values`` and ``<core>/jacobian``, with the
    settings as JSON under ``settings``."""
    from pint_tpu.orbital import kepler as K

    fns = {"2d": (K.kepler_2d, K.Kepler2DParameters),
           "3d": (K.kepler_3d, K.Kepler3DParameters),
           "two_body": (K.kepler_two_body, K.KeplerTwoBodyParameters)}
    arrays = {"settings": np.asarray(json.dumps(s))}
    for core, x in kepler_inputs(s).items():
        fn, params = fns[core]
        vals, jacs = zip(*(fn(params(*row[:-1]), row[-1]) for row in x))
        arrays[f"{core}/inputs"] = x
        arrays[f"{core}/values"] = np.stack(vals)
        arrays[f"{core}/jacobian"] = np.stack(jacs)
    return arrays


def _downhill_fit(f, kw, design, key, arrays, ref) -> bool:
    """``f.fit_toas(**kw)`` into ``ref[key + "_chi2"]`` and the arrays;
    a downhill fit that cannot lower chi2 from where it starts raises
    :class:`StepProblem` in the reference, and that is its output:
    ``ref[key + "_error"]`` holds the class and message (False
    returned)."""
    from pint_tpu.exceptions import StepProblem

    try:
        ref[f"{key}_chi2"] = float(f.fit_toas(**kw))
    except StepProblem as e:
        ref[f"{key}_error"] = f"StepProblem: {e}"
        return False
    _fit_outputs(f, design, key, arrays)
    return True


def _huber_outputs(model, toas, design, arrays, ref):
    """Both WLS fitters' ``fit_toas(robust="huber")`` from the snapshot's
    values (``WLSFitter`` at the settings' ``maxiter``): chi2, values,
    uncertainties, the Huber weights and the IRLS rounds."""
    from pint_tpu.fitter import DownhillWLSFitter, WLSFitter

    for key, cls, kw in (("huber", WLSFitter,
                          {"maxiter": ref["settings"]["fit_maxiter"]}),
                         ("huber_downhill", DownhillWLSFitter, {})):
        f = cls(toas, model)
        if _downhill_fit(f, dict(robust="huber", **kw), design, key, arrays,
                         ref):
            ref[f"{key}_iterations"] = int(f.robust_iterations)
            arrays[f"ref/{key}_weights"] = np.asarray(f.robust_weights)


#: the grids that sweep two parameters 3 sigma about the fit, by the
#: settings' ``grid``
GRIDS = {"h3stigma": ("H3", "STIGMA"), "kinkom": ("KIN", "KOM"),
         "mtotm2": ("MTOT", "M2"), "fb0fb1": ("FB0", "FB1"),
         "glitch": ("GLF0D_1", "GLTD_1")}
#: grid parameters whose axis stays positive: its lower end at least a
#: tenth of the fitted value (a glitch's recovery time)
POSITIVE = ("GLTD_1",)


def wls_grid_axes(fitter, settings):
    """The grid of a stand-in after ``fitter``'s fit, as (names, axes):
    ``grid_axes``' M2 x SINI about the snapshot's values; F0 x F1 as
    ``bench.py:1617-1623`` sets it, 3 sigma scaled by sqrt(reduced chi2)
    about the fit; H3 x STIGMA, KIN x KOM and MTOT x M2 (:data:`GRIDS`),
    3 sigma about the fit."""
    n = settings["grid_points"]
    kind = settings.get("grid", "m2sini")
    if kind == "m2sini":
        return ("M2", "SINI"), grid_axes(fitter.model_init, n)
    m = fitter.model
    if kind == "f0f1":
        escale = max(1.0, np.sqrt(fitter.resids.reduced_chi2))
        names = ("F0", "F1")
        spans = (3 * escale * fitter.errors.get("F0", 1e-10),
                 3 * escale * fitter.errors.get("F1", 1e-18))
    else:
        names = GRIDS[kind]
        spans = tuple(3 * fitter.errors[p] for p in names)
    return names, tuple(np.linspace(
        max(getattr(m, p).value - d, 0.1 * getattr(m, p).value)
        if p in POSITIVE else getattr(m, p).value - d,
        getattr(m, p).value + d, n) for p, d in zip(names, spans))


def reference_wls_grid(fitter, axes, niter: int, chunk: int,
                       names=("M2", "SINI")):
    """The reference's WLS chi2 grid of ``names`` over the outer product
    of ``axes`` after ``fitter``'s fit: ``(chi2, rungs)``, grid-shaped.
    Its ``build_grid_chi2_fn`` runs ``chunk`` points per call (memory
    only: each point's refit is independent of the others)."""
    from pint_tpu.grid import _point_spans, build_grid_chi2_fn

    model, toas = fitter.model, fitter.toas
    shape = tuple(len(a) for a in axes)
    pts = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                   axis=-1)
    fn, _, _ = build_grid_chi2_fn(
        model, toas, tuple(names), niter=niter,
        grid_spans=_point_spans(model, tuple(names), pts))
    c2, dg = [], []
    for i in range(0, len(pts), chunk):
        out = fn(pts[i:i + chunk])
        c2.append(np.asarray(out[0]))
        dg.append(np.asarray(out[2]))
    c2, dg = np.concatenate(c2), np.concatenate(dg)
    return c2.reshape(shape), dg[:, 0].astype(int).reshape(shape)


def export_wls_snapshot(model, toas, settings: dict, chunk: int = 16,
                        grid: bool = True) -> dict:
    """:func:`export_state` plus the reference's WLS outputs: phase,
    delay, residuals and design matrix at the snapshot's values; chi2,
    values and uncertainties of ``WLSFitter.fit_toas(maxiter)``, of
    ``DownhillWLSFitter.fit_toas()`` (with its converged flag) and of
    ``Fitter.auto``'s fit, each from the snapshot's values (and both
    fitters' Huber fits where the settings ask for them); and the WLS chi2
    grid of :func:`wls_grid_axes` (``niter``) after the WLS fit, with each
    point's ladder rung.  Grids other than M2 x SINI name their
    parameters in ``meta["reference"]["grid_params"]`` and store their
    axes as ``ref/grid_<name>``."""
    from pint_tpu.fitter import DownhillWLSFitter, WLSFitter
    from pint_tpu.residuals import Residuals

    arrays = export_state(model, toas)
    meta = json.loads(str(arrays["meta"]))
    ph = model.phase(toas)
    arrays["ref/phase_int"] = np.asarray(ph.int_)
    arrays["ref/phase_frac"] = np.asarray(ph.frac)
    if "AbsPhase" in model.components:
        ph = model.phase(toas, abs_phase=True)
        arrays["ref/abs_phase_int"] = np.asarray(ph.int_)
        arrays["ref/abs_phase_frac"] = np.asarray(ph.frac)
    arrays["ref/delay"] = np.asarray(model.delay(toas))
    arrays["ref/time_resids"] = np.asarray(Residuals(toas, model).time_resids)
    M, names, _ = model.designmatrix(toas)
    arrays["ref/designmatrix"] = np.asarray(M)
    design = list(model.design_param_names())
    f = WLSFitter(toas, model)
    chi2 = float(f.fit_toas(maxiter=settings["fit_maxiter"]))
    _fit_outputs(f, design, "postfit", arrays)
    ref = {"designmatrix_names": list(names), "postfit_params": design,
           "postfit_chi2": chi2, "fitter": "WLSFitter",
           "settings": dict(settings)}
    d = DownhillWLSFitter(toas, model)
    if _downhill_fit(d, {}, design, "downhill", arrays, ref):
        ref["downhill_converged"] = bool(d.converged)
    _auto_outputs(model, toas, design, arrays, ref)
    if settings.get("huber"):
        _huber_outputs(model, toas, design, arrays, ref)
    if grid:
        gnames, axes = wls_grid_axes(f, settings)
        c2, rungs = reference_wls_grid(f, axes, settings["grid_niter"],
                                       chunk, gnames)
        if gnames != ("M2", "SINI"):
            ref["grid_params"] = list(gnames)
        for g, a in zip(gnames, axes):
            arrays[f"ref/grid_{g.lower()}"] = a
        arrays["ref/grid_chi2"] = c2
        arrays["ref/grid_rungs"] = rungs
        ref["grid_argmin"] = [int(i) for i in np.unravel_index(
            int(np.nanargmin(c2)), c2.shape)]
        ref["grid_chunk"] = int(chunk)
    meta["reference"] = ref
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


# ---------------------------------------------------------------------------
# component parity helpers of the CPU tests
# ---------------------------------------------------------------------------
def port_and_reference(settings, full: bool = False):
    """(reference model, reference TOAs, port model, port batch) of a
    stand-in, the port's loaded on the CPU from the reference's exported
    state."""
    from pint_torch.bridge import load_snapshot

    model, toas = make_standin(settings, full=full)
    m, b = load_snapshot(export_state(model, toas), device="cpu")
    return model, toas, m, b


def component_outputs(model, toas, m, b, name):
    """One component's output in both packages, numpy (N,) each: a delay
    component's delay with no delay accumulated before it, or a phase
    component's phase (integer plus fraction) at the model's total
    delay."""
    import torch

    comp, tcomp = model.components[name], m.components[name]
    pv, batch = model._const_pv(), toas.to_batch()
    n = len(toas)
    if tcomp.kind == "delay":
        ref = comp.delay_func(pv, batch, comp.build_context(toas),
                              np.zeros(n))
        got = tcomp.delay_func(m.const_pv(), b, tcomp.build_context(b),
                               torch.zeros((1, n), dtype=torch.float64))
        return (np.broadcast_to(np.asarray(got.detach()), (1, n))[0],
                np.broadcast_to(np.asarray(ref), (n,)))
    delay = model.delay(toas)
    ref = comp.phase_func(pv, batch, comp.build_context(toas), delay)
    got = tcomp.phase_func(m.const_pv(), b, tcomp.build_context(b),
                           torch.tensor(np.array(delay))[None])
    return (np.broadcast_to(np.asarray(got.int_ + got.frac), (1, n))[0],
            np.broadcast_to(np.asarray(ref.int_ + ref.frac), (n,)))


# ---------------------------------------------------------------------------
# the fitter, residuals, model and grid API's reference outputs
# ---------------------------------------------------------------------------
#: what each stand-in's ``ref/api/`` keys hold, by its exporter settings
#: name: ``d_delay`` the parameters of ``d_delay_d_param``; ``post`` the
#: products of the snapshot's first fit (``update_model``'s fields, the
#: labelled covariance, the derived parameters before and after);
#: ``stats`` the residual statistics after it; ``grid`` the tuple and
#: derived grids over (M2, SINI) after it; ``doonefit``; ``state`` the
#: ``ModelState`` flavour whose ``predicted_chi2`` is kept; ``powell``
#: ``PowellFitter``'s ``maxiter`` and its start ("prefit": the snapshot's
#: values scaled by its first fit's uncertainties; "auto": ``Fitter.auto``'s
#: fit); ``full_cov`` the wideband downhill fit with the dense covariance
API = {
    "b1855": dict(d_delay=("M2", "PB", "A1", "FD1", "DMX_0001"), post=True,
                  stats=True, grid=True, state="GLSState"),
    "ell1": dict(d_delay=("EPS1", "A1", "TASC"), post=True, grid=True,
                 doonefit=True, state="WLSState"),
    "ngc": dict(powell=(20, "prefit")),
    "bt": dict(powell=(20, "auto")),
    "bw": dict(d_delay=("FB1",), post=True),
    "pta": dict(d_delay=("SWXDM_0001",)),
    "b1855_wb": dict(post=True, state="WidebandState"),
    "b1855_noise": dict(post=True, stats=True),
    "small_wb": dict(full_cov=True),
}
#: the tuple grid's points and the derived grid's axes
API_TUPLES = 37
API_GRID_POINTS = 16
#: the parameters whose refit values the grids report
API_EXTRA = ("A1", "PB")
#: update_model's fields
UPDATE_MODEL_FIELDS = ("START", "FINISH", "NTOA", "CHI2", "CHI2R", "TRES",
                       "DMRES", "DMDATA", "EPHEM")


def top_level_meta(model, toas) -> dict:
    """The model's own parameters (START and FINISH as (hi, lo) pairs) and
    the TOAs' ephemeris: the snapshot's ``meta["top_level"]``."""
    from pint_tpu.dd import dd_from_longdouble

    out = {}
    for name in model.top_level_params:
        v = getattr(model, name).value
        if v is None or name == "PSR":
            continue
        if name in ("START", "FINISH"):
            d = dd_from_longdouble(np.longdouble(v))
            v = [float(d.hi), float(d.lo)]
        elif isinstance(v, (bool, np.bool_)):
            v = bool(v)
        elif isinstance(v, (int, np.integer)):
            v = int(v)
        elif isinstance(v, (float, np.floating)):
            v = float(v)
        else:
            v = str(v)
        out[name] = v
    if getattr(toas, "ephem", None):
        out["ephem"] = str(toas.ephem)
    return out


def _first_fit(model, toas, settings):
    """The snapshot's first fit, as the exporter and ``chip_smoke.py`` run
    it: ``WidebandTOAFitter``, ``GLSFitter`` or ``WLSFitter`` at the
    settings' ``fit_maxiter``."""
    from pint_tpu.fitter import WLSFitter
    from pint_tpu.gls_fitter import GLSFitter
    from pint_tpu.wideband import WidebandTOAFitter

    cls = WidebandTOAFitter if toas.wideband else GLSFitter \
        if model.has_correlated_errors else WLSFitter
    f = cls(toas, model)
    f.fit_toas(maxiter=settings["fit_maxiter"])
    return f


def api_grid_points(model, errors, seed: int = 11):
    """The tuple grid's (M2, SINI) points, seeded, 3 sigma about the fit
    (SINI kept below 1), and the derived grid's (Mc, cos i) axes, 3 sigma
    about the fit."""
    rng = np.random.default_rng(seed)
    m2, si = float(model.M2.value), float(model.SINI.value)
    # a model that keeps M2 and SINI frozen spans a tenth of M2 and 0.01
    sm, ss = errors.get("M2", 0.1 * m2), errors.get("SINI", 0.01)
    pts = np.stack([m2 + 3 * sm * rng.uniform(-1, 1, API_TUPLES),
                    np.minimum(si + 3 * ss * rng.uniform(-1, 1, API_TUPLES),
                               0.9999)], axis=1)
    ci = np.sqrt(1.0 - si**2)
    sci = si * ss / ci
    mc = np.linspace(m2 - 3 * sm, m2 + 3 * sm, API_GRID_POINTS)
    cosi = np.linspace(max(ci - 3 * sci, 0.01 * ci), ci + 3 * sci,
                       API_GRID_POINTS)
    return pts, mc, cosi


def derived_m2(mc, cosi):
    return mc


def derived_sini(mc, cosi):
    return np.sqrt(1.0 - cosi**2)


def _derived_dict(d, prefix, arrays, ref_api, key):
    """A ``get_derived_params`` dict: values and sigmas as arrays in its key
    order, the keys and ``Binary`` in the meta."""
    keys = [k for k in d if k != "Binary"]
    ref_api[f"{key}_keys"] = keys
    ref_api[f"{key}_binary"] = d.get("Binary")
    arrays[f"{prefix}{key}_values"] = np.array([float(d[k][0]) for k in keys])
    arrays[f"{prefix}{key}_sigmas"] = np.array([float(d[k][1]) for k in keys])


def reference_api_points(f, pts, niter: int):
    """The reference's chi2, rungs and :data:`API_EXTRA` values at the (M2,
    SINI) points ``pts`` after ``f``'s fit: what its ``tuple_chisq`` and
    ``grid_chisq_derived`` compute (``build_grid_chi2_fn`` over the
    points' spans), the WLS grid fed 16 points a call (memory only)."""
    from pint_tpu import grid as G

    names = ("M2", "SINI")
    fn, _, fit_params = G.build_grid_chi2_fn(
        f.model, f.toas, names, niter=niter,
        grid_spans=G._point_spans(f.model, names, pts))
    step = len(pts) if f.model.has_correlated_errors else 16
    outs = [fn(pts[i:i + step]) for i in range(0, len(pts), step)]
    c2 = np.concatenate([np.asarray(o[0]) for o in outs])
    vf = np.concatenate([np.asarray(o[1]) for o in outs])
    dg = np.concatenate([np.asarray(o[2]) for o in outs])
    ex = G._extraout(API_EXTRA, fit_params, names, vf, pts, f.model)
    return c2, dg[:, 0].astype(int), {k: np.asarray(v) for k, v in ex.items()}


def export_api(model, toas, which: str, arrays: dict, meta: dict) -> None:
    """Add the reference's outputs of the fitter, residuals, model and grid
    API (:data:`API`) to a snapshot's ``arrays`` under ``ref/api/`` and to
    ``meta["reference"]["api"]``, and the model's own parameters to
    ``meta["top_level"]``."""
    import copy

    from pint_tpu import fitter as F
    from pint_tpu import grid as G
    from pint_tpu.wideband import WidebandDownhillFitter, WidebandTOAFitter

    spec = API[which]
    settings = meta["reference"]["settings"]
    ref_api = {}
    P = "ref/api/"
    meta["top_level"] = top_level_meta(model, toas)
    for p in spec.get("d_delay", ()):
        arrays[f"{P}d_delay/{p}"] = np.asarray(model.d_delay_d_param(toas, p))
    if spec.get("post"):
        _derived_dict(model.get_derived_params(returndict=True)[1], P,
                      arrays, ref_api, "derived_pre")
        f = _first_fit(model, toas, settings)
        fm = f.model
        ref_api["update_model"] = {
            k: (None if getattr(fm, k).value is None
                else float(getattr(fm, k).value) if k not in ("DMDATA",
                                                              "EPHEM")
                else str(getattr(fm, k).value)) for k in UPDATE_MODEL_FIELDS}
        cov = f.parameter_covariance_matrix
        ref_api["cov_labels"] = cov.get_label_names(axis=0)
        arrays[P + "cov"] = np.asarray(cov.matrix)
        arrays[P + "corr"] = np.asarray(
            f.get_parameter_correlation_matrix().matrix)
        _derived_dict(f.get_derived_params(returndict=True)[1], P, arrays,
                      ref_api, "derived_post")
        ref_api["summary"] = f.get_summary()
        ref_api["errors"] = {k: float(v) for k, v in f.errors.items()}
        if spec.get("stats"):
            r = f.resids
            ref_api["rms_weighted"] = float(r.rms_weighted())
            ref_api["time_mean"] = float(r.calc_time_mean())
            ref_api["phase_mean"] = float(r.calc_phase_mean())
            arrays[P + "whitened_times_sigma"] = np.asarray(
                r.calc_whitened_resids()) * np.asarray(r.get_data_error())
            for comp, nr in r.noise_resids().items():
                arrays[f"{P}noise_resids/{comp}"] = np.asarray(nr)
            arrays[P + "psr_freq_taylor"] = np.asarray(
                r.get_PSR_freq("taylor"))
            arrays[P + "full_basis_weight"] = np.asarray(
                model.full_basis_weight(toas))
            ea = r.ecorr_average()
            arrays[P + "ecorr_time_resids"] = np.asarray(ea["time_resids"])
            arrays[P + "ecorr_errors"] = np.asarray(ea["errors"])
            arrays[P + "ecorr_index_counts"] = np.array(
                [len(i) for i in ea["indices"]])
            arrays[P + "ecorr_indices"] = np.concatenate(
                [np.asarray(i, dtype=np.int64) for i in ea["indices"]])
        if spec.get("grid"):
            pts, mc, cosi = api_grid_points(fm, f.errors)
            arrays[P + "tuple_points"] = pts
            arrays[P + "derived_mc"] = mc
            arrays[P + "derived_cosi"] = cosi
            niter = settings["grid_niter"]
            mesh = np.meshgrid(mc, cosi, indexing="ij")
            dpts = np.stack([derived_m2(*mesh).ravel(),
                             derived_sini(*mesh).ravel()], axis=-1)
            for key, p in (("tuple", pts), ("derived", dpts)):
                c2, rungs, ex = reference_api_points(f, p, niter)
                arrays[f"{P}{key}_chi2"] = c2
                arrays[f"{P}{key}_rungs"] = rungs
                for k, v in ex.items():
                    arrays[f"{P}{key}_extra/{k}"] = v
            if spec.get("doonefit"):
                chi2, ex = G.doonefit(f, ("M2", "SINI"), pts[0],
                                      extraparnames=API_EXTRA,
                                      maxiter=settings["fit_maxiter"])
                ref_api["doonefit_chi2"] = float(chi2)
                arrays[P + "doonefit_extra"] = np.array(
                    [float(v) for v in ex])
    if spec.get("state"):
        from pint_tpu.gls_fitter import DownhillGLSFitter

        cls = getattr(F, spec["state"])
        fc = {"GLSState": DownhillGLSFitter,
              "WidebandState": WidebandDownhillFitter}.get(
                  spec["state"], F.DownhillWLSFitter)
        st = cls(fc(toas, model), model)
        ref_api["state_chi2"] = float(st.chi2)
        ref_api["predicted_chi2"] = [float(st.predicted_chi2(lambda_=lam))
                                     for lam in (1.0, 0.5)]
    if spec.get("powell"):
        import scipy.optimize as opt

        maxiter, start = spec["powell"]
        m = copy.deepcopy(model)
        key = "postfit" if start == "prefit" else "auto"
        names = meta["reference"]["postfit_params"]
        for i, p in enumerate(names):
            par = getattr(m, p)
            par.uncertainty = float(arrays[f"ref/{key}_uncertainties"][i])
            if start == "auto":
                par.value = float(arrays[f"ref/{key}_values"][i])
        seen, minimize = [], opt.minimize

        def spy(*a, **k):
            seen.append(minimize(*a, **k))
            return seen[-1]

        opt.minimize = spy
        try:
            f = F.PowellFitter(toas, m)
            chi2 = f.fit_toas(maxiter=maxiter)
        finally:
            opt.minimize = minimize
        ref_api["powell"] = {"maxiter": maxiter, "start": start,
                             "chi2": float(chi2),
                             "converged": bool(f.converged),
                             "nfev": int(seen[-1].nfev),
                             "nit": int(seen[-1].nit)}
        arrays[P + "powell_values"] = np.array(
            [float(getattr(f.model, p).value) for p in names])
    if spec.get("full_cov"):
        import types

        f = WidebandDownhillFitter(toas, model)
        # the reference's downhill class is no WidebandTOAFitter, so it
        # lacks the dense covariance its full_cov solve reads: bind the
        # reference's own method
        f.get_noise_covariancematrix = types.MethodType(
            WidebandTOAFitter.get_noise_covariancematrix, f)
        chi2 = f.fit_toas(full_cov=True)
        names = meta["reference"]["postfit_params"]
        ref_api["downhill_full_cov"] = {
            "chi2": float(chi2), "converged": bool(f.converged),
            "noise_ampls": bool(getattr(f.resids, "noise_ampls", None))}
        _fit_outputs(f, names, "api/downhill_full_cov", arrays)
    meta["reference"]["api"] = ref_api
