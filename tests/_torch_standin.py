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
import torch

#: one intra-op thread a test process: the tests run six workers on eight
#: cores, and torch's default of a thread a core oversubscribes them (six
#: of the heaviest port test files: 206 s of wall at the default, 64 s at
#: one thread; CHANGES.md, PR 24)
torch.set_num_threads(1)

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

#: the streaming stand-in (``j1909_stream``): the J1909-3744 shape of
#: ``ELL1_SETTINGS`` with NANOGrav-15-yr-style achromatic red noise, 30
#: modes on a period pinned to the 8.87-yr span (``TNREDTSPAN``), no
#: ECORR.  ``stream``: a ``GLSFitter.fit_toas(maxiter=2)`` on the first
#: ``base`` epochs, then one append a ``blocks`` entry of that many epochs
#: (40 single epochs of 9 sub-bands, then a backlog of 5), the append
#: ``dup`` carrying a copy of its own first row; then ``quarantine`` rows
#: of the last append's block are quarantined and released, and
#: ``apply_validation`` runs once
STREAM_SETTINGS = dict(
    ELL1_SETTINGS, rn_modes=30, rn_tspan=8.87, grid=None,
    stream=dict(base=400, blocks=[1] * 40 + [5], dup=4,
                quarantine=[0, 3, 7]))

#: its CPU-test version (``small_stream``): the small stand-in without
#: ECORR, five red-noise modes on a 6-yr period, 3 DMX windows; a fit on
#: the first 40 TOAs, five appends of 8 (the third opens a DMX window with
#: no base rows)
SMALL_STREAM_SETTINGS = dict(
    SMALL_SETTINGS, ecorr=False, rn_tspan=6.0,
    stream=dict(base=10, blocks=[2] * 5, dup=1, quarantine=[0, 3, 5]))

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

#: the small wideband stand-in with white noise only (no ECORR, no red
#: noise), so that its wideband likelihood is the diagonal ``wb_wls`` one
#: the Bayesian timing interface evaluates
SMALL_WB_WHITE_SETTINGS = dict(SMALL_WB_SETTINGS, rn_modes=0, ecorr=False)

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
    if s.get("rn_tspan"):
        lines += [f"TNRedAmp {s.get('rn_amp', -13.8)}", "TNRedGam 3.2",
                  f"TNRedC {s['rn_modes']}", f"TNREDTSPAN {s['rn_tspan']}"]
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
    windows covering the span, EFAC/EQUAD and (but for B1913+16, or where
    ``ecorr`` is False) ECORR per group; no red noise where ``rn_modes``
    is 0, and a fitted PHOFF where the settings ask for it."""
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
        if s.get("pulsar") != "B1913+16" and s.get("ecorr", True):
            lines.append(f"ECORR -f {g} {ecorr * scale:.6g}")
    if s.get("wideband"):
        lines += _wideband_noise_lines(s)
    if s["rn_modes"]:
        lines += [f"TNRedAmp {s.get('rn_amp', -13.8)}", "TNRedGam 3.2",
                  f"TNRedC {s['rn_modes']}"]
        if s.get("rn_tspan"):
            lines.append(f"TNREDTSPAN {s['rn_tspan']}")
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
# the stand-ins as par and tim files (ref/files/)
# ---------------------------------------------------------------------------
def standin_par_text(s, full: bool) -> str:
    """The par text a stand-in's model is read from."""
    if _ngc(s):
        return ngc_par(s)
    if _j1909(s):
        return j1909_par(s)
    if s.get("pulsar") == "J0023+0923":
        return bw_par(s)
    if s.get("pulsar") == "J0835-4510":
        return vela_par(s, full)
    return standin_par(s, full)


#: the host columns of the reference's TOAs read from the files, under
#: ``ref/files/host/``: longdouble columns as (hi, lo) pairs
HOST_COLUMNS = ("clock_corr_s", "error_us", "freq_mhz", "ssb_obs_pos_km",
                "ssb_obs_vel_kms", "obs_sun_pos_km")


def host_columns(toas) -> dict:
    """{name: array} of a host TOAs' columns: the UTC MJDs and TDBs as
    exact (hi, lo) pairs of their longdouble, the rest as they are."""
    from pint_tpu.dd import dd_from_longdouble

    out = {}
    for name in ("utc_mjd", "tdb"):
        d = dd_from_longdouble(getattr(toas, name))
        out[f"{name}_hi"] = np.asarray(d.hi)
        out[f"{name}_lo"] = np.asarray(d.lo)
    for name in HOST_COLUMNS:
        out[name] = np.asarray(getattr(toas, name))
    out["obs"] = np.asarray(toas.obs).astype(str)
    return out


def export_files(s, full: bool, par_path: str, tim_path: str) -> tuple:
    """Write a stand-in's par text and its simulated TOAs (the reference's
    ``TOAs.write_TOA_file``) to ``par_path`` and ``tim_path``, then run
    the reference on those files: ``(arrays, meta)`` to store under
    ``ref/files/`` and ``meta["reference"]["files"]``.  The arrays are
    the snapshot exporter's (:func:`export_snapshot` or
    :func:`export_wls_snapshot`: the state, batch and contexts, the
    residuals, design matrix, fits and grid) on the models and TOAs read
    from the files, plus the host columns (:func:`host_columns`); the
    meta records whether the reference's own round trip through the
    written tim file is bitwise its in-memory TOAs and state."""
    from pint_tpu.models import get_model_and_toas

    model, toas = make_standin(s, full=full)
    with open(par_path, "w") as fh:
        fh.write(standin_par_text(s, full))
    toas.write_TOA_file(tim_path)
    fmodel, ftoas = get_model_and_toas(par_path, tim_path)
    before, after = export_state(model, toas), export_state(fmodel, ftoas)
    same = {k: bool(np.array_equal(before[k], after[k]))
            for k in before if k != "meta"}
    same["meta"] = bool(str(before["meta"]) == str(after["meta"]))
    hb, ha = host_columns(toas), host_columns(ftoas)
    same.update({f"host/{k}": bool(np.array_equal(hb[k], ha[k]))
                 for k in hb})
    same["flags"] = toas.flags == ftoas.flags
    export = export_snapshot if fmodel.has_correlated_errors \
        else export_wls_snapshot
    arrays = export(fmodel, ftoas, s, chunk=16, grid=True)
    meta = json.loads(str(arrays.pop("meta")))
    arrays.update({f"host/{k}": v for k, v in ha.items()})
    meta["flags"] = ftoas.flags
    meta["roundtrip_bitwise"] = all(same.values())
    meta["roundtrip_differs"] = sorted(k for k, v in same.items() if not v)
    return arrays, meta


# ---------------------------------------------------------------------------
# component parity helpers of the CPU tests
# ---------------------------------------------------------------------------
def port_and_reference(settings, full: bool = False):
    """(reference model, reference TOAs, port model, port batch) of a
    stand-in, the port's loaded on the CPU from the reference's exported
    state."""
    from pint_torch.bridge import load_snapshot

    import dataclasses

    model, toas = make_standin(settings, full=full)
    m, b = load_snapshot(export_state(model, toas), device="cpu")
    return model, toas, m, dataclasses.replace(b, _version=toas._version)


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


#: the fused sweep's reference run (``ref/sweep/``): a 32 x 32 M2 x SINI
#: grid about the first fit, 1024 points in chunks of 256 retired three a
#: dispatch (two fused dispatches, the second padded), and the refit values
#: of two of its fit parameters
SWEEP = dict(points=32, chunk=256, fuse=3, extra=("PB", "A1"))


def export_sweep(model, toas, which: str, arrays: dict, meta: dict) -> None:
    """Add the reference's fused ``grid_chisq`` (:data:`SWEEP`) after the
    snapshot's first fit to ``arrays`` under ``ref/sweep/``: the axes,
    chi2, per-point diagnostics, the extra parameters' refit values and
    the grid function's ``dispatch_count()``.  The fit must give the
    committed post-fit values bitwise."""
    from pint_tpu import grid as G

    settings = meta["reference"]["settings"]
    f = _first_fit(model, toas, settings)
    vals = np.array([float(getattr(f.model, p).value)
                     for p in meta["reference"]["postfit_params"]])
    if not np.array_equal(vals, arrays["ref/postfit_values"]):
        raise SystemExit("the first fit is not the committed one")
    axes = grid_axes(f.model, SWEEP["points"])
    built = []
    build = G.build_grid_chi2_fn

    def spy(*a, **kw):
        out = build(*a, **kw)
        built.append(out[0])
        return out

    G.build_grid_chi2_fn = spy
    try:
        c2, extra = G.grid_chisq(f, ("M2", "SINI"), axes,
                                 extraparnames=SWEEP["extra"],
                                 niter=settings["grid_niter"],
                                 chunk=SWEEP["chunk"], fuse=SWEEP["fuse"])
    finally:
        G.build_grid_chi2_fn = build
    P = "ref/sweep/"
    arrays[P + "m2"], arrays[P + "sini"] = axes
    arrays[P + "chi2"] = np.asarray(c2)
    d = f.last_grid_diagnostics
    arrays[P + "diag"] = np.stack([d["ladder_rung"].ravel().astype(float),
                                   d["ridge"].ravel(),
                                   d["condition"].ravel()], axis=1)
    for p in SWEEP["extra"]:
        arrays[P + p.lower()] = np.asarray(extra[p])
    arrays[P + "dispatch_count"] = np.asarray(built[-1].dispatch_count())


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


# ---------------------------------------------------------------------------
# Bayesian timing and the ensemble MCMC's reference outputs
# ---------------------------------------------------------------------------
#: the stand-ins that carry ``ref/bayes/``, by their exporter settings
#: name: the MCMC run's walkers and steps
BAYES = {"ell1": dict(nwalkers=256, nsteps=20),
         "ddgr": dict(nwalkers=256, nsteps=20),
         "ngc_phoff": dict(nwalkers=32, nsteps=50),
         "small_wb_white": dict(nwalkers=32, nsteps=50)}
#: the prior box's half-width in post-fit uncertainties (the reference's
#: ``set_priors_basic`` default), the seeded points and how many of them
#: lie outside the box, the unit cubes of ``prior_transform``
BAYES_PRIORERRFACT = 10.0
BAYES_POINTS = 64
BAYES_OUTSIDE = 8
BAYES_CUBES = 16
#: seeds of the points and cubes, of the initial walker ball and of the
#: sampler's generator
BAYES_SEEDS = dict(points=20261017, pos=20261018, sampler=20261019)


def bayes_prior_info(model, toas, names, uncertainties) -> dict:
    """The prior box of the reference's ``set_priors_basic`` at
    :data:`BAYES_PRIORERRFACT` on an ``MCMCFitter`` of the snapshot's
    model: each free parameter's value +/- the factor times its post-fit
    uncertainty (``names``/``uncertainties`` the snapshot's
    ``postfit_params`` and ``ref/postfit_uncertainties``)."""
    from pint_tpu.mcmc_fitter import MCMCFitter, set_priors_basic

    f = MCMCFitter(toas, model)
    unc = dict(zip(names, (float(u) for u in uncertainties)))
    for p in f.fitkeys:
        getattr(f.model, p).uncertainty = unc[p]
    return set_priors_basic(f, BAYES_PRIORERRFACT)


def bayes_points(values, pmin, pmax, seed: int):
    """:data:`BAYES_POINTS` seeded points about ``values``: each
    coordinate off by a normal draw times its box half-width over 10 (one
    post-fit sigma) times a per-point scale from 0.01 to 1; the last
    :data:`BAYES_OUTSIDE` with one coordinate 5% of the half-width past an
    edge of the box.  Also :data:`BAYES_CUBES` seeded unit cubes."""
    rng = np.random.default_rng(seed)
    values = np.asarray(values, dtype=np.float64)
    half = 0.5 * (np.asarray(pmax) - np.asarray(pmin))
    n, nd = BAYES_POINTS, len(values)
    scale = 10.0 ** rng.uniform(-2.0, 0.0, n)
    pts = values + (half / BAYES_PRIORERRFACT) * scale[:, None] \
        * rng.standard_normal((n, nd))
    for i in range(n - BAYES_OUTSIDE, n):
        k = int(rng.integers(nd))
        side = 1.0 if rng.random() < 0.5 else -1.0
        edge = pmax[k] if side > 0 else pmin[k]
        pts[i, k] = edge + side * 0.05 * half[k]
    return pts, rng.random((BAYES_CUBES, nd))


def export_bayes(model, toas, which: str, arrays: dict, meta: dict) -> None:
    """Add the reference's Bayesian timing and MCMC outputs to a
    snapshot's ``arrays`` under ``ref/bayes/`` and to
    ``meta["reference"]["bayes"]``: the prior box (``pmin``, ``pmax`` in
    free-parameter order), :func:`bayes_points`' points with each one's
    ``lnposterior_batch``, ``lnprior`` and chi2 (the batched path's, from
    a box 100 times as wide), ``prior_transform`` of the cubes, the
    initial walker positions (the reference's seeded ball of
    ``errfact`` 0.1 post-fit sigmas, walkers outside the box reset to the
    values) and a seeded ``MCMCFitter.fit_toas`` from them: the chain
    (``walker_chain``, (nwalkers, ndim, nsteps): walker-major, so that a
    rejected step repeats its predecessor beside it and compresses), its
    log-posteriors, each decision's accept flag, the acceptance fraction,
    the maximum posterior, its index and values, the posterior stds and
    the returned chi2."""
    from pint_tpu.bayesian import BayesianTiming
    from pint_tpu.mcmc_fitter import MCMCFitter
    from pint_tpu.sampler import EnsembleSampler

    spec = BAYES[which]
    ref = meta["reference"]
    if toas.delta_pulse_number is not None:
        raise ValueError("the port's batched lnposterior takes the delta "
                         "pulse numbers as 0; these TOAs have some")
    names = list(model.free_params)
    info = bayes_prior_info(model, toas, ref["postfit_params"],
                            arrays["ref/postfit_uncertainties"])
    pmin = np.array([info[p]["pmin"] for p in names])
    pmax = np.array([info[p]["pmax"] for p in names])
    values = np.array([float(getattr(model, p).value or 0.0) for p in names])
    pts, cubes = bayes_points(values, pmin, pmax, BAYES_SEEDS["points"])
    P = "ref/bayes/"
    arrays[P + "pmin"], arrays[P + "pmax"] = pmin, pmax
    arrays[P + "points"], arrays[P + "cubes"] = pts, cubes
    bt = BayesianTiming(model, toas, prior_info=info)
    arrays[P + "lnposterior"] = np.asarray(bt.lnposterior_batch(pts))
    half = 0.5 * (pmax - pmin)
    wide = {p: dict(distr="uniform", pmin=v - 100.0 * h, pmax=v + 100.0 * h)
            for p, v, h in zip(names, values, half)}
    bw = BayesianTiming(model, toas, prior_info=wide)
    lp_wide = np.asarray(bw.lnposterior_batch(pts))
    lognorm = float(np.sum(np.log(np.asarray(
        model.scaled_toa_uncertainty(toas)))))
    if toas.wideband:
        lognorm += float(np.sum(np.log(np.asarray(
            model.scaled_dm_uncertainty(toas)))))
    lnpr_wide = np.array([bw.lnprior(x) for x in pts])
    arrays[P + "chi2"] = -2.0 * (lp_wide - lnpr_wide + lognorm)
    arrays[P + "lnprior"] = np.array([bt.lnprior(x) for x in pts])
    arrays[P + "prior_transform"] = np.array([bt.prior_transform(c)
                                              for c in cubes])
    f = MCMCFitter(toas, model, prior_info=info,
                   sampler=EnsembleSampler(spec["nwalkers"],
                                           seed=BAYES_SEEDS["sampler"]))
    unc = dict(zip(ref["postfit_params"],
                   arrays["ref/postfit_uncertainties"]))
    for p in names:
        getattr(f.model, p).uncertainty = float(unc[p])
    pos = f.sampler.get_initial_pos(f.fitkeys, f.get_fitvals(),
                                    f.get_fiterrs(), f.errfact,
                                    seed=BAYES_SEEDS["pos"])
    bad = ~np.isfinite(f.bt.lnposterior_batch(pos))
    pos[bad] = f.get_fitvals()
    arrays[P + "pos"] = pos.copy()
    chi2 = f.fit_toas(maxiter=spec["nsteps"], pos=pos)
    chain = f.sampler.get_chain()
    prev = np.concatenate([arrays[P + "pos"][None], chain[:-1]])
    arrays[P + "walker_chain"] = np.ascontiguousarray(
        chain.transpose(1, 2, 0))
    arrays[P + "lnprob"] = f.sampler.get_log_prob()
    arrays[P + "accepted"] = np.any(chain != prev, axis=2)
    nsteps = chain.shape[0]
    lnp = f.sampler.get_log_prob(flat=True, discard=int(nsteps * 0.25))
    arrays[P + "maxpost_fitvals"] = np.asarray(f.maxpost_fitvals)
    arrays[P + "stds"] = np.array([f.errors[p] for p in f.fitkeys])
    ref["bayes"] = dict(
        spec, params=names, priorerrfact=BAYES_PRIORERRFACT,
        seeds=dict(BAYES_SEEDS), errfact=float(f.errfact), burn_frac=0.25,
        lognorm=lognorm, acceptance=float(f.sampler.acceptance_fraction),
        naccepted=int(f.sampler.naccepted), maxpost=float(f.maxpost),
        maxpost_index=int(np.argmax(lnp)), chi2=float(chi2),
        likelihood=bt.likelihood_method)


# ---------------------------------------------------------------------------
# the photon domain: Fermi-LAT-shaped photon stand-ins
# ---------------------------------------------------------------------------
#: J0030+0451's par as the reference's photon tests write it
#: (``tests/test_photon_domain.py:259-261``)
J0030_PAR = ("PSR J0030+0451\nRAJ 00:30:27.4\nDECJ 04:51:39.7\n"
             "POSEPOCH 55000\nF0 205.53069 1\nF1 -4.3e-16\nPEPOCH 55000\n"
             "DM 4.33\nUNITS TDB\n")
#: the reference test's own set-up (300 barycentred photons over 20 days,
#: one Gaussian peak, phases from ``default_rng(7)``) plus a seeded weight
#: column; F0 free, 3e-8 Hz off, in a uniform box of +/- 2e-7 Hz
SMALL_PHOTON_SETTINGS = dict(
    pulsar="J0030+0451", photons=300, mjd_start=54990.0, mjd_end=55010.0,
    toa_seed=6, phase_seed=7, weight_seed=8, peaks=[[0.04, 0.5, 0.6]],
    weighted_draw=False, free=["F0"], unc={"F0": 1e-8},
    offset={"F0": 3e-8}, priors={"F0": ["truth_box", 2e-7]}, nbins=256,
    nwalkers=16, nsteps=30)
#: twelve years of a bright MSP's LAT photons after a weight cut: 32768
#: barycentred photons, weights skewed low (Beta(0.5, 1.5)), each phase a
#: draw from J0030's two-peak template (peaks 0.44 apart) with probability
#: its weight and uniform otherwise; F0 (3 sigma off, event_optimize's
#: normal prior of 10 sigma) and F1 (a uniform box of 10 sigma) free
PHOTON_SETTINGS = dict(
    pulsar="J0030+0451", photons=32768, mjd_start=54700.0,
    mjd_end=59000.0, toa_seed=20261017, phase_seed=20261018,
    weight_seed=20261019, peaks=[[0.04, 0.15, 0.35], [0.06, 0.59, 0.25]],
    weighted_draw=True, free=["F0", "F1"], unc={"F0": 1.5e-11, "F1": 3e-19},
    offset={"F0": 4.5e-11}, priors={"F0": ["normal", 10.0],
                                    "F1": ["uniform", 10.0]},
    nbins=256, nwalkers=128, nsteps=40)
#: the seeds of the lnposterior points, of the initial walker ball and of
#: the samplers' generators; the number of points and of those outside a
#: uniform box
PHOTON_SEEDS = dict(points=20261020, pos=20261021, sampler=20261022)
PHOTON_POINTS = 64
PHOTON_OUTSIDE = 8


def photon_template(s):
    """The stand-in's ``LCTemplate`` (``pint_tpu``'s)."""
    from pint_tpu.templates import LCGaussian, LCTemplate

    return LCTemplate([LCGaussian([w, loc]) for w, loc, _ in s["peaks"]],
                      [n for _, _, n in s["peaks"]])


def make_photon_standin(s):
    """(truth model, TOAs, weights) of a photon stand-in: barycentred
    photons (``obs="barycenter"``, ``freq=inf``) each moved so that its
    phase under the truth is its draw (the reference test's
    ``adjust_TOAs``)."""
    import io

    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_uniform

    m = get_model(io.StringIO(J0030_PAR))
    t = make_fake_toas_uniform(s["mjd_start"], s["mjd_end"], s["photons"], m,
                               error_us=1.0, obs="barycenter", freq=np.inf,
                               rng=np.random.default_rng(s["toa_seed"]))
    n = len(t)
    template = photon_template(s)
    ph_now = np.asarray(m.phase(t).frac) % 1.0
    rng = np.random.default_rng(s["phase_seed"])
    ph_want = template.random(n, rng=rng)
    w = np.random.default_rng(s["weight_seed"]).beta(0.5, 1.5, n)
    if s["weighted_draw"]:
        uniform = rng.random(n)
        ph_want = np.where(rng.random(n) < w, ph_want, uniform)
    dt = ((ph_want - ph_now + 0.5) % 1.0 - 0.5) / float(m.F0.value)
    t.adjust_TOAs(dt)
    return m, t, w


def photon_start(m, s):
    """The fitters' starting model: the settings' free parameters with
    their uncertainties, F0 moved off the truth; and the prior_info of
    the settings' priors about the starting values."""
    import copy

    m2 = copy.deepcopy(m)
    info = {}
    for p in s["free"]:
        par = getattr(m2, p)
        par.frozen = False
        par.value = float(par.value) + s["offset"].get(p, 0.0)
        par.uncertainty = s["unc"][p]
        kind, k = s["priors"][p]
        v = float(par.value)
        if kind == "normal":
            info[p] = {"distr": "normal", "mu": v, "sigma": k * s["unc"][p]}
        elif kind == "uniform":
            info[p] = {"distr": "uniform", "pmin": v - k * s["unc"][p],
                       "pmax": v + k * s["unc"][p]}
        else:  # "truth_box": +/- k about the truth, as the reference test
            t = float(getattr(m, p).value)
            info[p] = {"distr": "uniform", "pmin": t - k, "pmax": t + k}
    return m2, info


def photon_points(values, info, names, unc, seed: int):
    """:data:`PHOTON_POINTS` seeded points about ``values``: each
    coordinate off by a normal draw times its uncertainty times a
    per-point scale from 0.01 to 3; the last :data:`PHOTON_OUTSIDE` with
    a uniform-box coordinate 5% of the box's half-width past an edge."""
    rng = np.random.default_rng(seed)
    n, nd = PHOTON_POINTS, len(values)
    scale = 10.0 ** rng.uniform(-2.0, np.log10(3.0), n)
    sig = np.array([unc[p] for p in names])
    pts = np.asarray(values) + sig * scale[:, None] \
        * rng.standard_normal((n, nd))
    boxes = [i for i, p in enumerate(names)
             if info[p]["distr"] == "uniform"]
    for i in range(n - PHOTON_OUTSIDE, n):
        k = boxes[int(rng.integers(len(boxes)))]
        lo, hi = info[names[k]]["pmin"], info[names[k]]["pmax"]
        half = 0.5 * (hi - lo)
        pts[i, k] = hi + 0.05 * half if rng.random() < 0.5 \
            else lo - 0.05 * half
    return pts


def export_photon(s) -> dict:
    """A photon stand-in's snapshot: the starting model and the photons
    (their weights under ``weight``), with the reference's outputs under
    ``ref/photon/`` and ``meta["reference"]["photon"]``: the photons'
    phases under the starting model; ``fftfit_full`` of the weighted
    ``nbins`` profile against the template (shift, error, scale, its
    error); then, with the template rotated by the shift (the binned
    fitter's ``set_template``, as ``event_optimize`` does), each fitter's
    ``lnposterior_batch`` at :func:`photon_points` and a seeded
    ``fit_toas`` from the stored walker ball (the chain walker-major,
    its log-posteriors, accept flags, maximum and stds)."""
    from pint_tpu.event_fitter import (MCMCFitterAnalyticTemplate,
                                       MCMCFitterBinnedTemplate)
    from pint_tpu.fftfit import fftfit_full
    from pint_tpu.sampler import EnsembleSampler

    truth, toas, w = make_photon_standin(s)
    m2, info = photon_start(truth, s)
    arrays = export_state(m2, toas)
    arrays["weight"] = w
    meta = json.loads(str(arrays["meta"]))
    template = photon_template(s)
    nbins = s["nbins"]
    seeds = PHOTON_SEEDS

    def fitter(kind, nwalkers=16):
        sampler = EnsembleSampler(nwalkers, seed=seeds["sampler"])
        if kind == "binned":
            f = MCMCFitterBinnedTemplate(toas, m2, template, nbins=nbins,
                                         weights=w, prior_info=info,
                                         sampler=sampler)
            f.set_template(rotated)
            return f
        return MCMCFitterAnalyticTemplate(toas, m2, rotated, weights=w,
                                          prior_info=info, sampler=sampler)

    P = "ref/photon/"
    f0 = MCMCFitterBinnedTemplate(toas, m2, template, nbins=nbins,
                                  weights=w, prior_info=info)
    phases = f0.phaseogram_phases()
    arrays[P + "phases"] = phases
    prof, _ = np.histogram(phases, bins=nbins, range=(0.0, 1.0), weights=w)
    grid = (np.arange(nbins) + 0.5) / nbins
    fft = fftfit_full(np.asarray(template(grid)), prof.astype(np.float64))
    rotated = template.copy()
    rotated.rotate(fft[0])
    names = list(f0.fitkeys)
    values = f0.get_fitvals()
    pts = photon_points(values, info, names, s["unc"], seeds["points"])
    arrays[P + "points"] = pts
    ref = {"settings": dict(s), "prior_info": info, "params": names,
           "fftfit": [float(v) for v in fft], "seeds": dict(seeds),
           "nbins": nbins, "truth": {p: float(getattr(truth, p).value)
                                     for p in names}}
    for kind in ("binned", "analytic"):
        f = fitter(kind, s["nwalkers"])
        arrays[P + f"lnposterior_{kind}"] = np.asarray(
            f.lnposterior_batch(pts))
        pos = f.sampler.get_initial_pos(f.fitkeys, f.get_fitvals(),
                                        f.get_fiterrs(), f.errfact,
                                        seed=seeds["pos"])
        pos[~np.isfinite(f.lnposterior_batch(pos))] = f.get_fitvals()
        arrays[P + f"{kind}/pos"] = pos.copy()
        maxpost = f.fit_toas(maxiter=s["nsteps"], pos=pos)
        chain = f.sampler.get_chain()
        prev = np.concatenate([arrays[P + f"{kind}/pos"][None], chain[:-1]])
        arrays[P + f"{kind}/walker_chain"] = np.ascontiguousarray(
            chain.transpose(1, 2, 0))
        arrays[P + f"{kind}/lnprob"] = f.sampler.get_log_prob()
        arrays[P + f"{kind}/accepted"] = np.any(chain != prev, axis=2)
        arrays[P + f"{kind}/maxpost_fitvals"] = np.asarray(
            f.maxpost_fitvals)
        arrays[P + f"{kind}/stds"] = np.array([f.errors[p]
                                               for p in f.fitkeys])
        ref[kind] = dict(maxpost=float(maxpost),
                         acceptance=float(f.sampler.acceptance_fraction),
                         naccepted=int(f.sampler.naccepted))
    meta["reference"] = {"photon": ref, "settings": dict(s)}
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


#: ``ref/photon_mixed/``: one primitive of each closed-form kind K8's MIXED
#: mode evaluates, (class, parameters, norm, keyword arguments), the widths
#: and the King's gamma within each shape's use, the two strongest peaks
#: where J0030's template has its peaks (0.15, 0.59); rotated by the stored
#: FFTFIT shift as the analytic fitter's template is
PHOTON_MIXED = (("LCGaussian", [0.03, 0.15], 0.12, {}),
                ("LCGaussian2", [0.02, 0.035, 0.59], 0.10, {}),
                ("LCLorentzian", [0.015, 0.30], 0.05, {}),
                ("LCLorentzian2", [0.02, 0.03, 0.45], 0.05, {}),
                ("LCVonMises", [0.04, 0.70], 0.05, {}),
                ("LCTopHat", [0.08, 0.85], 0.04, {}),
                ("LCKing", [0.025, 4.0, 0.05], 0.05, {}),
                ("LCHarmonic", [0.10], 0.04, {"order": 2}))
#: the mixed template's seeded chain: at most this many steps
PHOTON_MIXED_STEPS = 10


def photon_mixed_template(mod, shift: float):
    """The :data:`PHOTON_MIXED` template of package ``mod``'s
    ``templates`` (its classes from ``templates.lcprimitives``), rotated by
    ``shift``."""
    import importlib

    prims = importlib.import_module(mod.__name__ + ".lcprimitives")
    t = mod.LCTemplate([getattr(prims, c)(list(p), **kw)
                        for c, p, _, kw in PHOTON_MIXED],
                       [n for _, _, n, _ in PHOTON_MIXED])
    t.rotate(shift)
    return t


def export_photon_mixed(s, arrays: dict, meta: dict) -> None:
    """Add the mixed template's reference outputs to a photon stand-in's
    ``arrays`` under ``ref/photon_mixed/`` and ``meta["reference"]
    ["photon_mixed"]``: the template density at the stored phases, the
    analytic fitter's ``lnposterior_batch`` at the stored points and a
    seeded ``fit_toas`` (:data:`PHOTON_MIXED_STEPS` steps at most) from
    the stored analytic walker ball (the chain walker-major, its
    log-posteriors, accept flags, maximum and stds).  The stand-in is
    simulated again and must export its committed state bitwise."""
    from pint_tpu import templates as RT
    from pint_tpu.event_fitter import MCMCFitterAnalyticTemplate
    from pint_tpu.sampler import EnsembleSampler

    truth, toas, w = make_photon_standin(s)
    m2, info = photon_start(truth, s)
    for k, v in export_state(m2, toas).items():
        if k != "meta" and not np.array_equal(v, arrays[k]):
            raise SystemExit(f"{k} is not as committed: rebuild differs")
    R = meta["reference"]["photon"]
    P = "ref/photon_mixed/"
    tpl = photon_mixed_template(RT, float(R["fftfit"][0]))
    phases = arrays["ref/photon/phases"]
    arrays[P + "density"] = np.asarray(tpl(phases), dtype=np.float64)
    f = MCMCFitterAnalyticTemplate(
        toas, m2, tpl, weights=w, prior_info=info,
        sampler=EnsembleSampler(s["nwalkers"], seed=PHOTON_SEEDS["sampler"]))
    arrays[P + "lnposterior"] = np.asarray(
        f.lnposterior_batch(arrays["ref/photon/points"]))
    steps = min(s["nsteps"], PHOTON_MIXED_STEPS)
    pos = arrays["ref/photon/analytic/pos"].copy()
    maxpost = f.fit_toas(maxiter=steps, pos=pos.copy())
    chain = f.sampler.get_chain()
    prev = np.concatenate([pos[None], chain[:-1]])
    arrays[P + "walker_chain"] = np.ascontiguousarray(chain.transpose(1, 2, 0))
    arrays[P + "lnprob"] = f.sampler.get_log_prob()
    arrays[P + "accepted"] = np.any(chain != prev, axis=2)
    arrays[P + "maxpost_fitvals"] = np.asarray(f.maxpost_fitvals)
    arrays[P + "stds"] = np.array([f.errors[p] for p in f.fitkeys])
    meta["reference"]["photon_mixed"] = dict(
        template=[[c, list(p), n, kw] for c, p, n, kw in PHOTON_MIXED],
        shift=float(R["fftfit"][0]), steps=steps, maxpost=float(maxpost),
        acceptance=float(f.sampler.acceptance_fraction),
        naccepted=int(f.sampler.naccepted))


#: ``ref/full_cov/``: the narrowband GLS fitters with ``full_cov=True``
#: (``GLSFitter`` at ``gls_maxiter`` steps, ``DownhillGLSFitter`` at its
#: default ``maxiter``)
FULL_COV = dict(gls_maxiter=2)


def export_full_cov(model, toas, which: str, arrays: dict,
                    meta: dict) -> None:
    """Add the reference's full-covariance fits to ``arrays`` under
    ``ref/full_cov/`` (``gls_`` and ``downhill_``: the fitted parameters'
    values and uncertainties) and to ``meta["reference"]["full_cov"]``
    (each fit's chi2, parameters, converged flag and downhill steps)."""
    from pint_tpu.gls_fitter import DownhillGLSFitter, GLSFitter

    ref = dict(FULL_COV)
    for key, cls, kw in (
            ("gls", GLSFitter, dict(maxiter=FULL_COV["gls_maxiter"],
                                    full_cov=True)),
            ("downhill", DownhillGLSFitter, dict(full_cov=True))):
        f = cls(toas, model)
        chi2 = f.fit_toas(**kw)
        params = [p for p in f.fitted_params if p != "Offset"]
        arrays[f"ref/full_cov/{key}_values"] = np.array(
            [float(getattr(f.model, p).value) for p in params])
        arrays[f"ref/full_cov/{key}_uncertainties"] = np.array(
            [float(getattr(f.model, p).uncertainty) for p in params])
        ref[key] = dict(chi2=float(chi2), params=params,
                        converged=bool(f.converged),
                        iterations=int(getattr(f, "iterations", 0)))
    meta["reference"]["full_cov"] = ref


# ---------------------------------------------------------------------------
# the streaming GLS engine and the serve batcher's reference outputs
# ---------------------------------------------------------------------------
def stream_rows(s):
    """(base rows, [rows of each append]) of a stream stand-in's schedule
    (:func:`pint_torch.bridge.stream_schedule`)."""
    from pint_torch.bridge import stream_schedule

    return stream_schedule({"reference": {"settings": s}})[:2]


def _integrity_meta(toas) -> dict:
    """What the coverage checks read on the host: each site's clock-chain
    end (None where the reference finds no finite one) and the ephemeris
    span (None where it loads none), as ``run_toa_checks`` reads them."""
    from pint_tpu.ephemeris import load_ephemeris
    from pint_tpu.observatory import get_observatory

    clock = {}
    for site in np.unique(np.asarray(toas.obs).astype(str)):
        try:
            last = float(get_observatory(site).last_clock_correction_mjd(
                limits="allow"))
        except Exception:
            last = None
        clock[site] = last if last is not None and np.isfinite(last) \
            else None
    span = None
    if getattr(toas, "ephem", None):
        try:
            span = [float(v) for v in
                    load_ephemeris(str(toas.ephem)).coverage_mjd()]
        except Exception:
            span = None
    return {"clock_end": clock, "ephem_span": span}


def _integrity_arrays(toas) -> dict:
    """The duplicate check's keys beyond the batch: the sub-double part of
    each UTC MJD and each TOA's observatory."""
    mjd64 = np.asarray(toas.utc_mjd, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        lo = np.asarray(np.asarray(toas.utc_mjd)
                        - mjd64.astype(np.longdouble), dtype=np.float64)
    lo = np.where(np.isfinite(lo), lo, 0.0)
    if getattr(toas, "utc_mjd_lo", None) is not None:
        lo = lo + np.asarray(toas.utc_mjd_lo, dtype=np.float64)
    return {"mjd_lo": lo, "obs": np.asarray(toas.obs).astype(str)}


def _block_of(toas, rows, dup: bool):
    """The reference's append block of ``rows``; with ``dup`` a copy of its
    first row after it."""
    from pint_tpu.toa import merge_TOAs

    blk = toas[rows]
    return merge_TOAs([blk, toas[rows[:1]]]) if dup else blk


def _ref_state(eng) -> dict:
    c = eng.cache
    return {"L": np.asarray(c.L).copy(), "b": np.asarray(c.b).copy(),
            "x": np.asarray(c.x).copy(), "chi2": float(c.chi2)}


class _Crash(RuntimeError):
    """The cut of a checkpointed stream."""


def reference_stream(model, toas, s, tmpdir=None) -> dict:
    """Run a stream stand-in's schedule (``s["stream"]``) through the
    reference's streaming engine: the base fit, the appends, the
    quarantine and release of the last block's rows, ``apply_validation``;
    then a scratch ``GLSFitter.fit_toas(maxiter=4)`` of the final certified
    set, and ``stream_updates`` over the appends with a checkpoint cut
    after half the chunks (``cut_half``) and, where a fallback comes later,
    before the first fallback (``cut_first``), each resumed on a fresh
    engine.  Returns the operations' outcomes and the states kept."""
    import copy

    from pint_tpu.gls_fitter import GLSFitter
    from pint_tpu.runtime.checkpoint import CheckpointError as RefCkptError
    from pint_tpu.streaming import update as up
    from pint_tpu.streaming.lowrank import DEFAULT_BLOCK_BUCKETS
    from pint_tpu.streaming.update import StreamingGLS, stream_updates

    st = s["stream"]
    base_rows, rows = stream_rows(s)
    base = toas[base_rows]

    def fit_base():
        f = GLSFitter(base, copy.deepcopy(model))
        f.fit_toas(maxiter=s["fit_maxiter"])
        return f

    def engine(f):
        return StreamingGLS(f, block_buckets=DEFAULT_BLOCK_BUCKETS)

    def blocks():
        return [_block_of(toas, r, i == st["dup"]) for i, r in enumerate(rows)]

    f = fit_base()
    eng = engine(f)
    design = [p for p in eng.cache.params if p != "Offset"]
    ntm = len(eng.cache.params)
    out = {"design": design, "base_values": np.array(
        [float(getattr(f.model, p).value) for p in design]),
        "states": {"base": _ref_state(eng)}, "ops": []}

    def record(o):
        i = len(out["ops"])
        errs = np.asarray(eng.cache.errors())[:ntm]
        out["ops"].append(dict(
            kind=o.kind, block=int(o.block), quarantined=int(o.quarantined),
            steps=int(o.steps), chi2=float(o.chi2),
            dx_final=float(o.dx_final), fallback=o.fallback,
            block_id=None if o.block_id is None else int(o.block_id),
            values=np.array([o.params[p] for p in design]),
            errors=np.array([e for p, e in zip(eng.cache.params, errs)
                             if p != "Offset"])))
        if (i + 1) % 10 == 0:
            out["states"][f"op{i}"] = _ref_state(eng)

    for b in blocks():
        record(eng.update_toas(b))
    out["after_appends"] = _ref_state(eng)
    out["after_appends"]["values"] = np.array(
        [float(getattr(f.model, p).value) for p in design])
    qb = out["ops"][-1]["block_id"]
    record(eng.quarantine_rows(qb, st["quarantine"]))
    record(eng.release_quarantined(qb, st["quarantine"]))
    out["validation_ops"] = len(eng.apply_validation())
    out["states"]["final"] = _ref_state(eng)
    c = eng.cache
    A = np.diag(c.phiinv).astype(np.float64)
    for blk in c.blocks:
        m = blk.alive
        A += (blk.M[m].T * blk.w[m]) @ blk.M[m]
    fresh = np.linalg.cholesky(A)
    out["fresh_gap"] = float(np.max(np.abs(c.L - fresh))
                             / np.max(np.abs(fresh)))
    out["rebuilds"], out["fallbacks"] = eng.rebuilds, c.fallbacks
    scratch = GLSFitter(c.toas.certified(), copy.deepcopy(model))
    scratch.fit_toas(maxiter=4)
    out["scratch_values"] = np.array(
        [float(getattr(scratch.model, p).value) for p in design])
    out["scratch_errors"] = np.array(
        [float(getattr(scratch.model, p).uncertainty) for p in design])
    out["final_values"] = np.array(
        [float(getattr(f.model, p).value) for p in design])
    first_fb = next((i for i, o in enumerate(out["ops"][:len(rows)])
                     if o["fallback"] is not None), None)
    cuts = {"cut_half": len(rows) // 2}
    if first_fb:
        cuts["cut_first"] = first_fb
    want = out["after_appends"]
    orig = up._invoke_stream
    out["checkpoint"] = {}
    with tempfile.TemporaryDirectory(dir=tmpdir) as d:
        for name, cut in cuts.items():
            path = os.path.join(d, name)

            def crashing(engine_, batch, index, cut=cut):
                if index == cut:
                    raise _Crash("cut")
                return orig(engine_, batch, index)

            up._invoke_stream = crashing
            try:
                stream_updates(engine(fit_base()), blocks(), checkpoint=path)
            except _Crash:
                pass
            finally:
                up._invoke_stream = orig
            e2 = engine(fit_base())
            try:
                outs = stream_updates(e2, blocks(), checkpoint=path)
            except RefCkptError:
                out["checkpoint"][name] = dict(cut=cut, refused=True)
                continue
            got = _ref_state(e2)
            vals = np.array([float(getattr(e2.fitter.model, p).value)
                             for p in design])
            out["checkpoint"][name] = dict(
                cut=cut, refused=False, ran=len(outs),
                bitwise=bool(all(np.array_equal(got[k], want[k])
                                 for k in ("L", "b", "x"))
                             and got["chi2"] == want["chi2"]
                             and np.array_equal(vals, want["values"])))
    return out


#: the serve phase's requests: (stand-in, TOAs of the base-fit state)
SERVE_REQUESTS = (("stream", 3600), ("stream", 3690), ("stream", 3780),
                  ("stream", 4005), ("small_stream", 40),
                  ("small_stream", 56), ("small_stream", 64))
SERVE_STEPS = 3


def serve_groups(batcher, reqs):
    """The batcher's bucket groups of ``reqs`` in its order: [(bucket,
    [request index])]."""
    groups = {}
    for i, q in enumerate(reqs):
        groups.setdefault(batcher.bucket_for(q), []).append(i)
    return list(groups.items())


def reference_serve(fitted) -> dict:
    """The reference's ``ShapeBatcher.run`` on :data:`SERVE_REQUESTS`
    (``fitted``: stand-in -> (base-fitted model, TOAs)) and
    ``serve_fused(steps=3, reweight="huber")`` on each bucket group padded
    to its batch rung, unpadded per request."""
    from pint_tpu.gls_fitter import GLSFitter
    from pint_tpu.serving.batcher import (FitRequest, ShapeBatcher,
                                          bucket_of, pad_request,
                                          serve_fused)

    reqs = []
    for which, n in SERVE_REQUESTS:
        model, toas = fitted[which]
        f = GLSFitter(toas[np.arange(n)], model)
        reqs.append(FitRequest.from_fitter(f, request_id=f"{which}:{n}"))
    sb = ShapeBatcher()
    res = sb.run(reqs)
    fused = [None] * len(reqs)
    for bucket, idxs in serve_groups(sb, reqs):
        batch = bucket_of(len(idxs), sb.batch_buckets)
        padded = [pad_request(reqs[i], *bucket) for i in idxs]
        padded += [padded[0]] * (batch - len(padded))
        ops = tuple(np.stack([p[j] for p in padded]) for j in range(5))
        dx, err, chi2, chi2_0 = (np.asarray(a) for a in serve_fused(
            steps=SERVE_STEPS, reweight="huber")(*ops))
        for lane, i in enumerate(idxs):
            k = reqs[i].n_free
            fused[i] = (dx[lane, :, :k], err[lane, :k], chi2[lane],
                        float(chi2_0[lane]))
    return {"reqs": reqs, "res": res, "fused": fused}


def export_stream(s, tmpdir=None) -> dict:
    """A stream stand-in's snapshot: the whole TOA set (the base and every
    append block) with the duplicate check's keys (``mjd_lo``, ``obs``) and
    ``meta["coverage"]``, and under ``ref/stream/`` and
    ``meta["reference"]["stream"]`` the reference's run
    (:func:`reference_stream`): each operation's outcome, values and
    uncertainties; ``L``, ``b``, ``chi2`` after the base fit, every tenth
    operation and at the end; the scratch fit; the checkpoint cuts.  The
    full-width one (``STREAM_SETTINGS``) also holds under ``ref/serve/``
    the serve batcher's outputs on :data:`SERVE_REQUESTS` (with the small
    stand-in's requests), each request's residuals beside them."""
    import copy

    from pint_tpu.gls_fitter import GLSFitter

    full = s is STREAM_SETTINGS
    model, toas = make_standin(s, full=full)
    arrays = export_state(model, toas)
    arrays.update(_integrity_arrays(toas))
    meta = json.loads(str(arrays["meta"]))
    meta["coverage"] = _integrity_meta(toas)
    run = reference_stream(model, toas, s, tmpdir=tmpdir)
    P = "ref/stream/"
    ops = run["ops"]
    arrays[P + "chi2"] = np.array([o["chi2"] for o in ops])
    arrays[P + "dx_final"] = np.array([o["dx_final"] for o in ops])
    arrays[P + "values"] = np.stack([o["values"] for o in ops])
    arrays[P + "errors"] = np.stack([o["errors"] for o in ops])
    for key in ("base_values", "scratch_values", "scratch_errors",
                "final_values"):
        arrays[P + key] = run[key]
    for name, state in run["states"].items():
        for k in ("L", "b"):
            arrays[f"{P}{name}/{k}"] = state[k]
        arrays[f"{P}{name}/chi2"] = np.array([state["chi2"]])
    ref = {"settings": dict(s), "design": run["design"],
           "ops": [{k: v for k, v in o.items()
                    if k not in ("values", "errors", "chi2", "dx_final")}
                   for o in ops],
           "states": list(run["states"]), "validation_ops":
           run["validation_ops"], "fresh_gap": run["fresh_gap"],
           "rebuilds": run["rebuilds"], "fallbacks": run["fallbacks"],
           "checkpoint": run["checkpoint"],
           "K": int(run["states"]["base"]["L"].shape[0])}
    meta["reference"] = {"settings": dict(s), "stream": ref}
    if full:
        small, stoas = make_standin(SMALL_STREAM_SETTINGS, full=False)
        fitted = {}
        for which, (m, t, ss) in {"stream": (model, toas, s),
                                  "small_stream": (small, stoas,
                                                   SMALL_STREAM_SETTINGS)
                                  }.items():
            f = GLSFitter(t[stream_rows(ss)[0]], copy.deepcopy(m))
            f.fit_toas(maxiter=ss["fit_maxiter"])
            d = list(f.model.design_param_names())
            arrays[f"ref/serve/{which}_values"] = np.array(
                [float(getattr(f.model, p).value) for p in d])
            fitted[which] = (f.model, t)
        srv = reference_serve(fitted)
        from pint_tpu.serving.batcher import ShapeBatcher

        groups = serve_groups(ShapeBatcher(), srv["reqs"])
        for i, (q, r, fz) in enumerate(zip(srv["reqs"], srv["res"],
                                           srv["fused"])):
            Q = f"ref/serve/{i}/"
            arrays[Q + "r"] = np.asarray(q.r)
            arrays[Q + "dx"], arrays[Q + "errors"] = r.dx, r.errors
            arrays[Q + "chi2"] = np.array([r.chi2, r.chi2_initial])
            arrays[Q + "fused_dx"], arrays[Q + "fused_errors"] = fz[0], fz[1]
            arrays[Q + "fused_chi2"] = np.append(fz[2], fz[3])
        meta["reference"]["serve"] = {
            "requests": [list(r) for r in SERVE_REQUESTS],
            "buckets": [list(r.bucket) for r in srv["res"]],
            "batches": [int(r.batch) for r in srv["res"]],
            "groups": [[list(b), idx] for b, idx in groups],
            "steps": SERVE_STEPS, "reweight": "huber"}
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


# ---------------------------------------------------------------------------
# the PTA catalogue: many pulsars, learned buckets, the joint likelihood
# ---------------------------------------------------------------------------
#: the reference catalogue test's own catalogue (``tests/test_catalog.py:
#: 60-68``: 16 pulsars, 24-64 TOAs, one corrupt row in members 3 and 11) at
#: 3 GWB modes; the bench's fit passes (1 settle + 4 timed), an 8-step
#: fused refine, the bench's 32 joint-likelihood points plus 16 seeded
#: ones, and a seeded 32-walker x 10-step chain on ``lnlike_batch``
SMALL_CATALOG_SETTINGS = dict(
    catalog=dict(n_pulsars=16, seed=7, ntoa_range=[24, 64],
                 bad_rows_in=[3, 11]),
    n_modes=3, fit_passes=5, refine_steps=8, bench_points=32,
    seeded_points=16, points_box=[[-17.0, -12.5], [2.0, 6.0]],
    walkers=32, chain_steps=10,
    seeds=dict(points=20261023, pos=20261024, sampler=42))
#: the full-width catalogue (``pta67_catalog``): the reference generator at
#: the NANOGrav 15-year GWB analysis' 67 pulsars and 14 GWB frequencies
#: (R = 67 x 28 = 1876), the bench's seed, 100-400 TOAs a pulsar
PTA67_CATALOG_SETTINGS = dict(
    SMALL_CATALOG_SETTINGS,
    catalog=dict(n_pulsars=67, seed=20260804, ntoa_range=[100, 400],
                 bad_rows_in=[3, 11]),
    n_modes=14)


def catalog_points(s) -> np.ndarray:
    """The joint-likelihood points of catalogue settings ``s``: the bench's
    ``bench_points`` on log10_A in [-16, -13] at gamma 13/3
    (``bench.py:675-678``), then ``seeded_points`` uniform in the box."""
    n = s["bench_points"]
    bench = np.column_stack([np.linspace(-16.0, -13.0, n),
                             np.full(n, 13.0 / 3.0)])
    (alo, ahi), (glo, ghi) = s["points_box"]
    rng = np.random.default_rng(s["seeds"]["points"])
    k = s["seeded_points"]
    seeded = np.column_stack([rng.uniform(alo, ahi, k),
                              rng.uniform(glo, ghi, k)])
    return np.concatenate([bench, seeded])


def catalog_start(s) -> np.ndarray:
    """The chain's starting walkers: a seeded ball about (-14, 13/3), as the
    reference catalogue test's sampler start."""
    rng = np.random.default_rng(s["seeds"]["pos"])
    w = s["walkers"]
    return np.column_stack([-14.0 + 0.3 * rng.standard_normal(w),
                            13.0 / 3.0 + 0.2 * rng.standard_normal(w)])


def catalog_pairs(s):
    """The reference generator's ``(model, TOAs)`` pairs of settings
    ``s``."""
    from pint_tpu.catalog import make_synthetic_catalog

    c = s["catalog"]
    return make_synthetic_catalog(
        n_pulsars=c["n_pulsars"], seed=c["seed"],
        ntoa_range=tuple(c["ntoa_range"]), bad_rows_in=c["bad_rows_in"])


class _spy_catalog_batched:
    """Record the outputs of every call of the reference's batched catalogue
    kernel (``pint_tpu.catalog.batchfit.catalog_batched``) until
    :meth:`stop`."""

    def __init__(self):
        from pint_tpu.catalog import batchfit

        self._mod, self._orig, self._calls = batchfit, \
            batchfit.catalog_batched, []

        def spied(spec=None):
            fn = self._orig(spec)

            def call(*operands):
                out = fn(*operands)
                self._calls.append([np.asarray(o) for o in out])
                return out

            return call

        batchfit.catalog_batched = spied

    def take(self) -> list:
        calls, self._calls = self._calls, []
        return calls

    def stop(self) -> None:
        self._mod.catalog_batched = self._orig


def reference_catalog(pairs, s) -> dict:
    """The reference's catalogue path on ``pairs``: ingest, the learned
    buckets, ``fit_passes`` ``fit(maxiter=1)`` passes (each member's
    residuals before each pass, its fit after), ``refine``, the joint
    likelihood at :func:`catalog_points` and a seeded chain on
    ``lnlike_batch``."""
    from pint_tpu.catalog import (CatalogFitter, JointLikelihood,
                                  ingest_catalog)
    from pint_tpu.sampler import EnsembleSampler

    report = ingest_catalog(pairs)
    members = []
    for p in report.pulsars:
        members.append(dict(name=p.name, n_toas=p.n_toas,
                            n_quarantined=p.n_quarantined,
                            codes=list(p.quarantine_codes)))
    masks = []
    for _, toas in pairs:
        m = toas.quarantine_mask
        masks.append([] if m is None else
                     [int(i) for i in np.flatnonzero(m)])
    cf = CatalogFitter(report)
    bp = cf.bucket_plan
    out = {"ingest": dict(report.to_dict(), members=members,
                          quarantined_rows=masks),
           "buckets": dict(bp.to_dict(), shapes=[list(x) for x in cf.shapes],
                           members={f"{bn}x{bk}": idx for (bn, bk), idx
                                    in sorted(bp.buckets.items())}),
           "passes": []}
    design = [list(p.model.free_params) for p in report.pulsars]
    lin = _spy_catalog_batched()
    for _ in range(s["fit_passes"]):
        r = [np.asarray(p.fitter.resids.time_resids, dtype=np.float64)
             for p in report.pulsars]
        calls = lin.take()
        res = cf.fit(maxiter=1)
        calls = lin.take()
        dx, err, c2 = [None] * len(r), [None] * len(r), np.zeros(len(r))
        for (_, idx), o in zip(sorted(bp.buckets.items()), calls):
            for j, i in enumerate(idx):
                k = len(res.fits[i].dpars)
                dx[i], err[i], c2[i] = o[0][j, :k], o[1][j, :k], o[2][j]
        out["passes"].append(dict(
            r=np.concatenate(r),
            chi2=np.array([f.chi2 for f in res.fits]),
            chi2_initial=np.array([f.chi2_initial for f in res.fits]),
            dpars=np.concatenate([[f.dpars[n] for n in f.dpars]
                                  for f in res.fits]),
            errors=np.concatenate([[f.errors[n] for n in f.errors]
                                   for f in res.fits]),
            values=np.concatenate([[float(getattr(p.fitted_model, n).value)
                                    for n in d]
                                   for p, d in zip(report.pulsars, design)]),
            lin_dx=np.concatenate(dx), lin_err=np.concatenate(err),
            lin_chi2=c2, params=[list(f.dpars) for f in res.fits],
            buckets=[list(f.bucket) for f in res.fits],
            n_buckets=res.n_buckets, pad_waste_frac=res.pad_waste_frac))
    lin.stop()
    out["design"] = design
    out["final_r"] = np.concatenate([
        np.asarray(p.fitter.resids.time_resids, dtype=np.float64)
        for p in report.pulsars])
    ref = cf.refine(steps=s["refine_steps"])
    names = [p.name for p in report.pulsars]
    out["refine"] = dict(
        chi2_steps=np.stack([ref.chi2_steps[n] for n in names]),
        dpars_first=np.concatenate([[ref.dpars_first[n][k]
                                     for k in ref.dpars_first[n]]
                                    for n in names]),
        dispatches=ref.dispatches, n_buckets=ref.n_buckets)
    jl = JointLikelihood(cf, n_modes=s["n_modes"])
    pts = catalog_points(s)
    out["likelihood"] = dict(
        points=pts, per_pulsar=np.asarray(jl.per_pulsar_lnlike()),
        nocommon=float(jl.lnlike_nocommon()),
        lnlike=np.asarray(jl.lnlike_batch(pts)), Tspan=float(jl.Tspan),
        pad_shape=list(jl.pad_shape), Lhd=np.asarray(jl.Lhd))
    sampler = EnsembleSampler(s["walkers"], seed=s["seeds"]["sampler"])
    sampler.initialize_batched(jl.lnlike_batch, 2)
    pos = catalog_start(s)
    sampler.run_mcmc(pos.copy(), s["chain_steps"])
    chain = np.asarray(sampler.get_chain())
    prev = np.concatenate([pos[None], chain[:-1]])
    out["chain"] = dict(pos=pos, walker_chain=np.ascontiguousarray(
        chain.transpose(1, 2, 0)), lnprob=np.asarray(sampler.get_log_prob()),
        accepted=np.any(chain != prev, axis=2),
        naccepted=int(sampler.naccepted))
    out["cf"], out["jl"], out["report"] = cf, jl, report
    return out


def export_catalog(s, pairs=None, run=None) -> dict:
    """A catalogue snapshot: each member's model and its raw TOAs (the
    corrupt rows too, so the port's gate reproduces the quarantine) under
    ``psr/<i>/`` (:func:`export_state` with the duplicate check's keys),
    and under ``ref/catalog/`` and ``meta["reference"]["catalog"]`` the
    reference's run (:func:`reference_catalog`): the ingest report and
    quarantined rows, the ladders and bucket members, each fit pass's
    residuals (concatenated over the certified members), steps, errors,
    chi2 and values, the refine's chi2 trajectories and first steps, the
    joint likelihood at the points, and the chain."""
    pairs = catalog_pairs(s) if pairs is None else pairs
    arrays = {}
    for i, (model, toas) in enumerate(pairs):
        st = export_state(model, toas)
        st.update(_integrity_arrays(toas))
        for k, v in st.items():
            arrays[f"psr/{i}/{k}"] = v
    run = reference_catalog(pairs, s) if run is None else run
    P = "ref/catalog/"
    passes = []
    for k, ps in enumerate(run["passes"]):
        for key in ("r", "chi2", "chi2_initial", "dpars", "errors",
                    "values", "lin_dx", "lin_err", "lin_chi2"):
            arrays[f"{P}pass{k}/{key}"] = ps[key]
        passes.append({key: ps[key] for key in ("params", "buckets",
                                                "n_buckets",
                                                "pad_waste_frac")})
    arrays[P + "final_r"] = run["final_r"]
    rf = run["refine"]
    arrays[P + "refine/chi2_steps"] = rf["chi2_steps"]
    arrays[P + "refine/dpars_first"] = rf["dpars_first"]
    lk = run["likelihood"]
    for key in ("points", "per_pulsar", "lnlike", "Lhd"):
        arrays[P + "likelihood/" + key] = lk[key]
    ch = run["chain"]
    for key in ("pos", "walker_chain", "lnprob", "accepted"):
        arrays[P + "chain/" + key] = ch[key]
    meta = {"format": "pint_torch-snapshot-1", "name": "catalog",
            "catalog": {"members": len(pairs)},
            "reference": {"settings": dict(s), "catalog": dict(
                ingest=run["ingest"], buckets=run["buckets"],
                design=run["design"], passes=passes,
                refine=dict(dispatches=rf["dispatches"],
                            n_buckets=rf["n_buckets"]),
                likelihood=dict(nocommon=lk["nocommon"],
                                Tspan=lk["Tspan"],
                                pad_shape=lk["pad_shape"]),
                chain=dict(naccepted=ch["naccepted"]))}}
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays


# ---------------------------------------------------------------------------
# the precision layer: forced reduced-precision outputs and the probes
# ---------------------------------------------------------------------------
#: the precision layer's reference runs (``ref/precision/``): the forced
#: specs of its bars (float32 at every accumulation, bfloat16 under
#: two_prod), the grid's points (every fifth value of the stored 16 x 16
#: M2 x SINI axes: 4 x 4), the joint likelihood's points (the first four of
#: the catalogue's) and the probes' points (the grid's first four)
PRECISION = dict(specs=(("float32", "native"), ("float32", "f64"),
                        ("float32", "two_sum"), ("float32", "two_prod"),
                        ("bfloat16", "two_prod")),
                 grid_every=5, lnlike_points=4, probe_points=4)


def precision_tag(ct: str, acc: str) -> str:
    """``f32_two_prod`` etc.: a forced spec's key in ``ref/precision/``."""
    return f"{'f32' if ct == 'float32' else 'bf16'}_{acc}"


def _forced(ct, acc):
    from pint_tpu.precision import PrecisionPolicy, use_policy

    return use_policy(PrecisionPolicy.forced(ct, accumulation=acc))


def _probe_records(ftr, **kw) -> dict:
    """The reference's probes at its default candidate (float32
    ``two_prod``), unforced and forced: per segment the measured
    ``rel_err`` and the dtype decided."""
    from pint_tpu.precision import tune_precision_segments

    out = {}
    for force in (False, True):
        decs = tune_precision_segments(ftr, force=force, **kw)
        out["forced" if force else "unforced"] = {
            seg: {"rel_err": float(d.measured["rel_err"]),
                  "decision": d.value["compute_dtype"]}
            for seg, d in decs.items()}
    return out


def precision_grid_points(arrays) -> np.ndarray:
    e = PRECISION["grid_every"]
    g1, g2 = arrays["ref/grid_m2"][::e], arrays["ref/grid_sini"][::e]
    return np.stack([g.ravel() for g in np.meshgrid(g1, g2, indexing="ij")],
                    axis=-1)


def export_precision(model, toas, which: str, arrays: dict,
                     meta: dict) -> None:
    """b1855's ``ref/precision/``: under each forced spec of
    :data:`PRECISION`, the snapshot's first fit from its values (chi2,
    values and uncertainties of ``postfit_params``) and, after the float64
    first fit, the GLS grid (``grid.gram`` and ``grid.correction``) at
    :func:`precision_grid_points` (chi2 and rungs); the probes on the
    float64 first fit.  The float64 first fit must be the committed one."""
    import copy

    import jax.numpy as jnp

    from pint_tpu.gls_fitter import GLSFitter
    from pint_tpu.grid import build_grid_gls_chi2_fn

    settings = meta["reference"]["settings"]
    design = meta["reference"]["postfit_params"]
    base = copy.deepcopy(model)
    f64 = _first_fit(copy.deepcopy(model), toas, settings)
    vals = np.array([float(getattr(f64.model, p).value) for p in design])
    if not np.array_equal(vals, arrays["ref/postfit_values"]):
        raise SystemExit("the first fit is not the committed one")
    pts = precision_grid_points(arrays)
    P = "ref/precision/"
    arrays[P + "grid_points"] = pts
    for ct, acc in PRECISION["specs"]:
        tag = precision_tag(ct, acc)
        with _forced(ct, acc):
            f = GLSFitter(toas, copy.deepcopy(base))
            chi2 = f.fit_toas(maxiter=settings["fit_maxiter"])
            fn, _, _ = build_grid_gls_chi2_fn(
                f64.model, toas, ("M2", "SINI"),
                niter=settings["grid_niter"], chunk=len(pts))
        arrays[f"{P}{tag}/fit_chi2"] = np.array([float(chi2)])
        arrays[f"{P}{tag}/fit_values"] = np.array(
            [float(getattr(f.model, p).value) for p in design])
        arrays[f"{P}{tag}/fit_errors"] = np.array(
            [float(getattr(f.model, p).uncertainty) for p in design])
        c2, _, dg = (np.asarray(x) for x in fn(jnp.asarray(pts)))
        arrays[f"{P}{tag}/grid_chi2"] = c2
        arrays[f"{P}{tag}/grid_rungs"] = dg[:, 0]
    meta["reference"]["precision"] = {
        "specs": [list(s) for s in PRECISION["specs"]],
        "grid_params": ["M2", "SINI"], "grid_every": PRECISION["grid_every"],
        "probes": _probe_records(
            f64, grid_params=("M2", "SINI"),
            points=pts[:PRECISION["probe_points"]])}


def export_precision_serve(arrays: dict, meta: dict) -> None:
    """j1909_stream's ``ref/precision/``: ``ShapeBatcher.run`` on the serve
    phase's seven requests (:data:`SERVE_REQUESTS`, the committed
    ``ref/serve/`` ones) under each forced spec: each request's dx,
    errors, chi2 and chi2_initial; and the probes on the stream's base
    fit.  The stand-ins rebuilt from the settings must export their
    committed state and base fits bitwise."""
    import copy

    from pint_tpu.gls_fitter import GLSFitter
    from pint_tpu.serving.batcher import FitRequest, ShapeBatcher

    fitted = {}
    base = None
    for which, s in (("stream", STREAM_SETTINGS),
                     ("small_stream", SMALL_STREAM_SETTINGS)):
        model, toas = make_standin(s, full=s is STREAM_SETTINGS)
        if which == "stream":
            st = export_state(model, toas)
            st.update(_integrity_arrays(toas))
            for k, v in st.items():
                if k != "meta" and not np.array_equal(v, arrays[k]):
                    raise SystemExit(f"{k} is not as committed")
        f = GLSFitter(toas[stream_rows(s)[0]], copy.deepcopy(model))
        f.fit_toas(maxiter=s["fit_maxiter"])
        d = list(f.model.design_param_names())
        if not np.array_equal(np.array([float(getattr(f.model, p).value)
                                        for p in d]),
                              arrays[f"ref/serve/{which}_values"]):
            raise SystemExit(f"the {which} base fit is not the committed one")
        fitted[which] = (f.model, toas)
        if which == "stream":
            base = f
    reqs = []
    for i, (which, n) in enumerate(SERVE_REQUESTS):
        model, toas = fitted[which]
        q = FitRequest.from_fitter(GLSFitter(toas[np.arange(n)], model),
                                   request_id=f"{which}:{n}")
        if not np.array_equal(np.asarray(q.r), arrays[f"ref/serve/{i}/r"]):
            raise SystemExit(f"request {i} is not the committed one")
        reqs.append(q)
    P = "ref/precision/"
    for ct, acc in PRECISION["specs"]:
        tag = precision_tag(ct, acc)
        with _forced(ct, acc):
            res = ShapeBatcher().run(reqs)
        for i, r in enumerate(res):
            Q = f"{P}{tag}/{i}/"
            arrays[Q + "dx"], arrays[Q + "errors"] = r.dx, r.errors
            arrays[Q + "chi2"] = np.array([r.chi2, r.chi2_initial])
    meta["reference"]["precision"] = {
        "specs": [list(s) for s in PRECISION["specs"]],
        "probes": _probe_records(base, segments=("serve.gram",))}


def export_precision_catalog(s, arrays: dict, meta: dict) -> None:
    """pta67_catalog's ``ref/precision/``: at the ingest state (the
    residuals of ``ref/catalog/pass0/r``), under each forced spec, the
    batched catalogue fit's outputs per member (each bucket's
    ``catalog_batched`` call; dx and errors concatenated over the members,
    chi2 and chi2_initial) and the joint likelihood at the first
    :data:`PRECISION` ``lnlike_points`` of the catalogue's points; and the
    catalogue probes.  The members rebuilt from the settings must export
    their committed state bitwise."""
    from pint_tpu import precision as R
    from pint_tpu.catalog import (CatalogFitter, JointLikelihood,
                                  ingest_catalog)

    pairs = catalog_pairs(s)
    for i, (model, toas) in enumerate(pairs):
        st = export_state(model, toas)
        st.update(_integrity_arrays(toas))
        for k, v in st.items():
            if k != "meta" and not np.array_equal(v, arrays[f"psr/{i}/{k}"]):
                raise SystemExit(f"psr/{i}/{k} is not as committed")
    report = ingest_catalog(pairs)
    r0 = np.concatenate([np.asarray(p.fitter.resids.time_resids,
                                    dtype=np.float64)
                         for p in report.pulsars])
    if not np.array_equal(r0, arrays["ref/catalog/pass0/r"]):
        raise SystemExit("the ingest state's residuals are not pass0's")
    pts = catalog_points(s)[:PRECISION["lnlike_points"]]
    P = "ref/precision/"
    arrays[P + "lnlike_points"] = pts
    cf = CatalogFitter(report)
    for ct, acc in PRECISION["specs"]:
        tag = precision_tag(ct, acc)
        spec = R.SegmentSpec(segment="catalog.fit", compute_dtype=ct,
                             accumulation=acc, source="forced")
        outs = [None] * len(report.pulsars)
        execs = list(cf.bucket_executables(spec=spec).values())
        for (bucket, idx), (fn, operands) in zip(
                sorted(cf.bucket_plan.buckets.items()), execs):
            o = [np.asarray(x) for x in fn(*operands)]
            for lane, i in enumerate(idx):
                k = cf.shapes[i][1]
                outs[i] = (o[0][lane, :k], o[1][lane, :k], o[2][lane],
                           o[3][lane])
        arrays[f"{P}{tag}/fit_dx"] = np.concatenate([x[0] for x in outs])
        arrays[f"{P}{tag}/fit_errors"] = np.concatenate([x[1] for x in outs])
        arrays[f"{P}{tag}/fit_chi2"] = np.array([[x[2], x[3]] for x in outs])
        lspec = R.SegmentSpec(segment="catalog.lnlike", compute_dtype=ct,
                              accumulation=acc, source="forced")
        jl = JointLikelihood(report, n_modes=s["n_modes"], precision=lspec)
        arrays[f"{P}{tag}/lnlike"] = np.array([jl.lnlike(*p) for p in pts])
    meta["reference"]["precision"] = {
        "specs": [list(x) for x in PRECISION["specs"]],
        "probes": _probe_records(report.pulsars[0].fitter,
                                 segments=("catalog.fit", "catalog.lnlike"),
                                 catalog=report)}


# ---------------------------------------------------------------------------
# amortized inference: the flow's ELBO, its training and its posterior
# ---------------------------------------------------------------------------
#: the flow, the training run and the posterior's queries of
#: ``ref/amortized/``: ``AmortizedVI(n_layers, hidden, seed)`` on the
#: stand-in's posterior, ``TrainConfig(steps, n_samples, lr, seed)``,
#: ``draw(draws, seed=draw_seed)`` (``draws_kept`` of them stored), and
#: ``log_prob`` at ``logprob_points`` points (``logprob_outside`` with one
#: coordinate past its box edge, ``logprob_edges`` exactly on one)
AMORTIZED = dict(n_layers=4, hidden=32, flow_seed=1, steps=20, n_samples=64,
                 lr=1e-2, train_seed=2, draws=4096, draws_kept=512,
                 draw_seed=5, logprob_points=256, logprob_outside=16,
                 logprob_edges=8, logprob_seed=7, points_seed=20261025)


def amortized_z_stream(seed: int, steps: int, n: int, ndim: int):
    """The reference's per-step base samples of ``train_flow``: ``split``
    from ``PRNGKey(seed)`` each step, then ``normal`` (n, ndim)."""
    import jax

    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (n, ndim),
                                                dtype=np.float64)))
    return out


def z_stream_sha256(zs) -> str:
    import hashlib

    h = hashlib.sha256()
    for z in zs:
        h.update(np.ascontiguousarray(z, dtype=np.float64).tobytes())
    return h.hexdigest()


def reference_amortized(vi, spec=AMORTIZED) -> tuple:
    """The reference's amortized run on ``vi`` (a ``pint_tpu``
    ``AmortizedVI``): (arrays under their names below ``ref/amortized/``,
    meta).  At the initial parameters and the first step's samples: the
    ELBO, each sample's lnpost and logq and the whole gradient; the
    ``steps``-step training run (its ELBO trace, the state before its last
    step, the gradient of that step and the final weights); the trained
    posterior's draws and log-probabilities at seeded points about them
    (some outside the box, some on an edge)."""
    import jax
    import jax.numpy as jnp

    from pint_tpu.amortized import AmortizedPosterior, TrainConfig
    from pint_tpu.amortized.train import _adam_step_fn

    cfg = TrainConfig(steps=spec["steps"], n_samples=spec["n_samples"],
                      lr=spec["lr"], seed=spec["train_seed"])
    zs = amortized_z_stream(cfg.seed, cfg.steps, cfg.n_samples, vi.ndim)
    init = jax.tree_util.tree_map(jnp.asarray, vi.flow.init())
    out = {}
    for i, leaf in enumerate(jax.tree_util.tree_leaves(init)):
        out[f"init/leaf_{i:03d}"] = np.asarray(leaf)
    z0 = jnp.asarray(zs[0])
    out["z0"] = zs[0]
    elbo = vi.elbo_fn()
    val, grad = jax.value_and_grad(lambda p: elbo(p, z0))(init)
    x, logq = vi.sample_and_logq(init, z0)
    out["lnpost0"] = np.asarray(vi.lnpost_batch(x))
    out["logq0"] = np.asarray(logq)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(grad)):
        out[f"grad0/leaf_{i:03d}"] = np.asarray(leaf)
    step = _adam_step_fn(vi, cfg)

    params = init
    m = jax.tree_util.tree_map(jnp.zeros_like, params)
    v = jax.tree_util.tree_map(jnp.zeros_like, params)
    t, trace = 0, []
    for k, z in enumerate(zs):
        if k == len(zs) - 1:
            before = (params, m, v, int(t))
        params, m, v, t, e = step(params, m, v, t, jnp.asarray(z))
        trace.append(float(e))
    final, trace = params, np.asarray(trace)
    out["trace"] = trace
    for tag, tree in zip(("state/p", "state/m", "state/v"), before[:3]):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
            out[f"{tag}_{i:03d}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(final)):
        out[f"final/leaf_{i:03d}"] = np.asarray(leaf)
    zl = jnp.asarray(zs[-1])
    g_last = jax.jit(jax.grad(lambda p: -elbo(p, zl)))(before[0])
    for i, leaf in enumerate(jax.tree_util.tree_leaves(g_last)):
        out[f"grad_last/leaf_{i:03d}"] = np.asarray(leaf)

    class _Result:
        params = final
    post = AmortizedPosterior.from_training(vi, _Result)
    draws = post.draw(spec["draws"], seed=spec["draw_seed"])
    out["draws"] = draws[:spec["draws_kept"]]
    out["draws_mean"] = draws.mean(axis=0)
    out["draws_std"] = draws.std(axis=0)
    pts = np.array(post.draw(spec["logprob_points"],
                             seed=spec["logprob_seed"]))
    rng = np.random.default_rng(spec["points_seed"])
    lo = np.array([s[1] for s in vi.transform.specs])
    hi = np.array([s[2] for s in vi.transform.specs])
    uni = np.array([s[0] == "uniform" for s in vi.transform.specs])
    cols = np.flatnonzero(uni)
    n_out, n_edge = spec["logprob_outside"], spec["logprob_edges"]
    for i in range(n_out + n_edge):
        k = int(rng.choice(cols))
        up = rng.random() < 0.5
        if i < n_out:
            pts[i, k] = (hi[k] if up else lo[k]) \
                + (1.0 if up else -1.0) * 0.05 * (hi[k] - lo[k])
        else:
            pts[i, k] = hi[k] if up else lo[k]
    out["logprob_points"] = pts
    out["logprob"] = post.log_prob(pts)
    meta = dict(spec, elbo0=float(val), t_state=before[3],
                z_sha256=z_stream_sha256(zs),
                z_sha256_steps=[z_stream_sha256([z]) for z in zs],
                labels=list(vi.param_labels),
                specs=[list(s) for s in vi.transform.specs],
                vkey=repr(vi.vkey))
    return out, meta


def reference_amortized_op_by_op(vi, arrays: dict,
                                  spec=AMORTIZED) -> tuple:
    """The reference's amortized run evaluated op by op (its jitted step
    under ``jax.disable_jit``), beside the compiled run of
    :func:`reference_amortized` already in ``arrays``: (arrays under
    ``ref/amortized/op_by_op/``, meta).  Its ELBO trace and final weights,
    and at the compiled run's stored state before its last step its
    gradient; and there the compiled ELBO's central differences along the
    two gradients' difference (steps ``h`` of the unit direction) beside
    each gradient's derivative along it.  Where the posterior is a few ulps
    of a parameter wide (ddgr's F0) the compiled gradient leaves the
    compiled ELBO's own differences and the op-by-op one follows them."""
    import jax
    import jax.numpy as jnp

    from pint_tpu.amortized import TrainConfig
    from pint_tpu.amortized.train import _adam_step_fn

    P = "ref/amortized/"
    cfg = TrainConfig(steps=spec["steps"], n_samples=spec["n_samples"],
                      lr=spec["lr"], seed=spec["train_seed"])
    zs = amortized_z_stream(cfg.seed, cfg.steps, cfg.n_samples, vi.ndim)
    init = vi.flow.init()
    treedef = jax.tree_util.tree_structure(init)

    def stored(tag):
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(arrays[k]) for k in sorted(
                k for k in arrays if k.startswith(P + tag))])

    if not all(np.array_equal(np.asarray(a), b) for a, b in zip(
            jax.tree_util.tree_leaves(init),
            jax.tree_util.tree_leaves(stored("init/leaf_")))):
        raise SystemExit("the flow's init() is not the stored one")
    step = _adam_step_fn(vi, cfg)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    m = jax.tree_util.tree_map(jnp.zeros_like, params)
    v = jax.tree_util.tree_map(jnp.zeros_like, params)
    t, trace = 0, []
    with jax.disable_jit():
        for z in zs:
            params, m, v, t, e = step(params, m, v, t, jnp.asarray(z))
            trace.append(float(e))
    out = {"op_by_op/trace": np.asarray(trace)}
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"op_by_op/final/leaf_{i:03d}"] = np.asarray(leaf)
    state = stored("state/p_")
    zl = jnp.asarray(zs[-1])
    elbo = vi.elbo_fn()

    def loss(p):
        return -elbo(p, zl)

    g_op = [np.asarray(x) for x in
            jax.tree_util.tree_leaves(jax.grad(loss)(state))]
    for i, leaf in enumerate(g_op):
        out[f"op_by_op/grad_last/leaf_{i:03d}"] = leaf
    g_c = [arrays[k] for k in sorted(k for k in arrays
                                     if k.startswith(P + "grad_last/"))]
    d = [a - b for a, b in zip(g_c, g_op)]
    norm = float(np.sqrt(sum(float((x * x).sum()) for x in d)))
    if norm == 0.0:
        d = g_op
        norm = float(np.sqrt(sum(float((x * x).sum()) for x in d)))
    d = [x / norm for x in d]
    compiled = jax.jit(loss)
    hs = (1e-7, 1e-6, 1e-5)
    fd = []
    for h in hs:
        up, dn = (jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(np.asarray(x) + s * h * y) for x, y in zip(
                jax.tree_util.tree_leaves(state), d)]) for s in (1.0, -1.0))
        fd.append((float(compiled(up)) - float(compiled(dn))) / (2.0 * h))
    meta = dict(fd_h=list(hs), fd=fd,
                along_compiled=float(sum((a * b).sum()
                                         for a, b in zip(g_c, d))),
                along_op_by_op=float(sum((a * b).sum()
                                         for a, b in zip(g_op, d))))
    return out, meta


def export_amortized_op_by_op(model, toas, which: str, arrays: dict,
                              meta: dict) -> None:
    """Add :func:`reference_amortized_op_by_op` on the stand-in's
    ``ref/bayes/`` box to ``arrays`` under ``ref/amortized/op_by_op/`` and
    to ``meta["reference"]["amortized"]["op_by_op"]``."""
    vi = amortized_vi_bayes(model, toas, arrays, meta)
    out, m = reference_amortized_op_by_op(vi, arrays)
    for k, v in out.items():
        arrays["ref/amortized/" + k] = v
    meta["reference"]["amortized"]["op_by_op"] = m


#: ``ref/amortized_reduced/``: the amortized run of :data:`AMORTIZED` under
#: ``use_policy(PrecisionPolicy.forced(*REDUCED_POLICY))``: every precision
#: segment, ``flow.coupling`` among them, at float32 with ``f64``
#: accumulation (the reference's ``forced`` default)
REDUCED_POLICY = ("float32",)


def reference_amortized_reduced(model, toas, arrays, meta,
                                spec=AMORTIZED) -> tuple:
    """The reference's amortized run under the forced reduced policy on a
    stand-in with ``ref/bayes/`` (arrays under ``ref/amortized_reduced/``,
    meta): at the initial parameters and the first step's samples the ELBO
    and its gradient; the ``steps``-step run jitted (its trace, the state
    before its last step, the final weights) and the gradient at that
    state, jitted and op by op; the same run op by op (``jax.disable_jit``:
    its trace and final weights)."""
    import jax
    import jax.numpy as jnp

    from pint_tpu import precision
    from pint_tpu.amortized import TrainConfig
    from pint_tpu.amortized.train import _adam_step_fn

    with precision.use_policy(
            precision.PrecisionPolicy.forced(*REDUCED_POLICY)):
        vi = amortized_vi_bayes(model, toas, arrays, meta, spec)
        if not vi.flow.spec.reduced:
            raise SystemExit("the forced policy left flow.coupling float64")
        cfg = TrainConfig(steps=spec["steps"], n_samples=spec["n_samples"],
                          lr=spec["lr"], seed=spec["train_seed"])
        zs = amortized_z_stream(cfg.seed, cfg.steps, cfg.n_samples, vi.ndim)
        init = jax.tree_util.tree_map(jnp.asarray, vi.flow.init())
        elbo = vi.elbo_fn()
        z0 = jnp.asarray(zs[0])
        val, grad = jax.value_and_grad(lambda p: elbo(p, z0))(init)
        out = {}
        for i, leaf in enumerate(jax.tree_util.tree_leaves(grad)):
            out[f"grad0/leaf_{i:03d}"] = np.asarray(leaf)
        step = _adam_step_fn(vi, cfg)

        def run(op_by_op: bool):
            params = init
            m = jax.tree_util.tree_map(jnp.zeros_like, params)
            v = jax.tree_util.tree_map(jnp.zeros_like, params)
            t, trace, before = 0, [], None
            for k, z in enumerate(zs):
                if k == len(zs) - 1:
                    before = (params, m, v, int(t))
                if op_by_op:
                    with jax.disable_jit():
                        params, m, v, t, e = step(params, m, v, t,
                                                  jnp.asarray(z))
                else:
                    params, m, v, t, e = step(params, m, v, t,
                                              jnp.asarray(z))
                trace.append(float(e))
            return params, np.asarray(trace), before

        final, trace, before = run(False)
        out["trace"] = trace
        for tag, tree in zip(("state/p", "state/m", "state/v"), before[:3]):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                out[f"{tag}_{i:03d}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(final)):
            out[f"final/leaf_{i:03d}"] = np.asarray(leaf)
        zl = jnp.asarray(zs[-1])

        def loss(p):
            return -elbo(p, zl)

        for tag, g in (("grad_last", jax.jit(jax.grad(loss))(before[0])),
                       ("op_by_op/grad_last", None)):
            if g is None:
                with jax.disable_jit():
                    g = jax.grad(loss)(before[0])
            for i, leaf in enumerate(jax.tree_util.tree_leaves(g)):
                out[f"{tag}/leaf_{i:03d}"] = np.asarray(leaf)
        final_o, trace_o, _ = run(True)
        out["op_by_op/trace"] = trace_o
        for i, leaf in enumerate(jax.tree_util.tree_leaves(final_o)):
            out[f"op_by_op/final/leaf_{i:03d}"] = np.asarray(leaf)
        m = dict(spec, elbo0=float(val), t_state=before[3],
                 policy=list(REDUCED_POLICY), flow_spec=vi.flow.spec.tag(),
                 z_sha256=z_stream_sha256(zs),
                 labels=list(vi.param_labels))
    return out, m


def export_amortized_reduced(model, toas, which: str, arrays: dict,
                             meta: dict) -> None:
    """Add :func:`reference_amortized_reduced` to ``arrays`` under
    ``ref/amortized_reduced/`` and to
    ``meta["reference"]["amortized_reduced"]``."""
    out, m = reference_amortized_reduced(model, toas, arrays, meta)
    for k, v in out.items():
        arrays["ref/amortized_reduced/" + k] = v
    meta["reference"]["amortized_reduced"] = m


def amortized_vi_bayes(model, toas, arrays, meta, spec=AMORTIZED):
    """The reference's ``AmortizedVI.from_bayesian`` on a stand-in with its
    ``ref/bayes/`` prior box."""
    from pint_tpu.amortized import AmortizedVI
    from pint_tpu.bayesian import BayesianTiming

    bz = meta["reference"]["bayes"]
    info = {p: dict(distr="uniform", pmin=lo, pmax=hi) for p, lo, hi in
            zip(bz["params"], arrays["ref/bayes/pmin"],
                arrays["ref/bayes/pmax"])}
    return AmortizedVI.from_bayesian(
        BayesianTiming(model, toas, prior_info=info),
        n_layers=spec["n_layers"], hidden=spec["hidden"],
        seed=spec["flow_seed"])


def export_amortized(model, toas, which: str, arrays: dict,
                     meta: dict) -> None:
    """Add the reference's amortized run (:func:`reference_amortized`) on
    the stand-in's ``ref/bayes/`` box to ``arrays`` under
    ``ref/amortized/`` and to ``meta["reference"]["amortized"]``."""
    vi = amortized_vi_bayes(model, toas, arrays, meta)
    out, m = reference_amortized(vi)
    for k, v in out.items():
        arrays["ref/amortized/" + k] = v
    meta["reference"]["amortized"] = m


def amortized_vi_catalog(s, spec=AMORTIZED):
    """The reference's ``AmortizedVI.from_joint_likelihood`` on the
    catalogue's joint likelihood at the ingest state (the residuals of
    ``ref/catalog/pass0/r``), with its default box: (vi, ingest report,
    joint likelihood)."""
    from pint_tpu.amortized import AmortizedVI
    from pint_tpu.catalog import JointLikelihood, ingest_catalog

    report = ingest_catalog(catalog_pairs(s))
    jl = JointLikelihood(report, n_modes=s["n_modes"])
    return AmortizedVI.from_joint_likelihood(
        jl, n_layers=spec["n_layers"], hidden=spec["hidden"],
        seed=spec["flow_seed"]), report, jl


def export_amortized_catalog(s, arrays: dict, meta: dict,
                             k12_grad: bool = False) -> None:
    """A catalogue's ``ref/amortized/``: :func:`reference_amortized` on the
    joint likelihood at the ingest state, whose residuals must be
    ``ref/catalog/pass0/r``; with ``k12_grad`` also ``jax.grad`` of the
    batched joint kernel at the stored likelihood points (``k12_grad``,
    (N, 2): the gradient K12 computes)."""
    import jax
    import jax.numpy as jnp

    vi, report, jl = amortized_vi_catalog(s)
    if k12_grad:
        fn, data = jl._fn(), jl._data_args()
        pts = jnp.asarray(arrays["ref/catalog/likelihood/points"])
        arrays["ref/amortized/k12_grad"] = np.asarray(jax.jit(jax.grad(
            lambda p: jnp.sum(fn(p, *data))))(pts))
    r0 = np.concatenate([np.asarray(p.fitter.resids.time_resids,
                                    dtype=np.float64)
                         for p in report.pulsars])
    if not np.array_equal(r0, arrays["ref/catalog/pass0/r"]):
        raise SystemExit("the ingest state's residuals are not pass0's")
    out, m = reference_amortized(vi)
    for k, v in out.items():
        arrays["ref/amortized/" + k] = v
    meta["reference"]["amortized"] = m


# ---------------------------------------------------------------------------
# the phase-prediction path's reference outputs (``ref/predict/``)
# ---------------------------------------------------------------------------
#: P1, the bench's read path (``bench.py:1520-1604``), on ngc at the
#: barycentre from PEPOCH, and the same request mix on b1855's cache at
#: GBT from MJD 55000; P2, one ``generate_predictor_sets`` call over four
#: stand-ins at GBT (the settings and the order of the members)
PREDICT = dict(span_days=2.0, segLength=60.0, ncoeff=12, obsFreq=1400.0,
               requests=8, times_per_request=48, probes=12, seed=20260808,
               gen_start=55000.0, gen_days=2.5, gen_obs="gbt",
               gen_members=("b1855", "ell1", "ddk", "ddgr"),
               serve={"ngc": "@", "b1855": "gbt"})


def predict_node_toas(model, tmids, segLength: float, ncoeff: int,
                      obs: str, obsFreq: float):
    """The reference's node TOAs of ``node_targets`` (``predict/
    generate.py:136-190``), made the same way, for their stored columns."""
    from pint_tpu.observatory import get_observatory
    from pint_tpu.polycos import MIN_PER_DAY
    from pint_tpu.toa import TOAs

    obsname = get_observatory(obs).name
    span_d = segLength / MIN_PER_DAY
    nnode = max(2 * ncoeff, ncoeff + 4)
    k = np.arange(nnode)
    cheb = np.cos(np.pi * (k + 0.5) / nnode)[::-1]
    flat = (tmids[:, None] + cheb[None, :] * (span_d / 2)).ravel()
    n = len(flat)
    ts = TOAs(utc_mjd=np.asarray(flat, dtype=np.longdouble),
              error_us=np.ones(n), freq_mhz=np.full(n, obsFreq),
              obs=np.array([obsname] * n, dtype=object),
              flags=[{} for _ in range(n)])
    include_bipm = str(model.CLOCK.value
                       or "").upper().startswith("TT(BIPM")
    if obsname != "barycenter":
        ts.apply_clock_corrections(include_bipm=include_bipm)
    else:
        ts.clock_corr_s = np.zeros(n)
    ts.compute_TDBs(ephem=model.EPHEM.value or "DE440")
    ts.compute_posvels(ephem=model.EPHEM.value or "DE440",
                       planets=bool(model.PLANET_SHAPIRO.value))
    return ts


def _predict_generation(prefix, arrays, model, tmids, host, coeffs, rms,
                        obs):
    """Store one pulsar's generation under ``prefix``: the midpoints, the
    node TOAs' host columns, the targets, the coefficients and the fit
    rms; returns the warned windows."""
    from pint_tpu.predict.generate import FIT_RMS_WARN

    S = PREDICT
    ts = predict_node_toas(model, tmids, S["segLength"], S["ncoeff"], obs,
                           S["obsFreq"])
    hi = np.asarray(ts.tdb, dtype=np.float64)
    arrays.update({
        prefix + "tmids": np.asarray(tmids),
        prefix + "clock_corr_s": np.asarray(ts.clock_corr_s),
        prefix + "tdb_hi": hi,
        prefix + "tdb_lo": np.asarray(ts.tdb - hi.astype(np.longdouble),
                                      dtype=np.float64),
        prefix + "ssb_obs_pos_km": ts.ssb_obs_pos_km,
        prefix + "ssb_obs_vel_kms": ts.ssb_obs_vel_kms,
        prefix + "obs_sun_pos_km": ts.obs_sun_pos_km,
        prefix + "x": host["x"], prefix + "y": host["y"],
        prefix + "rint": host["rint"], prefix + "rfrac": host["rfrac"],
        prefix + "coeffs": np.asarray(coeffs),
        prefix + "fit_rms": np.asarray(rms)})
    return [int(s) for s in np.nonzero(np.asarray(rms) > FIT_RMS_WARN)[0]]


def _serve_requests(lo, hi):
    """The bench's request epochs: settle (8 x 48), bench (8 x 48) and
    the probes (12 x 48), drawn in that order from one seeded stream."""
    S = PREDICT
    rng = np.random.default_rng(S["seed"])
    n, k = S["times_per_request"], S["requests"]

    def draw(m):
        return np.stack([np.sort(rng.uniform(lo, hi, size=n))
                         for _ in range(m)])

    return {"settle": draw(k), "bench": draw(k), "probe": draw(S["probes"])}


def export_predict_serve(model, which: str, arrays: dict, meta: dict) -> None:
    """P1's read path on ``model`` (``ref/predict/serve/``): a
    ``PredictorCache`` over ``span_days`` from PEPOCH (ngc, at the
    barycentre) or from ``gen_start`` (b1855, at GBT), built, then the
    settle and bench batches coalesced through ``run_predict_requests``
    (``pool=None``, the bench's ladders) and the probes one by one; every
    result's arrays and ``cache.predict`` at the bench epochs."""
    from pint_tpu.predict import PredictorCache, PredictRequest
    from pint_tpu.predict.door import run_predict_requests
    from pint_tpu.predict.generate import node_targets

    S = PREDICT
    obs = S["serve"][which]
    start = float(model.PEPOCH.value) if which == "ngc" \
        else S["gen_start"]
    cache = PredictorCache(model, start, start + S["span_days"], obs=obs,
                           segLength=S["segLength"], ncoeff=S["ncoeff"],
                           obsFreq=S["obsFreq"])
    cache.build()
    P = "ref/predict/serve/"
    host = node_targets(model, cache._tmid, S["segLength"], S["ncoeff"],
                        obs, S["obsFreq"])
    for k in ("rint", "rfrac"):
        if not np.array_equal(host[k], getattr(cache, "_" + k)):
            raise SystemExit("node_targets is not the cache's build")
    warned = _predict_generation(P, arrays, model, cache._tmid, host,
                                 cache._coeffs, cache._rms, obs)
    lo, hi = cache.coverage()
    reqs = _serve_requests(lo, hi)
    ladders = dict(time_buckets=(S["times_per_request"],),
                   batch_buckets=(1, S["requests"]))
    for tag, times in reqs.items():
        arrays[P + tag + "_times"] = times
        if tag == "probe":
            res = [run_predict_requests(cache, None,
                                        [PredictRequest(t)], **ladders)[0]
                   for t in times]
        else:
            res = run_predict_requests(
                cache, None, [PredictRequest(t) for t in times], **ladders)
        for f in ("phase_int", "phase_frac", "freq"):
            arrays[P + f"{tag}_{f}"] = np.stack([getattr(r, f) for r in res])
        for f in ("bucket", "batch", "windows"):
            arrays[P + f"{tag}_{f}"] = np.array([getattr(r, f) for r in res])
    pi, pf, fr = cache.predict(reqs["bench"].ravel())
    arrays[P + "predict_phase_int"] = pi
    arrays[P + "predict_phase_frac"] = pf
    arrays[P + "predict_freq"] = fr
    ref = meta.setdefault("reference", {}).setdefault("predict", {})
    ref["serve"] = {"obs": obs, "mjd_start": start,
                    "mjd_end": start + S["span_days"],
                    "segLength": S["segLength"], "ncoeff": S["ncoeff"],
                    "obsFreq": S["obsFreq"], "seed": S["seed"],
                    "requests": S["requests"],
                    "times_per_request": S["times_per_request"],
                    "probes": S["probes"], "warned": warned,
                    "hits": int(cache.hits), "misses": int(cache.misses)}


def export_predict_gen(models: dict, arrays_by: dict, meta_by: dict) -> None:
    """P2 (``ref/predict/gen/``): one ``generate_predictor_sets`` call at
    ``gen_obs`` over ``gen_days`` from ``gen_start`` for the members'
    models in :data:`PREDICT`'s order (``pool=None``); each member's rows
    go to its own snapshot's arrays."""
    from pint_tpu.predict.generate import (generate_predictor_sets,
                                           node_targets, window_tmids)

    S = PREDICT
    names = list(S["gen_members"])
    lo, hi = S["gen_start"], S["gen_start"] + S["gen_days"]
    sets = generate_predictor_sets([models[n] for n in names], lo, hi,
                                   S["gen_obs"], segLength=S["segLength"],
                                   ncoeff=S["ncoeff"], obsFreq=S["obsFreq"])
    tmids = window_tmids(lo, hi, S["segLength"])
    for n, ps in zip(names, sets):
        host = node_targets(models[n], tmids, S["segLength"], S["ncoeff"],
                            S["gen_obs"], S["obsFreq"])
        if not np.array_equal(host["rint"], ps.rphase_int):
            raise SystemExit(f"{n}: node_targets is not the set's")
        warned = _predict_generation("ref/predict/gen/", arrays_by[n],
                                     models[n], tmids, host, ps.coeffs,
                                     ps.fit_rms, S["gen_obs"])
        ref = meta_by[n].setdefault("reference", {}).setdefault("predict",
                                                                 {})
        ref["gen"] = {"obs": S["gen_obs"], "mjd_start": lo, "mjd_end": hi,
                      "segLength": S["segLength"], "ncoeff": S["ncoeff"],
                      "obsFreq": S["obsFreq"], "members": names,
                      "member": names.index(n), "warned": warned}


def snapshot_noise_bars(path, expect_cls):
    """``Fitter.auto``'s fit of a committed snapshot with its noise
    parameters freed, against the stored reference outputs."""
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import Fitter

    meta, ref = read_snapshot(path)
    rr = meta["reference"]
    m, b = load_snapshot(path, device="cpu")
    for p in rr["auto_noise_params"]:
        m[p].frozen = False
    f = Fitter.auto(b, m)
    assert type(f).__name__ == rr["auto_fitter"] == expect_cls
    chi2 = f.fit_toas()
    assert abs(chi2 / rr["auto_chi2"] - 1) <= 1e-6
    assert (bool(f.converged), f.iterations) == (rr["auto_converged"],
                                                 rr["auto_iterations"])
    for i, (got, want) in enumerate(zip(f.noise_fit_results,
                                        rr["auto_noise_rounds"])):
        assert (got.nit, got.converged) == (want["nit"], want["converged"])
        assert abs(got.lnlike / want["lnlike"] - 1) <= 1e-9
    names = rr["auto_noise_names"]
    err = ref["ref/auto_noise_uncertainties"]
    vals = np.array([f.model.value(p) for p in names])
    assert np.abs((vals - ref["ref/auto_noise_values"]) / err).max() <= 1e-2
    design = rr["postfit_params"]
    sig = ref["ref/auto_uncertainties"]
    vals = np.array([f.model.value(p) for p in design])
    unc = np.array([f.model[p].uncertainty for p in design])
    assert np.abs((vals - ref["ref/auto_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-4


# ---------------------------------------------------------------------------
# the tracking layer's reference outputs (``ref/tracking/``)
# ---------------------------------------------------------------------------
#: what the tracking phase runs on each committed par and tim pair: the
#: F0 offset in cycles over the span that wraps ngc's nearest-pulse
#: residuals, the fits' ``maxiter``, ell1's walkers and steps and its
#: three added WaveX frequencies [1/d], b1855's removed DMX windows, its
#: parameter left out by ``ftest``, the rows its jump flags are put on
TRACKING = dict(wrap_cycles=3.0, fit_maxiter=3, gls_maxiter=2,
                nwalkers=32, nsteps=10,
                wavex_freqs=(1.0 / 400.0, 1.0 / 250.0, 1.0 / 150.0),
                dmx_removed=(2, 3), ftest_removed="FD3",
                gui_rows=tuple(range(10)), pn_offset_every=3,
                pn_missing=5, padd_rows=((7, "2"), (9, "-1")))


def tracking_flags(flags, pn) -> None:
    """Stamp the tracking phase's ``-pn``/``-padd`` flags: each TOA's pulse
    number plus (its row mod ``pn_offset_every``), none on row
    ``pn_missing``, ``-padd`` on ``padd_rows``."""
    S = TRACKING
    for i, fl in enumerate(flags):
        if i != S["pn_missing"]:
            fl["pn"] = repr(float(pn[i] + (i % S["pn_offset_every"])))
    for i, v in S["padd_rows"]:
        flags[i]["padd"] = v


def _fit_record(prefix, f, chi2, arrays, meta):
    names = list(f.model.free_params)
    arrays[prefix + "values"] = np.array(
        [float(getattr(f.model, p).value) for p in names])
    arrays[prefix + "uncertainties"] = np.array(
        [float(getattr(f.model, p).uncertainty) for p in names])
    meta[prefix.split("/")[-2]] = dict(params=names, chi2=float(chi2),
                                       converged=bool(f.converged))


def _doctor_sections(text):
    return [ln for ln in text.splitlines()[2:]
            if not ln.startswith("Last solve:")]


def _jump_state(model, toas):
    return dict(flags=[dict(fl) for fl in toas.flags],
                jumps={p: [getattr(model, p).key,
                           [str(v) for v in getattr(model, p).key_value],
                           float(getattr(model, p).value),
                           bool(getattr(model, p).frozen)]
                       for p in model.params if p.startswith("JUMP")})


def export_tracking(which: str, par: str, tim: str) -> tuple:
    """The reference's run of the tracking phase on a committed par and
    tim pair: ``(arrays, meta)`` to store under ``ref/tracking/`` and
    ``meta["reference"]["tracking"]``.  Every stand-in: the file model's
    par text in each dialect, its first fit (GLS with correlated noise,
    else WLS; values, uncertainties, chi2), ``compare`` of the file model
    against it, the doctor's sections of that fit, ``d_phase_d_toa`` and
    ``ftest`` adding F2 to Spindown.  ngc: the pulse numbers, the
    residuals and the WLS fit in each ``track_mode`` with F0 off by
    ``wrap_cycles`` over the span, and the columns of
    ``phase_columns_from_flags`` on :func:`tracking_flags`.  b1855:
    ``ftest`` removing ``ftest_removed``, the GLS fit with two DMX windows
    removed, the jump editing's flags and jumps after each step, and the
    first half by MJD: its ECORR epoch of each TOA and its GLS fit.
    ell1: the prior box, 64 points' lnposterior with
    ``use_pulse_numbers`` (and each point's chi2), a seeded
    ``nwalkers`` x ``nsteps`` ``MCMCFitter`` chain from a seeded ball, and
    the WLS fit with three WaveX terms added."""
    import copy

    from pint_tpu.bayesian import BayesianTiming
    from pint_tpu.fitter import WLSFitter
    from pint_tpu.gls_fitter import GLSFitter
    from pint_tpu.mcmc_fitter import MCMCFitter
    from pint_tpu.models import get_model_and_toas
    from pint_tpu.models.parameter import prefixParameter
    from pint_tpu.sampler import EnsembleSampler

    S = TRACKING
    arrays, meta = {}, {"settings": {k: (list(v) if isinstance(v, tuple)
                                         else v) for k, v in S.items()}}
    model, toas = get_model_and_toas(par, tim)
    meta["parfile"] = {fmt: model.as_parfile(format=fmt)
                       for fmt in ("pint", "tempo", "tempo2")}
    gls = model.has_correlated_errors
    cls = GLSFitter if gls else WLSFitter
    maxiter = S["gls_maxiter"] if gls else S["fit_maxiter"]
    f = cls(toas, model)
    chi2 = f.fit_toas(maxiter=maxiter)
    _fit_record("base/", f, chi2, arrays, meta)
    meta["compare"] = {v: model.compare(f.model, verbosity=v)
                       for v in ("max", "med", "min", "check")}
    meta["doctor"] = _doctor_sections(f.doctor())
    arrays["dphase"] = np.asarray(model.d_phase_d_toa(toas))
    meta["ftest"] = {"add_F2": f.ftest(
        prefixParameter("F2", value=0.0, units="Hz/s^2"), "Spindown",
        full_output=True),
        "base": [float(f.resids.chi2), int(f.resids.dof)]}
    if which == "ngc":
        t = copy.deepcopy(toas)
        arrays["pn"] = np.asarray(t.compute_pulse_numbers(model))
        mjd = np.asarray(t.get_mjds(), dtype=np.float64)
        df0 = S["wrap_cycles"] / ((mjd.max() - mjd.min()) * 86400.0)
        meta["df0"] = float(df0)
        for mode in ("use_pulse_numbers", "nearest"):
            mw = copy.deepcopy(model)
            mw.F0.value = float(mw.F0.value) + df0
            fw = WLSFitter(t, mw, track_mode=mode)
            arrays[f"resid/{mode}"] = np.asarray(fw.resids.time_resids)
            _fit_record(f"fit_{mode}/", fw,
                        fw.fit_toas(maxiter=S["fit_maxiter"]), arrays, meta)
        tf = copy.deepcopy(toas)
        tracking_flags(tf.flags, arrays["pn"])
        tf.phase_columns_from_flags()
        arrays["flags_pn"] = np.asarray(tf.pulse_number)
        arrays["flags_dpn"] = np.asarray(tf.delta_pulse_number)
    if which == "b1855":
        meta["ftest"]["remove"] = f.ftest(
            getattr(f.model, S["ftest_removed"]), None, remove=True,
            full_output=True)
        md = copy.deepcopy(model)
        md.components["DispersionDMX"].remove_DMX_range(
            list(S["dmx_removed"]))
        fd = GLSFitter(toas, md)
        _fit_record("dmx_removed/", fd, fd.fit_toas(maxiter=maxiter),
                    arrays, meta)
        mj, tj = copy.deepcopy(model), copy.deepcopy(toas)
        steps = {}
        mj.components["PhaseJump"].jump_params_to_flags(tj)
        steps["jump_params_to_flags"] = _jump_state(mj, tj)
        for i in S["gui_rows"]:
            tj.flags[i]["gui_jump"] = "2"
        mj.jump_flags_to_params(tj)
        steps["jump_flags_to_params"] = _jump_state(mj, tj)
        mj.delete_jump_and_flags(tj, 2)
        steps["delete_jump_and_flags"] = _jump_state(mj, tj)
        meta["jumps"] = steps
        mjd = np.asarray(toas.get_mjds(), dtype=np.float64)
        keep = mjd < np.median(mjd)
        sub = toas[keep]
        ecorr = next(c for c in model.noise_components
                     if getattr(c, "is_ecorr", False)
                     or type(c).__name__ == "EcorrNoise")
        U, _ = ecorr.basis_weight_pair(model, sub) \
            if hasattr(ecorr, "basis_weight_pair") \
            else model.noise_basis_by_component(sub)[:2]
        U = np.asarray(U)
        arrays["subset/ecorr_epoch"] = np.where(
            U.any(axis=1), np.argmax(U != 0, axis=1), -1)
        fs = GLSFitter(sub, model)
        _fit_record("subset/", fs, fs.fit_toas(maxiter=maxiter), arrays,
                    meta)
    if which == "ell1":
        from pint_tpu.models.wavex import WaveX

        names = list(model.free_params)
        unc = [float(getattr(f.model, p).uncertainty) for p in names]
        info = bayes_prior_info(model, toas, names, unc)
        pmin = np.array([info[p]["pmin"] for p in names])
        pmax = np.array([info[p]["pmax"] for p in names])
        values = np.array([float(getattr(model, p).value) for p in names])
        pts, _ = bayes_points(values, pmin, pmax, BAYES_SEEDS["points"])
        P = "bayes/"
        arrays[P + "pmin"], arrays[P + "pmax"] = pmin, pmax
        arrays[P + "points"] = pts
        t = copy.deepcopy(toas)
        bt = BayesianTiming(model, t, use_pulse_numbers=True,
                            prior_info=info)
        arrays[P + "pn"] = np.asarray(t.pulse_number)
        arrays[P + "lnposterior"] = np.asarray(bt.lnposterior_batch(pts))
        half = 0.5 * (pmax - pmin)
        wide = {p: dict(distr="uniform", pmin=v - 100.0 * h,
                        pmax=v + 100.0 * h)
                for p, v, h in zip(names, values, half)}
        bw = BayesianTiming(model, copy.deepcopy(toas),
                            use_pulse_numbers=True, prior_info=wide)
        lp_wide = np.asarray(bw.lnposterior_batch(pts))
        lognorm = float(np.sum(np.log(np.asarray(
            model.scaled_toa_uncertainty(toas)))))
        lnpr_wide = np.array([bw.lnprior(x) for x in pts])
        arrays[P + "chi2"] = -2.0 * (lp_wide - lnpr_wide + lognorm)
        fm = MCMCFitter(copy.deepcopy(toas), model, use_pulse_numbers=True,
                        prior_info=info,
                        sampler=EnsembleSampler(
                            S["nwalkers"], seed=BAYES_SEEDS["sampler"]))
        for p, u in zip(names, unc):
            getattr(fm.model, p).uncertainty = u
        pos = fm.sampler.get_initial_pos(fm.fitkeys, fm.get_fitvals(),
                                         fm.get_fiterrs(), fm.errfact,
                                         seed=BAYES_SEEDS["pos"])
        bad = ~np.isfinite(fm.bt.lnposterior_batch(pos))
        pos[bad] = fm.get_fitvals()
        arrays[P + "pos"] = pos.copy()
        mchi2 = fm.fit_toas(maxiter=S["nsteps"], pos=pos)
        chain = fm.sampler.get_chain()
        prev = np.concatenate([arrays[P + "pos"][None], chain[:-1]])
        arrays[P + "walker_chain"] = np.ascontiguousarray(
            chain.transpose(1, 2, 0))
        arrays[P + "lnprob"] = fm.sampler.get_log_prob()
        arrays[P + "accepted"] = np.any(chain != prev, axis=2)
        lnp = fm.sampler.get_log_prob(
            flat=True, discard=int(chain.shape[0] * 0.25))
        arrays[P + "maxpost_fitvals"] = np.asarray(fm.maxpost_fitvals)
        arrays[P + "stds"] = np.array([fm.errors[p] for p in fm.fitkeys])
        meta["bayes"] = dict(
            params=names, nwalkers=S["nwalkers"], nsteps=S["nsteps"],
            seeds=dict(BAYES_SEEDS), burn_frac=0.25, lognorm=lognorm,
            acceptance=float(fm.sampler.acceptance_fraction),
            naccepted=int(fm.sampler.naccepted),
            maxpost_index=int(np.argmax(lnp)), chi2=float(mchi2))
        mw = copy.deepcopy(model)
        mw.add_component(WaveX(), validate=False)
        mw.WXEPOCH.value = mw.PEPOCH.value
        mw.components["WaveX"].add_wavex_components(
            list(S["wavex_freqs"]), indices=[1, 2, 3], frozens=False)
        fw = WLSFitter(toas, mw)
        _fit_record("wavex/", fw, fw.fit_toas(maxiter=S["fit_maxiter"]),
                    arrays, meta)
    return arrays, meta
