#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pint_torch``) on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc under $CUDA_HOME or /usr/local/cuda)::

    python3 chip_smoke.py

Phases, one line each:

1. device -- the card's name and power limit (nvidia-smi) and its
   properties;
2. build -- the seven hand kernels, one nvcc per source, started
   together; the ptxas report of each ``__global__`` (registers, stack
   frame, spill bytes; K1's per S = 1..6, K2's and K4's per mode and orbit
   source, K6's per form, its duals staged and direct), read from the
   build logs: K1's primal templates must hold no stack frame, and no
   primal (K1, K2 in its five modes and both orbit sources, K4 likewise,
   K6, K7), no ELL1H dual, no K6 or K7 dual and no tiled K5 kernel may
   spill;
3. main paths, each with the kernel launch counts zeroed just before it
   and read just after, and every kernel of the path required to have
   launched; then its bars against the reference package's outputs stored
   in its snapshot.  Each path: load onto the card, residuals (the
   absolute phase where the model has AbsPhase), design matrix cold and
   warm, the fits the reference ran -- ``GLSFitter.fit_toas(maxiter=2)``
   with correlated noise, else ``WLSFitter.fit_toas(maxiter)`` and
   ``DownhillWLSFitter.fit_toas()`` --, ``Fitter.auto``'s fitter
   (``DownhillGLSFitter`` or ``DownhillWLSFitter``), both WLS fitters'
   Huber fits where the snapshot holds them, then the 16x16 grid of the
   snapshot's parameters after the first fit, cold and warm
   (``chunk=256``):

   * b1855 -- the B1855+09-shaped GLS stand-in
     (``pint_torch/data/b1855_standin.npz``, nt = 88 at the M2 x SINI
     grid, ``niter=1``; K1, K2, K3 in shared memory);
   * dmx15 -- its 216-DMX sibling (``b1855_dmx15_standin.npz``, nt = 232;
     K3 in global memory);
   * ell1 -- the J1909-3744-shaped WLS stand-in
     (``j1909_ell1_standin.npz``, ELL1, k = 88, M2 x SINI at ``niter=4``;
     K1, K4's ELL1 primal and dual, K5's tiled fold and SVD);
   * ell1h -- the same with BinaryELL1H, H3/STIGMA in the exact form
     (``j1909_ell1h_standin.npz``, the H3 x STIGMA grid; K4's ELL1H-exact
     primal and dual in place of ELL1's);
   * ngc, ngc_phoff -- the NGC6440E-shaped stand-ins of the reference
     benchmark's secondary cell (``ngc6440e_standin.npz``,
     ``ngc6440e_phoff_standin.npz``: 62 TOAs, AbsPhase with its TZR row,
     the second with a fitted PHOFF; the F0 x F1 grid at ``niter=4``; K1,
     K5 at N = 62);
   * ddk -- the J1713+0747-shaped GLS stand-in (``j1713_ddk_standin.npz``:
     ecliptic astrometry with PX, a DDK binary with K96 on, nt = 89 at the
     KIN x KOM grid, ``niter=1``; K1, K2's DDK primal and dual, K3 in
     shared memory);
   * ddgr -- the B1913+16-shaped WLS stand-in (``b1913_ddgr_standin.npz``:
     a DDGR binary at ECC 0.617, k = 85 at the MTOT x M2 grid,
     ``niter=4``; K1, K2's DDGR primal and dual, K5 tiled);
   * bt, dds, ddh -- the small GLS stand-in (80 TOAs) with its binary as
     BT, DDS and DDH (``small_bt_standin.npz``, ``small_dds_standin.npz``,
     ``small_ddh_standin.npz``; the fits, no grid; K1, K2's BT primal and
     dual, or its DD ones on DDS's and DDH's reparameterized rows);
   * bw -- the J0023+0923-shaped black widow (``j0023_bw_standin.npz``:
     ELL1 on FB0..FB3 orbits, WLS, the FB0 x FB1 grid at ``niter=4``; K1,
     K6 FBX, K4's ELL1 with orbit inputs, K5 tiled); bw_waves -- the same
     on ORBWAVES with an FBX base (``j0023_bw_waves_standin.npz``, no
     grid; K6's waves on FBX);
   * pta -- J1713+0747 with PLDMNoise, PLChromNoise, CM/CM1, SWX windows,
     FDJUMP and FDJUMPDM (``j1713_pta_standin.npz``; the KIN x KOM GLS
     grid at ``niter=1``; K1, K2 DDK, K3 smem, K7);
   * young -- the Vela-shaped young pulsar (``vela_young_standin.npz``:
     two glitches, WAVE pairs, the troposphere; the GLF0D_1 x GLTD_1 WLS
     grid at ``niter=4``; K1, K5 tiled);
   * small_dd_fbx, small_bt_piecewise, small_pta, small_young -- the small
     stand-ins (80 TOAs, the fits, no grid) of DD on ORBWAVES with a PB
     base (K6's waves on PB, K2's DD with orbit inputs), BT_piecewise (K2
     BTX), the solar-wind and Fourier-basis PTA terms (K7 for NE_SW's
     SWM 1) and piecewise spindown with IFUNC (K1);
   * b1855_wb -- the NANOGrav-12.5-yr-wideband-shaped B1855+09
     (``b1855_wb_standin.npz``: 890 wideband TOAs, one per epoch and
     Arecibo receiver, each with a DM measurement; DMJUMP, EFAC/EQUAD and
     DMEFAC/DMEQUAD per receiver, red noise; K1, K2 DD): the TOA and DM
     residuals, both design matrices, then ``WidebandTOAFitter`` (Schur
     path) and with ``full_cov=True``, ``WidebandDownhillFitter``,
     ``WidebandLMFitter`` and ``Fitter.auto``'s with DMEFAC, DMEQUAD and
     EFAC free -- the joint TOA+DM noise fit;
   * b1855_noise -- b1855's 4005 TOAs simulated with their correlated
     noise (``b1855_noise_standin.npz``; K1, K2 DD): ``GLSFitter``, then
     ``Fitter.auto``'s ``DownhillGLSFitter`` with every EFAC, EQUAD and
     ECORR and TNREDAMP/TNREDGAM free: two rounds of (timing fit,
     L-BFGS-B noise fit), the Hessian's uncertainties, a last timing fit;
     each round's iterations, evaluations and ms per evaluation printed;
   * small_wb -- the small stand-in made wideband, near the ecliptic
     (``small_wb_standin.npz``: SWM 1 NE_SW, SWX, DMWaveX, FDJUMPDM,
     DMJUMP; K1, K2 DD, K7 through the DM Jacobian too): the wideband
     fits.

   Bars: residuals 1e-10 s, the absolute phase's integers exactly, each
   fit's chi2 1e-6 rel, values 1e-2 sigma and uncertainties 1e-6 rel (or
   the reference's own ``StepProblem``, message and all), the downhill and
   ``Fitter.auto`` converged flags and steps, ``Fitter.auto``'s class, its
   noise amplitudes 1e-6 of their largest, the Huber weights 1e-6 with the
   same down-weighted TOAs and IRLS rounds, the grid's surface 1e-6 rel,
   argmin and rungs; for wideband TOAs the DM residuals 1e-12 pc/cm^3 and
   the joint chi2 1e-6 rel; for a fit with free noise parameters each
   round's L-BFGS-B iterations and converged flag, its lnlike 1e-9 rel,
   the noise values within 1e-2 of their uncertainties and the timing
   uncertainties 1e-4 rel.  After its bars, each path whose snapshot
   holds the fitter, residuals, model and grid API's reference outputs
   (``ref/api/``: b1855, ell1, ngc, bt, bw, pta, b1855_wb, b1855_noise,
   small_wb) runs an api phase, counts zeroed around it, one line per
   entry point with its wall s and launches: ``d_delay_d_param``
   (b1855's M2, PB, A1, FD1, DMX_0001; ell1's EPS1, A1 and the frozen
   TASC; bw's FB1; pta's SWXDM_0001: 1e-10 of the column's largest), the
   derived parameters at the snapshot's values (1e-12 rel, sigmas 1e-10)
   and after the first fit (1e-2 sigma, sigmas 1e-6 rel), the labelled
   covariance (labels, diagonal 1e-6 rel, correlations 1e-6 abs),
   ``update_model``'s fields, the report's lines, the residual statistics
   (1e-10 s; ECORR epochs exactly, errors 1e-12 rel; the Taylor
   frequency 1e-13 rel), ``tuple_chisq`` at 37 points and
   ``grid_chisq_derived`` on a 16x16 (Mc, cos i) grid with ``doonefit``
   (chi2 1e-6 rel, argmin, rungs, refit values 1e-2 sigma),
   ``ModelState.predicted_chi2`` (1e-6 rel), ``PowellFitter`` on ngc and
   bt (chi2 1e-6 rel, values 1e-2 sigma, converged; its evaluations and
   ms per evaluation), on wideband TOAs the dispersion slope and the DM
   covariance (1e-13 rel) and the ``full_cov`` wideband downhill fit on
   small_wb; each path's api kernels must have launched.  Then the Kepler phase: ``kepler_2d``,
   ``kepler_3d`` and ``kepler_two_body`` with their ``jacfwd`` Jacobians
   on the card, on the orbits of ``kepler_reference.npz`` (e 0-0.95, one
   exactly circular) against the reference's values (1e-13 of each
   state's largest) and Jacobians (1e-10 of each output's largest
   partial), each warm call's time beside its bound (its float64
   operations, counted by a dispatch mode, at the instruction rate);
4. kernels -- each CUDA kernel (the primal and dual instantiations of K1,
   K2 and K4 -- K4's for ELL1, ELL1k, ELL1H exact and ELL1H harmonic --,
   K3's shared-memory instantiation at nt = 88 and its global one at nt =
   232, K5's tiled fold and SVD and its untiled global kernel) against
   its plain PyTorch twin on the card, on the inputs its path gave it
   (captured there) plus seeded random inputs: K1 at S = 1, 2, 3 and 6
   spin terms, k and f bitwise; K2 in each mode (DD on b1855's call, BT on
   bt's, DDGR on ddgr's, DDK on ddk's) and on random orbits with ECC 0-0.9
   and in bands at ~2e-5, 0.1, 0.6 and 0.95 (the Kepler solve's exits --
   fixed point, 2-cycle, all 15 steps -- counted per band by the twin's
   ``kepler_steps``, each must occur), delay bitwise, partials 1e-10 rel,
   and two rows whose NaN delays poison every partial (sini > 1: SINI, a1
   / ar, DDK's per-TOA sini; BT: NaN TOAs); the Newton steps' histogram
   and exits on the ddgr path's TOAs; K3 with an ill-conditioned
   and a NaN point; K4 on random orbits with |EPS| to 1e-2 and TOAs across
   the orbital phase's wrap, delay bitwise, partials 1e-10 rel, NaN rows
   poisoning all partials -- ELL1H's in both forms, the harmonic one at
   NHARMS = 3, 7 and 12 with stigma from STIGMA and from H4/H3, rows at
   H3 = 0; K5's tiled kernels each against its own
   plain version (the fold's triangles, rows up to sign, and the SVD
   kernel on the fold's workspace, on the path's call and on random
   systems at k = 88), then the wrapper against the twin on the ell1
   path's call, on ngc_phoff's (N = 62, rank k - 1 at every point), and
   on random systems (raw condition to 1e10, with an all-zero
   column and a NaN in the ragged last tile) at k = 88 and 111 (tiled)
   and at k = 130 and 233 (the untiled global kernel): x to 1e-9 of
   max|x|, singular values to 1e-12 of the largest, the same rank and NaN
   flags, the zero column's x exactly 0, no point of the path at the sweep
   cap; the tiled design (tile rows, WY block, the Jacobi's lanes, read
   from the built library) and, on the path's points, the kernel's gap to
   the twin beside the first-order least-squares sensitivity are printed.
   Then each K2 and K4 orbit-input instantiation on its mode's
   random orbits fed ``orbits_pb``'s orbits and pbprime, the delay
   bitwise against its twin and against the PB instantiation, partials
   1e-10 rel, NaN rows poisoning every partial (K2's DD also on
   small_dd_fbx's call, K4's ELL1 on bw's: timed, recorded); K6 in each
   form on its path's call (FBX bw, waves on FBX bw_waves, waves on PB
   small_dd_fbx) and on random coefficients and TOAs (the waves' duals
   also at 60 terms, a tile of fewer threads above 48 KB, and 230, the
   direct dual), orbits and pbprime bitwise, partials 1e-10 rel; K7 on
   pta's SWX call, on small_pta's and on random elongations 1-179 deg
   with indices 1.5-4.4 and windows, the geometry bitwise, partials 1e-10
   rel.
   K2's Newton steps on each path's inputs set its operation count; the
   per-element operation counts of K1, K2, K4, K6 and K7 are bounded at
   the float64 instruction rate (-fmad=false; K6's and K7's count each
   math-library call at its SASS count, ``SASS_OPS``); K5's counts what its function
   needs (QR at the float64 tensor-core rate, the k x k SVD at the CUDA
   cores' flop rate).
   CUDA-event times of kernel, twin and, for K3 and K5, the library call
   (Cholesky; a QR or the batched SVD), with the launches queued behind a
   spin kernel so that the events time the device and not the host's launch
   rate.  Launch counts, times and errors in the ``kernels`` line are per
   instantiation, launches from the path whose shapes the record was
   measured at.

The whole run's wall time is printed before the JSON lines.  The line
before the last is one JSON object with every kernel's record, then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failed phase or bar exits non-zero without the ok line; so does a
machine without a GPU, or a directory that holds this script without the
``pint_torch`` package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float64 rate of
#: the CUDA cores and that of the tensor cores (float64 matrix products)
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
F64_TC_FLOP_PER_S = 67e12
#: float64 instructions per second of the CUDA cores: 132 SMs x 64 FP64
#: lanes x 1.98 GHz.  The 34 TFLOP/s above counts a fused multiply-add as
#: two operations; the kernels are built with -fmad=false (their
#: double-double and folded products must round alone), so each add and
#: multiply is an instruction of its own, and the per-element operation
#: counts of K1, K2 and K4 are bounded at this rate
F64_INSTR_PER_S = 132 * 64 * 1.98e9

#: float64 operations per element of ``dd_binary.cu``, counted from the
#: source with a sine, cosine, arctangent, logarithm or square root counted
#: as 20 and any other operation as 1: ``dd_forward`` (both
#: instantiations) 403 outside Kepler's equation plus 49 per Newton step
#: (1138 at the reference's fixed 15 steps; the kernel stops once the
#: iterate repeats, and the two integer comparisons of its exit test are
#: not counted); ``dd_reverse`` (the dual instantiation's partials) 242
#: more.
K2_FORWARD_OPS = 403
K2_NEWTON_OPS = 49
K2_REVERSE_OPS = 242
#: the same per mode (0 DD, 1 BT, 2 DDGR, 3 DDK), (forward outside
#: Kepler's equation, reverse sweep): BT's own passes, counted alike (the
#: orbits, a1, omega_bt and two sincos pairs, 161; its reverse sweep 77);
#: DDGR reads k and m2 from its row (5 fewer) and divides a1 by ar (1
#: more), and its sweep drops k's chain and the TSUN product (7) for
#: ar's partial and a1's share (5); DDK adds its two offsets (2); BTX (4)
#: is BT with a per-TOA a1 in place of the row's.  The orbit-input forms
#: read orbits and pbprime in place of forming them (7 and 6 fewer in the
#: forward pass, BT 5, and 9 fewer in the sweep)
K2_MODE_OPS = {0: (K2_FORWARD_OPS, K2_REVERSE_OPS), 1: (161, 77),
               2: (K2_FORWARD_OPS - 4, K2_REVERSE_OPS - 2),
               3: (K2_FORWARD_OPS + 2, K2_REVERSE_OPS), 4: (161, 77)}


#: float64 operations per element of ``ell1_binary.cu``, counted from the
#: source as K2's are, by mode (0 ELL1, 1 ELL1k): ``ell1_forward`` 391 and
#: 392 (five sincos pairs and a log, 200 of them), ``ell1_reverse`` 278 and
#: 321 more in the dual.  Of these the M2/SINI Shapiro delay takes 25 of
#: the forward pass and 31 of the reverse sweep; ELL1H's orthometric forms
#: replace them (:func:`_k4_ops`).
K4_FORWARD_OPS = {0: 391, 1: 392}
K4_REVERSE_OPS = {0: 278, 1: 321}
K4_SHAPIRO_OPS = (25, 31)


def _k4_ops(mode: int, partials: bool, nharms: int = 7) -> int:
    """float64 operations per element of ``ell1_binary.cu`` in ``mode``
    (0 ELL1, 1 ELL1k, 2 ELL1H exact, 3 ELL1H harmonic to ``nharms``),
    counted from the source: ELL1H shares ELL1's inverse delay and reverse
    sweep less their M2/SINI Shapiro terms; its exact form adds 34 (a log
    among them) to the forward pass and 31 to the reverse sweep; each
    harmonic k adds its coefficient (2), the products of stigma^(k-3) by
    binary powering, 3 more and, past k = 4, k phi and a sine or cosine
    (21) to the forward pass, and to the reverse sweep both of sin and cos
    (41 past k = 4) and 8 plus the powering of stigma^(k-3) and
    stigma^(k-4)."""
    if mode in (0, 1):
        return K4_FORWARD_OPS[mode] + (K4_REVERSE_OPS[mode] if partials
                                       else 0)

    def powering(y):
        return 0 if y < 1 else bin(y).count("1") - 1 + y.bit_length() - 1

    fwd = K4_FORWARD_OPS[0] - K4_SHAPIRO_OPS[0]
    rev = K4_REVERSE_OPS[0] - K4_SHAPIRO_OPS[1]
    if mode == 2:
        fwd, rev = fwd + 34, rev + 31
    else:
        fwd += 2
        rev += 7
        for k in range(3, nharms + 1):
            fwd += 2 + powering(k - 3) + 3 + (21 if k > 4 else 0)
            rev += 2 + (41 if k > 4 else 0) + 4 + powering(k - 3)
            if k > 3:
                rev += 4 + powering(k - 4)
    return fwd + (rev if partials else 0)


def _k5_ops(N: int, k: int):
    """float64 operations per point that ``wls_lstsq``'s function needs,
    whatever algorithm computes it: ``qr``, those a blocked Householder QR
    of the (N, k) matrix runs as matrix products (2 N k^2 - 2 k^3 / 3);
    ``fold``, the rest of the tiled fold's share -- the column norms and
    scaling (3 N k), applying the k reflectors to rw (4 N k - 2 k^2); and
    ``svd``, the SVD kernel's: an SVD of the k x k triangle with
    V (12 k^3, Golub-Kahan-Reinsch with the left rotations applied to one
    vector) and x (4 k^2)."""
    return dict(qr=2 * N * k * k - 2 * k**3 / 3,
                fold=3 * N * k + 4 * N * k - 2 * k * k,
                svd=12 * k**3 + 4 * k * k)


def _k2_ops(steps: float, partials: bool, mode: int = 0) -> float:
    """float64 operations per element of ``dd_binary.cu`` in ``mode`` at a
    mean of ``steps`` Newton steps per element."""
    fwd, rev = K2_MODE_OPS[mode]
    return fwd + K2_NEWTON_OPS * steps + (rev if partials else 0)


def _k1_ops(S: int, has_pe: bool, partials: bool) -> int:
    """float64 operations per element of ``spin_phase.cu``'s
    ``spin_phase_math``, counted from the source.  Each fold costs 31 on
    plain doubles: 28 in ``mul_mod1_impl`` (two scaled splits of 4, three
    folded products of 5, the last product 2 and its carry 3) and 3 to
    gather it.  The dual instantiation keeps the folds on doubles and adds,
    for each of its S + 2 lanes, 5 per fold (the custom JVP t*dc + c*dt and
    the two gathers), 3 per Dual product and 1 per sum.  The Horner loop's
    factorials are not counted."""
    nf = 3 if has_pe else 1
    primal = 31 * nf + 7      # folds; tail; dt + tail, F0*tail into f; round
    lanes = 5 * nf + 6
    if has_pe:
        primal += 11          # PEPOCH - tdb0, day2sec, negations, PEPOCH lo
        lanes += 3
    if S > 1:
        primal += 3 * (S - 1) + 3     # Horner, then acc*dt*dt into f
        lanes += 5 * (S - 1) + 7
    return primal + (S + 2) * lanes if partials else primal


#: float64 instructions one call of CUDA's math library runs on its fast
#: path, counted in the SASS that nvcc emits with the kernels' flags
#: (``-fmad=false``) by ``tools/torch_sass_ops.py``: the float64-pipe
#: instructions (DADD, DMUL, DFMA, DSETP, conversions) from a one-call
#: kernel's entry to its EXIT, with the calls no branch skips followed
#: (``pow`` keeps its core out of line) and the slow paths (a huge
#: argument's reduction, a subnormal, a division's exceptions) left out;
#: predicated fix-ups before the EXIT count, so a count may exceed the
#: fast path's by an instruction or two.  Counted for sm_90a by nvcc 12.9
#: (NVIDIA H100 80GB HBM3).  A division is ``div``.
SASS_OPS = {"sin": 18, "cos": 18, "sincos": 23, "atan": 28, "atan2": 40,
            "log": 30, "exp": 18, "pow": 94, "sqrt": 8, "div": 8,
            "hypot": 15}


def _k6_ops(form: int, nfb: int, nw: int, partials: bool) -> int:
    """float64 instructions per element of ``binary_orbits.cu``'s work,
    with a sincos and a division at their SASS counts and every other
    operation as 1 (the reciprocals 1/n of the ladders are constants, not
    counted).  Forward: the Horner ladder 6 a term, then orbits t and
    1/freq (9); the PB base's period, t/pb and 1/pb (17); the waves on an
    FBX base a second reciprocal (8); each wave term its frequency, phase,
    sincos, sum and rate (34) and the waves' tw, sums and 1/(inv +
    dphi_dot) (11).  Dual: -pbprime^2 and pbprime's t entry (2); the FB
    columns' powers and scaled rows and the rate's ladder (6 a term, less
    3); the PB base's entries (36); each wave term its sincos and 25
    more, and the OM columns (2)."""
    sc, dv = SASS_OPS["sincos"], SASS_OPS["div"]
    fb = 6 * nfb + 1 + dv
    fwd = {0: fb, 1: 1 + 2 * dv, 2: fb + dv}[form]
    if form:
        fwd += (sc + 11) * nw + 3 + dv
    if not partials:
        return fwd
    rev = 2 + (6 * nfb - 3 if form != 1 else 20 + 2 * dv)
    if form:
        rev += (sc + 25) * nw + 2
    return fwd + rev


#: float64 instructions per element (a TOA in a window) of
#: ``solar_wind_pl.cu``'s work, whatever computes it: a power counts as
#: one logarithm, one exponential and one product, the dual's d/dp term
#: reuses the node's logarithm, and sin and cos of one angle are one
#: sincos, each at its SASS count (``SASS_OPS``); every other operation is
#: 1.  The elongation: sincos, two products, u = z/b, atan and two more
#: (63); each of the 64 nodes: the primal's cos, log, exp and 4 (70; the
#: built kernel's node loop runs 70 float64 instructions a pass,
#: tools/torch_sass_ops.py), the dual's sincos, log, exp, a division and
#: 12 (91; its loop 91); the tail: (AU/b)^p (b/pc) with I and the sum (two
#: divisions, log, exp and 5: 69); the dual's partials three divisions
#: and 20 more (44).  The same count bounds any implementation: CUDA's
#: pow() or exp(y log x).
_SC, _LOG, _EXP, _DIV = (SASS_OPS[k] for k in ("sincos", "log", "exp",
                                                 "div"))
K7_ELONGATION = _SC + 2 + _DIV + SASS_OPS["atan"] + 2
K7_TAIL = 2 * _DIV + _LOG + _EXP + 5
K7_OPS = {False: K7_ELONGATION + 64 * (SASS_OPS["cos"] + _LOG + _EXP + 4)
          + K7_TAIL,
          True: K7_ELONGATION + 64 * (_SC + _LOG + _EXP + _DIV + 12)
          + K7_TAIL + 3 * _DIV + 20}


def _aten_ops(fn):
    """(float64 operations, result) of one call of ``fn``, counted by a
    dispatch mode over the aten operations it runs: an elementwise
    operation counts each output element once, a math-library one
    (``SASS_OPS``) its SASS count, a square or cube 1 or 2, a batched
    matrix product 2 k for each output element; views, copies, fills and
    stacking count none."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    free = {"select", "view", "_unsafe_view", "alias", "scalar_tensor",
            "permute", "expand", "_efficientzerotensor", "zeros", "ones",
            "stack", "_to_copy", "to", "unsqueeze", "squeeze", "cat",
            "slice", "zeros_like", "ones_like", "lift_fresh", "new_zeros",
            "new_ones", "diagonal", "fill_", "split_with_sizes",
            "transpose", "clone", "t", "detach", "copy_", "empty",
            "empty_like", "new_empty", "unbind", "as_strided"}
    lib = {"sin": "sin", "cos": "cos", "atan2": "atan2", "atan": "atan",
           "sqrt": "sqrt", "div": "div", "reciprocal": "div",
           "hypot": "hypot", "exp": "exp", "log": "log", "pow": "pow"}
    total = [0.0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in free:
                return out
            res = out[0] if isinstance(out, (tuple, list)) else out
            n = res.numel() if torch.is_tensor(res) else 1
            if name in ("bmm", "mm", "matmul"):
                n *= 2 * args[0].shape[-1]
            elif name == "pow" and not torch.is_tensor(args[1]) \
                    and args[1] in (2, 3):
                n *= args[1] - 1
            else:
                n *= SASS_OPS.get(lib.get(name, ""), 1)
            total[0] += n
            return out

    with Count():
        res = fn()
    return total[0], res


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Capture:
    """Spy on each kernel module's ``_launch``: keeps a copy of the largest
    call's inputs per (kernel, partials) -- per (kernel, (mode, partials))
    for K2 and K4 on PB orbits, (kernel, (mode, partials, True)) with
    orbit inputs, (kernel, (form, partials)) for K6 -- so the comparisons
    run at the main path's shapes.  Counting stays in the original
    ``_launch``."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = {}
        self._orig = {}

    def install(self):
        for name, mod in self.kernels.items():
            orig = mod._launch
            self._orig[name] = orig

            def spy(*args, _orig=orig, _name=name):
                self._record(_name, args)
                return _orig(*args)

            mod._launch = spy

    def remove(self):
        for name, mod in self.kernels.items():
            mod._launch = self._orig[name]

    def _record(self, name, args):
        import torch

        if name == "dd_binary":
            partials = (int(args[2]), bool(args[5])) + (
                (True,) if args[4] is not None else ())
        elif name == "ell1_binary":
            partials = (int(args[2]), bool(args[3])) + (
                (True,) if len(args) > 6 and args[6] is not None else ())
        elif name == "binary_orbits":
            partials = (int(args[2]), bool(args[6]))
        else:
            partials = args[-1] if name in ("spin_phase", "solar_wind_pl") \
                else None
        size = sum(a.numel() for a in args if torch.is_tensor(a))
        key = (name, partials)
        if key not in self.calls or self.calls[key][0] < size:
            self.calls[key] = (size, tuple(
                a.clone() if torch.is_tensor(a) else
                tuple(v.clone() for v in a) if isinstance(a, tuple) else a
                for a in args))

    def args(self, name, partials=None):
        return self.calls[(name, partials)][1]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel that holds the stream until the host has
    queued them all, so that a kernel shorter than its launch's host cost
    is timed back to back and not at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * 2e9) + 1000)  # ~2 GHz clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: float, tensor_ops: float = 0.0,
           rate: float = F64_FLOP_PER_S):
    """Least ms for the work: bytes over HBM bandwidth or ``ops`` over
    ``rate`` (the CUDA cores' float64 flop rate, or for the per-element
    instruction counts of K1, K2 and K4 their instruction rate) plus
    ``tensor_ops`` (matrix products) over the tensor cores', whichever is
    longer, and which it is."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = (ops / rate + tensor_ops / F64_TC_FLOP_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _grid_of(meta, ref):
    """The snapshot's grid: (parameter names, axes); M2 x SINI unless its
    reference names others; None for a snapshot without a grid."""
    if "ref/grid_chi2" not in ref:
        return None
    names = tuple(meta["reference"].get("grid_params", ("M2", "SINI")))
    return names, tuple(ref[f"ref/grid_{n.lower()}"] for n in names)


def _drive(label, path, kernels, tag):
    """One main path on one snapshot, counts zeroed just before and read
    just after: load, residuals, design matrix cold and warm, the fits the
    reference ran on it, each from the snapshot's values -- ``GLSFitter``
    with correlated noise, else ``WLSFitter`` and ``DownhillWLSFitter``;
    then ``Fitter.auto``'s fitter and, where the snapshot holds them, both
    WLS fitters' Huber fits (a fit whose reference raised ``StepProblem``
    must raise it too) -- then the 16x16 grid after the first fit, cold and
    warm, at the snapshot's ``niter`` (where the snapshot has one); returns
    (counts, capture, outputs)."""
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import (DownhillWLSFitter, Fitter, StepProblem,
                                   WLSFitter)
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.residuals import Residuals
    from pint_torch.wideband import (WidebandDownhillFitter,
                                     WidebandLMFitter, WidebandTOAFitter,
                                     WidebandTOAResiduals)

    meta, ref = read_snapshot(path)
    rr = meta["reference"]
    niter = rr["settings"]["grid_niter"]
    grid = _grid_of(meta, ref)
    cap = Capture(kernels.modules())
    cap.install()
    kernels.reset_counts()
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        return out

    def fit(key, fitter, **kw):
        """``fitter.fit_toas(**kw)`` as stage ``fit_<key>``: (fitter,
        chi2), or (fitter, the StepProblem's text) where it raises one."""
        try:
            return fitter, stage(f"fit_{key}", lambda: fitter.fit_toas(**kw))
        except StepProblem as e:
            return fitter, f"StepProblem: {e}"

    model, batch = stage("load", lambda: load_snapshot(path, device="cuda"))
    abs_phase = "AbsPhase" in model.components
    wide = None
    if batch.wideband:
        def wideband_resids():
            wr = WidebandTOAResiduals(batch, model)
            return wr, wr.time_resids, wr.dm.resids

        wr, resid, dm_resid = stage("residuals", wideband_resids)
        wide = dict(dm_resid=dm_resid, chi2=wr.calc_chi2())
        wide["M_dm"] = stage("dm_designmatrix",
                             lambda: model.dm_designmatrix(batch))[0]
    else:
        resid = stage("residuals",
                      lambda: Residuals(batch, model).time_resids)
    phase_int = model.phase(batch, abs_phase=abs_phase).int_ \
        if abs_phase else None
    M, _ = stage("designmatrix", lambda: model.designmatrix(batch))
    stage("designmatrix_warm", lambda: model.designmatrix(batch))
    gls = model.has_correlated_errors
    maxiter = rr["settings"]["fit_maxiter"]
    if batch.wideband:
        fitter = WidebandTOAFitter(batch, model)
        fits = {"postfit": fit("postfit", fitter, maxiter=maxiter),
                "full_cov": fit("full_cov", WidebandTOAFitter(batch, model),
                                maxiter=maxiter, full_cov=True),
                "downhill": fit("downhill",
                                WidebandDownhillFitter(batch, model)),
                "lm": fit("lm", WidebandLMFitter(batch, model))}
    else:
        fitter = (GLSFitter if gls else WLSFitter)(batch, model)
        fits = {"postfit": fit("postfit", fitter, maxiter=maxiter)}
    if not gls and not batch.wideband:
        fits["downhill"] = fit("downhill", DownhillWLSFitter(batch, model))
    # Fitter.auto's fit with the noise parameters the reference freed for
    # it: the alternation of timing and noise fits, each noise fit timed
    auto_model = model
    if rr.get("auto_noise_params"):
        auto_model = model.copy()
        for p in rr["auto_noise_params"]:
            auto_model[p].frozen = False
    auto = Fitter.auto(batch, auto_model)
    noise_rounds = _timed_noise_fits(auto)
    fits["auto"] = fit("auto", auto)
    if noise_rounds:
        # the likelihood's Hessian alone, warm, at the fit's noise values
        vg, hess, names = next(v for k, v in auto.model._cache.items()
                               if isinstance(k, tuple)
                               and k[0] == "noisefit_fns")
        x = torch.tensor([auto.model.value(p) for p in names],
                         dtype=torch.float64, device=batch.device)
        rs = [auto.resids.time_resids] + (
            [auto.resids.dm.resids] if batch.wideband else [])
        stage("noise_hessian_warm", lambda: hess(x, *rs))
    if "huber_iterations" in rr or "huber_error" in rr:
        fits["huber"] = fit("huber", WLSFitter(batch, model),
                            robust="huber", maxiter=maxiter)
        fits["huber_downhill"] = fit("huber_downhill",
                                     DownhillWLSFitter(batch, model),
                                     robust="huber")
    surface = None
    if grid is not None:
        gnames, axes = grid
        stage("grid_cold", lambda: grid_chisq(fitter, gnames, axes,
                                              niter=niter, chunk=256))
        surface, _ = stage("grid_warm", lambda: grid_chisq(
            fitter, gnames, axes, niter=niter, chunk=256))
    counts = kernels.launch_counts()
    cap.remove()
    k = 1 + len(fitter.model.free_params) - (len(grid[0]) if grid else 0)
    system = "wideband (TOA+DM) k" if batch.wideband \
        else "GLS nt" if gls else "WLS k"
    print(f"phase main path {label}: N={batch.ntoas} TOAs, "
          f"{len(model.free_params)} free, {system}={k}, "
          + (f"{gnames[0]} x {gnames[1]} grid niter={niter}; "
             if grid else "no grid; ")
          + ", ".join(f"{n} {v:.4f} s" for n, v in stages.items())
          + (f"; warm grid {surface.size / stages['grid_warm']:.2f} fits/s"
             if grid else "")
          + f"; launches (nonzero) {dict((k, v) for k, v in counts.items() if v)}"
          f" {tag}", flush=True)
    return counts, cap, dict(meta=meta, ref=ref, resid=resid, M=M,
                             phase_int=phase_int, fitter=fitter, fits=fits,
                             surface=surface, wide=wide,
                             noise_rounds=noise_rounds)


def _timed_noise_fits(fitter) -> list:
    """Time each noise fit of the fitter's alternation: a list that fills
    with (result, wall seconds) as ``fit_noise`` returns."""
    import torch

    rounds = []
    fit_noise = fitter.fit_noise

    def timed(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fit_noise(**kw)
        torch.cuda.synchronize()
        rounds.append((res, time.perf_counter() - t))
        return res

    fitter.fit_noise = timed
    return rounds


def _bars(label, out):
    """The path's outputs against the reference outputs in its snapshot:
    residuals (and the absolute phase's integer part, exactly); each fit's
    chi2, values and uncertainties, or the reference's own StepProblem;
    ``Fitter.auto``'s class, converged flag and downhill steps and its
    noise amplitudes (1e-6 of their largest); the downhill fit's converged
    flag; the Huber fits' weights (1e-6), down-weighted set and IRLS
    rounds; the grid's surface, argmin and rungs (where there is one).
    Wideband TOAs: the DM residuals (1e-12 pc/cm^3) and the joint chi2
    (1e-6 rel), and the LM fit's converged flag.  A fit with free noise
    parameters: each noise round's L-BFGS-B iterations and converged flag
    equal, its lnlike 1e-9 rel, the noise values within 1e-2 of their
    uncertainties and the timing uncertainties 1e-4 rel.  Raises on a
    failed bar."""
    import numpy as np

    meta, ref = out["meta"], out["ref"]
    rref = meta["reference"]
    d_res = float(np.abs(out["resid"].cpu().numpy()
                         - ref["ref/time_resids"]).max())
    Mr = ref["ref/designmatrix"]
    d_M = float((np.abs(out["M"].cpu().numpy() - Mr).max(0)
                 / np.maximum(np.abs(Mr).max(0), 1e-300)).max())
    checks = [(d_res <= 1e-10, "residuals")]
    notes = []
    wide = out["wide"]
    if wide is not None:
        d_dm = float(np.abs(wide["dm_resid"].cpu().numpy()
                            - ref["ref/dm_resids"]).max())
        c_wb = abs(wide["chi2"] / rref["combined_chi2"] - 1)
        Md = ref["ref/dm_designmatrix"]
        d_Md = float((np.abs(wide["M_dm"].cpu().numpy() - Md).max(0)
                      / np.maximum(np.abs(Md).max(0), 1e-300)).max())
        checks += [(d_dm <= 1e-12, "DM residuals"),
                   (c_wb <= 1e-6, "joint TOA+DM chi2")]
        notes.append(f"DM residuals max|d| {d_dm:.3e} pc/cm3 (<= 1e-12), "
                     f"joint chi2 rel {c_wb:.3e} (<= 1e-6), DM design matrix "
                     f"max col-rel {d_Md:.3e}")
    if out["phase_int"] is not None:
        same_int = bool(np.array_equal(out["phase_int"].cpu().numpy(),
                                       ref["ref/abs_phase_int"]))
        checks.append((same_int, "absolute phase's integer part"))
        notes.append(f"absolute phase integers equal {same_int}")
    for key, (f, chi2) in out["fits"].items():
        want_err = rref.get(f"{key}_error")
        if want_err is not None or isinstance(chi2, str):
            checks.append((chi2 == want_err, f"{key} outcome"))
            notes.append(f"{key} raised {chi2!r} vs {want_err!r}")
            continue
        vals = np.array([f.model.value(p) for p in rref["postfit_params"]])
        uncs = np.array([f.model[p].uncertainty
                         for p in rref["postfit_params"]])
        sig = ref[f"ref/{key}_uncertainties"]
        c = abs(chi2 / rref[f"{key}_chi2"] - 1)
        v = float(np.abs((vals - ref[f"ref/{key}_values"]) / sig).max())
        u = float(np.abs(uncs / sig - 1).max())
        if key.startswith("huber"):
            # Huber's bars: weights, the down-weighted set, IRLS rounds;
            # its chi2 is printed (on a PHOFF model it moves at first order
            # with the near-degenerate DM-PHOFF direction's rounding)
            w = f.robust_weights.cpu().numpy()
            wr = ref[f"ref/{key}_weights"]
            dw = float(np.abs(w - wr).max())
            same_set = bool(np.array_equal(w < 1.0, wr < 1.0))
            rounds = (f.robust_iterations, rref[f"{key}_iterations"])
            checks += [(dw <= 1e-6, f"{key} weights"),
                       (same_set, f"{key} down-weighted set"),
                       (rounds[0] == rounds[1], f"{key} IRLS rounds"),
                       (v <= 1e-2, f"{key} values"),
                       (u <= 1e-6, f"{key} uncertainties")]
            notes.append(f"{key} weights max|d| {dw:.3e} (<= 1e-6), "
                         f"{int((wr < 1).sum())} down-weighted, same set "
                         f"{same_set}, rounds {rounds[0]} vs {rounds[1]}, "
                         f"values max {v:.3e} sigma (<= 1e-2), "
                         f"uncertainties rel {u:.3e} (<= 1e-6), chi2 rel "
                         f"{c:.3e}")
            continue
        # after an alternation with noise fits, the timing uncertainties
        # carry the noise values' optimizer tolerance: 1e-4
        u_bar = 1e-4 if key == "auto" and "auto_noise_names" in rref \
            else 1e-6
        checks += [(c <= 1e-6, f"{key} chi2"), (v <= 1e-2, f"{key} values"),
                   (u <= u_bar, f"{key} uncertainties")]
        notes.append(f"{key} chi2 rel {c:.3e} (<= 1e-6), values max "
                     f"{v:.3e} sigma (<= 1e-2), uncertainties rel {u:.3e} "
                     f"(<= {u_bar:g})")
        if f"{key}_converged" in rref and key != "auto":
            pair = (bool(f.converged), rref[f"{key}_converged"])
            checks.append((pair[0] == pair[1], f"{key} converged flag"))
            notes.append(f"{key} converged {pair[0]} vs {pair[1]}")
        if key == "auto" and "auto_noise_names" in rref:
            checks += _noise_bars(f, out["noise_rounds"], ref, rref, notes)
        if key == "auto":
            pair = ((bool(f.converged), f.iterations),
                    (rref["auto_converged"], rref["auto_iterations"]))
            checks.append((pair[0] == pair[1],
                           "auto converged flag and steps"))
            want = {k.rsplit("/", 1)[1]: a for k, a in ref.items()
                    if k.startswith("ref/auto_noise_ampls/")}
            d_n = max((float(np.abs(f.noise_ampls[c_].cpu().numpy() - a)
                             .max() / np.abs(a).max())
                       for c_, a in want.items()), default=0.0)
            checks.append((set(getattr(f, "noise_ampls", {})) == set(want)
                           and d_n <= 1e-6, "auto noise amplitudes"))
            notes.append(f"auto converged, steps {pair[0]} vs {pair[1]}"
                         + (f", noise amplitudes max {d_n:.3e} of their "
                            "largest (<= 1e-6)" if want else ""))
    auto_cls = type(out["fits"]["auto"][0]).__name__
    checks.append((auto_cls == rref["auto_fitter"], "Fitter.auto class"))
    surface = out["surface"]
    grid_note = "no grid"
    if surface is not None:
        d_grid = float(np.abs(surface / ref["ref/grid_chi2"] - 1).max())
        argmin = [int(i) for i in np.unravel_index(
            int(np.nanargmin(surface)), surface.shape)]
        rungs = out["fitter"].last_grid_diagnostics["ladder_rung"]
        same_rungs = bool(np.array_equal(rungs, ref["ref/grid_rungs"]))
        checks += [(d_grid <= 1e-6, "grid surface"),
                   (argmin == rref["grid_argmin"], "grid argmin"),
                   (same_rungs, "grid rungs")]
        grid_note = (f"grid max rel {d_grid:.3e} (<= 1e-6); argmin {argmin} "
                     f"vs {rref['grid_argmin']}; rungs "
                     f"{sorted(set(rungs.ravel().tolist()))} equal "
                     f"{same_rungs}")
    print(f"phase bars {label}: residuals max|d| {d_res:.3e} s (<= 1e-10); "
          f"design matrix max col-rel {d_M:.3e}; Fitter.auto {auto_cls} vs "
          f"{rref['auto_fitter']}; " + "; ".join(notes) + f"; {grid_note}",
          flush=True)
    for ok, what in checks:
        if not ok:
            raise RuntimeError(f"bar failed ({label}): {what}")


#: the API's refit parameters the grids report (the exporter's API_EXTRA)
API_EXTRA = ("A1", "PB")


def _derived_m2(mc, cosi):
    return mc


def _derived_sini(mc, cosi):
    import numpy as np

    return np.sqrt(1.0 - cosi**2)


def _api_phase(label, out, kernels, tag) -> dict:
    """The fitter, residuals, model and grid API on one path, against the
    reference's outputs under the snapshot's ``ref/api/``; launch counts
    zeroed just before and read just after, each entry point's wall s
    (after synchronize) and its launches printed on a line of its own.
    Bars: ``d_delay_d_param`` 1e-10 of the column's largest; the derived
    parameters at the snapshot's values 1e-12 rel (sigmas 1e-10 rel),
    after the first fit within 1e-2 of their sigma (sigmas 1e-6 rel);
    the covariance's labels, diagonal 1e-6 rel, correlations 1e-6 abs;
    ``update_model``'s START, FINISH and NTOA exact, CHI2, CHI2R, TRES and
    DMRES 1e-6 rel, DMDATA equal; the report's lines; the residual
    statistics 1e-10 s (the phase mean 1e-10 s x F0), the ECORR epochs
    exactly and their errors 1e-12 rel, the Taylor frequency and the basis
    weights 1e-13 rel; ``predicted_chi2`` 1e-6 rel; Powell's chi2 1e-6 rel,
    values 1e-2 sigma and converged flag; the tuple and derived grids'
    chi2 1e-6 rel with argmin and rungs, refit values 1e-2 sigma;
    ``doonefit`` likewise; the wideband downhill fit with ``full_cov`` at
    the fit bars; on wideband TOAs the dispersion slope and the DM
    covariance 1e-13 rel (against the reference's total DM and scaled DM
    errors).  Returns the phase's launch counts."""
    import re

    import numpy as np
    import torch

    from pint_torch import fitter as PF
    from pint_torch.gls_fitter import DownhillGLSFitter
    from pint_torch.grid import doonefit, grid_chisq_derived, tuple_chisq
    from pint_torch.wideband import WidebandDownhillFitter

    meta, ref = out["meta"], out["ref"]
    rr = meta["reference"]
    api = rr["api"]
    f = out["fitter"]
    model, batch = f.model_init, f.batch
    P = "ref/api/"
    checks, lines = [], []
    kernels.reset_counts()
    last = dict(kernels.launch_counts())

    def entry(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        now = kernels.launch_counts()
        d = {k: now[k] - last[k] for k in now if now[k] != last[k]}
        last.update(now)
        lines.append((name, wall, d))
        return res

    def rel(a, b):
        return abs(float(a) / float(b) - 1)

    def check(ok, what):
        checks.append((bool(ok), what))

    for key in sorted(k for k in ref if k.startswith(P + "d_delay/")):
        p = key.rsplit("/", 1)[1]
        got = entry(f"d_delay_d_param({p})",
                    lambda: model.d_delay_d_param(batch, p)).cpu().numpy()
        want = ref[key]
        gap = float(np.abs(got - want).max() / np.abs(want).max())
        check(gap <= 1e-10, f"d_delay_d_param({p})")
        lines[-1] += (f"max|d| {gap:.3e} of the column's largest",)

    def derived_bars(d, key, post):
        keys = api[f"{key}_keys"]
        vals, sigs = ref[f"{P}{key}_values"], ref[f"{P}{key}_sigmas"]
        check([k for k in d if k != "Binary"] == keys
              and d.get("Binary") == api[f"{key}_binary"], f"{key} keys")
        worst = 0.0
        for k, v, s_ in zip(keys, vals, sigs):
            gv, gs = d[k]
            if post and s_:
                dv = abs(float(gv) - v) / s_
                ok = dv <= 1e-2 and abs(gs / s_ - 1) <= 1e-6
            else:
                dv = abs(float(gv) - v) / max(abs(v), 1e-300)
                ok = dv <= (1e-6 if post else 1e-12) and (
                    abs(gs - s_) <= 1e-10 * abs(s_))
            worst = max(worst, dv)
            check(ok, f"{key} {k}")
        return worst

    if "update_model" in api:
        d = entry("get_derived_params(snapshot values)",
                  lambda: model.get_derived_params(returndict=True)[1])
        lines[-1] += (f"values max rel {derived_bars(d, 'derived_pre', False):.3e}",)
        um = api["update_model"]
        fm = f.model
        check(fm["START"].value == (um["START"], 0.0)
              and fm["FINISH"].value == (um["FINISH"], 0.0)
              and fm["NTOA"].value == um["NTOA"]
              and fm["DMDATA"].value == um["DMDATA"], "update_model exact")
        for k in ("CHI2", "CHI2R", "TRES", "DMRES"):
            check((fm[k].value is None) == (um[k] is None) and (
                um[k] is None or rel(fm[k].value, um[k]) <= 1e-6),
                f"update_model {k}")
        cov = entry("parameter_covariance_matrix",
                    lambda: f.parameter_covariance_matrix)
        corr = f.get_parameter_correlation_matrix().matrix
        dd = float(np.abs(np.diag(cov.matrix) / np.diag(ref[P + "cov"])
                          - 1).max())
        dc = float(np.abs(corr - ref[P + "corr"]).max())
        check(cov.get_label_names(axis=0) == api["cov_labels"], "cov labels")
        check(dd <= 1e-6 and dc <= 1e-6, "covariance")
        lines[-1] += (f"diagonal max rel {dd:.3e}, correlations max|d| "
                      f"{dc:.3e}",)
        d = entry("get_derived_params(after the fit)",
                  lambda: f.get_derived_params(returndict=True)[1])
        lines[-1] += (f"values max {derived_bars(d, 'derived_post', True):.3e} sigma",)
        text = entry("get_summary", f.get_summary)
        num = re.compile(r"(?<![A-Za-z_\d.])[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")

        def skel(t):
            return [" ".join(num.sub("#", x).split()) for x in t.splitlines()]

        check(skel(text) == skel(api["summary"]), "summary lines")
    if "rms_weighted" in api:
        r = f.resids
        F0 = f.model.value("F0")
        got = entry("rms_weighted, calc_time_mean, calc_phase_mean",
                    lambda: (r.rms_weighted(), r.calc_time_mean(),
                             r.calc_phase_mean()))
        want = (api["rms_weighted"], api["time_mean"], api["phase_mean"])
        gaps = [abs(a - b) for a, b in zip(got, want)]
        check(gaps[0] <= 1e-10 and gaps[1] <= 1e-10
              and gaps[2] <= 1e-10 * F0, "rms and means")
        w = entry("calc_whitened_resids",
                  lambda: r.calc_whitened_resids() * r.get_data_error())
        dw = float(np.abs(w.cpu().numpy() - ref[P + "whitened_times_sigma"])
                   .max())
        nr = entry("noise_resids", r.noise_resids)
        dn = max(float(np.abs(v.cpu().numpy()
                              - ref[f"{P}noise_resids/{k}"]).max())
                 for k, v in nr.items())
        check(dw <= 1e-10 and dn <= 1e-10 and len(nr) == len(
            [k for k in ref if k.startswith(P + "noise_resids/")]),
            "whitened residuals and noise realizations")
        fr_ = entry("get_PSR_freq(taylor)",
                    lambda: r.get_PSR_freq("taylor")).cpu().numpy()
        df = float(np.abs(fr_ / ref[P + "psr_freq_taylor"] - 1).max())
        wb = model.full_basis_weight(batch)
        dwb = float(np.abs(wb / ref[P + "full_basis_weight"] - 1).max())
        ea = entry("ecorr_average", r.ecorr_average)
        idx = np.concatenate([np.asarray(i, dtype=np.int64)
                              for i in ea["indices"]])
        de = float(np.abs(ea["time_resids"].cpu().numpy()
                          - ref[P + "ecorr_time_resids"]).max())
        der = float(np.abs(ea["errors"].cpu().numpy()
                           / ref[P + "ecorr_errors"] - 1).max())
        check(df <= 1e-13 and dwb <= 1e-13, "Taylor frequency, weights")
        check(np.array_equal(idx, ref[P + "ecorr_indices"])
              and np.array_equal([len(i) for i in ea["indices"]],
                                 ref[P + "ecorr_index_counts"])
              and de <= 1e-10 and der <= 1e-12, "ecorr_average")
        lines[-1] += (f"rms/means max|d| {max(gaps[:2]):.3e} s, whitened x "
                      f"sigma {dw:.3e} s, noise realizations {dn:.3e} s, "
                      f"Taylor frequency rel {df:.3e}, epoch averages "
                      f"{de:.3e} s, errors rel {der:.3e}",)
    if P + "tuple_chi2" in ref:
        niter = rr["settings"]["grid_niter"]
        sig = api["errors"]
        pts = ref[P + "tuple_points"]
        c2, ex = entry("tuple_chisq", lambda: tuple_chisq(
            f, ("M2", "SINI"), pts, extraparnames=API_EXTRA, niter=niter,
            chunk=256))
        rungs = f.last_grid_diagnostics["ladder_rung"]
        d2 = float(np.abs(c2 / ref[P + "tuple_chi2"] - 1).max())
        dx = max(float(np.abs((ex[k] - ref[f"{P}tuple_extra/{k}"])
                              / sig[k]).max()) for k in API_EXTRA)
        check(d2 <= 1e-6 and dx <= 1e-2
              and np.argmin(c2) == np.argmin(ref[P + "tuple_chi2"])
              and np.array_equal(rungs, ref[P + "tuple_rungs"]),
              "tuple_chisq")
        lines[-1] += (f"{len(pts)} tuples, chi2 max rel {d2:.3e}, refit "
                      f"max {dx:.3e} sigma, rungs {sorted(set(rungs.tolist()))}",)
        mc, cosi = ref[P + "derived_mc"], ref[P + "derived_cosi"]
        c2, _, ex = entry("grid_chisq_derived", lambda: grid_chisq_derived(
            f, ("M2", "SINI"), (_derived_m2, _derived_sini), (mc, cosi),
            extraparnames=API_EXTRA, niter=niter, chunk=256))
        rungs = f.last_grid_diagnostics["ladder_rung"].ravel()
        d2 = float(np.abs(c2.ravel() / ref[P + "derived_chi2"] - 1).max())
        dx = max(float(np.abs((ex[k].ravel() - ref[f"{P}derived_extra/{k}"])
                              / sig[k]).max()) for k in API_EXTRA)
        check(d2 <= 1e-6 and dx <= 1e-2
              and np.argmin(c2) == np.argmin(ref[P + "derived_chi2"])
              and np.array_equal(rungs, ref[P + "derived_rungs"]),
              "grid_chisq_derived")
        lines[-1] += (f"{c2.shape[0]}x{c2.shape[1]} (Mc, cos i) -> (M2, "
                      f"SINI), chi2 max rel {d2:.3e}, refit max {dx:.3e} "
                      f"sigma",)
        if "doonefit_chi2" in api:
            c1, ex = entry("doonefit", lambda: doonefit(
                f, ("M2", "SINI"), pts[0], extraparnames=API_EXTRA,
                maxiter=rr["settings"]["fit_maxiter"]))
            d1 = rel(c1, api["doonefit_chi2"])
            dx = max(abs(a - b) / sig[k] for k, a, b in
                     zip(API_EXTRA, ex, ref[P + "doonefit_extra"]))
            check(d1 <= 1e-6 and dx <= 1e-2, "doonefit")
            lines[-1] += (f"chi2 rel {d1:.3e}, refit max {dx:.3e} sigma",)
    if "predicted_chi2" in api:
        cls = {"b1855": "GLSState", "b1855_wb": "WidebandState"}.get(
            label, "WLSState")
        fc = {"GLSState": DownhillGLSFitter,
              "WidebandState": WidebandDownhillFitter}.get(
                  cls, PF.DownhillWLSFitter)
        st = getattr(PF, cls)(fc(batch, model), model)
        got = entry(f"{cls}.predicted_chi2", lambda: (
            st.chi2, st.predicted_chi2(lambda_=1.0),
            st.predicted_chi2(lambda_=0.5)))
        want = (api["state_chi2"], *api["predicted_chi2"])
        dp = max(rel(a, b) for a, b in zip(got, want))
        check(dp <= 1e-6, f"{cls}.predicted_chi2")
        lines[-1] += (f"chi2 and lambda 1, 0.5 max rel {dp:.3e}",)
    if "powell" in api:
        pw = api["powell"]
        m = model.copy()
        key = "postfit" if pw["start"] == "prefit" else "auto"
        names = rr["postfit_params"]
        for i, p in enumerate(names):
            m[p].uncertainty = float(ref[f"ref/{key}_uncertainties"][i])
            if key == "auto":
                m[p].value = float(ref[f"ref/{key}_values"][i])
        pf = PF.PowellFitter(batch, m)
        c2 = entry("PowellFitter", lambda: pf.fit_toas(maxiter=pw["maxiter"]))
        sig = ref[f"ref/{key}_uncertainties"]
        dv = float(np.abs((np.array([pf.model.value(p) for p in names])
                           - ref[P + "powell_values"]) / sig).max())
        dc = rel(c2, pw["chi2"])
        check(dc <= 1e-6 and dv <= 1e-2 and pf.converged == pw["converged"],
              "PowellFitter")
        wall = lines[-1][1]
        lines[-1] += (f"maxiter {pw['maxiter']}, {pf.nfev} evaluations vs "
                      f"{pw['nfev']}, {pf.nit} iterations vs {pw['nit']}, "
                      f"converged {pf.converged} vs {pw['converged']}, "
                      f"{wall / pf.nfev * 1e3:.3f} ms per evaluation, chi2 "
                      f"rel {dc:.3e}, values max {dv:.3e} sigma",)
    if batch.wideband:
        from pint_torch.models.dispersion_model import DMconst

        slope = entry("total_dispersion_slope",
                      lambda: model.total_dispersion_slope(batch))
        dcov = entry("dm_covariance_matrix",
                     lambda: model.dm_covariance_matrix(batch))
        ds = float(np.abs(slope.cpu().numpy()
                          / (ref["ref/total_dm"] * DMconst) - 1).max())
        dc = float(np.abs(torch.diagonal(dcov).cpu().numpy()
                          / ref["ref/scaled_dm_uncertainty"]**2 - 1).max())
        check(ds <= 1e-13 and dc <= 1e-13, "DM slope and covariance")
        lines[-1] += (f"slope max rel {ds:.3e}, covariance diagonal max rel "
                      f"{dc:.3e}",)
    if "downhill_full_cov" in api:
        want = api["downhill_full_cov"]
        wf = WidebandDownhillFitter(batch, model)
        c2 = entry("WidebandDownhillFitter(full_cov)",
                   lambda: wf.fit_toas(full_cov=True))
        names = rr["postfit_params"]
        sig = ref[P + "downhill_full_cov_uncertainties"]
        dv = float(np.abs((np.array([wf.model.value(p) for p in names])
                           - ref[P + "downhill_full_cov_values"]) / sig)
                   .max())
        du = float(np.abs(np.array([wf.model[p].uncertainty for p in names])
                          / sig - 1).max())
        dc = rel(c2, want["chi2"])
        check(dc <= 1e-6 and dv <= 1e-2 and du <= 1e-6
              and wf.converged == want["converged"]
              and not wf.noise_ampls and not want["noise_ampls"],
              "full_cov downhill fit")
        lines[-1] += (f"chi2 rel {dc:.3e}, values max {dv:.3e} sigma, "
                      f"uncertainties rel {du:.3e}",)
    counts = kernels.launch_counts()
    for name, wall, d, *note in lines:
        print(f"phase api {label} {name}: {wall:.4f} s; launches {d}"
              + (f"; {note[0]}" if note else "") + f" {tag}", flush=True)
    for ok, what in checks:
        if not ok:
            raise RuntimeError(f"api bar failed ({label}): {what}")
    return counts


def _kepler_phase(path, tag) -> None:
    """The Kepler cores with their ``jacfwd`` Jacobians on the card, each
    on the snapshot's orbits in one batch, against the reference's values
    (1e-13 of each state's largest component) and Jacobians (1e-10 of each
    output's largest partial; on the exactly circular orbit all but the
    eps2 column, where the 1e-30 nudge leaves rounding times 1e30 in
    either package); times the warm batched call beside its bound, the
    call's float64 operations (:func:`_aten_ops`) at the instruction
    rate."""
    import numpy as np
    import torch

    from pint_torch.orbital import kepler as K

    z = np.load(path, allow_pickle=False)
    cores = {"2d": (K.kepler_2d, K.Kepler2DParameters),
             "3d": (K.kepler_3d, K.Kepler3DParameters),
             "two_body": (K.kepler_two_body, K.KeplerTwoBodyParameters)}
    notes, ok = [], True
    for core, (fn, params) in cores.items():
        x = z[f"{core}/inputs"]

        def call():
            return fn(params(*x[:, :-1].T), x[:, -1])

        v, j = call()
        if v.device.type != "cuda":
            raise RuntimeError("the Kepler cores did not run on the card")
        v, j = v.cpu().numpy(), j.cpu().numpy()
        vr, jr = z[f"{core}/values"], z[f"{core}/jacobian"]
        keep = np.ones(j.shape, dtype=bool)
        keep[(x[:, 2] == 0) & (x[:, 3] == 0), :, 3] = False
        dv = float((np.abs(v - vr).max(1) / np.abs(vr).max(1)).max())
        dj = float((np.where(keep, np.abs(j - jr), 0.0).max(2)
                    / np.maximum(np.where(keep, np.abs(jr), 0.0).max(2),
                                 1e-300)).max())
        ok = ok and dv <= 1e-13 and dj <= 1e-10 and np.isfinite(j).all()
        ops, _ = _aten_ops(call)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        # the least time: the call's operations (values and Jacobian, as
        # the dispatch mode counts them) at the float64 instruction rate,
        # or its inputs and outputs once through HBM
        bound = _bound(8 * (x.size + v.size + j.size), ops,
                       rate=F64_INSTR_PER_S)
        notes.append(f"{core} ({len(x)} orbits, e 0-0.95, one circular): "
                     f"values max {dv:.3e} of each state's largest (<= "
                     f"1e-13), Jacobian max {dj:.3e} of each output's "
                     f"largest partial (<= 1e-10), "
                     f"{(time.perf_counter() - t) / 5 * 1e3:.3f} ms a call, "
                     f"bound {bound[0]:.6f} ms ({bound[1]}; "
                     f"{ops / len(x):.0f} float64 operations an orbit)")
    print("phase kepler: " + "; ".join(notes) + f" {tag}", flush=True)
    if not ok:
        raise RuntimeError("the Kepler cores disagree with the reference")


def _noise_bars(f, rounds, ref, rref, notes) -> list:
    """The alternation's noise fits against the reference's: per round the
    L-BFGS-B iterations and converged flag, the lnlike at the optimum (1e-9
    rel), with the evaluations and the ms per evaluation on the card; the
    final noise values within 1e-2 of their Hessian uncertainties, and
    those to 1e-4 rel.  Returns the (ok, what) checks."""
    import numpy as np

    checks = [(len(rounds) == len(rref["auto_noise_rounds"]),
               "auto noise rounds")]
    for i, ((res, wall), want) in enumerate(zip(rounds,
                                                rref["auto_noise_rounds"])):
        d_l = abs(res.lnlike / want["lnlike"] - 1)
        checks += [((res.nit, res.converged) == (want["nit"],
                                                 want["converged"]),
                    f"noise round {i} iterations and converged flag"),
                   (d_l <= 1e-9, f"noise round {i} lnlike")]
        notes.append(
            f"noise round {i}: L-BFGS-B {res.nit} iterations vs "
            f"{want['nit']}, {res.nfev} evaluations vs {want['nfev']}, "
            f"converged {res.converged} vs {want['converged']}, lnlike rel "
            f"{d_l:.3e} (<= 1e-9), {wall:.4f} s"
            f"{' with the Hessian' if res.errors is not None else ''}, "
            f"{wall / max(res.nfev, 1) * 1e3:.3f} ms per evaluation")
    # the least time of one evaluation: the value's Gram V^T N^-1 V and
    # the gradient's product of the same size, 2 N m^2 flops each, at the
    # float64 tensor cores' rate (N TOAs, m basis columns with the offset)
    n = f.batch.ntoas
    m = 1 + sum(U.shape[1] for U in
                f.model.noise_basis_by_component(f.batch)[0])
    bound = 4 * n * m * m / F64_TC_FLOP_PER_S * 1e3
    notes.append(f"bound per evaluation {bound:.4f} ms (2 x 2 N m^2 flops, "
                 f"N={n}, m={m}, at the float64 tensor cores' rate)")
    names = rref["auto_noise_names"]
    err = ref["ref/auto_noise_uncertainties"]
    vals = np.array([f.model.value(p) for p in names])
    uncs = np.array([f.model[p].uncertainty for p in names])
    d_v = float(np.abs((vals - ref["ref/auto_noise_values"]) / err).max())
    d_u = float(np.abs(uncs / err - 1).max())
    checks += [(d_v <= 1e-2, "noise values"),
               (d_u <= 1e-4, "noise uncertainties")]
    notes.append(f"{len(names)} noise values max {d_v:.3e} of their "
                 f"uncertainties (<= 1e-2), uncertainties rel {d_u:.3e} "
                 "(<= 1e-4)")
    return checks


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not (HERE / "pint_torch" / "__init__.py").is_file():
        _fail(f"the pint_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE))

    from pint_torch import kernels
    from pint_torch.bridge import (BT_PIECEWISE_SMALL_PATH, BT_SMALL_PATH,
                                   BW_PATH, BW_WAVES_PATH, DD_FBX_SMALL_PATH,
                                   DDGR_PATH, DDH_SMALL_PATH, DDK_PATH,
                                   DDS_SMALL_PATH, DMX15_PATH, ELL1_PATH,
                                   ELL1H_PATH, NGC_PATH, NGC_PHOFF_PATH,
                                   KEPLER_PATH, NOISE_PATH, PTA_PATH,
                                   PTA_SMALL_PATH, STANDIN_PATH,
                                   WB_PATH, WB_SMALL_PATH, YOUNG_PATH,
                                   YOUNG_SMALL_PATH)
    from pint_torch.kernels import _build
    from pint_torch.kernels import binary_orbits as K6
    from pint_torch.kernels import solar_wind_pl as K7
    from pint_torch.kernels import dd_binary as K2
    from pint_torch.kernels import ell1_binary as K4
    from pint_torch.kernels import schur_cholesky_solve as K3
    from pint_torch.kernels import spin_phase as K1
    from pint_torch.kernels import wls_lstsq as K5

    dev = torch.device("cuda")
    card = _card()
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    tag = f"[{card}]"
    print(f"phase device: {card}; {name}, {props.multi_processor_count} SMs, "
          f"{props.total_memory / 2**30:.1f} GiB, cc {props.major}."
          f"{props.minor}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    build_s = kernels.build_all()
    print(f"phase build: {time.perf_counter() - t0:.2f} s wall for "
          f"{len(build_s)} kernels in parallel "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in build_s.items())})",
          flush=True)
    ptxas = [("spin_phase", f"{K1.KERNELS[p]}<{S}>",
              f"{K1.KERNELS[p]}ILi{S}E")
             for p in (False, True) for S in range(1, 7)]
    ptxas += [("dd_binary", K2.KERNELS[(m, p, True) if o else (m, p)],
               f"dd_binary_{'dual' if p else 'primal'}ILi{m}ELb{int(o)}EE")
              for m in K2.MODES for o in (False, True) for p in (False, True)]
    ptxas += [("schur_cholesky_solve", K3.KERNELS[False],
               "schur_cholesky_kernelILb1E"),
              ("schur_cholesky_solve", K3.KERNELS[True],
               "schur_cholesky_kernelILb0E")]
    ptxas += [("ell1_binary", K4.KERNELS[(m, p, True) if o else (m, p)],
               f"ell1_binary_{'dual' if p else 'primal'}ILi{m}ELb{int(o)}EE")
              for m in range(4) for o in (False, True) for p in (False, True)]
    k6_forms = (K6.FBX, K6.WAVES_PB, K6.WAVES_FBX)
    ptxas += [("binary_orbits", K6.KERNELS[(f, False)],
               f"binary_orbits_primalILi{f}EE") for f in k6_forms]
    # each dual staged through shared memory and, past the widest tile,
    # direct
    ptxas += [("binary_orbits", K6.KERNELS[(f, True)]
               + ("" if st else " (direct)"),
               f"binary_orbits_dualILi{f}ELb{int(st)}EE")
              for f in k6_forms for st in (True, False)]
    ptxas += [("solar_wind_pl", K7.KERNELS[p],
               f"solar_wind_pl_kernelILb{int(p)}EE") for p in (False, True)]
    ptxas += [("wls_lstsq", K5.KERNELS[n], K5.KERNELS[n])
              for n in ("fold", "svd", "global")]
    # no primal may spill (K1, K2 and K4 in each mode and orbit source,
    # K6, K7), nor ELL1H's duals, K6's and K7's duals or K5's tiled kernels
    k4_primals = [K4.KERNELS[(m, False)] for m in range(4)] \
        + [K4.KERNELS[(m, False, True)] for m in range(4)] \
        + [K4.KERNELS[(m, True)] for m in (K4.ELL1H_EXACT,
                                           K4.ELL1H_HARMONIC)]
    no_spill = [K2.KERNELS[(m, False, True)] for m in K2.MODES] \
        + [K2.KERNELS[(K2.BTX, False)], K7.KERNELS[False]] \
        + [K6.KERNELS[(f, p)] + d for f in k6_forms for p in (False, True)
           for d in (("", " (direct)") if p else ("",))] \
        + [K7.KERNELS[True]]
    for src, kernel, marker in ptxas:
        log = _build.library_path(src).with_suffix(".log")
        r = _build.ptxas_report(log.read_text() if log.exists() else "",
                                marker)
        print(f"phase ptxas {kernel}: " + (
            f"{r[0]} registers, {r[1]} bytes stack frame, {r[2]} bytes spill "
            f"stores, {r[3]} bytes spill loads" if r else "not in the build "
            "log"), flush=True)
        # K1's primal templates keep no stack frame; no primal spills, nor
        # ELL1H's duals, K6's and K7's duals or K5's tiled kernels
        k1_primal = kernel.startswith(K1.KERNELS[False])
        primal = k1_primal \
            or kernel in [K2.KERNELS[(m, False)] for m in range(4)] \
            or kernel in k4_primals or kernel in no_spill \
            or kernel in (K5.KERNELS["fold"], K5.KERNELS["svd"])
        if r is None or (k1_primal and r[1]) or (primal and (r[2] or r[3])):
            raise RuntimeError(f"ptxas: no report for {kernel}, or a stack "
                               "frame or spills that it must not have")

    # ---- main paths: each with its counts zeroed just before it ------------
    paths = {}
    k5_tiled = (K5.KERNELS["fold"], K5.KERNELS["svd"])
    k2 = {m: (K2.KERNELS[(m, False)], K2.KERNELS[(m, True)])
          for m in K2.MODES}
    k2_orbit = {m: (K2.KERNELS[(m, False, True)], K2.KERNELS[(m, True, True)])
                for m in K2.MODES}
    k4_orbit = {m: (K4.KERNELS[(m, False, True)], K4.KERNELS[(m, True, True)])
                for m in range(4)}
    k6 = {f: (K6.KERNELS[(f, False)], K6.KERNELS[(f, True)])
          for f in (K6.FBX, K6.WAVES_PB, K6.WAVES_FBX)}
    path_kernels = {
        "b1855": (*K1.KERNELS.values(), *k2[K2.DD], K3.KERNELS[False]),
        "dmx15": (*K1.KERNELS.values(), *k2[K2.DD], K3.KERNELS[True]),
        "ell1": (*K1.KERNELS.values(), K4.KERNELS[(K4.ELL1, False)],
                 K4.KERNELS[(K4.ELL1, True)], *k5_tiled),
        "ell1h": (*K1.KERNELS.values(), K4.KERNELS[(K4.ELL1H_EXACT, False)],
                  K4.KERNELS[(K4.ELL1H_EXACT, True)], *k5_tiled),
        "ngc": (*K1.KERNELS.values(), *k5_tiled),
        "ngc_phoff": (*K1.KERNELS.values(), *k5_tiled),
        "ddk": (*K1.KERNELS.values(), *k2[K2.DDK], K3.KERNELS[False]),
        "ddgr": (*K1.KERNELS.values(), *k2[K2.DDGR], *k5_tiled),
        "bt": (*K1.KERNELS.values(), *k2[K2.BT]),
        "dds": (*K1.KERNELS.values(), *k2[K2.DD]),
        "ddh": (*K1.KERNELS.values(), *k2[K2.DD]),
        "bw": (*K1.KERNELS.values(), *k6[K6.FBX], *k4_orbit[K4.ELL1],
               *k5_tiled),
        "bw_waves": (*K1.KERNELS.values(), *k6[K6.WAVES_FBX],
                     *k4_orbit[K4.ELL1]),
        "pta": (*K1.KERNELS.values(), *k2[K2.DDK], K3.KERNELS[False],
                *K7.KERNELS.values()),
        "young": (*K1.KERNELS.values(), *k5_tiled),
        "small_dd_fbx": (*K1.KERNELS.values(), *k2_orbit[K2.DD],
                         *k6[K6.WAVES_PB]),
        "small_bt_piecewise": (*K1.KERNELS.values(), *k2[K2.BTX]),
        "small_pta": (*K1.KERNELS.values(), *k2[K2.DD],
                      *K7.KERNELS.values()),
        "small_young": tuple(K1.KERNELS.values()),
        "b1855_wb": (*K1.KERNELS.values(), *k2[K2.DD]),
        "b1855_noise": (*K1.KERNELS.values(), *k2[K2.DD]),
        "small_wb": (*K1.KERNELS.values(), *k2[K2.DD],
                     *K7.KERNELS.values())}
    # the kernels each path's api phase must launch (the API's entry
    # points on that path)
    api_kernels = {
        "b1855": (K1.KERNELS[False], *k2[K2.DD], K3.KERNELS[False]),
        "ell1": (K1.KERNELS[False], K4.KERNELS[(K4.ELL1, False)],
                 K4.KERNELS[(K4.ELL1, True)], *k5_tiled),
        "ngc": (K1.KERNELS[False],),
        "bt": (K1.KERNELS[False], K2.KERNELS[(K2.BT, False)]),
        "bw": (K6.KERNELS[(K6.FBX, True)], k4_orbit[K4.ELL1][1]),
        "pta": (K7.KERNELS[True], K2.KERNELS[(K2.DDK, True)]),
        "b1855_wb": (*K1.KERNELS.values(), *k2[K2.DD]),
        "b1855_noise": (K1.KERNELS[False], K2.KERNELS[(K2.DD, False)]),
        "small_wb": (*K1.KERNELS.values(), *k2[K2.DD],
                     *K7.KERNELS.values())}
    for label, path in (("b1855", STANDIN_PATH), ("dmx15", DMX15_PATH),
                        ("ell1", ELL1_PATH), ("ell1h", ELL1H_PATH),
                        ("ngc", NGC_PATH), ("ngc_phoff", NGC_PHOFF_PATH),
                        ("ddk", DDK_PATH), ("ddgr", DDGR_PATH),
                        ("bt", BT_SMALL_PATH), ("dds", DDS_SMALL_PATH),
                        ("ddh", DDH_SMALL_PATH), ("bw", BW_PATH),
                        ("bw_waves", BW_WAVES_PATH), ("pta", PTA_PATH),
                        ("young", YOUNG_PATH),
                        ("small_dd_fbx", DD_FBX_SMALL_PATH),
                        ("small_bt_piecewise", BT_PIECEWISE_SMALL_PATH),
                        ("small_pta", PTA_SMALL_PATH),
                        ("small_young", YOUNG_SMALL_PATH),
                        ("b1855_wb", WB_PATH), ("b1855_noise", NOISE_PATH),
                        ("small_wb", WB_SMALL_PATH)):
        counts, cap, out = _drive(label, path, kernels, tag)
        missing = [k for k in path_kernels[label] if counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} main "
                               f"path: {missing}")
        _bars(label, out)
        if "api" in out["meta"]["reference"]:
            api_counts = _api_phase(label, out, kernels, tag)
            missing = [k for k in api_kernels[label] if api_counts[k] == 0]
            if missing:
                raise RuntimeError(f"kernels never launched on the {label} "
                                   f"api phase: {missing}")
        paths[label] = (counts, cap)
        del out

    _kepler_phase(KEPLER_PATH, tag)

    # ---- kernels against their plain twins ----------------------------------
    # Every CUDA kernel -- the primal and dual instantiations of K1, of K2
    # in its four modes and of K4, K3's two, K5's three -- runs on its
    # path's largest call of it (captured there) and on seeded random
    # inputs, against its twin on the same tensors.
    gen = torch.Generator(device=dev).manual_seed(20260729)
    records = []
    counts, cap = paths["b1855"]

    def rt(*shape, lo=-1.0, hi=1.0):
        return torch.rand(*shape, generator=gen, dtype=torch.float64,
                          device=dev) * (hi - lo) + lo

    def p_rel(Pk, Pr):
        return float(((Pk - Pr).abs().amax(dim=(0, 1))
                      / Pr.abs().amax(dim=(0, 1)).clamp(min=1e-300)).max())

    def record(kernel, source, replaces, err, ms, plain, bound, library=None,
               path="b1855"):
        records.append(dict(name=kernel, route="cuda",
                            source=f"pint_torch/kernels/csrc/{source}",
                            replaces=replaces,
                            launches=paths[path][0][kernel],
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bound[0], bound_by=bound[1],
                            library_ms=library, path=path))

    # K1: its path's inputs, then seeded random inputs within the fold's
    # static bounds |F0| < 2**12 and |t| < 2**35 s at S = 1, 2, 3 and 6 spin
    # terms, so that every template runs; k and f bitwise
    tdb0 = cap.args("spin_phase", True)[2]
    Bn, Nn = 64, 20000

    def rand1(S):
        F = [rt(Bn, lo=1.0, hi=4000.0), rt(Bn, lo=-1e-13, hi=0.0)]
        F += [rt(Bn) * 10.0 ** (-3 - 11 * i) for i in range(2, S)]
        return (torch.round(rt(Nn, lo=-2.0**34, hi=2.0**34)),
                rt(Nn, lo=-1e-6, hi=1e-6), tdb0,
                torch.stack([tdb0 + rt(Bn, lo=-3000.0, hi=3000.0),
                             rt(Bn, lo=-1e-11, hi=1e-11)], dim=1),
                rt(Bn, Nn, lo=-600.0, hi=600.0),
                torch.stack(F[:S], dim=1), True)

    rand1s = {S: rand1(S) for S in (1, 2, 3, 6)}
    for partials in (False, True):
        kernel = K1.KERNELS[partials]
        a1 = cap.args("spin_phase", partials)
        th, tl, _, pe, dl, F, has_pe, _ = a1

        def twin1():
            return K1.spin_phase_reference(th, tl, tdb0, pe, dl, F, has_pe,
                                           partials)

        kk, fk, Pk = K1._launch(*a1)
        kr, fr, Pr = twin1()
        k_eq = bool(torch.equal(kk, kr))
        err = float((fk - fr).abs().max())
        prel = p_rel(Pk, Pr) if partials else 0.0
        err_r = {}
        for S, args in rand1s.items():
            kk, fk, Pk = K1._launch(*args, partials)
            kr, fr, Pr = K1.spin_phase_reference(*args, partials)
            k_eq = k_eq and bool(torch.equal(kk, kr))
            err_r[S] = float((fk - fr).abs().max())
            if partials:
                prel = max(prel, p_rel(Pk, Pr))
        B1, N1, S1 = dl.shape[0], dl.shape[1], F.shape[1]
        ms = _time_ms(lambda: K1._launch(*a1), 50)
        plain = _time_ms(twin1, 5)
        lanes = S1 + 2 if partials else 0
        bound = _bound(16 * N1 + 8 * B1 * (2 + S1)
                       + 8 * B1 * N1 * (1 + 2 + lanes),
                       B1 * N1 * _k1_ops(S1, has_pe, partials),
                       rate=F64_INSTR_PER_S)
        print(f"phase kernel {kernel}: B={B1} N={N1} S={S1} k equal {k_eq}; "
              f"max|df| {err:.3e}, random S=1,2,3,6 "
              f"{', '.join(f'{v:.3e}' for v in err_r.values())} cycles "
              f"(= 0); "
              + (f"partials max rel {prel:.3e} (<= 1e-10); " if partials
                 else "")
              + f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) {tag}", flush=True)
        err = max(err, *err_r.values())
        if not (k_eq and err == 0.0 and prel <= 1e-10):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "spin_phase.cu", K1.REPLACES, err, ms, plain, bound)

    # K2 in its four modes, each on its path's largest call (DD b1855's, BT
    # bt's, DDGR ddgr's, DDK ddk's) and on random orbits -- ECC 0 to 0.9 and
    # bands at ~2e-5, 0.1, 0.6 and 0.95, any OM, so that both exits of the
    # Kepler solve (fixed point, 2-cycle) and the full 15 steps run on the
    # card -- with two rows whose NaN delays must poison every partial: SINI
    # = 1.5 (DD), ar = a1 / 1.5 (DDGR), the per-TOA sini 1.5 (DDK), NaN
    # TOAs (BT, which has no logarithm); the delay bitwise everywhere, the
    # partials to 1e-10 of each column's largest
    k2_paths = {K2.DD: "b1855", K2.BT: "bt", K2.DDGR: "ddgr", K2.DDK: "ddk",
                K2.BTX: "small_bt_piecewise"}
    tt0_main = paths["b1855"][1].args("dd_binary", (K2.DD, True))[0]
    bands = ((0.0, 0.9), (1.5e-5, 2.5e-5), (0.09, 0.11), (0.59, 0.61),
             (0.94, 0.96))
    nb = 32
    nr = nb * len(bands)
    rtt = rt(nr, tt0_main.shape[1], lo=-3e8, hi=3e8)

    def random_k2(mode):
        """(tt0, row, per-TOA inputs) of the random orbits in ``mode``, the
        row from the mode's path."""
        base = paths[k2_paths[mode]][1].args("dd_binary", (mode, True))[1]
        rp = base[:1].expand(nr, -1).clone()
        for i, (lo, hi) in enumerate(bands):
            rp[i * nb:(i + 1) * nb, 5] = rt(nb, lo=lo, hi=hi)
        rp[:, 7] = rt(nr, lo=0.0, hi=360.0)
        t, toa = rtt, None
        if mode in (K2.DD, K2.BT, K2.DDK, K2.BTX):
            rp[:, 8] = rt(nr, lo=0.0, hi=0.05)
        if mode == K2.DD:
            rp[:, 10] = rt(nr, lo=0.5, hi=0.999)
            rp[-2:, 10] = 1.5
        elif mode in (K2.BT, K2.BTX):
            t = rtt.clone()
            t[-2:, ::97] = float("nan")
            if mode == K2.BTX:
                toa = (rp[:, 3:4] * (1.0 + rt(nr, rtt.shape[1], lo=-1e-5,
                                              hi=1e-5)),)
        elif mode == K2.DDGR:
            rp[-2:, 10] = rp[-2:, 3] / 1.5
        else:
            toa = (rt(nr, rtt.shape[1], lo=-1e-6, hi=1e-6),
                   rt(nr, rtt.shape[1], lo=-1e-5, hi=1e-5),
                   rt(nr, rtt.shape[1], lo=0.5, hi=0.999))
            toa[2][-2:] = 1.5
        return t, rp, toa

    randoms = {mode: random_k2(mode) for mode in k2_paths}
    k2_randoms = randoms
    for mode, (t, rp, _) in randoms.items():
        _, _, kind = K2.kepler_steps(torch.nan_to_num(t), rp)
        exits = [torch.bincount(kind[i * nb:(i + 1) * nb].flatten(),
                                minlength=3).tolist()
                 for i in range(len(bands))]
        what = K2.KERNELS[(mode, False)].split("_")[0]
        print(f"phase kepler exits on the random orbits ({what}), per ECC "
              "band "
              + ", ".join(f"{lo:g}-{hi:g} {dict(zip(K2.KEPLER_EXITS, n))}"
                          for (lo, hi), n in zip(bands, exits)), flush=True)
        if not all(sum(n[k] for n in exits) for k in range(3)):
            raise RuntimeError("the random orbits miss an exit of the Kepler "
                               "solve")

    def warp_max_mean(steps, rows: bool) -> float:
        """Mean over warps of the most Newton steps in a warp: 32
        consecutive TOAs of one row (the primal's 2-D grid) or of the
        flattened (B, N) (the dual's 1-D grid)."""
        x = steps if rows else steps.reshape(1, -1)
        pad = (-x.shape[1]) % 32
        x = torch.nn.functional.pad(x, (0, pad))
        return float(x.reshape(x.shape[0], -1, 32).amax(-1).double().mean())

    # the Newton steps on the ddgr path's TOAs (ECC 0.617), its largest
    # call: how many elements stop after each count, and how
    tg, pg = paths["ddgr"][1].args("dd_binary", (K2.DDGR, True))[:2]
    _, steps, kind = K2.kepler_steps(tg, pg)
    hist = torch.bincount(steps.flatten(), minlength=16).tolist()
    ex = torch.bincount(kind.flatten(), minlength=3).tolist()
    print(f"phase kepler steps on the ddgr path (B={tg.shape[0]} N="
          f"{tg.shape[1]}, ECC {float(pg[0, 5]):.7f}): mean "
          f"{float(steps.double().mean()):.4f}, histogram "
          f"{dict((i, n) for i, n in enumerate(hist) if n)}, exits "
          f"{dict(zip(K2.KEPLER_EXITS, ex))} {tag}", flush=True)

    # each mode on its path's largest call; BT once more at a full width,
    # on b1855's call with its DD row read as BT's (bt's calls are 80
    # TOAs, launch-sized), not recorded: no path launches BT at that width
    k2_calls = [(mode, path, mode) for mode, path in k2_paths.items()] \
        + [(K2.BT, "b1855", K2.DD)]
    for mode, path, captured in k2_calls:
        rtt_m, rp, rtoa = randoms[mode]
        on_path = path == k2_paths[mode]
        for partials in (False, True):
            kernel = K2.KERNELS[(mode, partials)]
            tt0, params, _, toa, _, _ = paths[path][1].args(
                "dd_binary", (captured, partials))
            if mode == K2.BTX and toa is None:
                toa = (params[:, 3:4].expand_as(tt0).contiguous(),)
            a2 = (tt0, params, mode, toa, None, partials)

            def twin2():
                return K2.dd_binary_reference(tt0, params, partials, mode,
                                              toa)

            dk, Pk = K2._launch(*a2)
            dr, Pr = twin2()
            err = float((dk - dr).abs().max())
            same = bool(torch.equal(dk, dr))
            prel = p_rel(Pk, Pr) if partials else 0.0
            dk, Pk = K2._launch(rtt_m, rp, mode, rtoa, None, partials)
            dr, Pr = K2.dd_binary_reference(rtt_m, rp, partials, mode, rtoa)
            nan_k, nan_r = torch.isnan(dk), torch.isnan(dr)
            nan_ok = bool(torch.equal(nan_k, nan_r)) and bool(nan_k.any())
            fin = ~nan_r
            err_r = float((dk[fin] - dr[fin]).abs().max())
            same = same and bool(torch.equal(dk[fin], dr[fin]))
            if partials:
                nan_ok = nan_ok and bool(torch.isnan(Pk[nan_k]).all())
                prel = max(prel, p_rel(Pk[:-2], Pr[:-2]))
            B2, N2 = tt0.shape
            _, steps, _ = K2.kepler_steps(tt0, params)
            st_elem = float(steps.double().mean())
            st_warp = warp_max_mean(steps, rows=not partials)
            ms = _time_ms(lambda: K2._launch(*a2), 20)
            plain = _time_ms(twin2, 3)
            # tt0 and the row entries the mode reads in, the delay and the
            # partials the mode writes out; DDK's three per-TOA inputs in
            nbytes = 8 * B2 * N2 + 8 * B2 * len(K2.ROW_COLUMNS[mode]) \
                + 8 * B2 * N2 * (1 + (K2.npartial(mode) if partials else 0)) \
                + (24 * B2 * N2 if mode == K2.DDK else 0) \
                + (8 * B2 * N2 if mode == K2.BTX else 0)
            ops = _k2_ops(st_elem, partials, mode)
            bound = _bound(nbytes, B2 * N2 * ops, rate=F64_INSTR_PER_S)
            b_warp = _bound(nbytes, B2 * N2 * _k2_ops(st_warp, partials, mode),
                            rate=F64_INSTR_PER_S)
            b_15 = _bound(nbytes, B2 * N2 * _k2_ops(15, partials, mode),
                          rate=F64_INSTR_PER_S)
            on = path if on_path else f"{path}'s call read in this mode"
            print(f"phase kernel {kernel}: {on} B={B2} N={N2}; delay bitwise "
                  f"{same}, max|d delay| {err:.3e} (random {err_r:.3e}) s (= "
                  f"0); NaN rows equal and poisoning {nan_ok}; "
                  + (f"partials ({K2.npartial(mode)}) max rel {prel:.3e} "
                     "(<= 1e-10); " if partials else "")
                  + f"Newton steps per element {st_elem:.4f}, per warp (most "
                  f"in the warp) {st_warp:.4f}, of 15; kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]}, {nbytes / (B2 * N2):.1f} B and {ops:.1f} "
                  f"ops/element at the steps each element needs; share "
                  f"{bound[0] / ms:.2f}); at the warps' steps {b_warp[0]:.4f} "
                  f"ms ({b_warp[1]}); at 15 steps {b_15[0]:.4f} ms "
                  f"({b_15[1]}) {tag}", flush=True)
            if not (same and prel <= 1e-10 and nan_ok):
                raise RuntimeError(f"{kernel} disagrees with its plain "
                                   f"version on {on}")
            if on_path:
                record(kernel, "dd_binary.cu", K2.REPLACES_OF[mode],
                       max(err, err_r), ms, plain, bound, path=path)

    # K3 at each path's Schur systems plus an ill-conditioned and a NaN point
    for path, regime in (("b1855", False), ("dmx15", True)):
        kernel = K3.KERNELS[regime]
        Ar, rhs, ridge = paths[path][1].args("schur_cholesky_solve")
        B3, nt = rhs.shape
        q, _ = torch.linalg.qr(rt(nt, nt))
        ill = (q * torch.logspace(0, -13, nt, dtype=torch.float64,
                                  device=dev)) @ q.T
        nanpt = Ar[0].clone()
        nanpt[3, 5] = nanpt[5, 3] = float("nan")
        Ar_x = torch.cat([Ar, ill[None], nanpt[None]])
        rhs_x = torch.cat([rhs, rt(1, nt), rhs[:1]])
        xk, okk, ck = K3._launch(Ar_x, rhs_x, ridge)
        xr, okr, cr = K3.schur_cholesky_solve_reference(Ar_x.clone(),
                                                        rhs_x.clone(), ridge)
        same_ok = bool(torch.equal(okk, okr))
        both = okk & okr
        scale = xr[both].abs().amax(dim=1).clamp(min=1e-300)
        rel3 = float(((xk[both] - xr[both]).abs().amax(dim=1) / scale).max())
        err3 = float((xk[both] - xr[both]).abs().max())
        nan_same = bool(torch.equal(torch.isnan(xk), torch.isnan(xr)))
        ms3 = _time_ms(lambda: K3._launch(Ar, rhs, ridge), 20)
        plain3 = _time_ms(lambda: K3.schur_cholesky_solve_reference(
            Ar.clone(), rhs.clone(), ridge), 2)
        d = torch.diagonal(Ar, dim1=-2, dim2=-1)
        an = torch.sqrt(torch.clamp(d, min=1e-300))
        Arn = Ar / (an[:, :, None] * an[:, None, :]) \
            + ridge * torch.eye(nt, dtype=torch.float64, device=dev)
        bn = (rhs / an)[:, :, None]

        def library():
            L, _ = torch.linalg.cholesky_ex(Arn)
            return torch.cholesky_solve(bn, L)

        lib3 = _time_ms(library, 20)
        bnd3 = _bound(8 * B3 * (nt * nt + nt) + B3 * (8 * nt + 9),
                      B3 * (nt**3 / 3 + 4 * nt * nt))
        print(f"phase kernel {kernel}: B={B3} nt={nt} (+1 ill-conditioned, "
              f"+1 NaN point); ok flags equal {same_ok}, NaN equal "
              f"{nan_same}; x max rel {rel3:.3e} (<= 1e-9), max|dx| "
              f"{err3:.3e}; kernel {ms3:.4f} ms, plain {plain3:.4f} ms, "
              f"library cholesky_ex+cholesky_solve {lib3:.4f} ms, bound "
              f"{bnd3[0]:.4f} ms ({bnd3[1]}) {tag}", flush=True)
        if not (same_ok and nan_same and rel3 <= 1e-9 and not bool(okk[-1])):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "schur_cholesky_solve.cu", K3.REPLACES, err3, ms3,
               plain3, bnd3, lib3, path=path)

    # K4, in its four modes.  ELL1 on the ell1 path's inputs, ELL1k on the
    # same TOAs (OMDOT 1.7 deg/yr, LNEDOT 2e-4 /yr), and seeded random
    # orbits -- |EPS1|, |EPS2| to 1e-2, EPS1DOT/EPS2DOT, OMDOT, LNEDOT,
    # PBDOT and A1DOT random, SINI 0.5-0.999, half the TOAs within 5 s of a
    # whole orbit so that the orbital phase crosses its 0/2 pi wrap -- plus
    # two rows with SINI = 1.5 whose NaN delays must poison all 14
    # partials.  ELL1H exact on the ell1h path's inputs, its harmonic form
    # (NHARMS 7) on the same, and both on the random orbits with
    # H3/STIGMA (stigma 0.3-0.97, H3 = Tsun M2 stigma^3) -- the harmonic one
    # at NHARMS 3, 7 and 12, with stigma from STIGMA and from H4/H3, a row
    # at H3 = 0 -- their last two rows with NaN TOAs that must poison all
    # 15 partials.  The delay bitwise everywhere, the partials to 1e-10 of
    # each column's largest.
    from pint_torch.models.binary.engines import TSUN, ell1_forward

    tt4, p4 = paths["ell1"][1].args("ell1_binary", (K4.ELL1, True))[:2]
    tt4h, p4h = paths["ell1h"][1].args("ell1_binary",
                                       (K4.ELL1H_EXACT, True))[:2]
    p4k = p4.clone()
    p4k[:, 9], p4k[:, 10] = 1.7, 2e-4
    nr4 = 64
    rp4 = p4[:1].expand(nr4, -1).clone()
    rp4[:, 0] = rp4[:, 0] * (1.0 + rt(nr4, lo=-1e-3, hi=1e-3))
    for col, (lo, hi) in {1: (-1e-12, 1e-12), 4: (-1e-14, 1e-14),
                          5: (-1e-2, 1e-2), 6: (-1e-2, 1e-2),
                          7: (-1e-16, 1e-16), 8: (-1e-16, 1e-16),
                          9: (0.0, 5.0), 10: (-1e-3, 1e-3),
                          12: (0.5, 0.999)}.items():
        rp4[:, col] = rt(nr4, lo=lo, hi=hi)
    rp4[-2:, 12] = 1.5
    N4 = tt4.shape[1]
    half = N4 // 2
    rtt4 = torch.cat([rt(nr4, half, lo=-3e8, hi=3e8),
                      torch.round(rt(nr4, N4 - half, lo=-2e3, hi=2e3))
                      * (rp4[:, :1] * 86400.0)
                      + rt(nr4, N4 - half, lo=-5.0, hi=5.0)], dim=1)
    phi = ell1_forward({n: rp4[:, i:i + 1]
                        for i, n in enumerate(K4.ELL1_PARAMS)}, rtt4)["phi"]
    wrap = (int((phi < 1e-4).sum()), int((phi > 2 * 3.141592653589793
                                           - 1e-4).sum()))
    print(f"phase ell1 random orbits: {nr4} rows x {N4} TOAs, orbital "
          f"phases within 1e-4 rad below / above the wrap {wrap[1]} / "
          f"{wrap[0]}", flush=True)
    if not min(wrap):
        raise RuntimeError("the random ELL1 TOAs miss the phase wrap")
    sig = rt(nr4, lo=0.3, hi=0.97)
    h3 = TSUN * 0.2067 * (1.0 + rt(nr4, lo=-0.1, hi=0.1)) * sig ** 3
    zero = torch.zeros_like(sig)
    rp4s = torch.cat([rp4[:, :11], torch.stack([h3, zero, sig], 1)], 1)
    rp4s[-3, 11] = 0.0
    rp4h4 = torch.cat([rp4[:, :11], torch.stack([h3, h3 * sig, zero], 1)],
                      1)
    rp4h4[-3, 11] = 0.0
    rtt4h = rtt4.clone()
    rtt4h[-2:, ::97] = float("nan")
    p4harm = p4h.clone()
    modes = (
        (K4.ELL1, "ELL1, the path's TOAs", "ell1", tt4, p4,
         [(rtt4, rp4, 7, False)]),
        (K4.ELL1K, "ELL1k, ell1's TOAs, OMDOT and LNEDOT set", "ell1", tt4,
         p4k, [(rtt4, rp4, 7, False)]),
        (K4.ELL1H_EXACT, "ELL1H exact, the path's TOAs", "ell1h", tt4h, p4h,
         [(rtt4h, rp4s, 7, False)]),
        (K4.ELL1H_HARMONIC, "ELL1H harmonic NHARMS=7, ell1h's TOAs",
         "ell1h", tt4h, p4harm,
         [(rtt4h, rp, n, h4) for rp, h4 in ((rp4s, False), (rp4h4, True))
          for n in (3, 7, 12)]))
    for mode, what, path, ttp, pp, randoms in modes:
        for partials in (False, True):
            kernel = K4.KERNELS[(mode, partials)]

            def twin4():
                return K4.ell1_binary_reference(ttp, pp, mode, partials)

            dk, Pk = K4._launch(ttp, pp, mode, partials)
            dr, Pr = twin4()
            err = float((dk - dr).abs().max())
            same = bool(torch.equal(dk, dr))
            # one TOA a row, as a TZR row runs it
            t1 = ttp[:, :1].contiguous()
            same = same and bool(torch.equal(
                K4._launch(t1, pp, mode, partials)[0],
                K4.ell1_binary_reference(t1, pp, mode, partials)[0]))
            prel = p_rel(Pk, Pr) if partials else 0.0
            err_r, nan_ok = 0.0, True
            for rtt, rp, nharms, use_h4 in randoms:
                dk, Pk = K4._launch(rtt, rp, mode, partials, nharms, use_h4)
                dr, Pr = K4.ell1_binary_reference(rtt, rp, mode, partials,
                                                  nharms, use_h4)
                nan_k, nan_r = torch.isnan(dk), torch.isnan(dr)
                nan_ok = nan_ok and bool(torch.equal(nan_k, nan_r)) \
                    and bool(nan_k.any())
                fin = ~nan_r
                err_r = max(err_r, float((dk[fin] - dr[fin]).abs().max()))
                same = same and bool(torch.equal(dk[fin], dr[fin]))
                if partials:
                    nan_ok = nan_ok and bool(torch.isnan(Pk[nan_k]).all())
                    prel = max(prel, p_rel(Pk[:-2], Pr[:-2]))
            B4 = ttp.shape[0]
            ms = _time_ms(lambda: K4._launch(ttp, pp, mode, partials), 50)
            plain = _time_ms(twin4, 3)
            ops = _k4_ops(mode, partials)
            bound = _bound(8 * B4 * N4 + 8 * B4 * pp.shape[1]
                           + 8 * B4 * N4 * (1 + (K4.npartial(mode)
                                                 if partials else 0)),
                           B4 * N4 * ops, rate=F64_INSTR_PER_S)
            print(f"phase kernel {kernel}: B={B4} N={N4} ({what}; random "
                  f"orbits {len(randoms)} set(s); N=1); delay bitwise {same}, "
                  f"max|d delay| {err:.3e} (random {err_r:.3e}) s (= 0); "
                  f"NaN rows equal and poisoning {nan_ok}; "
                  + (f"partials max rel {prel:.3e} (<= 1e-10); " if partials
                     else "")
                  + f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}, {ops} ops/element) "
                  f"{tag}", flush=True)
            if not (same and prel <= 1e-10 and nan_ok):
                raise RuntimeError(f"{kernel} disagrees with its plain "
                                   "version")
            record(kernel, "ell1_binary.cu", K4.REPLACES_OF[mode],
                   max(err, err_r), ms, plain, bound, path=path)

    # K2 and K4 with orbit inputs.  Each orbit-input instantiation on the
    # random orbits of its mode (NaN rows and all), fed the orbits and
    # pbprime that orbits_pb forms from the row (BT and BTX: PB 86400 as
    # R's period, as the components hand it on a PB base): the delay
    # bitwise against its twin and against the PB instantiation on the
    # same orbits, the partials to 1e-10 of each column's largest, NaN
    # rows poisoning every partial.  K2's DD and K4's ELL1 also on the
    # path that launches them (small_dd_fbx: ORBWAVES on a PB base; bw: FB0
    # to FB3), from K6, where they are timed and recorded.
    from pint_torch.models.binary.engines import kepler_inputs

    def orbits_pb_of(tt, rp, pb_period=False):
        f = {}
        kepler_inputs({n: rp[:, i:i + 1]
                       for i, n in enumerate(K2.DD_PARAMS)}, tt, f)
        frac = f["frac"]
        orbits = (frac - 0.5 * f["pbdot"] * frac * frac).expand_as(tt)
        pbp = (rp[:, :1] * 86400.0) if pb_period else f["pbprime"]
        return orbits.contiguous(), pbp.expand_as(tt).contiguous()

    def orbit_check(launch, twin, pb_launch, nan_rows=True):
        """(same, err, prel, nan_ok) of one orbit-input call."""
        dk, Pk = launch()
        dr, Pr = twin()
        dp, _ = pb_launch()
        nan_k, nan_r = torch.isnan(dk), torch.isnan(dr)
        nan_ok = bool(torch.equal(nan_k, nan_r)) and (bool(nan_k.any())
                                                      or not nan_rows)
        fin = ~nan_r
        same = bool(torch.equal(dk[fin], dr[fin])) \
            and bool(torch.equal(dk[fin], dp[fin]))
        err = float((dk[fin] - dr[fin]).abs().max())
        prel = 0.0
        if Pk is not None:
            nan_ok = nan_ok and bool(torch.isnan(Pk[nan_k]).all())
            good = ~nan_r.any(dim=1)
            prel = p_rel(Pk[good], Pr[good])
        return same, err, prel, nan_ok

    for mode in K2.MODES:
        t, rp, rtoa = k2_randoms[mode]
        orb = orbits_pb_of(t, rp, mode in (K2.BT, K2.BTX))
        for partials in (False, True):
            kernel = K2.KERNELS[(mode, partials, True)]
            same, err, prel, nan_ok = orbit_check(
                lambda: K2._launch(t, rp, mode, rtoa, orb, partials),
                lambda: K2.dd_binary_reference(t, rp, partials, mode, rtoa,
                                               orb),
                lambda: K2._launch(t, rp, mode, rtoa, None, partials))
            note = ""
            if mode == K2.DD:
                a2 = paths["small_dd_fbx"][1].args("dd_binary",
                                                    (mode, partials, True))
                tt0, params, _, toa, porb, _ = a2

                def twin2o():
                    return K2.dd_binary_reference(tt0, params, partials,
                                                  mode, toa, porb)

                dk, Pk = K2._launch(*a2)
                dr, Pr = twin2o()
                same = same and bool(torch.equal(dk, dr))
                err = max(err, float((dk - dr).abs().max()))
                if partials:
                    prel = max(prel, p_rel(Pk, Pr))
                B2, N2 = tt0.shape
                ms = _time_ms(lambda: K2._launch(*a2), 50)
                plain = _time_ms(twin2o, 3)
                _, steps, _ = K2.kepler_steps(tt0, params)
                st_elem = float(steps.double().mean())
                nbytes = 8 * B2 * N2 * 3 + 8 * B2 * 13 \
                    + 8 * B2 * N2 * (1 + (K2.npartial(mode, True)
                                          if partials else 0))
                ops = _k2_ops(st_elem, partials, mode) - (9 if partials
                                                          else 0) - 7
                bound = _bound(nbytes, B2 * N2 * ops, rate=F64_INSTR_PER_S)
                note = (f"; small_dd_fbx's call B={B2} N={N2}: kernel "
                        f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
                        f"{bound[0]:.4f} ms ({bound[1]}; share "
                        f"{bound[0] / ms:.2f})")
                record(kernel, "dd_binary.cu", K2.REPLACES_OF[mode], err, ms,
                       plain, bound, path="small_dd_fbx")
            else:
                # no path launches it: timed on the random orbits, the
                # launches those of its mode's path (0)
                B2, N2 = t.shape
                ms = _time_ms(lambda: K2._launch(t, rp, mode, rtoa, orb,
                                                 partials), 20)
                plain = _time_ms(lambda: K2.dd_binary_reference(
                    t, rp, partials, mode, rtoa, orb), 3)
                _, steps, _ = K2.kepler_steps(torch.nan_to_num(t), rp)
                nbytes = 8 * B2 * N2 * (3 + len(rtoa or ())) + 8 * B2 * 13 \
                    + 8 * B2 * N2 * (1 + (K2.npartial(mode, True)
                                          if partials else 0))
                ops = _k2_ops(float(steps.double().mean()), partials,
                              mode) - (9 if partials else 0) - 7
                bound = _bound(nbytes, B2 * N2 * ops, rate=F64_INSTR_PER_S)
                note = (f"; timed on them: kernel {ms:.4f} ms, plain "
                        f"{plain:.4f} ms, bound {bound[0]:.4f} ms "
                        f"({bound[1]}; share {bound[0] / ms:.2f})")
                record(kernel, "dd_binary.cu", K2.REPLACES_OF[mode], err, ms,
                       plain, bound, path=k2_paths[mode])
            print(f"phase kernel {kernel}: random orbits B={t.shape[0]} "
                  f"N={t.shape[1]}, orbits_pb's orbits as inputs; delay "
                  f"bitwise against the twin and the PB form {same}, max|d "
                  f"delay| {err:.3e} s (= 0); NaN rows equal and poisoning "
                  f"{nan_ok}; " + (f"partials ({K2.npartial(mode, True)}) "
                                   f"max rel {prel:.3e} (<= 1e-10)"
                                   if partials else "primal") + note
                  + f" {tag}", flush=True)
            if not (same and prel <= 1e-10 and nan_ok):
                raise RuntimeError(f"{kernel} disagrees with its plain "
                                   "version or with the PB form")

    # ELL1 and ELL1k on the random orbits with their SINI = 1.5 rows, ELL1H
    # on them with H3/STIGMA and NaN TOAs in their last two rows
    rp4_modes = {K4.ELL1: (rp4, rtt4), K4.ELL1K: (rp4, rtt4),
                 K4.ELL1H_EXACT: (rp4s, rtt4h),
                 K4.ELL1H_HARMONIC: (rp4s, rtt4h)}
    for mode, (rq, tq) in rp4_modes.items():
        pb_s = rq[:, :1] * 86400.0
        frac = tq / pb_s
        orb = ((frac - 0.5 * (rq[:, 1:2] + rq[:, 2:3]) * frac * frac)
               .contiguous(), (pb_s + rq[:, 1:2] * tq).contiguous())
        for partials in (False, True):
            kernel = K4.KERNELS[(mode, partials, True)]
            same, err, prel, nan_ok = orbit_check(
                lambda: K4._launch(tq, rq, mode, partials, 7, False, orb),
                lambda: K4.ell1_binary_reference(tq, rq, mode, partials,
                                                 7, False, orb),
                lambda: K4._launch(tq, rq, mode, partials, 7, False))
            note = ""
            if mode == K4.ELL1:
                a4 = paths["bw"][1].args("ell1_binary",
                                         (mode, partials, True))

                def twin4o():
                    return K4.ell1_binary_reference(a4[0], a4[1], mode,
                                                    partials, 7, False,
                                                    a4[6])

                dk, Pk = K4._launch(*a4)
                dr, Pr = twin4o()
                same = same and bool(torch.equal(dk, dr))
                err = max(err, float((dk - dr).abs().max()))
                if partials:
                    prel = max(prel, p_rel(Pk, Pr))
                B4, N4o = a4[0].shape
                ms = _time_ms(lambda: K4._launch(*a4), 50)
                plain = _time_ms(twin4o, 3)
                ops = _k4_ops(mode, partials) - 6 - (7 if partials else 0)
                bound = _bound(8 * B4 * N4o * 3 + 8 * B4 * a4[1].shape[1]
                               + 8 * B4 * N4o * (1 + (K4.npartial(mode, True)
                                                      if partials else 0)),
                               B4 * N4o * ops, rate=F64_INSTR_PER_S)
                note = (f"; bw's call B={B4} N={N4o}: kernel {ms:.4f} ms, "
                        f"plain {plain:.4f} ms, bound {bound[0]:.4f} ms "
                        f"({bound[1]}; share {bound[0] / ms:.2f})")
                record(kernel, "ell1_binary.cu", K4.REPLACES_OF[mode], err,
                       ms, plain, bound, path="bw")
            else:
                # no path launches it: timed on the random orbits
                B4, N4o = tq.shape
                ms = _time_ms(lambda: K4._launch(tq, rq, mode, partials, 7,
                                                 False, orb), 20)
                plain = _time_ms(lambda: K4.ell1_binary_reference(
                    tq, rq, mode, partials, 7, False, orb), 3)
                ops = _k4_ops(mode, partials) - 6 - (7 if partials else 0)
                bound = _bound(8 * B4 * N4o * 3 + 8 * B4 * rq.shape[1]
                               + 8 * B4 * N4o * (1 + (K4.npartial(mode, True)
                                                      if partials else 0)),
                               B4 * N4o * ops, rate=F64_INSTR_PER_S)
                note = (f"; timed on them: kernel {ms:.4f} ms, plain "
                        f"{plain:.4f} ms, bound {bound[0]:.4f} ms "
                        f"({bound[1]}; share {bound[0] / ms:.2f})")
                record(kernel, "ell1_binary.cu", K4.REPLACES_OF[mode], err,
                       ms, plain, bound,
                       path="ell1" if mode < K4.ELL1H_EXACT else "ell1h")
            print(f"phase kernel {kernel}: random orbits B={tq.shape[0]} "
                  f"N={tq.shape[1]}, orbits_pb's orbits as inputs; delay "
                  f"bitwise against the twin and the PB form {same}, max|d "
                  f"delay| {err:.3e} s (= 0); NaN rows equal and poisoning "
                  f"{nan_ok}; " + (f"partials max rel {prel:.3e} (<= 1e-10)"
                                   if partials else "primal") + note
                  + f" {tag}", flush=True)
            if not (same and prel <= 1e-10 and nan_ok):
                raise RuntimeError(f"{kernel} disagrees with its plain "
                                   "version or with the PB form")

    # K6 in its three forms, each on its path's largest call (FBX: bw;
    # ORBWAVES on an FBX base: bw_waves; on a PB base: small_dd_fbx) and
    # on seeded random coefficients within 1e-3 of the path's and TOAs
    # over +-3e8 s (the waves' duals also at 60 and 230 terms): orbits
    # and pbprime bitwise, the partials to 1e-10 of each column's largest
    k6_paths = {K6.FBX: "bw", K6.WAVES_FBX: "bw_waves",
                K6.WAVES_PB: "small_dd_fbx"}
    for form, path in k6_paths.items():
        for partials in (False, True):
            kernel = K6.KERNELS[(form, partials)]
            a6 = paths[path][1].args("binary_orbits", (form, partials))
            tt6, c6, _, nfb, nw, off, _ = a6

            def twin6():
                return K6.binary_orbits_reference(tt6, c6, form, nfb, nw,
                                                  off, partials)

            ok_, pk_, Pk = K6._launch(*a6)
            or_, pr_, Pr = twin6()
            same = bool(torch.equal(ok_, or_)) and bool(torch.equal(pk_, pr_))
            err = float((ok_ - or_).abs().max())
            prel = 0.0
            if partials:
                prel = max(p_rel(Pk[..., 0, :], Pr[..., 0, :]),
                           p_rel(Pk[..., 1, :], Pr[..., 1, :]))
            Br = 64
            tr = rt(Br, tt6.shape[1], lo=-3e8, hi=3e8)
            cr = c6[:1].expand(Br, -1) * (1.0 + rt(Br, c6.shape[1], lo=-1e-3,
                                                   hi=1e-3))
            ok_, pk_, Pk = K6._launch(tr, cr.contiguous(), form, nfb, nw,
                                      off, partials)
            or_, pr_, Pr = K6.binary_orbits_reference(tr, cr, form, nfb, nw,
                                                      off, partials)
            same = same and bool(torch.equal(ok_, or_)) \
                and bool(torch.equal(pk_, pr_))
            err = max(err, float((ok_ - or_).abs().max()))
            if partials:
                prel = max(prel, p_rel(Pk[..., 0, :], Pr[..., 0, :]),
                           p_rel(Pk[..., 1, :], Pr[..., 1, :]))
            wide = []
            if partials and form != K6.FBX:
                # ORBWAVES wider than the stand-ins': 60 terms (a tile of
                # fewer than 128 threads, above 48 KB) and 230 (wider than
                # one warp's tile: the direct dual)
                base = c6[0, :1 if form == K6.WAVES_PB else nfb]
                for nww in (60, 230):
                    cw = torch.cat([base, 1e-4 * rt(2 * nww), c6[0, -1:]])
                    cw = cw.expand(4, -1) * (1.0 + rt(4, cw.numel(),
                                                      lo=-1e-3, hi=1e-3))
                    tw6 = rt(4, 2000, lo=-3e8, hi=3e8)
                    ok_, pk_, Pk = K6._launch(tw6, cw.contiguous(), form,
                                              nfb, nww, off, True)
                    or_, pr_, Pr = K6.binary_orbits_reference(
                        tw6, cw, form, nfb, nww, off, True)
                    same = same and bool(torch.equal(ok_, or_)) \
                        and bool(torch.equal(pk_, pr_))
                    prel = max(prel, p_rel(Pk[..., 0, :], Pr[..., 0, :]),
                               p_rel(Pk[..., 1, :], Pr[..., 1, :]))
                    wide.append(nww)
            B6, N6 = tt6.shape
            nc = c6.shape[1]
            ms = _time_ms(lambda: K6._launch(*a6), 50)
            plain = _time_ms(twin6, 3)
            ops = _k6_ops(form, nfb, nw, partials)
            bound = _bound(8 * B6 * N6 + 8 * B6 * nc + 16 * B6 * N6
                           + (16 * (1 + nc) * B6 * N6 if partials else 0),
                           B6 * N6 * ops, rate=F64_INSTR_PER_S)
            print(f"phase kernel {kernel}: {path} B={B6} N={N6} nfb={nfb} "
                  f"nwaves={nw} (+ {Br} random rows"
                  + "".join(f", + 4 x 2000 at nwaves={w}" for w in wide)
                  + "); orbits and pbprime "
                  f"bitwise {same}, max|d orbits| {err:.3e} (= 0); "
                  + (f"partials ({2 * (1 + nc)}) max rel {prel:.3e} "
                     "(<= 1e-10); " if partials else "")
                  + f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}, {ops} ops/element; share "
                  f"{bound[0] / ms:.2f}) {tag}", flush=True)
            if not (same and prel <= 1e-10):
                raise RuntimeError(f"{kernel} disagrees with its plain "
                                   "version")
            record(kernel, "binary_orbits.cu", K6.REPLACES_OF[form], err, ms,
                   plain, bound, path=path)

    # K7 on the pta path's largest calls (SWX: one window a conjunction
    # year, each TOA's geometry at its window's SWXP_), on small_pta's
    # (NE_SW's SWP, every TOA) and on seeded random elongations from 1 to
    # 179 deg with indices 1.5-4.4, three windows and TOAs outside them:
    # the geometry bitwise, the partials to 1e-10 of each column's largest
    for partials in (False, True):
        kernel = K7.KERNELS[partials]
        a7 = paths["pta"][1].args("solar_wind_pl", partials)
        r7, th7, p7, i7, w7, _ = a7

        def twin7():
            return K7._twin(r7, th7, p7, i7, w7, partials)

        gk, Pk = K7._launch(*a7)
        gr, Pr = twin7()
        same = bool(torch.equal(gk, gr))
        err = float((gk - gr).abs().max())
        prel = p_rel(Pk, Pr) if partials else 0.0
        a7s = paths["small_pta"][1].args("solar_wind_pl", partials)
        gk, Pk = K7._launch(*a7s)
        gr, Pr = K7._twin(*a7s)
        same = same and bool(torch.equal(gk, gr))
        if partials:
            prel = max(prel, p_rel(Pk, Pr))
        Nr = 4096
        rr7 = rt(Nr, lo=490.0, hi=510.0)
        thr = rt(32, Nr, lo=math.radians(1.0), hi=math.radians(179.0))
        pr7 = rt(32, 3, lo=1.5, hi=4.4)
        wr = torch.randint(-1, 3, (Nr,), generator=gen, device=dev)
        gk, Pk = K7._launch(rr7, thr, pr7, K7.sw_i_inf(pr7), wr, partials)
        gr, Pr = K7._twin(rr7, thr, pr7, K7.sw_i_inf(pr7), wr, partials)
        same = same and bool(torch.equal(gk, gr))
        if partials:
            prel = max(prel, p_rel(Pk, Pr))
        B7, N7 = th7.shape
        W7 = p7.shape[1]
        inside = int((w7 >= 0).sum()) if w7 is not None else N7
        ms = _time_ms(lambda: K7._launch(*a7), 20)
        plain = _time_ms(twin7, 2)
        bound = _bound(8 * N7 + 8 * B7 * N7 + 16 * B7 * W7 + 4 * N7
                       + 8 * B7 * N7 * (1 + (3 if partials else 0)),
                       B7 * inside * K7_OPS[partials], rate=F64_INSTR_PER_S)
        print(f"phase kernel {kernel}: pta B={B7} N={N7} ({W7} windows, "
              f"{inside} TOAs inside one; + small_pta's call, + 32 x {Nr} "
              f"random); geometry bitwise {same}, max|d g| {err:.3e} pc (= "
              f"0); " + (f"partials max rel {prel:.3e} (<= 1e-10); "
                         if partials else "")
              + f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}, {K7_OPS[partials]} ops per "
              f"TOA in a window; share {bound[0] / ms:.2f}) {tag}",
              flush=True)
        if not (same and prel <= 1e-10):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "solar_wind_pl.cu", K7.REPLACES, err, ms, plain,
               bound, path="pta")

    # K5: the ell1 path's largest call (its 256 points, N = 4005, k = 88)
    # runs the tiled kernels.  Each is held against its own plain version on
    # the same inputs -- the fold's triangles against fold_reference's, row
    # by row up to sign, its sums of squares and NaN flags; the SVD kernel
    # against svd_reference on the fold's workspace -- and the wrapper
    # against the twin on the path's call and on seeded random systems: raw
    # condition numbers to 1e10, made of a normalized matrix's (1e2 to 1e6)
    # and column scales (to 1e8), one point with an all-zero column (rank
    # k - 1: that direction's x must be 0) and one with a NaN in the ragged
    # last tile; at k = 88 and k = 111 (odd, the tiled path's largest), and
    # through the global kernel at k = 130 and at N = 4005, k = 233, the
    # width of a dense-DMX WLS model
    Aw5, rw5 = paths["ell1"][1].args("wls_lstsq")[:2]
    P5, N5, k5 = Aw5.shape
    d5 = K5.design()
    print(f"phase kernel wls_lstsq design: P={P5} N={N5} k={k5}: S=1 (one "
          f"block a point), m={d5['TILE']}-row tiles in one buffer, "
          f"nb={d5['NB']} reflectors per WY block ({d5['ACC']} sum(s) per "
          f"slice), {d5['FOLD_THREADS']} threads a fold block; Jacobi on "
          f"R^T, {d5['JG']} lanes a pair, {d5['SVD_BLOCKS']} blocks of "
          f"{d5['SVD_THREADS']} threads an SM, cap {d5['MAX_SWEEPS']} sweeps;"
          f" tiled up to k={d5['TILED_MAX_K']}, the global kernel's R and V "
          f"in shared memory up to k={d5['SMEM_MAX_K']}", flush=True)

    def system(n, k, cond_n, colscale):
        q1, _ = torch.linalg.qr(rt(n, k))
        q2, _ = torch.linalg.qr(rt(k, k))
        s = torch.logspace(0, -math.log10(cond_n), k,
                           dtype=torch.float64, device=dev)
        scale = torch.logspace(0, float(colscale), k, dtype=torch.float64,
                               device=dev)
        perm = torch.randperm(k, generator=gen, device=dev)
        return ((q1 * s) @ q2.T) * scale[perm]

    def random_systems(n, k):
        A = torch.stack([system(n, k, 1e6, 4), system(n, k, 1e4, 6),
                         system(n, k, 1e2, 8), system(n, k, 10.0, 0),
                         rt(n, k), rt(n, k)])
        A[4, :, 3] = 0.0
        A[5, n - 3, 2] = float("nan")
        return A, rt(len(A), n)

    def k5_compare(Aw, rw):
        xk, sk, nk, swk = K5._launch(Aw, rw)
        xr, sr, nr = K5.wls_lstsq_reference(Aw, rw)
        return k5_bars(xk, sk, nk, xr, sr, nr, Aw.shape[1:]) | dict(
            sweeps=swk)

    def k5_bars(xk, sk, nk, xr, sr, nr, shape):
        nan_same = bool(torch.equal(torch.isnan(xk), torch.isnan(xr))) \
            and bool(torch.equal(torch.isnan(sk), torch.isnan(sr)))
        fin = ~torch.isnan(xr).any(dim=1)
        xk0 = xk
        xk, sk, nk, xr, sr, nr = (t[fin] for t in (xk, sk, nk, xr, sr, nr))
        x_rel = float(((xk - xr).abs().amax(dim=1)
                       / xr.abs().amax(dim=1)).max())
        s_rel = float(((sk - sr).abs().amax(dim=1) / sr[:, 0]).max())
        cut = torch.finfo(torch.float64).eps * max(shape)
        rank_k = ((sk > 0) & (sk >= cut * sk[:, :1])).sum(dim=1)
        rank_r = ((sr > 0) & (sr >= cut * sr[:, :1])).sum(dim=1)
        return dict(x_rel=x_rel, s_rel=s_rel, err=float((xk - xr).abs().max()),
                    rank=bool(torch.equal(rank_k, rank_r)), nan=nan_same,
                    ranks=rank_k, norms=float((nk / nr - 1).abs().max()),
                    xk=xk0, cond=(sr[:, 0] / sr[:, -1]))

    # each tiled kernel against its plain version, on the path's inputs and
    # on the random systems at k = 88 (a zero column, a NaN point)
    nt5 = k5 * (k5 + 1)

    def rows_up_to_sign(ws):
        tri = ws[:, :nt5].reshape(ws.shape[0], k5, k5 + 1)
        d = torch.diagonal(tri[..., :k5], dim1=-2, dim2=-1)
        return tri * torch.where(d < 0, -1.0, 1.0)[..., None]

    def fold_compare(Aw, rw):
        """The fold's triangles against fold_reference's: rows up to sign,
        relative to the column norms, where R has full rank (only there is
        it unique up to its rows' signs: a zero column leaves the kernel a
        zero row where LAPACK keeps Q^T A's); at every finite point the
        Gram R^T R of Aw's columns, which is A^T A whatever the rank,
        relative to the column norms' products; the sums of squares and
        NaN flags; the workspace."""
        wk, wr = K5._launch_fold(Aw, rw), K5.fold_reference(Aw, rw)
        ok = wr[:, -1] == 0
        norms = torch.sqrt(wr[:, nt5:-1])
        colscale = torch.cat([norms, rw.norm(dim=1, keepdim=True)], dim=1)
        Rr = wr[:, :nt5].reshape(-1, k5, k5 + 1)[..., :k5]
        Rk = wk[:, :nt5].reshape(-1, k5, k5 + 1)[..., :k5]
        full = ok & (torch.diagonal(Rr, dim1=-2, dim2=-1).abs()
                     > 1e-8 * norms).all(dim=1)
        d = (rows_up_to_sign(wk) - rows_up_to_sign(wr))[full]
        rel = float((d.abs() / colscale[full][:, None, :].clamp(
            min=1e-300)).max())
        n1 = torch.where(norms == 0, 1.0, norms)
        gram = float(((Rk.transpose(1, 2) @ Rk - Rr.transpose(1, 2) @ Rr)
                      .abs() / (n1[:, :, None] * n1[:, None, :]))[ok].max())
        sums = float(((wk[ok, nt5:-1] - wr[ok, nt5:-1]).abs()
                      / wr[ok, nt5:-1].clamp(min=1e-300)).max())
        return dict(rel=rel, err=float(d.abs().max()), gram=gram, sums=sums,
                    flags=bool(torch.equal(wk[:, -1], wr[:, -1])),
                    full=int(full.sum()), ok=int(ok.sum())), wk

    def fold_ok(f):
        return f["rel"] <= 1e-9 and f["gram"] <= 1e-9 \
            and f["sums"] <= 1e-12 and f["flags"]

    f_path, ws_k = fold_compare(Aw5, rw5)
    Am, rm = random_systems(N5, k5)
    f_rand, wm = fold_compare(Am, rm)
    xs, ss, ns, _ = K5._launch_svd(ws_k, N5, k5)
    c_svd = k5_bars(xs, ss, ns, *K5.svd_reference(ws_k, N5, k5), (N5, k5))
    xs, ss, ns, _ = K5._launch_svd(wm, N5, k5)
    c_msvd = k5_bars(xs, ss, ns, *K5.svd_reference(wm, N5, k5), (N5, k5))
    for what, f in (("path", f_path), ("random", f_rand)):
        print(f"phase kernel wls_tsqr_fold {what}: P={f['ok']} finite "
              f"points, {f['full']} of full rank; triangles against "
              f"fold_reference (rows up to sign, full rank) max "
              f"{f['rel']:.3e} of the column norms (<= 1e-9), max|d| "
              f"{f['err']:.3e}; Gram R^T R max {f['gram']:.3e} of the norms' "
              f"products (<= 1e-9); sums of squares rel {f['sums']:.3e} (<= "
              f"1e-12); NaN flags equal {f['flags']} {tag}", flush=True)
    print(f"phase kernel wls_tsqr_svd: on the fold's workspace against "
          f"svd_reference: x max rel to max|x| {c_svd['x_rel']:.3e} "
          f"(random {c_msvd['x_rel']:.3e}; <= 1e-9), sv max rel to s_max "
          f"{c_svd['s_rel']:.3e} (random {c_msvd['s_rel']:.3e}; <= 1e-12), "
          f"ranks equal {c_svd['rank'] and c_msvd['rank']}, NaN flags equal "
          f"{c_svd['nan'] and c_msvd['nan']} {tag}", flush=True)
    ok5 = fold_ok(f_path) and fold_ok(f_rand) and all(
        c["x_rel"] <= 1e-9 and c["s_rel"] <= 1e-12 and c["rank"] and c["nan"]
        for c in (c_svd, c_msvd))
    del Am, rm, wm

    # the wrapper against the twin, on the ell1 path's call and on ngc_phoff's
    # (N = 62, one ragged tile; PHOFF and the grid's offset column are one
    # direction, so every point has rank k - 1)
    c_path = k5_compare(Aw5, rw5)
    cases = {"path": c_path}
    Aw6, rw6 = paths["ngc_phoff"][1].args("wls_lstsq")[:2]
    cases["ngc_phoff path (N=62, k=5)"] = c6 = k5_compare(Aw6, rw6)
    if not bool((c6["ranks"] == Aw6.shape[2] - 1).all()):
        raise RuntimeError("wls_lstsq: ngc_phoff's points are not rank k - 1")
    zero_x = []
    for what, (n, k) in (("random k=88", (N5, k5)),
                         ("random k=111", (N5, 111)),
                         ("random k=130 (global)", (600, 130)),
                         ("random k=233 (global)", (N5, 233))):
        A_, r_ = random_systems(n, k)
        cases[what] = k5_compare(A_, r_)
        zero_x.append(float(cases[what]["xk"][4, 3].abs()))
        del A_, r_
    for what, c in cases.items():
        print(f"phase kernel wls_lstsq {what}: P={len(c['ranks'])} finite "
              f"points; x max rel to max|x| {c['x_rel']:.3e} (<= 1e-9), sv "
              f"max rel to s_max {c['s_rel']:.3e} (<= 1e-12), ranks equal "
              f"{c['rank']} ({sorted(set(c['ranks'].tolist()))}), NaN flags "
              f"equal {c['nan']}, norms rel {c['norms']:.1e}; normalized "
              f"condition {float(c['cond'].min()):.3g}-"
              f"{float(c['cond'].max()):.3g}; Jacobi sweeps "
              f"{sorted(set(c['sweeps'].tolist()))} {tag}", flush=True)
        ok5 = ok5 and c["x_rel"] <= 1e-9 and c["s_rel"] <= 1e-12 \
            and c["rank"] and c["nan"]
    sweeps = c_path["sweeps"].double()

    # how far two backward-stable solvers may differ on the paths' points
    # (ell1's, and ngc_phoff's, whose kept singular values span ~1e6): the
    # first-order sensitivity of least squares to a relative perturbation
    # u of the normalized matrix and rw (Golub and Van Loan, Matrix
    # Computations, 5.3.7), u (2 kappa / cos(theta) + kappa^2 tan(theta))
    # of ||x||, with kappa the kept singular values' ratio and sin(theta) =
    # ||r|| / ||rw||; the kernel's gap to the twin in 2-norms against it
    # (informational: no bar)
    def sensitivity(what, Aw, rw, xk):
        xr, sr, nr = K5.wls_lstsq_reference(Aw, rw)
        fin = ~torch.isnan(xr).any(dim=1)
        cut = torch.finfo(torch.float64).eps * max(Aw.shape[1:])
        kept = (sr > 0) & (sr >= cut * sr[:, :1])
        kappa = sr[:, 0] / torch.where(kept, sr, math.inf).amin(dim=1)
        fit = ((Aw / nr[:, None, :]) @ xr[:, :, None])[..., 0]
        sin = ((rw - fit).norm(dim=1) / rw.norm(dim=1)).clamp(max=1.0)
        cos = torch.sqrt(1.0 - sin * sin)
        u = torch.finfo(torch.float64).eps / 2
        sens = u * (2 * kappa / cos + kappa**2 * sin / cos)
        gap = (xk - xr).norm(dim=1) / xr.norm(dim=1)
        ratio = (gap / sens)[fin]
        print(f"phase kernel wls_lstsq {what} sensitivity: kappa "
              f"{float(kappa[fin].min()):.4g}-{float(kappa[fin].max()):.4g},"
              f" tan(theta) {float((sin / cos)[fin].min()):.4g}-"
              f"{float((sin / cos)[fin].max()):.4g}; first-order bound at "
              f"u = eps/2 {float(sens[fin].min()):.3e}-"
              f"{float(sens[fin].max()):.3e} of ||x||; kernel against twin "
              f"||dx||/||x|| max {float(gap[fin].max()):.3e}; gap / bound "
              f"median {float(ratio.median()):.3g}, max "
              f"{float(ratio.max()):.3g} {tag}", flush=True)

    sensitivity("path", Aw5, rw5, c_path["xk"])
    sensitivity("ngc_phoff path", Aw6, rw6, c6["xk"])

    # times: each tiled kernel, its plain version and the library call for
    # its function (the fold's: the R of [Aw | rw]; the SVD kernel's: the
    # SVD of the scaled triangles); then the whole of K5 on the path's call
    # against the twin and torch.linalg.svd of the normalized matrices; the
    # global kernel on 32 random systems at k = 233
    aug5 = torch.cat([Aw5, rw5[:, :, None]], dim=2)
    Rn5 = ws_k[:, :nt5].reshape(P5, k5, k5 + 1)[:, :, :k5] \
        / torch.sqrt(ws_k[:, nt5:-1]).clamp(min=1e-300)[:, None]
    ms_fold = _time_ms(lambda: K5._launch_fold(Aw5, rw5), 10)
    ms_svd = _time_ms(lambda: K5._launch_svd(ws_k, N5, k5), 10)
    plain_fold = _time_ms(lambda: K5.fold_reference(Aw5, rw5), 2, warmup=1)
    plain_svd = _time_ms(lambda: K5.svd_reference(ws_k, N5, k5), 2, warmup=1)
    lib_fold = _time_ms(lambda: torch.linalg.qr(aug5, mode="r"), 2, warmup=1)
    lib_svd = _time_ms(lambda: torch.linalg.svd(Rn5), 2, warmup=1)
    del aug5, Rn5
    ms5 = _time_ms(lambda: K5._launch(Aw5, rw5), 5)
    plain5 = _time_ms(lambda: K5.wls_lstsq_reference(Aw5, rw5), 1, warmup=1)
    norms5 = torch.sqrt(torch.sum(Aw5 * Aw5, dim=1))
    An5 = Aw5 / torch.where(norms5 == 0, 1.0, norms5)[:, None, :]
    lib5 = _time_ms(lambda: torch.linalg.svd(An5, full_matrices=False), 1,
                    warmup=1)
    del An5
    Pg, kg = 32, 233
    Ag = rt(Pg, N5, kg) * torch.logspace(0, 6, kg, dtype=torch.float64,
                                         device=dev)
    rg = rt(Pg, N5)
    ms_glob = _time_ms(lambda: K5._launch(Ag, rg), 2, warmup=1)
    plain_glob = _time_ms(lambda: K5.wls_lstsq_reference(Ag, rg), 1,
                          warmup=1)
    ng = torch.sqrt(torch.sum(Ag * Ag, dim=1))
    lib_glob = _time_ms(lambda: torch.linalg.svd(
        Ag / ng[:, None, :], full_matrices=False), 1, warmup=1)
    del Ag, rg, ng
    ops5 = _k5_ops(N5, k5)
    ws5 = ws_k.shape[-1]
    bound_fold = _bound(8 * P5 * N5 * (k5 + 1) + 8 * P5 * ws5,
                        P5 * ops5["fold"], P5 * ops5["qr"])
    bound_svd = _bound(8 * P5 * ws5 + 24 * P5 * k5 + 4 * P5,
                       P5 * ops5["svd"])
    bound5 = _bound(8 * P5 * (N5 * k5 + N5) + 24 * P5 * k5 + 4 * P5,
                    P5 * (ops5["fold"] + ops5["svd"]), P5 * ops5["qr"])
    opsg = _k5_ops(N5, kg)
    bound_glob = _bound(8 * Pg * (N5 * kg + N5) + 24 * Pg * kg + 4 * Pg,
                        Pg * (opsg["fold"] + opsg["svd"]), Pg * opsg["qr"])
    print(f"phase kernel wls_lstsq: P={P5} N={N5} k={k5}; zero column's x "
          f"at k=88, 111, 130, 233: "
          f"{', '.join(f'{v:.1e}' for v in zero_x)} (= 0); Jacobi sweeps on "
          f"the path's inputs min {int(sweeps.min())} mean "
          f"{float(sweeps.mean()):.4f} max {int(sweeps.max())} (cap "
          f"{d5['MAX_SWEEPS']}); wls_tsqr_fold {ms_fold:.4f} ms (plain "
          f"{plain_fold:.4f}, library torch.linalg.qr {lib_fold:.4f}, bound "
          f"{bound_fold[0]:.4f} ({bound_fold[1]})); wls_tsqr_svd "
          f"{ms_svd:.4f} ms (plain {plain_svd:.4f}, library torch.linalg.svd "
          f"of the triangles {lib_svd:.4f}, bound {bound_svd[0]:.4f} "
          f"({bound_svd[1]})); K5 whole {ms5:.4f} ms, plain {plain5:.4f} ms, "
          f"library torch.linalg.svd {lib5:.4f} ms, bound {bound5[0]:.4f} ms "
          f"({bound5[1]}; per point {ops5['qr']:.4g} ops of QR at the tensor "
          f"cores' rate, {ops5['fold'] + ops5['svd']:.4g} other); "
          f"wls_lstsq_global P={Pg} k={kg} {ms_glob:.4f} ms (plain "
          f"{plain_glob:.4f}, library torch.linalg.svd {lib_glob:.4f}, bound "
          f"{bound_glob[0]:.4f} ({bound_glob[1]})) {tag}", flush=True)
    if not (ok5 and not any(zero_x)
            and int(sweeps.max()) < d5["MAX_SWEEPS"]):
        raise RuntimeError("wls_lstsq disagrees with its plain versions")
    err5 = max(c["err"] for c in cases.values())
    record(K5.KERNELS["fold"], "wls_lstsq.cu", K5.REPLACES,
           max(f_path["err"], f_rand["err"]), ms_fold, plain_fold,
           bound_fold, lib_fold, path="ell1")
    record(K5.KERNELS["svd"], "wls_lstsq.cu", K5.REPLACES,
           max(err5, c_svd["err"], c_msvd["err"]), ms_svd, plain_svd,
           bound_svd, lib_svd, path="ell1")
    record(K5.KERNELS["global"], "wls_lstsq.cu", K5.REPLACES,
           max(cases["random k=130 (global)"]["err"],
               cases["random k=233 (global)"]["err"]), ms_glob, plain_glob,
           bound_glob, lib_glob, path="ell1")

    print(f"phase wall: {time.perf_counter() - t_start:.2f} s for the whole "
          f"run {tag}", flush=True)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
