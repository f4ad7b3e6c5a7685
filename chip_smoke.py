#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pint_torch``) on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc under $CUDA_HOME or /usr/local/cuda)::

    python3 chip_smoke.py

Phases, one line each:

1. device -- the card's name and power limit (nvidia-smi) and its
   properties;
2. build -- the fourteen hand kernels (K12's are entry points of K10's
   source), one nvcc per source, started together; the ptxas report of each ``__global__`` (registers, stack
   frame, spill bytes; K1's per S = 1..6, K2's and K4's per mode and orbit
   source, K6's per form, its duals staged and direct, K8's per mode and
   output, K9's per factor layout and entry point, K10's, K11's forward
   and backward per accumulation mode and compute dtype), read from the
   build logs: K1's primal templates must hold no stack frame, and no
   primal (K1, K2 in its five modes and both orbit sources, K4 likewise,
   K6, K7), no ELL1H dual, no K6 or K7 dual, no tiled K5 kernel, no K8
   kernel but the MIXED ones (whose switch over eight primitives is
   printed, not bounded), no K9 and no K10 kernel may spill;
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
   small_wb; each path's api kernels must have launched.  Then the files
   phase: b1855, ell1 and ngc read from their committed par and tim files
   (``pint_torch/data/b1855.par`` and ``.tim``, ``j1909_ell1.*``,
   ``ngc6440e.*``) by ``pint_torch.models.get_model_and_toas``, each host
   stage's wall time printed (par parse and model build, tim read, the TOA
   table with the C++ MJD parse, validate, clock chain, TDB, posvels),
   ``to_batch`` onto the card, then the residuals, the fits the reference
   ran on the files, the 16x16 grid cold and warm; counts zeroed around
   each, and K1's primal and dual on all three, K2's DD and K3 in shared
   memory on b1855, K4's ELL1 on ell1 and K5's tiled kernels on ell1 and
   ngc must launch.  The C++ parser must be the path that ran; the parse,
   the tim columns, the parameter table, the configs, the free and design
   parameters and the contexts must be bitwise the reference's run on the
   same files (``ref/files/``), the host pipeline's columns within the
   host layer's bars, and the main-path bars above hold against
   ``ref/files/``.  Then the Kepler phase: ``kepler_2d``,
   ``kepler_3d`` and ``kepler_two_body`` with their ``jacfwd`` Jacobians
   on the card, on the orbits of ``kepler_reference.npz`` (e 0-0.95, one
   exactly circular) against the reference's values (1e-13 of each
   state's largest) and Jacobians (1e-10 of each output's largest
   partial), each warm call's time beside its bound (its float64
   operations, counted by a dispatch mode, at the instruction rate).
   Then the mcmc phase, each path's counts zeroed just before it, from
   the reference's outputs under its snapshot's ``ref/bayes/``: on ell1
   and ddgr (256 walkers x 20 steps, 89 and 86 free parameters, 4005
   TOAs; K1 with K4's ELL1 or K2's DDGR primal), ngc_phoff (32 x 50, a
   PhaseOffset: no mean subtracted) and small_wb_white (32 x 50, the
   wideband likelihood; K7 through ``evaluate_dm``): ``BayesianTiming``
   with the stored prior box, ``lnposterior_batch`` at 64 stored points
   (within 5e-7 of the reference's chi2, -inf and NaN where the
   reference's), ``lnprior`` and ``prior_transform`` (1e-12 rel), then
   the seeded ``MCMCFitter.fit_toas`` from the stored walkers: every
   accept decision the reference's unless the port's margin ``|lnratio
   - log u|`` is within twice the lnposterior bar, the walkers bitwise
   up to the first decision that differs, and with none inside the
   margin the whole chain bitwise, lnprob at the bar, acceptance and the
   maximum exact, its values and the stds bitwise, chi2 1e-6 rel.
   Printed: steps/s and walker evaluations/s, the acceptance,
   ``lnposterior_batch`` at B = 128 walker rows (the median of 5 warm
   calls), its wrapper launches and its CUDA kernels under
   ``torch.profiler``, and ell1's busy share of 5 warm steps; a
   checkpointed 25 + 25 steps on ngc_phoff equal 50 uninterrupted
   bitwise; b1855 (correlated noise) is refused with
   ``NotImplementedError``.  Then the photon phase, each stand-in's
   counts zeroed just before it, on small_photon (the reference photon
   test's 300 photons, 16 walkers x 30 steps) and photon_j0030 (32768
   weighted, barycentred photons over twelve years with J0030+0451's two
   peaks; F0 with a normal prior, F1 in a box; 128 x 40): the photons'
   phases within 1e-10 s x F0 cycles of the reference's (the count that
   differ at all and that changed bin printed), ``event_optimize``'s
   FFTFIT start (the weighted profile, ``fftfit_full`` within 1e-10
   cycles of the reference's shift, ``rotate``, ``set_template``), then
   ``MCMCFitterBinnedTemplate`` (K8 BINNED) and
   ``MCMCFitterAnalyticTemplate`` (K8 GAUSS): ``lnposterior_batch`` at
   the 64 stored points within each point's bar (1e-12 of the sum of
   |log terms|, plus, binned, the jump of each photon within the phase
   bar of a bin edge, analytic the phase bar times the sum of |d term /
   d phi|), -inf where the reference's; ``get_template_vals`` 1e-13 rel
   of the host template; the seeded chain from the stored walkers
   (decisions the reference's unless the margin is within the two
   points' bars, walkers bitwise, and with none differing lnprob within
   its bar, acceptance, maximum and stds exact); printed: steps/s, walker
   evaluations/s, the half-ensemble's ``lnposterior_batch`` (median of 5
   warm calls), its launches, its CUDA kernels under ``torch.profiler``
   and its peak memory; K1's primal and every K8 kernel must launch.
   Then the photon_mixed phase (``_photon_mixed_phase``) on photon_j0030
   at its full 32768 photons: a template of one of each closed-form
   primitive (``LCGaussian``, ``LCGaussian2``, ``LCLorentzian``,
   ``LCLorentzian2``, ``LCVonMises``, ``LCTopHat``, ``LCKing``,
   ``LCHarmonic``), rotated by the stored shift, on
   ``MCMCFitterAnalyticTemplate`` (K8 MIXED) against ``ref/photon_mixed/``:
   the lnposterior at the stored points within ``_photon_bars``, the
   density at the stored phases within 1e-12 of its sum of |terms|, the
   seeded 128-walker x 10-step chain at the photon chain bars; printed:
   steps/s, the half-ensemble's ``lnposterior_batch`` and its busy
   share; K1's primal, K8's MIXED kernels and the row sum must launch.
   Then the full-covariance fits (``_full_cov_phase``) on b1855_noise:
   ``GLSFitter.fit_toas(maxiter=2, full_cov=True)`` and
   ``DownhillGLSFitter.fit_toas(full_cov=True)`` against
   ``ref/full_cov/`` at the GLS bars (chi2 1e-6 rel, values 1e-2 sigma,
   uncertainties 1e-6 rel), each fit's wall printed; K1's and K2 DD's
   kernels must launch.
   Then the stream phase on j1909_stream
   (``j1909_stream_standin.npz``: J1909-3744's 4005 TOAs with 30
   red-noise modes on a pinned 8.87-yr period, a K = 150 GLS frame): the
   base ``GLSFitter.fit_toas(maxiter=2)`` on 400 epochs, then with the
   counts zeroed ``StreamingGLS`` through 40 single-epoch appends (one
   carrying a copy of its own row, which the duplicate check pens), a
   5-epoch backlog, a quarantine of 3 rows and their release and
   ``apply_validation`` -- each operation's kind, block, quarantined
   rows, steps, block id and fallback reason class the reference's, chi2
   1e-6 rel, values 1e-2 sigma, uncertainties 1e-6 rel; the final factor
   within 1e-9 x max|L| of the reference's and of a fresh Cholesky of the
   frame Gram; the stream within 1e-2 sigma of the port's scratch fit of
   the final set, that fit at the fit bars; ``stream_updates`` cut at
   half (refused on resume, as the reference's: a fallback re-froze the
   frame) and before the first fallback (resumed bitwise); p50/p99 of
   rank-k appends and of refactors apart, appends/s, the warm refit and
   the speedup, K9 launches an append, the profiler's kernels and busy
   share over five warm appends; K1, K4's ELL1 and K9's
   ``stream_ingest_smem`` must launch.  Then the serve phase: the
   reference's base-fit states of j1909_stream (3600, 3690, 3780, 4005
   TOAs) and small_stream (40, 56, 64) as ``FitRequest.from_fitter``,
   their residuals within 1e-10 s of the reference's, then on the
   reference's residuals ``ShapeBatcher.run`` (buckets (4096, 512) and
   (64, 32), a padded lane) and ``serve_fused(steps=3,
   reweight="huber")``: buckets and batches equal, dx within 1e-6 of each
   column's error, errors, chi2 and chi2_initial 1e-9 rel, padded equal
   to dedicated to 1e-9; the warm dispatch's ms and requests/s.  Then
   the catalog phase on pta67_catalog (``pta67_catalog_standin.npz``: 67
   pulsars of 100-400 TOAs, two with a corrupt row; 14 GWB modes, R =
   1876; K1 and K10 must launch): load, ingest, ``CatalogFitter`` (1
   settle and 4 timed ``fit(maxiter=1)`` passes, ``refine(steps=8)``),
   ``JointLikelihood``, ``lnlike_batch`` at the bench's 32 points (8 timed
   repetitions) and the 48 stored ones, the seeded 32 x 10 chain; its
   bars in ``_catalog_phase``; printed the bench block's quantities
   (``catalog_fits_per_s``, ``joint_lnlike_per_s``, ``pad_waste_frac``,
   buckets), each stage's wall s and the peak device memory.  Then the
   sweep phase on b1855 and dmx15 (counts zeroed around each; K1, K2's
   DD and K3 must launch): after the first fit, ``grid_chisq`` of the
   32 x 32 M2 x SINI grid stored under ``ref/sweep/`` (``chunk=256``,
   four chunks) unfused and at ``fuse=3`` and ``4`` -- each fused group
   one replay of a CUDA graph of its chunks, captured at the first fused
   call --, the fused surfaces bitwise the unfused one and each at the
   grid bars against the reference's fused sweep, ``fn.fused``'s
   dispatches the reference's; printed the warm walls (median of 5), the
   graphs' replays and captured launches, the profiled kernels and busy
   share and the peak memory of each kind.  Then on b1855
   ``grid_chisq(checkpoint=)`` into a temporary directory, a sweep of
   the phase's own chunk function under ``checkpointed_map`` failing once
   with a device-shaped error (retried) and once with another at chunk 2
   (resumed, chunks 2-3 recomputed), each bitwise the unfused surface,
   and the refusal of a checkpoint after a parameter value changed; and a
   32 x 10 ``EnsembleSampler`` chain on ngc_phoff whose batched
   lnposterior fails once with a device-shaped error, bitwise the chain
   without it.  Then the precision phase (K11's counts zeroed just before
   it and read just after; every K11 instantiation must launch), against the reference's forced outputs under each stand-in's
   ``ref/precision/``, for float32 at ``native``, ``f64``, ``two_sum`` and
   ``two_prod`` and bfloat16 at ``two_prod`` (``PRECISION_SPECS``; the
   other bfloat16 modes run on the serve requests too): on b1855 the
   first fit (``gls.design``) and, after the float64 first fit, the grid
   at 16 stored points (``grid.gram`` and ``grid.correction``), a fused
   sweep under float32 two_prod captured with K11 and bitwise its
   unfused surface; on j1909_stream the serve phase's seven requests
   (``serve.gram``) on the reference's residuals; on pta67_catalog each
   bucket's batched fit at the ingest state (``catalog.fit``) and the
   joint likelihood at 4 points (``catalog.lnlike``), on the reference's
   residuals.  Bars: under float64 accumulation of float32 parts the
   standing ones (fit chi2 1e-6 rel and values 1e-2 sigma; grid chi2
   1e-6 rel, argmin and rungs; serve and catalogue steps 1e-6 of their
   errors, errors and chi2 1e-9 rel; the joint likelihood 1e-9 x max(1,
   |ref|)) and each within its segment's forced budget of the port's own
   float64; float32 native and bfloat16 two_prod within the forced budget
   of the reference's (float32 native's steps and values not held: its
   float32 sums leave them at each package's own rounding); the default
   and ``PrecisionPolicy.f64()`` bitwise, with no K11 count moving during
   them.  The probes
   (``tune_precision_segments``, unforced, then forced into a temporary
   tune directory, from which a fresh fitter resolves its decision) decide
   as the reference's unless its rel_err is within 2x of the threshold.
   Printed: each bar's gap, the probes' rel_errs beside the reference's,
   and each consumer's wall under float64 and forced float32 two_prod
   (median of ``PRECISION_REPS`` warm calls);  then the amortized phase (each
   stand-in's counts zeroed just before it; ``_amortized_phase``), from
   the reference's run under ``ref/amortized/``: on ell1 and ddgr
   ``AmortizedVI.from_bayesian`` on the stored box (K1's and K4's ELL1
   or K2's DDGR duals under autograd, their ``backward``), on
   pta67_catalog ``from_joint_likelihood`` at the ingest state on the
   reference's residuals (K10 forward, K12 backward), each with a 4 x 32
   flow: ``train_flow`` of 20 steps of 64 samples, then the reference's
   trained posterior's ``draw(4096)`` and ``log_prob`` at 256 points.
   Bars: ``init()`` bitwise, the samples within 2 ulp (the last step's
   bitwise), the ELBO, lnpost, logq and gradient at the stored first
   step, the free-running trace and final weights against the
   reference's run (op by op on ell1 and ddgr, where the snapshot holds
   it), the last step's gradient at the reference's stored state, Adam
   from the reference's gradient, draws, moments and log-probs, a save
   and load on the card; printed: 150 (pta67: 100) timed steps, a step's
   forward and backward ms, busy share, peak memory, draws/s and
   log-probs/s; then the amortized_reduced phase
   (``_amortized_reduced_phase``): ell1 trained under
   ``use_policy(PrecisionPolicy.forced("float32"))`` (flow.coupling at
   float32 with float64 accumulation: K11 forward, its gradient K11's
   backward) against ``ref/amortized_reduced/`` at the amortized phase's ell1 bars (the
   ELBO and gradient at the initial parameters, the first two steps' ELBO
   and the whole trace 1e-6 rel of the reference's op-by-op run, the
   final weights and the gradient at the stored state 1e-6 of each leaf's
   largest), then 2 steps under each of the eight (dtype, accumulation)
   specs of flow.coupling alone, so that every K11 forward and backward
   instantiation launches on the path, and 50 timed steps: steps/s and
   the busy share of 5 steps; then the predict phase
   (``_predict_phase``), from the
   snapshots' models and the port's own host layer (clock corrections,
   TDB, posvels, each component's context of the node TOAs), against the
   reference's ``ref/predict/``: P1, the bench's read path, on ngc (a
   ``PredictorCache`` at the barycentre over 2 days from PEPOCH, 48
   windows of 60 minutes with 12 coefficients: ``build()``, a settle
   batch, 8 requests x 48 epochs coalesced through
   ``run_predict_requests``, 12 single-request probes), and P2, one
   ``generate_predictor_sets`` at GBT over 2.5 days from MJD 55000 for
   b1855, ell1, ddk and ddgr (240 rows on the 256 rung, 5760 node TOAs),
   then b1855's cache at GBT serving P1's mix -- each path's counts
   zeroed just before it and read after, K13 and K14 (and the phase's K1,
   K2 and K4 primals) required to launch.  Bars: the host layer at every
   stored node set and the TZR row it builds (clock and TDB 1e-12 s,
   positions 1 mm, velocities 1e-9 km/s), the node targets (integer
   phases exactly, y and rfrac 1e-10 cycles), the predicted phases 1e-10
   cycles, frequencies 1e-12 rel, fit rms 1e-11 cycles -- each phase bar
   at least 8 (targets) or 16 (predictions, rms) granules ulp(F0
   max|delay|), the rounding both packages' spin phase carries --, the
   windows logged above ``FIT_RMS_WARN`` the reference's, every
   PredictResult's bucket, batch and windows equal and no kernel build
   during a call; printed: P1's and b1855's ``predicts_per_s``, p50/p99
   ms of the probes and ``cache_hit_rate``, P2's generation wall s, each
   after ``torch.cuda.synchronize()``;
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
   rel; K1's, K4's ELL1, K2's DDGR and K7's primals on the mcmc phase's
   B = 128 walker rows (every parameter distinct per row), bitwise,
   timed and recorded with the phase's launches; K8 in each mode on the
   photon_j0030 path's calls and on edge rows (phases 0, -0.0, -1e-17,
   1 - 1e-16, every k / 256 and one ulp either side, NaN rows; weights
   with exact 0s and 1s, and none; a zero-density bin; 1, 2 and 5 peaks
   of sigma 0.005-0.3): the density bitwise, NaN where the plain version
   has NaN, each row's sum within 1e-12 of its sum of |terms|, two
   launches bitwise; timed on a half-ensemble's B = 64 rows, the row
   sum against ``torch.sum``.  K9: ``stream_ingest`` on the
   stream path's calls (k = 16 appends, the k = 64 backlog, the k = 4
   quarantine and release) and ``chol_rank_update`` on the path's factor,
   then both on random factors at K = 23 (shared memory) and 233
   (global), each sign, zero rows interleaved, a downdate of absent rows:
   the factor bitwise its plain version's (NaN alike), b' and chi2'
   within 1e-13 of their sums of |terms|, ok and cond equal, zero rows
   bitwise no-ops; timed beside ``torch.linalg.cholesky_ex`` of the
   updated Gram (the library yardstick) and the bound, the chain of
   dependent steps (n + K - 1 a wavefront pass of n rows) and the us a
   step printed.  K10 on the catalog path's G and u at B = 16 and 32 of
   the bench's points and the 48 stored ones, in the wrapper's chunks, in
   one chunk and in chunks of 3, and on zero-amplitude rows: bitwise its
   plain version (and within 1e-12 of its scale), exactly 0.0 at zero
   amplitude, its workspace within its cap; timed (the median of 5 warm
   calls) beside the library's ``cholesky_ex`` + ``solve_triangular`` + log-determinant and
   the bound.  K11 in each accumulation mode and compute dtype on the
   largest call each consumer gave it in the precision phase and on
   seeded random operands (a 1-D rhs, a shared operand, k = 1, k <
   split, k off the tile, a zero column, NaN and Inf), within
   ``4 k_blk 2^-53 (|a|@|b|)`` elementwise (``2 k 2^-24 (|a|@|b|)`` for
   native, plus a bfloat16 ulp for bfloat16) of its twin, NaN and Inf
   where the twin's; timed on each consumer's call (the record: the
   largest) beside its bound (a multiply and an add a product, three
   products a pair under two_prod, at the float64 tensor cores' rate --
   the products of the rounded parts are exact in float64 -- or for
   native at float32's CUDA-core rate or bfloat16's tensor-core rate) and
   the library's ``torch.matmul`` of the pre-rounded operands, one call a
   pass.
   K11's backward in each accumulation mode and compute dtype, bitwise
   its plain twin, on the amortized_reduced path's largest call (the
   coupling MLP's (64, 32) @ (32, 45)), seeded flow shapes, an off-tile
   batch and the serve Gram (4, 512, 4096) @ (4, 4096, 512); timed at the
   path's call and at the serve Gram beside its bound (a, b and g read
   and da, db written once, or 2 m k n multiply-adds for each cotangent,
   twice under two_prod, at the float64 tensor cores' rate; native at
   float32's or bfloat16's), the twin and the library's ``torch.matmul``
   of the cotangent with the pre-rounded operands, then the rounding.
   K8's MIXED density and log-likelihood kernels on the photon_mixed
   path's calls and on edge rows (phases 0, -0.0, -1e-17, 1 - 1e-16, each
   primitive's location and half a cycle off with an ulp either side, a
   NaN row) under the path's table, each primitive alone and a wide King
   and Lorentzian: the density bitwise, each row's sum within 1e-12 of its
   sum of |terms|, two launches bitwise; timed at B = 64 rows of 32768
   photons read from HBM beside the bound (``_k8_mixed_ops``).
   K12 against its plain version on the amortized pta67 path's G, u and
   walker points at B = 16, 32, 48 and 64 in every chunking (bitwise,
   within 1e-12 x sum_k |e_k| (w_k^2 + (M^-1)_kk + 1)), exactly 0.0 at
   zero amplitude, timed beside ``cholesky_ex`` + ``cholesky_inverse`` +
   ``solve_triangular`` and its bound (the factor's and the inverse's
   2 R^3 / 3 flops a walker at the float64 tensor cores); each kernel Function's ``backward``
   (K1, K2 in each mode, K4, K6, K7) against autograd through its twin at
   its path's inputs, within 1e-10 of each input's largest.
   K14 ``polyco_fit`` on P1's and P2's calls and on 256 seeded rows of
  which 200 are pad rows (exactly 0), K13 ``polyco_eval`` on P1's and
  P2's calls and on seeded evaluations, each bitwise its plain version;
  timed (median of 20 warm calls) beside its bound (launch-sized at these
  shapes), its plain version and, for K14, ``torch.linalg.lstsq`` on the
  same rows.
  K2's Newton steps on each path's inputs set its operation count; the
   per-element operation counts of K1, K2, K4, K6 and K7 are bounded at
   the float64 instruction rate (-fmad=false; K6's, K7's and K8's count
   each math-library call at its SASS count, ``SASS_OPS``); K5's counts what its function
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
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float64 rate of
#: the CUDA cores and that of the tensor cores (float64 matrix products)
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
F64_TC_FLOP_PER_S = 67e12
#: float32 outside the tensor cores and bfloat16 on them (dense), the
#: rates that bound K11's native products
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
#: float64 instructions per second of the CUDA cores: 132 SMs x 64 FP64
#: lanes x 1.98 GHz.  The 34 TFLOP/s above counts a fused multiply-add as
#: two operations; the kernels are built with -fmad=false (their
#: double-double and folded products must round alone), so each add and
#: multiply is an instruction of its own, and the per-element operation
#: counts of K1, K2 and K4 are bounded at this rate
F64_INSTR_PER_S = 132 * 64 * 1.98e9
#: the H100 SXM's L2 cache: a timed loop whose inputs fit in it reads them
#: from the cache, not from HBM
L2_BYTES = 50 * 2**20

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


#: the launch functions :class:`Capture` spies on: each kernel module's
#: ``_launch``, and K10's module's ``_launch_value_and_grad`` (K12's
#: sequence), recorded as ``hd_cross_lnlike_value_and_grad``
LAUNCHERS = ("_launch", "_launch_value_and_grad")


class Capture:
    """Spy on each kernel module's launch functions (:data:`LAUNCHERS`):
    keeps a copy of the largest
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
            for attr in LAUNCHERS:
                if not hasattr(mod, attr):
                    continue
                orig = getattr(mod, attr)
                self._orig[(name, attr)] = orig

                def spy(*args, _orig=orig,
                        _name=name + attr[len("_launch"):]):
                    self._record(_name, args)
                    return _orig(*args)

                setattr(mod, attr, spy)

    def remove(self):
        for (name, attr), orig in self._orig.items():
            setattr(self.kernels[name], attr, orig)

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
        elif name == "photon_lnlike":
            partials = (int(args[3]), bool(args[4]))
        elif name == "chol_rank_update":
            partials = (len(args) > 3 and args[3] is not None,
                        int(args[1].shape[0]), float(args[2]))
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


def _rotated(fn, x, *rest):
    """``fn`` on ``x``'s copies in turn, with ``rest`` after it: copies
    enough that together they hold four times the L2 cache, so that each
    call of a timed loop reads its ``x`` from HBM as the bytes bound
    assumes."""
    import itertools

    n = max(2, math.ceil(4 * L2_BYTES / (x.numel() * x.element_size())))
    copies = itertools.cycle([x.clone() for _ in range(n)])
    return lambda: fn(next(copies), *rest)


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
    auto_cls = type(out["fits"]["auto"][0]).__name__ \
        if "auto" in out["fits"] else None
    if auto_cls is not None:
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
    auto_note = f"Fitter.auto {auto_cls} vs {rref['auto_fitter']}; " \
        if auto_cls is not None else ""
    print(f"phase bars {label}: residuals max|d| {d_res:.3e} s (<= 1e-10); "
          f"design matrix max col-rel {d_M:.3e}; {auto_note}"
          + "; ".join(notes) + f"; {grid_note}", flush=True)
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


#: the mcmc phase's bar: lnposterior within LNPOST_BAR of the reference's
#: chi2 at each point (the 1e-6-relative chi2 bar carried over to -chi2/2)
LNPOST_BAR = 5e-7


def _bayes_info(meta, ref) -> dict:
    """The stored prior box as ``prior_info``."""
    bz = meta["reference"]["bayes"]
    return {p: dict(distr="uniform", pmin=float(lo), pmax=float(hi))
            for p, lo, hi in zip(bz["params"], ref["ref/bayes/pmin"],
                                 ref["ref/bayes/pmax"])}


def _chain_bars(f, want, accepted, bars, tol, final) -> dict:
    """The chain bars on the port's run ``f`` (its sampler's
    ``decision_log`` set) against the reference's stored run from the
    same walkers, ``want`` its (T, W, ndim) chain and ``accepted`` its (T,
    W) decisions: each decision the reference's unless the port's margin
    ``|lnratio - log u|`` is within ``tol(bar of the proposal, bar of the
    current point)``, ``bars(k)`` the (n,) lnposterior bars of the
    starting walkers (k = 0) and of half-step k - 1's proposals; the
    walkers bitwise up to the first decision that differs.  With no
    decision differing, ``final(out, hist)`` holds the whole run to the
    phase's own bars (``hist`` the (T, W) bars of each step's walkers) and
    adds to ``out`` what it found.  Returns what it found; raises on a
    broken bar."""
    import numpy as np

    s = f.sampler
    chain = s.get_chain()
    T, W, _ = want.shape
    half = W // 2
    bar_cur = np.array(bars(0), dtype=np.float64)
    hist, inside, diverged = [], [], None
    for t in range(T):
        for h in (0, 1):
            sl = slice(0, half) if h == 0 else slice(half, W)
            marg, _ = s.decision_log[2 * t + h]
            bp = bars(1 + 2 * t + h)
            with np.errstate(invalid="ignore"):
                inm = np.isfinite(marg) & (np.abs(marg)
                                           <= tol(bp, bar_cur[sl]))
            inside += [t] * int(inm.sum())
            acc = marg > 0
            differ = acc != accepted[t, sl]
            if (differ & ~inm).any():
                raise RuntimeError(f"an accept decision at step {t} differs "
                                   "from the reference's outside the margin")
            if differ.any():
                diverged = (t, h)
                break
            bar_cur[sl][acc] = bp[acc]
        if diverged:
            break
        hist.append(bar_cur.copy())
    upto = diverged[0] if diverged else T
    if not np.array_equal(chain[:upto], want[:upto]):
        raise RuntimeError(f"the walkers are not bitwise the reference's "
                           f"before step {upto}")
    out = dict(inside=len(inside), inside_steps=sorted(set(inside)),
               diverged=diverged, bitwise_steps=upto)
    if not diverged:
        final(out, np.asarray(hist))
    return out


def _mcmc_chain_bars(stored, bz, f, pos) -> dict:
    """:func:`_chain_bars` of the mcmc phase: each point's bar
    LNPOST_BAR x its chi2, the margin twice the larger of the proposal's
    and the current point's; with no decision inside the margin the
    whole chain bitwise, lnprob at the lnposterior bar, the acceptance and
    the maximum's index exact, its values and the stds bitwise and the
    returned chi2 to 1e-6 rel."""
    import numpy as np

    s, bt = f.sampler, f.bt
    lnpr = float(sum(p.prior.logpdf(p.prior.ppf(0.5)) for p in bt.params))

    def chi2_of(lp):
        return -2.0 * (lp - lnpr + bt.lognorm)

    lp0 = bt.lnposterior_batch(pos)

    def bars(k):
        with np.errstate(invalid="ignore"):
            return LNPOST_BAR * chi2_of(lp0 if k == 0
                                        else s.decision_log[k - 1][1])

    def final(out, hist):
        if out["inside"]:
            return
        lnprob = s.get_log_prob()
        c2 = -2.0 * (stored["lnprob"] - lnpr + bt.lognorm)
        dl = float(np.max(np.abs(lnprob - stored["lnprob"]) / c2))
        n = lnprob.shape[0]
        lnp = s.get_log_prob(flat=True, discard=int(n * bz["burn_frac"]))
        chi2 = f.model["CHI2"].value
        dchi2 = abs(chi2 - bz["chi2"]) / abs(bz["chi2"])
        ok = (dl <= LNPOST_BAR
              and s.naccepted == bz["naccepted"]
              and int(np.argmax(lnp)) == bz["maxpost_index"]
              and np.array_equal(f.maxpost_fitvals,
                                 stored["maxpost_fitvals"])
              and np.array_equal([f.errors[p] for p in f.fitkeys],
                                 stored["stds"])
              and dchi2 <= 1e-6)
        if not ok:
            raise RuntimeError("with no decision inside the margin the "
                               "chain, lnprob, acceptance, maximum, stds or "
                               "chi2 differ from the reference's")
        out.update(lnprob_rel=dl, chi2_rel=dchi2)

    return _chain_bars(f, stored["walker_chain"].transpose(2, 0, 1),
                       stored["accepted"], bars,
                       lambda bp, bc: 2.0 * np.maximum(bp, bc), final)


def _profile_cuda(fn):
    """(CUDA events, summed device microseconds, wall s) of one ``fn()``
    under ``torch.profiler``; (None, None, wall) where the profiler shows
    no device activity or cannot read it (a measurement, not a bar)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    try:
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.time_range.elapsed_us() for e in dev)
    except (AttributeError, RuntimeError) as e:
        print(f"chip_smoke: torch.profiler's events unreadable: {e}",
              file=sys.stderr)
        dev = []
    if not dev:
        return None, None, wall
    return len(dev), us, wall


def _mcmc_phase(label, path, kernels, tag, busy: bool = False):
    """The Bayesian timing interface and the ensemble MCMC on one path,
    from the reference's outputs under the snapshot's ``ref/bayes/``, its
    counts zeroed just before and read just after: ``BayesianTiming``
    with the stored prior box, ``lnposterior_batch`` at the stored points,
    ``lnprior`` and ``prior_transform``, then the seeded
    ``MCMCFitter.fit_toas`` from the stored walkers.  Bars: lnposterior
    within 5e-7 of the reference's chi2 at each point, -inf (and NaN)
    exactly where the reference has them; lnprior and prior_transform
    1e-12 rel; the chain bars (:func:`_mcmc_chain_bars`).  Printed: steps/s and
    walker evaluations/s over the run, the acceptance fraction, then
    ``lnposterior_batch`` at B = 128 walker rows (the median of 5 warm
    calls), its kernel launches (the wrappers' counters) and all its CUDA
    kernels (``torch.profiler``), with ``busy`` the device's busy share
    of 5 warm steps.  Returns (the run's counts, the capture of the B =
    128 call)."""
    import numpy as np
    import torch

    from pint_torch.bayesian import BayesianTiming
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.mcmc_fitter import MCMCFitter
    from pint_torch.sampler import EnsembleSampler

    meta, ref = read_snapshot(path)
    bz = meta["reference"]["bayes"]
    stored = {k[len("ref/bayes/"):]: v for k, v in ref.items()
              if k.startswith("ref/bayes/")}
    info = _bayes_info(meta, ref)
    kernels.reset_counts()
    model, batch = load_snapshot(path, device="cuda")
    bt = BayesianTiming(model, batch, prior_info=info)
    pts = stored["points"]
    lp = bt.lnposterior_batch(pts)
    want = stored["lnposterior"]
    same_nonfinite = bool(np.array_equal(np.isneginf(lp), np.isneginf(want))
                          and np.array_equal(np.isnan(lp), np.isnan(want)))
    fin = np.isfinite(want)
    d_lp = float(np.max(np.abs(lp[fin] - want[fin]) / stored["chi2"][fin]))
    lnpr = np.array([bt.lnprior(x) for x in pts])
    fin_p = np.isfinite(stored["lnprior"])
    d_pr = float(np.max(np.abs(lnpr[fin_p] - stored["lnprior"][fin_p])
                        / np.abs(stored["lnprior"][fin_p])))
    same_pr = bool(np.array_equal(np.isneginf(lnpr),
                                  np.isneginf(stored["lnprior"])))
    pt = np.array([bt.prior_transform(c) for c in stored["cubes"]])
    d_pt = float(np.max(np.abs(pt - stored["prior_transform"])
                        / np.abs(stored["prior_transform"])))
    s = EnsembleSampler(bz["nwalkers"], seed=bz["seeds"]["sampler"])
    s.decision_log = []
    f = MCMCFitter(batch, model, prior_info=info, sampler=s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    chi2 = f.fit_toas(maxiter=bz["nsteps"], pos=stored["pos"].copy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    print(f"phase mcmc {label}: N={batch.ntoas} TOAs, {len(bt.param_labels)} "
          f"free, {bz['nwalkers']} walkers x {bz['nsteps']} steps, "
          f"{bt.likelihood_method}; lnposterior at {len(pts)} points max|d| "
          f"{d_lp:.3e} of chi2 (<= {LNPOST_BAR:g}), -inf/NaN where the "
          f"reference's {same_nonfinite}; lnprior max rel {d_pr:.3e}, "
          f"prior_transform max rel {d_pt:.3e} (<= 1e-12); fit_toas "
          f"{wall:.4f} s, {bz['nsteps'] / wall:.2f} steps/s, "
          f"{bz['nwalkers'] * (bz['nsteps'] + 1) / wall:.1f} walker "
          f"evaluations/s, acceptance {s.acceptance_fraction:.6f} "
          f"(reference {bz['acceptance']:.6f}), chi2 {chi2:.10g}; launches "
          f"(nonzero) {dict((k, v) for k, v in counts.items() if v)} {tag}",
          flush=True)
    if not (same_nonfinite and d_lp <= LNPOST_BAR and same_pr
            and d_pr <= 1e-12 and d_pt <= 1e-12):
        raise RuntimeError(f"mcmc bar failed ({label}): lnposterior, "
                           "lnprior or prior_transform")
    cb = _mcmc_chain_bars(stored, bz, f, stored["pos"])
    print(f"phase mcmc {label} chain: {cb['inside']} decision(s) inside the "
          f"margin" + (f" at step(s) {cb['inside_steps']}" if cb["inside"]
                       else "")
          + f"; first differing decision {cb['diverged']}; walkers bitwise "
          f"over {cb['bitwise_steps']} of {bz['nsteps']} steps"
          + (f"; whole chain bitwise, lnprob max|d| {cb['lnprob_rel']:.3e} "
             f"of chi2, acceptance and maximum exact, stds bitwise, chi2 "
             f"rel {cb['chi2_rel']:.3e}" if not cb["inside"] else "")
          + f" {tag}", flush=True)
    # B = 128 walker rows of the run: the median of 5 warm calls, the
    # kernel launches of one, its CUDA kernels under the profiler
    rows = f.sampler.get_chain(flat=True)[-128:]
    cap = Capture(kernels.modules())
    cap.install()
    before = kernels.launch_counts()
    bt.lnposterior_batch(rows)
    one = {k: v - before[k] for k, v in kernels.launch_counts().items()
           if v != before[k]}
    cap.remove()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        bt.lnposterior_batch(rows)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    n_ev, dev_us, wall_p = _profile_cuda(lambda: bt.lnposterior_batch(rows))
    line = (f"phase mcmc {label} B=128: lnposterior_batch median of 5 warm "
            f"{1e3 * float(np.median(times)):.4f} ms; kernel launches per "
            f"evaluation {one} ({sum(one.values())}); CUDA kernels per "
            f"evaluation (torch.profiler) "
            + (f"{n_ev}, device {dev_us / 1e3:.4f} ms of {wall_p * 1e3:.4f} "
               "ms wall" if n_ev else "not measured (no device events)"))
    if busy:
        x = f.sampler.get_chain()[-1].copy()
        s5 = EnsembleSampler(bz["nwalkers"], seed=1)
        s5.initialize_batched(bt.lnposterior_batch, len(bt.param_labels))
        s5.run_mcmc(x, 1)
        n5, us5, w5 = _profile_cuda(lambda: s5.run_mcmc(x, 5))
        line += ("; busy share of 5 warm steps "
                 + (f"{us5 / 1e6 / w5:.4f} ({us5 / 1e3:.2f} ms device of "
                    f"{w5 * 1e3:.2f} ms wall, {n5} CUDA events)" if n5
                    else "not measured (no device events)"))
    print(line + f" {tag}", flush=True)
    return counts, cap


def _mcmc_resume(path, tag) -> None:
    """On the path's snapshot a checkpointed run of half the steps plus a
    resumed half must equal an uninterrupted run bitwise."""
    import tempfile

    import numpy as np

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.mcmc_fitter import MCMCFitter
    from pint_torch.sampler import EnsembleSampler

    meta, ref = read_snapshot(path)
    bz = meta["reference"]["bayes"]
    info = _bayes_info(meta, ref)
    model, batch = load_snapshot(path, device="cuda")
    n, seed = bz["nsteps"], bz["seeds"]["sampler"]

    def run(steps, sampler, **kw):
        f = MCMCFitter(batch, model, prior_info=info, sampler=sampler)
        chi2 = f.fit_toas(maxiter=steps, **kw)
        return f.sampler, chi2

    whole, c_whole = run(n, EnsembleSampler(bz["nwalkers"], seed=seed),
                         pos=ref["ref/bayes/pos"].copy())
    with tempfile.TemporaryDirectory() as d:
        ck = str(Path(d) / "chain.npz")
        run(n // 2, EnsembleSampler(bz["nwalkers"], seed=seed),
            pos=ref["ref/bayes/pos"].copy(), checkpoint=ck)
        resumed, c_res = run(n, EnsembleSampler(bz["nwalkers"]),
                             checkpoint=ck)
    same = bool(np.array_equal(resumed.get_chain(), whole.get_chain())
                and np.array_equal(resumed.get_log_prob(),
                                   whole.get_log_prob())
                and resumed.naccepted == whole.naccepted and c_res == c_whole)
    print(f"phase mcmc resume: {n // 2} checkpointed + {n - n // 2} resumed "
          f"steps equal {n} uninterrupted bitwise {same} {tag}", flush=True)
    if not same:
        raise RuntimeError("a resumed MCMC run differs from an "
                           "uninterrupted one")


#: the photon phase's bar on a photon's phase [s]: the residual bar,
#: carried to phases (x F0 cycles) and to the log-likelihood
PHOTON_BAR_S = 1e-10


def _k8_ops(mode: int, density: bool, npeaks: int = 0) -> int:
    """float64 instructions per photon (and walker row) of K8's work,
    with an exponential, a logarithm and a division at their SASS counts
    (``SASS_OPS``) and every other operation as 1.  The wrap x - floor(x)
    (2); BINNED the scaled index (1: its conversion and clip are integer
    work); GAUSS per peak the wrap of phi - loc (3), 13 images each an
    add, a division, two products, an exponential and a sum, then s / den,
    the product by the norm and the sum (2 and a division); the
    log-likelihood the weights' product, 1 - w and their sum (3), the
    floor at 1e-300 (1), the logarithm and the block sum (1).  The GAUSS
    count, 403 a peak, is the SASS's: its peak loop issues 402 float64
    instructions a pass (``tools/torch_sass_ops.py``)."""
    from pint_torch.kernels.photon_lnlike import NWRAP

    ops = 2 + (1 if mode == 0 else npeaks * (
        3 + (2 * NWRAP + 1) * (4 + _DIV + _EXP) + 2 + _DIV))
    return ops if density else ops + 3 + 1 + _LOG + 1


def _photon_template(meta):
    """The stand-in's template, rebuilt from its settings' peaks."""
    from pint_torch.templates import LCGaussian, LCTemplate

    s = meta["reference"]["photon"]["settings"]
    return LCTemplate([LCGaussian([w, loc]) for w, loc, _ in s["peaks"]],
                      [n for _, _, n in s["peaks"]])


def _photon_bars(f, pts):
    """(B,) bar of the lnposterior of fitter ``f`` at each of the (B,
    ndim) host points: 1e-12 x sum_i |term_i| (the sums' order) plus,
    binned, the jump to the neighbouring bin's term of each photon whose
    phase lies within the phase bar (1e-10 s x F0) of a bin edge, or,
    analytic, the phase bar times sum_i |d term_i / d phi| (a central
    difference of the plain density); term_i = log(max(w_i f(phi_i) + 1
    - w_i, 1e-300)) at the port's phases.  A check, computed with K8's
    plain version off the main path."""
    import torch

    from pint_torch.kernels.photon_lnlike import (BINNED,
                                                  photon_lnlike_reference)

    dev = f.batch.device
    vals = torch.as_tensor(pts, dtype=torch.float64, device=dev)
    frac = f.model.evaluate(vals, tuple(f.fitkeys), f.batch,
                            f.model.const_pv())[0].frac
    w = None if f.weights is None else torch.as_tensor(
        f.weights, dtype=torch.float64, device=dev)
    mode, table = f._table()
    floor = torch.full((), 1e-300, dtype=torch.float64, device=dev)

    def terms(x):
        d = photon_lnlike_reference(x, None, table, mode, density=True)
        return torch.log(torch.maximum(d if w is None else w * d + (1 - w),
                                       floor))

    t0 = terms(frac)
    bar = 1e-12 * t0.abs().sum(-1)
    dphi = PHOTON_BAR_S * f.model.value("F0")
    if mode == BINNED:
        nb = table.shape[0]
        x = torch.remainder(frac, 1.0) * nb
        near = (x - torch.round(x)).abs() <= dphi * nb
        jump = (terms(frac + dphi) - terms(frac - dphi)).abs()
        bar = bar + torch.where(near, jump, 0.0).sum(-1)
    else:
        h = 1e-7
        slope = (terms(frac + h) - terms(frac - h)).abs() / (2 * h)
        bar = bar + dphi * slope.sum(-1)
    return bar.cpu().numpy()


def _photon_chain_bars(kind, f, stored, props, ref) -> dict:
    """:func:`_chain_bars` of the photon phase, ``props`` every point the
    run evaluated in order (the walkers, then each half-step's
    proposals): each point's bar :func:`_photon_bars`, the margin the sum
    of the proposal's and the current point's; with no decision differing
    each lnprob within its point's bar, the acceptance and the maximum's
    index exact, its values and the stds bitwise."""
    import numpy as np

    s = f.sampler
    bars = [_photon_bars(f, p) for p in props]

    def final(out, hist):
        lnprob = s.get_log_prob()
        dlp = np.abs(lnprob - stored[f"{kind}/lnprob"])
        ratio = float(np.max(dlp / np.maximum(hist, 1e-300)))
        burn = int(lnprob.shape[0] * 0.25)
        lnp = s.get_log_prob(flat=True, discard=burn)
        lnp_ref = stored[f"{kind}/lnprob"][burn:].reshape(-1)
        ok = (ratio <= 1.0 and s.naccepted == ref[kind]["naccepted"]
              and int(np.argmax(lnp)) == int(np.argmax(lnp_ref))
              and np.array_equal(f.maxpost_fitvals,
                                 stored[f"{kind}/maxpost_fitvals"])
              and np.array_equal([f.errors[p] for p in f.fitkeys],
                                 stored[f"{kind}/stds"]))
        if not ok:
            raise RuntimeError(f"photon {kind}: with no decision differing "
                               "the lnprob, acceptance, maximum or stds "
                               "differ from the reference's")
        out.update(lnprob_ratio=ratio,
                   maxpost_d=abs(f.maxpost - ref[kind]["maxpost"]))

    return _chain_bars(f, stored[f"{kind}/walker_chain"].transpose(2, 0, 1),
                       stored[f"{kind}/accepted"], bars.__getitem__,
                       lambda bp, bc: bp + bc, final)


def _photon_phase(label, path, kernels, tag):
    """The photon domain on one photon stand-in, the counts zeroed just
    before each ``fit_toas`` and each ``get_template_vals`` and read just
    after (the checks' launches are not counted): load, the photons'
    phases against the
    reference's, the FFTFIT start of ``event_optimize`` (weighted profile,
    ``fftfit_full``, ``rotate``, ``set_template``), then for
    ``MCMCFitterBinnedTemplate`` and ``MCMCFitterAnalyticTemplate`` the
    lnposterior at the stored points, ``get_template_vals`` at the
    phases, and the seeded ``fit_toas`` from the stored walkers.  Bars:
    phases within 1e-10 s x F0 cycles; the shift within 1e-10 cycles (if
    no photon's bin moved); each lnposterior within :func:`_photon_bars`,
    -inf exactly where the reference's; the template values 1e-13 rel of
    the host's; the chain bars (:func:`_photon_chain_bars`).  Printed:
    steps/s and walker evaluations/s, acceptance, then
    ``lnposterior_batch`` at B = nwalkers / 2 walker rows (the median of 5
    warm calls), its launches, its CUDA kernels under ``torch.profiler``
    and the peak of ``torch.cuda.max_memory_allocated`` over one call.
    Returns (the two ``fit_toas``' counts, the two
    ``get_template_vals``' counts, the capture of the phase's kernel calls:
    the largest of each instantiation)."""
    import numpy as np
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.event_fitter import (MCMCFitterAnalyticTemplate,
                                         MCMCFitterBinnedTemplate)
    from pint_torch.fftfit import fftfit_full
    from pint_torch.sampler import EnsembleSampler

    meta, ref = read_snapshot(path)
    R = meta["reference"]["photon"]
    S = R["settings"]
    stored = {k[len("ref/photon/"):]: v for k, v in ref.items()
              if k.startswith("ref/photon/")}
    nbins, info = R["nbins"], R["prior_info"]
    counts, tv_counts = {}, {}

    def counted(into, fn):
        """``fn()`` with the counts zeroed just before and added to
        ``into`` just after."""
        kernels.reset_counts()
        r = fn()
        for k, v in kernels.launch_counts().items():
            into[k] = into.get(k, 0) + v
        return r

    cap = Capture(kernels.modules())
    cap.install()
    t_phase = t = time.perf_counter()
    model, batch = load_snapshot(path, device="cuda")
    template = _photon_template(meta)
    fb = MCMCFitterBinnedTemplate(batch, model, template, nbins=nbins,
                                  prior_info=info)
    phases = fb.phaseogram_phases()
    F0 = model.value("F0")
    d_ph = (phases - stored["phases"] + 0.5) % 1.0 - 0.5
    n_diff = int(np.count_nonzero(d_ph))
    b_port = np.minimum((phases * nbins).astype(int), nbins - 1)
    b_ref = np.minimum((stored["phases"] * nbins).astype(int), nbins - 1)
    n_bin = int(np.count_nonzero(b_port != b_ref))
    prof, _ = np.histogram(phases, bins=nbins, range=(0.0, 1.0),
                           weights=fb.weights)
    grid = (np.arange(nbins) + 0.5) / nbins
    fft = fftfit_full(np.asarray(template(grid)), prof.astype(np.float64))
    if n_bin:  # a photon changed bin: hold the FFT to the reference's bins
        prof_r, _ = np.histogram(stored["phases"], bins=nbins,
                                 range=(0.0, 1.0), weights=fb.weights)
        fft_chk = fftfit_full(np.asarray(template(grid)),
                              prof_r.astype(np.float64))
    else:
        fft_chk = fft
    d_shift = abs(fft_chk[0] - R["fftfit"][0])
    rotated = template.copy()
    rotated.rotate(fft[0])
    fb.set_template(rotated)
    fa = MCMCFitterAnalyticTemplate(batch, model, rotated, prior_info=info)
    load_s = time.perf_counter() - t
    line = (f"phase photon {label}: N={batch.ntoas} photons "
            f"({'weighted' if fb.weights is not None else 'unweighted'}), "
            f"free {fb.fitkeys}; phases max|d| {np.abs(d_ph).max():.3e} "
            f"cycles (<= {PHOTON_BAR_S * F0:.3e}), {n_diff} photon(s) differ "
            f"at all, {n_bin} in another of {nbins} bins; FFTFIT shift "
            f"{fft[0]:.15f} +/- {fft[1]:.3e} (reference {R['fftfit'][0]:.15f},"
            f" |d| {d_shift:.3e} <= 1e-10); start {load_s:.4f} s")
    print(line + f" {tag}", flush=True)
    if np.abs(d_ph).max() > PHOTON_BAR_S * F0 or d_shift > 1e-10:
        raise RuntimeError(f"photon bar failed ({label}): phases or FFTFIT")
    pts = stored["points"]
    host_vals = np.asarray(rotated(phases))
    out = {}
    for kind, f in (("binned", fb), ("analytic", fa)):
        lp = f.lnposterior_batch(pts)
        want = stored[f"lnposterior_{kind}"]
        same_inf = bool(np.array_equal(np.isneginf(lp), np.isneginf(want))
                        and not np.isnan(lp).any())
        fin = np.isfinite(want)
        bars = _photon_bars(f, pts[fin])
        ratio = float(np.max(np.abs(lp[fin] - want[fin]) / bars))
        tv = counted(tv_counts, lambda: f.get_template_vals(phases))
        tv_ref = host_vals if kind == "analytic" else \
            f.template_bins[np.minimum(((phases % 1.0) * nbins).astype(int),
                                       nbins - 1)]
        d_tv = float(np.max(np.abs(tv - tv_ref) / np.abs(tv_ref)))
        print(f"phase photon {label} {kind}: {f!r}; lnposterior at "
              f"{len(pts)} points max |d| / bar {ratio:.3e} (<= 1; bars "
              f"{bars.min():.3e}-{bars.max():.3e}), -inf where the "
              f"reference's {same_inf} ({int((~fin).sum())} outside the "
              f"box); get_template_vals max rel {d_tv:.3e} (<= 1e-13) {tag}",
              flush=True)
        if not (same_inf and ratio <= 1.0 and d_tv <= 1e-13):
            raise RuntimeError(f"photon bar failed ({label} {kind}): "
                               "lnposterior or template values")
        # the seeded chain from the stored walkers, each evaluated point
        # recorded for the bars
        s = EnsembleSampler(S["nwalkers"], seed=R["seeds"]["sampler"])
        s.decision_log = []
        f.sampler = s
        props = []
        evaluate = f.lnposterior_batch

        def recorded(p, _ev=evaluate):
            props.append(np.array(p))
            return _ev(p)

        f.lnposterior_batch = recorded
        torch.cuda.synchronize()
        t = time.perf_counter()
        maxpost = counted(counts, lambda: f.fit_toas(
            maxiter=S["nsteps"], pos=stored[f"{kind}/pos"].copy()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        del f.lnposterior_batch
        cb = _photon_chain_bars(kind, f, stored, props, R)
        print(f"phase photon {label} {kind} chain: {S['nwalkers']} walkers "
              f"x {S['nsteps']} steps, fit_toas {wall:.4f} s, "
              f"{S['nsteps'] / wall:.2f} steps/s, "
              f"{S['nwalkers'] * (S['nsteps'] + 1) / wall:.1f} walker "
              f"evaluations/s, acceptance {s.acceptance_fraction:.6f} "
              f"(reference {R[kind]['acceptance']:.6f}), maxpost "
              f"{maxpost:.10f}; {cb['inside']} decision(s) inside the margin"
              + (f" at step(s) {cb['inside_steps']}" if cb["inside"] else "")
              + f"; first differing decision {cb['diverged']}; walkers "
              f"bitwise over {cb['bitwise_steps']} of {S['nsteps']} steps"
              + (f"; whole chain bitwise, lnprob max |d| / bar "
                 f"{cb['lnprob_ratio']:.3e}, acceptance and maximum exact, "
                 f"stds bitwise, maxpost |d| {cb['maxpost_d']:.3e}"
                 if not cb["diverged"] else "") + f" {tag}", flush=True)
        out[kind] = f
    cap.remove()
    print(f"phase photon {label}: {time.perf_counter() - t_phase:.2f} s "
          f"wall (the bars' evaluations included); launches (nonzero) in "
          f"the two fit_toas {dict((k, v) for k, v in counts.items() if v)}"
          f"; in the two get_template_vals "
          f"{dict((k, v) for k, v in tv_counts.items() if v)} {tag}",
          flush=True)
    # B = nwalkers / 2 rows of each run (a half-ensemble): the median of 5
    # warm calls, the launches of one, its CUDA kernels, its peak memory
    for kind, f in out.items():
        rows = f.sampler.get_chain(flat=True)[-(S["nwalkers"] // 2):]
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        f.lnposterior_batch(rows)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        one = {k: v - before[k] for k, v in kernels.launch_counts().items()
               if v != before[k]}
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            f.lnposterior_batch(rows)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        n_ev, dev_us, wall_p = _profile_cuda(
            lambda: f.lnposterior_batch(rows))
        print(f"phase photon {label} {kind} B={len(rows)}: lnposterior_batch "
              f"median of 5 warm {1e3 * float(np.median(times)):.4f} ms; "
              f"kernel launches per evaluation {one} ({sum(one.values())}); "
              f"CUDA kernels per evaluation (torch.profiler) "
              + (f"{n_ev}, device {dev_us / 1e3:.4f} ms of "
                 f"{wall_p * 1e3:.4f} ms wall" if n_ev
                 else "not measured (no device events)")
              + f"; peak memory over one call {peak / 2**20:.2f} MiB above "
              f"{base / 2**20:.2f} MiB held {tag}", flush=True)
    return counts, tv_counts, cap


def _k8_kernels(capj, dev, tag) -> list:
    """K8 on the photon_j0030 path's calls (``capj``: the half-ensemble's
    B = 64 rows in each mode, get_template_vals' densities) and on edge
    rows: phases 0, -0.0, -1e-17, 1 - 1e-16, every k / 256 and one ulp
    either side (and each less 1), a row with NaNs and one all NaN;
    weights with exact 0s and 1s, and none; a zero-density bin (its
    photons weighted 1); 1, 2 and 5 Gaussian peaks with sigma 0.005 to
    0.3.  The density bitwise the plain version's, NaN where it has NaN;
    each row's sum within 1e-12 of its sum of |terms|; two launches
    bitwise; then each instantiation timed on a half-ensemble's B = 64
    rows, its phases read from HBM (:func:`_rotated`), beside its bound,
    and once with one L2-resident copy; the row sum on one copy of its
    partials, which lie in the L2 cache on the path too.  Returns the records' (kernel, source,
    replaces, err, ms, plain_ms, bound, library_ms) tuples."""
    import numpy as np
    import torch

    from pint_torch.kernels import photon_lnlike as K8
    from pint_torch.templates import LCGaussian, LCTemplate

    out = []

    def k8_same(a, b):
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a, nan=0.0),
                                    torch.nan_to_num(b, nan=0.0)))

    def k8_check(frac, w, table, mode):
        """(density bitwise, max |d sum| / sum |terms|, NaN rows alike,
        two launches bitwise, max |d density|)."""
        dk = K8._launch(frac, w, table, mode, True)
        dr = K8.photon_lnlike_reference(frac, w, table, mode, True)
        lk = K8._launch(frac, w, table, mode, False)
        lr = K8.photon_lnlike_reference(frac, w, table, mode, False)
        again = k8_same(dk, K8._launch(frac, w, table, mode, True)) \
            and k8_same(lk, K8._launch(frac, w, table, mode, False))
        v = dr if w is None else w * dr + (1 - w)
        scale = torch.log(torch.clamp_min(v, 1e-300)).abs().sum(-1)
        fin = torch.isfinite(lr)
        rel = float(((lk - lr).abs()[fin] / scale[fin]).max()) \
            if bool(fin.any()) else 0.0
        dd = (dk - dr).abs()
        err = float(dd[torch.isfinite(dd)].max()) if bool(
            torch.isfinite(dd).any()) else 0.0
        return (k8_same(dk, dr), rel, k8_same(lk[~fin], lr[~fin]), again,
                err)

    nb8 = 256
    edge = [0.0, -0.0, -1e-17, 1.0 - 1e-16, 0.5, -0.5, 1e-300, -1e-300]
    for k in range(nb8 + 1):
        x = k / nb8
        edge += [np.nextafter(x, -np.inf), x, np.nextafter(x, np.inf)]
    edge = np.asarray(edge)
    E8 = len(edge)
    rng8 = np.random.default_rng(20261023)
    nan_row = rng8.uniform(-0.5, 0.5, E8)
    nan_row[::7] = np.nan
    frac_e = torch.tensor(np.stack([edge, edge - 1.0,
                                    rng8.uniform(-0.5, 0.5, E8), nan_row,
                                    np.full(E8, np.nan)]),
                          dtype=torch.float64, device=dev)
    w_e = rng8.beta(0.5, 1.5, E8)
    w_e[::5], w_e[1::5] = 0.0, 1.0
    bins_path = capj.args("photon_lnlike", (K8.BINNED, False))[2]
    bins_zero = bins_path.clone()
    bins_zero[3] = 0.0
    in_zero = np.minimum(((edge % 1.0) * nb8).astype(int), nb8 - 1) == 3
    w_e[in_zero] = 1.0
    w_e = torch.tensor(w_e, dtype=torch.float64, device=dev)

    def gtab(peaks):
        t = LCTemplate([LCGaussian([sg, loc]) for sg, loc, _ in peaks],
                       [n for _, _, n in peaks])
        return torch.tensor(K8.gauss_table(t), dtype=torch.float64,
                            device=dev)

    gauss_path = capj.args("photon_lnlike", (K8.GAUSS, False))[2]
    cases8 = []
    for mode, key in ((K8.BINNED, "binned"), (K8.GAUSS, "gauss")):
        a_l = capj.args("photon_lnlike", (mode, False))
        a_d = capj.args("photon_lnlike", (mode, True))
        cases8 += [(f"{key} path B={a_l[0].shape[0]} N={a_l[0].shape[1]}",
                    a_l[0], a_l[1], a_l[2], mode),
                   (f"{key} path density {tuple(a_d[0].shape)}", a_d[0],
                    None, a_d[2], mode)]
    for wk, w in (("weights 0/1", w_e), ("no weights", None)):
        cases8.append((f"binned edges, a zero bin, {wk}", frac_e, w,
                       bins_zero, K8.BINNED))
        for tk, tab in (("1 peak sigma 0.005", gtab([[0.005, 0.3, 0.7]])),
                        ("the path's 2 peaks", gauss_path),
                        ("5 peaks sigma 0.005-0.3",
                         gtab([[0.005, 0.1, 0.2], [0.3, 0.5, 0.2],
                               [0.02, 0.62, 0.15], [0.1, 0.8, 0.1],
                               [0.05, 0.95, 0.1]]))):
            cases8.append((f"gauss edges, {tk}, {wk}", frac_e, w, tab,
                           K8.GAUSS))
    ok8, err8 = True, {K8.BINNED: 0.0, K8.GAUSS: 0.0}
    for what, frac8, w8, tab8, mode in cases8:
        same, rel, nan_ok, again, err = k8_check(frac8, w8, tab8, mode)
        err8[mode] = max(err8[mode], err)
        print(f"phase kernel photon_lnlike {what}: density bitwise {same}, "
              f"sums max |d| / sum|terms| {rel:.3e} (<= 1e-12), NaN rows "
              f"alike {nan_ok}, two launches bitwise {again} {tag}",
              flush=True)
        ok8 = ok8 and same and rel <= 1e-12 and nan_ok and again
    if not ok8:
        raise RuntimeError("photon_lnlike disagrees with its plain version")
    # timed on a half-ensemble's rows, 80 of the 82 evaluations of a
    # 128-walker chain: the first 64 of the walkers' first evaluation
    for mode in (K8.BINNED, K8.GAUSS):
        a8 = capj.args("photon_lnlike", (mode, False))
        for density in (False, True):
            kernel = K8.KERNELS[(mode, density)]
            fr8 = a8[0][:a8[0].shape[0] // 2]
            w8, tab8 = (None, capj.args("photon_lnlike", (mode, True))[2]) \
                if density else (a8[1], a8[2])
            B8, N8 = fr8.shape
            npk = (tab8.shape[0] - 1) // 4 if mode == K8.GAUSS else 0
            warm = _time_ms(lambda: K8._launch_terms(fr8, w8, tab8, mode,
                                                     density), 20)
            ms = _time_ms(_rotated(K8._launch_terms, fr8, w8, tab8, mode,
                                   density), 20)
            plain = _time_ms(_rotated(K8.photon_lnlike_reference, fr8, w8,
                                      tab8, mode, density), 3)
            nblk = (N8 + 255) // 256
            nbytes = 8 * B8 * N8 + 8 * tab8.shape[0] + (
                8 * B8 * N8 if density else 8 * N8 + 8 * B8 * nblk)
            ops8 = _k8_ops(mode, density, npk)
            bound = _bound(nbytes, B8 * N8 * ops8, rate=F64_INSTR_PER_S)
            print(f"phase kernel {kernel}: photon_j0030 B={B8} N={N8}"
                  + (f", {npk} peaks" if npk else f", {tab8.shape[0]} bins")
                  + f"; phases from HBM (rotated copies): kernel {ms:.4f} "
                  f"ms, plain {plain:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]}, {ops8} ops/photon; share "
                  f"{bound[0] / ms:.2f}); one copy, L2-resident: kernel "
                  f"{warm:.4f} ms {tag}", flush=True)
            out.append((kernel, "photon_lnlike.cu", K8.REPLACES, err8[mode],
                        ms, plain, bound))
    a8 = capj.args("photon_lnlike", (K8.GAUSS, False))
    parts8 = K8._launch_terms(a8[0][:a8[0].shape[0] // 2], a8[1], a8[2],
                              K8.GAUSS, False)
    rs_k = K8._launch_rowsum(parts8)
    rs_r = torch.sum(parts8, dim=-1)
    rs_err = float((rs_k - rs_r).abs().max())
    rs_rel = float(((rs_k - rs_r).abs() / parts8.abs().sum(-1)).max())
    ms = _time_ms(lambda: K8._launch_rowsum(parts8), 20)
    plain = _time_ms(lambda: torch.sum(parts8, dim=-1), 20)
    Br, nblk = parts8.shape
    bound = _bound(8 * Br * nblk + 8 * Br, Br * nblk, rate=F64_INSTR_PER_S)
    print(f"phase kernel {K8.KERNELS['rowsum']}: photon_j0030 B={Br} "
          f"partials {nblk}; max|d| {rs_err:.3e}, / sum|partials| "
          f"{rs_rel:.3e} (<= 1e-12) against torch.sum; kernel {ms:.4f} ms, "
          f"torch.sum {plain:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]}; "
          f"share {bound[0] / ms:.3f}) {tag}", flush=True)
    if rs_rel > 1e-12:
        raise RuntimeError("photon_lnlike_rowsum disagrees with torch.sum")
    out.append((K8.KERNELS["rowsum"], "photon_lnlike.cu", K8.REPLACES,
                rs_err, ms, plain, bound, plain))
    return out


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


# ---- the stream and serve phases ------------------------------------------
def _reason_class(reason):
    """A fallback reason's class: its first two words (``condition
    proxy``, ``non-finite/non-PD updated``, ``sentinel design``, ``column
    layout``), or None on the rank-k path."""
    return None if reason is None else " ".join(reason.split()[:2])


def _mask(n, idx):
    import numpy as np

    keep = np.zeros(n, dtype=bool)
    keep[idx] = True
    return keep


def _stream_blocks(m, b, meta):
    """(base batch, [append batches]) of a stream snapshot's schedule, the
    append ``dup`` with a copy of its first row."""
    from pint_torch.bridge import stream_schedule
    from pint_torch.toa import merge_TOAs

    base, rows, dup, _ = stream_schedule(meta)
    out = []
    for i, r in enumerate(rows):
        blk = b.select(_mask(b.ntoas, r), m)
        if i == dup:
            blk = merge_TOAs([blk, b.select(_mask(b.ntoas, r[:1]), m)])
        out.append(blk)
    return b.select(_mask(b.ntoas, base), m), out


def _stream_phase(path, kernels, tag):
    """The streaming GLS engine on the j1909_stream stand-in, the counts
    zeroed just before the stream's operations and read just after: the
    base ``GLSFitter.fit_toas(maxiter=2)`` on the first 400 epochs, then
    ``StreamingGLS`` through the 40 single-epoch appends (one with a copy
    of its own row, which the duplicate check pens), the 5-epoch backlog,
    a quarantine of 3 of its rows and their release and one
    ``apply_validation``.  Bars, per operation against the reference's
    (``ref/stream/``): the kind, block, quarantined rows, steps, block id
    and fallback reason class exactly; chi2 1e-6 rel, values 1e-2 sigma,
    uncertainties 1e-6 rel; the final factor within 1e-9 x max|L| of the
    reference's and of a fresh Cholesky of the frame Gram; the stream's
    final values within 1e-2 sigma of the port's scratch
    ``fit_toas(maxiter=4)`` of the final set, and that scratch fit at the
    fit bars against the reference's; ``stream_updates`` cut after half
    the chunks refused on resume where the reference's was (a fallback
    re-froze the frame), and cut before the first fallback resumed
    bitwise the uninterrupted stream.  Printed: p50/p99 wall ms (after
    synchronize) of rank-k appends and of fallbacks apart, appends/s, a
    warm fresh ``fit_toas(maxiter=1)`` of the final set and the speedup,
    K9 launches an append, and ``torch.profiler``'s CUDA kernels and busy
    share over five warm rank-k single-epoch appends of a replay.  Returns
    (counts,
    the capture of K9's calls, stats)."""
    import numpy as np
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.kernels import chol_rank_update as K9
    from pint_torch.runtime.checkpoint import CheckpointError
    from pint_torch.streaming import StreamingGLS, stream_updates
    from pint_torch.streaming import update as up

    meta, ref = read_snapshot(path)
    R = meta["reference"]["stream"]
    S = meta["reference"]["settings"]
    P = "ref/stream/"
    design = R["design"]
    model, batch = load_snapshot(path, device="cuda")
    prefit = model.copy()
    base, blocks = _stream_blocks(model, batch, meta)
    qrows = S["stream"]["quarantine"]

    def fit_base():
        f = GLSFitter(base, prefit)
        f.fit_toas(maxiter=S["fit_maxiter"])
        return f

    torch.cuda.synchronize()
    t = time.perf_counter()
    f = fit_base()
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t
    cap = Capture({"chol_rank_update": kernels.modules()["chol_rank_update"]})
    cap.install()
    kernels.reset_counts()
    eng = StreamingGLS(f)
    ntm = len(eng.cache.params)
    ops, errs, walls, k9 = [], [], [], []

    def run(fn):
        n0 = kernels.launch_counts()[K9.KERNELS[(True, True)]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        k9.append(kernels.launch_counts()[K9.KERNELS[(True, True)]] - n0)
        ops.append(o)
        e = eng.cache.errors()[:ntm]
        errs.append(np.array([x for p, x in zip(eng.cache.params, e)
                              if p != "Offset"]))

    for blk in blocks:
        run(lambda blk=blk: eng.update_toas(blk))
    after = eng.cache.state_dict()
    after_vals = np.array([eng.fitter.model.value(p) for p in design])
    qb = ops[-1].block_id
    run(lambda: eng.quarantine_rows(qb, qrows))
    run(lambda: eng.release_quarantined(qb, qrows))
    nval = len(eng.apply_validation())
    counts = kernels.launch_counts()
    cap.remove()

    bad = []
    for i, (o, e, want) in enumerate(zip(ops, errs, R["ops"])):
        same = (o.kind, o.block, o.quarantined, o.steps, o.block_id) == (
            want["kind"], want["block"], want["quarantined"], want["steps"],
            want["block_id"]) and _reason_class(o.fallback) \
            == _reason_class(want["fallback"])
        vals = np.array([o.params[p] for p in design])
        rv, re = ref[P + "values"][i], ref[P + "errors"][i]
        dchi = abs(o.chi2 / ref[P + "chi2"][i] - 1.0)
        dv = float(np.max(np.abs(vals - rv) / re))
        de = float(np.max(np.abs(e / re - 1.0)))
        if not (same and dchi <= 1e-6 and dv <= 1e-2 and de <= 1e-6):
            bad.append(f"op {i} ({o.kind}): same {same}, chi2 {dchi:.3e}, "
                       f"values {dv:.3e} sigma, errors {de:.3e}")
    gaps = [(abs(o.chi2 / ref[P + "chi2"][i] - 1.0),
             float(np.max(np.abs(np.array([o.params[p] for p in design])
                                 - ref[P + "values"][i])
                          / ref[P + "errors"][i])),
             float(np.max(np.abs(errs[i] / ref[P + "errors"][i] - 1.0))))
            for i, o in enumerate(ops)]
    c = eng.cache
    L = c.L.cpu().numpy()
    Lr = ref[P + "final/L"]
    d_final = float(np.max(np.abs(L - Lr)) / np.max(np.abs(Lr)))
    A = torch.diag(c.phiinv)
    for blk in c.blocks:
        idx = torch.as_tensor(np.flatnonzero(blk.alive), device=c.L.device)
        M, w = blk.M[idx], blk.w[idx]
        A = A + (M.T * w) @ M
    fresh = torch.linalg.cholesky(A).cpu().numpy()
    d_fresh = float(np.max(np.abs(L - fresh)) / np.max(np.abs(fresh)))
    if nval != R["validation_ops"]:
        bad.append(f"apply_validation: {nval} operations, reference "
                   f"{R['validation_ops']}")
    if d_final > 1e-9 or d_fresh > 1e-9:
        bad.append(f"final factor {d_final:.3e} of max|L| from the "
                   f"reference's, {d_fresh:.3e} from a fresh Cholesky")

    # the scratch fit of the final certified set, and the warm refit's time
    final = c.toas.certified()
    sf = GLSFitter(final, prefit)
    sf.fit_toas(maxiter=4)
    sv = np.array([sf.model.value(p) for p in design])
    se = np.array([sf.model[p].uncertainty for p in design])
    stream_v = np.array([eng.fitter.model.value(p) for p in design])
    d_scratch = float(np.max(np.abs(stream_v - sv) / se))
    d_sref = float(np.max(np.abs(sv - ref[P + "scratch_values"])
                          / ref[P + "scratch_errors"]))
    d_seref = float(np.max(np.abs(se / ref[P + "scratch_errors"] - 1.0)))
    rel = {p: abs(stream_v[design.index(p)] / sv[design.index(p)] - 1.0)
           for p in ("F0", "F1")}
    rel_ref = {p: abs(ref[P + "final_values"][design.index(p)]
                      / ref[P + "scratch_values"][design.index(p)] - 1.0)
               for p in ("F0", "F1")}
    if d_scratch > 1e-2 or d_sref > 1e-2 or d_seref > 1e-6:
        bad.append(f"scratch fit: stream {d_scratch:.3e} sigma from it, it "
                   f"{d_sref:.3e} sigma and {d_seref:.3e} rel from the "
                   "reference's")
    refit = GLSFitter(final, eng.fitter.model)
    refit.fit_toas(maxiter=1)
    refit_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refit = GLSFitter(final, eng.fitter.model)
        refit.fit_toas(maxiter=1)
        torch.cuda.synchronize()
        refit_ms.append(1e3 * (time.perf_counter() - t0))

    # stream_updates cut and resumed on a fresh engine
    orig = up._invoke_stream
    ckpt = {}
    tmp = tempfile.TemporaryDirectory()
    for name, want in R["checkpoint"].items():
        d = Path(tmp.name) / name

        def cut(engine, blk, index, at=want["cut"]):
            if index == at:
                raise KeyboardInterrupt
            return orig(engine, blk, index)

        up._invoke_stream = cut
        try:
            stream_updates(StreamingGLS(fit_base()), blocks,
                           checkpoint=str(d))
        except KeyboardInterrupt:
            pass
        finally:
            up._invoke_stream = orig
        e2 = StreamingGLS(fit_base())
        try:
            outs = stream_updates(e2, blocks, checkpoint=str(d))
        except CheckpointError:
            ckpt[name] = dict(cut=want["cut"], refused=True)
        else:
            got = e2.cache.state_dict()
            vals = np.array([e2.fitter.model.value(p) for p in design])
            ckpt[name] = dict(
                cut=want["cut"], refused=False, ran=len(outs),
                bitwise=bool(all(np.array_equal(got[k], after[k])
                                 for k in ("L", "b", "x", "chi2"))
                             and np.array_equal(vals, after_vals)))
        if ckpt[name] != want:
            bad.append(f"checkpoint {name}: {ckpt[name]}, reference {want}")
    tmp.cleanup()

    # five warm rank-k single-epoch appends of a replay under the profiler
    fb = [o["fallback"] is not None for o in R["ops"][:len(blocks)]]
    epochs = S["stream"]["blocks"]
    chosen = [i for i in range(1, len(blocks)) if not fb[i]
              and epochs[i] == epochs[0] and i != S["stream"]["dup"]][:5]
    e3 = StreamingGLS(fit_base())
    n_ev = us = wall = 0
    for i, blk in enumerate(blocks[:chosen[-1] + 1]):
        if i not in chosen:
            e3.update_toas(blk)
            continue
        n, u, w = _profile_cuda(lambda blk=blk: e3.update_toas(blk))
        n_ev, us, wall = (None, None, wall + w) if n is None or n_ev is None \
            else (n_ev + n, us + u, wall + w)

    n_app = len(blocks)
    rk = [walls[i] for i in range(n_app) if ops[i].fallback is None]
    fbw = [walls[i] for i in range(n_app) if ops[i].fallback is not None]
    stats = dict(
        K=c.K, base_s=base_s, rankk_p50=float(np.percentile(rk, 50)),
        rankk_p99=float(np.percentile(rk, 99)),
        fallback_p50=float(np.percentile(fbw, 50)) if fbw else None,
        fallback_p99=float(np.percentile(fbw, 99)) if fbw else None,
        appends_per_s=n_app / (sum(walls[:n_app]) / 1e3),
        refit_p50=float(np.percentile(refit_ms, 50)),
        n_rankk=len(rk), n_fallback=len(fbw),
        k9_per_append=sorted(set(k9[:n_app])),
        k9_rankk=sorted({k9[i] for i in range(n_app)
                         if ops[i].fallback is None}),
        k9_fallback=sorted({k9[i] for i in range(n_app)
                            if ops[i].fallback is not None}),
        downdate_ms=walls[n_app], release_ms=walls[n_app + 1])
    stats["speedup"] = stats["refit_p50"] / stats["rankk_p50"]
    busy = f"{n_ev} CUDA kernels, {us / 1e3:.4f} ms device in " \
        f"{wall * 1e3:.4f} ms wall, busy {us / 1e6 / wall:.4f}" \
        if n_ev else f"{wall * 1e3:.4f} ms wall, device time not measured " \
        "(the profiler saw no device events)"
    print(f"phase stream j1909_stream: K = {c.K} frame columns, "
          f"{len(ops)} operations ({n_app} appends: {len(rk)} rank-k, "
          f"{len(fbw)} refactors; a quarantine, a release), "
          f"apply_validation {nval}; base fit {base_s:.4f} s; chi2 max "
          f"{max(g[0] for g in gaps):.3e} rel, values max "
          f"{max(g[1] for g in gaps):.3e} sigma, uncertainties max "
          f"{max(g[2] for g in gaps):.3e} rel; final factor "
          f"{d_final:.3e} of max|L| from the reference's, {d_fresh:.3e} "
          f"from a fresh Cholesky; scratch fit: stream {d_scratch:.3e} "
          f"sigma from it (F0 {rel['F0']:.3e}, F1 {rel['F1']:.3e} rel; "
          f"the reference's F0 {rel_ref['F0']:.3e}, F1 {rel_ref['F1']:.3e}),"
          f" it {d_sref:.3e} sigma / {d_seref:.3e} rel from the "
          f"reference's; checkpoint {ckpt} {tag}", flush=True)
    print(f"phase stream times: rank-k append p50 {stats['rankk_p50']:.4f} "
          f"ms, p99 {stats['rankk_p99']:.4f} ms ({len(rk)}); refactor "
          f"p50 {stats['fallback_p50']:.4f} ms, p99 "
          f"{stats['fallback_p99']:.4f} ms ({len(fbw)}); quarantine "
          f"{stats['downdate_ms']:.4f} ms, release {stats['release_ms']:.4f}"
          f" ms; {stats['appends_per_s']:.3f} appends/s; warm refit "
          f"fit_toas(maxiter=1) of the {final.ntoas} TOAs p50 "
          f"{stats['refit_p50']:.4f} ms (3), speedup "
          f"{stats['speedup']:.3f}; K9 launches an append: rank-k "
          f"{stats['k9_rankk']}, refactor {stats['k9_fallback']}; "
          f"{len(chosen)} warm rank-k appends under torch.profiler: {busy} "
          f"{tag}", flush=True)
    if bad:
        raise RuntimeError("stream phase: " + "; ".join(bad))
    return counts, cap, stats


def _serve_phase(path, small_path, kernels, tag):
    """The shape-bucketed serve batcher on the card, the counts zeroed
    just before the requests are built and read after the last dispatch:
    ``FitRequest.from_fitter`` on j1909_stream's base-fit state (the
    reference's values) at 3600, 3690, 3780 and 4005 TOAs and
    small_stream's at 40, 56 and 64 -- two buckets, (4096, 512) and (64,
    32), the second with a padded batch lane --, then
    ``ShapeBatcher.run`` and ``serve_fused(steps=3, reweight="huber")``
    per bucket group.  Bars: each request's residuals within 1e-10 s of
    the reference's; served on the reference's residuals (the same
    inputs), the same bucket and batch, ``dx`` within 1e-6 of each
    column's error, errors, chi2 and chi2_initial within 1e-9 rel, the
    fused steps alike; each request padded equal to its dedicated shape to
    1e-9 rel.  Printed: the warm dispatch's ms and requests/s.  Returns
    the counts."""
    import numpy as np
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.serving import (FitRequest, ShapeBatcher, bucket_of,
                                    pad_request, serve_fused, serve_kernel)

    meta, ref = read_snapshot(path)
    R = meta["reference"]["serve"]
    loaded = {"stream": load_snapshot(path, device="cuda"),
              "small_stream": load_snapshot(small_path, device="cuda")}
    for which, (m, _) in loaded.items():
        for p, v in zip(m.design_param_names(),
                        ref[f"ref/serve/{which}_values"]):
            m[p].value = float(v)
    kernels.reset_counts()
    reqs, bad = [], []
    d_r = 0.0
    for i, (which, n) in enumerate(R["requests"]):
        m, b = loaded[which]
        q = FitRequest.from_fitter(
            GLSFitter(b.select(np.arange(b.ntoas) < n, m), m),
            request_id=f"{which}:{n}")
        rr = ref[f"ref/serve/{i}/r"]
        d_r = max(d_r, float(np.max(np.abs(q.r.cpu().numpy() - rr))))
        reqs.append(FitRequest(M=q.M, r=rr, w=q.w, phiinv=q.phiinv,
                               params=q.params, norm=q.norm,
                               request_id=q.request_id, device="cuda"))
    sb = ShapeBatcher()
    res = sb.run(reqs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = sb.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    gap = dict(dx=0.0, err=0.0, chi2=0.0, pad=0.0, fdx=0.0, ferr=0.0,
               fchi2=0.0)
    for i, (q, r) in enumerate(zip(reqs, res)):
        Q = f"ref/serve/{i}/"
        if list(r.bucket) != R["buckets"][i] or r.batch != R["batches"][i]:
            bad.append(f"request {i}: bucket {r.bucket} batch {r.batch}")
        e = ref[Q + "errors"]
        gap["dx"] = max(gap["dx"], float(np.max(np.abs(r.dx - ref[Q + "dx"])
                                                / e)))
        gap["err"] = max(gap["err"], float(np.max(np.abs(r.errors / e - 1))))
        c2 = np.array([r.chi2, r.chi2_initial])
        gap["chi2"] = max(gap["chi2"], float(np.max(np.abs(
            c2 / ref[Q + "chi2"] - 1))))
        n, k = q.M.shape
        ded = serve_kernel(*pad_request(q, n, k))
        dd = [x.cpu().numpy() for x in ded]
        gap["pad"] = max(gap["pad"], float(np.max(np.abs(r.dx - dd[0])
                                                  / np.abs(dd[1]))),
                         float(np.max(np.abs(r.errors / dd[1] - 1))),
                         abs(r.chi2 / float(dd[2]) - 1),
                         abs(r.chi2_initial / float(dd[3]) - 1))
    for bucket, idxs in R["groups"]:
        batch = bucket_of(len(idxs), sb.batch_buckets)
        padded = [pad_request(reqs[i], *bucket) for i in idxs]
        padded += [padded[0]] * (batch - len(padded))
        ops = tuple(torch.stack([p[j] for p in padded]) for j in range(5))
        dx, err, chi2, chi2_0 = (x.cpu().numpy() for x in serve_fused(
            steps=R["steps"], reweight=R["reweight"])(*ops))
        for lane, i in enumerate(idxs):
            Q, k = f"ref/serve/{i}/", reqs[i].n_free
            e = ref[Q + "fused_errors"]
            gap["fdx"] = max(gap["fdx"], float(np.max(
                np.abs(dx[lane, :, :k] - ref[Q + "fused_dx"]) / e)))
            gap["ferr"] = max(gap["ferr"], float(np.max(
                np.abs(err[lane, :k] / e - 1))))
            gap["fchi2"] = max(gap["fchi2"], float(np.max(np.abs(
                np.append(chi2[lane], chi2_0[lane])
                / ref[Q + "fused_chi2"] - 1))))
    ok = d_r <= 1e-10 and gap["dx"] <= 1e-6 and gap["fdx"] <= 1e-6 \
        and max(gap["err"], gap["chi2"], gap["pad"], gap["ferr"],
                gap["fchi2"]) <= 1e-9
    print(f"phase serve: {len(reqs)} requests, buckets "
          f"{sorted({tuple(r.bucket) for r in res})}, batches "
          f"{[r.batch for r in res]}; residuals max {d_r:.3e} s from the "
          f"reference's; dx max {gap['dx']:.3e} of the column's error, "
          f"errors {gap['err']:.3e}, chi2 {gap['chi2']:.3e} rel; padded "
          f"against dedicated {gap['pad']:.3e}; serve_fused(steps=3, huber)"
          f" dx {gap['fdx']:.3e} of the error, errors {gap['ferr']:.3e}, "
          f"chi2 {gap['fchi2']:.3e} rel; warm ShapeBatcher.run "
          f"{wall * 1e3:.4f} ms, {len(reqs) / wall:.3f} requests/s {tag}",
          flush=True)
    if bad or not ok:
        raise RuntimeError("serve phase: " + "; ".join(bad) + f" {gap}")
    return counts


def _k9_ops(K: int, rows: int, k: int, ingest: bool) -> int:
    """float64 instructions of one K9 call on ``rows`` nonzero rows of a
    rung of ``k`` (a zero row is skipped), a sqrt and a division at their
    SASS counts and every other operation 1: per row and column step j the
    owner's d d + s xj xj, sqrt and two divisions (3 + 8 + 16), and per row
    below it sign s x, a sum, a division, c x - s col (4 + 8 ... 13); with
    the ingest r_now (2 k K), V = sqrt(w) M (rows' sqrt and K products), b'
    (3 k K + 2 K), chi2 (3 k + 2); the final check 2 K^2."""
    dv, sq = SASS_OPS["div"], SASS_OPS["sqrt"]
    sweep = rows * (K * (3 + sq + 2 * dv) + (5 + dv) * K * (K - 1) // 2)
    extra = (2 * k * K + rows * (sq + K) + 3 * k * K + 2 * K + 3 * k + 2) \
        if ingest else 0
    return sweep + extra + 2 * K * K


def _k9_kernels(cap, counts, dev, tag) -> list:
    """K9 against its plain version on the card: ``stream_ingest`` on the
    stream path's calls (k = 16 appends, the k = 64 backlog, the k = 4
    quarantine downdate and release), ``chol_rank_update`` on the path's
    factor with its weighted rows, and both on random SPD factors at K =
    23 (shared memory) and 233 (global), each sign, with zero rows
    interleaved and a downdate of absent rows.  Bars: the factor bitwise
    (NaN where the plain version's is), b' and chi2' within 1e-13 of
    their sums of |terms|, ok and cond equal, a zero row a bitwise no-op.
    Times (CUDA events behind a spin kernel): each instantiation on one
    call (the path's k = 16 append for the shared-memory ones, K = 233, k
    = 16 for the global ones), its plain version, the library yardstick
    ``torch.linalg.cholesky_ex`` of the updated Gram (formed outside the
    timed window) and the bound; the chain of dependent steps (each
    wavefront pass of n rows n + K - 1) and the us a step printed.
    Returns the ``kernels`` records."""
    import torch

    from pint_torch.kernels import chol_rank_update as K9

    gen = torch.Generator(device=dev).manual_seed(20261018)
    notes, ok, records, errs = [], True, [], {}

    def spd(K):
        A = torch.randn((K + 9, K), generator=gen, dtype=torch.float64,
                        device=dev)
        # row-major, as the wrappers hand K9 its factor (torch's Cholesky
        # may return the transposed layout)
        return torch.linalg.cholesky(A.T @ A + torch.eye(
            K, dtype=torch.float64, device=dev)).contiguous()

    def same(a, b):
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(
            torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))

    def ingest_check(label, L, b, chi2, M, r, w, dx, sign):
        nonlocal ok
        got = K9._launch(L, M, sign, (b, chi2, r, w, dx))
        want = K9.stream_ingest_reference(L, b, chi2, M, r, w, dx, sign)
        rnow = r - M @ dx
        bt = b.abs() + M.abs().T @ (w * rnow).abs()
        ct = chi2.abs() + (w * rnow * rnow).abs().sum()
        fl = same(got[0], want[0])
        db = float(((got[1] - want[1]).abs() / bt.clamp(min=1e-300)).max())
        dc = float((got[2] - want[2]).abs() / ct.clamp(min=1e-300))
        oc = float(got[3]) == float(want[3]) and (
            same(got[4].reshape(1), want[4].reshape(1)))
        fine = fl and db <= 1e-13 and dc <= 1e-13 and oc
        ok = ok and fine
        errs[label] = float((got[0] - want[0]).abs().nan_to_num().max())
        notes.append(f"{label}: factor {'bitwise' if fl else 'DIFFERS'}, "
                     f"b' {db:.1e}, chi2' {dc:.1e} of |terms|, ok/cond "
                     f"{'equal' if oc else 'DIFFER'}")
        return got

    def rank_check(label, L, V, sign):
        nonlocal ok
        got, want = K9._launch(L, V, sign), K9.chol_rank_update_reference(
            L, V, sign)
        fl = same(got, want)
        ok = ok and fl
        errs[label] = float((got - want).abs().nan_to_num().max())
        notes.append(f"{label}: factor {'bitwise' if fl else 'DIFFERS'}")
        return got

    # the path's calls
    calls = sorted((key, args) for key, (_, args) in cap.calls.items()
                   if key[0] == "chol_rank_update" and key[1][0])
    path16 = None
    for (_, (ingest, k, sign)), args in calls:
        L, M, sgn, vecs = args
        ingest_check(f"path stream_ingest k={k} sign {sgn:+.0f}", L,
                     *vecs[:2], M, *vecs[2:], sgn)
        if k == 16 and sgn > 0:
            path16 = args
    if path16 is None:
        raise RuntimeError("no k = 16 append reached K9 on the stream path")
    L16, M16, _, v16 = path16
    b16, c16, r16, w16, dx16 = v16
    V16 = torch.sqrt(w16)[:, None] * M16
    rank_check("path chol_rank_update k=16 +1", L16, V16, 1.0)
    # random factors: both layouts, each sign, zero rows, absent rows
    for K in (23, 233):
        L = spd(K)
        V = torch.randn((16, K), generator=gen, dtype=torch.float64,
                        device=dev)
        V[[2, 5, 9, 10, 15]] = 0.0
        up = rank_check(f"K={K} update", L, V, 1.0)
        rank_check(f"K={K} downdate", up, V, -1.0)
        z = K9._launch(L, torch.zeros((4, K), dtype=torch.float64,
                                      device=dev), -1.0)
        zero = bool(torch.equal(z, L))
        ok = ok and zero
        notes.append(f"K={K} zero rows: {'bitwise no-op' if zero else 'NOT'}")
        rank_check(f"K={K} absent downdate", L, 30.0 * V, -1.0)
        r = torch.randn(16, generator=gen, dtype=torch.float64, device=dev)
        w = torch.rand(16, generator=gen, dtype=torch.float64,
                       device=dev) + 0.5
        w[[2, 5, 9, 10, 15]] = 0.0
        dx = 1e-3 * torch.randn(K, generator=gen, dtype=torch.float64,
                                device=dev)
        b = torch.randn(K, generator=gen, dtype=torch.float64, device=dev)
        c2 = torch.tensor(7.0, dtype=torch.float64, device=dev)
        for sign in (1.0, -1.0):
            g = ingest_check(f"K={K} stream_ingest sign {sign:+.0f}", L, b,
                             c2, V if sign > 0 else 30.0 * V, r, w, dx, sign)
        ok = ok and not bool(g[3])  # the absent downdate is refused
    print("phase kernel chol_rank_update: " + "; ".join(notes) + f" {tag}",
          flush=True)
    if not ok:
        raise RuntimeError("chol_rank_update disagrees with its plain "
                           "version")

    def timed(kernel, L, M, sign, vecs, label, path_launches):
        K, k = L.shape[0], M.shape[0]
        ingest = vecs is not None
        Vw = torch.sqrt(vecs[3])[:, None] * M if ingest else M
        rows = int((Vw != 0).any(dim=1).sum())
        if ingest:
            ms = _time_ms(lambda: K9._launch(L, M, sign, vecs), 20)
            plain = _time_ms(lambda: K9.stream_ingest_reference(
                L, vecs[0], vecs[1], M, vecs[2], vecs[3], vecs[4], sign), 1,
                warmup=1)
        else:
            ms = _time_ms(lambda: K9._launch(L, M, sign), 20)
            plain = _time_ms(lambda: K9.chol_rank_update_reference(
                L, M, sign), 1, warmup=1)
        G = L @ L.T + sign * (Vw.T @ Vw)
        lib = _time_ms(lambda: torch.linalg.cholesky_ex(G), 20)
        nbytes = 8 * (2 * K * K + k * K + 2) + (
            8 * (2 * k + 3 * K + 2) if ingest else 0)
        bound = _bound(nbytes, _k9_ops(K, rows, k, ingest),
                       rate=F64_INSTR_PER_S)
        chain = K9.chain_steps(K, rows)
        print(f"phase kernel {kernel} {label}: K={K} k={k} ({rows} nonzero "
              f"rows), {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"torch.linalg.cholesky_ex of the updated Gram {lib:.4f} ms, "
              f"bound {bound[0]:.6f} ms ({bound[1]}; "
              f"{_k9_ops(K, rows, k, ingest)} float64 instructions), chain "
              f"{chain} dependent steps (wavefront passes of "
              f"{K9.pass_rows(K)} rows; {rows * K} row by row), "
              f"{1e3 * ms / max(chain, 1):.3f} us a step {tag}", flush=True)
        return dict(name=kernel, route="cuda",
                    source="pint_torch/kernels/csrc/chol_rank_update.cu",
                    replaces=K9.REPLACES if not ingest else
                    "pint_tpu/streaming/lowrank.py:115",
                    launches=path_launches, max_abs_err=max(
                        v for key, v in errs.items()
                        if (("stream_ingest" in key) == ingest)
                        and ((K == 233) == ("K=233" in key))),
                    ms=ms, plain_ms=plain, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=lib, path="stream")

    for (_, (ingest, k, sign)), args in calls:
        if (k, sign) != (16, 1.0):
            L, M, sgn, vecs = args
            timed(K9.KERNELS[(K9.uses_smem(L.shape[0]), True)], L, M, sgn,
                  vecs, f"path k={k} sign {sgn:+.0f}", None)
    records.append(timed(K9.KERNELS[(True, True)], L16, M16, 1.0, v16,
                         "path k=16 append",
                         counts[K9.KERNELS[(True, True)]]))
    records.append(timed(K9.KERNELS[(True, False)], L16, V16, 1.0, None,
                         "path factor, k=16",
                         counts[K9.KERNELS[(True, False)]]))
    L = spd(233)
    V = torch.randn((16, 233), generator=gen, dtype=torch.float64, device=dev)
    r = torch.randn(16, generator=gen, dtype=torch.float64, device=dev)
    w = torch.rand(16, generator=gen, dtype=torch.float64, device=dev) + 0.5
    vecs = (torch.randn(233, generator=gen, dtype=torch.float64, device=dev),
            torch.tensor(7.0, dtype=torch.float64, device=dev), r, w,
            1e-3 * torch.randn(233, generator=gen, dtype=torch.float64,
                               device=dev))
    records.append(timed(K9.KERNELS[(False, True)], L, V, 1.0, vecs,
                         "random", counts[K9.KERNELS[(False, True)]]))
    records.append(timed(K9.KERNELS[(False, False)], L, V, 1.0, None,
                         "random", counts[K9.KERNELS[(False, False)]]))
    return records


CATALOG_LNLIKE_REPS = 8
#: the joint likelihood's bar: 1e-9 x max(1, |reference|)
LNLIKE_BAR = 1e-9


def _catalog_on(reqs, r_concat):
    """The catalogue requests ``reqs`` with the residuals ``r_concat``
    (concatenated over the members, as the snapshot stores the
    reference's) in place of their own."""
    import numpy as np

    from pint_torch.serving import FitRequest

    parts = np.split(np.asarray(r_concat),
                     np.cumsum([q.n_toas for q in reqs])[:-1])
    return [FitRequest(M=q.M, r=x, w=q.w, phiinv=q.phiinv, params=q.params,
                       norm=q.norm, request_id=q.request_id,
                       device=q.M.device) for q, x in zip(reqs, parts)]


def _catalog_lanes(cf, reqs, fn):
    """Each member's outputs of ``fn`` over the fitter's bucket groups."""
    outs = [None] * len(reqs)
    for bucket, idx in sorted(cf.bucket_plan.buckets.items()):
        o = [x.cpu().numpy() for x in fn(*cf._group_operands(
            bucket, [reqs[i] for i in idx]))]
        for j, i in enumerate(idx):
            outs[i] = [x[j] for x in o]
    return outs


def _catalog_phase(path, kernels, tag):
    """The PTA catalogue on the card, the counts zeroed just before the
    snapshot is loaded and read after the chain: ``load_catalog_snapshot``
    (each member's raw TOAs), ``ingest_catalog`` (lenient gate),
    ``CatalogFitter`` with 1 settle and 4 timed ``fit(maxiter=1)`` passes,
    ``refine(steps=8)``, ``JointLikelihood(n_modes)``, ``lnlike_batch`` at
    the bench's 32 points (1 warm-up, 8 timed repetitions) and at every
    stored point, and the seeded ``EnsembleSampler`` chain on
    ``lnlike_batch`` from the stored walkers.  Bars (``ref/catalog/``):
    certified rows, quarantined rows and codes, excluded members; ladders,
    each member's bucket and the padding waste, all exactly; each pass's
    residuals within 1e-10 s of the reference's and, served on the
    reference's residuals (the same inputs: the reference's jitted
    residuals round ~1e-13 s apart from its eager arithmetic, which the
    port follows -- ~1e-8 of these chi2), each batched step within 1e-6 of
    its error, errors, chi2 and the initial chi2 within 1e-9 rel; the
    applied steps within 1e-6 sigma, errors 1e-9 rel, the post-fit chi2 of
    the port's own residuals 1e-6 rel; the values after the passes within
    1e-6 sigma; the refine on the reference's residuals (chi2 trajectories
    1e-9 rel, first steps 1e-6 sigma) and the port's own (1e-6); the joint
    likelihood on the reference's residuals: each per-pulsar value 1e-9
    rel, at every point 1e-9 x max(1, |ref|), the cross term 1e-8 x max(1,
    |ref cross|); on both, at zero amplitude the cross term exactly 0.0 and
    the joint value the per-pulsar sum to 1e-12 rel; the port's own joint
    values at the 1e-9 bar; the chain at PR 12's chain bars with that bar
    as each point's.  Printed: the bench block's quantities
    (``catalog_fits_per_s``, ``joint_lnlike_per_s``, ``pad_waste_frac``,
    buckets), each stage's wall s, chain steps/s and the peak device
    memory.  Returns (counts, the main path's joint likelihood, the bench
    points)."""
    import numpy as np
    import torch

    from pint_torch.bridge import load_catalog_snapshot, read_snapshot
    from pint_torch.catalog import (CatalogFitter, JointLikelihood,
                                    catalog_batched, catalog_fused,
                                    ingest_catalog)
    from pint_torch.kernels import hd_cross_lnlike as K10
    from pint_torch.sampler import EnsembleSampler

    meta, ref = read_snapshot(path)
    R, S = meta["reference"]["catalog"], meta["reference"]["settings"]
    P = "ref/catalog/"
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        return out

    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    pairs = timed("load", lambda: load_catalog_snapshot(path, device="cuda"))
    report = timed("ingest", lambda: ingest_catalog(pairs))
    cf = timed("fitter", lambda: CatalogFitter(report))
    taken = []
    orig = cf._requests
    cf._requests = lambda: taken.append(orig()) or taken[-1]
    passes = S["fit_passes"]
    fits = [timed("settle", lambda: cf.fit(maxiter=1))]
    fits += timed("fit", lambda: [cf.fit(maxiter=1)
                                  for _ in range(passes - 1)])
    rf = timed("refine", lambda: cf.refine(steps=S["refine_steps"]))
    cf._requests = orig
    jl = timed("joint", lambda: JointLikelihood(cf, n_modes=S["n_modes"]))
    pts = ref[P + "likelihood/points"]
    bench = pts[:S["bench_points"]]
    jl.lnlike_batch(bench)
    timed("lnlike", lambda: [jl.lnlike_batch(bench)
                             for _ in range(CATALOG_LNLIKE_REPS)])
    own = timed("points", lambda: jl.lnlike_batch(pts))
    own_nc = jl.lnlike_nocommon()
    s = EnsembleSampler(S["walkers"], seed=S["seeds"]["sampler"])
    s.decision_log = []
    s.initialize_batched(jl.lnlike_batch, 2)
    timed("chain", lambda: s.run_mcmc(ref[P + "chain/pos"].copy(),
                                      S["chain_steps"]))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # K10's share of that peak: the factor and pivots of the widest chunk
    # (the 48 stored points), as the wrapper allocates them
    R_k10 = jl.G.shape[0]
    k10_ws = 8 * K10.walkers_per_chunk(len(pts), R_k10) * (
        R_k10 * (R_k10 + 1) + R_k10)

    bad, gap = [], {}
    # the gate and the buckets, exactly
    I = R["ingest"]
    if report.to_dict() != {k: v for k, v in I.items()
                            if k not in ("members", "quarantined_rows")}:
        bad.append(f"ingest report {report.to_dict()}")
    if [dict(name=p.name, n_toas=p.n_toas, n_quarantined=p.n_quarantined,
             codes=list(p.quarantine_codes))
            for p in report.pulsars] != I["members"]:
        bad.append("ingest members")
    rows = [[] if b.quarantine_mask is None else
            [int(i) for i in np.flatnonzero(b.quarantine_mask)]
            for _, b in pairs]
    if rows != I["quarantined_rows"]:
        bad.append(f"quarantined rows {rows}")
    B = R["buckets"]
    bp = cf.bucket_plan
    if [list(x) for x in cf.shapes] != B["shapes"] \
            or list(bp.ntoa_ladder) != B["ntoa_ladder"] \
            or list(bp.nfree_ladder) != B["nfree_ladder"] \
            or {f"{bn}x{bk}": idx for (bn, bk), idx
                in bp.buckets.items()} != B["members"] \
            or bp.pad_waste_frac != B["pad_waste_frac"]:
        bad.append(f"buckets {bp.to_dict()}")
    # each pass: the port's residuals, then the batched call on the
    # reference's residuals, then the applied fit
    design = R["design"]
    for k in range(passes):
        Q = f"{P}pass{k}/"
        reqs, fit = taken[k], fits[k]
        r_own = np.concatenate([q.r.cpu().numpy() for q in reqs])
        gap["r"] = max(gap.get("r", 0.0),
                       float(np.max(np.abs(r_own - ref[Q + "r"]))))
        outs = _catalog_lanes(cf, _catalog_on(reqs, ref[Q + "r"]),
                              catalog_batched())
        dx = np.concatenate([o[0][:len(q.params)]
                             for o, q in zip(outs, reqs)])
        er = np.concatenate([o[1][:len(q.params)]
                             for o, q in zip(outs, reqs)])
        e = ref[Q + "lin_err"]
        for key, v in (
                ("dx", np.abs(dx - ref[Q + "lin_dx"]) / e),
                ("err", np.abs(er / e - 1)),
                ("chi2", np.abs(np.array([o[2] for o in outs])
                                / ref[Q + "lin_chi2"] - 1)),
                ("chi2_initial", np.abs(np.array([o[3] for o in outs])
                                        / ref[Q + "chi2_initial"] - 1)),
                ("fit_err", np.abs(np.concatenate(
                    [[f.errors[n] for n in f.errors] for f in fit.fits])
                    / ref[Q + "errors"] - 1)),
                ("fit_dx", np.abs(np.concatenate(
                    [[f.dpars[n] for n in f.dpars] for f in fit.fits])
                    - ref[Q + "dpars"]) / ref[Q + "errors"]),
                ("fit_chi2", np.abs(np.array([f.chi2 for f in fit.fits])
                                    / ref[Q + "chi2"] - 1))):
            gap[key] = max(gap.get(key, 0.0), float(np.max(v)))
        if [list(f.bucket) for f in fit.fits] != R["passes"][k]["buckets"]:
            bad.append(f"pass {k} buckets")
    last = f"{P}pass{passes - 1}/"
    vals = np.concatenate([[p.fitted_model[n].value for n in d]
                           for p, d in zip(report.pulsars, design)])
    sig = np.concatenate([[f.errors[n] for n in d]
                          for f, d in zip(fits[-1].fits, design)])
    gap["values"] = float(np.max(np.abs(vals - ref[last + "values"]) / sig))
    # the refine, on the reference's residuals and on the port's own
    reqs = taken[-1]
    same = _catalog_on(reqs, ref[P + "final_r"])
    outs = _catalog_lanes(cf, same, catalog_fused(steps=S["refine_steps"]))
    e = ref[last + "errors"]
    gap["refine_chi2"] = float(np.max(np.abs(np.stack(
        [o[2] for o in outs]) / ref[P + "refine/chi2_steps"] - 1)))
    gap["refine_dx"] = float(np.max(np.abs(np.concatenate(
        [o[0][0][:len(q.params)] / q.norm[:len(q.params)]
         for o, q in zip(outs, reqs)]) - ref[P + "refine/dpars_first"]) / e))
    names = [p.name for p in report.pulsars]
    gap["refine_own_chi2"] = float(np.max(np.abs(np.stack(
        [rf.chi2_steps[n] for n in names]) / ref[P + "refine/chi2_steps"]
        - 1)))
    gap["refine_own_dx"] = float(np.max(np.abs(np.concatenate(
        [[rf.dpars_first[n][x] for x in rf.dpars_first[n]] for n in names])
        - ref[P + "refine/dpars_first"]) / e))
    if rf.dispatches != R["refine"]["dispatches"]:
        bad.append(f"refine dispatches {rf.dispatches}")
    # the joint likelihood on the reference's residuals, and the pin
    js = JointLikelihood(cf, n_modes=S["n_modes"], requests=same)
    L = R["likelihood"]
    want = ref[P + "likelihood/lnlike"]
    want_cross = want - L["nocommon"]
    gap["per_pulsar"] = float(np.max(np.abs(
        js.per_pulsar_lnlike() / ref[P + "likelihood/per_pulsar"] - 1)))
    got = js.lnlike_batch(pts)
    gap["lnlike"] = float(np.max(np.abs(got - want)
                                 / np.maximum(1, np.abs(want))))
    gap["cross"] = float(np.max(np.abs((got - js.lnlike_nocommon())
                                       - want_cross)
                                / np.maximum(1, np.abs(want_cross))))
    gap["own_lnlike"] = float(np.max(np.abs(own - want)
                                     / np.maximum(1, np.abs(want))))
    gap["own_cross"] = float(np.max(np.abs((own - own_nc) - want_cross)
                                    / np.maximum(1, np.abs(want_cross))))
    for name, j in (("own", jl), ("same", js)):
        c0 = j.cross_batch(np.array([[-np.inf, 4.33]])).cpu().numpy()
        parts = j.per_pulsar_lnlike()
        pin = abs(j.lnlike_nocommon() - parts.sum()) / abs(parts.sum())
        gap[f"pin_{name}"] = pin
        if c0[0] != 0.0 or pin > 1e-12:
            bad.append(f"factorization pin ({name}): cross {c0[0]!r}, "
                       f"{pin:.3e} rel")
    if (jl.pad_shape != tuple(L["pad_shape"]) or jl.Tspan != L["Tspan"]
            or np.max(np.abs(jl.Lhd - ref[P + "likelihood/Lhd"])) > 1e-12):
        bad.append("pad shape, Tspan or the HD factor")
    # the chain: PR 12's chain bars, each point's bar the joint one
    stored = {k: ref[P + "chain/" + k] for k in ("walker_chain", "lnprob",
                                               "accepted", "pos")}
    lp0 = jl.lnlike_batch(stored["pos"])

    def bars(k):
        lp = lp0 if k == 0 else s.decision_log[k - 1][1]
        with np.errstate(invalid="ignore"):
            return LNLIKE_BAR * np.maximum(1.0, np.abs(lp))

    def final(out, hist):
        if out["inside"]:
            return
        lp = s.get_log_prob()
        rel = float(np.max(np.abs(lp - stored["lnprob"])
                           / np.maximum(1.0, np.abs(stored["lnprob"]))))
        if rel > LNLIKE_BAR or s.naccepted != R["chain"]["naccepted"]:
            raise RuntimeError("catalogue chain: lnprob or acceptance "
                               "differ from the reference's")
        out.update(lnprob_rel=rel)

    chain = _chain_bars(types.SimpleNamespace(sampler=s),
                        stored["walker_chain"].transpose(2, 0, 1),
                        stored["accepted"], bars,
                        lambda bp, bc: 2.0 * np.maximum(bp, bc), final)
    n = report.n_pulsars
    fits_per_s = n * (passes - 1) / walls["fit"]
    lnl_per_s = len(bench) * CATALOG_LNLIKE_REPS / walls["lnlike"]
    steps_per_s = S["chain_steps"] / walls["chain"]
    print(f"phase catalog: {n} pulsars, {report.n_toas} certified TOAs, "
          f"{report.n_quarantined} quarantined ({', '.join(report.codes())}"
          f"), R = {jl.G.shape[0]} ({S['n_modes']} modes); buckets "
          f"{bp.n_buckets} ({bp.to_dict()['buckets']}), pad_waste_frac "
          f"{bp.pad_waste_frac}; catalog_fits_per_s {fits_per_s} "
          f"(4 passes {walls['fit']} s, settle {walls['settle']} s), "
          f"joint_lnlike_per_s {lnl_per_s} ({CATALOG_LNLIKE_REPS} x "
          f"{len(bench)} points {walls['lnlike']} s), chain "
          f"{S['walkers']} x {S['chain_steps']} {walls['chain']} s "
          f"({steps_per_s} steps/s; bitwise steps {chain['bitwise_steps']}, "
          f"decisions inside the margin {chain['inside']}, diverged "
          f"{chain['diverged']}); walls load {walls['load']} s, ingest "
          f"{walls['ingest']} s, fitter {walls['fitter']} s, refine "
          f"{walls['refine']} s, joint {walls['joint']} s, {len(pts)} "
          f"points {walls['points']} s; max_memory_allocated "
          f"{peak / 2**20:.2f} MiB, of it K10's workspace at the "
          f"{len(pts)} stored points {k10_ws / 2**20:.2f} MiB (cap "
          f"{K10.WORKSPACE_CAP_BYTES / 2**20:.0f} MiB); K10 launches "
          + ", ".join(f"{k} {counts[k]}" for k in K10.KERNELS.values())
          + f" {tag}", flush=True)
    print("phase catalog bars: " + ", ".join(
        f"{k} {v:.3e}" for k, v in gap.items()) + f" {tag}", flush=True)
    ok = (gap["r"] <= 1e-10 and gap["dx"] <= 1e-6 and gap["fit_dx"] <= 1e-6
          and max(gap["err"], gap["chi2"], gap["chi2_initial"],
                  gap["fit_err"]) <= 1e-9 and gap["fit_chi2"] <= 1e-6
          and gap["values"] <= 1e-6 and gap["refine_chi2"] <= 1e-9
          and max(gap["refine_dx"], gap["refine_own_dx"],
                  gap["refine_own_chi2"]) <= 1e-6
          and gap["per_pulsar"] <= 1e-9
          and max(gap["lnlike"], gap["own_lnlike"]) <= LNLIKE_BAR
          and gap["cross"] <= 1e-8)
    if bad or not ok:
        raise RuntimeError("catalog phase: " + "; ".join(bad) + f" {gap}")
    return counts, jl, bench, pts


def _k10_ops(R: int, m: int, products: bool = True) -> int:
    """float64 instructions of K10 for one walker: the spectrum (m exp,
    two more exp and a log a mode, sqrt), then per column j the R + 1 - j
    rows' M entry (3) and j products and differences each, the pivot's sqrt
    and log, the R - j divisions and z^2's product and sum (a sqrt, exp,
    log and division at their SASS counts); without ``products`` all but
    the j products and differences an entry (the GEMM-shaped updates,
    which :func:`_k10_bound` counts at the tensor cores' rate)."""
    e, lg, sq, dv = SASS_OPS["exp"], SASS_OPS["log"], SASS_OPS["sqrt"], \
        SASS_OPS["div"]
    ops = m * (3 * e + lg + sq + 8)
    for j in range(R):
        ops += (R + 1 - j) * (3 + (2 * j if products else 0)) + sq + lg \
            + 2 + (R - j) * dv + 2
    return ops


def _k10_bound(B: int, R: int, m: int):
    """K10's least time for ``B`` walkers: G, u, the points and
    frequencies read, the (B, R, R + 1) workspace and the results written,
    against the factor's R^3 / 6 multiply-adds a walker (R^3 / 3 flops,
    GEMM-shaped in its trailing updates) at the float64 tensor cores' rate
    and the rest (M's entries, pivots, divisions, sums) at the CUDA cores'
    float64 instruction rate."""
    nbytes = 8 * (R * R + R + 2 * B + m + B + B * R * (R + 1))
    return _bound(nbytes, B * _k10_ops(R, m, products=False),
                  tensor_ops=B * R ** 3 / 3, rate=F64_INSTR_PER_S)


#: warm calls K10's time is the median of
K10_REPS = 5


def _median_ms(fn, reps: int) -> float:
    """Median device ms of ``reps`` calls of ``fn`` after a warm-up, each
    timed alone by :func:`_time_ms` (CUDA events behind a spin kernel)."""
    import statistics

    fn()
    return statistics.median(_time_ms(fn, 1, warmup=0) for _ in range(reps))


def _k10_kernels(jl, counts, bench, stored, dev, tag) -> list:
    """K10 against its plain version on the card at the catalogue path's G
    and u: the bench's points at B = 16 and 32 and every stored point (B =
    48), each in the wrapper's chunks under its workspace cap, in one
    chunk (the cap raised past B) and in chunks of at most 3 walkers:
    bitwise (``torch.equal``), and within 1e-12 x max(1, sum |log L_jj| +
    0.5 ||z||^2) (the sums from the library's factor); on rows at zero
    amplitude exactly 0.0.  At B = 48 the call's own peak device memory
    over what was held (its workspace: never over the cap).  Times at B =
    32: the kernel (the median of ``K10_REPS`` warm calls, CUDA events
    behind a spin kernel), its launches a call by kernel, its plain
    version, the
    library yardstick -- ``torch.linalg.cholesky_ex`` of the formed M,
    ``solve_triangular`` and the log-determinant, M formed outside the
    timed window -- and the bound.  Returns the ``kernels`` record (B =
    32; ``parts`` holds each of its kernels' launches on the path)."""
    import torch

    from pint_torch.kernels import hd_cross_lnlike as K10

    G, u, f, T = jl.G, jl.u, jl._freqs_t, jl.Tspan
    R, m = G.shape[0], f.shape[0]
    pts = torch.as_tensor(stored, dtype=torch.float64, device=dev)
    bpts = torch.as_tensor(bench, dtype=torch.float64, device=dev)
    eye = torch.eye(R, dtype=torch.float64, device=dev)
    cap = K10.WORKSPACE_CAP_BYTES
    per_walker = 8 * (R * (R + 1) + R)

    def formed(la, ga):
        d = K10._sqrt_phi(la, ga, f, T).repeat_interleave(2, dim=1).repeat(
            1, R // (2 * m))
        return (d[:, :, None] * G) * d[:, None, :] + eye, d * u

    def library(M, v):
        L, _ = torch.linalg.cholesky_ex(M)
        z = torch.linalg.solve_triangular(L, v[..., None], upper=False)
        logd = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
        return 0.5 * (z[..., 0] ** 2).sum(-1) - logd.sum(-1), logd, z

    def chunked(cap_bytes, la, ga):
        K10.WORKSPACE_CAP_BYTES = cap_bytes
        try:
            return K10._launch(G, u, la, ga, f, T)
        finally:
            K10.WORKSPACE_CAP_BYTES = cap

    notes, err, rec, mem = [], 0.0, None, None
    for B in (16, 32, 48):
        src = bpts if B <= len(bpts) else pts
        la, ga = src[:B, 0].contiguous(), src[:B, 1].contiguous()
        want = K10.hd_cross_lnlike_reference(G, u, la, ga, f, T)
        if B == 48:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        got = K10._launch(G, u, la, ga, f, T)
        if B == 48:
            torch.cuda.synchronize()
            mem = torch.cuda.max_memory_allocated() - held
            if mem - 8 * B > cap:
                raise RuntimeError(f"hd_cross_lnlike's workspace {mem} bytes "
                                   f"is over its cap {cap}")
        one = chunked(per_walker * B, la, ga)
        small = chunked(per_walker * 3, la, ga)
        M, v = formed(la, ga)
        lib, logd, z = library(M, v)
        scale = torch.clamp(logd.abs().sum(-1) + 0.5 * (z[..., 0] ** 2).sum(
            -1), min=1.0)
        e = float(((got - want).abs() / scale).max())
        el = float(((got - lib).abs() / scale).max())
        bit = all(bool(torch.equal(x, want)) for x in (got, one, small))
        err = max(err, *(float((x - want).abs().max())
                         for x in (got, one, small)))
        notes.append(f"B={B} (chunks of {K10.walkers_per_chunk(B, R)}, of "
                     f"{B} and of 3): {'bitwise' if bit else 'DIFFERS'}, "
                     f"{e:.3e} of the scale (<= 1e-12), library {el:.3e}")
        if not bit or e > 1e-12:
            raise RuntimeError(f"hd_cross_lnlike disagrees with its plain "
                               f"version at B = {B}: {e:.3e}, bitwise {bit}")
        if B == 32:
            before = dict(K10.launch_counts)
            K10._launch(G, u, la, ga, f, T)
            a_call = {k: K10.launch_counts[k] - before[k]
                      for k in K10.KERNELS.values()}
            ms = _median_ms(lambda: K10._launch(G, u, la, ga, f, T),
                            K10_REPS)
            plain = _time_ms(lambda: K10.hd_cross_lnlike_reference(
                G, u, la, ga, f, T), 1, warmup=1)
            lib_ms = _median_ms(lambda: library(M, v), K10_REPS)
            bound = _k10_bound(B, R, m)
            rec = (ms, plain, lib_ms, bound, a_call)
        del M, v, z
    zl = torch.tensor([-float("inf"), -14.0, -float("inf")],
                      dtype=torch.float64, device=dev)
    zg = torch.tensor([4.33, 4.33, 2.0], dtype=torch.float64, device=dev)
    z0 = K10._launch(G, u, zl, zg, f, T).cpu()
    if not (float(z0[0]) == 0.0 and float(z0[2]) == 0.0
            and float(z0[1]) != 0.0):
        raise RuntimeError(f"hd_cross_lnlike at zero amplitude: {z0}")
    ms, plain, lib_ms, bound, a_call = rec
    verdict = "met" if ms <= lib_ms else "missed"
    print(f"phase kernel hd_cross_lnlike: R={R} m={m}; " + "; ".join(notes)
          + f"; zero amplitude exactly 0.0; B=48 peak {mem / 2**20:.2f} MiB "
          f"over what was held (cap {cap / 2**20:.0f} MiB); B=32 {ms:.4f} "
          f"ms (median of {K10_REPS}; {sum(a_call.values())} launches: "
          + ", ".join(f"{k} {a_call[k]}" for k in a_call)
          + f"), plain {plain:.4f} ms, library cholesky_ex + "
          f"solve_triangular + log-det {lib_ms:.4f} ms (no slower than the "
          f"library: {verdict}), bound {bound[0]:.4f} ms ({bound[1]}; "
          f"R^3 / 3 flops a walker at the float64 tensor cores, "
          f"{_k10_ops(R, m, products=False)} float64 instructions at the "
          f"CUDA cores), share "
          f"{bound[0] / ms:.4f} {tag}", flush=True)
    return [dict(name=K10.NAME, route="cuda",
                 source="pint_torch/kernels/csrc/hd_cross_lnlike.cu",
                 replaces=K10.REPLACES,
                 launches=sum(counts[k] for k in K10.KERNELS.values()),
                 max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
                 bound_by=bound[1], library_ms=lib_ms, path="catalog",
                 parts={k: counts[k] for k in K10.KERNELS.values()})]


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


#: the sweep phase's grid and fused widths (the reference's ``ref/sweep/``
#: was run at fuse 3; the port's fuse 4 holds one group)
SWEEP_GRID = ("M2", "SINI")
SWEEP_FUSES = (3, 4)
SWEEP_REPS = 5


def _sweep_ref(path):
    """(meta, the snapshot's arrays, the stored sweep's arrays by name)."""
    from pint_torch.bridge import read_snapshot

    meta, ref = read_snapshot(path)
    P = "ref/sweep/"
    return meta, ref, {k[len(P):]: v for k, v in ref.items()
                       if k.startswith(P)}


def _sweep_fitter(path, meta):
    """The GLS fitter after the snapshot's first fit, on the card."""
    from pint_torch.bridge import load_snapshot
    from pint_torch.gls_fitter import GLSFitter

    model, batch = load_snapshot(path, device="cuda")
    f = GLSFitter(batch, model)
    f.fit_toas(maxiter=meta["reference"]["settings"]["fit_maxiter"])
    return f


def _sweep_surface(c2, extra, f, names):
    """(chi2 (P,), the extra parameters' values (P, n), diag (P, 3)) of a
    ``grid_chisq`` call on the host."""
    import numpy as np

    d = f.last_grid_diagnostics
    return (np.asarray(c2).ravel(),
            np.stack([np.asarray(extra[n]).ravel() for n in names], axis=1),
            np.stack([d["ladder_rung"].ravel().astype(float),
                      d["ridge"].ravel(), d["condition"].ravel()], axis=1))


def _same(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


def _sweep_phase(label, path, kernels, tag):
    """The fused GLS sweep on one stand-in, counts zeroed just before and
    read just after: after the first fit, ``grid_chisq`` of the stored
    32 x 32 M2 x SINI grid (``chunk=256``, the snapshot's ``niter``)
    unfused and at ``fuse=3`` and ``4``, cold and then the median of 5 warm
    calls each; the fused surfaces (chi2, the extra parameters' refit
    values, rung, ridge and condition) must be bitwise the unfused one,
    and each holds the reference's fused surface (``ref/sweep/``) at the
    grid bars: chi2 1e-6 rel, argmin and rungs equal, values within 1e-2
    sigma.  The grid function built as ``grid_chisq`` builds it gives
    ``fn.fused``'s ``dispatch_count()`` (the reference's stored one at
    fuse 3) and its graphs' replays and captured launches (the wrappers
    count a launch where it is captured: the replays run the captured
    launches again uncounted).  Printed: the warm walls, the CUDA kernels
    and busy share of one warm sweep of each kind under ``torch.profiler``,
    the peak device memory (``max_memory_allocated``) of a cold and a warm
    sweep at fuse 1 (the unfused sweep), 3 and 4, and what the caching
    allocator keeps reserved after each fuse's sweeps once its free blocks
    are released (``empty_cache``): a captured graph's intermediates live
    in its private pool, which counts as reserved, not allocated, and
    stays reserved while the graph lives in the model's grid bundle; the
    reserve is read again after the bundle is dropped.  Returns the
    phase's counts."""
    import gc
    import numpy as np
    import statistics
    import torch

    from pint_torch.grid import build_grid_chi2_fn, grid_chisq, point_spans

    meta, ref, sw = _sweep_ref(path)
    rr = meta["reference"]
    niter = rr["settings"]["grid_niter"]
    extra = ("PB", "A1")
    axes = (sw["m2"], sw["sini"])
    pts = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                   axis=-1)
    names = rr["postfit_params"]
    sig = np.array([ref["ref/postfit_uncertainties"][names.index(p)]
                    for p in extra])
    f = _sweep_fitter(path, meta)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**20
    kernels.reset_counts()

    def sweep(fuse):
        c2, ex = grid_chisq(f, SWEEP_GRID, axes, extraparnames=extra,
                            niter=niter, chunk=256,
                            fuse=None if fuse == 1 else fuse)
        return _sweep_surface(c2, ex, f, extra)

    def timed(fuse):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = sweep(fuse)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, \
            torch.cuda.max_memory_allocated() / 2**20

    def reserved():
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved() / 2**20

    cold, warm, peak, surf, resv = {}, {}, {}, {}, {0: reserved()}
    for fuse in (1,) + SWEEP_FUSES:
        surf[fuse], cold[fuse], pk_cold = timed(fuse)
        walls, pk_warm = [], 0.0
        for _ in range(SWEEP_REPS):
            out, w, pk = timed(fuse)
            walls.append(w)
            pk_warm = max(pk_warm, pk)
            if not _same(out, surf[fuse]):
                raise RuntimeError(f"sweep {label}: a warm fuse={fuse} "
                                   "sweep differs from the cold one")
        warm[fuse] = statistics.median(walls)
        peak[fuse] = (pk_cold, pk_warm)
        resv[fuse] = reserved()
    counts = kernels.launch_counts()
    fn, _, fit_params = build_grid_chi2_fn(
        f.model, f.batch, SWEEP_GRID, niter=niter, chunk=256,
        grid_spans=point_spans(f.model, SWEEP_GRID, pts))
    base = fn(pts)
    n_unfused = fn.dispatch_count()
    dispatch = {}
    for fuse in SWEEP_FUSES:
        got = fn.fused(pts, fuse=fuse)
        dispatch[fuse] = fn.dispatch_count()
        if not _same(got, base):
            raise RuntimeError(f"sweep {label}: fn.fused(fuse={fuse}) is "
                               "not bitwise fn")
    stats = fn.graph_stats()
    prof = {fuse: _profile_cuda(lambda: sweep(fuse))
            for fuse in (1,) + SWEEP_FUSES}
    del fn
    f.model._cache.clear()
    resv_dropped = reserved()
    bitwise = all(_same(surf[fz], surf[1]) for fz in SWEEP_FUSES)
    rc2, rdg = sw["chi2"].ravel(), sw["diag"]
    rvf = np.stack([sw[p.lower()].ravel() for p in extra], axis=1)
    c2, vf, dg = surf[SWEEP_FUSES[0]]
    d_c2 = float(np.max(np.abs(c2 / rc2 - 1)))
    d_vf = float(np.max(np.abs(vf - rvf) / sig))
    same_arg = int(np.nanargmin(c2)) == int(np.nanargmin(rc2))
    same_rung = bool(np.array_equal(dg[:, 0], rdg[:, 0]))
    want_disp = int(sw["dispatch_count"])
    nchunks = -(-len(pts) // 256)
    print(f"phase sweep {label}: {len(pts)} points, chunk 256 ({nchunks} "
          f"chunks), niter={niter}, fits {len(fit_params)}; fused bitwise "
          f"the unfused (chi2, {', '.join(extra)}, rung, ridge, condition; "
          f"fn.fused against fn too) {bitwise}; against ref/sweep/ (the "
          f"reference's fuse=3): chi2 max rel {d_c2:.3e} (<= 1e-6), argmin "
          f"{same_arg}, rungs {same_rung}, values max {d_vf:.3e} sigma (<= "
          f"1e-2); dispatches unfused {n_unfused}, "
          + ", ".join(f"fuse={fz} {dispatch[fz]}" for fz in SWEEP_FUSES)
          + f" (reference fuse=3 {want_disp}) {tag}", flush=True)
    for fuse in (1,) + SWEEP_FUSES:
        n_ev, us, wall = prof[fuse]
        st = stats.get(fuse, {})
        busy = "not measured" if us is None else \
            f"{n_ev} CUDA kernels, {us / 1e3:.4f} ms device in " \
            f"{wall * 1e3:.4f} ms, busy {us / 1e6 / wall:.4f}"
        graph = "" if fuse == 1 else (
            f"; graph replays {st.get('replays')}, captured launches a "
            f"replay {sum(st.get('launches', {}).values())} ("
            + ", ".join(f"{k} {v}" for k, v in st.get("launches",
                                                      {}).items()) + ")")
        print(f"phase sweep {label} fuse={fuse}: cold {cold[fuse]:.4f} s, "
              f"warm {warm[fuse]:.4f} s (median of {SWEEP_REPS}), "
              f"{len(pts) / warm[fuse]:.2f} fits/s; profiled warm sweep "
              f"{busy}; max_memory_allocated cold {peak[fuse][0]:.2f} MiB, "
              f"warm {peak[fuse][1]:.2f} MiB ({held:.2f} MiB held before "
              f"the sweeps); memory_reserved after its sweeps "
              f"{resv[fuse]:.2f} MiB{graph} {tag}", flush=True)
    print(f"phase sweep {label} memory: memory_reserved (after empty_cache)"
          f" before the sweeps {resv[0]:.2f} MiB, after fuse=1 "
          f"{resv[1]:.2f}, after fuse="
          + ", after fuse=".join(f"{fz} {resv[fz]:.2f}" for fz in SWEEP_FUSES)
          + f" (graphs of fuse {', '.join(map(str, SWEEP_FUSES))} held in "
          f"the grid bundle), after the bundle is dropped "
          f"{resv_dropped:.2f} MiB {tag}", flush=True)
    if not (bitwise and d_c2 <= 1e-6 and same_arg and same_rung
            and d_vf <= 1e-2 and dispatch[3] == want_disp
            and n_unfused == nchunks
            and all(dispatch[fz] == -(-nchunks // fz) for fz in SWEEP_FUSES)
            and all(stats.get(fz, {}).get("replays") for fz in SWEEP_FUSES)):
        raise RuntimeError(f"sweep {label}: a bar missed")
    return counts


def _sweep_families(paths, tag) -> None:
    """A fused GLS sweep captured on each binary family's GLS stand-in
    ``(label, path)``: the grid pair the last two free parameters but F0
    and F1, 16 points about their values at chunk 4 and ``niter=1``,
    ``fn.fused(fuse=2)`` (two replays of one graph) bitwise ``fn``; with
    the parameters as fitted and with every other one frozen, so that
    frozen values (numbers, not tensors) reach ``evaluate`` under the
    capture."""
    import numpy as np

    from pint_torch.bridge import load_snapshot
    from pint_torch.grid import build_grid_chi2_fn, point_spans

    res = []
    for label, path in paths:
        for frozen in (False, True):
            model, batch = load_snapshot(path, device="cuda")
            free = [n for n, p in model.params_table.items()
                    if not p.frozen]
            grid = tuple(n for n in free if n not in ("F0", "F1"))[-2:]
            if frozen:
                for n in free:
                    if n not in ("F0", "F1") + grid:
                        model[n].frozen = True
            steps = []
            for n in grid:
                v, u = model.value(n), model[n].uncertainty
                steps.append(v + np.linspace(-1, 1, 4) * (
                    u if u and np.isfinite(u) else 1e-9 * max(abs(v), 1)))
            pts = np.stack([g.ravel() for g in np.meshgrid(
                *steps, indexing="ij")], axis=-1)
            fn, _, _ = build_grid_chi2_fn(
                model, batch, grid, niter=1, chunk=4,
                grid_spans=point_spans(model, grid, pts))
            base = fn(pts)
            got = fn.fused(pts, fuse=2)
            same = _same(got, base)
            reps = fn.graph_stats().get(2, {}).get("replays")
            res.append((f"{label}{' frozen' if frozen else ''} "
                        f"{'x'.join(grid)}", same, reps,
                        same and reps == 2 and fn.dispatch_count() == 2))
    print("phase sweep families: fn.fused(fuse=2) of 16 points at chunk 4 "
          "against fn (bitwise, graph replays): "
          + "; ".join(f"{n} {same} {r}" for n, same, r, _ in res)
          + f" {tag}", flush=True)
    bad = [n for n, _, _, ok in res if not ok]
    if bad:
        raise RuntimeError(f"sweep families: a fused sweep missed: {bad}")


def _sweep_checkpoint(path, tag) -> None:
    """Checkpointed sweeps on the stand-in, each into a fresh temporary
    directory: ``grid_chisq(checkpoint=)`` bitwise the unfused surface;
    the phase's own chunk function (the built grid function on a block)
    failing once with a device-shaped error under ``checkpointed_map``
    with a retry policy, retried, bitwise; the same stopped by a
    non-retryable error at chunk 2 and resumed, recomputing chunks 2-3
    only, bitwise; and after one parameter value changes,
    ``grid_chisq(checkpoint=)`` on the first directory raises
    ``CheckpointError``."""
    import shutil

    import numpy as np

    from pint_torch.exceptions import CheckpointError
    from pint_torch.grid import build_grid_chi2_fn, grid_chisq, point_spans
    from pint_torch.runtime.checkpoint import RetryPolicy, checkpointed_map

    meta, ref, sw = _sweep_ref(path)
    niter = meta["reference"]["settings"]["grid_niter"]
    axes = (sw["m2"], sw["sini"])
    pts = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                   axis=-1)
    f = _sweep_fitter(path, meta)
    base, _ = grid_chisq(f, SWEEP_GRID, axes, niter=niter, chunk=256)
    base_d = f.last_grid_diagnostics["ladder_rung"]
    tmp = Path(tempfile.mkdtemp(prefix="pint_torch_sweep_"))
    try:
        c_ck, _ = grid_chisq(f, SWEEP_GRID, axes, niter=niter, chunk=256,
                             checkpoint=str(tmp / "whole"),
                             retry=RetryPolicy(backoff_base=0.0))
        whole = bool(np.array_equal(c_ck, base) and np.array_equal(
            f.last_grid_diagnostics["ladder_rung"], base_d))
        files = sorted(p.name for p in (tmp / "whole").iterdir())
        fn, _, _ = build_grid_chi2_fn(
            f.model, f.batch, SWEEP_GRID, niter=niter, chunk=256,
            grid_spans=point_spans(f.model, SWEEP_GRID, pts))
        blocks = [pts[i:i + 256] for i in range(0, len(pts), 256)]
        fp = dict(parnames=SWEEP_GRID, pts=pts, niter=niter)
        calls = []

        def chunk_fn(blk, fail_at=None, exc=None):
            i = next(j for j, b in enumerate(blocks) if b is blk)
            calls.append(i)
            if i == fail_at and calls.count(i) == 1:
                raise exc
            c2, vf, dg = fn(blk)
            return {"chi2": c2, "vfit": vf, "diag": dg}

        def stitched(outs):
            return np.concatenate([o["chi2"] for o in outs])

        outs = checkpointed_map(
            lambda b: chunk_fn(b, 1, RuntimeError(
                "injected: CUDA error on device 0")), blocks,
            checkpoint=str(tmp / "retried"), fingerprint=fp,
            retry=RetryPolicy(backoff_base=0.0))
        retried = bool(calls == [0, 1, 1, 2, 3]
                       and np.array_equal(stitched(outs), base.ravel()))
        calls.clear()
        stop = KeyError("injected: the sweep stops at chunk 2")
        try:
            checkpointed_map(lambda b: chunk_fn(b, 2, stop), blocks,
                             checkpoint=str(tmp / "resumed"), fingerprint=fp)
            stopped = False
        except KeyError:
            stopped = calls == [0, 1, 2]
        calls.clear()
        outs = checkpointed_map(lambda b: chunk_fn(b), blocks,
                                checkpoint=str(tmp / "resumed"),
                                fingerprint=fp)
        resumed = bool(stopped and calls == [2, 3]
                       and np.array_equal(stitched(outs), base.ravel()))
        m2 = f.model.copy()
        m2["PB"].value = m2.value("PB") + 1e-10
        from pint_torch.gls_fitter import GLSFitter

        try:
            grid_chisq(GLSFitter(f.batch, m2), SWEEP_GRID, axes, niter=niter,
                       chunk=256, checkpoint=str(tmp / "whole"))
            refused = ""
        except CheckpointError as e:
            refused = f"CheckpointError: {str(e)[:60]}..."
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase sweep checkpoint: grid_chisq(checkpoint=) bitwise "
          f"{whole} ({', '.join(files)}); one device-shaped failure retried, "
          f"bitwise {retried}; stopped at chunk 2 and resumed, chunks 2-3 "
          f"recomputed, bitwise {resumed}; a changed PB refused: "
          f"{refused or 'no'} {tag}", flush=True)
    if not (whole and retried and resumed and refused
            and files == ["chunk_00000.npz", "chunk_00001.npz",
                          "chunk_00002.npz", "chunk_00003.npz",
                          "meta.json"]):
        raise RuntimeError("a checkpointed sweep missed a bar")


def _sampler_retries(path, tag) -> None:
    """One ``EnsembleSampler`` chain on the stand-in (32 walkers x 10
    steps from the stored walkers) whose batched lnposterior fails once
    with a device-shaped error: retried, the chain bitwise the one
    without the failure."""
    import numpy as np

    from pint_torch.bayesian import BayesianTiming
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.sampler import EnsembleSampler

    meta, ref = read_snapshot(path)
    bz = meta["reference"]["bayes"]
    model, batch = load_snapshot(path, device="cuda")
    bt = BayesianTiming(model, batch, prior_info=_bayes_info(meta, ref))

    def chain(inject):
        calls = [0]

        def lnpost(pts):
            calls[0] += 1
            if inject and calls[0] == 3:
                raise RuntimeError("injected: device lost")
            return bt.lnposterior_batch(pts)

        s = EnsembleSampler(bz["nwalkers"], seed=bz["seeds"]["sampler"],
                            retries=2, retry_backoff=0.0)
        s.initialize_batched(lnpost, len(bt.param_labels))
        s.run_mcmc(ref["ref/bayes/pos"].copy(), 10)
        return np.asarray(s._chain), np.asarray(s._lnprob), calls[0]

    x1, l1, n1 = chain(True)
    x0, l0, n0 = chain(False)
    same = bool(np.array_equal(x1, x0) and np.array_equal(l1, l0)
                and n1 == n0 + 1)
    print(f"phase sweep sampler retries: {bz['nwalkers']} walkers x 10 "
          f"steps, one injected device-shaped failure retried ({n1} "
          f"evaluations against {n0}), chain and lnprob bitwise the "
          f"uninjected {same} {tag}", flush=True)
    if not same:
        raise RuntimeError("a retried chain differs from the uninjected one")


# ---------------------------------------------------------------------------
# the precision phase: the precision layer's segments on K11
# ---------------------------------------------------------------------------
#: the forced specs held against the reference's stored outputs
#: (``ref/precision/``): float32 at every accumulation, bfloat16 two_prod
PRECISION_SPECS = (("float32", "native"), ("float32", "f64"),
                   ("float32", "two_sum"), ("float32", "two_prod"),
                   ("bfloat16", "two_prod"))
#: the other bfloat16 modes, run on the serve requests only (no stored
#: outputs): each K11 instantiation launches on the phase's path
PRECISION_EXTRA = (("bfloat16", "native"), ("bfloat16", "f64"),
                   ("bfloat16", "two_sum"))
#: warm repetitions of each timed consumer (the median is printed)
PRECISION_REPS = 5


def _ptag(ct, acc) -> str:
    return f"{'f32' if ct == 'float32' else 'bf16'}_{acc}"


def _pexact(ct, acc) -> bool:
    """The specs held at the standing bars: float64 accumulation of float32
    parts; float32 native and bfloat16 at the segment's forced budget."""
    return ct == "float32" and acc != "native"


def _psteps(ct, acc) -> bool:
    """Whether a forced spec's steps and values are held against the
    reference's: not under float32 native, whose float32 sums over
    thousands of rows, amplified by the systems' conditioning (~1e7),
    leave each package's steps at its own rounding (its chi2 is held)."""
    return not (ct == "float32" and acc == "native")


class _K11Spy:
    """Keep each consumer's largest K11 call (by the output's size) while
    installed, per (consumer, accumulation, dtype), without copying the
    operands; counting stays in K11's own ``_launch``."""

    def __init__(self, K11):
        self.K11 = K11
        self.orig = K11._launch
        self.calls = {}
        self.consumer = None

    def __enter__(self):
        def spy(a3, b3, ct, acc, bounds):
            if self.consumer is not None:
                key = (self.consumer, acc, ct)
                size = a3.shape[0] * a3.shape[1] * b3.shape[2] * a3.shape[2]
                if key not in self.calls or self.calls[key][0] < size:
                    self.calls[key] = (size, (a3, b3, ct, acc, bounds))
            return self.orig(a3, b3, ct, acc, bounds)

        self.K11._launch = spy
        return self

    def __exit__(self, *exc):
        self.K11._launch = self.orig


def _k11_bar(a, b, ct, acc, bounds):
    """The elementwise bar of K11 against its twin: ``4 k_blk 2^-53
    (|a|@|b|)`` for the float64-accumulated modes (k_blk the longest
    two_sum block, else k), ``2 k 2^-24 (|a|@|b|)`` for native, plus one
    bfloat16 ulp of the result for bfloat16."""
    import torch

    k = a.shape[-1]
    scale = torch.matmul(a.abs(), b.abs())
    if acc == "native":
        return 2.0 * k * 2.0 ** -24 * scale
    if acc == "two_sum":
        k = max(hi - lo for lo, hi in zip(bounds[:-1], bounds[1:]))
    return 4.0 * k * 2.0 ** -53 * scale


def _k11_check(K11, a3, b3, ct, acc, split=8):
    """(max |kernel - twin|, max of that over its bar, NaN/Inf positions
    equal, a second launch bitwise the first) of K11 on (B, m, k) x (B, k,
    n) operands."""
    import torch

    bounds = K11.split_bounds(a3.shape[-1], split)
    got = K11._launch(a3, b3, ct, acc, bounds)
    again = K11._launch(a3, b3, ct, acc, bounds)
    same = bool(torch.equal(got.nan_to_num(), again.nan_to_num())) and \
        bool(torch.equal(torch.isnan(got), torch.isnan(again)))
    want = K11.compensated_matmul_reference(a3, b3, ct, acc, split)
    fin = torch.isfinite(want)
    same_nf = bool(torch.equal(torch.isnan(got), torch.isnan(want))) and \
        bool(torch.equal(torch.isinf(got), torch.isinf(want)))
    d = (got - want).abs().where(fin, torch.zeros_like(want))
    bar = _k11_bar(a3, b3, ct, acc, bounds)
    if ct == "bfloat16" and acc == "native":
        w = want.abs().where(fin, torch.ones_like(want)).clamp(min=1e-300)
        bar = bar + torch.exp2(torch.floor(torch.log2(w)) - 7.0)
    ratio = float((d / bar.where(fin, torch.ones_like(bar)).clamp(
        min=1e-300)).max()) if d.numel() else 0.0
    return float(d.max()) if d.numel() else 0.0, ratio, same_nf, same


def _k11_unique_bytes(t) -> int:
    """Bytes a strided operand spans once (a stride-0 batch counted once)."""
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return 8 * min(span, t.numel())


def _k11_bound(a3, b3, ct, acc):
    """K11's least time: each operand read once and the output written
    once over HBM, or its products (a multiply and an add each, three
    products a pair under two_prod) at the card's fastest rate for them.
    The products of float32 or bfloat16 parts are exact in float64, so
    f64, two_sum and two_prod go at the float64 tensor cores' rate;
    native float32 at the CUDA cores' float32 rate, native bfloat16 at the
    bfloat16 tensor cores'."""
    B, m, k = a3.shape
    n = b3.shape[-1]
    nbytes = _k11_unique_bytes(a3) + _k11_unique_bytes(b3) + 8 * B * m * n
    flops = 2.0 * B * m * n * k * (3 if acc == "two_prod" else 1)
    if acc != "native":
        return _bound(nbytes, 0.0, tensor_ops=flops)
    rate = F32_FLOP_PER_S if ct == "float32" else BF16_TC_FLOP_PER_S
    return _bound(nbytes, flops, rate=rate)


def _k11_library(K11, a3, b3, ct, acc):
    """One PyTorch call a pass for the same function on pre-rounded
    operands: ``torch.matmul`` in float64 of the rounded parts (three
    calls under two_prod), in float32 for native."""
    import torch

    F = torch.float64
    ah = K11.round_to(a3, ct)
    bh = K11.round_to(b3, ct)
    if acc == "native":
        a32, b32 = ah.float(), bh.float()
        return lambda: torch.matmul(a32, b32)
    if acc != "two_prod":
        a64, b64 = ah.to(F), bh.to(F)
        return lambda: torch.matmul(a64, b64)
    al = K11.round_to(a3 - ah.to(F), ct).to(F)
    bl = K11.round_to(b3 - bh.to(F), ct).to(F)
    ah, bh = ah.to(F), bh.to(F)
    return lambda: (torch.matmul(ah, bh), torch.matmul(ah, bl),
                    torch.matmul(al, bh))


def _no_k11(fn, what, bad):
    """``fn()``, adding to ``bad`` if any K11 count moved during it: the
    default and ``PrecisionPolicy.f64()`` never launch K11."""
    from pint_torch.kernels import compensated_matmul as K11

    before = dict(K11.launch_counts)
    out = fn()
    moved = {k: v - before[k] for k, v in K11.launch_counts.items()
             if v != before[k]}
    if moved:
        bad.append(f"{what}: K11 launched {moved}")
    return out


def _precision_wall(fn, reps=PRECISION_REPS):
    """Median wall s after synchronize of ``reps`` warm calls of ``fn``."""
    import statistics

    import torch

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return statistics.median(walls)


#: the band of float64's own rounding of a probe's solve under two_prod: a
#: rel_err below it on both sides is that rounding, not the reduced
#: precision (1e-13 to 1e-11 on the CPU; tests/test_torch_precision.py
#: holds both packages' two_prod rel_errs below it)
PROBE_ROUNDING_BAND = 1e-10


def _decisions_agree(mine, stored, segments_def, tag) -> list:
    """Segments whose decided dtype differs from the stored reference's
    where the reference's rel_err is not within 2x of the threshold.  A
    difference where both rel_errs lie in float64's rounding band
    (``PROBE_ROUNDING_BAND``) is printed, not failed: there the threshold
    decides by rounding."""
    bad = []
    for mode in ("unforced", "forced"):
        for seg, want in stored[mode].items():
            d = segments_def[seg]
            bar = d.forced_budget if mode == "forced" else d.safe_rel
            got = mine[mode].get(seg)
            if got is None:
                bad.append(f"{mode} {seg}: not probed")
                continue
            if bar / 2 <= want["rel_err"] <= 2 * bar \
                    or got.value["compute_dtype"] == want["decision"]:
                continue
            msg = (f"{mode} {seg}: {got.value['compute_dtype']} (rel_err "
                   f"{got.measured['rel_err']:.3e}) against the reference's "
                   f"{want['decision']} ({want['rel_err']:.3e})")
            if max(got.measured["rel_err"], want["rel_err"]) \
                    <= PROBE_ROUNDING_BAND:
                print(f"phase precision probe decided by rounding: {msg} "
                      f"{tag}", flush=True)
            else:
                bad.append(msg)
    return bad


def _probe_line(label, mine, stored) -> str:
    return "; ".join(
        f"{mode} " + ", ".join(
            f"{seg} {d.value['compute_dtype']} rel_err "
            f"{d.measured['rel_err']:.3e} (reference "
            f"{stored[mode][seg]['decision']} "
            f"{stored[mode][seg]['rel_err']:.3e})"
            for seg, d in mine[mode].items())
        for mode in ("unforced", "forced"))


def _precision_b1855(path, spy, tag):
    """b1855's consumers (``gls.design``, ``grid.gram``,
    ``grid.correction``): the first fit and, after the float64 first fit,
    the grid at the stored points, under every forced spec against
    ``ref/precision/`` and the port's own float64; the default and
    ``PrecisionPolicy.f64()`` bitwise; a fused sweep under float32
    two_prod captured and bitwise its unfused surface; the probes; the
    walls.  Returns the bars' failures."""
    import numpy as np

    from pint_torch import autotune, config
    from pint_torch import precision as P
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import build_grid_gls_chi2_fn

    meta, ref = read_snapshot(path)
    S, R = meta["reference"]["settings"], meta["reference"]
    pre = "ref/precision/"
    design = R["postfit_params"]
    sig = ref["ref/postfit_uncertainties"]
    pts = ref[pre + "grid_points"]
    bad = []
    base_m, base_b = load_snapshot(path, device="cuda")

    def fit(policy):
        f = GLSFitter(base_b, base_m.copy())
        with P.use_policy(policy):
            chi2 = f.fit_toas(maxiter=S["fit_maxiter"])
        return f, chi2, np.array([f.model.value(p) for p in design])

    spy.consumer = "gls.design"
    f64, chi2_64, v64 = _no_k11(lambda: fit(None), "b1855 fit default", bad)
    _, chi2_f, vf = _no_k11(lambda: fit(P.PrecisionPolicy.f64()),
                            "b1855 fit f64()", bad)
    if not (chi2_f == chi2_64 and np.array_equal(vf, v64)):
        bad.append("b1855 fit: PrecisionPolicy.f64() not bitwise the default")

    def grid(policy, chunk=len(pts)):
        with P.use_policy(policy):
            fn, _, _ = build_grid_gls_chi2_fn(
                f64.model, base_b, ("M2", "SINI"), niter=S["grid_niter"],
                chunk=chunk)
        return fn

    spy.consumer = "grid.gram"
    g64 = _no_k11(lambda: grid(None)(pts), "b1855 grid default", bad)
    if not _same(g64, _no_k11(lambda: grid(P.PrecisionPolicy.f64())(pts),
                              "b1855 grid f64()", bad)):
        bad.append("b1855 grid: PrecisionPolicy.f64() not bitwise")
    lines = []
    for ct, acc in PRECISION_SPECS:
        t = _ptag(ct, acc)
        pol = P.PrecisionPolicy.forced(ct, accumulation=acc)
        spy.consumer = "gls.design"
        _, chi2, v = fit(pol)
        spy.consumer = "grid.gram"
        c2, _, dg = grid(pol)(pts)
        rc2 = float(ref[f"{pre}{t}/fit_chi2"][0])
        rv = ref[f"{pre}{t}/fit_values"]
        gr = ref[f"{pre}{t}/grid_chi2"]
        budget = P.SEGMENTS["gls.design"].forced_budget
        d_chi2 = abs(chi2 / rc2 - 1)
        d_v = float(np.max(np.abs(v - rv) / sig))
        own = abs(chi2 / chi2_64 - 1)
        own_v = float(np.max(np.abs(v - v64) / np.maximum(np.abs(v64), sig)))
        d_g = float(np.max(np.abs(c2 / gr - 1)))
        own_g = float(np.max(np.abs(c2 - g64[0])) / np.max(np.abs(g64[0])))
        same_arg = int(np.argmin(c2)) == int(np.argmin(gr))
        same_rung = bool(np.array_equal(dg[:, 0],
                                        ref[f"{pre}{t}/grid_rungs"]))
        gbudget = P.SEGMENTS["grid.gram"].forced_budget
        if _pexact(ct, acc):
            ok = d_chi2 <= 1e-6 and d_v <= 1e-2 and own <= budget \
                and own_v <= budget and d_g <= 1e-6 and same_arg \
                and same_rung and own_g <= gbudget
        else:
            scale = np.maximum(np.abs(rv), sig)
            ok = d_chi2 <= budget and float(np.max(np.abs(c2 - gr))
                                            / np.max(np.abs(gr))) <= gbudget \
                and (not _psteps(ct, acc) or float(np.max(
                    np.abs(v - rv) / scale)) <= budget)
        lines.append(f"{t}: fit chi2 {d_chi2:.3e} rel, values {d_v:.3e} "
                     f"sigma from the reference's, {own:.3e} / {own_v:.3e} "
                     f"from its own float64; grid chi2 {d_g:.3e} rel, argmin "
                     f"{'equal' if same_arg else 'DIFFERS'}, rungs "
                     f"{'equal' if same_rung else 'DIFFER'}, {own_g:.3e} "
                     f"from its own float64")
        if not ok:
            bad.append(f"b1855 {t}: " + lines[-1])
    print(f"phase precision b1855: " + "; ".join(lines) + f" {tag}",
          flush=True)
    # a fused sweep under float32 two_prod: captured, K11 included
    pol = P.PrecisionPolicy.forced("float32", accumulation="two_prod")
    spy.consumer = "grid.fused"
    fn = grid(pol, chunk=len(pts) // 2)
    with P.use_policy(pol):
        unfused = fn(pts)
        fused = fn.fused(pts, fuse=2)
    stats = fn.graph_stats()
    k11_in = {k: v for s in stats.values() for k, v in s["launches"].items()
              if k.startswith("compensated_matmul")}
    print(f"phase precision b1855 fused: fn.fused(fuse=2) under float32 "
          f"two_prod {'bitwise' if _same(fused, unfused) else 'DIFFERS'}; "
          f"graphs {stats}; K11 in the capture {k11_in} {tag}", flush=True)
    if not (_same(fused, unfused) and k11_in):
        bad.append("b1855 fused sweep under two_prod")
    # walls: float64 against forced float32 two_prod, median of 5 warm
    spy.consumer = None
    walls = {}
    for name, pol in (("f64", None), ("f32_two_prod", pol)):
        walls[("fit", name)] = _precision_wall(lambda: fit(pol))
        gfn = grid(pol)
        with P.use_policy(pol):
            walls[("grid", name)] = _precision_wall(lambda: gfn(pts))
    print("phase precision b1855 walls (median of 5 warm, s): " + ", ".join(
        f"{k[0]} {k[1]} {v:.4f}" for k, v in walls.items()) + f" {tag}",
        flush=True)
    # the probes, unforced and forced, in a temporary tune dir; a fresh
    # fitter then resolves the forced decisions from the manifest alone
    with tempfile.TemporaryDirectory() as tmp:
        config.set_tune_dir(tmp)
        autotune.reset_manifest_singleton()
        try:
            mine = {mode: P.tune_precision_segments(
                f64, force=mode == "forced", grid_params=("M2", "SINI"),
                points=pts[:4], tuning_manifest=autotune.manifest())
                for mode in ("unforced", "forced")}
            fresh = GLSFitter(base_b, f64.model.copy())
            sp = P.segment_spec("gls.design", model=fresh.model,
                                toas=fresh.batch)
        finally:
            config.set_tune_dir(None)
            autotune.reset_manifest_singleton()
    print(f"phase precision b1855 probes: "
          + _probe_line("b1855", mine, R["precision"]["probes"])
          + f"; a fresh fitter resolves gls.design {sp.tag()} "
          f"source={sp.source} {tag}", flush=True)
    bad += _decisions_agree(mine, R["precision"]["probes"], P.SEGMENTS,
                            tag)
    if sp.reduced != (mine["forced"]["gls.design"].value["compute_dtype"]
                      != "float64") or (sp.reduced and sp.source != "tuned"):
        bad.append("b1855: the fresh fitter did not resolve the manifest")
    return bad, walls


def _serve_requests(path, small_path):
    """The serve phase's seven requests on the card at the reference's
    base-fit values, with the reference's residuals (``ref/serve/``), and
    the stream's base fitter."""
    import numpy as np

    from pint_torch.bridge import load_snapshot, read_snapshot, \
        stream_schedule
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.serving import FitRequest

    meta, ref = read_snapshot(path)
    R = meta["reference"]["serve"]
    loaded = {"stream": load_snapshot(path, device="cuda"),
              "small_stream": load_snapshot(small_path, device="cuda")}
    for which, (m, _) in loaded.items():
        for p, v in zip(m.design_param_names(),
                        ref[f"ref/serve/{which}_values"]):
            m[p].value = float(v)
    reqs = []
    for i, (which, n) in enumerate(R["requests"]):
        m, b = loaded[which]
        q = FitRequest.from_fitter(
            GLSFitter(b.select(np.arange(b.ntoas) < n, m), m),
            request_id=f"{which}:{n}")
        reqs.append(FitRequest(M=q.M, r=ref[f"ref/serve/{i}/r"], w=q.w,
                               phiinv=q.phiinv, params=q.params,
                               norm=q.norm, request_id=q.request_id,
                               device=q.M.device))
    m, b = loaded["stream"]
    rows = stream_schedule(meta)[0]
    keep = np.zeros(b.ntoas, dtype=bool)
    keep[rows] = True
    return meta, ref, reqs, GLSFitter(b.select(keep, m), m)


def _precision_serve(path, small_path, spy, tag):
    """j1909_stream's ``serve.gram``: ``ShapeBatcher.run`` on the seven
    requests under every forced spec against ``ref/precision/`` (and its
    own float64), the three other bfloat16 modes run too; the default and
    ``PrecisionPolicy.f64()`` bitwise; the probe on the stream's base fit;
    the walls."""
    import numpy as np

    from pint_torch import precision as P
    from pint_torch.serving import ShapeBatcher

    meta, ref, reqs, base = _serve_requests(path, small_path)
    pre = "ref/precision/"
    sb = ShapeBatcher()
    bad, lines = [], []
    spy.consumer = "serve.gram"

    def run(policy):
        with P.use_policy(policy):
            return sb.run(reqs)

    def flat(res):
        return [np.concatenate([r.dx, r.errors, [r.chi2, r.chi2_initial]])
                for r in res]

    r64 = _no_k11(lambda: run(None), "serve default", bad)
    r64f = _no_k11(lambda: run(P.PrecisionPolicy.f64()), "serve f64()", bad)
    if not all(np.array_equal(a, b) for a, b in zip(flat(r64), flat(r64f))):
        bad.append("serve: PrecisionPolicy.f64() not bitwise the default")
    budget = P.SEGMENTS["serve.gram"].forced_budget
    for ct, acc in PRECISION_SPECS + PRECISION_EXTRA:
        t = _ptag(ct, acc)
        res = run(P.PrecisionPolicy.forced(ct, accumulation=acc))
        if (ct, acc) in PRECISION_EXTRA:
            lines.append(f"{t}: chi2 {max(abs(r.chi2 / q.chi2 - 1) for r, q in zip(res, r64)):.3e} rel from its own float64 (no stored output)")
            continue
        g = dict(dx=0.0, err=0.0, chi2=0.0, own=0.0)
        for i, (r, r6) in enumerate(zip(res, r64)):
            Q = f"{pre}{t}/{i}/"
            e = ref[Q + "errors"]
            c2 = np.array([r.chi2, r.chi2_initial])
            if _pexact(ct, acc):
                g["dx"] = max(g["dx"], float(np.max(np.abs(
                    r.dx - ref[Q + "dx"]) / e)))
                g["err"] = max(g["err"], float(np.max(np.abs(
                    r.errors / e - 1))))
            else:
                g["dx"] = max(g["dx"], float(np.max(np.abs(
                    r.dx - ref[Q + "dx"]) / np.maximum(
                        np.abs(ref[Q + "dx"]), e))))
            g["chi2"] = max(g["chi2"], float(np.max(np.abs(
                c2 / ref[Q + "chi2"] - 1))))
            g["own"] = max(g["own"], abs(r.chi2 / r6.chi2 - 1))
        if _pexact(ct, acc):
            ok = g["dx"] <= 1e-6 and g["err"] <= 1e-9 and g["chi2"] <= 1e-9 \
                and g["own"] <= budget
        else:
            ok = g["chi2"] <= budget and (not _psteps(ct, acc)
                                          or g["dx"] <= budget)
        lines.append(f"{t}: dx {g['dx']:.3e}, errors {g['err']:.3e}, chi2 "
                     f"{g['chi2']:.3e} from the reference's, chi2 "
                     f"{g['own']:.3e} from its own float64")
        if not ok:
            bad.append(f"serve {t}: " + lines[-1])
    print("phase precision serve: " + "; ".join(lines) + f" {tag}",
          flush=True)
    spy.consumer = None
    pol = P.PrecisionPolicy.forced("float32", accumulation="two_prod")
    walls = {("serve", "f64"): _precision_wall(lambda: run(None)),
             ("serve", "f32_two_prod"): _precision_wall(lambda: run(pol))}
    mine = {mode: P.tune_precision_segments(
        base, segments=("serve.gram",), force=mode == "forced")
        for mode in ("unforced", "forced")}
    stored = meta["reference"]["precision"]["probes"]
    print("phase precision serve probes: " + _probe_line("serve", mine,
                                                         stored)
          + "; walls (median of 5 warm, s): " + ", ".join(
              f"{k[1]} {v:.4f}" for k, v in walls.items()) + f" {tag}",
          flush=True)
    bad += _decisions_agree(mine, stored, P.SEGMENTS, tag)
    return bad, walls


def _precision_catalog(path, spy, tag):
    """pta67_catalog's ``catalog.fit`` and ``catalog.lnlike`` at the ingest
    state on the reference's residuals (``ref/catalog/pass0/r``): each
    bucket's batched call and the joint likelihood at the stored points
    under every forced spec against ``ref/precision/`` (and its own
    float64); the default and ``PrecisionPolicy.f64()`` bitwise; the
    catalogue probes; the walls."""
    import numpy as np

    from pint_torch import precision as P
    from pint_torch.bridge import load_catalog_snapshot, read_snapshot
    from pint_torch.catalog import (CatalogFitter, JointLikelihood,
                                    catalog_batched, ingest_catalog)

    meta, ref = read_snapshot(path)
    S = meta["reference"]["settings"]
    pre = "ref/precision/"
    report = ingest_catalog(load_catalog_snapshot(path, device="cuda"))
    cf = CatalogFitter(report)
    reqs = _catalog_on(cf._requests(), ref["ref/catalog/pass0/r"])
    ks = [q.n_free for q in reqs]
    pts = ref[pre + "lnlike_points"]
    bad, lines = [], []

    def fit(policy):
        with P.use_policy(policy):
            return _catalog_lanes(cf, reqs, catalog_batched())

    def lnlike(policy):
        with P.use_policy(policy):
            jl = JointLikelihood(cf, n_modes=S["n_modes"], requests=reqs)
            return jl.lnlike_batch(pts)

    spy.consumer = "catalog.fit"
    f64 = _no_k11(lambda: fit(None), "catalog fit default", bad)
    f64f = _no_k11(lambda: fit(P.PrecisionPolicy.f64()), "catalog fit f64()",
                   bad)
    same_fit = all(all(np.array_equal(x, y) for x, y in zip(a, b))
                   for a, b in zip(f64, f64f))
    spy.consumer = "catalog.lnlike"
    l64 = _no_k11(lambda: lnlike(None), "catalog lnlike default", bad)
    l64f = _no_k11(lambda: lnlike(P.PrecisionPolicy.f64()),
                   "catalog lnlike f64()", bad)
    if not (same_fit and np.array_equal(l64, l64f)):
        bad.append("catalog: PrecisionPolicy.f64() not bitwise the default")
    fb = P.SEGMENTS["catalog.fit"].forced_budget
    lb = P.SEGMENTS["catalog.lnlike"].forced_budget
    for ct, acc in PRECISION_SPECS:
        t = _ptag(ct, acc)
        pol = P.PrecisionPolicy.forced(ct, accumulation=acc)
        spy.consumer = "catalog.fit"
        outs = fit(pol)
        spy.consumer = "catalog.lnlike"
        ll = lnlike(pol)
        rdx = np.split(ref[f"{pre}{t}/fit_dx"], np.cumsum(ks)[:-1])
        rerr = np.split(ref[f"{pre}{t}/fit_errors"], np.cumsum(ks)[:-1])
        rc2 = ref[f"{pre}{t}/fit_chi2"]
        g = dict(dx=0.0, err=0.0, chi2=0.0, own=0.0)
        for i, (o, o6) in enumerate(zip(outs, f64)):
            k = ks[i]
            e = rerr[i]
            scale = e if _pexact(ct, acc) else np.maximum(np.abs(rdx[i]), e)
            g["dx"] = max(g["dx"], float(np.max(np.abs(o[0][:k] - rdx[i])
                                                / scale)))
            g["err"] = max(g["err"], float(np.max(np.abs(o[1][:k] / e - 1))))
            g["chi2"] = max(g["chi2"], float(np.max(np.abs(
                np.array([o[2], o[3]]) / rc2[i] - 1))))
            g["own"] = max(g["own"], abs(float(o[2]) / float(o6[2]) - 1))
        rl = ref[f"{pre}{t}/lnlike"]
        d_l = float(np.max(np.abs(ll - rl) / np.maximum(1.0, np.abs(rl))))
        own_l = float(np.max(np.abs(ll - l64) / np.maximum(1.0,
                                                           np.abs(l64))))
        if _pexact(ct, acc):
            ok = g["dx"] <= 1e-6 and g["err"] <= 1e-9 and g["chi2"] <= 1e-9 \
                and g["own"] <= fb and d_l <= 1e-9 and own_l <= lb
        else:
            ok = g["chi2"] <= fb and d_l <= lb and (not _psteps(ct, acc)
                                                     or g["dx"] <= fb)
        lines.append(f"{t}: fit dx {g['dx']:.3e}, errors {g['err']:.3e}, "
                     f"chi2 {g['chi2']:.3e} from the reference's, chi2 "
                     f"{g['own']:.3e} from its own float64; lnlike "
                     f"{d_l:.3e} x max(1, |ref|), {own_l:.3e} from its own")
        if not ok:
            bad.append(f"catalog {t}: " + lines[-1])
    print("phase precision catalog: " + "; ".join(lines) + f" {tag}",
          flush=True)
    spy.consumer = None
    pol = P.PrecisionPolicy.forced("float32", accumulation="two_prod")
    walls = {}
    for name, p in (("f64", None), ("f32_two_prod", pol)):
        walls[("catalog.fit", name)] = _precision_wall(lambda: fit(p))
        walls[("catalog.lnlike", name)] = _precision_wall(lambda: lnlike(p))
    mine = {mode: P.tune_precision_segments(
        report.pulsars[0].fitter, segments=("catalog.fit", "catalog.lnlike"),
        catalog=report, force=mode == "forced")
        for mode in ("unforced", "forced")}
    stored = meta["reference"]["precision"]["probes"]
    print("phase precision catalog probes: "
          + _probe_line("catalog", mine, stored)
          + "; walls (median of 5 warm, s; lnlike: the likelihood's build "
          "and 4 points): " + ", ".join(
              f"{k[0]} {k[1]} {v:.4f}" for k, v in walls.items())
          + f" {tag}", flush=True)
    bad += _decisions_agree(mine, stored, P.SEGMENTS, tag)
    return bad, walls


def _precision_phase(paths, kernels, tag):
    """The precision layer on the card, K11's counts zeroed just before
    and read just after: b1855 (``gls.design``, ``grid.gram``,
    ``grid.correction``, a fused sweep), j1909_stream (``serve.gram``) and
    pta67_catalog (``catalog.fit``, ``catalog.lnlike``), each under every
    forced spec (module docstring).  Returns (counts, the largest K11 call
    per consumer and mode, the walls)."""
    from pint_torch.kernels import compensated_matmul as K11

    t0 = time.perf_counter()
    kernels.reset_counts()
    with _K11Spy(K11) as spy:
        bad, walls = _precision_b1855(paths["b1855"], spy, tag)
        b2, w2 = _precision_serve(paths["stream"], paths["small_stream"],
                                  spy, tag)
        b3, w3 = _precision_catalog(paths["catalog"], spy, tag)
    counts = kernels.launch_counts()
    bad += b2 + b3
    walls.update(w2)
    walls.update(w3)
    print("phase precision launches: " + ", ".join(
        f"{k} {v}" for k, v in counts.items() if v)
        + f"; wall {time.perf_counter() - t0:.2f} s {tag}", flush=True)
    if bad:
        raise RuntimeError("precision phase: " + " | ".join(bad))
    return counts, spy.calls, walls


#: the index in ``_k11_cases`` of its largest case, (2, 300, 4005) x
#: (2, 4005, 30)
K11_LARGEST_CASE = 5


def _k11_cases(dev) -> list:
    """K11's seeded random (B, m, k) x (B, k, n) cases on ``dev``, entries
    spread over six decades: a 1-D rhs, a batch against a shared operand,
    k = 1, k < split, k off the 16-deep tile, a tall contraction over
    4005 rows, an off-tile shape (m, n past a tile edge, k off the
    256-deep middle sums, few enough tiles that the contraction is split),
    and a zero column with NaN and Inf."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(20261018)

    def rnd(*shape):
        return (torch.rand(*shape, generator=gen, dtype=torch.float64,
                           device=dev) - 0.5) * torch.exp(
            6 * torch.rand(*shape, generator=gen, dtype=torch.float64,
                           device=dev) - 3)

    cases = []
    for sa, sb in (((7, 37), (37, 1)), ((3, 9, 40), (1, 40, 4)),
                   ((4, 1), (1, 3)), ((5, 5), (5, 2)), ((33, 50), (50, 17)),
                   ((2, 300, 4005), (2, 4005, 30)),
                   ((3, 70, 1000), (3, 1000, 77))):
        a, b = rnd(*sa), rnd(*sb)
        if a.ndim == 2:
            a = a[None]
        if b.ndim == 2:
            b = b[None]
        cases.append((a, b.expand(a.shape[0], *b.shape[1:])))
    a, b = rnd(1, 9, 21), rnd(1, 21, 6)
    b[..., 2] = 0.0
    a[0, 3, 4], a[0, 5, 7], b[0, 10, 4] = math.nan, math.inf, -math.inf
    cases.append((a, b))
    return cases


def _k11_kernels(calls, counts, dev, tag) -> list:
    """K11 against its plain twin on the card: every instantiation on the
    largest call each consumer gave K11 in the precision phase in any mode
    (the four path shapes gls.design, grid.gram, serve.gram and
    catalog.lnlike among them) and on the seeded random operands of
    ``_k11_cases`` (an off-tile, split shape among them), within each
    mode's bar (``_k11_bar``), NaN and Inf where the twin's, and a second
    launch bitwise the first; timed on each path shape beside its bound,
    the twin and the library's passes, the record holding the largest call
    of its own mode.  Returns the kernels-line records."""
    from pint_torch.kernels import compensated_matmul as K11

    rand_cases = _k11_cases(dev)
    shapes = {}
    for (consumer, _, _), (size, args) in calls.items():
        if consumer not in shapes or shapes[consumer][0] < size:
            shapes[consumer] = (size, args)
    records = []
    for acc in K11.ACCUMULATIONS:
        for ct in ("float32", "bfloat16"):
            name = K11.KERNELS[(acc, ct)]
            mine = {key: c for key, c in calls.items()
                    if key[1] == acc and key[2] == ct}
            errs, worst, nf, err_path, same = [], 0.0, True, 0.0, True
            for consumer, (_, (a3, b3, _, _, _)) in sorted(shapes.items()):
                bd = K11.split_bounds(a3.shape[-1], 8)
                e, r, s_nf, s_bit = _k11_check(K11, a3, b3, ct, acc)
                ms_c = _time_ms(lambda: K11._launch(a3, b3, ct, acc, bd), 5)
                plain_c = _time_ms(lambda: K11.compensated_matmul_reference(
                    a3, b3, ct, acc), 3, warmup=1)
                lib_c = _time_ms(_k11_library(K11, a3, b3, ct, acc), 5)
                bound_c = _k11_bound(a3, b3, ct, acc)
                errs.append(f"{consumer} {tuple(a3.shape)}x"
                            f"{tuple(b3.shape)} {e:.3e} ({r:.3f} of the bar)"
                            f", kernel {ms_c:.4f} ms, plain {plain_c:.4f}, "
                            f"library {lib_c:.4f}, bound {bound_c[0]:.4f} "
                            f"({bound_c[1]}), share "
                            f"{bound_c[0] / ms_c:.4f}")
                worst, nf, same = max(worst, r), nf and s_nf, same and s_bit
                err_path = max(err_path, e)
            err = 0.0
            for a, b in rand_cases:
                e, r, s_nf, s_bit = _k11_check(K11, a, b, ct, acc)
                err, worst = max(err, e), max(worst, r)
                nf, same = nf and s_nf, same and s_bit
            big = max(mine.values(), key=lambda c: c[0])[1] if mine \
                else (*rand_cases[K11_LARGEST_CASE], ct, acc,
                      K11.split_bounds(4005, 8))
            a3, b3, _, _, bd = big
            ms = _time_ms(lambda: K11._launch(a3, b3, ct, acc, bd), 5)
            plain = _time_ms(lambda: K11.compensated_matmul_reference(
                a3, b3, ct, acc), 3, warmup=1)
            lib = _time_ms(_k11_library(K11, a3, b3, ct, acc), 5)
            bound = _k11_bound(a3, b3, ct, acc)
            print(f"phase kernel {name}: path shapes " + ("; ".join(errs)
                                                         or "none")
                  + f"; random {err:.3e}; worst {worst:.3f} of the bar; NaN/"
                  f"Inf where the twin's {nf}; two launches bitwise {same}; "
                  f"at {tuple(a3.shape)}x{tuple(b3.shape)} kernel {ms:.4f} "
                  f"ms, plain {plain:.4f} ms, library {lib:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), share "
                  f"{bound[0] / ms:.4f} {tag}", flush=True)
            if not (worst <= 1.0 and nf and same):
                raise RuntimeError(f"{name} disagrees with its plain version "
                                   f"or with itself")
            records.append(dict(
                name=name, route="cuda",
                source="pint_torch/kernels/csrc/compensated_matmul.cu",
                replaces=K11.REPLACES, launches=counts[name],
                max_abs_err=max(err, err_path), ms=ms, plain_ms=plain,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
                path="precision"))
    return records


# ---------------------------------------------------------------------------
# the amortized phase: flows trained on reverse mode through the kernels
# ---------------------------------------------------------------------------
#: the training run's bars: the ELBO trace within this rel at every step,
#: the final weights and the last step's gradient within this of each
#: leaf's largest
AMORT_TRACE_BAR = 1e-6
AMORT_REPS = 10


def _amortized_leaves(ref, prefix):
    """The stored leaves under ``ref/amortized/<prefix>``, in order."""
    P = "ref/amortized/" + prefix
    return [ref[k] for k in sorted(k for k in ref if k.startswith(P))]


def _amortized_vi(kind, path, meta, ref, flow_kw):
    """(AmortizedVI on the card, its posterior object): from_bayesian on the
    stored ``ref/bayes/`` box, or from_joint_likelihood at the catalogue's
    ingest state on the reference's residuals."""
    from pint_torch.amortized import AmortizedVI

    if kind == "bayes":
        from pint_torch.bayesian import BayesianTiming
        from pint_torch.bridge import load_snapshot

        model, batch = load_snapshot(path, device="cuda")
        bt = BayesianTiming(model, batch, prior_info=_bayes_info(meta, ref))
        return AmortizedVI.from_bayesian(bt, **flow_kw), bt
    from pint_torch.bridge import load_catalog_snapshot
    from pint_torch.catalog import (CatalogFitter, JointLikelihood,
                                    ingest_catalog)

    S = meta["reference"]["settings"]
    cf = CatalogFitter(ingest_catalog(load_catalog_snapshot(path,
                                                            device="cuda")))
    reqs = _catalog_on(cf._requests(), ref["ref/catalog/pass0/r"])
    jl = JointLikelihood(cf, n_modes=S["n_modes"], requests=reqs)
    return AmortizedVI.from_joint_likelihood(jl, **flow_kw), jl


def _amortized_phase(label, path, kind, kernels, tag, timed_steps):
    """Amortized inference on one stand-in, from the reference's outputs
    under ``ref/amortized/``, the counts zeroed just before the main path
    (the VI's construction, ``train_flow`` of the stored schedule, the
    reference's trained posterior's draws and log-probabilities) and read
    just after.  Bars: ``init()`` bitwise; the base samples within 2 ulp of
    the reference's (and the 20-step stream's sha256 printed); at the
    initial parameters and the stored first samples the ELBO, each sample's
    lnpost (5e-7 x chi2; the catalogue 1e-9 x max(1, |ref|)), logq (1e-12 x
    max(1, |logq|)) and each gradient leaf (1e-6 of its largest |g_ref|,
    zeros where the reference's); the last step's samples the reference's
    (sha256); the free-running ELBO trace within :data:`AMORT_TRACE_BAR`
    rel at every step and the final weights within it of each leaf's
    largest, against the reference's run evaluated op by op where the
    snapshot holds one (``ref/amortized/op_by_op/``: ell1, ddgr), else its
    compiled run; at the compiled run's state before its last step the
    ELBO (1e-6 rel) and the gradient (1e-6 of each leaf's largest against
    the op-by-op gradient there where stored, zeros alike), and Adam's
    update from the compiled gradient within 1e-12 of each leaf's largest
    |w| of the compiled final weights.  Printed beside: the gaps to the
    compiled run, and where stored the compiled ELBO's central
    differences along the two reference gradients' difference beside
    each gradient's derivative along it.  The reference's trained
    posterior carried in:
    the kept draws, the 4096 draws' mean and std within 1e-12 of each box's
    width, log-probs within 1e-12 x max(1, |ref|) with -inf exactly where
    the reference's; saved and loaded on the card bitwise.  Printed: the
    free-running trace's and weights' gaps, then ``timed_steps`` steps:
    steps/s, the forward and backward ms of a step (median of
    :data:`AMORT_REPS`), the CUDA kernels and busy share of 5 steps under
    ``torch.profiler``, a step's ``max_memory_allocated``, draws/s and
    log-probs/s.  Returns (counts, capture, the posterior object)."""
    import hashlib

    import numpy as np
    import torch

    from pint_torch.amortized import (AmortizedPosterior, TrainConfig,
                                      _prng, train_flow)
    from pint_torch.amortized.flows import leaves, unflatten
    from pint_torch.amortized.train import adam_update, loss_and_grad
    from pint_torch.bridge import read_snapshot

    meta, ref = read_snapshot(path)
    A = meta["reference"]["amortized"]
    P = "ref/amortized/"
    dev = torch.device("cuda")
    flow_kw = dict(n_layers=A["n_layers"], hidden=A["hidden"],
                   seed=A["flow_seed"])
    cfg = TrainConfig(steps=A["steps"], n_samples=A["n_samples"], lr=A["lr"],
                      seed=A["train_seed"])
    f64 = torch.float64
    cap = Capture(kernels.modules())
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vi, obj = _amortized_vi(kind, path, meta, ref, flow_kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cap.install()
    t0 = time.perf_counter()
    res = train_flow(vi, cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    cap.remove()
    nl = vi.flow.n_coupling_layers
    final_ref = [torch.as_tensor(x, dtype=f64, device=dev)
                 for x in _amortized_leaves(ref, "final/")]
    post = AmortizedPosterior(vi.flow, vi.transform,
                              unflatten(final_ref, nl), vi.param_labels,
                              vi.vkey)
    draws = post.draw(A["draws"], seed=A["draw_seed"])
    lp = post.log_prob(ref[P + "logprob_points"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    bad = []
    # the initial parameters and the random stream
    init = leaves(vi.flow.init(dev))
    if not all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(
            init, _amortized_leaves(ref, "init/"))):
        bad.append("init() not bitwise")
    key, zs = _prng.prng_key(cfg.seed), []
    for _ in range(cfg.steps):
        key, sub = _prng.split(key)
        zs.append(_prng.normal(sub, (cfg.n_samples, vi.ndim)))
    z0 = ref[P + "z0"]
    ulp = float((np.abs(zs[0] - z0) / np.spacing(np.abs(z0))).max())
    same = [hashlib.sha256(z.tobytes()).hexdigest() == want
            for z, want in zip(zs, A["z_sha256_steps"])]
    if ulp > 2.0:
        bad.append(f"base samples {ulp} ulp from the reference's")
    if not same[-1]:
        bad.append("the last step's samples are not the reference's")
    # the ELBO, lnpost, logq and gradient at (init, z0)
    ps = [x.clone().requires_grad_(True) for x in init]
    zt = torch.as_tensor(z0, dtype=f64, device=dev)
    params = unflatten(ps, nl)
    x, logq = vi.sample_and_logq(params, zt)
    lnpost = vi.lnpost_batch(x)
    elbo = torch.mean(lnpost - logq)
    grad = torch.autograd.grad(elbo, ps)
    lnpost = lnpost.detach().cpu().numpy()
    logq = logq.detach().cpu().numpy()
    want_lp, want_q = ref[P + "lnpost0"], ref[P + "logq0"]
    if kind == "bayes":
        xs = x.detach().cpu().numpy()
        lnpr = np.array([obj.lnprior(p) for p in xs])
        scale = -2.0 * (want_lp - lnpr + obj.lognorm)
        bar_lp = LNPOST_BAR
    else:
        scale = np.maximum(1.0, np.abs(want_lp))
        bar_lp = LNLIKE_BAR
    d_lp = float(np.max(np.abs(lnpost - want_lp) / scale))
    d_q = float(np.max(np.abs(logq - want_q) / np.maximum(1.0,
                                                          np.abs(want_q))))
    d_elbo = abs(float(elbo.detach()) - A["elbo0"]) \
        / float(np.mean(scale))
    d_g, zeros = 0.0, True
    for g, w in zip(grad, _amortized_leaves(ref, "grad0/")):
        g = g.cpu().numpy()
        zeros = zeros and bool(np.array_equal(g == 0, w == 0))
        d_g = max(d_g, float(np.abs(g - w).max()
                             / max(np.abs(w).max(), 1e-300)))
    # Adam's first step from the port's and the reference's first gradient:
    # lr * g / (|g| + eps), so an entry whose sign differs moves a whole
    # step; the first such entry (in leaf order) printed
    flips, first_flip = 0, "none"
    for i, (g, w) in enumerate(zip(grad, _amortized_leaves(ref, "grad0/"))):
        g = g.cpu().numpy().ravel()
        w = w.ravel()
        bad_sign = (np.sign(g) != np.sign(w)) & (np.maximum(
            np.abs(g), np.abs(w)) > cfg.eps)
        flips += int(bad_sign.sum())
        if bad_sign.any() and first_flip == "none":
            j = int(np.flatnonzero(bad_sign)[0])
            first_flip = (f"leaf {i} entry {j}: the reference's {w[j]:.3e}, "
                          f"the port's {g[j]:.3e}")
    if not (d_lp <= bar_lp and d_q <= 1e-12 and d_elbo <= bar_lp
            and d_g <= 1e-6 and zeros):
        bad.append(f"ELBO at the stored samples: lnpost {d_lp:.3e}, logq "
                   f"{d_q:.3e}, ELBO {d_elbo:.3e}, gradient {d_g:.3e}, "
                   f"exact zeros {zeros}")
    # the free-running run against the reference's, op by op where stored
    O = "op_by_op/" if P + "op_by_op/trace" in ref else ""
    trace, trace_c = ref[P + O + "trace"], ref[P + "trace"]
    gap = np.abs(res.elbo_trace - trace) / np.abs(trace)
    gap_c = np.abs(res.elbo_trace - trace_c) / np.abs(trace_c)

    def leaf_gap(got, prefix):
        return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
                   for g, w in zip(got, _amortized_leaves(ref, prefix)))

    mine = [x.detach().cpu().numpy() for x in leaves(res.params)]
    d_wfree = leaf_gap(mine, O + "final/")
    d_wfree_c = leaf_gap(mine, "final/")
    if not (gap.max() <= AMORT_TRACE_BAR and d_wfree <= AMORT_TRACE_BAR):
        bad.append(f"free-running run: trace {gap.max():.3e} (step "
                   f"{int(np.argmax(gap)) + 1}), final weights "
                   f"{d_wfree:.3e}")
    # the last step at the compiled run's state and samples
    st = [[torch.as_tensor(x, dtype=f64, device=dev)
           for x in _amortized_leaves(ref, f"state/{t}_")]
          for t in ("p", "m", "v")]
    loss, g_last = loss_and_grad(vi, st[0], torch.as_tensor(
        zs[-1], dtype=f64, device=dev))
    d_last = abs(-float(loss) - trace_c[-1]) / abs(trace_c[-1])
    g_last = [g.cpu().numpy() for g in g_last]
    d_gl = leaf_gap(g_last, O + "grad_last/")
    d_gc = leaf_gap(g_last, "grad_last/")
    zeros_l = all(np.array_equal(g == 0, w == 0) for g, w in zip(
        g_last, _amortized_leaves(ref, O + "grad_last/")))
    g_ref = [torch.as_tensor(x, dtype=f64, device=dev)
             for x in _amortized_leaves(ref, "grad_last/")]
    p_last = adam_update(*st, A["t_state"], g_ref, cfg)[0]
    d_w = max(float((a - w).abs().max() / w.abs().max().clamp(min=1e-300))
              for a, w in zip(p_last, final_ref))
    if not (d_last <= AMORT_TRACE_BAR and d_gl <= AMORT_TRACE_BAR
            and zeros_l and d_w <= 1e-12):
        bad.append(f"the last step at the reference's state: ELBO "
                   f"{d_last:.3e}, gradient {d_gl:.3e}, zeros alike "
                   f"{zeros_l}, Adam from its gradient {d_w:.3e}")
    fd_note = ""
    if O:
        F = A["op_by_op"]
        own = float(np.max(np.abs(trace_c - trace) / np.abs(trace)))
        fd_note = (f"; the compiled reference's own trace against its "
                   f"op-by-op run up to {own:.3e}, and along the two "
                   f"reference gradients' difference at its last state the "
                   f"compiled ELBO's central differences "
                   + ", ".join(f"{x:.6e}" for x in F["fd"])
                   + f" (steps {F['fd_h']}) against the op-by-op "
                   f"gradient's {F['along_op_by_op']:.6e} and the "
                   f"compiled's {F['along_compiled']:.6e}")
    # the reference's posterior
    width = np.array([s[2] - s[1] if s[0] == "uniform" else s[2]
                      for s in vi.transform.specs])
    kept = ref[P + "draws"]
    d_draw = float(np.max(np.abs(draws[:len(kept)] - kept) / width))
    d_mom = float(max(np.max(np.abs(draws.mean(0) - ref[P + "draws_mean"])
                             / width),
                      np.max(np.abs(draws.std(0) - ref[P + "draws_std"])
                             / width)))
    want = ref[P + "logprob"]
    inf_same = bool(np.array_equal(np.isneginf(lp), np.isneginf(want)))
    fin = np.isfinite(want)
    d_logp = float(np.max(np.abs(lp[fin] - want[fin])
                          / np.maximum(1.0, np.abs(want[fin]))))
    with tempfile.TemporaryDirectory() as tmp:
        post.save(os.path.join(tmp, "flow"))
        back = AmortizedPosterior.load(os.path.join(tmp, "flow"))
        reload_same = bool(np.array_equal(back.draw(64, seed=3),
                                          post.draw(64, seed=3)))
    if not (d_draw <= 1e-12 and d_mom <= 1e-12 and inf_same
            and d_logp <= 1e-12 and reload_same):
        bad.append(f"posterior: draws {d_draw:.3e}, moments {d_mom:.3e}, "
                   f"log-probs {d_logp:.3e}, -inf alike {inf_same}, "
                   f"reloaded bitwise {reload_same}")
    print(f"phase amortized {label}: {vi.ndim}-dim, flow {A['n_layers']} x "
          f"{A['hidden']}; setup {setup_s:.4f} s, train {cfg.steps} x "
          f"{cfg.n_samples} {train_s:.4f} s; init bitwise; z0 max "
          f"{ulp:.0f} ulp, {sum(same)} of {cfg.steps} steps' samples "
          f"bitwise (sha256), the last step's {same[-1]}; "
          f"at (init, z0): lnpost {d_lp:.3e} (<= {bar_lp:g} of "
          f"{'chi2' if kind == 'bayes' else 'max(1, |ref|)'}), logq "
          f"{d_q:.3e}, ELBO {d_elbo:.3e}, gradient {d_g:.3e} of each leaf's "
          f"largest (<= 1e-6), zeros alike {zeros}; Adam's first step: "
          f"{flips} entries of opposite sign (first {first_flip}); "
          f"free-running against the reference's "
          f"{'op-by-op' if O else 'compiled'} run: trace gaps "
          + ", ".join(f"{g:.1e}" for g in gap)
          + f" (<= {AMORT_TRACE_BAR:g}), final weights {d_wfree:.3e} of each "
          f"leaf's largest (<= {AMORT_TRACE_BAR:g})"
          + (f"; against its compiled run: trace up to {gap_c.max():.3e}, "
             f"weights {d_wfree_c:.3e}" if O else "")
          + f"; at the compiled run's state before the last step: ELBO "
          f"{d_last:.3e}, gradient {d_gl:.3e} of each leaf's largest "
          f"(<= 1e-6{', the op-by-op one' if O else ''}"
          + (f"; the compiled one {d_gc:.3e}" if O else "")
          + f"), zeros alike {zeros_l}, Adam from the reference's gradient "
          f"{d_w:.3e} (<= 1e-12){fd_note}; draws {d_draw:.3e}, moments "
          f"{d_mom:.3e} of the box width, log-probs {d_logp:.3e}, -inf alike "
          f"{inf_same} ({int(np.isneginf(want).sum())} outside), reloaded "
          f"bitwise "
          f"{reload_same}; launches (nonzero) "
          f"{dict((k, v) for k, v in counts.items() if v)} {tag}",
          flush=True)
    step_launches = {k: v / cfg.steps for k, v in counts.items() if v}
    if kind == "catalog":
        # every walker factored once a step: value and gradient from K12's
        # sequence, K10's own launch never called where a gradient is taken
        from pint_torch.kernels import hd_cross_lnlike as K10

        alone = {k: counts[k] for k in K10.KERNELS.values() if counts[k]}
        if alone:
            bad.append(f"K10 launched alone under a gradient: {alone}")
        print(f"phase amortized {label} launches a step: K10 "
              + str({k: step_launches.get(k, 0.0)
                     for k in K10.KERNELS.values()})
              + ", K12 " + str({k: step_launches.get(k, 0.0)
                                for k in K10.GRAD_KERNELS.values()})
              + f" {tag}", flush=True)
    if bad:
        raise RuntimeError(f"amortized bars failed ({label}): "
                           + "; ".join(bad))
    # timed: the schedule's steps, a step's parts, the profiler
    tcfg = TrainConfig(steps=timed_steps, n_samples=cfg.n_samples,
                       lr=cfg.lr, seed=cfg.seed, checkpoint_chunk=timed_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_flow(vi, tcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    zt = torch.as_tensor(zs[1], dtype=f64, device=dev)
    elbo_fn = vi.elbo_fn()
    fwd, bwd = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mem = torch.cuda.memory_allocated()
    for _ in range(AMORT_REPS):
        ps = [x.clone().requires_grad_(True) for x in final_ref]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = -elbo_fn(unflatten(ps, nl), zt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, ps)
        torch.cuda.synchronize()
        fwd.append(t1 - t0)
        bwd.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() - held_mem
    n5, us5, w5 = _profile_cuda(lambda: train_flow(vi, TrainConfig(
        steps=5, n_samples=cfg.n_samples, lr=cfg.lr, seed=cfg.seed)))
    post.draw(A["draws"], seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d4 = post.draw(A["draws"], seed=2)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    post.log_prob(d4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post.log_prob(d4)
    torch.cuda.synchronize()
    t_lp = time.perf_counter() - t0
    print(f"phase amortized {label} timed: {timed_steps} steps {wall:.4f} s, "
          f"{timed_steps / wall:.3f} steps/s; a step's forward "
          f"{1e3 * float(np.median(fwd)):.4f} ms, backward "
          f"{1e3 * float(np.median(bwd)):.4f} ms (medians of {AMORT_REPS}); "
          f"5 steps under torch.profiler: "
          + (f"{n5} CUDA kernels, busy {us5 / 1e6 / w5:.4f} ({us5 / 1e3:.2f} "
             f"ms device of {w5 * 1e3:.2f} ms wall)" if n5 else
             "not measured (no device events)")
          + f"; a step's peak {peak / 2**20:.2f} MiB over "
          f"{held_mem / 2**20:.2f} held; draw({A['draws']}) "
          f"{A['draws'] / t_draw:.1f} draws/s, log_prob of {A['draws']} "
          f"{A['draws'] / t_lp:.1f} /s {tag}", flush=True)
    return counts, cap, obj


#: warm calls K12's time is the median of
K12_REPS = 5


def _k12_bound(B: int, R: int, m: int):
    """K12's least time for ``B`` walkers (value and gradient from one
    factor): its inputs read and its outputs written once, against its
    whole work -- the factor's R^3 / 6 and L^-1's R^3 / 6 multiply-adds a
    walker (2 R^3 / 3 flops), GEMM-shaped in their trailing updates, at the
    float64 tensor cores' rate, and 5 R^2 flops on the CUDA cores (M's two
    products an entry, the squared column norms of L^-1 and w's column
    sums)."""
    nbytes = 8 * (R * R + R + 2 * B + m + B + 2 * B)
    return _bound(nbytes, B * 5 * R ** 2, tensor_ops=B * 2 * R ** 3 / 3)


def _k12_kernels(jl, cap, counts, dev, tag) -> list:
    """K12's launch sequence (value and gradient from one factor) against
    its plain versions on the card at the amortized path's G, u and walker
    points (its largest call, B = 64) at B = 16, 32, 48 and 64, each in the
    wrapper's chunks under the workspace cap, in one chunk and in chunks of
    3: the value bitwise K10's (``_launch``) and the gradient bitwise its
    plain version (``torch.equal``), and the gradient within 1e-12 x sum_k
    |e_k| (w_k^2 + (M^-1)_kk + 1) (those from the library's factor, for
    log10_A and gamma apart); exactly 0.0 at zero amplitude.  Times at B =
    64: the sequence (median of ``K12_REPS`` warm calls), its launches a
    call, K10 alone beside it, its plain version, the library yardstick for
    the same work -- ``cholesky_ex`` of the formed M, the value's solve and
    log-determinant, the diagonal of ``cholesky_inverse`` and w's two
    solves, M formed outside the timed window -- and the bound
    (:func:`_k12_bound`)."""
    import torch

    from pint_torch.kernels import hd_cross_lnlike as K10

    G, u, la0, ga0, f, T = cap.args("hd_cross_lnlike_value_and_grad")
    R, m = G.shape[0], f.shape[0]
    eye = torch.eye(R, dtype=torch.float64, device=dev)
    eg = K10.gamma_weights(f).repeat_interleave(2).repeat(R // (2 * m))
    per = 8 * (R * (R + 1) + (K10.NB + 2) * R)
    capb = K10.WORKSPACE_CAP_BYTES

    def library(la, ga):
        d = K10._sqrt_phi(la, ga, f, T).repeat_interleave(2, dim=1).repeat(
            1, R // (2 * m))
        M = (d[:, :, None] * G) * d[:, None, :] + eye
        return M, d * u

    def lib_terms(M, v):
        L, _ = torch.linalg.cholesky_ex(M)
        dinv = torch.diagonal(torch.cholesky_inverse(L), dim1=-2, dim2=-1)
        z = torch.linalg.solve_triangular(L, v[..., None], upper=False)
        value = 0.5 * (z[..., 0] ** 2).sum(-1) - torch.log(
            torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        w = torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]
        return w, dinv, value

    def chunked(cap_bytes, la, ga):
        K10.WORKSPACE_CAP_BYTES = cap_bytes
        try:
            return K10._launch_value_and_grad(G, u, la, ga, f, T)
        finally:
            K10.WORKSPACE_CAP_BYTES = capb

    notes, err, rec = [], 0.0, None
    for B in (16, 32, 48, 64):
        la, ga = la0[:B].contiguous(), ga0[:B].contiguous()
        want = K10.hd_cross_grad_reference(G, u, la, ga, f, T)
        want_v = K10._launch(G, u, la, ga, f, T)
        outs = [K10._launch_value_and_grad(G, u, la, ga, f, T),
                chunked(per * B, la, ga), chunked(per * 3, la, ga)]
        M, v = library(la, ga)
        w, dinv, _ = lib_terms(M, v)
        t = w * w + dinv + 1.0
        scale = torch.stack([math.log(10.0) * t.sum(-1),
                             (eg.abs() * t).sum(-1)], dim=1)
        lib = torch.stack([math.log(10.0) * (w * w + dinv - 1.0).sum(-1),
                           (eg * (w * w + dinv - 1.0)).sum(-1)], dim=1)
        got = outs[0][1]
        e = float(((got - want).abs() / scale).max())
        el = float(((got - lib).abs() / scale).max())
        bit = all(bool(torch.equal(g, want)) for _, g in outs)
        bit_v = all(bool(torch.equal(x, want_v)) for x, _ in outs)
        err = max(err, *(float((g - want).abs().max()) for _, g in outs))
        notes.append(f"B={B} (chunks of "
                     f"{K10.walkers_per_chunk(B, R, K10.NB + 2)}, of {B} "
                     f"and of 3): gradient {'bitwise' if bit else 'DIFFERS'}"
                     f", value {'bitwise K10' if bit_v else 'DIFFERS'}, "
                     f"{e:.3e} of the scale (<= 1e-12), library {el:.3e}")
        if not (bit and bit_v) or e > 1e-12:
            raise RuntimeError(f"hd_cross_grad disagrees with its plain "
                               f"versions at B = {B}: {e:.3e}, gradient "
                               f"bitwise {bit}, value bitwise {bit_v}")
        if B == 64:
            before = dict(K10.launch_counts)
            K10._launch_value_and_grad(G, u, la, ga, f, T)
            a_call = {k: K10.launch_counts[k] - before[k]
                      for k in K10.GRAD_KERNELS.values()}
            ms = _median_ms(lambda: K10._launch_value_and_grad(
                G, u, la, ga, f, T), K12_REPS)
            ms10 = _median_ms(lambda: K10._launch(G, u, la, ga, f, T),
                              K12_REPS)
            plain = _time_ms(lambda: K10.hd_cross_value_and_grad_reference(
                G, u, la, ga, f, T), 1, warmup=0)
            lib_ms = _median_ms(lambda: lib_terms(M, v), K12_REPS)
            bound = _k12_bound(B, R, m)
            rec = (ms, ms10, plain, lib_ms, bound, a_call)
        del M, v, w, dinv
    zl = torch.tensor([-float("inf"), -14.0, -float("inf")],
                      dtype=torch.float64, device=dev)
    zg = torch.tensor([4.33, 4.33, 2.0], dtype=torch.float64, device=dev)
    zv, z0 = (x.cpu() for x in K10._launch_value_and_grad(G, u, zl, zg, f,
                                                         T))
    if not (bool((z0[0] == 0.0).all()) and bool((z0[2] == 0.0).all())
            and bool((z0[1] != 0.0).all()) and float(zv[0]) == 0.0
            and float(zv[2]) == 0.0):
        raise RuntimeError(f"hd_cross_grad at zero amplitude: {zv}, {z0}")
    ms, ms10, plain, lib_ms, bound, a_call = rec
    print(f"phase kernel hd_cross_grad: R={R} m={m}; " + "; ".join(notes)
          + f"; zero amplitude exactly 0.0; B=64 value and gradient "
          f"{ms:.4f} ms (median of {K12_REPS}; {sum(a_call.values())} "
          f"launches: " + ", ".join(f"{k} {a_call[k]}" for k in a_call)
          + f"; K10 alone {ms10:.4f} ms), plain {plain:.4f} ms, library "
          f"cholesky_ex + solves + log-det + cholesky_inverse diagonal "
          f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; 2 R^3 / 3 "
          f"flops a walker at the float64 tensor cores, 5 R^2 at the CUDA "
          f"cores), share {bound[0] / ms:.4f} {tag}",
          flush=True)
    parts = {k: counts[k] for k in K10.GRAD_KERNELS.values()}
    return [dict(name="hd_cross_grad", route="cuda",
                 source="pint_torch/kernels/csrc/hd_cross_lnlike.cu",
                 replaces=K10.GRAD_REPLACES, launches=sum(parts.values()),
                 max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
                 bound_by=bound[1], library_ms=lib_ms,
                 path="amortized_pta67_catalog", parts=parts)]


def _backward_kernels(caps, dev, tag, partial: bool = False) -> dict:
    """Each kernel Function's ``backward`` (the kernel's partials contracted
    with a seeded cotangent) against autograd through its plain twin on the
    same CUDA tensors, at the inputs its path gave it: K1's and K4's
    (ELL1) duals on the amortized ell1 path, K2's DDGR on amortized ddgr,
    K2's DD, BT, DDK and BTX on b1855, bt, ddk and small_bt_piecewise, K6's
    FBX and waves on bw, bw_waves and small_dd_fbx, K7 on pta: every input
    cotangent within 1e-10 of its largest.  Timed: the backward node alone
    (``torch.autograd.grad`` on a kept graph, the contraction) on the
    amortized paths' calls, beside its bound: the saved partials (B, N, k)
    and the cotangent read once, each input's gradient written once, and
    2 B N k operations for the contraction.  ``partial``: check only the
    paths in ``caps`` (a probe's).  Returns {name: (error, backward
    ms)}."""
    import torch

    from pint_torch.kernels import binary_orbits as K6
    from pint_torch.kernels import dd_binary as K2
    from pint_torch.kernels import ell1_binary as K4
    from pint_torch.kernels import solar_wind_pl as K7
    from pint_torch.kernels import spin_phase as K1

    gen = torch.Generator(device=dev).manual_seed(20261026)
    lines, out = [], {}

    def check(name, fn, twin, args, timed=False, k=0):
        xs = [a.detach().clone().requires_grad_(True) for a in args]
        y = fn(*xs)
        ys = y if isinstance(y, tuple) else (y,)
        cots = [torch.randn(o.shape, generator=gen, dtype=torch.float64,
                            device=dev) for o in ys]
        got = torch.autograd.grad(ys, xs, cots, retain_graph=timed,
                                  allow_unused=True)
        xt = [a.detach().clone().requires_grad_(True) for a in args]
        yt = twin(*xt)
        yt = yt if isinstance(yt, tuple) else (yt,)
        want = torch.autograd.grad(yt, xt, cots, allow_unused=True)
        e = 0.0
        for g, w in zip(got, want):
            if w is None:
                continue
            g = torch.zeros_like(w) if g is None else g
            e = max(e, float((g - w).abs().max()
                             / w.abs().max().clamp(min=1e-300)))
        ms = None
        if timed:
            ms = _median_ms(lambda: torch.autograd.grad(
                ys, xs, cots, retain_graph=True, allow_unused=True), 5)
            bn = sum(c.numel() for c in cots)
            bound = _bound(8 * (bn * (k + 1) + sum(x.numel() for x in xs)),
                           2 * bn * k)
        lines.append(f"{name} {e:.3e}" + (
            f" ({ms:.4f} ms, B x N {tuple(cots[0].shape)}, k {k}, bound "
            f"{bound[0]:.4f} ms ({bound[1]}))" if timed else ""))
        out[name] = (e, ms)
        if not e <= 1e-10:
            raise RuntimeError(f"{name}'s backward disagrees with its twin's: "
                               f"{e:.3e}")

    def k1(args, timed=False):
        th, tl, t0, pe, dl, F, has = args[:7]
        check("spin_phase (K1)", lambda p, d, f_: K1.spin_phase(
            th, tl, t0, p, d, f_, has)[1], lambda p, d, f_:
            K1.spin_phase_reference(th, tl, t0, p, d, f_, has, False)[1],
            (pe, dl, F), timed, F.shape[1] + 2)

    def k2(name, args, timed=False):
        tt0, params, mode, toa, orb = args[:5]
        extra = list(toa or ()) + list(orb or ())
        nt = len(toa or ())

        def split(rest):
            return tuple(rest[:nt]) or None, tuple(rest[nt:]) or None

        check(name, lambda t, p, *r: K2.dd_binary(t, p, mode, *split(r)),
              lambda t, p, *r: K2.dd_binary_reference(
                  t, p, False, mode, *split(r))[0],
              (tt0, params, *extra), timed,
              K2.npartial(mode, orb is not None))

    def k4(name, args, timed=False):
        tt, params, mode, _, nh, h4 = args[:6]
        orb = args[6] if len(args) > 6 else None
        check(name, lambda t, p, *o: K4.ell1_binary(
            t, p, mode, nh, h4, tuple(o) or None),
            lambda t, p, *o: K4.ell1_binary_reference(
                t, p, mode, False, nh, h4, tuple(o) or None)[0],
            (tt, params, *(orb or ())), timed,
            K4.npartial(mode, orb is not None))

    def k6(name, args):
        tt0, coef, form, nfb, nw, off = args[:6]
        check(name, lambda t, c: K6.binary_orbits(t, c, form, nfb, nw, off),
              lambda t, c: K6.binary_orbits_reference(
                  t, c, form, nfb, nw, off, False)[:2], (tt0, coef))

    def k7(name, args):
        r, th, p, ii, win = args[:5]
        check(name, lambda t, p_, i_: K7.solar_wind_pl(r, t, p_, i_, win),
              lambda t, p_, i_: K7._twin(r, t, p_, i_, win, False)[0],
              (th, p, ii))

    cases = [
        ("amortized_ell1", lambda c: k1(c.args("spin_phase", True), True)),
        ("amortized_ell1", lambda c: k4("ell1_binary ELL1 (K4)", c.args(
            "ell1_binary", (K4.ELL1, True)), True)),
        ("amortized_ddgr", lambda c: k2("dd_binary DDGR (K2)", c.args(
            "dd_binary", (K2.DDGR, True)), True))]
    for mode, path, nm in ((K2.DD, "b1855", "DD"), (K2.BT, "bt", "BT"),
                           (K2.DDK, "ddk", "DDK"),
                           (K2.BTX, "small_bt_piecewise", "BTX")):
        cases.append((path, lambda c, mode=mode, nm=nm: k2(
            f"dd_binary {nm} (K2)", c.args("dd_binary", (mode, True)))))
    cases.append(("small_dd_fbx", lambda c: k2(
        "dd_binary DD orbit inputs (K2)", c.args("dd_binary",
                                                 (K2.DD, True, True)))))
    for form, path, nm in ((K6.FBX, "bw", "FBX"),
                           (K6.WAVES_FBX, "bw_waves", "waves on FBX"),
                           (K6.WAVES_PB, "small_dd_fbx", "waves on PB")):
        cases.append((path, lambda c, form=form, nm=nm: k6(
            f"binary_orbits {nm} (K6)", c.args("binary_orbits",
                                                (form, True)))))
    cases.append(("pta", lambda c: k7("solar_wind_pl (K7)",
                                      c.args("solar_wind_pl", True))))
    for path, case in cases:
        if path in caps or not partial:
            case(caps[path])
    print("phase kernel backward: each Function's backward against autograd "
          "through its twin, max of each input's |d| / its largest (<= "
          "1e-10; the backward node's ms on the amortized path): "
          + "; ".join(lines) + f" {tag}", flush=True)
    return out


# ---------------------------------------------------------------------------
# the predict phase: the phase-prediction path on K13 and K14
# ---------------------------------------------------------------------------
#: the predict path's bars against ``ref/predict/``: the host layer's node
#: columns (clock corrections and TDB [s], positions [km], velocities
#: [km/s]), phases [cycles], frequencies (relative) and fit rms [cycles]
HOST_CLOCK_BAR_S = 1e-12
HOST_TDB_BAR_S = 1e-12
HOST_POS_BAR_KM = 1e-6
HOST_VEL_BAR_KMS = 1e-9
PREDICT_PHASE_BAR = 1e-10
PREDICT_FREQ_BAR = 1e-12
PREDICT_RMS_BAR = 1e-11
#: the floor of those bars, in granules q = ulp(F0 max|delay|) of the node
#: set: the spin phase carries F0 times the delay (~1e5 cycles at a few
#: hundred Hz) in one float64, so each package's node phase is rounded to
#: q (2.9e-11 cycles for ell1), the two packages' delays part by an ulp
#: and their spin arithmetic by as much -- each node phase by up to 2 q, a
#: target (a difference of two) by 4 q, a fitted prediction or rms by
#: about twice its targets' gap.  The bars are max(bar, floor x q)
PREDICT_TARGET_FLOOR_Q = 8
PREDICT_FIT_FLOOR_Q = 16
#: P2's members, in the reference's order
PREDICT_MEMBERS = ("b1855", "ell1", "ddk", "ddgr")


def _k13_ops(n: int) -> int:
    """float64 instructions per element of ``polyco_eval.cu``, the
    division at its SASS count: 5 a Horner step of both series (n - 1
    steps), poly's last step (2), the ramp and its sums (4), floor and the
    fraction (2), the frequency's division and sum."""
    return 5 * (n - 1) + 8 + SASS_OPS["div"] + 1


def _k14_ops(m: int, n: int) -> int:
    """float64 instructions of one row of ``polyco_fit.cu``, sqrt and
    division at their SASS counts: V by repeated products, per column k
    the norm (2 (m - k)), its sqrt, alpha, v'v, its reciprocal and v_k,
    then for each of the n - k later columns (y among them) the dot
    (2 (m - k)), f and the update (2 (m - k)); back substitution; the
    residual (3 a term) and the rms."""
    sq, dv = SASS_OPS["sqrt"], SASS_OPS["div"]
    ops = m * (n - 1)
    for k in range(n):
        r = m - k
        ops += 2 * r + sq + dv + 5 + (n - k) * (4 * r + 1)
    ops += sum(2 * (n - 1 - i) + dv for i in range(n))
    return ops + 3 * m * n + 2 * m + sq + dv


def _horner_np(tmid, seg_min, coeffs, rint, rfrac, f0, t):
    """``(int, frac, freq)`` of a grid at ``t`` by the cache's numpy
    recurrence, each time in its (half-open) window."""
    import numpy as np

    half = seg_min / 2880.0
    w = np.clip(np.searchsorted(tmid - half, t, side="right") - 1, 0,
                len(tmid) - 1)
    dt = (t - tmid[w]) * 1440.0
    c = coeffs[w]
    poly = np.zeros_like(dt)
    dpoly = np.zeros_like(dt)
    for i in range(c.shape[1] - 1, 0, -1):
        poly = poly * dt + c[:, i]
        dpoly = dpoly * dt + i * c[:, i]
    poly = poly * dt + c[:, 0]
    raw = rfrac[w] + 60.0 * f0 * dt + poly
    ip = np.floor(raw)
    return rint[w] + ip, raw - ip, f0 + dpoly / 60.0


def _phase_gap(pi, pf, ri, rf) -> float:
    """The largest gap [cycles] of two absolute phases; inf where the
    integers differ away from a cycle's edge."""
    import numpy as np

    pi, pf, ri, rf = (np.asarray(a, dtype=np.float64).ravel()
                      for a in (pi, pf, ri, rf))
    inside = np.minimum(rf, 1.0 - rf) > 1e-9
    if not np.array_equal(pi[inside], ri[inside]):
        return math.inf
    return float(np.max(np.abs((pi - ri) + (pf - rf))))


class _WarnedWindows:
    """Collect the ``predict window <s>: fit rms ...`` warnings of the
    ``pint_torch`` logger in place of its handlers while inside (one line
    a window would flood the log): ``windows`` the logged rows in order."""

    def __init__(self):
        import logging

        self.log = logging.getLogger("pint_torch")
        self.windows = []
        outer = self

        class Collect(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith("predict window "):
                    outer.windows.append(int(msg.split()[2].rstrip(":")))

        self.handler = Collect(logging.WARNING)

    def __enter__(self):
        self.saved = list(self.log.handlers)
        for h in self.saved:
            self.log.removeHandler(h)
        self.log.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)
        for h in self.saved:
            self.log.addHandler(h)
        return False


def _grid_gaps(model, P, ref, meta_p, coeffs, rms, rint, rfrac, f0,
               warned):
    """One stored grid (``P``: ``ref/predict/serve/`` or ``gen/``) against
    the port's: the host layer at its nodes, its node targets (run again
    by ``node_targets``; the integers exactly), the predicted phases and
    frequencies at 64 seeded epochs a window through the port's and the
    stored coefficients, and the fit rms."""
    import numpy as np

    from pint_torch.predict.generate import node_mjds, node_targets, \
        node_toas

    tmid = ref[P + "tmids"]
    seg, nc, obs, fq = (meta_p["segLength"], meta_p["ncoeff"],
                        meta_p["obs"], meta_p["obsFreq"])
    ts = node_toas(model, node_mjds(tmid, seg, nc)[0], obs, fq)
    want = np.asarray(ref[P + "tdb_hi"], dtype=np.longdouble) \
        + np.asarray(ref[P + "tdb_lo"], dtype=np.longdouble)
    g = dict(
        clock=float(np.max(np.abs(ts.clock_corr_s - ref[P + "clock_corr_s"]))),
        tdb=float(np.max(np.abs(np.asarray((ts.tdb - want) * 86400,
                                           dtype=np.float64)))),
        pos=float(max(np.max(np.abs(ts.ssb_obs_pos_km
                                    - ref[P + "ssb_obs_pos_km"])),
                      np.max(np.abs(ts.obs_sun_pos_km
                                    - ref[P + "obs_sun_pos_km"])))),
        vel=float(np.max(np.abs(ts.ssb_obs_vel_kms
                                - ref[P + "ssb_obs_vel_kms"]))))
    h = node_targets(model, tmid, seg, nc, obs, fq)
    g["q"] = float(np.spacing(abs(f0) * float(
        model.delay(ts).abs().max())))
    g["rint"] = bool(np.array_equal(h["rint"], ref[P + "rint"])
                     and np.array_equal(rint, ref[P + "rint"]))
    g["y"] = float(np.max(np.abs(h["y"] - ref[P + "y"])))
    g["rfrac"] = float(max(np.max(np.abs(h["rfrac"] - ref[P + "rfrac"])),
                           np.max(np.abs(rfrac - ref[P + "rfrac"]))))
    g["x"] = float(np.max(np.abs(h["x"] - ref[P + "x"])))
    rng = np.random.default_rng(20260808)
    half = seg / 2880.0
    t = np.concatenate([rng.uniform(c - half, c + half, 64) for c in tmid])
    pi, pf, pq = _horner_np(tmid, seg, coeffs, rint, rfrac, f0, t)
    ri, rf, rq = _horner_np(tmid, seg, ref[P + "coeffs"], ref[P + "rint"],
                            ref[P + "rfrac"], f0, t)
    g["phase"] = _phase_gap(pi, pf, ri, rf)
    g["freq"] = float(np.max(np.abs(pq / rq - 1)))
    g["rms"] = float(np.max(np.abs(rms - ref[P + "fit_rms"])))
    # the windows the port logged above FIT_RMS_WARN, the reference's
    g["warned"] = list(warned) == meta_p["warned"]
    return g


def _bars_of(q) -> tuple:
    """(target, prediction, rms) bars [cycles] at granule ``q``."""
    return (max(PREDICT_PHASE_BAR, PREDICT_TARGET_FLOOR_Q * q),
            max(PREDICT_PHASE_BAR, PREDICT_FIT_FLOOR_Q * q),
            max(PREDICT_RMS_BAR, PREDICT_FIT_FLOOR_Q * q))


def _grid_ok(g) -> bool:
    b_y, b_p, b_r = _bars_of(g["q"])
    return (g["clock"] <= HOST_CLOCK_BAR_S and g["tdb"] <= HOST_TDB_BAR_S
            and g["pos"] <= HOST_POS_BAR_KM and g["vel"] <= HOST_VEL_BAR_KMS
            and g["rint"] and g["warned"] and g["x"] <= PREDICT_PHASE_BAR
            and max(g["y"], g["rfrac"]) <= b_y and g["phase"] <= b_p
            and g["freq"] <= PREDICT_FREQ_BAR and g["rms"] <= b_r)


def _grid_line(g) -> str:
    q = g["q"]
    return (f"host clock {g['clock']:.2e} s, TDB {g['tdb']:.2e} s, pos "
            f"{g['pos']:.2e} km, vel {g['vel']:.2e} km/s; granule q "
            f"{q:.3e} cycles; rint {'equal' if g['rint'] else 'DIFFER'}, x "
            f"{g['x']:.2e}, y {g['y']:.3e} ({g['y'] / q:.1f} q), rfrac "
            f"{g['rfrac']:.3e} ({g['rfrac'] / q:.1f} q), predicted phase "
            f"{g['phase']:.3e} cycles ({g['phase'] / q:.1f} q), freq "
            f"{g['freq']:.2e} rel, fit rms {g['rms']:.3e} cycles "
            f"({g['rms'] / q:.1f} q), windows logged above the rms bar "
            f"{'the same' if g['warned'] else 'DIFFER'}")


def _serve_predicts(model, ref, meta_p):
    """P1's request mix on a ``PredictorCache`` of ``model`` (the settings
    of its stored ``ref/predict/serve/``): build, the settle batch, the
    bench batch coalesced, then the probes one by one, each after
    ``torch.cuda.synchronize()``.  Returns (cache, results by batch,
    quantities)."""
    import numpy as np
    import torch

    from pint_torch.predict import PredictorCache, PredictRequest
    from pint_torch.predict.door import run_predict_requests

    P = "ref/predict/serve/"
    k, n = meta_p["requests"], meta_p["times_per_request"]
    ladders = dict(time_buckets=(n,), batch_buckets=(1, k))
    reqs = {tag: [PredictRequest(t, request_id=f"{tag}-{i}")
                  for i, t in enumerate(ref[P + f"{tag}_times"])]
            for tag in ("settle", "bench", "probe")}
    t = time.perf_counter()
    cache = PredictorCache(model, meta_p["mjd_start"], meta_p["mjd_end"],
                           obs=meta_p["obs"], segLength=meta_p["segLength"],
                           ncoeff=meta_p["ncoeff"], obsFreq=meta_p["obsFreq"])
    cache.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    res = {"settle": run_predict_requests(cache, None, reqs["settle"],
                                          **ladders)}
    torch.cuda.synchronize()
    h0, m0 = cache.hits, cache.misses
    t = time.perf_counter()
    res["bench"] = run_predict_requests(cache, None, reqs["bench"], **ladders)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    lat, res["probe"] = [], []
    for q in reqs["probe"]:
        t = time.perf_counter()
        res["probe"] += run_predict_requests(cache, None, [q], **ladders)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t))
    dh, dm = cache.hits - h0, cache.misses - m0
    return cache, res, dict(
        windows=int(cache.n_windows), build_s=build_s,
        predicts_per_s=n * k / elapsed, p50_ms=float(np.percentile(lat, 50)),
        p99_ms=float(np.percentile(lat, 99)),
        cache_hit_rate=dh / (dh + dm) if dh + dm else 0.0)


def _served_gaps(cache, res, ref):
    """Every PredictResult against the stored one: (phase gap, freq gap,
    the host ``cache.predict`` at the bench epochs, mismatches of bucket,
    batch, windows and compiles)."""
    import numpy as np

    P = "ref/predict/serve/"
    phase = freq = 0.0
    bad = []
    for key, rs in res.items():
        for i, r in enumerate(rs):
            phase = max(phase, _phase_gap(r.phase_int, r.phase_frac,
                                          ref[P + f"{key}_phase_int"][i],
                                          ref[P + f"{key}_phase_frac"][i]))
            freq = max(freq, float(np.max(np.abs(
                r.freq / ref[P + f"{key}_freq"][i] - 1))))
            want = tuple(int(ref[P + f"{key}_{f}"][i])
                         for f in ("bucket", "batch", "windows"))
            if (r.bucket, r.batch, r.windows) != want or r.compiles:
                bad.append(f"{key} {i}: (bucket, batch, windows) "
                           f"{(r.bucket, r.batch, r.windows)} != {want} or "
                           f"compiles {r.compiles}")
    pi, pf, _ = cache.predict(ref[P + "bench_times"].ravel())
    host = _phase_gap(pi, pf, ref[P + "predict_phase_int"],
                      ref[P + "predict_phase_frac"])
    return phase, freq, host, bad


def _predict_phase(paths, kernels, tag):
    """The phase-prediction path (``pint_torch.predict``) on the card,
    from the snapshots' models and the port's own host layer, against the
    reference's ``ref/predict/``.  P1 (counts zeroed just before, read
    just after): ngc's ``PredictorCache`` at the barycentre over 2 days
    from PEPOCH (48 windows of 60 min, 12 coefficients), built, a settle
    batch, 8 requests x 48 epochs coalesced, 12 single-request probes.
    P2 (likewise): ``generate_predictor_sets`` at GBT over 2.5 days from
    MJD 55000 for b1855, ell1, ddk and ddgr (240 rows on the 256 rung),
    then b1855's cache at GBT serving P1's mix.  Bars: the host layer at
    every stored node set (clock and TDB 1e-12 s, positions 1 mm,
    velocities 1e-9 km/s) and the TZR row built by it (the same bars
    against the snapshot's); node targets (integers exactly, y and rfrac
    1e-10 cycles), predicted phases 1e-10 cycles, frequencies 1e-12 rel,
    fit rms 1e-11 cycles, the same warned windows; every PredictResult's
    phases and frequencies at those bars, its bucket, batch and windows
    equal and no build during the call.  Returns {path: (counts,
    Capture)} for P1 and P2."""
    import numpy as np
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.predict import generate_predictor_sets

    t_phase = time.perf_counter()
    models, refs = {}, {}
    for label in ("ngc",) + PREDICT_MEMBERS:
        meta, ref = read_snapshot(paths[label])
        models[label] = load_snapshot(paths[label], device="cuda")[0]
        refs[label] = (meta["reference"]["predict"], ref)
    bad = []

    # the TZR row from the host layer against the snapshot's
    ab = models["ngc"].components["AbsPhase"]
    host, stored = ab.host_tzr_batch(), ab.context["tzr_batch"]
    c_ls = 299792.458
    tzr = dict(
        tdb=float(abs((host.tdb.hi - stored.tdb.hi) + (host.tdb.lo
                                                       - stored.tdb.lo))
                  .max()) * 86400,
        pos=max(float((getattr(host, f) - getattr(stored, f)).abs().max())
                for f in ("ssb_obs_pos", "obs_sun_pos")) * c_ls,
        vel=float((host.ssb_obs_vel - stored.ssb_obs_vel).abs().max()) * c_ls,
        ctx=all(torch.equal(host.contexts[c][k], v)
                for c, d in stored.contexts.items() for k, v in d.items()))
    print(f"phase predict tzr: the host layer's TZR row against the "
          f"snapshot's: TDB {tzr['tdb']:.2e} s, positions {tzr['pos']:.2e} "
          f"km, velocity {tzr['vel']:.2e} km/s, contexts "
          f"{'equal' if tzr['ctx'] else 'DIFFER'} {tag}", flush=True)
    if not (tzr["tdb"] <= HOST_TDB_BAR_S and tzr["pos"] <= HOST_POS_BAR_KM
            and tzr["vel"] <= HOST_VEL_BAR_KMS and tzr["ctx"]):
        bad.append(f"TZR row {tzr}")

    out = {}
    # ---- P1: the bench's read path on ngc ----------------------------------
    rp, ref = refs["ngc"]
    cap = Capture(kernels.modules())
    kernels.reset_counts()
    cap.install()
    try:
        with _WarnedWindows() as w1:
            cache, res, q = _serve_predicts(models["ngc"], ref, rp["serve"])
    finally:
        cap.remove()
    out["predict_p1"] = (kernels.launch_counts(), cap)
    phase, freq, hostg, sbad = _served_gaps(cache, res, ref)
    g = _grid_gaps(models["ngc"], "ref/predict/serve/", ref, rp["serve"],
                   cache._coeffs, cache._rms, cache._rint, cache._rfrac,
                   cache.f0, w1.windows)
    print(f"phase predict P1 ngc @: {q['windows']} windows, build "
          f"{q['build_s']:.4f} s, predicts_per_s {q['predicts_per_s']:.3f}, "
          f"p50 {q['p50_ms']:.4f} ms, p99 {q['p99_ms']:.4f} ms (12 probes, "
          f"wall after synchronize), cache_hit_rate "
          f"{q['cache_hit_rate']:.4f}; results: phase {phase:.2e} cycles, "
          f"freq {freq:.2e} rel, cache.predict {hostg:.2e} cycles; "
          f"{_grid_line(g)} {tag}", flush=True)
    if not (_grid_ok(g) and max(phase, hostg) <= _bars_of(g["q"])[1]
            and freq <= PREDICT_FREQ_BAR) or sbad:
        bad.append(f"P1: {g} phase {phase} freq {freq} host {hostg} {sbad}")

    # ---- P2: one predictor batch for four pulsars, then b1855's cache ------
    gen = refs[PREDICT_MEMBERS[0]][0]["gen"]
    cap = Capture(kernels.modules())
    kernels.reset_counts()
    cap.install()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _WarnedWindows() as w2:
            sets = generate_predictor_sets(
                [models[n] for n in PREDICT_MEMBERS], gen["mjd_start"],
                gen["mjd_end"], gen["obs"], segLength=gen["segLength"],
                ncoeff=gen["ncoeff"], obsFreq=gen["obsFreq"])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        rp, ref = refs["b1855"]
        with _WarnedWindows() as w3:
            cache, res, q = _serve_predicts(models["b1855"], ref,
                                            rp["serve"])
    finally:
        cap.remove()
    out["predict_p2"] = (kernels.launch_counts(), cap)
    print(f"phase predict P2 generation: {len(sets)} pulsars x "
          f"{sets[0].n_windows} windows at {gen['obs']} in one "
          f"generate_predictor_sets, {gen_s:.4f} s wall after synchronize "
          f"{tag}", flush=True)
    for i, (name, s) in enumerate(zip(PREDICT_MEMBERS, sets)):
        rp_m, ref_m = refs[name]
        W = s.n_windows
        g = _grid_gaps(models[name], "ref/predict/gen/", ref_m, rp_m["gen"],
                       s.coeffs, s.fit_rms, s.rphase_int, s.rphase_frac,
                       s.f0, [r - i * W for r in w2.windows
                              if i * W <= r < (i + 1) * W])
        print(f"phase predict P2 {name} gbt: max fit rms "
              f"{float(s.fit_rms.max()):.3e} cycles, "
              f"{len(rp_m['gen']['warned'])} windows above FIT_RMS_WARN in "
              f"the reference; {_grid_line(g)} {tag}", flush=True)
        if not _grid_ok(g):
            bad.append(f"P2 {name}: {g}")
    phase, freq, hostg, sbad = _served_gaps(cache, res, ref)
    g = _grid_gaps(models["b1855"], "ref/predict/serve/", ref, rp["serve"],
                   cache._coeffs, cache._rms, cache._rint, cache._rfrac,
                   cache.f0, w3.windows)
    print(f"phase predict P2 b1855 cache gbt: {q['windows']} windows, build "
          f"{q['build_s']:.4f} s, predicts_per_s {q['predicts_per_s']:.3f}, "
          f"p50 {q['p50_ms']:.4f} ms, p99 {q['p99_ms']:.4f} ms, "
          f"cache_hit_rate {q['cache_hit_rate']:.4f}; results: phase "
          f"{phase:.2e} cycles, freq {freq:.2e} rel, cache.predict "
          f"{hostg:.2e} cycles; {_grid_line(g)} {tag}", flush=True)
    if not (_grid_ok(g) and max(phase, hostg) <= _bars_of(g["q"])[1]
            and freq <= PREDICT_FREQ_BAR) or sbad:
        bad.append(f"P2 cache: {g} phase {phase} freq {freq} host {hostg} "
                   f"{sbad}")
    print(f"phase predict wall: {time.perf_counter() - t_phase:.2f} s {tag}",
          flush=True)
    if bad:
        raise RuntimeError("predict phase: " + "; ".join(bad))
    return out


def _k13_k14_kernels(p1, p2, dev, tag) -> list:
    """K13 and K14 against their plain versions on P1's and P2's calls and
    on seeded rows -- 256 rows of which 200 are pad rows, and random
    evaluations --, bitwise; each timed (the median of 20 warm calls)
    beside its bound, its plain version and, for K14, the library's
    ``torch.linalg.lstsq`` on the same rows (K13 has no single PyTorch
    call).  Returns their records."""
    import torch

    from pint_torch.kernels import polyco_eval as K13
    from pint_torch.kernels import polyco_fit as K14

    gen = torch.Generator(device=dev).manual_seed(20260808)
    records = []
    # K14: P1's 64-row call, P2's 256-row call, a seeded 256-row case with
    # 200 pad rows (zero targets on the last window's nodes)
    x2, y2, n = (p2[1].args("polyco_fit")[i] for i in (0, 1, 2))
    xs = x2.clone()
    ys = torch.randn(xs.shape, generator=gen, dtype=torch.float64,
                     device=dev) * 1e-6
    ys[56:] = 0.0
    cases = {"P1": p1[1].args("polyco_fit")[:3], "P2": (x2, y2, n),
             "seeded, 200 pad rows": (xs, ys, n)}
    err14, same14, pad0 = 0.0, True, True
    for label, (x, y, nc) in cases.items():
        ck, rk = K14._launch(x, y, nc)
        cr, rr = K14.polyco_fit_reference(x, y, nc)
        same14 = same14 and bool(torch.equal(ck, cr) and torch.equal(rk, rr))
        err14 = max(err14, float((ck - cr).abs().max()),
                    float((rk - rr).abs().max()))
        if label.startswith("seeded"):
            pad0 = bool((ck[56:] == 0).all() and (rk[56:] == 0).all())
    W, m = x2.shape
    cols = [torch.ones_like(x2)]
    for _ in range(1, n):
        cols.append(cols[-1] * x2)
    V = torch.stack(cols, dim=2)
    ms14 = _median_ms(lambda: K14._launch(x2, y2, n), 20)
    plain14 = _median_ms(lambda: K14.polyco_fit_reference(x2, y2, n), 5)
    lib14 = _median_ms(lambda: torch.linalg.lstsq(V, y2.unsqueeze(-1)), 20)
    bound14 = _bound(8 * (2 * W * m + W * (n + 1)), W * _k14_ops(m, n),
                     rate=F64_INSTR_PER_S)
    # K13: P1's and P2's largest calls and seeded evaluations
    a1 = p1[1].args("polyco_eval")
    a2 = p2[1].args("polyco_eval")
    B, T, nc = a1[3].shape
    rnd = (torch.rand((B, T), generator=gen, dtype=torch.float64,
                      device=dev) * 60 - 30,
           torch.rand((B, T), generator=gen, dtype=torch.float64,
                      device=dev) - 0.5,
           torch.rand((B, T), generator=gen, dtype=torch.float64,
                      device=dev) * 700 + 1,
           torch.randn((B, T, nc), generator=gen, dtype=torch.float64,
                       device=dev) * 1e-3)
    err13, same13 = 0.0, True
    for args in (a1, a2, rnd):
        ok = K13._launch(*args)
        orr = K13.polyco_eval_reference(*args)
        same13 = same13 and all(torch.equal(a, b) for a, b in zip(ok, orr))
        err13 = max([err13] + [float((a - b).abs().max())
                               for a, b in zip(ok, orr)])
    ms13 = _median_ms(lambda: K13._launch(*a1), 20)
    plain13 = _median_ms(lambda: K13.polyco_eval_reference(*a1), 5)
    bound13 = _bound(8 * B * T * (3 + nc) + 24 * B * T,
                     B * T * _k13_ops(nc), rate=F64_INSTR_PER_S)
    print(f"phase kernel polyco_fit: W={W} m={m} n={n} (P2's call; P1's "
          f"{tuple(cases['P1'][0].shape)}); bitwise its plain version on "
          f"P1's, P2's and 256 seeded rows: {same14}, pad rows exactly 0: "
          f"{pad0}; {ms14:.4f} ms (plain {plain14:.4f}, library "
          f"torch.linalg.lstsq {lib14:.4f}, bound {bound14[0]:.6f} "
          f"({bound14[1]}; launch-sized)) {tag}", flush=True)
    print(f"phase kernel polyco_eval: B={B} T={T} n={nc} (P1's call; P2's "
          f"{tuple(a2[3].shape)}); bitwise its plain version on P1's, P2's "
          f"and seeded inputs: {same13}; {ms13:.4f} ms (plain "
          f"{plain13:.4f}, library none: no single PyTorch call, bound "
          f"{bound13[0]:.6f} ({bound13[1]}; launch-sized)) {tag}", flush=True)
    if not (same14 and pad0 and same13):
        raise RuntimeError("polyco_fit or polyco_eval disagrees with its "
                           "plain version")
    for K, src, err, ms, plain, bound, lib, path in (
            (K14, "polyco_fit.cu", err14, ms14, plain14, bound14, lib14,
             p2), (K13, "polyco_eval.cu", err13, ms13, plain13, bound13,
                   None, p1)):
        (name,) = K.KERNELS.values()
        records.append(dict(
            name=name, route="cuda", source=f"pint_torch/kernels/csrc/{src}",
            replaces=K.REPLACES, launches=path[0][name], max_abs_err=err,
            ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
            library_ms=lib,
            path="predict_p2" if path is p2 else "predict_p1"))
    return records


# ---------------------------------------------------------------------------
# slice 21: K11's backward under a reduced flow.coupling spec, K8's MIXED
# mode, the narrowband GLS fitters' full covariance
# ---------------------------------------------------------------------------
#: the (compute dtype, accumulation) specs of flow.coupling the
#: amortized_reduced path trains 2 steps each under, after the stored run
AMORT_REDUCED_SPECS = tuple((ct, acc) for ct in ("float32", "bfloat16")
                            for acc in ("native", "f64", "two_sum",
                                        "two_prod"))


class _K11BwdSpy:
    """Keep the largest K11 backward call per (accumulation, dtype) while
    installed, copying the operands; counting stays in K11's own
    ``_launch_backward``."""

    def __init__(self, K11):
        self.K11 = K11
        self.orig = K11._launch_backward
        self.calls = {}

    def __enter__(self):
        def spy(a3, b3, g3, ct, acc):
            key = (acc, ct)
            size = a3.numel() + b3.numel() + g3.numel()
            if key not in self.calls or self.calls[key][0] < size:
                self.calls[key] = (size, (a3.clone(), b3.clone(),
                                          g3.clone()))
            return self.orig(a3, b3, g3, ct, acc)

        self.K11._launch_backward = spy
        return self

    def __exit__(self, *exc):
        self.K11._launch_backward = self.orig


def _amortized_reduced_phase(path, kernels, tag, timed_steps):
    """Amortized training under a reduced ``flow.coupling`` spec on ell1,
    from ``ref/amortized_reduced/``: the counts zeroed just before the main
    path (the VI's construction and ``train_flow`` of the stored schedule
    inside ``use_policy(PrecisionPolicy.forced("float32"))``, then 2 steps
    under each of :data:`AMORT_REDUCED_SPECS` forced on flow.coupling
    alone) and read just after.  Bars (the amortized phase's ell1 bars): the ELBO at the
    initial parameters and stored first samples 1e-6 rel and its gradient
    1e-6 of each leaf's largest; the first two steps' ELBO and the whole
    trace 1e-6 rel of the reference's op-by-op run (and of its jitted one,
    printed); the final weights 1e-6 of each leaf's largest; at the stored
    state before the last step the gradient 1e-6 of each leaf's largest
    of the op-by-op gradient there, zeros alike; each spec's 2 steps
    finite.  Then ``timed_steps`` steps at the stored width: steps/s, and
    5 steps under ``torch.profiler``: CUDA kernels and busy share.
    Returns (counts, the K11 backward calls by (accumulation, dtype))."""
    import numpy as np
    import torch

    from pint_torch import precision
    from pint_torch.amortized import TrainConfig, _prng, train_flow
    from pint_torch.amortized.flows import leaves
    from pint_torch.amortized.train import loss_and_grad
    from pint_torch.bridge import read_snapshot
    from pint_torch.kernels import compensated_matmul as K11

    meta, ref = read_snapshot(path)
    A = meta["reference"]["amortized_reduced"]
    P = "ref/amortized_reduced/"
    dev = torch.device("cuda")
    f64 = torch.float64
    flow_kw = dict(n_layers=A["n_layers"], hidden=A["hidden"],
                   seed=A["flow_seed"])
    cfg = TrainConfig(steps=A["steps"], n_samples=A["n_samples"], lr=A["lr"],
                      seed=A["train_seed"])

    def stored(prefix):
        return [ref[k] for k in sorted(k for k in ref
                                       if k.startswith(P + prefix))]

    def leaf_gap(got, prefix):
        return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
                   for g, w in zip(got, stored(prefix)))

    pol = precision.PrecisionPolicy.forced(*A["policy"])
    spec_runs = {}
    with _K11BwdSpy(K11) as spy:
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with precision.use_policy(pol):
            vi, bt = _amortized_vi("bayes", path, meta, ref, flow_kw)
            res = train_flow(vi, cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        for ct, acc in AMORT_REDUCED_SPECS:
            sp = precision.PrecisionPolicy.forced(
                ct, accumulation=acc, segments=("flow.coupling",))
            with precision.use_policy(sp):
                from pint_torch.amortized import AmortizedVI

                vs = AmortizedVI.from_bayesian(bt, **flow_kw)
                r2 = train_flow(vs, TrainConfig(
                    steps=2, n_samples=cfg.n_samples, lr=cfg.lr,
                    seed=cfg.seed))
            spec_runs[(ct, acc)] = (vs.flow.spec.tag(), r2.elbo_trace)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    calls = dict(spy.calls)
    bad = []
    if not (vi.flow.spec.reduced and vi.flow.spec.tag() == A["flow_spec"]):
        bad.append(f"flow.coupling spec {vi.flow.spec.tag()}, not "
                   f"{A['flow_spec']}")
    key, zs = _prng.prng_key(cfg.seed), []
    for _ in range(cfg.steps):
        key, sub = _prng.split(key)
        zs.append(_prng.normal(sub, (cfg.n_samples, vi.ndim)))
    with precision.use_policy(pol):
        init = leaves(vi.flow.init(dev))
        loss0, g0 = loss_and_grad(vi, init, torch.as_tensor(
            zs[0], dtype=f64, device=dev))
        d_e0 = abs(-float(loss0) / A["elbo0"] - 1)
        d_g0 = leaf_gap([-g.cpu().numpy() for g in g0], "grad0/")
        st = [torch.as_tensor(x, dtype=f64, device=dev)
              for x in stored("state/p_")]
        _, g_last = loss_and_grad(vi, st, torch.as_tensor(
            zs[-1], dtype=f64, device=dev))
    g_last = [g.cpu().numpy() for g in g_last]
    d_gl = leaf_gap(g_last, "op_by_op/grad_last/")
    d_gc = leaf_gap(g_last, "grad_last/")
    zeros = all(np.array_equal(g == 0, w == 0) for g, w in zip(
        g_last, stored("op_by_op/grad_last/")))
    gap = np.abs(res.elbo_trace / ref[P + "op_by_op/trace"] - 1)
    gap_c = np.abs(res.elbo_trace / ref[P + "trace"] - 1)
    mine = [x.detach().cpu().numpy() for x in leaves(res.params)]
    d_w = leaf_gap(mine, "op_by_op/final/")
    d_wc = leaf_gap(mine, "final/")
    if not (d_e0 <= AMORT_TRACE_BAR and d_g0 <= AMORT_TRACE_BAR):
        bad.append(f"at (init, z0): ELBO {d_e0:.3e}, gradient {d_g0:.3e}")
    if not (gap[:2].max() <= AMORT_TRACE_BAR and gap.max() <= AMORT_TRACE_BAR
            and d_w <= AMORT_TRACE_BAR):
        bad.append(f"trace {gap.max():.3e}, final weights {d_w:.3e}")
    if not (d_gl <= AMORT_TRACE_BAR and zeros):
        bad.append(f"gradient at the stored state {d_gl:.3e}, zeros alike "
                   f"{zeros}")
    nonfinite = [k for k, (_, tr) in spec_runs.items()
                 if not np.all(np.isfinite(tr))]
    if nonfinite:
        bad.append(f"non-finite ELBO under {nonfinite}")
    print(f"phase amortized_reduced ell1: {vi.ndim}-dim, flow "
          f"{A['n_layers']} x {A['hidden']} under forced {A['policy']} "
          f"(flow.coupling {vi.flow.spec.tag()}); train {cfg.steps} x "
          f"{cfg.n_samples} {train_s:.4f} s; at (init, z0): ELBO {d_e0:.3e}, "
          f"gradient {d_g0:.3e} of each leaf's largest (<= 1e-6); trace "
          f"against the reference's op-by-op run: "
          + ", ".join(f"{g:.1e}" for g in gap)
          + f" (first two <= 1e-6, all <= 1e-6), against its jitted run up "
          f"to {gap_c.max():.3e}; final weights {d_w:.3e} (jitted "
          f"{d_wc:.3e}) of each leaf's largest; at the stored state the "
          f"gradient {d_gl:.3e} of the op-by-op one's leaves (jitted "
          f"{d_gc:.3e}), zeros alike {zeros}; 2 steps under each spec: "
          + ", ".join(f"{t} {tr[-1]:.6e}" for t, tr in spec_runs.values())
          + f"; launches (nonzero) "
          f"{dict((k, v) for k, v in counts.items() if v)} {tag}",
          flush=True)
    if bad:
        raise RuntimeError("amortized_reduced bars failed: " + "; ".join(bad))
    tcfg = TrainConfig(steps=timed_steps, n_samples=cfg.n_samples,
                       lr=cfg.lr, seed=cfg.seed, checkpoint_chunk=timed_steps)
    with precision.use_policy(pol):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_flow(vi, tcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n5, us5, w5 = _profile_cuda(lambda: train_flow(vi, TrainConfig(
            steps=5, n_samples=cfg.n_samples, lr=cfg.lr, seed=cfg.seed)))
    print(f"phase amortized_reduced ell1 timed: {timed_steps} steps "
          f"{wall:.4f} s, {timed_steps / wall:.3f} steps/s; 5 steps under "
          f"torch.profiler: "
          + (f"{n5} CUDA kernels, busy {us5 / 1e6 / w5:.4f} ({us5 / 1e3:.2f} "
             f"ms device of {w5 * 1e3:.2f} ms wall)" if n5 else
             "not measured (no device events)") + f" {tag}", flush=True)
    return counts, calls


def _k11_bwd_library(K11, a3, b3, g3, ct, acc):
    """One PyTorch call a product for the backward's function:
    ``torch.matmul`` of the cotangent with the pre-rounded operands (in
    float32 for native, float64 otherwise; two a cotangent under
    two_prod), then the rounding to the compute dtype."""
    import torch

    F = torch.float64
    at, bt = a3.transpose(1, 2), b3.transpose(1, 2)
    if acc == "native":
        gc = K11.round_to(g3, ct).float()
        ac, bc = K11.round_to(at, ct).float(), K11.round_to(bt, ct).float()
        return lambda: (K11.round_to(torch.matmul(gc, bc), ct),
                        K11.round_to(torch.matmul(ac, gc), ct))
    ah, bh = K11.round_to(at, ct).to(F), K11.round_to(bt, ct).to(F)
    if acc != "two_prod":
        return lambda: (K11.round_to(torch.matmul(g3, bh), ct),
                        K11.round_to(torch.matmul(ah, g3), ct))
    al = K11.round_to(at - ah, ct).to(F)
    bl = K11.round_to(bt - bh, ct).to(F)
    return lambda: tuple(K11.round_to(torch.matmul(x, y), ct) for x, y in (
        (g3, bh), (g3, bl), (ah, g3), (al, g3)))


def _k11_bwd_bound(a3, b3, ct, acc):
    """The backward's least time: a, b and g read once and da, db written
    once over HBM, or its products -- 2 m k n multiply-adds for da and for
    db, twice that under two_prod -- at the float64 tensor cores' rate
    (float32's CUDA cores' or bfloat16's tensor cores' for native)."""
    B, m, k = a3.shape
    n = b3.shape[-1]
    nbytes = 8 * B * (2 * m * k + 2 * k * n + m * n)
    flops = 2.0 * 2.0 * B * m * k * n * (2 if acc == "two_prod" else 1)
    if acc != "native":
        return _bound(nbytes, 0.0, tensor_ops=flops)
    rate = F32_FLOP_PER_S if ct == "float32" else BF16_TC_FLOP_PER_S
    return _bound(nbytes, flops, rate=rate)


def _k11_bwd_kernels(calls, counts, dev, tag) -> list:
    """K11's backward against its plain twin on the card, bitwise, in every
    (accumulation, dtype): on the amortized_reduced path's largest call of
    it (the coupling MLP's (64, in) @ (in, out) products), on seeded flow
    shapes ((64, 2) @ (2, 32), (64, 32) @ (32, 3), (256, 32) @ (32, 32)),
    an off-tile batch, and the serve Gram (4, 512, 4096) @ (4, 4096, 512);
    timed at the path's call and at the serve Gram beside its bound, the
    twin and the library's products.  Returns the kernels-line records
    (measured at the path's call)."""
    import torch

    from pint_torch.kernels import compensated_matmul as K11

    gen = torch.Generator(device=dev).manual_seed(20261102)

    def rnd(*shape, spread=6.0):
        return (torch.rand(*shape, generator=gen, dtype=torch.float64,
                           device=dev) - 0.5) * torch.exp(
            spread * torch.rand(*shape, generator=gen, dtype=torch.float64,
                                device=dev) - spread / 2)

    shapes = ((1, 64, 2, 32), (1, 64, 32, 3), (1, 256, 32, 32),
              (3, 37, 19, 45))
    rand = [(rnd(B, m, k), rnd(B, k, n), rnd(B, m, n))
            for B, m, k, n in shapes]
    gram = (rnd(4, 512, 4096, spread=2.0), rnd(4, 4096, 512, spread=2.0),
            rnd(4, 512, 512, spread=2.0))
    records = []
    for acc in K11.ACCUMULATIONS:
        for ct in ("float32", "bfloat16"):
            name = K11.BWD_KERNELS[(acc, ct)]
            path_call = calls.get((acc, ct), (0, None))[1]
            cases = ([("path", path_call)] if path_call else []) \
                + [(f"{tuple(a.shape)}x{tuple(b.shape)}", (a, b, g))
                   for a, b, g in rand] + [("serve Gram", gram)]
            same, err = True, 0.0
            for _, (a3, b3, g3) in cases:
                dk = K11._launch_backward(a3, b3, g3, ct, acc)
                dr = K11.compensated_matmul_backward_reference(a3, b3, g3,
                                                               ct, acc)
                for x, y in zip(dk, dr):
                    same = same and bool(torch.equal(x, y))
                    err = max(err, float((x - y).abs().max()))
            a3, b3, g3 = path_call if path_call else rand[0]
            ms = _time_ms(lambda: K11._launch_backward(a3, b3, g3, ct, acc),
                          20)
            plain = _time_ms(lambda: K11.compensated_matmul_backward_reference(
                a3, b3, g3, ct, acc), 3, warmup=1)
            lib = _time_ms(_k11_bwd_library(K11, a3, b3, g3, ct, acc), 20)
            bound = _k11_bwd_bound(a3, b3, ct, acc)
            ga, gb, gg = gram
            ms_g = _time_ms(lambda: K11._launch_backward(ga, gb, gg, ct, acc),
                            3, warmup=1)
            plain_g = _time_ms(
                lambda: K11.compensated_matmul_backward_reference(
                    ga, gb, gg, ct, acc), 1, warmup=0)
            lib_g = _time_ms(_k11_bwd_library(K11, ga, gb, gg, ct, acc), 3,
                             warmup=1)
            bound_g = _k11_bwd_bound(ga, gb, ct, acc)
            print(f"phase kernel {name}: bitwise the twin {same} (max|d| "
                  f"{err:.3e}) on "
                  + ", ".join(c for c, _ in cases)
                  + f"; at {tuple(a3.shape)}x{tuple(b3.shape)} kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
                  f"bound {bound[0]:.6f} ms ({bound[1]}); at the serve Gram "
                  f"kernel {ms_g:.4f} ms, plain {plain_g:.4f} ms, library "
                  f"{lib_g:.4f} ms, bound {bound_g[0]:.4f} ms ({bound_g[1]}; "
                  f"share {bound_g[0] / ms_g:.3f}); {counts[name]} launches "
                  f"on the amortized_reduced path {tag}", flush=True)
            if not same:
                raise RuntimeError(f"{name} disagrees with its plain version")
            records.append(dict(
                name=name, route="cuda",
                source="pint_torch/kernels/csrc/compensated_matmul.cu",
                replaces=K11.REPLACES_BWD, launches=counts[name],
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib,
                path="amortized_reduced"))
    return records


def _k8_mixed_ops(table) -> int:
    """float64 instructions per photon of K8's MIXED density over
    ``table``'s primitives (exponential, logarithm, cosine and division at
    their SASS counts, ``SASS_OPS``; every other operation 1): the wrap
    (2); per primitive the norm's product and sum (2) and its pdf --
    Gaussian as GAUSS's peak; two-sided Gaussian 1 + 13 (6 + exp) + 1;
    Lorentzian 2 + cos + 1 + div; two-sided Lorentzian 4 + 13 (6 + div);
    von Mises 4 + cos + exp + div; top hat 6; King 4 + 13 (6 + 2 div +
    log + exp) + div; harmonic 4 + cos."""
    from pint_torch.kernels.photon_lnlike import NWRAP, REC

    im = 2 * NWRAP + 1
    cos = SASS_OPS["cos"]
    per = {0: 3 + im * (4 + _DIV + _EXP) + 2 + _DIV,
           1: 2 + im * (6 + _EXP), 2: 3 + cos + _DIV,
           3: 4 + im * (6 + _DIV), 4: 4 + cos + _EXP + _DIV, 5: 6,
           6: 4 + im * (6 + 2 * _DIV + _LOG + _EXP) + _DIV, 7: 4 + cos}
    codes = [int(c) for c in table[1::REC]]
    return 2 + sum(2 + per[c] for c in codes)


def _photon_mixed_phase(label, path, kernels, tag):
    """K8's MIXED mode on a photon stand-in, from ``ref/photon_mixed/``:
    the mixed template (one of each closed-form primitive, rotated by the
    stored FFTFIT shift) on ``MCMCFitterAnalyticTemplate``, the counts
    zeroed just before ``fit_toas`` and ``get_template_vals`` and read
    just after.  Bars: the route is K8 MIXED; the lnposterior at the
    stored points within :func:`_photon_bars`, -inf where the
    reference's; the density at the stored phases within 1e-12 of the
    sum of |terms| (bg and each norm x pdf) of the reference's; the seeded
    chain from the stored walkers at :func:`_photon_chain_bars`.  Printed:
    steps/s, and ``lnposterior_batch`` at B = nwalkers / 2 rows (the
    median of 5 warm calls) with its CUDA kernels and busy share.
    Returns (counts, capture)."""
    import numpy as np
    import torch

    import pint_torch.templates as PT
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.event_fitter import MCMCFitterAnalyticTemplate
    from pint_torch.sampler import EnsembleSampler

    meta, ref = read_snapshot(path)
    R = meta["reference"]["photon"]
    M = meta["reference"]["photon_mixed"]
    S = R["settings"]
    Pm = "ref/photon_mixed/"
    stored = {"mixed/" + k[len(Pm):]: v for k, v in ref.items()
              if k.startswith(Pm)}
    refm = {"mixed": dict(naccepted=M["naccepted"], maxpost=M["maxpost"])}
    import importlib

    prims = importlib.import_module("pint_torch.templates.lcprimitives")
    tpl = PT.LCTemplate([getattr(prims, c)(list(p), **kw)
                         for c, p, _, kw in M["template"]],
                        [n for _, _, n, _ in M["template"]])
    tpl.rotate(M["shift"])
    cap = Capture(kernels.modules())
    cap.install()
    t_phase = time.perf_counter()
    model, batch = load_snapshot(path, device="cuda")
    f = MCMCFitterAnalyticTemplate(batch, model, tpl,
                                   prior_info=R["prior_info"])
    route = repr(f)
    pts = ref["ref/photon/points"]
    lp = f.lnposterior_batch(pts)
    want = stored["mixed/lnposterior"]
    fin = np.isfinite(want)
    same_inf = bool(np.array_equal(np.isneginf(lp), np.isneginf(want)))
    bars = _photon_bars(f, pts[fin])
    ratio = float(np.max(np.abs(lp[fin] - want[fin]) / bars))
    phases = ref["ref/photon/phases"]
    kernels.reset_counts()
    tv = f.get_template_vals(phases)
    torch.cuda.synchronize()
    tv_counts = kernels.launch_counts()
    norms = tpl.norms()
    scale = np.abs(1.0 - norms.sum()) + sum(
        np.abs(n * np.asarray(p(phases))) for n, p in zip(norms,
                                                          tpl.primitives))
    d_tv = float(np.max(np.abs(tv - stored["mixed/density"]) / scale))
    print(f"phase photon_mixed {label}: N={batch.ntoas} photons, "
          f"{len(tpl.primitives)} primitives ("
          + ", ".join(type(p).__name__ for p in tpl.primitives)
          + f"); {route}; lnposterior at {len(pts)} points max |d| / bar "
          f"{ratio:.3e} (<= 1), -inf where the reference's {same_inf}; "
          f"density at the stored phases max |d| / sum|terms| {d_tv:.3e} "
          f"(<= 1e-12) {tag}", flush=True)
    if not ("K8 photon_lnlike MIXED" in route and same_inf and ratio <= 1.0
            and d_tv <= 1e-12):
        raise RuntimeError(f"photon_mixed bars failed ({label})")
    s = EnsembleSampler(S["nwalkers"], seed=R["seeds"]["sampler"])
    s.decision_log = []
    f.sampler = s
    props = []
    evaluate = f.lnposterior_batch

    def recorded(p, _ev=evaluate):
        props.append(np.array(p))
        return _ev(p)

    f.lnposterior_batch = recorded
    kernels.reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    maxpost = f.fit_toas(maxiter=M["steps"],
                         pos=ref["ref/photon/analytic/pos"].copy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    del f.lnposterior_batch
    cap.remove()
    cb = _photon_chain_bars("mixed", f, stored, props, refm)
    print(f"phase photon_mixed {label} chain: {S['nwalkers']} walkers x "
          f"{M['steps']} steps, fit_toas {wall:.4f} s, "
          f"{M['steps'] / wall:.2f} steps/s, acceptance "
          f"{s.acceptance_fraction:.6f} (reference {M['acceptance']:.6f}), "
          f"maxpost {maxpost:.10f}; {cb['inside']} decision(s) inside the "
          f"margin; first differing decision {cb['diverged']}; walkers "
          f"bitwise over {cb['bitwise_steps']} of {M['steps']} steps; "
          f"launches (nonzero) {dict((k, v) for k, v in counts.items() if v)}"
          f"; get_template_vals "
          f"{dict((k, v) for k, v in tv_counts.items() if v)}; "
          f"{time.perf_counter() - t_phase:.2f} s wall {tag}", flush=True)
    rows = s.get_chain(flat=True)[-(S["nwalkers"] // 2):]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        f.lnposterior_batch(rows)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    n_ev, dev_us, wall_p = _profile_cuda(lambda: f.lnposterior_batch(rows))
    print(f"phase photon_mixed {label} B={len(rows)}: lnposterior_batch "
          f"median of 5 warm {1e3 * float(np.median(times)):.4f} ms; CUDA "
          f"kernels per evaluation (torch.profiler) "
          + (f"{n_ev}, device {dev_us / 1e3:.4f} ms of {wall_p * 1e3:.4f} "
             f"ms wall, busy {dev_us / 1e6 / wall_p:.4f}" if n_ev
             else "not measured (no device events)") + f" {tag}",
          flush=True)
    return {k: counts[k] + tv_counts[k] for k in counts}, cap


def _k8_mixed_kernels(cap, dev, tag) -> list:
    """K8's MIXED instantiations against the plain version on the card: on
    the photon_mixed path's calls (B = 64 walker rows of N = 32768 photons
    and get_template_vals' density), and on edge rows (phases 0, -0.0,
    -1e-17, 1 - 1e-16, each primitive's location and half a cycle off with
    one ulp either side, a NaN row; weights with exact 0s and 1s, and
    none) under the path's table, each primitive alone, and a King of
    gamma 1.2 and a Lorentzian of gamma 0.3: the density bitwise (NaN
    where the plain version's), each row's sum within 1e-12 of its sum of
    |terms|, two launches bitwise; timed on the path's B = 64 rows, their
    phases read from HBM (:func:`_rotated`), beside the bound.  Returns
    the records' (kernel, source, replaces, err, ms, plain_ms, bound)
    tuples."""
    import numpy as np
    import torch

    from pint_torch.kernels import photon_lnlike as K8

    def same(a, b):
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a, nan=0.0),
                                    torch.nan_to_num(b, nan=0.0)))

    a_l = cap.args("photon_lnlike", (K8.MIXED, False))
    a_d = cap.args("photon_lnlike", (K8.MIXED, True))
    tab = a_l[2]
    host = tab.cpu().numpy()
    recs = host[1:].reshape(-1, K8.REC)
    locs = [float(r[1 + {0: 1, 1: 2, 2: 1, 3: 2, 4: 1, 5: 1, 6: 2,
                         7: 0}[int(r[0])]]) for r in recs]
    edge = [0.0, -0.0, -1e-17, 1.0 - 1e-16, 0.5, -0.5]
    for x in locs + [(v + 0.5) % 1.0 for v in locs]:
        edge += [np.nextafter(x, -np.inf), x, np.nextafter(x, np.inf)]
    edge = np.asarray(edge)
    rng = np.random.default_rng(20261103)
    nan_row = rng.uniform(-0.5, 0.5, len(edge))
    nan_row[::5] = np.nan
    frac_e = torch.tensor(np.stack([edge, edge - 1.0, nan_row]),
                          dtype=torch.float64, device=dev)
    w_e = rng.beta(0.5, 1.5, len(edge))
    w_e[::4], w_e[1::4] = 0.0, 1.0
    w_e = torch.tensor(w_e, dtype=torch.float64, device=dev)
    tables = [("path table", tab)]
    for i, r in enumerate(recs):
        one = np.concatenate([[1.0 - r[4]], r])
        tables.append((f"primitive {int(r[0])} alone",
                       torch.tensor(one, dtype=torch.float64, device=dev)))
    from pint_torch.templates import LCTemplate
    from pint_torch.templates.lcprimitives import LCKing, LCLorentzian

    wide = LCTemplate([LCKing([0.05, 1.2, 0.3]), LCLorentzian([0.3, 0.7])],
                      [0.3, 0.3])
    tables.append(("King gamma 1.2, Lorentzian gamma 0.3",
                   torch.tensor(K8.mixed_table(wide), dtype=torch.float64,
                                device=dev)))
    cases = [(f"path B={a_l[0].shape[0]} N={a_l[0].shape[1]}", a_l[0],
              a_l[1], tab), (f"path density {tuple(a_d[0].shape)}",
                             a_d[0], None, a_d[2])]
    for tk, t8 in tables:
        for wk, w in (("weights 0/1", w_e), ("no weights", None)):
            cases.append((f"edges, {tk}, {wk}", frac_e, w, t8))
    ok, err = True, 0.0
    for what, fr, w, t8 in cases:
        dk = K8._launch(fr, w, t8, K8.MIXED, True)
        dr = K8.photon_lnlike_reference(fr, w, t8, K8.MIXED, True)
        lk = K8._launch(fr, w, t8, K8.MIXED, False)
        lr = K8.photon_lnlike_reference(fr, w, t8, K8.MIXED, False)
        again = same(dk, K8._launch(fr, w, t8, K8.MIXED, True)) \
            and same(lk, K8._launch(fr, w, t8, K8.MIXED, False))
        v = dr if w is None else w * dr + (1 - w)
        scale = torch.log(torch.clamp_min(v, 1e-300)).abs().sum(-1)
        fin = torch.isfinite(lr)
        rel = float(((lk - lr).abs()[fin] / scale[fin]).max()) \
            if bool(fin.any()) else 0.0
        dd = (dk - dr).abs()
        if bool(torch.isfinite(dd).any()):
            err = max(err, float(dd[torch.isfinite(dd)].max()))
        bit = same(dk, dr)
        print(f"phase kernel photon_lnlike MIXED {what}: density bitwise "
              f"{bit}, sums max |d| / sum|terms| {rel:.3e} (<= 1e-12), NaN "
              f"rows alike {same(lk[~fin], lr[~fin])}, two launches bitwise "
              f"{again} {tag}", flush=True)
        ok = ok and bit and rel <= 1e-12 and again \
            and same(lk[~fin], lr[~fin])
    if not ok:
        raise RuntimeError("photon_lnlike MIXED disagrees with its plain "
                           "version")
    out = []
    for density in (False, True):
        kernel = K8.KERNELS[(K8.MIXED, density)]
        fr8 = a_l[0][:a_l[0].shape[0] // 2] if a_l[0].shape[0] > 64 \
            else a_l[0]
        w8 = None if density else a_l[1]
        B8, N8 = fr8.shape
        ms = _time_ms(_rotated(K8._launch_terms, fr8, w8, tab, K8.MIXED,
                               density), 10)
        plain = _time_ms(_rotated(K8.photon_lnlike_reference, fr8, w8, tab,
                                  K8.MIXED, density), 2, warmup=1)
        nblk = (N8 + 255) // 256
        nbytes = 8 * B8 * N8 + 8 * tab.shape[0] + (
            8 * B8 * N8 if density else 8 * N8 + 8 * B8 * nblk)
        ops = _k8_mixed_ops(host) + (0 if density else 3 + 1 + _LOG + 1)
        bound = _bound(nbytes, B8 * N8 * ops, rate=F64_INSTR_PER_S)
        print(f"phase kernel {kernel}: photon_j0030 B={B8} N={N8}, "
              f"{len(recs)} primitives; phases from HBM: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
              f"{ops} ops/photon; share {bound[0] / ms:.2f}) {tag}",
              flush=True)
        out.append((kernel, "photon_lnlike.cu", K8.REPLACES, err, ms, plain,
                    bound))
    return out


def _full_cov_phase(path, kernels, tag):
    """The narrowband GLS fitters' full-covariance path on b1855_noise
    (4005 TOAs; the dense N x N covariance of white noise, ECORR and red
    noise through ``torch.linalg.cholesky``), from ``ref/full_cov/``: the
    counts zeroed just before ``GLSFitter.fit_toas(full_cov=True)`` and
    ``DownhillGLSFitter.fit_toas(full_cov=True)`` and read just after.
    Bars (the GLS bars): chi2 1e-6 rel, values 1e-2 sigma, uncertainties
    1e-6 rel, the converged flag the reference's.  Printed: each fit's
    wall s.  Returns the counts."""
    import numpy as np
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.gls_fitter import DownhillGLSFitter, GLSFitter

    meta, ref = read_snapshot(path)
    R = meta["reference"]["full_cov"]
    model, batch = load_snapshot(path, device="cuda")
    counts = {}
    for key, cls, kw in (("gls", GLSFitter,
                          dict(maxiter=R["gls_maxiter"], full_cov=True)),
                         ("downhill", DownhillGLSFitter,
                          dict(full_cov=True))):
        f = cls(batch, model)
        kernels.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        chi2 = f.fit_toas(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for k, v in kernels.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        r = R[key]
        params = r["params"]
        vals = np.array([f.model.value(p) for p in params])
        unc = np.array([f.model[p].uncertainty for p in params])
        sig = ref[f"ref/full_cov/{key}_uncertainties"]
        d_c = abs(chi2 / r["chi2"] - 1)
        d_v = float(np.abs((vals - ref[f"ref/full_cov/{key}_values"])
                           / sig).max())
        d_u = float(np.abs(unc / sig - 1).max())
        ok = (d_c <= 1e-6 and d_v <= 1e-2 and d_u <= 1e-6
              and f.converged == r["converged"]
              and [p for p in f.fitted_params if p != "Offset"] == params)
        print(f"phase full_cov b1855_noise {cls.__name__}: N={batch.ntoas}, "
              f"{len(params)} parameters; chi2 {chi2:.10f} (reference "
              f"{r['chi2']:.10f}, {d_c:.3e} <= 1e-6), values {d_v:.3e} sigma "
              f"(<= 1e-2), uncertainties {d_u:.3e} (<= 1e-6), converged "
              f"{f.converged}; {wall:.4f} s {tag}", flush=True)
        if not ok:
            raise RuntimeError(f"full_cov bars failed ({cls.__name__})")
    return counts


#: the host layer's stages of ``get_model_and_toas``, each timed where it
#: is entered: (label, module, attribute)
FILES_STAGES = (
    ("par parse and model build", "pint_torch.models.model_builder",
     "ModelBuilder.__call__"),
    ("tim read", "pint_torch.toa", "read_tim_file"),
    ("TOA table (MJD parse)", "pint_torch.toa", "TOAs.from_raw"),
    ("validate", "pint_torch.toa", "TOAs.validate"),
    ("clock chain", "pint_torch.toa", "TOAs.apply_clock_corrections"),
    ("TDB", "pint_torch.toa", "TOAs.compute_TDBs"),
    ("posvels", "pint_torch.toa", "TOAs.compute_posvels"))


class _StageTimer:
    """Wall time of each of :data:`FILES_STAGES` while in the context, by
    wrapping the function where the call enters it."""

    def __init__(self, stages=FILES_STAGES):
        self.stages = stages
        self.seconds = {label: 0.0 for label, _, _ in stages}
        self._orig = []

    def __enter__(self):
        import importlib

        for label, mod_name, attr in self.stages:
            owner = importlib.import_module(mod_name)
            *path, name = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            orig = owner.__dict__[name]
            wrap = type(orig) if isinstance(
                orig, (classmethod, staticmethod)) else None
            fn = orig.__func__ if wrap else orig

            def timed(*a, _fn=fn, _label=label, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_label] += time.perf_counter() - t

            self._orig.append((owner, name, orig))
            setattr(owner, name, wrap(timed) if wrap else timed)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._orig):
            setattr(owner, name, orig)


def _files_parity(model, toas, batch, meta, ref) -> dict:
    """The port's reading of a stand-in's files against the reference's
    run on them (``ref/files/``): ``bitwise`` {item: bool} for the parsed
    MJDs, the tim columns, the parameter table, the components' configs,
    the free and design parameters and each stored context; ``gaps``
    {item: max |port - reference|} for the host pipeline's columns (s, s,
    km, km/s) and the batch's fields."""
    import numpy as np

    from pint_torch.dd import dd_from_longdouble

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and bool(np.array_equal(a, b))

    def gap(a, b):
        return float(np.max(np.abs(np.asarray(a, dtype=np.float64)
                                   - np.asarray(b, dtype=np.float64))))

    bit, gaps = {}, {}
    utc = dd_from_longdouble(toas.utc_mjd)
    bit["parsed MJDs"] = same(utc.hi, ref["host/utc_mjd_hi"]) \
        and same(utc.lo, ref["host/utc_mjd_lo"])
    bit["tim columns"] = same(toas.error_us, ref["host/error_us"]) \
        and same(toas.freq_mhz, ref["host/freq_mhz"]) \
        and same(np.asarray(toas.obs).astype(str), ref["host/obs"]) \
        and toas.flags == meta["flags"]
    tdb = dd_from_longdouble(toas.tdb)
    gaps["clock [s]"] = gap(toas.clock_corr_s, ref["host/clock_corr_s"])
    gaps["TDB [s]"] = 86400.0 * max(
        gap(tdb.hi, ref["host/tdb_hi"]),
        float(np.max(np.abs((tdb.hi - ref["host/tdb_hi"])
                            + (tdb.lo - ref["host/tdb_lo"])))))
    gaps["posvels [km]"] = max(
        gap(toas.ssb_obs_pos_km, ref["host/ssb_obs_pos_km"]),
        gap(toas.obs_sun_pos_km, ref["host/obs_sun_pos_km"]))
    gaps["velocity [km/s]"] = gap(toas.ssb_obs_vel_kms,
                                  ref["host/ssb_obs_vel_kms"])
    for k in ("clock_corr_s", "tdb_hi", "tdb_lo", "ssb_obs_pos_km",
              "ssb_obs_vel_kms", "obs_sun_pos_km"):
        col = {"tdb_hi": tdb.hi, "tdb_lo": tdb.lo}.get(k)
        bit[f"host {k}"] = same(getattr(toas, k) if col is None else col,
                                ref[f"host/{k}"])
    table = []
    for p in meta["params"]:
        q = model[p["name"]]
        v = list(q.value) if isinstance(q.value, tuple) else q.value
        table.append(q.component == p["component"] and q.kind == p["kind"]
                     and v == p["value"] and q.frozen == p["frozen"]
                     and q.uncertainty == p["uncertainty"]
                     and q.key == p["key"]
                     and list(q.key_value) == p["key_value"])
    names = [n for c in model.components.values() for n in c.params]
    bit["parameter table"] = all(table) \
        and names == [p["name"] for p in meta["params"]]
    bit["component configs"] = [
        {"class": n, "config": c.config}
        for n, c in model.components.items()] == meta["components"]
    bit["free parameters"] = list(model.free_params) == meta["free_params"]
    bit["design parameters"] = list(model.design_param_names()) \
        == meta["design_params"]
    for k in ("tdb_hi", "tdb_lo", "tdb_s_hi", "tdb_s_lo", "freq", "error_us",
              "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos"):
        part = k.rsplit("_", 1)[-1] if k.startswith("tdb") else None
        mine = getattr(getattr(batch, k.rsplit("_", 1)[0]), part) \
            if part in ("hi", "lo") else getattr(batch, k)
        mine = mine.cpu().numpy()
        gaps[f"batch {k}"] = gap(mine, ref[k])
        bit[f"batch {k}"] = same(mine, ref[k])
    bit["batch tdb0"] = float(batch.tdb0) == float(ref["tdb0"])
    for key, want in ref.items():
        if not key.startswith("ctx/"):
            continue
        _, comp, *sub = key.split("/")
        got = batch.contexts.get(comp, {})
        for s in sub:
            got = got.get(s) if isinstance(got, dict) else None
        if got is None:
            bit[key] = False
            continue
        got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
        bit[key] = same(np.asarray(got, dtype=want.dtype), want)
    return dict(bitwise=bit, gaps=gaps)


def _files_phase(label, path, kernels, tag, device="cuda", grid_every=1):
    """The main path from the stand-in's committed par and tim files, with
    the counts zeroed just before and read just after: the model and host
    TOAs through ``pint_torch.models.get_model_and_toas`` (each host stage
    timed: :data:`FILES_STAGES`), ``to_batch`` onto the card, then the
    residuals, the fits the reference ran on the files (``GLSFitter`` with
    correlated noise, else ``WLSFitter`` and ``DownhillWLSFitter``) and
    the 16 x 16 grid after the first fit, cold and warm.  Fails unless the
    C++ parser ran, unless the parse, the parameter table, the configs and
    the contexts are bitwise the reference's and the host columns within
    the host layer's bars (:func:`_files_parity`), and on any of
    :func:`_bars` against ``ref/files/``.  ``device`` and ``grid_every``
    (every n-th axis value of the grid; 0: no grid) let the CPU tests
    rehearse it.
    Returns (counts, capture)."""
    import numpy as np
    import torch

    from pint_torch import native
    from pint_torch.bridge import files_reference, standin_files
    from pint_torch.fitter import DownhillWLSFitter, WLSFitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.models import get_model_and_toas
    from pint_torch.residuals import Residuals

    meta, ref = files_reference(path)
    rr = meta["reference"]
    par, tim = standin_files(path)
    path_used = native.parser_path()
    if path_used != "native":
        raise RuntimeError("the C++ parser did not build: the files phase "
                           "took the pure-Python path")
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

    with _StageTimer() as timer:
        model, toas = stage("get_model_and_toas", lambda: get_model_and_toas(
            str(par), str(tim), device=device))
    batch = stage("to_batch", lambda: toas.to_batch(device=device,
                                                    model=model))
    resid = stage("residuals", lambda: Residuals(batch, model).time_resids)
    abs_phase = "AbsPhase" in model.components
    phase_int = model.phase(batch, abs_phase=True).int_ if abs_phase \
        else None
    M, _ = stage("designmatrix", lambda: model.designmatrix(batch))
    maxiter = rr["settings"]["fit_maxiter"]
    gls = model.has_correlated_errors
    fitter = (GLSFitter if gls else WLSFitter)(batch, model)
    fits = {"postfit": (fitter, stage("fit_postfit", lambda: fitter.fit_toas(
        maxiter=maxiter)))}
    if not gls:
        d = DownhillWLSFitter(batch, model)
        fits["downhill"] = (d, stage("fit_downhill", d.fit_toas))
    gnames, axes = _grid_of(meta, ref)
    if not grid_every:
        surface = None
    elif grid_every > 1:
        axes = tuple(a[::grid_every] for a in axes)
        ref = dict(ref)
        ref["ref/grid_chi2"] = ref["ref/grid_chi2"][::grid_every,
                                                     ::grid_every]
        ref["ref/grid_rungs"] = ref["ref/grid_rungs"][::grid_every,
                                                      ::grid_every]
        c2 = ref["ref/grid_chi2"]
        rr = dict(rr, grid_argmin=[int(i) for i in np.unravel_index(
            int(np.nanargmin(c2)), c2.shape)])
        meta = dict(meta, reference=rr)
    niter = rr["settings"]["grid_niter"]
    # a thinned grid runs as one chunk of its own points (each point's
    # chi2 does not depend on the chunk)
    chunk = 256 if grid_every == 1 else int(np.prod([len(a) for a in axes]))
    if grid_every:
        surface, _ = stage("grid_cold", lambda: grid_chisq(
            fitter, gnames, axes, niter=niter, chunk=chunk))
        if device == "cuda":  # the warm time is what a card run measures
            surface, _ = stage("grid_warm", lambda: grid_chisq(
                fitter, gnames, axes, niter=niter, chunk=chunk))
    counts = kernels.launch_counts()
    cap.remove()
    parity = _files_parity(model, toas, batch, meta, ref)
    print(f"phase files {label}: {par.name} + {tim.name} -> N="
          f"{batch.ntoas} TOAs, {len(model.components)} components, "
          f"{len(model.free_params)} free; parser {path_used}; host stages "
          + ", ".join(f"{k} {v:.4f} s" for k, v in timer.seconds.items())
          + "; main path " + ", ".join(f"{k} {v:.4f} s"
                                       for k, v in stages.items())
          + f"; launches (nonzero) "
          f"{dict((k, v) for k, v in counts.items() if v)} {tag}",
          flush=True)
    bit, gaps = parity["bitwise"], parity["gaps"]
    print(f"phase files parity {label}: reference round trip through its "
          f"own tim writer bitwise {meta['roundtrip_bitwise']} (differs: "
          f"{meta['roundtrip_differs']}); bars against ref/files/; "
          f"bitwise {sum(bit.values())}/{len(bit)}"
          + (f" (not: {sorted(k for k, v in bit.items() if not v)})"
             if not all(bit.values()) else "")
          + "; gaps " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" {tag}", flush=True)
    must = ("parsed MJDs", "tim columns", "parameter table",
            "component configs", "free parameters", "design parameters")
    bad = [k for k in must if not bit[k]] + [
        k for k in bit if k.startswith("ctx/") and not bit[k]]
    host = (gaps["clock [s]"] <= HOST_CLOCK_BAR_S
            and gaps["TDB [s]"] <= HOST_TDB_BAR_S
            and gaps["posvels [km]"] <= HOST_POS_BAR_KM
            and gaps["velocity [km/s]"] <= HOST_VEL_BAR_KMS)
    if bad or not host:
        raise RuntimeError(f"files parity failed ({label}): {bad}, host "
                           f"columns within their bars {host}")
    _bars(f"files {label}", dict(meta=meta, ref=ref, resid=resid, M=M,
                                 phase_int=phase_int, fitter=fitter,
                                 fits=fits, surface=surface, wide=None,
                                 noise_rounds=[]))
    return counts, cap

TRACKING_RESID_BAR_S = 1e-10
TRACKING_FT_BAR = 1e-6
#: the chi2 an F-test's refit moves, port against reference, as a share of
#: the reference's chi2 of the fit tested against: each package's fits
#: agree to a few 1e-9 of chi2 (PERF.md section 6, PR 24)
TRACKING_DCHI2_BAR = 2e-8


def _tracking_fit_bars(label, f, ref, meta, prefix) -> dict:
    """A fit at the fit bars against the stored one under ``prefix``:
    chi2 1e-6 rel, each value within 1e-2 of the reference's uncertainty,
    uncertainties 1e-6 rel, the converged flag the reference's."""
    import numpy as np

    want = meta[prefix.rstrip("/")]
    names = want["params"]
    if list(f.model.free_params) != names:
        raise RuntimeError(f"tracking {label}: free parameters "
                           f"{f.model.free_params} not {names}")
    sig = ref[prefix + "uncertainties"]
    vals = np.array([f.model.value(p) for p in names])
    unc = np.array([f.model[p].uncertainty for p in names])
    out = dict(chi2=abs(f.chi2 / want["chi2"] - 1),
               values=float(np.max(np.abs(vals - ref[prefix + "values"])
                                   / sig)),
               unc=float(np.max(np.abs(unc / sig - 1))))
    ok = (out["chi2"] <= 1e-6 and out["values"] <= 1e-2
          and out["unc"] <= 1e-6
          and bool(f.converged) == want["converged"])
    if not ok:
        raise RuntimeError(f"tracking {label}: fit bars failed {out}, "
                           f"converged {f.converged} (reference "
                           f"{want['converged']})")
    return out


def _tracking_ftest(label, got, want, base, rbase, remove=False) -> dict:
    """``ftest`` (``base``, ``rbase``: the port's and the reference's
    (chi2, dof) of the fit tested against): the refit's chi2 and rms 1e-6
    rel and its dof exact; the port's p-value ``FTest`` of the port's own
    two fits exactly, and ``FTest`` of the reference's two fits the
    reference's p-value to 1e-6 rel; the chi2 the refit moves (the base's
    less the refit's) within ``TRACKING_DCHI2_BAR`` x the reference's base
    chi2 of the reference's.  That bar is below each case's |chi2 moved|,
    so it holds the refit to moving as the reference's did where the move
    is a small part of chi2 (b1855 adding F2: 4.0e-4 of 3860).  The two
    p-values' gap is recorded: it carries the moved chi2's relative gap
    times the p-value's sensitivity to it.  Returns the gaps."""
    from pint_torch.utils import FTest

    def ft(b, new):
        return FTest(*new, *b) if remove else FTest(*b, *new)

    moved, rmoved = base[0] - got["chi2_test"], rbase[0] - want["chi2_test"]
    at_ref = ft(rbase, (want["chi2_test"], want["dof_test"]))
    out = dict(chi2=abs(got["chi2_test"] / want["chi2_test"] - 1),
               rms=abs(got["resid_rms_test"] / want["resid_rms_test"] - 1),
               ft=abs(got["ft"] / want["ft"] - 1) if want["ft"] else 0.0)
    out["ft of its own fits"] = abs(
        got["ft"] - ft(base, (got["chi2_test"], got["dof_test"])))
    out["ft at the reference's chi2s"] = abs(at_ref / want["ft"] - 1) \
        if want["ft"] else abs(at_ref)
    out["chi2 moved (of chi2)"] = abs(moved - rmoved) / rbase[0]
    out["chi2 moved (rel)"] = abs(moved / rmoved - 1) if rmoved else 0.0
    ok = (out["chi2"] <= TRACKING_FT_BAR and out["rms"] <= TRACKING_FT_BAR
          and got["dof_test"] == want["dof_test"] and base[1] == rbase[1]
          and out["ft of its own fits"] == 0.0
          and out["ft at the reference's chi2s"] <= TRACKING_FT_BAR
          and out["chi2 moved (of chi2)"] <= TRACKING_DCHI2_BAR)
    if not ok:
        raise RuntimeError(f"tracking {label}: ftest {got} against {want}: "
                           f"{out}")
    return out


def _tracking_texts(label, m, t, batch, tmeta, ref_fit, ref) -> dict:
    """The par text in each dialect and ``compare`` line by line the
    reference's (but the creator line), and a model read back from the
    port's text giving bitwise its residuals."""
    import torch

    from pint_torch.models import get_model
    from pint_torch.residuals import Residuals

    for fmt, text in tmeta["parfile"].items():
        if m.as_parfile(format=fmt).splitlines()[1:] \
                != text.splitlines()[1:]:
            raise RuntimeError(f"tracking {label}: as_parfile({fmt}) is not "
                               "the reference's")
    m2 = get_model(m.as_parfile(), device=batch.device)
    want = Residuals(batch, m).time_resids
    got = Residuals(t.to_batch(device=batch.device, model=m2),
                    m2).time_resids
    if not torch.equal(got, want):
        raise RuntimeError(f"tracking {label}: the par text read back "
                           "moves the residuals")
    fitted = m.copy()
    for p, v, u in zip(ref_fit["params"], ref["base/values"],
                       ref["base/uncertainties"]):
        fitted[p].value, fitted[p].uncertainty = float(v), float(u)
    for v, text in tmeta["compare"].items():
        if m.compare(fitted, verbosity=v) != text:
            raise RuntimeError(f"tracking {label}: compare({v}) is not the "
                               "reference's")
    return dict(dialects=len(tmeta["parfile"]), compare=len(tmeta["compare"]))


def _tracking_doctor(label, f, tmeta) -> list:
    """The doctor's TOA, compatibility and robust sections the reference's;
    a degenerate pair whose |correlation| is within 1e-9 of the bar is the
    one difference allowed, and returned."""
    import re

    from pint_torch.integrity.doctor import DEGENERATE_CORR

    got = [ln for ln in f.doctor().splitlines()[2:]
           if not ln.startswith("Last solve:")]
    want = tmeta["doctor"]
    if got == want:
        return []
    pat = re.compile(r"\(\|column corr\| = ([0-9.]+)\)")

    def near(ln):
        mt = pat.search(ln)
        return mt and abs(float(mt.group(1)) - DEGENERATE_CORR) <= 1e-9

    rest_g = [ln for ln in got if not near(ln)
              and not ln.startswith("Model/TOA compatibility")]
    rest_w = [ln for ln in want if not near(ln)
              and not ln.startswith("Model/TOA compatibility")]
    if rest_g != rest_w:
        raise RuntimeError(f"tracking {label}: doctor {got} against {want}")
    return sorted(set(got) ^ set(want))


def _tracking_phase(kernels, tag, device="cuda",
                    only=("ell1", "b1855")) -> tuple:
    """The whole-TOA-set layer on the card from the committed par and tim
    files of ngc, ell1 and b1855 (``get_model_and_toas``), the counts
    zeroed just before and read just after, against the reference's run
    on the same files (``ref/tracking/``): (a) ngc's pulse numbers
    exactly, with F0 off by the stored offset the residuals in each
    ``track_mode`` within 1e-10 s and ``WLSFitter``'s fit at the fit bars
    (the nearest mode's wrapped fit too: values, chi2, converged), the
    columns of ``phase_columns_from_flags`` bitwise; (b) ell1's
    ``BayesianTiming(use_pulse_numbers=True)`` at 64 stored points within
    5e-7 x chi2 and a 32 x 10 ``MCMCFitter`` chain at PR 12's chain bars;
    (c) ``d_phase_d_toa`` on ngc, b1855 and ell1 within max(1e-11 |ref|,
    8 q / (2 h)), q = ulp(F0 max|delay|); (d) ``ftest`` adding F2 (all
    three) and removing FD3 (b1855); (e) the par text in three dialects,
    ``compare`` and the read-back, b1855 with two DMX windows removed and
    ell1 with three WaveX terms added fitted at the fit bars, the jump
    editing's flags and jumps; (f) b1855's first half by MJD selected
    from its batch: ECORR epochs exactly, the GLS fit at the fit bars;
    (g) the preflight: platform, float64 health, the policies; (h) the
    doctor's sections.  Each operation is timed after synchronize.
    ``device`` and ``only`` (the stand-ins to run after ngc) let the CPU
    tests rehearse it.  Returns (counts, capture, timings)."""
    import copy

    import numpy as np
    import torch

    from pint_torch.bayesian import BayesianTiming
    from pint_torch.bridge import (ELL1_PATH, NGC_PATH, STANDIN_PATH,
                                   read_snapshot, standin_files)
    from pint_torch.exceptions import DeviceMismatchError
    from pint_torch.fitter import WLSFitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.mcmc_fitter import MCMCFitter
    from pint_torch.models import get_model_and_toas
    from pint_torch.models.parameter import prefixParameter
    from pint_torch.models.wavex import WaveX
    from pint_torch.residuals import Residuals
    from pint_torch.runtime.preflight import check_device, device_profile
    from pint_torch.sampler import EnsembleSampler

    times = {}

    def timed(name, fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    def stored(path):
        meta, arrays = read_snapshot(path)
        pre = "ref/tracking/"
        return (meta["reference"]["tracking"],
                {k[len(pre):]: v for k, v in arrays.items()
                 if k.startswith(pre)})

    def dphase_gap(label, m, t, want):
        got = timed(f"{label} d_phase_d_toa",
                    lambda: m.d_phase_d_toa(t)).cpu().numpy()
        F0 = m.value("F0")
        q = float(np.spacing(F0 * np.abs(m.delay(t).cpu().numpy()).max()))
        h = 2.0 / F0
        bar = np.maximum(1e-11 * np.abs(want), 8 * q / (2 * h))
        gap = np.abs(got - want)
        if not np.all(gap <= bar):
            raise RuntimeError(f"tracking {label}: d_phase_d_toa gap "
                               f"{gap.max():.3e} Hz over its bar")
        return float((gap / (q / (2 * h))).max())

    # ---- (g) the preflight on the card --------------------------------
    prof = timed("device_profile", lambda: device_profile(refresh=True,
                                                          device=device))
    want_platform = "gpu" if device == "cuda" else "cpu"
    if not (prof.platform == want_platform and prof.f64_native
            and prof.mantissa_bits == 52 and prof.two_sum_error == 0.0):
        raise RuntimeError(f"tracking preflight: {prof}")
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")
        check_device(want_platform, device=device)
    try:
        check_device("tpu", policy="strict", device=device)
    except DeviceMismatchError:
        strict = "raised DeviceMismatchError"
    else:
        raise RuntimeError("check_device('tpu', policy='strict') passed")
    print(f"phase tracking preflight: platform {prof.platform}, kind "
          f"{prof.device_kind}, f64_native {prof.f64_native}, mantissa_bits "
          f"{prof.mantissa_bits}, two_sum_error {prof.two_sum_error}; "
          f"check_device({want_platform!r}) silent, check_device('tpu', "
          f"strict) {strict} {tag}", flush=True)

    cap = Capture(kernels.modules())
    cap.install()
    kernels.reset_counts()
    found = {}

    # ---- (a) phase connection on ngc ------------------------------------
    tmeta, ref = stored(NGC_PATH)
    S = tmeta["settings"]
    par, tim = standin_files(NGC_PATH)
    m, t = timed("ngc get_model_and_toas", lambda: get_model_and_toas(
        str(par), str(tim), device=device))
    pn = timed("ngc compute_pulse_numbers",
               lambda: t.compute_pulse_numbers(m))
    near_half = []
    if not np.array_equal(pn, ref["pn"]):
        ph = m.phase(t, abs_phase=True)
        frac = ph.frac.cpu().numpy()
        bad = np.flatnonzero(pn != ref["pn"])
        near_half = [(int(i), float(frac[i])) for i in bad
                     if abs(abs(frac[i]) - 0.5) <= 1e-9]
        if len(near_half) != len(bad):
            raise RuntimeError("tracking ngc: pulse numbers differ from the "
                               f"reference's at rows {bad.tolist()}")
    mw = m.copy()
    mw["F0"].value = mw.value("F0") + tmeta["df0"]
    batch = t.to_batch(device=device, model=mw)
    gaps = {}
    for mode in ("use_pulse_numbers", "nearest"):
        r = timed(f"ngc residuals {mode}", lambda: Residuals(
            batch, mw, track_mode=mode).time_resids)
        gaps[f"resid {mode}"] = float(np.abs(
            r.cpu().numpy() - ref[f"resid/{mode}"]).max())
        if gaps[f"resid {mode}"] > TRACKING_RESID_BAR_S:
            raise RuntimeError(f"tracking ngc: residuals ({mode}) "
                               f"{gaps[f'resid {mode}']:.3e} s off")
        f = WLSFitter(batch, mw, track_mode=mode)
        timed(f"ngc WLS fit {mode}",
              lambda: f.fit_toas(maxiter=S["fit_maxiter"]))
        found[f"ngc fit {mode}"] = _tracking_fit_bars(
            f"ngc {mode}", f, ref, tmeta, f"fit_{mode}/")
    tf = copy.deepcopy(t)
    for i, fl in enumerate(tf.flags):
        if i != S["pn_missing"]:
            fl["pn"] = repr(float(ref["pn"][i] + (i % S["pn_offset_every"])))
    for i, v in S["padd_rows"]:
        tf.flags[i]["padd"] = v
    tf.phase_columns_from_flags()
    if not (np.array_equal(tf.pulse_number, ref["flags_pn"], equal_nan=True)
            and np.array_equal(tf.delta_pulse_number, ref["flags_dpn"])):
        raise RuntimeError("tracking ngc: phase_columns_from_flags")
    b0 = t.to_batch(device=device, model=m)
    f = WLSFitter(b0, m)
    timed("ngc WLS fit", lambda: f.fit_toas(maxiter=S["fit_maxiter"]))
    found["ngc fit"] = _tracking_fit_bars("ngc", f, ref, tmeta, "base/")
    found["ngc dphase q"] = dphase_gap("ngc", m, t, ref["dphase"])
    ft = timed("ngc ftest add F2", lambda: f.ftest(
        prefixParameter("F2", value=0.0, units="Hz/s^2"), "Spindown",
        full_output=True))
    found["ngc ftest"] = _tracking_ftest(
        "ngc add F2", ft, tmeta["ftest"]["add_F2"],
        (f.resids.chi2, f.resids.dof),
        tuple(tmeta["ftest"]["base"]))
    _tracking_texts("ngc", m, t, b0, tmeta, tmeta["base"], ref)
    found["ngc doctor near-bar lines"] = _tracking_doctor("ngc", f, tmeta)
    print(f"phase tracking ngc: N={t.ntoas}; pulse numbers exact"
          + (f" but {near_half} (|frac| within 1e-9 of 0.5)" if near_half
             else "")
          + f"; F0 + {tmeta['df0']:.6e} Hz ({S['wrap_cycles']} cycles over "
          f"the span); " + ", ".join(f"{k} {v:.3e} s" for k, v in
                                     gaps.items())
          + "; " + "; ".join(f"{k} {v}" for k, v in found.items()
                             if k.startswith("ngc"))
          + f"; flags' columns bitwise {tag}", flush=True)

    if "ell1" not in only:
        return _tracking_done(kernels, cap, times, found, tag)
    # ---- (b) walker rows with pulse numbers on ell1; ell1's edits -------
    tmeta, ref = stored(ELL1_PATH)
    S = tmeta["settings"]
    bz = tmeta["bayes"]
    par, tim = standin_files(ELL1_PATH)
    m, t = timed("ell1 get_model_and_toas", lambda: get_model_and_toas(
        str(par), str(tim), device=device))
    batch = t.to_batch(device=device, model=m)
    f = WLSFitter(batch, m)
    timed("ell1 WLS fit", lambda: f.fit_toas(maxiter=S["fit_maxiter"]))
    found["ell1 fit"] = _tracking_fit_bars("ell1", f, ref, tmeta, "base/")
    info = {p: dict(distr="uniform", pmin=float(lo), pmax=float(hi))
            for p, lo, hi in zip(bz["params"], ref["bayes/pmin"],
                                 ref["bayes/pmax"])}
    bb = copy.copy(batch)
    bt = timed("ell1 BayesianTiming(use_pulse_numbers=True)",
               lambda: BayesianTiming(m, bb, use_pulse_numbers=True,
                                      prior_info=info))
    if not np.array_equal(bb.pulse_number.cpu().numpy(), ref["bayes/pn"]):
        raise RuntimeError("tracking ell1: pulse numbers")
    pts = ref["bayes/points"]
    lp = timed("ell1 lnposterior_batch 64",
               lambda: bt.lnposterior_batch(pts))
    want = ref["bayes/lnposterior"]
    fin = np.isfinite(want)
    if not np.array_equal(np.isfinite(lp), fin):
        raise RuntimeError("tracking ell1: -inf where the reference's not")
    d_lp = float(np.max(np.abs(lp[fin] - want[fin])
                        / ref["bayes/chi2"][fin]))
    if d_lp > LNPOST_BAR:
        raise RuntimeError(f"tracking ell1: lnposterior {d_lp:.3e} of chi2")
    s = EnsembleSampler(bz["nwalkers"], seed=bz["seeds"]["sampler"])
    s.decision_log = []
    fm = MCMCFitter(copy.copy(batch), m, use_pulse_numbers=True,
                    prior_info=info, sampler=s)
    for p, u in zip(bz["params"], ref["base/uncertainties"]):
        fm.model[p].uncertainty = float(u)
    pos = ref["bayes/pos"]
    timed("ell1 MCMCFitter.fit_toas 32 x 10", lambda: fm.fit_toas(
        maxiter=bz["nsteps"], pos=pos.copy()))
    chain = {k[len("bayes/"):]: v for k, v in ref.items()
             if k.startswith("bayes/")}
    cb = _mcmc_chain_bars(chain, bz, fm, pos)
    mx = m.copy()
    mx.add_component(WaveX.template(), validate=False)
    mx["WXEPOCH"].value = mx["PEPOCH"].value
    mx.components["WaveX"].add_wavex_components(
        list(S["wavex_freqs"]), indices=[1, 2, 3], frozens=False)
    fw = WLSFitter(batch, mx)
    timed("ell1 WLS fit after add_wavex_components",
          lambda: fw.fit_toas(maxiter=S["fit_maxiter"]))
    found["ell1 wavex fit"] = _tracking_fit_bars("ell1 wavex", fw, ref,
                                                 tmeta, "wavex/")
    found["ell1 dphase q"] = dphase_gap("ell1", m, t, ref["dphase"])
    ft = timed("ell1 ftest add F2", lambda: f.ftest(
        prefixParameter("F2", value=0.0, units="Hz/s^2"), "Spindown",
        full_output=True))
    found["ell1 ftest"] = _tracking_ftest(
        "ell1 add F2", ft, tmeta["ftest"]["add_F2"],
        (f.resids.chi2, f.resids.dof),
        tuple(tmeta["ftest"]["base"]))
    _tracking_texts("ell1", m, t, batch, tmeta, tmeta["base"], ref)
    print(f"phase tracking ell1: N={t.ntoas}; lnposterior (pulse numbers) "
          f"at {len(pts)} points max|d| {d_lp:.3e} of chi2 (<= "
          f"{LNPOST_BAR:g}); chain {bz['nwalkers']} x {bz['nsteps']}: "
          f"{cb['inside']} decision(s) inside the margin, first differing "
          f"{cb['diverged']}, walkers bitwise over {cb['bitwise_steps']} "
          f"steps; " + "; ".join(f"{k} {v}" for k, v in found.items()
                                if k.startswith("ell1")) + f" {tag}",
          flush=True)

    if "b1855" not in only:
        return _tracking_done(kernels, cap, times, found, tag)
    # ---- b1855: ftest both forms, edits, the ECORR subset, the doctor ---
    tmeta, ref = stored(STANDIN_PATH)
    S = tmeta["settings"]
    par, tim = standin_files(STANDIN_PATH)
    m, t = timed("b1855 get_model_and_toas", lambda: get_model_and_toas(
        str(par), str(tim), device=device))
    batch = t.to_batch(device=device, model=m)
    f = GLSFitter(batch, m)
    timed("b1855 GLS fit", lambda: f.fit_toas(maxiter=S["gls_maxiter"]))
    found["b1855 fit"] = _tracking_fit_bars("b1855", f, ref, tmeta, "base/")
    found["b1855 dphase q"] = dphase_gap("b1855", m, t, ref["dphase"])
    ft = timed("b1855 ftest add F2", lambda: f.ftest(
        prefixParameter("F2", value=0.0, units="Hz/s^2"), "Spindown",
        full_output=True))
    base = (f.resids.chi2, f.resids.dof)
    rbase = tuple(tmeta["ftest"]["base"])
    found["b1855 ftest add"] = _tracking_ftest(
        "b1855 add F2", ft, tmeta["ftest"]["add_F2"], base, rbase)
    ft = timed("b1855 ftest remove", lambda: f.ftest(
        f.model[S["ftest_removed"]], None, remove=True, full_output=True))
    found["b1855 ftest remove"] = _tracking_ftest(
        "b1855 remove", ft, tmeta["ftest"]["remove"], base, rbase,
        remove=True)
    md = m.copy()
    md.components["DispersionDMX"].remove_DMX_range(list(S["dmx_removed"]))
    fd = GLSFitter(batch, md)
    timed("b1855 GLS fit after remove_DMX_range",
          lambda: fd.fit_toas(maxiter=S["gls_maxiter"]))
    found["b1855 dmx fit"] = _tracking_fit_bars("b1855 dmx", fd, ref, tmeta,
                                                "dmx_removed/")
    mj, tj = m.copy(), copy.deepcopy(t)

    def jump_state(step):
        want = tmeta["jumps"][step]
        got = {p: [mj[p].key, list(mj[p].key_value), float(mj[p].value),
                   bool(mj[p].frozen)]
               for p in mj.params if p.startswith("JUMP")}
        if [dict(fl) for fl in tj.flags] != want["flags"] \
                or got != want["jumps"]:
            raise RuntimeError(f"tracking b1855: {step} left other flags "
                               "or jumps than the reference's")

    mj.components["PhaseJump"].jump_params_to_flags(tj)
    jump_state("jump_params_to_flags")
    for i in S["gui_rows"]:
        tj.flags[i]["gui_jump"] = "2"
    mj.jump_flags_to_params(tj)
    jump_state("jump_flags_to_params")
    mj.delete_jump_and_flags(tj, 2)
    jump_state("delete_jump_and_flags")
    mjd = np.asarray(t.get_mjds(), dtype=np.float64)
    keep = mjd < np.median(mjd)
    sub = timed("b1855 select first half", lambda: batch.select(keep, m))
    ecorr = m.components["EcorrNoise"]
    U = np.asarray(ecorr.basis_weight_pair(m, sub)[0])
    epoch = np.where(U.any(axis=1), np.argmax(U != 0, axis=1), -1)
    if not np.array_equal(epoch, ref["subset/ecorr_epoch"]):
        raise RuntimeError("tracking b1855: the subset's ECORR epochs")
    fs = GLSFitter(sub, m)
    timed("b1855 GLS fit of the subset",
          lambda: fs.fit_toas(maxiter=S["gls_maxiter"]))
    found["b1855 subset fit"] = _tracking_fit_bars("b1855 subset", fs, ref,
                                                   tmeta, "subset/")
    _tracking_texts("b1855", m, t, batch, tmeta, tmeta["base"], ref)
    found["b1855 doctor near-bar lines"] = _tracking_doctor("b1855", f,
                                                            tmeta)
    print(f"phase tracking b1855: N={t.ntoas}; subset N={sub.ntoas}, "
          f"{int(epoch.max()) + 1} ECORR epochs exact; jump editing's "
          f"flags and jumps the reference's; "
          + "; ".join(f"{k} {v}" for k, v in found.items()
                      if k.startswith("b1855")) + f" {tag}", flush=True)
    return _tracking_done(kernels, cap, times, found, tag)


def _tracking_done(kernels, cap, times, found, tag) -> tuple:
    """Read the tracking phase's counts, print its times."""
    counts = kernels.launch_counts()
    cap.remove()
    print("phase tracking times: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in times.items()) + f"; launches "
        f"(nonzero) {dict((k, v) for k, v in counts.items() if v)} {tag}",
        flush=True)
    return counts, cap, times


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
                                   WB_PATH, WB_SMALL_PATH,
                                   WB_WHITE_SMALL_PATH, YOUNG_PATH,
                                   YOUNG_SMALL_PATH, PHOTON_PATH,
                                   PHOTON_SMALL_PATH, STREAM_PATH,
                                   STREAM_SMALL_PATH, CATALOG_PATH)
    from pint_torch.kernels import _build
    from pint_torch.kernels import binary_orbits as K6
    from pint_torch.kernels import solar_wind_pl as K7
    from pint_torch.kernels import dd_binary as K2
    from pint_torch.kernels import ell1_binary as K4
    from pint_torch.kernels import schur_cholesky_solve as K3
    from pint_torch.kernels import spin_phase as K1
    from pint_torch.kernels import wls_lstsq as K5
    from pint_torch.kernels import photon_lnlike as K8
    from pint_torch.kernels import chol_rank_update as K9
    from pint_torch.kernels import hd_cross_lnlike as K10
    from pint_torch.kernels import compensated_matmul as K11
    from pint_torch.kernels import polyco_eval as K13
    from pint_torch.kernels import polyco_fit as K14

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
    ptxas += [("photon_lnlike", K8.KERNELS[(m, d)],
               f"photon_{'density' if d else 'lnlike'}_kernelILi{m}EE")
              for m in (K8.BINNED, K8.GAUSS, K8.MIXED)
              for d in (False, True)]
    ptxas += [("photon_lnlike", K8.KERNELS["rowsum"], "photon_lnlike_rowsum")]
    ptxas += [("chol_rank_update", K9.KERNELS[(sm, ing)],
               f"chol_rank_kernelILb{int(sm)}ELb{int(ing)}EE")
              for sm in (True, False) for ing in (False, True)]
    ptxas += [("hd_cross_lnlike", k, k) for k in K10.KERNELS.values()]
    ptxas += [("hd_cross_lnlike", k, k) for k in (
        "hd_cross_inv_left", "hd_cross_colsum", "hd_cross_bins")]
    # K11's forward: native float32 on the CUDA cores, native bfloat16 on
    # its tensor cores, the float64-accumulated modes on the float64 ones,
    # and split-K's second pass
    ptxas += [("compensated_matmul", K11.KERNELS[(acc, ct)],
               ("cm_f32", "cm_bf16")[j] if acc == "native"
               else f"cm_dmmaILi{i}ELi{j}E")
              for i, acc in enumerate(K11.ACCUMULATIONS)
              for j, ct in enumerate(("float32", "bfloat16"))]
    ptxas += [("compensated_matmul", f"{K11.KERNELS[(acc, ct)]} (split-K "
               "pass)", f"cm_reduceILi{i}ELi{j}E")
              for i, acc in enumerate(K11.ACCUMULATIONS)
              for j, ct in enumerate(("float32", "bfloat16"))]
    ptxas += [("compensated_matmul", K11.BWD_KERNELS[(acc, ct)],
               f"compensated_matmul_bwd_kernelILi{i}ELi{j}E")
              for i, acc in enumerate(K11.ACCUMULATIONS)
              for j, ct in enumerate(("float32", "bfloat16"))]
    ptxas += [(n, n, f"{n}_kernel") for n in ("polyco_eval", "polyco_fit")]
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
        + [K7.KERNELS[True]] + [v for k, v in K8.KERNELS.items()
                                if k == "rowsum" or k[0] != K8.MIXED] \
        + list(K9.KERNELS.values()) + list(K10.KERNELS.values()) \
        + list(K13.KERNELS.values()) + list(K14.KERNELS.values())
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

    # ---- the files phase: b1855, ell1 and ngc read from their par and tim
    # files by the port's own reading layer, each with its counts zeroed
    # just before it; the kernels its main path must launch
    for label, path in (("b1855", STANDIN_PATH), ("ell1", ELL1_PATH),
                        ("ngc", NGC_PATH)):
        counts, _ = _files_phase(label, path, kernels, tag)
        missing = [k for k in path_kernels[label] if counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} files "
                               f"phase: {missing}")

    # ---- the mcmc phase: Bayesian timing and the ensemble MCMC -------------
    # each path's counts zeroed just before it; the kernels its walkers'
    # evaluations must launch
    mcmc_kernels = {
        "ell1": (K1.KERNELS[False], K4.KERNELS[(K4.ELL1, False)]),
        "ddgr": (K1.KERNELS[False], K2.KERNELS[(K2.DDGR, False)]),
        "ngc_phoff": (K1.KERNELS[False],),
        "small_wb_white": (K1.KERNELS[False], K7.KERNELS[False])}
    for label, path in (("ell1", ELL1_PATH), ("ddgr", DDGR_PATH),
                        ("ngc_phoff", NGC_PHOFF_PATH),
                        ("small_wb_white", WB_WHITE_SMALL_PATH)):
        counts, cap128 = _mcmc_phase(label, path, kernels, tag,
                                     busy=label == "ell1")
        missing = [k for k in mcmc_kernels[label] if counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} mcmc "
                               f"phase: {missing}")
        paths[f"mcmc_{label}"] = (counts, cap128)
    _mcmc_resume(NGC_PHOFF_PATH, tag)
    from pint_torch.bayesian import BayesianTiming
    from pint_torch.bridge import load_snapshot

    m_gls, b_gls = load_snapshot(STANDIN_PATH, device="cuda")
    box = {p: dict(distr="uniform", pmin=m_gls.value(p) - 1.0,
                   pmax=m_gls.value(p) + 1.0) for p in m_gls.free_params}
    try:
        BayesianTiming(m_gls, b_gls, prior_info=box)
    except NotImplementedError as e:
        print(f"phase mcmc refusal b1855: NotImplementedError: {e} {tag}",
              flush=True)
    else:
        raise RuntimeError("BayesianTiming took b1855's correlated noise")
    del m_gls, b_gls

    # ---- the photon phase: the photon-template fitters ----------------------
    # the counts zeroed just before each fit_toas and get_template_vals:
    # the chains must launch K1's primal and K8's log-likelihood kernels,
    # get_template_vals K8's density kernels
    for label, path in (("small_photon", PHOTON_SMALL_PATH),
                        ("photon_j0030", PHOTON_PATH)):
        counts, tv_counts, cap_ph = _photon_phase(label, path, kernels, tag)
        in_fit = [K1.KERNELS[False], K8.KERNELS["rowsum"]] + [
            K8.KERNELS[(m, False)] for m in (K8.BINNED, K8.GAUSS)]
        in_tv = [K8.KERNELS[(m, True)] for m in (K8.BINNED, K8.GAUSS)]
        missing = [k for k in in_fit if counts[k] == 0] + [
            k for k in in_tv if tv_counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} "
                               f"photon phase: {missing}")
        paths[label] = ({k: counts[k] + tv_counts[k] for k in counts}, cap_ph)
    # K8's MIXED mode: the closed-form primitives' mixture at full width
    counts_m, cap_m = _photon_mixed_phase("photon_j0030", PHOTON_PATH,
                                          kernels, tag)
    want = (K1.KERNELS[False], K8.KERNELS["rowsum"],
            K8.KERNELS[(K8.MIXED, False)], K8.KERNELS[(K8.MIXED, True)])
    missing = [k for k in want if counts_m[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the photon_mixed "
                           f"path: {missing}")
    paths["photon_mixed"] = (counts_m, cap_m)
    # the narrowband GLS fitters' full covariance
    counts_f = _full_cov_phase(NOISE_PATH, kernels, tag)
    missing = [k for k in (*K1.KERNELS.values(), *k2[K2.DD])
               if counts_f[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the full_cov path: "
                           f"{missing}")

    _kepler_phase(KEPLER_PATH, tag)

    # ---- the stream and serve phases: the streaming GLS engine on K9 ---------
    stream_counts, stream_cap, _ = _stream_phase(STREAM_PATH, kernels, tag)
    want = (*K1.KERNELS.values(), K4.KERNELS[(K4.ELL1, False)],
            K4.KERNELS[(K4.ELL1, True)], K9.KERNELS[(True, True)])
    missing = [k for k in want if stream_counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the stream path: "
                           f"{missing}")
    print("phase stream launches: " + ", ".join(
        f"{k} {v}" for k, v in stream_counts.items() if v) + f" {tag}",
        flush=True)
    serve_counts = _serve_phase(STREAM_PATH, STREAM_SMALL_PATH, kernels, tag)
    want = (*K1.KERNELS.values(), K4.KERNELS[(K4.ELL1, False)],
            K4.KERNELS[(K4.ELL1, True)], *k2[K2.DD])
    missing = [k for k in want if serve_counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the serve path: "
                           f"{missing}")

    # ---- the catalogue phase: the PTA catalogue on K10 ----------------------
    cat_counts, cat_jl, cat_bench, cat_pts = _catalog_phase(CATALOG_PATH,
                                                            kernels, tag)
    want = (*K1.KERNELS.values(), *K10.KERNELS.values())
    missing = [k for k in want if cat_counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the catalog path: "
                           f"{missing}")

    # ---- the sweep phase: fused, checkpointed and retried GLS sweeps --------
    t_sweep = time.perf_counter()
    for label, path, k3 in (("b1855", STANDIN_PATH, K3.KERNELS[False]),
                            ("dmx15", DMX15_PATH, K3.KERNELS[True])):
        sweep_counts = _sweep_phase(label, path, kernels, tag)
        missing = [k for k in (*K1.KERNELS.values(), *k2[K2.DD], k3)
                   if sweep_counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} sweep "
                               f"phase: {missing}")
    _sweep_families((("ddk", DDK_PATH), ("bt", BT_SMALL_PATH),
                     ("dds", DDS_SMALL_PATH), ("ddh", DDH_SMALL_PATH),
                     ("small_dd_fbx", DD_FBX_SMALL_PATH),
                     ("small_bt_piecewise", BT_PIECEWISE_SMALL_PATH),
                     ("small_pta", PTA_SMALL_PATH),
                     ("small_wb", WB_SMALL_PATH)), tag)
    _sweep_checkpoint(STANDIN_PATH, tag)
    _sampler_retries(NGC_PHOFF_PATH, tag)
    print(f"phase sweep wall: {time.perf_counter() - t_sweep:.2f} s {tag}",
          flush=True)

    # ---- the precision phase: the precision layer's segments on K11 --------
    prec_counts, k11_calls, _ = _precision_phase(
        {"b1855": STANDIN_PATH, "stream": STREAM_PATH,
         "small_stream": STREAM_SMALL_PATH, "catalog": CATALOG_PATH},
        kernels, tag)
    missing = [k for k in K11.KERNELS.values() if prec_counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the precision path: "
                           f"{missing}")

    # ---- the amortized phase: flows trained on reverse mode ---------------
    # each stand-in's counts zeroed just before it; under autograd the
    # posterior's forward launches the dual kernels, the cross term K12's
    # value-and-gradient sequence (and K10 alone never)
    amort_kernels = {
        "ell1": (K1.KERNELS[True], K4.KERNELS[(K4.ELL1, True)]),
        "ddgr": (K1.KERNELS[True], K2.KERNELS[(K2.DDGR, True)]),
        "pta67_catalog": tuple(K10.GRAD_KERNELS.values())}
    t_amort = time.perf_counter()
    for label, path, kind, timed in (
            ("ell1", ELL1_PATH, "bayes", 150),
            ("ddgr", DDGR_PATH, "bayes", 150),
            ("pta67_catalog", CATALOG_PATH, "catalog", 100)):
        counts_a, cap_a, obj = _amortized_phase(label, path, kind, kernels,
                                                tag, timed)
        missing = [k for k in amort_kernels[label] if counts_a[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} "
                               f"amortized path: {missing}")
        paths[f"amortized_{label}"] = (counts_a, cap_a)
        if kind == "catalog":
            amort_jl = obj
    # under a reduced flow.coupling spec: K11 forward and backward
    counts_r, k11_bwd_calls = _amortized_reduced_phase(ELL1_PATH, kernels,
                                                       tag, 50)
    want = (K1.KERNELS[True], K4.KERNELS[(K4.ELL1, True)],
            *K11.KERNELS.values(), *K11.BWD_KERNELS.values())
    missing = [k for k in want if counts_r[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the amortized_reduced "
                           f"path: {missing}")
    paths["amortized_reduced"] = (counts_r, None)
    print(f"phase amortized wall: {time.perf_counter() - t_amort:.2f} s "
          f"{tag}", flush=True)

    # ---- the predict phase: phase prediction on K13 and K14 ----------------
    # P1's and P2's counts each zeroed just before it and read just after:
    # both must launch K13 and K14, and the phase evaluations K1 (P2 also
    # K2's DD, DDK and DDGR primals and K4's ELL1 primal)
    predict = _predict_phase({"ngc": NGC_PATH, "b1855": STANDIN_PATH,
                              "ell1": ELL1_PATH, "ddk": DDK_PATH,
                              "ddgr": DDGR_PATH}, kernels, tag)
    predict_kernels = {
        "predict_p1": (K1.KERNELS[False], *K13.KERNELS.values(),
                       *K14.KERNELS.values()),
        "predict_p2": (K1.KERNELS[False], *K13.KERNELS.values(),
                       *K14.KERNELS.values(),
                       *(K2.KERNELS[(m, False)] for m in (K2.DD, K2.DDK,
                                                          K2.DDGR)),
                       K4.KERNELS[(K4.ELL1, False)])}
    for label, (counts_p, cap_p) in predict.items():
        missing = [k for k in predict_kernels[label] if counts_p[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} "
                               f"path: {missing}")
        print(f"phase {label} launches: " + ", ".join(
            f"{k} {v}" for k, v in counts_p.items() if v) + f" {tag}",
            flush=True)

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

    # The mcmc phase's primals on the walkers' own rows (B = 128 walker
    # positions, every parameter distinct per row): K1 and K4's ELL1 on
    # ell1's evaluation, K2's DDGR on ddgr's (each row its own ECC and PB,
    # so the Kepler solve stops at a different step in each), K7 on
    # small_wb_white's; each bitwise against its twin, timed beside its
    # bound and recorded with the phase's launches
    def mcmc_args(label, name, key):
        return paths[f"mcmc_{label}"][1].args(name, key)

    a1 = mcmc_args("ell1", "spin_phase", False)
    a4 = mcmc_args("ell1", "ell1_binary", (K4.ELL1, False))
    a2 = mcmc_args("ddgr", "dd_binary", (K2.DDGR, False))
    a7 = mcmc_args("small_wb_white", "solar_wind_pl", False)
    th, _, _, _, dl, F, has_pe, _ = a1
    B1, N1, S1 = dl.shape[0], dl.shape[1], F.shape[1]
    B4, N4w = a4[0].shape
    B2, N2 = a2[0].shape
    _, steps, _ = K2.kepler_steps(a2[0], a2[1])
    st_elem = float(steps.double().mean())
    _, th7, p7, _, w7, _ = a7
    B7, N7 = th7.shape
    inside7 = int((w7 >= 0).sum()) if w7 is not None else N7
    walker_calls = (
        ("ell1", K1.KERNELS[False], "spin_phase.cu", K1.REPLACES,
         lambda: K1._launch(*a1)[:2],
         lambda: K1.spin_phase_reference(*a1)[:2],
         _bound(16 * N1 + 8 * B1 * (2 + S1) + 8 * B1 * N1 * 3,
                B1 * N1 * _k1_ops(S1, has_pe, False), rate=F64_INSTR_PER_S),
         f"B={B1} N={N1} S={S1}"),
        ("ell1", K4.KERNELS[(K4.ELL1, False)], "ell1_binary.cu",
         K4.REPLACES_OF[K4.ELL1], lambda: K4._launch(*a4)[:1],
         lambda: K4.ell1_binary_reference(a4[0], a4[1], K4.ELL1, False)[:1],
         _bound(8 * B4 * N4w + 8 * B4 * a4[1].shape[1] + 8 * B4 * N4w,
                B4 * N4w * _k4_ops(K4.ELL1, False), rate=F64_INSTR_PER_S),
         f"B={B4} N={N4w}"),
        ("ddgr", K2.KERNELS[(K2.DDGR, False)], "dd_binary.cu",
         K2.REPLACES_OF[K2.DDGR], lambda: K2._launch(*a2)[:1],
         lambda: K2.dd_binary_reference(a2[0], a2[1], False, K2.DDGR,
                                        a2[3])[:1],
         _bound(8 * B2 * N2 + 8 * B2 * len(K2.ROW_COLUMNS[K2.DDGR])
                + 8 * B2 * N2, B2 * N2 * _k2_ops(st_elem, False, K2.DDGR),
                rate=F64_INSTR_PER_S),
         f"B={B2} N={N2}, Newton steps per element {st_elem:.4f}, per "
         f"warp (most in the warp) {warp_max_mean(steps, rows=True):.4f}, ECC "
         f"{float(a2[1][:, 5].min()):.12f}-{float(a2[1][:, 5].max()):.12f} "
         f"in {len(torch.unique(a2[1][:, 5]))} distinct rows"),
        ("small_wb_white", K7.KERNELS[False], "solar_wind_pl.cu",
         K7.REPLACES, lambda: K7._launch(*a7)[:1],
         lambda: K7._twin(*a7)[:1],
         _bound(8 * N7 + 8 * B7 * N7 + 16 * B7 * p7.shape[1] + 4 * N7
                + 8 * B7 * N7, B7 * inside7 * K7_OPS[False],
                rate=F64_INSTR_PER_S),
         f"B={B7} N={N7}"))
    for label, kernel, source, replaces, launch, twin, bound, what \
            in walker_calls:
        got, want = launch(), twin()
        same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms = _time_ms(launch, 20)
        plain = _time_ms(twin, 3)
        launches = paths[f"mcmc_{label}"][0][kernel]
        print(f"phase kernel {kernel}: mcmc {label} walker rows {what}; "
              f"bitwise {same}, max|d| {err:.3e} (= 0); kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
              f"share {bound[0] / ms:.2f}); {launches} launches in the mcmc "
              f"phase {tag}", flush=True)
        if not same:
            raise RuntimeError(f"{kernel} disagrees with its plain version on "
                               f"the {label} walkers' rows")
        record(kernel, source, replaces, err, ms, plain, bound,
               path=f"mcmc_{label}")

    for rec in _k8_kernels(paths["photon_j0030"][1], dev, tag):
        record(*rec, path="photon_j0030")
    for rec in _k8_mixed_kernels(paths["photon_mixed"][1], dev, tag):
        record(*rec, path="photon_mixed")

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

    records += _k9_kernels(stream_cap, stream_counts, dev, tag)
    records += _k10_kernels(cat_jl, cat_counts, cat_bench, cat_pts, dev, tag)
    records += _k11_kernels(k11_calls, prec_counts, dev, tag)
    records += _k11_bwd_kernels(k11_bwd_calls, counts_r, dev, tag)
    counts_c, cap_c = paths["amortized_pta67_catalog"]
    records += _k12_kernels(amort_jl, cap_c, counts_c, dev, tag)
    _backward_kernels({k: v[1] for k, v in paths.items()}, dev, tag)
    records += _k13_k14_kernels(predict["predict_p1"],
                                predict["predict_p2"], dev, tag)

    # ---- the tracking phase: the whole-TOA-set layer, after every other
    # phase, its counts zeroed just before it: pulse numbers feed the fits
    # and walker rows through K1's integer output, DD fits after an edit
    # and in ftest's refits run K2, ELL1 walker rows and the WaveX fit K4
    t_track = time.perf_counter()
    track_counts, _, _ = _tracking_phase(kernels, tag)
    track_kernels = (K1.KERNELS[False], K1.KERNELS[True],
                     *k2[K2.DD], K4.KERNELS[(K4.ELL1, False)],
                     K4.KERNELS[(K4.ELL1, True)])
    missing = [k for k in track_kernels if track_counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the tracking phase: "
                           f"{missing}")
    print(f"phase tracking wall: {time.perf_counter() - t_track:.2f} s; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in
                                   track_counts.items() if v) + f" {tag}",
          flush=True)

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
