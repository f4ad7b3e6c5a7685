// K4 ell1_binary: the ELL1 family's binary delay per (point, TOA), with its
// local partials on request.
//
// Replaces pint_tpu/models/binary/engines.py:orbits_pb, mean_anomaly,
// ell1_eps, ell1_roemer_terms, ell1_inverse_delay, ell1_delay,
// ell1k_delay, _h3_fourier_harms and ell1h_delay
// (engines.py:58-65,111-113,355-495) as called by the binary_delay of
// BinaryELL1, BinaryELL1H and BinaryELL1k (components.py:625,693,717):
// orbits and the instantaneous period from PB/PBDOT/XPBDOT, the orbital
// phase from the ascending node, EPS1/EPS2 at the epoch, the
// third-order-in-e Roemer terms (Zhu et al. 2019) and their phase
// derivatives over sin and cos of phi, 2 phi, 3 phi and 4 phi, the
// inverse-timing delay and a Shapiro delay: M2/SINI (ELL1, ELL1k) or the
// orthometric H3 with STIGMA or H4 (ELL1H, Freire & Wex 2010).  One thread
// per (point, TOA).
//
// Parameter row: PB, PBDOT, XPBDOT, A1, A1DOT, EPS1, EPS2, EPS1DOT,
// EPS2DOT, OMDOT, LNEDOT, then M2, SINI (13 values; ELL1, ELL1k) or H3, H4,
// STIGMA (14; ELL1H) -- the reference's units (PB in days, OMDOT in
// deg/yr, LNEDOT in 1/yr, M2 in solar masses, H3 and H4 in s).  ELL1 and
// ELL1H read EPS1DOT/EPS2DOT, ELL1k OMDOT/LNEDOT; the partials of the ones
// a form does not read are 0.  Partials are with respect to ttasc (index
// 0) and the row (1..13 or 1..14).
//
// ORB, a second template parameter, picks the orbits' source: false, PB,
// PBDOT and XPBDOT (orbits_pb); true, two (B, N) inputs more, orbits and
// pbprime, from K6 (binary_orbits.cu: FBX or ORBWAVES orbits,
// components.py:168-193), the orbital phase (orbits - floor(orbits)) 2 pi
// as engines.py:111 forms it.  The orbit-input duals write the partials
// with respect to orbits and pbprime in PB's and PBDOT's places and none
// for XPBDOT; the PB instantiations are the code they were.
//
// Eight instantiations a source: primal and dual of each MODE -- ELL1, ELL1K,
// ELL1H_EXACT, ELL1H_HARMONIC.  ELL1K selects ell1_eps's
// rotating/exponential eccentricity and the first-order Dre; ELL1H_EXACT
// the orthometric Shapiro delay's exact log form, -2 H3 / stigma^3 (log(1
// + stigma^2 - 2 stigma sin phi) + 2 stigma sin phi - stigma^2 cos 2 phi);
// ELL1H_HARMONIC its harmonics 3..nharms, -2 H3 sum_k c_k stigma^(k-3)
// trig(k phi), with stigma = STIGMA or (use_h4) H4/H3, 0 where H3 is 0.
// MODE is a template parameter, not a runtime branch, because the forms
// are different expressions, each bitwise its twin's; nharms and use_h4
// are runtime arguments.  The harmonics' powers of stigma repeat the
// reference's lax.integer_pow products (binary powering: x^3 = x x^2,
// x^4 = (x^2)^2), and each coefficient (-1)^pwr 2 / k is one division, as
// the reference folds it in Python doubles.  The primal runs ell1_forward
// and writes the delay.  The dual runs the same
// ell1_forward -- so its delay is bitwise the primal's -- and then a
// hand-derived reverse sweep: the three Roemer terms are one set of
// harmonics, Dre/a1 = sum_k S_k sin(k phi) + C_k cos(k phi) with S_k, C_k
// polynomials in eps1 and eps2, and Drep and Drepp its phase derivatives,
// so the adjoint of the three is one pass over k = 1..4 that reuses the
// forward pass's sines and cosines.  The plain twin
// (models/binary/engines.py ell1_forward, ell1_partials) repeats both
// passes operation for operation.
//
// The forward pass follows the reference's order of operations to the
// bit: sin and cos of 2 phi, 3 phi and 4 phi are each taken of its own
// rounded argument (no double-angle recurrence, which would change bits),
// each pair from one sincos(), which gives the bits of sin() and cos();
// divisions are divisions (the twin divides tensor by tensor), and
// -fmad=false keeps every product rounded alone.
//
// NaN propagates: a point outside the physical domain (SINI sin(phi) > 1
// making the Shapiro log NaN) poisons its delay; the reverse sweep is
// seeded with NaN where the delay is not finite, so such a point poisons
// all its partials, the ones the form does not read as well.
//
// Bound on this card.  Per element it reads ttasc (8 B) and writes the
// delay (8 B) and, in the dual, 14 or 15 partials (112 or 120 B), against
// the operations counted in chip_smoke.py (K4_FORWARD_OPS,
// K4_REVERSE_OPS, per MODE; a sine, cosine or logarithm counted as 20),
// each add and multiply one instruction under -fmad=false: the primal is
// bound by its operations (five sincos pairs and a log, ~250 arithmetic
// operations), the dual by bytes or operations, near the balance.  There is no loop and no data-dependent work: the
// design keeps everything in registers and launches a 2-D grid
// (blockIdx.y = row), so each block loads its parameter row once, behind
// its threads' ttasc loads, and no thread divides by N; the dual stages its
// partials in shared memory so that each block writes its rows of the
// (B, N, 14) output contiguously.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double TWO_PI = 6.283185307179586;        // 2.0 * math.pi
constexpr double DEG = 0.017453292519943295;        // math.pi / 180.0
constexpr double SEC_PER_YEAR = 31557600.0;         // 365.25 * 86400.0
constexpr double TSUN = 4.925490947000518e-06;      // G Msun / c^3 [s]
constexpr int THREADS = 128;
constexpr int MAX_GRID_Y = 65535;

// The forms (engines.py ELL1, ELL1K, ELL1H_EXACT, ELL1H_HARMONIC).
enum Mode : int { ELL1 = 0, ELL1K = 1, ELL1H_EXACT = 2, ELL1H_HARMONIC = 3 };

template <int MODE, bool ORB = false>
struct Row {
  static constexpr bool ELL1H = MODE == ELL1H_EXACT || MODE == ELL1H_HARMONIC;
  static constexpr int NPAR = ELL1H ? 14 : 13;
  // the reverse sweep's partials: ttasc (0) and the row (1..NPAR); with
  // ORB, 1 and 2 are orbits' and pbprime's and XPBDOT's (3) is not written
  static constexpr int NSWEEP = NPAR + 1;
  static constexpr int NPARTIAL = NSWEEP - (ORB ? 1 : 0);
  __host__ __device__ static constexpr int column(int j) {
    return ORB && j >= 3 ? j + 1 : j;
  }
};

// The forward pass's intermediates that the reverse sweep reads.
struct Fwd {
  double pb_s, pbdot, frac, pbprime, phi, eps1, eps2, omdot, lnedot, scale,
      cw, sw, a1, s[4], c[4], dre, drep, drepp, Dre, Drep, Drepp, nhat, nD,
      nhat2, brI, m2, brace, h3, sig, sig2, sig3, lognum, Q, A, T, delay;
};

// x^y for y >= 0 by lax.integer_pow's products: binary powering.
__device__ __forceinline__ double ipow(double x, int y) {
  if (y == 0) return 1.0;
  double acc = 0.0;
  bool first = true;
  while (y > 0) {
    if (y & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return acc;
}

// (-1)^pwr 2 / k of harmonic k, pwr = (k+1)/2 for odd k and (k+2)/2 for
// even k.
__device__ __forceinline__ double harmonic_coefficient(int k) {
  const int pwr = (k & 1) ? (k + 1) / 2 : (k + 2) / 2;
  return ((pwr & 1) ? -1.0 : 1.0) * 2.0 / (double)k;
}

// trig(k phi) of harmonic k and its phase derivative over k: (sin, cos)
// for odd k, (cos, -sin) for even; sin 3 phi and cos 4 phi are the Roemer
// terms'.  Only the dual asks for the derivative.
template <bool DERIV>
__device__ __forceinline__ void harmonic_basis(const Fwd& f, int k,
                                               double& b, double& db) {
  if (k == 3) {
    b = f.s[2];
    db = f.c[2];
  } else if (k == 4) {
    b = f.c[3];
    db = -f.s[3];
  } else if (!DERIV) {
    b = (k & 1) ? sin((double)k * f.phi) : cos((double)k * f.phi);
  } else {
    double sk, ck;
    sincos((double)k * f.phi, &sk, &ck);
    b = (k & 1) ? sk : ck;
    db = (k & 1) ? ck : -sk;
  }
}

template <int MODE, bool ORB>
__device__ __forceinline__ void ell1_forward(double t, const double* p,
                                             double orb, double pbp,
                                             int nharms, bool use_h4,
                                             Fwd& f) {
  constexpr bool ELL1K_ = MODE == ELL1K;
  // orbits_pb (or the orbit inputs), mean_anomaly
  double orbits;
  if constexpr (ORB) {
    orbits = orb;
    f.pbprime = pbp;
  } else {
    f.pb_s = p[0] * 86400.0;
    f.pbdot = p[1] + p[2];
    f.frac = t / f.pb_s;
    orbits = f.frac - 0.5 * f.pbdot * f.frac * f.frac;
    f.pbprime = f.pb_s + p[1] * t;
  }
  const double phi = (orbits - floor(orbits)) * TWO_PI;
  f.phi = phi;
  // ell1_eps
  if (ELL1K_) {
    f.omdot = p[9] * DEG / SEC_PER_YEAR;
    f.lnedot = p[10] / SEC_PER_YEAR;
    f.scale = 1.0 + f.lnedot * t;
    sincos(f.omdot * t, &f.sw, &f.cw);
    f.eps1 = f.scale * (p[5] * f.cw + p[6] * f.sw);
    f.eps2 = f.scale * (p[6] * f.cw - p[5] * f.sw);
  } else {
    f.eps1 = p[5] + t * p[7];
    f.eps2 = p[6] + t * p[8];
  }
  f.a1 = p[3] + t * p[4];
  // ell1_roemer_terms
  sincos(phi, &f.s[0], &f.c[0]);
  sincos(2.0 * phi, &f.s[1], &f.c[1]);
  sincos(3.0 * phi, &f.s[2], &f.c[2]);
  sincos(4.0 * phi, &f.s[3], &f.c[3]);
  const double s1 = f.s[0], c1 = f.c[0], s2 = f.s[1], c2 = f.c[1],
               s3 = f.s[2], c3 = f.c[2], s4 = f.s[3], c4 = f.c[3];
  const double e1 = f.eps1, e2 = f.eps2;
  const double e1sq = e1 * e1, e2sq = e2 * e2;
  const double e1cu = e1 * e1sq, e2cu = e2 * e2sq;
  if (ELL1K_) {
    f.dre = s1 + 0.5 * (e2 * s2 - e1 * (c2 + 3.0));
  } else {
    f.dre = s1 + 0.5 * (e2 * s2 - e1 * c2) -
            (1.0 / 8.0) * (5.0 * e2sq * s1 - 3.0 * e2sq * s3 -
                           2.0 * e2 * e1 * c1 + 6.0 * e2 * e1 * c3 +
                           3.0 * e1sq * s1 + 3.0 * e1sq * s3) -
            (1.0 / 12.0) * (5.0 * e2cu * s2 + 3.0 * e1sq * e2 * s2 -
                            6.0 * e1 * e2sq * c2 - 4.0 * e1cu * c2 -
                            4.0 * e2cu * s4 + 12.0 * e1sq * e2 * s4 +
                            12.0 * e1 * e2sq * c4 - 4.0 * e1cu * c4);
  }
  f.drep = c1 + e1 * s2 + e2 * c2 -
           (1.0 / 8.0) * (5.0 * e2sq * c1 - 9.0 * e2sq * c3 +
                          2.0 * e1 * e2 * s1 - 18.0 * e1 * e2 * s3 +
                          3.0 * e1sq * c1 + 9.0 * e1sq * c3) -
           (1.0 / 12.0) * (10.0 * e2cu * c2 + 6.0 * e1sq * e2 * c2 +
                           12.0 * e1 * e2sq * s2 + 8.0 * e1cu * s2 -
                           16.0 * e2cu * c4 + 48.0 * e1sq * e2 * c4 -
                           48.0 * e1 * e2sq * s4 + 16.0 * e1cu * s4);
  f.drepp = -s1 + 2.0 * e1 * c2 - 2.0 * e2 * s2 -
            (1.0 / 8.0) * (-5.0 * e2sq * s1 + 27.0 * e2sq * s3 +
                           2.0 * e1 * e2 * c1 - 54.0 * e1 * e2 * c3 -
                           3.0 * e1sq * s1 - 27.0 * e1sq * s3) -
            (1.0 / 12.0) * (-20.0 * e2cu * s2 - 12.0 * e1sq * e2 * s2 +
                            24.0 * e1 * e2sq * c2 + 16.0 * e1cu * c2 +
                            64.0 * e2cu * s4 - 192.0 * e1sq * e2 * s4 -
                            192.0 * e1 * e2sq * c4 + 64.0 * e1cu * c4);
  // ell1_inverse_delay
  f.Dre = f.a1 * f.dre;
  f.Drep = f.a1 * f.drep;
  f.Drepp = f.a1 * f.drepp;
  f.nhat = TWO_PI / f.pbprime;
  f.nD = f.nhat * f.Drep;
  f.nhat2 = f.nhat * f.nhat;
  f.brI = 1.0 - f.nD + f.nD * f.nD + 0.5 * f.nhat2 * f.Dre * f.Drepp;
  const double delayI = f.Dre * f.brI;
  double delayS;
  if constexpr (MODE == ELL1H_EXACT) {
    // ell1h_delay, exact: -2 H3 / stigma^3 (log(lognum) + 2 stigma s1 -
    // stigma^2 c2), lognum = 1 + stigma^2 - 2 stigma s1
    f.h3 = p[11];
    f.sig = p[13];
    f.sig2 = f.sig * f.sig;
    f.sig3 = f.sig2 * f.sig;
    f.lognum = 1.0 + f.sig2 - 2.0 * f.sig * s1;
    f.Q = log(f.lognum) + 2.0 * f.sig * s1 - f.sig2 * c2;
    f.A = -2.0 * f.h3 / f.sig3;
    delayS = f.A * f.Q;
  } else if constexpr (MODE == ELL1H_HARMONIC) {
    // ell1h_delay, harmonics 3..nharms: -2 H3 sum_k c_k stigma^(k-3)
    // trig(k phi)
    f.h3 = p[11];
    f.sig = use_h4 ? (f.h3 == 0.0 ? 0.0 : p[12] / f.h3) : p[13];
    double total = 0.0, b, db;
    for (int k = 3; k <= nharms; ++k) {
      harmonic_basis<false>(f, k, b, db);
      total = total + harmonic_coefficient(k) * ipow(f.sig, k - 3) * b;
    }
    f.T = total;
    delayS = -2.0 * f.h3 * total;
  } else {
    // ell1_delay: M2/SINI Shapiro
    f.m2 = p[11] * TSUN;
    f.brace = 1.0 - p[12] * s1;
    delayS = -2.0 * f.m2 * log(f.brace);
  }
  f.delay = delayI + delayS;
}

// The ELL1H Shapiro delay's partials into P[12] (H3), P[13] (H4), P[14]
// (STIGMA); returns the adjoint of phi.
template <int MODE>
__device__ __forceinline__ double ell1h_reverse(const Fwd& f, double gd,
                                                int nharms, bool use_h4,
                                                double* P) {
  const double zero = gd * 0.0;
  if constexpr (MODE == ELL1H_EXACT) {
    const double s1 = f.s[0], c1 = f.c[0], s2 = f.s[1], c2 = f.c[1];
    P[12] = gd * f.Q * (-2.0 / f.sig3);
    P[13] = zero;
    const double g_Q = gd * f.A;
    const double dQ_dsig =
        (2.0 * f.sig - 2.0 * s1) / f.lognum + 2.0 * s1 - 2.0 * f.sig * c2;
    P[14] = gd * f.Q * (-3.0 * f.A / f.sig) + g_Q * dQ_dsig;
    return g_Q * (-2.0 * f.sig * c1 / f.lognum + 2.0 * f.sig * c1 +
                  2.0 * f.sig2 * s2);
  }
  const double g_T = gd * (-2.0 * f.h3);
  double g_phi = 0.0, dT_dsig = 0.0, b, db;
  for (int k = 3; k <= nharms; ++k) {
    const double ck = harmonic_coefficient(k);
    harmonic_basis<true>(f, k, b, db);
    g_phi = g_phi + ck * (double)k * ipow(f.sig, k - 3) * db;
    if (k > 3)
      dT_dsig = dT_dsig + ck * (double)(k - 3) * ipow(f.sig, k - 4) * b;
  }
  const double g_sig = g_T * dT_dsig;
  P[12] = gd * f.T * -2.0;
  if (use_h4) {
    const bool nz = f.h3 != 0.0;
    const double h3s = nz ? f.h3 : 1.0;
    P[12] = P[12] + (nz ? -g_sig * f.sig / h3s : zero);
    P[13] = nz ? g_sig / h3s : zero;
    P[14] = zero;
  } else {
    P[13] = zero;
    P[14] = g_sig + zero;
  }
  return g_T * g_phi;
}

// Reverse sweep: the partials of f.delay into P (ttasc, then the row; with
// ORB, orbits' and pbprime's in 1 and 2 and 3 unset).
template <int MODE, bool ORB>
__device__ __forceinline__ void ell1_reverse(double t, const double* p,
                                             int nharms, bool use_h4,
                                             const Fwd& f, double* P) {
  constexpr bool ELL1K_ = MODE == ELL1K;
  const double gd = isfinite(f.delay) ? 1.0 : nan("");
  const double s1 = f.s[0], c1 = f.c[0];
  double g_phi;
  if constexpr (Row<MODE>::ELL1H) {
    g_phi = ell1h_reverse<MODE>(f, gd, nharms, use_h4, P);
  } else {
    // delayS = -2 m2 log(brace); brace = 1 - SINI sin(phi)
    P[12] = gd * (-2.0 * log(f.brace)) * TSUN;
    const double g_brace = gd * (-2.0 * f.m2 / f.brace);
    P[13] = -g_brace * s1;
    g_phi = -g_brace * p[12] * c1;
  }
  // delayI = Dre brI; brI = 1 - nD + nD^2 + 0.5 nhat2 Dre Drepp
  const double g_brI = gd * f.Dre;
  const double g_Dre = gd * f.brI + g_brI * 0.5 * f.nhat2 * f.Drepp;
  const double g_Drepp = g_brI * 0.5 * f.nhat2 * f.Dre;
  const double g_nD = g_brI * (2.0 * f.nD - 1.0);
  const double g_nhat =
      g_nD * f.Drep + g_brI * 0.5 * f.Dre * f.Drepp * 2.0 * f.nhat;
  const double g_Drep = g_nD * f.nhat;
  // nhat = 2 pi / pbprime; D* = a1 d*
  const double g_pbprime = -g_nhat * f.nhat / f.pbprime;
  const double g_a1 = g_Dre * f.dre + g_Drep * f.drep + g_Drepp * f.drepp;
  const double g_re = g_Dre * f.a1, g_rep = g_Drep * f.a1,
               g_repp = g_Drepp * f.a1;
  // the Roemer terms as harmonics: (S, C, dS/de1, dC/de1, dS/de2, dC/de2)
  const double e1 = f.eps1, e2 = f.eps2;
  const double e1sq = e1 * e1, e2sq = e2 * e2, e1e2 = e1 * e2;
  const double co[4][6] = {
      {1.0 - 0.125 * (5.0 * e2sq + 3.0 * e1sq), 0.25 * e1e2, -0.75 * e1,
       0.25 * e2, -1.25 * e2, 0.25 * e1},
      {0.5 * e2 - (5.0 * e2sq + 3.0 * e1sq) * e2 / 12.0,
       -0.5 * e1 + (6.0 * e2sq + 4.0 * e1sq) * e1 / 12.0, -0.5 * e1e2,
       -0.5 + 0.5 * e2sq + e1sq, 0.5 - (15.0 * e2sq + 3.0 * e1sq) / 12.0,
       e1e2},
      {0.375 * (e2sq - e1sq), -0.75 * e1e2, -0.75 * e1, -0.75 * e2,
       0.75 * e2, -0.75 * e1},
      {(e2sq / 3.0 - e1sq) * e2, (e1sq / 3.0 - e2sq) * e1, -2.0 * e1e2,
       e1sq - e2sq, e2sq - e1sq, -2.0 * e1e2}};
  double g_e1 = 0.0, g_e2 = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double k = (double)(i + 1);
    const double sk = f.s[i], ck = f.c[i];
    const double al = ELL1K_ ? -(k * k) * g_repp : g_re - (k * k) * g_repp;
    const double be = k * g_rep;
    const double a = al * co[i][0] - be * co[i][1];
    const double b = al * co[i][1] + be * co[i][0];
    g_phi = g_phi + k * (a * ck - b * sk);
    g_e1 = g_e1 + sk * (al * co[i][2] - be * co[i][3]) +
           ck * (al * co[i][3] + be * co[i][2]);
    g_e2 = g_e2 + sk * (al * co[i][4] - be * co[i][5]) +
           ck * (al * co[i][5] + be * co[i][4]);
  }
  if (ELL1K_) {
    // first-order Dre = s1 + 0.5 (e2 s2 - e1 (c2 + 3))
    const double s2 = f.s[1], c2 = f.c[1];
    g_phi = g_phi + g_re * (c1 + e2 * c2 + e1 * s2);
    g_e1 = g_e1 + g_re * (-0.5 * c2 - 1.5);
    g_e2 = g_e2 + g_re * (0.5 * s2);
  }
  // eps1, eps2; a1 = A1 + t A1DOT
  const double zero = gd * 0.0;
  double g_t = g_a1 * p[4];
  if (ELL1K_) {
    const double E1 = p[5], E2 = p[6];
    const double g_scale = g_e1 * (E1 * f.cw + E2 * f.sw) +
                           g_e2 * (E2 * f.cw - E1 * f.sw);
    P[6] = f.scale * (g_e1 * f.cw - g_e2 * f.sw);
    P[7] = f.scale * (g_e1 * f.sw + g_e2 * f.cw);
    const double g_c = f.scale * (g_e1 * E1 + g_e2 * E2);
    const double g_s = f.scale * (g_e1 * E2 - g_e2 * E1);
    const double g_th = g_s * f.cw - g_c * f.sw;
    P[8] = zero;
    P[9] = zero;
    P[10] = g_th * t * (DEG / SEC_PER_YEAR);
    P[11] = g_scale * t / SEC_PER_YEAR;
    g_t = g_t + g_th * f.omdot + g_scale * f.lnedot;
  } else {
    P[6] = g_e1;
    P[7] = g_e2;
    P[8] = g_e1 * t;
    P[9] = g_e2 * t;
    P[10] = zero;
    P[11] = zero;
    g_t = g_t + g_e1 * p[7] + g_e2 * p[8];
  }
  P[4] = g_a1;
  P[5] = g_a1 * t;
  // phi = (orbits - floor) 2 pi; orbits = frac - 0.5 pbdot frac^2;
  // frac = t / pb_s; pbprime = pb_s + PBDOT t; pb_s = PB 86400
  const double g_orb = g_phi * TWO_PI;
  if constexpr (ORB) {
    P[1] = g_orb;
    P[2] = g_pbprime;
    P[0] = g_t;
  } else {
    const double g_frac = g_orb * (1.0 - f.pbdot * f.frac);
    const double g_pbdot = -g_orb * 0.5 * f.frac * f.frac;
    const double g_pbs = g_pbprime - g_frac * f.frac / f.pb_s;
    P[1] = g_pbs * 86400.0;
    P[2] = g_pbdot + g_pbprime * t;
    P[3] = g_pbdot;
    P[0] = g_frac / f.pb_s + g_pbprime * p[1] + g_t;
  }
}

// One block covers THREADS TOAs of one row b = b0 + blockIdx.y, so the
// parameter row is loaded once per block and no thread divides by N.  Each
// thread's ttasc is loaded before the barrier, so that its latency overlaps
// the row's.
template <int MODE, bool ORB>
__global__ void ell1_binary_primal(const double* __restrict__ ttasc,
                                   const double* __restrict__ params,
                                   const double* __restrict__ orb,
                                   const double* __restrict__ pbp, int b0,
                                   int N, int nharms, int use_h4,
                                   double* __restrict__ delay) {
  constexpr int NPAR = Row<MODE>::NPAR;
  __shared__ double row[NPAR];
  const long b = (long)b0 + blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const long idx = b * N + n;
  const double t = n < N ? ttasc[idx] : 0.0;
  double o = 0.0, pb = 0.0;
  if constexpr (ORB) {
    if (n < N) {
      o = orb[idx];
      pb = pbp[idx];
    }
  }
  if (threadIdx.x < NPAR) row[threadIdx.x] = params[b * NPAR + threadIdx.x];
  __syncthreads();
  if (n >= N) return;
  double p[NPAR];
#pragma unroll
  for (int i = 0; i < NPAR; ++i) p[i] = row[i];
  Fwd f;
  ell1_forward<MODE, ORB>(t, p, o, pb, nharms, use_h4 != 0, f);
  delay[idx] = f.delay;
}

// The same 2-D grid; the block's partials go through shared memory so that
// its run of the (B, N, NPARTIAL) output is written contiguously (one
// thread's values are 8 NPARTIAL B apart from the next thread's).
template <int MODE, bool ORB>
__global__ void ell1_binary_dual(const double* __restrict__ ttasc,
                                 const double* __restrict__ params,
                                 const double* __restrict__ orb,
                                 const double* __restrict__ pbp, int b0,
                                 int N, int nharms, int use_h4,
                                 double* __restrict__ delay,
                                 double* __restrict__ partials) {
  constexpr int NPAR = Row<MODE>::NPAR;
  constexpr int NPARTIAL = Row<MODE, ORB>::NPARTIAL;
  __shared__ double row[NPAR];
  __shared__ double rows[THREADS * NPARTIAL];
  const long b = (long)b0 + blockIdx.y;
  const int n0 = blockIdx.x * THREADS;
  const int n = n0 + threadIdx.x;
  const long idx = b * N + n;
  const double t = n < N ? ttasc[idx] : 0.0;
  double o = 0.0, pb = 0.0;
  if constexpr (ORB) {
    if (n < N) {
      o = orb[idx];
      pb = pbp[idx];
    }
  }
  if (threadIdx.x < NPAR) row[threadIdx.x] = params[b * NPAR + threadIdx.x];
  __syncthreads();
  if (n < N) {
    double p[NPAR];
#pragma unroll
    for (int i = 0; i < NPAR; ++i) p[i] = row[i];
    Fwd f;
    ell1_forward<MODE, ORB>(t, p, o, pb, nharms, use_h4 != 0, f);
    double P[Row<MODE, ORB>::NSWEEP];
    ell1_reverse<MODE, ORB>(t, p, nharms, use_h4 != 0, f, P);
    delay[idx] = f.delay;
#pragma unroll
    for (int i = 0; i < NPARTIAL; ++i)
      rows[threadIdx.x * NPARTIAL + i] = P[Row<MODE, ORB>::column(i)];
  }
  __syncthreads();
  const int cnt = (N - n0 < THREADS ? N - n0 : THREADS) * NPARTIAL;
  double* out = partials + (b * N + n0) * NPARTIAL;
  for (int e = threadIdx.x; e < cnt; e += THREADS) out[e] = rows[e];
}

template <int MODE, bool ORB>
void launch_orb(const double* ttasc, const double* params, const double* orb,
                const double* pbp, int B, int N, int nharms, int use_h4,
                double* delay, double* partials, cudaStream_t st) {
  const unsigned nx = (unsigned)((N + THREADS - 1) / THREADS);
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const unsigned ny = (unsigned)(B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y);
    if (partials == nullptr)
      ell1_binary_primal<MODE, ORB><<<dim3(nx, ny), THREADS, 0, st>>>(
          ttasc, params, orb, pbp, b0, N, nharms, use_h4, delay);
    else
      ell1_binary_dual<MODE, ORB><<<dim3(nx, ny), THREADS, 0, st>>>(
          ttasc, params, orb, pbp, b0, N, nharms, use_h4, delay, partials);
  }
}

template <int MODE>
void launch(const double* ttasc, const double* params, const double* orb,
            const double* pbp, int B, int N, int nharms, int use_h4,
            double* delay, double* partials, cudaStream_t st) {
  if (orb == nullptr)
    launch_orb<MODE, false>(ttasc, params, orb, pbp, B, N, nharms, use_h4,
                            delay, partials, st);
  else
    launch_orb<MODE, true>(ttasc, params, orb, pbp, B, N, nharms, use_h4,
                           delay, partials, st);
}

}  // namespace

extern "C" int ell1_binary_launch(const double* ttasc, const double* params,
                                  const double* orb, const double* pbp,
                                  int B, int N, int mode, int nharms,
                                  int use_h4, double* delay,
                                  double* partials, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long)B * N == 0) return 0;
  if ((orb == nullptr) != (pbp == nullptr)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case ELL1:
      launch<ELL1>(ttasc, params, orb, pbp, B, N, nharms, use_h4, delay,
                   partials, st);
      break;
    case ELL1K:
      launch<ELL1K>(ttasc, params, orb, pbp, B, N, nharms, use_h4, delay,
                    partials, st);
      break;
    case ELL1H_EXACT:
      launch<ELL1H_EXACT>(ttasc, params, orb, pbp, B, N, nharms, use_h4,
                          delay, partials, st);
      break;
    case ELL1H_HARMONIC:
      launch<ELL1H_HARMONIC>(ttasc, params, orb, pbp, B, N, nharms, use_h4,
                             delay, partials, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ell1_binary_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
