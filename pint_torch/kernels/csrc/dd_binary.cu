// K2 dd_binary: the DD family's binary delay per (point, TOA), with its
// local partials on request.
//
// Replaces pint_tpu/models/binary/engines.py:orbits_pb, solve_kepler,
// dd_state and dd_delay_core (engines.py:38-226) as called by
// BinaryDD.delay_func (components.py:195-205 and :458-475): orbits and the
// instantaneous period from PB/PBDOT/XPBDOT, the mean anomaly, 15 clamped
// Newton steps of Kepler's equation, the true anomaly and periastron
// advance, then the inverse-timing Roemer/Einstein delay, the Shapiro delay
// and the A0/B0 aberration.  One thread per (point, TOA).
//
// Parameter row (16 values): PB, PBDOT, XPBDOT, A1, A1DOT, ECC, EDOT, OM,
// OMDOT, M2, SINI, GAMMA, DR, DTH, A0, B0 -- the reference's units (PB in
// days, OM in degrees, OMDOT in deg/yr, M2 in solar masses).  Partials are
// with respect to tt0 (index 0) and the 16 parameters (1..16).
//
// MODE, a template parameter, picks the family member (the forms differ
// in which inputs they read, so each gets its own instantiation and no
// runtime branch; DDS and DDH are DD on a reparameterized row):
//   DD   -- as above (engines.py:185 dd_delay_core via :216 dd_delay);
//   BT   -- engines.py:135 bt_delay: (L1 + L2) R on Kepler's E with
//           omega = OM + OMDOT t and R from the constant PB; it reads PB,
//           PBDOT, XPBDOT, A1, A1DOT, ECC, EDOT, OM, OMDOT and GAMMA and
//           has its own forward pass and reverse sweep (bt_forward,
//           bt_reverse); its dual writes 11 partials, tt0's and those of
//           the 10 entries it reads;
//   DDGR -- engines.py:266 ddgr_delay: the row holds the GR-derived k,
//           the companion mass in seconds and the semi-major axis ar in
//           place of OMDOT, M2 and SINI (PBDOT already holds the GR orbital
//           decay); sini = a1 / ar per TOA, one division as the reference
//           divides;
//   DDK  -- engines.py:338 ddk_delay: three (B, N) inputs more, Kopeikin's
//           d_a1 and d_om and sin(kin), added to a1 and to omega after
//           k nu and used as sini; its dual writes 19 partials: tt0's,
//           the row's but the unread SINI's, then d_a1's, d_om's and
//           sini's;
//   BTX  -- BT with a (B, N) a1 in place of the row's A1: the piecewise
//           BT (components.py:721-790), its a1 formed per TOA as the
//           reference forms it and handed in through d_a1; its dual writes
//           BT's 11 partials with the per-TOA a1's last, in A1's place.
//
// ORB, a second template parameter, picks the orbits' source: false, PB,
// PBDOT and XPBDOT as above (orbits_pb); true, two (B, N) inputs more,
// orbits and pbprime, from K6 (binary_orbits.cu: FBX or ORBWAVES orbits,
// components.py:168-193), of which the mean anomaly is (orbits -
// floor(orbits)) 2 pi as engines.py:111 forms it.  The orbit-input duals
// write the partials with respect to orbits and pbprime in PB's and
// PBDOT's places and none for XPBDOT; the PB instantiations are the code
// they were.
// A partial of a row entry the mode does not read would be a column of
// zeros, so it is not written (Mode<MODE>::column maps the output's
// columns onto the reverse sweep's).
//
// Two instantiations a mode.  dd_binary_primal<MODE> runs the forward pass
// and writes the delay.  dd_binary_dual<MODE> (the partials) runs the same
// forward pass -- so its delay is bitwise the primal's -- and then a
// hand-derived reverse sweep: the delay is one scalar of 17 inputs, so its
// gradient costs one adjoint pass over the ~40 intermediates dd_forward
// keeps, instead of a 17-wide dual number carried through every operation.
// Kepler's equation is not differentiated through its iterations: at the
// root E - e sin E = M the implicit function theorem gives
// dE = (dM + sin E de) / (1 - e cos E), which equals the derivative
// through 15 converged Newton steps to rounding (solve_kepler: below 1e-15
// for e <= 0.95).  The plain twin (kernels/dd_binary.py,
// models/binary/engines.py) repeats both passes operation for operation.
//
// NaN propagates: the Newton clamp is written as comparisons that keep NaN,
// so a point outside the physical domain (SINI > 1 making the Shapiro log
// negative) poisons its delay instead of returning a number; the reverse
// sweep is seeded with NaN where the delay is not finite, so such a point
// poisons every partial as well.
//
// Kepler's equation stops early without changing a bit.  The reference
// runs a fixed 15 clamped Newton steps, but the step is a function of its
// iterate's bits alone, so once an iterate repeats the rest of the 15 is
// known: an iterate equal to the one before is a fixed point (the result),
// and one equal to the one two steps back is a 2-cycle, whose step 15 lands
// on one of the pair by the parity of the steps left.  The kernel stops
// there, so E is bitwise the 15-step result (kernels/dd_binary.py
// kepler_exit emulates the rule in plain PyTorch).  Near-circular orbits
// repeat after 2-3 steps; at e >= 0.6 a few elements still run all 15.
//
// Bound on this card.  Per element it reads tt0 (8 B; DDK 32 B) and writes
// the delay (8 B) and, in the dual, 17 partials (136 B; BT 11, 88 B; DDK
// 19, 152 B),
// against the operations counted in chip_smoke.py (K2_FORWARD_OPS,
// K2_NEWTON_OPS per step, K2_REVERSE_OPS, and per mode; a sine, cosine,
// arctangent, logarithm or square root counted as 20): the primal is bound
// by operations and the dual by bytes.  What holds both above their bounds
// is latency: the Newton steps are a chain of dependent sine/cosine pairs
// and divisions, and the dual's registers (~140 a thread) leave fewer warps
// to hide it.  The design shortens that chain -- the exit above, and each
// same-argument sine and cosine from one sincos(), which shares the range
// reduction and gives the bits of sin() and cos() that the twin calls
// apart (chip_smoke.py holds the delay bitwise against it) -- and keeps
// everything in registers (0 spill bytes in the primals).  The primal runs
// on a 2-D grid (blockIdx.y = row), so each block loads its parameter row
// once, behind its threads' tt0 loads, and no thread divides by N; the
// dual keeps one thread per element on a 1-D grid and stages its partials
// in shared memory so that each block writes its rows of the output
// contiguously.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double TWO_PI = 6.283185307179586;        // 2.0 * math.pi
constexpr double DEG = 0.017453292519943295;        // math.pi / 180.0
constexpr double SEC_PER_YEAR = 31557600.0;         // 365.25 * 86400.0
constexpr double TSUN = 4.925490947000518e-06;      // G Msun / c^3 [s]
constexpr int NPAR = 16;
constexpr int THREADS = 128;
constexpr int MAX_GRID_Y = 65535;

// The family's forms (engines.py DD, BT, DDGR, DDK).
enum : int { DD = 0, BT = 1, DDGR = 2, DDK = 3, BTX = 4 };

template <int MODE, bool ORB>
struct Mode {
  // the reverse sweep's partials: tt0 (0), the row (1..16) and DDK's three
  // per-TOA inputs (17..19); with ORB, 1 and 2 are orbits' and pbprime's
  static constexpr int NSWEEP = NPAR + 1 + (MODE == DDK ? 3 : 0);
  // the partials written: all of the sweep's but those of the row entries
  // the mode does not read (BT, BTX: M2, SINI, DR, DTH, A0, B0; DDK: SINI;
  // with ORB: XPBDOT)
  static constexpr int NPARTIAL =
      (MODE == BT || MODE == BTX ? 11 : (MODE == DDK ? NSWEEP - 1 : NSWEEP)) -
      (ORB ? 1 : 0);
  // the sweep's index of written column j on PB orbits
  __host__ __device__ static constexpr int pb_column(int j) {
    return MODE == BT    ? (j < 10 ? j : 12)
           : MODE == BTX ? (j < 4 ? j : (j < 9 ? j + 1 : (j == 9 ? 12 : 4)))
           : MODE == DDK ? (j < 11 ? j : j + 1)
                         : j;
  }
  // the sweep's index of written column j
  __host__ __device__ static constexpr int column(int j) {
    return ORB ? (j < 3 ? j : pb_column(j + 1)) : pb_column(j);
  }
};

// Per-TOA inputs: DDK's three (BTX's a1 in d_a1) and the orbit inputs
// (zeros where the instantiation does not read them).
struct Toa {
  double d_a1, d_om, sini, orb, pbp;
};

// The DD forward pass's intermediates that the reverse sweep reads.
struct Fwd {
  double pb_s, pbdot, frac, pbprime, e, sinE, cosE, sE2, cE2, sq1p, sq1m,
      yv, xv, nu, k, nu_cont, omega, a1, m2_tsun, sini, er, eth, so, co,
      alpha, q, beta, bg, Dre, Drep, Drepp, den, nhat, nD, nhat2, T, brI, r1,
      inner, brace, sopn, copn, delay;
};

// BT's.
struct BtFwd {
  double pb_s, pbdot, frac, e, sinE, cosE, a1, omdot, so, co, alpha, sq,
      beta, bg, L, num, den, w, q, R, delay;
};

__device__ __forceinline__ double clip1(double x) {
  return x < -1.0 ? -1.0 : (x > 1.0 ? 1.0 : x);  // keeps NaN
}

// solve_kepler: 15 clamped Newton steps, left once the iterate repeats
// (see the head of this file): E_{n+1} equal to E_n is a fixed point,
// equal to E_{n-1} a 2-cycle whose step 15 is E_{n+1} or E_n by the parity
// of the steps left.  Bits, not ==, are compared, so -0 and +0 (and NaN)
// stay apart.
__device__ __forceinline__ double kepler(double M, double e) {
  double E = M + e * sin(M);
  long long before = 0;  // bits of E_{n-1}, from the second step on
  for (int it = 0; it < 15; ++it) {
    double sE, cE;
    sincos(E, &sE, &cE);
    const double dE = (E - e * sE - M) / (1.0 - e * cE);
    const double En = E - clip1(dE);
    const long long bn = __double_as_longlong(En);
    const long long bE = __double_as_longlong(E);
    if (bn == bE) break;
    if (it > 0 && bn == before) {
      if (((14 - it) & 1) == 0) E = En;
      break;
    }
    before = bE;
    E = En;
  }
  return E;
}

template <int MODE, bool ORB>
__device__ __forceinline__ void dd_forward(double t, const double* p,
                                           const Toa& x, Fwd& f) {
  // orbits_pb (or the orbit inputs), mean_anomaly, ecc_at
  double orbits;
  if constexpr (ORB) {
    orbits = x.orb;
    f.pbprime = x.pbp;
  } else {
    f.pb_s = p[0] * 86400.0;
    f.pbdot = p[1] + p[2];
    f.frac = t / f.pb_s;
    orbits = f.frac - 0.5 * f.pbdot * f.frac * f.frac;
    f.pbprime = f.pb_s + p[1] * t;
  }
  const double fl = floor(orbits);
  const double M = (orbits - fl) * TWO_PI;
  const double e = p[5] + t * p[6];
  f.e = e;
  const double E = kepler(M, e);
  sincos(E, &f.sinE, &f.cosE);
  // dd_state: true anomaly and periastron advance (DDGR: the row's k)
  sincos(E / 2.0, &f.sE2, &f.cE2);
  f.sq1p = sqrt(1.0 + e);
  f.sq1m = sqrt(1.0 - e);
  f.yv = f.sq1p * f.sE2;
  f.xv = f.sq1m * f.cE2;
  f.nu = 2.0 * atan2(f.yv, f.xv);
  if constexpr (MODE == DDGR)
    f.k = p[8];
  else
    f.k = p[8] * DEG / SEC_PER_YEAR / (TWO_PI / f.pbprime);
  f.nu_cont = f.nu + TWO_PI * fl + (f.nu < 0.0 ? TWO_PI : 0.0);
  f.omega = p[7] * DEG + f.k * f.nu_cont;
  // a1_at, dd_delay_core; DDK's corrections on top, sini by the mode
  f.a1 = p[3] + t * p[4];
  if constexpr (MODE == DDK) {
    f.omega = f.omega + x.d_om;
    f.a1 = f.a1 + x.d_a1;
  }
  if constexpr (MODE == DDGR)
    f.m2_tsun = p[9];
  else
    f.m2_tsun = p[9] * TSUN;
  if constexpr (MODE == DDGR)
    f.sini = f.a1 / p[10];
  else if constexpr (MODE == DDK)
    f.sini = x.sini;
  else
    f.sini = p[10];
  f.er = e * (1.0 + p[12]);
  f.eth = e * (1.0 + p[13]);
  sincos(f.omega, &f.so, &f.co);
  f.alpha = f.a1 * f.so;
  f.q = sqrt(1.0 - f.eth * f.eth);
  f.beta = f.a1 * f.q * f.co;
  f.bg = f.beta + p[11];
  f.Dre = f.alpha * (f.cosE - f.er) + f.beta * f.sinE + p[11] * f.sinE;
  f.Drep = -f.alpha * f.sinE + f.bg * f.cosE;
  f.Drepp = -f.alpha * f.cosE - f.bg * f.sinE;
  f.den = 1.0 - e * f.cosE;
  f.nhat = TWO_PI / f.pbprime / f.den;
  f.nD = f.nhat * f.Drep;
  f.nhat2 = f.nhat * f.nhat;
  f.T = 0.5 * e * f.sinE / f.den;
  f.brI = 1.0 - f.nhat * f.Drep + f.nD * f.nD +
          0.5 * f.nhat2 * f.Dre * f.Drepp - f.T * f.nhat2 * f.Dre * f.Drep;
  const double delayI = f.Dre * f.brI;
  f.r1 = sqrt(1.0 - e * e);
  f.inner = f.so * (f.cosE - e) + f.r1 * f.co * f.sinE;
  f.brace = f.den - f.sini * f.inner;
  const double delayS = -2.0 * f.m2_tsun * log(f.brace);
  const double opn = f.omega + f.nu;
  sincos(opn, &f.sopn, &f.copn);
  const double delayA =
      p[14] * (f.sopn + e * f.so) + p[15] * (f.copn + e * f.co);
  f.delay = delayI + delayS + delayA;
}

// Reverse sweep: the partials of f.delay into P (tt0, then the row, then
// DDK's per-TOA inputs; DDK leaves the unread SINI's P[11] unset).
template <int MODE, bool ORB>
__device__ __forceinline__ void dd_reverse(double t, const double* p,
                                           const Fwd& f, double* P) {
  const double e = f.e;
  const double gd = isfinite(f.delay) ? 1.0 : nan("");
  // delayA = A0 (sin(omega+nu) + e so) + B0 (cos(omega+nu) + e co)
  P[15] = gd * (f.sopn + e * f.so);
  P[16] = gd * (f.copn + e * f.co);
  const double g_opn = gd * (p[14] * f.copn - p[15] * f.sopn);
  double g_e = gd * (p[14] * f.so + p[15] * f.co);
  double g_so = gd * (p[14] * e);
  double g_co = gd * (p[15] * e);
  double g_omega = g_opn;
  double g_nu = g_opn;
  // delayS = -2 m2_tsun log(brace); brace = den - sini inner
  P[10] = gd * (-2.0 * log(f.brace));
  if constexpr (MODE != DDGR) P[10] = P[10] * TSUN;
  const double g_brace = gd * (-2.0 * f.m2_tsun / f.brace);
  double g_den = g_brace;
  const double g_sini = -g_brace * f.inner;
  const double g_inner = -g_brace * f.sini;
  // inner = so (cosE - e) + r1 co sinE; r1 = sqrt(1 - e^2)
  g_so = g_so + g_inner * (f.cosE - e);
  double g_c = g_inner * f.so;
  g_e = g_e - g_inner * f.so;
  const double g_r1 = g_inner * f.co * f.sinE;
  g_co = g_co + g_inner * f.r1 * f.sinE;
  double g_s = g_inner * f.r1 * f.co;
  g_e = g_e - g_r1 * e / f.r1;
  // delayI = Dre brI
  double g_Dre = gd * f.brI;
  const double g_brI = gd * f.Dre;
  double g_nhat = -g_brI * f.Drep;
  double g_Drep = -g_brI * f.nhat;
  const double g_nD = g_brI * 2.0 * f.nD;
  const double g_nhat2 =
      g_brI * (0.5 * f.Dre * f.Drepp - f.T * f.Dre * f.Drep);
  g_Dre = g_Dre + g_brI * (0.5 * f.nhat2 * f.Drepp - f.T * f.nhat2 * f.Drep);
  const double g_Drepp = g_brI * 0.5 * f.nhat2 * f.Dre;
  const double g_T = -g_brI * f.nhat2 * f.Dre * f.Drep;
  g_Drep = g_Drep - g_brI * f.T * f.nhat2 * f.Dre;
  // T = 0.5 e sinE / den; nhat2 = nhat^2; nD = nhat Drep
  g_e = g_e + g_T * 0.5 * f.sinE / f.den;
  g_s = g_s + g_T * 0.5 * e / f.den;
  g_den = g_den - g_T * f.T / f.den;
  g_nhat = g_nhat + g_nhat2 * 2.0 * f.nhat + g_nD * f.Drep;
  g_Drep = g_Drep + g_nD * f.nhat;
  // nhat = 2 pi / pbprime / den; den = 1 - e cosE
  double g_pbprime = -g_nhat * f.nhat / f.pbprime;
  g_den = g_den - g_nhat * f.nhat / f.den;
  g_e = g_e - g_den * f.cosE;
  g_c = g_c - g_den * e;
  // Drepp = -alpha cosE - bg sinE; Drep = -alpha sinE + bg cosE
  double g_alpha = -g_Drepp * f.cosE;
  g_c = g_c - g_Drepp * f.alpha;
  double g_bg = -g_Drepp * f.sinE;
  g_s = g_s - g_Drepp * f.bg;
  g_alpha = g_alpha - g_Drep * f.sinE;
  g_s = g_s - g_Drep * f.alpha;
  g_bg = g_bg + g_Drep * f.cosE;
  g_c = g_c + g_Drep * f.bg;
  // Dre = alpha (cosE - er) + beta sinE + GAMMA sinE; bg = beta + GAMMA
  g_alpha = g_alpha + g_Dre * (f.cosE - f.er);
  g_c = g_c + g_Dre * f.alpha;
  const double g_er = -g_Dre * f.alpha;
  const double g_beta = g_Dre * f.sinE + g_bg;
  P[12] = g_beta;
  g_s = g_s + g_Dre * f.bg;
  // beta = a1 q co; q = sqrt(1 - eth^2); alpha = a1 so
  double g_a1 = g_beta * f.q * f.co;
  const double g_q = g_beta * f.a1 * f.co;
  g_co = g_co + g_beta * f.a1 * f.q;
  const double g_eth = -g_q * f.eth / f.q;
  g_a1 = g_a1 + g_alpha * f.so;
  g_so = g_so + g_alpha * f.a1;
  g_omega = g_omega + g_so * f.co - g_co * f.so;
  // sini: SINI (DD), a1 / ar (DDGR), per TOA (DDK)
  if constexpr (MODE == DDGR) {
    g_a1 = g_a1 + g_sini / p[10];
    P[11] = -g_sini * f.sini / p[10];
  } else if constexpr (MODE == DDK) {
    P[17] = g_a1;
    P[18] = g_omega;
    P[19] = g_sini;
  } else {
    P[11] = g_sini;
  }
  // eth = e (1 + DTH); er = e (1 + DR)
  g_e = g_e + g_eth * (1.0 + p[13]) + g_er * (1.0 + p[12]);
  P[14] = g_eth * e;
  P[13] = g_er * e;
  // omega = OM DEG + k nu_cont; k = OMDOT DEG / SEC_PER_YEAR / (2 pi / pbprime)
  // or, in DDGR, the row's k
  P[8] = g_omega * DEG;
  const double g_k = g_omega * f.nu_cont;
  g_nu = g_nu + g_omega * f.k;
  if constexpr (MODE == DDGR) {
    P[9] = g_k;
  } else {
    P[9] = g_k * (DEG / SEC_PER_YEAR / (TWO_PI / f.pbprime));
    g_pbprime = g_pbprime + g_k * f.k / f.pbprime;
  }
  // nu = 2 atan2(yv, xv); yv = sq1p sin(E/2); xv = sq1m cos(E/2)
  const double rr = f.xv * f.xv + f.yv * f.yv;
  const double g_yv = g_nu * 2.0 * f.xv / rr;
  const double g_xv = -g_nu * 2.0 * f.yv / rr;
  const double g_E = g_s * f.cosE - g_c * f.sinE +
                     0.5 * (g_yv * f.sq1p * f.cE2 - g_xv * f.sq1m * f.sE2);
  g_e = g_e + 0.5 * (g_yv * f.sE2 / f.sq1p - g_xv * f.cE2 / f.sq1m);
  // Kepler at its root: dE = (dM + sinE de) / den
  const double g_M = g_E / f.den;
  g_e = g_e + g_M * f.sinE;
  // e = ECC + t EDOT; a1 = A1 + t A1DOT
  P[6] = g_e;
  P[7] = g_e * t;
  P[4] = g_a1;
  P[5] = g_a1 * t;
  // M = (orbits - floor) 2 pi; orbits = frac - 0.5 pbdot frac^2;
  // frac = t / pb_s; pbprime = pb_s + PBDOT t; pb_s = PB 86400
  const double g_orb = g_M * TWO_PI;
  if constexpr (ORB) {
    P[1] = g_orb;
    P[2] = g_pbprime;
    P[0] = g_e * p[6] + g_a1 * p[4];
  } else {
    const double g_frac = g_orb * (1.0 - f.pbdot * f.frac);
    const double g_pbdot = -g_orb * 0.5 * f.frac * f.frac;
    const double g_pbs = g_pbprime - g_frac * f.frac / f.pb_s;
    P[1] = g_pbs * 86400.0;
    P[2] = g_pbdot + g_pbprime * t;
    P[3] = g_pbdot;
    P[0] = g_frac / f.pb_s + g_pbprime * p[1] + g_e * p[6] + g_a1 * p[4];
  }
}

// BT (engines.py:135 bt_delay with use_pb): the same orbits and Kepler
// solve, omega_bt = OM DEG + ((OMDOT DEG) / SEC_PER_YEAR) t, and
// (alpha (cosE - e) + (beta + GAMMA) sinE) (1 - 2 pi num / (den PB 86400));
// with ORB, R reads the orbit input pbprime in place of PB 86400 (the
// caller hands it PB 86400 where the reference keeps use_pb), and BTX's a1
// is the per-TOA one.
template <int MODE, bool ORB>
__device__ __forceinline__ void bt_forward(double t, const double* p,
                                           const Toa& x, BtFwd& f) {
  double orbits;
  if constexpr (ORB) {
    orbits = x.orb;
    f.pb_s = x.pbp;
  } else {
    f.pb_s = p[0] * 86400.0;
    f.pbdot = p[1] + p[2];
    f.frac = t / f.pb_s;
    orbits = f.frac - 0.5 * f.pbdot * f.frac * f.frac;
  }
  const double M = (orbits - floor(orbits)) * TWO_PI;
  const double e = p[5] + t * p[6];
  f.e = e;
  const double E = kepler(M, e);
  if constexpr (MODE == BTX)
    f.a1 = x.d_a1 + t * p[4];
  else
    f.a1 = p[3] + t * p[4];
  f.omdot = p[8] * DEG / SEC_PER_YEAR;
  sincos(p[7] * DEG + f.omdot * t, &f.so, &f.co);
  sincos(E, &f.sinE, &f.cosE);
  f.alpha = f.a1 * f.so;
  f.sq = sqrt(1.0 - e * e);
  f.beta = f.a1 * f.co * f.sq;
  f.bg = f.beta + p[11];
  f.L = f.alpha * (f.cosE - e) + f.bg * f.sinE;
  f.num = f.beta * f.cosE - f.alpha * f.sinE;
  f.den = 1.0 - e * f.cosE;
  f.w = f.den * f.pb_s;
  f.q = TWO_PI * f.num / f.w;
  f.R = 1.0 - f.q;
  f.delay = f.L * f.R;
}

template <bool ORB>
__device__ __forceinline__ void bt_reverse(double t, const double* p,
                                           const BtFwd& f, double* P) {
  const double e = f.e;
  const double gd = isfinite(f.delay) ? 1.0 : nan("");
  // delay = L R; R = 1 - q; q = 2 pi num / w; w = den pb_s
  const double g_L = gd * f.R;
  const double g_q = -(gd * f.L);
  const double g_num = g_q * TWO_PI / f.w;
  const double g_w = -g_q * f.q / f.w;
  const double g_den = g_w * f.pb_s;
  double g_pbs = g_w * f.den;
  // den = 1 - e cosE
  double g_e = -g_den * f.cosE;
  double g_c = -g_den * e;
  // num = beta cosE - alpha sinE
  double g_beta = g_num * f.cosE;
  g_c = g_c + g_num * f.beta;
  double g_alpha = -g_num * f.sinE;
  double g_s = -g_num * f.alpha;
  // L = alpha (cosE - e) + bg sinE; bg = beta + GAMMA
  g_alpha = g_alpha + g_L * (f.cosE - e);
  g_c = g_c + g_L * f.alpha;
  g_e = g_e - g_L * f.alpha;
  const double g_bg = g_L * f.sinE;
  g_s = g_s + g_L * f.bg;
  g_beta = g_beta + g_bg;
  P[12] = g_bg;
  // beta = a1 co sq; sq = sqrt(1 - e^2); alpha = a1 so
  double g_a1 = g_beta * f.co * f.sq;
  const double g_co = g_beta * f.a1 * f.sq;
  const double g_sq = g_beta * f.a1 * f.co;
  g_e = g_e - g_sq * e / f.sq;
  g_a1 = g_a1 + g_alpha * f.so;
  const double g_so = g_alpha * f.a1;
  // om = OM DEG + omdot t
  const double g_om = g_so * f.co - g_co * f.so;
  P[8] = g_om * DEG;
  P[9] = g_om * (DEG / SEC_PER_YEAR) * t;
  // Kepler at its root: dE = (dM + sinE de) / den
  const double g_E = g_s * f.cosE - g_c * f.sinE;
  const double g_M = g_E / f.den;
  g_e = g_e + g_M * f.sinE;
  P[6] = g_e;
  P[7] = g_e * t;
  P[4] = g_a1;
  P[5] = g_a1 * t;
  // M = (orbits - floor) 2 pi; orbits = frac - 0.5 pbdot frac^2;
  // frac = t / pb_s; pb_s = PB 86400 (R's constant PB too)
  const double g_orb = g_M * TWO_PI;
  if constexpr (ORB) {
    P[1] = g_orb;
    P[2] = g_pbs;
    P[0] = g_e * p[6] + g_a1 * p[4] + g_om * f.omdot;
  } else {
    const double g_frac = g_orb * (1.0 - f.pbdot * f.frac);
    const double g_pbdot = -g_orb * 0.5 * f.frac * f.frac;
    g_pbs = g_pbs - g_frac * f.frac / f.pb_s;
    P[1] = g_pbs * 86400.0;
    P[2] = g_pbdot;
    P[3] = g_pbdot;
    P[0] = g_frac / f.pb_s + g_e * p[6] + g_a1 * p[4] + g_om * f.omdot;
  }
}

// One block covers THREADS TOAs of one row b = b0 + blockIdx.y, so the
// parameter row is loaded once per block and no thread divides by N.  Each
// thread's tt0 (and its per-TOA inputs) is loaded before the barrier, so
// that its latency overlaps the row's.
template <int MODE, bool ORB>
__device__ __forceinline__ Toa load_toa(const double* __restrict__ d_a1,
                                        const double* __restrict__ d_om,
                                        const double* __restrict__ sini,
                                        const double* __restrict__ orb,
                                        const double* __restrict__ pbp,
                                        long idx) {
  Toa x{0.0, 0.0, 0.0, 0.0, 0.0};
  if constexpr (MODE == DDK) {
    x.d_a1 = d_a1[idx];
    x.d_om = d_om[idx];
    x.sini = sini[idx];
  }
  if constexpr (MODE == BTX) x.d_a1 = d_a1[idx];
  if constexpr (ORB) {
    x.orb = orb[idx];
    x.pbp = pbp[idx];
  }
  return x;
}

template <int MODE, bool ORB>
__global__ void dd_binary_primal(const double* __restrict__ tt0,
                                 const double* __restrict__ params,
                                 const double* __restrict__ d_a1,
                                 const double* __restrict__ d_om,
                                 const double* __restrict__ sini,
                                 const double* __restrict__ orb,
                                 const double* __restrict__ pbp, int b0,
                                 int N, double* __restrict__ delay) {
  __shared__ double row[NPAR];
  const long b = (long)b0 + blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const long idx = b * N + n;
  const double t = n < N ? tt0[idx] : 0.0;
  Toa x{0.0, 0.0, 0.0, 0.0, 0.0};
  if constexpr (MODE == DDK || MODE == BTX || ORB) {
    if (n < N) x = load_toa<MODE, ORB>(d_a1, d_om, sini, orb, pbp, idx);
  }
  if (threadIdx.x < NPAR) row[threadIdx.x] = params[b * NPAR + threadIdx.x];
  __syncthreads();
  if (n >= N) return;
  double p[NPAR];
#pragma unroll
  for (int i = 0; i < NPAR; ++i) p[i] = row[i];
  if constexpr (MODE == BT || MODE == BTX) {
    BtFwd f;
    bt_forward<MODE, ORB>(t, p, x, f);
    delay[idx] = f.delay;
  } else {
    Fwd f;
    dd_forward<MODE, ORB>(t, p, x, f);
    delay[idx] = f.delay;
  }
}

// The block's partials go through shared memory so that its rows of the
// (B, N, NPARTIAL) output are written contiguously (one thread's values are
// 8 NPARTIAL B apart from the next thread's).
template <int MODE, bool ORB>
__global__ void dd_binary_dual(const double* __restrict__ tt0,
                               const double* __restrict__ params,
                               const double* __restrict__ d_a1,
                               const double* __restrict__ d_om,
                               const double* __restrict__ sini,
                               const double* __restrict__ orb,
                               const double* __restrict__ pbp, int B, int N,
                               double* __restrict__ delay,
                               double* __restrict__ partials) {
  constexpr int NPARTIAL = Mode<MODE, ORB>::NPARTIAL;
  __shared__ double rows[THREADS * NPARTIAL];
  const long first = (long)blockIdx.x * THREADS;
  const long idx = first + threadIdx.x;
  const long total = (long)B * N;
  if (idx < total) {
    const int b = (int)(idx / N);
    double p[NPAR];
#pragma unroll
    for (int i = 0; i < NPAR; ++i) p[i] = params[b * NPAR + i];
    const double t = tt0[idx];
    double P[Mode<MODE, ORB>::NSWEEP];
    const Toa x = load_toa<MODE, ORB>(d_a1, d_om, sini, orb, pbp, idx);
    if constexpr (MODE == BT || MODE == BTX) {
      BtFwd f;
      bt_forward<MODE, ORB>(t, p, x, f);
      bt_reverse<ORB>(t, p, f, P);
      delay[idx] = f.delay;
    } else {
      Fwd f;
      dd_forward<MODE, ORB>(t, p, x, f);
      dd_reverse<MODE, ORB>(t, p, f, P);
      delay[idx] = f.delay;
    }
#pragma unroll
    for (int i = 0; i < NPARTIAL; ++i)
      rows[threadIdx.x * NPARTIAL + i] = P[Mode<MODE, ORB>::column(i)];
  }
  __syncthreads();
  const long n = (total - first < THREADS ? total - first : THREADS) * NPARTIAL;
  double* out = partials + first * NPARTIAL;
  for (long e = threadIdx.x; e < n; e += THREADS) out[e] = rows[e];
}

template <int MODE, bool ORB>
void launch_orb(const double* tt0, const double* params, int B, int N,
                const double* d_a1, const double* d_om, const double* sini,
                const double* orb, const double* pbp, double* delay,
                double* partials, cudaStream_t st) {
  if (partials == nullptr) {
    const unsigned nx = (unsigned)((N + THREADS - 1) / THREADS);
    for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
      const unsigned ny = (unsigned)(B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y);
      dd_binary_primal<MODE, ORB><<<dim3(nx, ny), THREADS, 0, st>>>(
          tt0, params, d_a1, d_om, sini, orb, pbp, b0, N, delay);
    }
  } else {
    const long total = (long)B * N;
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    dd_binary_dual<MODE, ORB><<<blocks, THREADS, 0, st>>>(
        tt0, params, d_a1, d_om, sini, orb, pbp, B, N, delay, partials);
  }
}

template <int MODE>
void launch(const double* tt0, const double* params, int B, int N,
            const double* d_a1, const double* d_om, const double* sini,
            const double* orb, const double* pbp, double* delay,
            double* partials, cudaStream_t st) {
  if (orb == nullptr)
    launch_orb<MODE, false>(tt0, params, B, N, d_a1, d_om, sini, orb, pbp,
                            delay, partials, st);
  else
    launch_orb<MODE, true>(tt0, params, B, N, d_a1, d_om, sini, orb, pbp,
                           delay, partials, st);
}

}  // namespace

extern "C" int dd_binary_launch(const double* tt0, const double* params, int B,
                                int N, int mode, const double* d_a1,
                                const double* d_om, const double* sini,
                                const double* orb, const double* pbp,
                                double* delay, double* partials,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long)B * N == 0) return 0;
  if ((orb == nullptr) != (pbp == nullptr)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case DD:
      launch<DD>(tt0, params, B, N, d_a1, d_om, sini, orb, pbp, delay,
                 partials, st);
      break;
    case BT:
      launch<BT>(tt0, params, B, N, d_a1, d_om, sini, orb, pbp, delay,
                 partials, st);
      break;
    case DDGR:
      launch<DDGR>(tt0, params, B, N, d_a1, d_om, sini, orb, pbp, delay,
                   partials, st);
      break;
    case DDK:
      if (d_a1 == nullptr || d_om == nullptr || sini == nullptr)
        return (int)cudaErrorInvalidValue;
      launch<DDK>(tt0, params, B, N, d_a1, d_om, sini, orb, pbp, delay,
                  partials, st);
      break;
    case BTX:
      if (d_a1 == nullptr) return (int)cudaErrorInvalidValue;
      launch<BTX>(tt0, params, B, N, d_a1, d_om, sini, orb, pbp, delay,
                  partials, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dd_binary_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
