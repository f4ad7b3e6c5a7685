// Native host code for pint_torch: exact double-double arithmetic and
// decimal-string -> double-double conversion.
//
// These replace the reference's dependence on numpy longdouble (x87 80-bit,
// absent on arm64) for the host-side precision path (reference
// pulsar_mjd.py:488 str_to_mjds, :586 two_sum/two_product, utils.py:411
// taylor_horner).  The double-double pair (hi, lo) carries ~106 bits of
// mantissa — more than 80-bit extended — and the kernels below are
// branch-free batch loops over contiguous arrays, called through ctypes.
//
// Error-free transforms follow Dekker (1971) / Knuth; products use FMA.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

struct dd {
    double hi, lo;
};

static inline dd two_sum(double a, double b) {
    double s = a + b;
    double bb = s - a;
    double err = (a - (s - bb)) + (b - bb);
    return {s, err};
}

static inline dd quick_two_sum(double a, double b) {
    double s = a + b;
    return {s, b - (s - a)};
}

static inline dd two_prod(double a, double b) {
    double p = a * b;
    return {p, std::fma(a, b, -p)};
}

static inline dd dd_add(dd x, dd y) {
    dd s = two_sum(x.hi, y.hi);
    dd t = two_sum(x.lo, y.lo);
    double lo = s.lo + t.hi;
    dd r = quick_two_sum(s.hi, lo);
    lo = r.lo + t.lo;
    return quick_two_sum(r.hi, lo);
}

static inline dd dd_mul(dd x, dd y) {
    dd p = two_prod(x.hi, y.hi);
    double lo = p.lo + x.hi * y.lo + x.lo * y.hi;
    return quick_two_sum(p.hi, lo);
}

static inline dd dd_div(dd x, dd y) {
    double q1 = x.hi / y.hi;
    dd r = dd_add(x, {-q1 * y.hi, -std::fma(q1, y.hi, -q1 * y.hi)});
    r = dd_add(r, {-q1 * y.lo, 0.0});
    double q2 = r.hi / y.hi;
    dd r2 = dd_add(r, {-q2 * y.hi, -std::fma(q2, y.hi, -q2 * y.hi)});
    r2 = dd_add(r2, {-q2 * y.lo, 0.0});
    double q3 = r2.hi / y.hi;
    dd q = quick_two_sum(q1, q2);
    return dd_add(q, {q3, 0.0});
}

// ---------------------------------------------------------------------------
// batched dd arithmetic
// ---------------------------------------------------------------------------

void dd_add_batch(const double* ah, const double* al, const double* bh,
                  const double* bl, double* oh, double* ol, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        dd r = dd_add({ah[i], al[i]}, {bh[i], bl[i]});
        oh[i] = r.hi;
        ol[i] = r.lo;
    }
}

void dd_mul_batch(const double* ah, const double* al, const double* bh,
                  const double* bl, double* oh, double* ol, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        dd r = dd_mul({ah[i], al[i]}, {bh[i], bl[i]});
        oh[i] = r.hi;
        ol[i] = r.lo;
    }
}

void dd_div_batch(const double* ah, const double* al, const double* bh,
                  const double* bl, double* oh, double* ol, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        dd r = dd_div({ah[i], al[i]}, {bh[i], bl[i]});
        oh[i] = r.hi;
        ol[i] = r.lo;
    }
}

// out = sum_k c_k x^k / k!  when factorial != 0 (taylor series), or plain
// Horner when factorial == 0; coefficients are dd pairs.
void dd_horner_batch(const double* ch, const double* cl, int64_t nc,
                     const double* xh, const double* xl, double* oh,
                     double* ol, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        dd x = {xh[i], xl[i]};
        dd acc = {nc > 0 ? ch[nc - 1] : 0.0, nc > 0 ? cl[nc - 1] : 0.0};
        for (int64_t k = nc - 2; k >= 0; k--) {
            acc = dd_add(dd_mul(acc, x), {ch[k], cl[k]});
        }
        oh[i] = acc.hi;
        ol[i] = acc.lo;
    }
}

// ---------------------------------------------------------------------------
// decimal string -> dd (exact to 2^-106)
// ---------------------------------------------------------------------------

static dd pow10_dd(int n) {
    // 10^n as a dd, exact products up to the dd precision
    dd r = {1.0, 0.0};
    dd ten = {10.0, 0.0};
    for (int i = 0; i < n; i++) r = dd_mul(r, ten);
    return r;
}

// Parse one "[+-]IIII[.FFFF][eE[+-]X]" decimal into a dd.  Returns 0 on
// success.  Digits are accumulated in 15-digit chunks (exact in double).
static int str2dd_one(const char* s, dd* out) {
    while (*s == ' ' || *s == '\t') s++;
    int sign = 1;
    if (*s == '+') s++;
    else if (*s == '-') { sign = -1; s++; }
    dd acc = {0.0, 0.0};
    int frac_digits = 0, seen_point = 0, seen_digit = 0;
    int64_t chunk = 0;
    int chunk_len = 0;
    for (; *s; s++) {
        char c = *s;
        if (c >= '0' && c <= '9') {
            seen_digit = 1;
            chunk = chunk * 10 + (c - '0');
            chunk_len++;
            if (seen_point) frac_digits++;
            // 15-digit chunks: 10^15 < 2^53, so (double)chunk is exact
            if (chunk_len == 15) {
                acc = dd_add(dd_mul(acc, pow10_dd(15)), {(double)chunk, 0.0});
                chunk = 0;
                chunk_len = 0;
            }
        } else if ((c == '.') && !seen_point) {
            seen_point = 1;
        } else if (c == 'e' || c == 'E' || c == 'd' || c == 'D') {
            break;
        } else if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
            break;
        } else {
            return 1;
        }
    }
    if (!seen_digit) return 1;
    if (chunk_len > 0) {
        acc = dd_add(dd_mul(acc, pow10_dd(chunk_len)), {(double)chunk, 0.0});
    }
    int expo = 0;
    if (*s == 'e' || *s == 'E' || *s == 'd' || *s == 'D') {
        s++;
        int esign = 1;
        if (*s == '+') s++;
        else if (*s == '-') { esign = -1; s++; }
        int ev = 0;
        for (; *s >= '0' && *s <= '9'; s++) ev = ev * 10 + (*s - '0');
        expo = esign * ev;
    }
    int net = expo - frac_digits;
    dd r = acc;
    if (net > 0) r = dd_mul(acc, pow10_dd(net));
    else if (net < 0) r = dd_div(acc, pow10_dd(-net));
    if (sign < 0) { r.hi = -r.hi; r.lo = -r.lo; }
    *out = r;
    return 0;
}

// buf: n zero-terminated strings back to back; offsets[i] = start of i-th.
int str2dd_batch(const char* buf, const int64_t* offsets, int64_t n,
                 double* oh, double* ol) {
    int bad = 0;
    for (int64_t i = 0; i < n; i++) {
        dd r;
        if (str2dd_one(buf + offsets[i], &r)) {
            r = {0.0 / 0.0, 0.0};
            bad++;
        }
        oh[i] = r.hi;
        ol[i] = r.lo;
    }
    return bad;
}

// ---------------------------------------------------------------------------
// fast tim-file numeric column scan: for pre-split whitespace tokens this
// parses plain doubles (fortran D-exponent tolerated)
// ---------------------------------------------------------------------------

int parse_double_batch(const char* buf, const int64_t* offsets, int64_t n,
                       double* out) {
    int bad = 0;
    for (int64_t i = 0; i < n; i++) {
        dd r;
        if (str2dd_one(buf + offsets[i], &r)) {
            out[i] = 0.0 / 0.0;
            bad++;
        } else {
            out[i] = r.hi;
        }
    }
    return bad;
}

}  // extern "C"
