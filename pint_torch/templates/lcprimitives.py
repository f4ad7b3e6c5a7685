"""Light-curve primitive components: normalized peak shapes on phase [0,1)
(port of ``pint_tpu/templates/lcprimitives.py``).

Each primitive integrates to 1 over one period and exposes ``(phases) ->
density``.  Every ``_pdf`` evaluates numpy phases on the host, as the
reference's numpy branch does, and a ``torch.Tensor`` of phases with torch
on the tensor's device, in the order of the reference's ``jnp`` branch, so
that a whole-template photon log-likelihood runs on (walkers, photons)
tensors.  On a tensor, a divisor that is a host scalar becomes a float64
tensor on the phases' device first: torch divides a CUDA tensor by a
Python or CPU scalar as a product with its reciprocal, which rounds apart
from the reference's true division.  ``LCVonMises`` takes
``torch.special.i0e``, ``LCKing`` ``torch.lgamma`` and ``LCSkewGaussian``
``torch.special.erf``.

Wrapping: Gaussian/Lorentzian shapes are periodized by summing image terms
over a fixed window of wraps (trace-static), matching the reference's
approach of wrapping narrow peaks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["LCPrimitive", "LCWrappedFunction", "LCGaussian", "LCGaussian2",
           "LCLorentzian", "LCLorentzian2", "LCVonMises", "LCTopHat",
           "LCKing", "LCHarmonic", "LCSkewGaussian", "FastBessel",
           "LCEmpiricalFourier", "LCKernelDensity", "convert_primitive",
           "approx_gradient", "check_gradient", "two_comp_mc"]

_NWRAP = 6  # image terms each side; adequate for width > ~0.005


def _np_or_torch(x):
    """torch for a tensor of phases, numpy for anything else."""
    return torch if isinstance(x, torch.Tensor) else np


def _on(v, x):
    """``v`` as a float64 tensor on tensor ``x``'s device (a divisor, or a
    ``where`` branch that must stay float64); ``v`` itself for numpy
    ``x``."""
    if not isinstance(x, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.float64, device=x.device)


class LCPrimitive:
    """Base: parameters [width-like..., location]; pdf integrates to 1."""

    name = "base"
    pnames: list = []
    #: False for shapes whose component pdf can go negative (Fourier
    #: harmonics): they are not standalone densities, so mixture
    #: (per-component) sampling is invalid for them
    mixture_safe = True

    def __init__(self, p=None):
        self.p = np.asarray(p if p is not None else self.p0, dtype=np.float64)
        self.free = np.ones_like(self.p, dtype=bool)

    def get_location(self) -> float:
        return float(self.p[-1])

    def set_location(self, loc: float):
        self.p[-1] = loc % 1.0

    def get_width(self, error: bool = False) -> float:
        return float(self.p[0])

    def num_parameters(self, free: bool = True) -> int:
        return int(self.free.sum()) if free else len(self.p)

    def get_parameters(self, free: bool = True) -> np.ndarray:
        return self.p[self.free] if free else self.p.copy()

    def set_parameters(self, p, free: bool = True):
        if free:
            self.p[self.free] = p
        else:
            self.p[:] = p
        return True

    def _pdf(self, phases, p):
        raise NotImplementedError

    def __call__(self, phases):
        return self._pdf(phases, self.p)

    def hwhm(self, right: bool = False) -> float:
        """Half width at half maximum; subclasses with non-gaussian shapes
        override (reference ``lcprimitives.py hwhm``)."""
        return float(self.p[int(right) if self.is_two_sided() else 0]) \
            * math.sqrt(2 * math.log(2))

    def is_two_sided(self) -> bool:
        return False

    def random(self, n: int, rng=None) -> np.ndarray:
        """Draw n phases from this primitive (rejection fallback; analytic
        subclasses override)."""
        rng = rng or np.random.default_rng()
        grid = np.linspace(0.0, 1.0, 1024)
        fmax = float(np.max(np.asarray(self(grid)))) * 1.05
        out = np.empty(0)
        while len(out) < n:
            m = int((n - len(out)) * 1.5 * fmax) + 16
            x = rng.random(m)
            keep = rng.random(m) * fmax < np.asarray(self(x))
            out = np.concatenate([out, x[keep]])
        return out[:n]

    def integrate(self, x1: float = 0.0, x2: float = 1.0, simps: int = 512) -> float:
        """Numerical integral over [x1, x2] (analytic not needed at the
        fitting accuracy; the pdf is smooth and periodic)."""
        g = np.linspace(x1, x2, simps + 1)
        y = np.asarray(self(g))
        return float(np.trapezoid(y, g))

    def copy(self):
        import copy as _c

        return _c.deepcopy(self)

    def __repr__(self):
        pars = ", ".join(f"{n}={v:.4f}" for n, v in zip(self.pnames, self.p))
        return f"{type(self).__name__}({pars})"


class LCGaussian(LCPrimitive):
    """Wrapped Gaussian peak: p = [sigma, location]
    (reference ``lcprimitives.py LCGaussian``)."""

    name = "Gaussian"
    pnames = ["Width", "Location"]
    p0 = [0.03, 0.5]

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        sigma, loc = p[0], p[1]
        z = (xp.asarray(phases) - loc) % 1.0
        out = 0.0
        for k in range(-_NWRAP, _NWRAP + 1):
            out = out + xp.exp(-0.5 * ((z + k) / _on(sigma, z)) ** 2)
        return out / _on(sigma * np.sqrt(2 * np.pi), z)

    def random(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return (self.p[1] + self.p[0] * rng.standard_normal(n)) % 1.0


class LCGaussian2(LCPrimitive):
    """Wrapped two-sided Gaussian: p = [sigma_left, sigma_right, location]
    (reference ``lcprimitives.py:794 LCGaussian2``): each side is a half
    normal with its own width, continuous at the mode, integral 1."""

    name = "Gaussian2"
    pnames = ["Width1", "Width2", "Location"]
    p0 = [0.03, 0.03, 0.5]

    def is_two_sided(self):
        return True

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        w1, w2, loc = p[0], p[1], p[2]
        amp = math.sqrt(2.0 / np.pi)  # 2/sqrt(2 pi), shared peak height scale
        z0 = xp.asarray(phases) - loc
        out = 0.0
        for k in range(-_NWRAP, _NWRAP + 1):
            z = z0 + k
            zz = z * xp.where(z <= 0, _on(1.0 / w1, z), _on(1.0 / w2, z))
            out = out + xp.exp(-0.5 * zz**2)
        return out * (amp / (w1 + w2))

    def random(self, n, rng=None):
        rng = rng or np.random.default_rng()
        w1, w2, loc = self.p
        left = rng.random(n) < w1 / (w1 + w2)
        draw = np.abs(rng.standard_normal(n))
        return (loc + np.where(left, -w1 * draw, w2 * draw)) % 1.0


class LCLorentzian(LCPrimitive):
    """Periodized Lorentzian: p = [gamma (HWHM), location]."""

    name = "Lorentzian"
    pnames = ["Width", "Location"]
    p0 = [0.03, 0.5]

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        gamma, loc = p[0], p[1]
        # exact wrapped Lorentzian:
        # sum_k gamma/((z+k)^2+gamma^2) = pi sinh(2 pi g)/(cosh(2 pi g)-cos(2 pi z))
        # normalized over one cycle this is sinh/(cosh - cos)
        a = 2 * np.pi * gamma
        z = 2 * np.pi * (xp.asarray(phases) - loc)
        return _on(xp.sinh(_on(a, z)), z) / (xp.cosh(_on(a, z)) - xp.cos(z))

    def hwhm(self, right=False):
        return float(self.p[0])

    def random(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return (self.p[1] + self.p[0] * rng.standard_cauchy(n)) % 1.0


class LCLorentzian2(LCPrimitive):
    """Wrapped two-sided Lorentzian: p = [gamma_left, gamma_right, location]
    (reference ``lcprimitives.py:1086 LCLorentzian2``)."""

    name = "Lorentzian2"
    pnames = ["Width1", "Width2", "Location"]
    p0 = [0.03, 0.03, 0.5]

    def is_two_sided(self):
        return True

    def hwhm(self, right=False):
        return float(self.p[int(right)])

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        g1, g2, loc = p[0], p[1], p[2]
        amp = 2.0 / np.pi / (g1 + g2)  # shared peak height, integral 1
        z0 = (xp.asarray(phases) - loc + 0.5) % 1.0 - 0.5
        out = 0.0
        for k in range(-_NWRAP, _NWRAP + 1):
            z = z0 + k
            zz = z * xp.where(z <= 0, _on(1.0 / g1, z), _on(1.0 / g2, z))
            out = out + _on(amp, z) / (1.0 + zz * zz)
        return out

    def random(self, n, rng=None):
        rng = rng or np.random.default_rng()
        g1, g2, loc = self.p
        left = rng.random(n) < g1 / (g1 + g2)
        draw = np.abs(rng.standard_cauchy(n))
        return (loc + np.where(left, -g1 * draw, g2 * draw)) % 1.0


class LCVonMises(LCPrimitive):
    """Von Mises peak (circular normal): p = [width ~ 1/sqrt(kappa), loc]
    (reference parameterization: width = kappa^(-1/2)/(2 pi))."""

    name = "VonMises"
    pnames = ["Width", "Location"]
    p0 = [0.03, 0.5]

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        width, loc = p[0], p[1]
        kappa = 1.0 / (2 * np.pi * width) ** 2
        # density per unit PHASE (one cycle), not per radian:
        # f(phi) = exp(kappa cos z) / I0(kappa), z = 2 pi (phi - loc)
        z = 2 * np.pi * (xp.asarray(phases) - loc)
        if xp is np:
            from scipy.special import i0e as np_i0e

            return np.exp(kappa * (np.cos(z) - 1.0)) / np_i0e(kappa)
        return torch.exp(kappa * (torch.cos(z) - 1.0)) \
            / torch.special.i0e(_on(kappa, z))

    def random(self, n, rng=None):
        rng = rng or np.random.default_rng()
        kappa = 1.0 / (2 * np.pi * self.p[0]) ** 2
        draw = rng.vonmises(0.0, kappa, n) / (2 * np.pi)
        return (self.p[1] + draw) % 1.0


class LCTopHat(LCPrimitive):
    """Top hat of given width centered at location (host-side only shape)."""

    name = "TopHat"
    pnames = ["Width", "Location"]
    p0 = [0.1, 0.5]

    def hwhm(self, right=False):
        return float(self.p[0]) / 2

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        width, loc = p[0], p[1]
        z = (xp.asarray(phases) - loc + 0.5) % 1.0 - 0.5
        return xp.where(xp.abs(z) <= width / 2, _on(1.0 / width, z),
                        _on(0.0, z))

    def random(self, n, rng=None):
        rng = rng or np.random.default_rng()
        w, loc = self.p
        return (loc + (rng.random(n) - 0.5) * w) % 1.0


class LCKing(LCPrimitive):
    """Wrapped King-function peak: p = [sigma, gamma, location] (reference
    ``lcprimitives.py:1250 LCKing``): (1+z^2/(2 s^2 g))^-g with the
    (g-1)/g normalization of the unwrapped profile."""

    name = "King"
    pnames = ["Sigma", "Gamma", "Location"]
    p0 = [0.03, 5.0, 0.5]

    def hwhm(self, right=False):
        s, g, _ = self.p
        # solve (1+u/g)^-g = 1/2 for u = z^2/(2 s^2)
        u = g * (2.0 ** (1.0 / g) - 1.0)
        return float(np.sqrt(2.0 * u) * s)

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        s, g, loc = p[0], p[1], p[2]
        z0 = (xp.asarray(phases) - loc + 0.5) % 1.0 - 0.5
        out = 0.0
        for k in range(-_NWRAP, _NWRAP + 1):
            u = 0.5 * ((z0 + k) / _on(s, z0)) ** 2
            out = out + (1.0 + u / _on(g, z0)) ** (-g)
        # normalize the infinite-domain profile: int (1+u/g)^-g dz
        # = s sqrt(2 pi g) Gamma(g-1/2)/Gamma(g)  (exact); gammaln from the
        # active backend so traced parameters stay differentiable
        if xp is np:
            from scipy.special import gammaln
        else:
            gammaln = torch.lgamma
            g = _on(g, z0)

        norm = s * xp.sqrt(2 * np.pi * g) * xp.exp(
            gammaln(g - 0.5) - gammaln(g))
        return out / _on(norm, z0)


class LCHarmonic(LCPrimitive):
    """A single Fourier harmonic, 1 + 2 cos(2 pi k (phi - loc)): p = [loc]
    (reference ``lcprimitives.py:1336 LCHarmonic``).  Integrates to 1 over a
    cycle by construction; ``order`` selects the harmonic number."""

    name = "Harmonic"
    pnames = ["Location"]
    p0 = [0.0]
    mixture_safe = False  # pdf dips negative; only the sum is a density

    def __init__(self, p=None, order: int = 1):
        super().__init__(p)
        self.order = int(order)

    def hwhm(self, right=False):
        return 0.25 / self.order

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        loc = p[0]
        return 1.0 + 2.0 * xp.cos((2 * np.pi * self.order)
                                  * (xp.asarray(phases) - loc))


class LCEmpiricalFourier(LCPrimitive):
    """Empirical Fourier light-curve representation; only parameter is an
    overall phase shift (reference ``lcprimitives.py:1361``).  Cannot be
    mixed with other primitives.  Build from photon phases or a stored
    two-column (alpha, beta) coefficient file."""

    name = "EmpiricalFourier"
    pnames = ["Shift"]
    p0 = [0.0]
    mixture_safe = False  # truncated Fourier sums can dip negative

    def __init__(self, phases=None, input_file=None, nharm: int = 20):
        super().__init__([0.0])
        self.nharm = int(nharm)
        self.alphas = np.zeros(self.nharm)
        self.betas = np.zeros(self.nharm)
        if input_file is not None:
            self.from_file(input_file)
        if phases is not None:
            self.from_phases(phases)

    def from_phases(self, phases):
        phases = np.asarray(phases, dtype=np.float64)
        ks = 2 * np.pi * np.arange(1, self.nharm + 1)
        self.alphas = np.cos(ks[:, None] * phases[None, :]).mean(axis=1)
        self.betas = np.sin(ks[:, None] * phases[None, :]).mean(axis=1)

    def from_file(self, input_file):
        rows = []
        with open(input_file) as f:
            for line in f:
                ln = line.strip()
                if not ln or ln.startswith("#"):
                    continue
                tok = ln.split()
                if len(tok) == 2:
                    rows.append((float(tok[0]), float(tok[1])))
        if not rows:
            raise ValueError(f"No Fourier coefficients in {input_file}")
        arr = np.asarray(rows)
        self.alphas, self.betas = arr[:, 0], arr[:, 1]
        self.nharm = len(rows)

    def to_file(self, output_file):
        with open(output_file, "w") as f:
            f.write("# fourier\n")
            for a, b in zip(self.alphas, self.betas):
                f.write(f"{a}\t{b}\n")

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        shift = p[0]
        ph = xp.asarray(phases)
        ks = _on(2 * np.pi * np.arange(1, self.nharm + 1), ph)
        # shift theorem on the real coefficient pairs (xp ops so a traced
        # shift parameter stays differentiable)
        c, s = xp.cos(ks * shift), xp.sin(ks * shift)
        al, be = _on(self.alphas, ph), _on(self.betas, ph)
        a = c * al - s * be
        b = s * al + c * be
        terms = a[:, None] * xp.cos(ks[:, None] * ph[None, :]) \
            + b[:, None] * xp.sin(ks[:, None] * ph[None, :])
        return 1.0 + 2.0 * (terms.sum(axis=0) if xp is np
                            else terms.sum(dim=0))

    def integrate(self, x1=0.0, x2=1.0, simps=512):
        if (x1, x2) == (0.0, 1.0):
            return 1.0  # Fourier norm is exact by construction
        return super().integrate(x1, x2, simps)


class LCKernelDensity(LCPrimitive):
    """Wrapped gaussian kernel-density estimate of the light curve; only
    parameter is an overall phase shift (reference ``lcprimitives.py:1456``).
    Cannot be mixed with other primitives.  The empirical bandwidth follows
    Silverman's rule on the circular standard deviation, floored to resolve
    narrow peaks; the grid-sampled estimate is renormalized exactly."""

    name = "KernelDensity"
    pnames = ["Shift"]
    p0 = [0.0]

    def __init__(self, phases=None, bw: float = None, ngrid: int = 512):
        super().__init__([0.0])
        self.ngrid = int(ngrid)
        self.bw = bw  # user-supplied bandwidth, or None for per-fit auto
        self.bw_used = None  # bandwidth of the latest from_phases fit
        self.grid = np.linspace(0.0, 1.0, self.ngrid, endpoint=False)
        self.vals = np.ones(self.ngrid)
        if phases is not None:
            self.from_phases(phases)

    def from_phases(self, phases):
        phases = np.asarray(phases, dtype=np.float64) % 1.0
        n = len(phases)
        bw = self.bw
        if bw is None:
            # circular std via resultant length; re-estimated per dataset
            C = np.cos(2 * np.pi * phases).mean()
            S = np.sin(2 * np.pi * phases).mean()
            R = np.hypot(C, S)
            circ_std = np.sqrt(-2 * np.log(max(R, 1e-12))) / (2 * np.pi)
            bw = max(1.06 * circ_std * n ** (-0.2), 0.5 / self.ngrid)
        self.bw_used = bw
        # wrapped-gaussian KDE evaluated on the grid (vectorized, 3 wraps)
        d = (self.grid[:, None] - phases[None, :] + 0.5) % 1.0 - 0.5
        k = np.exp(-0.5 * (d / bw) ** 2)
        for w in (-1.0, 1.0):
            k += np.exp(-0.5 * ((d + w) / bw) ** 2)
        vals = k.sum(axis=1) / (n * bw * np.sqrt(2 * np.pi))
        self.vals = vals / np.mean(vals)  # exact unit integral on the grid

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        z = (xp.asarray(phases) - p[0]) % 1.0
        idx = z * self.ngrid
        i0 = xp.floor(idx)
        i0 = (i0.astype(int) if xp is np else i0.long()) % self.ngrid
        i1 = (i0 + 1) % self.ngrid
        frac = idx - xp.floor(idx)
        vals = _on(self.vals, z)
        return vals[i0] * (1 - frac) + vals[i1] * frac


class LCWrappedFunction(LCPrimitive):
    """Base for profiles defined by wrapping an infinite-support density
    (reference ``lcprimitives.py:559 LCWrappedFunction``).

    Subclasses provide ``base_func(phases, p, index)`` — the unwrapped
    density evaluated at ``phases + index`` — and optionally
    ``base_int(x1, x2, p)``, its exact integral.  ``_pdf`` sums image terms
    over a fixed +-``_NWRAP`` window (trace-static, jit-friendly — the
    reference instead iterates to convergence, which is data-dependent
    control flow) and, when ``base_int`` is available and the evaluation is
    host-side, adds the truncated tail back as a uniform component so the
    wrapped density still integrates to exactly 1 (the reference's
    normalization adjustment).
    """

    def base_func(self, phases, p, index=0):
        raise NotImplementedError

    def base_int(self, x1, x2, p):
        return None

    def _pdf(self, phases, p):
        xp = _np_or_torch(phases)
        z = xp.asarray(phases) % 1.0
        out = 0.0
        for k in range(-_NWRAP, _NWRAP + 1):
            out = out + self.base_func(z, p, index=k)
        if xp is np:
            covered = self.base_int(-_NWRAP, _NWRAP + 1, p)
            if covered is not None:
                out = out + (1.0 - covered)  # uniform remainder
        return out


class LCSkewGaussian(LCWrappedFunction):
    """Wrapped skew-normal peak: p = [width, shape, location] (reference
    ``lcprimitives.py:858 LCSkewGaussian``).  ``shape`` > 0 skews right;
    shape = 0 reduces exactly to :class:`LCGaussian`.  ``location`` is the
    location parameter of the skew-normal (not its mode)."""

    name = "SkewGaussian"
    pnames = ["Width", "Shape", "Location"]
    p0 = [0.03, 0.0, 0.5]

    def base_func(self, phases, p, index=0):
        xp = _np_or_torch(phases)
        if xp is np:
            from scipy.special import erf
        else:
            erf = torch.special.erf
        width, shape, x0 = p[0], p[1], p[2]
        ph = xp.asarray(phases)
        z = (ph + index - x0) / _on(width, ph)
        return (1.0 / (width * math.sqrt(2 * math.pi))) \
            * xp.exp(-0.5 * z * z) \
            * (1.0 + erf(shape * z / _on(math.sqrt(2.0), ph)))

    def base_int(self, x1, x2, p):
        from scipy.stats import skewnorm

        width, shape, x0 = p[0], p[1], p[2]  # scalars, or per-photon columns
        return np.asarray(skewnorm.cdf(x2, shape, loc=x0, scale=width)
                          - skewnorm.cdf(x1, shape, loc=x0, scale=width))

    def get_location(self) -> float:
        return float(self.p[2])

    def set_location(self, loc: float):
        self.p[2] = loc % 1.0

    def hwhm(self, right: bool = False) -> float:
        """Numeric HWHM about the mode (no closed form for skew normal)."""
        g = np.linspace(0, 1, 4096, endpoint=False)
        y = np.asarray(self(g))
        imax = int(np.argmax(y))
        half = y[imax] / 2.0
        d = (g - g[imax] + 0.5) % 1.0 - 0.5
        sel = (d > 0) if right else (d < 0)
        below = sel & (y < half)
        if not np.any(below):
            return 0.25
        return float(np.min(np.abs(d[below])))

    def random(self, n: int, rng=None) -> np.ndarray:
        """Exact skew-normal sampling: z = delta|u| + sqrt(1-delta^2) v with
        (u, v) iid standard normal, delta = shape/sqrt(1+shape^2)."""
        rng = rng or np.random.default_rng()
        width, shape, x0 = self.p
        delta = shape / math.sqrt(1.0 + shape * shape)
        u = np.abs(rng.standard_normal(n))
        v = rng.standard_normal(n)
        z = delta * u + math.sqrt(1.0 - delta * delta) * v
        return (x0 + width * z) % 1.0


class FastBessel:
    """Fast modified Bessel function I_nu via log-log interpolation with
    the exact asymptotic tail (reference ``lcprimitives.py:1675``): the
    von-Mises normalization 1/(2 pi I0(kappa)) is evaluated millions of
    times in photon likelihoods, and scipy's i0 overflows past x ~ 700
    where log I_nu(x) ~ x - log(sqrt(2 pi x)) + log(1 + (4 nu^2 - 1)/8x)
    is already exact to float precision."""

    def __init__(self, order: int = 0):
        if order not in (0, 1):
            raise NotImplementedError("orders 0 and 1 only")
        from scipy.special import i0, i1

        self.order = order
        x = np.logspace(-1, 3.5, 20001)
        safe = x < 700
        logy = np.empty_like(x)
        logy[safe] = np.log((i0 if order == 0 else i1)(x[safe]))
        xt = x[~safe]
        logy[~safe] = xt - 0.5 * np.log(2 * np.pi * xt) \
            + np.log1p((4 * order**2 - 1) / (8 * xt))
        self._logx = np.log(x)
        self._logy = logy

    def __call__(self, x):
        return np.exp(self.log(x))

    def log(self, x):
        """log I_nu(x): stays finite far beyond the float overflow of
        I_nu itself (x > ~709), which is the form likelihoods want.
        Outside the table the exact limits take over — the asymptotic
        expansion above, the small-x series below (np.interp would
        otherwise CLAMP to the edge values, wildly wrong for large x)."""
        x = np.asarray(x, dtype=np.float64)
        out = np.interp(np.log(np.maximum(x, 1e-300)), self._logx,
                        self._logy)
        lo, hi = np.exp(self._logx[0]), np.exp(self._logx[-1])
        nu = self.order
        big = x > hi
        if np.any(big):
            xb = x[big] if x.ndim else x
            asym = xb - 0.5 * np.log(2 * np.pi * xb) \
                + np.log1p((4 * nu**2 - 1) / (8 * xb))
            out = np.where(np.asarray(big), asym, out) if x.ndim \
                else float(asym)
        small = x < lo
        if np.any(small):
            xs = x[small] if x.ndim else x
            # I0 ~ 1 + x^2/4, I1 ~ x/2 (1 + x^2/8)
            ser = np.log1p(xs * xs / 4) if nu == 0 \
                else np.log(xs / 2) + np.log1p(xs * xs / 8)
            out = np.where(np.asarray(small), ser, out) if x.ndim \
                else float(ser)
        return out


def two_comp_mc(n, w1, w2, loc, func, rng=None):
    """Monte-Carlo photon phases from a two-sided peak (reference
    ``lcprimitives.py:45 two_comp_mc``): draw from ``func`` (a scipy-style
    ``rvs(loc=, scale=, size=)``) with left scale ``w1`` / right scale
    ``w2``, folding each draw onto its side of ``loc``; side membership is
    Bernoulli in w1/(w1+w2) so the composite density is continuous."""
    rng = rng or np.random.default_rng()
    w1, w2 = float(w1), float(w2)
    n1 = int(np.sum(rng.random(n) < w1 / (w1 + w2)))
    left = np.asarray(func(loc=0.0, scale=w1, size=n1))
    left = loc - np.abs(left)
    right = np.asarray(func(loc=0.0, scale=w2, size=n - n1))
    right = loc + np.abs(right)
    return np.concatenate([left, right]) % 1.0


def convert_primitive(p1: LCPrimitive, ptype=LCLorentzian) -> LCPrimitive:
    """Build a primitive of another type with matched location and HWHM
    (reference ``lcprimitives.py:1607 convert_primitive``).  Supported
    targets are the width+location families (Gaussian/Lorentzian/VonMises/
    TopHat and the two-sided variants); anything else raises."""
    one_sided = (LCGaussian, LCLorentzian, LCVonMises, LCTopHat)
    two_sided = (LCGaussian2, LCLorentzian2)
    if ptype not in one_sided + two_sided:
        raise ValueError(
            f"convert_primitive cannot target {ptype.__name__}: only "
            "width+location shapes have a well-defined HWHM mapping")
    loc = p1.get_location()
    if p1.is_two_sided():
        h1, h2 = p1.hwhm(False), p1.hwhm(True)
    else:
        h1 = h2 = p1.hwhm()

    def width_from_hwhm(h):
        if ptype in (LCLorentzian, LCLorentzian2):
            return h  # gamma is the HWHM
        if ptype is LCTopHat:
            return 2 * h
        return h / math.sqrt(2 * math.log(2))  # gaussian-like sigma

    if ptype in two_sided:
        return ptype([width_from_hwhm(h1), width_from_hwhm(h2), loc])
    return ptype([width_from_hwhm(0.5 * (h1 + h2)), loc])


def approx_gradient(prim: LCPrimitive, phases, eps: float = 1e-6) -> np.ndarray:
    """Numeric d(pdf)/d(params) matrix (nparam, nphase) (reference
    ``lcprimitives.py:74``)."""
    phases = np.asarray(phases, dtype=np.float64)
    out = []
    for i in range(len(prim.p)):
        hi = prim.p.copy()
        lo = prim.p.copy()
        hi[i] += eps / 2
        lo[i] -= eps / 2
        out.append((np.asarray(prim._pdf(phases, hi))
                    - np.asarray(prim._pdf(phases, lo))) / eps)
    return np.asarray(out)


def check_gradient(prim: LCPrimitive, n: int = 100, seed: int = 0,
                   atol: float = 1e-5, rtol: float = 1e-4) -> bool:
    """Cross-check the forward-mode autodiff gradient of the pdf against
    numeric differencing (reference ``lcprimitives.py:146
    check_gradient``; here the analytic side is ``torch.func.jacfwd`` of
    the same torch evaluation core, on the host)."""
    rng = np.random.default_rng(seed)
    phases = rng.random(n)
    num = approx_gradient(prim, phases)
    ana = torch.func.jacfwd(
        lambda p: prim._pdf(torch.as_tensor(phases, dtype=torch.float64),
                            p))(torch.as_tensor(prim.p, dtype=torch.float64))
    ana = ana.detach().numpy().T
    return np.allclose(ana, num, atol=atol, rtol=rtol)


#: reference re-export (each template module offers isvector)
from pint_torch.templates.lcnorm import isvector  # noqa: E402,F401
