"""LCTemplate: a normalized pulse-profile model — mixture of primitives plus
uniform background (port of ``pint_tpu/templates/lctemplate.py``).

Mixture evaluation, parameter get/set across primitives + norms, random
draws, gaussian-template-file IO compatible with pygaussfit output.  The
mixture ``bg + sum n_i prim_i(phases)`` takes numpy phases on the host or a
``torch.Tensor`` of phases (of any shape, e.g. (walkers, photons)) on its
device, through the primitives' torch branches.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pint_torch.templates.lcnorm import NormAngles
from pint_torch.templates.lcprimitives import LCGaussian, LCPrimitive, _on

__all__ = ["LCTemplate", "prim_io", "make_twoside_gaussian",
           "gradient_derivative", "check_gradient_derivative"]


class LCTemplate:
    def __init__(self, primitives: List[LCPrimitive], norms):
        self.primitives = list(primitives)
        self.norms = norms if isinstance(norms, NormAngles) else NormAngles(norms)
        if self.norms.dim != len(self.primitives):
            raise ValueError("One norm per primitive required")

    def is_energy_dependent(self) -> bool:
        return any(getattr(x, "is_energy_dependent", lambda: False)()
                   for x in list(self.primitives) + [self.norms])

    # -- evaluation ----------------------------------------------------------
    def __call__(self, phases, log10_ens=None, suppress_bg: bool = False):
        """Template density at the given phases; with ``log10_ens`` each
        photon is evaluated at its own energy (energy-dependent primitives /
        norms drift their parameters; reference ``lceprimitives.py`` /
        ``lcenorm.py`` semantics)."""
        if log10_ens is None:
            log10_ens = getattr(self, "_fixed_log10_en", None)
        if log10_ens is None:
            norms = self.norms()
            bg = 1.0 - norms.sum()
            out = bg if not suppress_bg else 0.0
            for n, prim in zip(norms, self.primitives):
                out = out + n * prim(phases)
            if suppress_bg:
                out = out / _on(norms.sum(), out)
            return out
        phases = np.atleast_1d(np.asarray(phases, dtype=np.float64))
        try:
            norms = self.norms(log10_ens)  # (N, ncomp) if energy-dependent
        except TypeError:
            norms = np.broadcast_to(self.norms(), (len(phases),
                                                   self.norms.dim))
        norms = np.atleast_2d(norms)
        bgsum = norms.sum(axis=1)
        out = np.zeros(len(phases)) if suppress_bg else 1.0 - bgsum
        for i, prim in enumerate(self.primitives):
            try:
                dens = np.asarray(prim(phases, log10_ens))
            except TypeError:  # energy-independent component
                dens = np.asarray(prim(phases))
            out = out + norms[:, i] * dens
        if suppress_bg:
            out = out / bgsum
        return out

    def gradient_phases(self, phases, eps: float = 1e-7):
        """d(template)/d(phase) by central difference (host path)."""
        return (self(np.asarray(phases) + eps) - self(np.asarray(phases) - eps)) / (2 * eps)

    def integrate(self, x1: float = 0.0, x2: float = 1.0) -> float:
        norms = self.norms()
        bg = 1.0 - norms.sum()
        return float(bg * (x2 - x1) + sum(
            n * p.integrate(x1, x2) for n, p in zip(norms, self.primitives)))

    # -- parameter plumbing --------------------------------------------------
    def num_parameters(self, free: bool = True) -> int:
        return sum(p.num_parameters(free) for p in self.primitives) + \
            self.norms.num_parameters(free)

    def get_parameters(self, free: bool = True) -> np.ndarray:
        return np.concatenate(
            [p.get_parameters(free) for p in self.primitives]
            + [self.norms.get_parameters(free)])

    def set_parameters(self, pars, free: bool = True) -> bool:
        pars = np.asarray(pars, dtype=np.float64)
        i = 0
        for p in self.primitives:
            n = p.num_parameters(free)
            p.set_parameters(pars[i:i + n], free)
            i += n
        n = self.norms.num_parameters(free)
        self.norms.set_parameters(pars[i:i + n], free)
        return True

    def get_errors(self, free: bool = True) -> np.ndarray:
        """Stored parameter errors (set by :meth:`set_errors` / the
        fitters), free-masked by default; zeros when never set."""
        out = []
        for p in self.primitives:
            e = np.asarray(getattr(p, "errors", np.zeros_like(
                np.asarray(p.p, dtype=np.float64))), dtype=np.float64)
            out.append(e[np.asarray(p.free, dtype=bool)] if free else e)
        ne = self.norms.get_errors(free=free) \
            if hasattr(self.norms, "get_errors") \
            else np.zeros(len(self.norms.get_parameters(free=free)))
        out.append(np.asarray(ne, dtype=np.float64))
        return np.concatenate(out)

    def get_location(self) -> float:
        """Location of the highest-amplitude peak."""
        norms = self.norms()
        i = int(np.argmax(norms))
        return self.primitives[i].get_location()

    def get_amplitudes(self) -> np.ndarray:
        return self.norms()

    # -- sampling ------------------------------------------------------------
    def random(self, n: int, rng=None) -> np.ndarray:
        """Draw n photon phases from the template: multinomial split over
        (background, components), each primitive drawing analytically where
        it can (reference ``lctemplate.py random`` technique); rejection
        sampling is the per-primitive fallback."""
        rng = rng or np.random.default_rng()
        if not all(getattr(p, "mixture_safe", True) for p in self.primitives):
            # Fourier-style components are not standalone densities (their
            # pdfs dip negative); only whole-template rejection is valid
            return self._random_rejection(n, rng)
        norms = np.asarray(self.norms(), dtype=np.float64)
        probs = np.concatenate([[max(1.0 - norms.sum(), 0.0)], norms])
        probs = probs / probs.sum()
        counts = rng.multinomial(n, probs)
        parts = [rng.random(counts[0])]  # uniform background
        for c, prim in zip(counts[1:], self.primitives):
            if c:
                parts.append(np.asarray(prim.random(int(c), rng=rng)))
        out = np.concatenate(parts)
        rng.shuffle(out)
        return out

    def _random_rejection(self, n: int, rng) -> np.ndarray:
        grid = np.linspace(0, 1, 2048)
        fmax = float(np.max(self(grid))) * 1.05
        out = np.empty(0)
        while len(out) < n:
            m = int((n - len(out)) * 1.5 * fmax) + 16
            x = rng.random(m)
            keep = rng.random(m) * fmax < np.asarray(self(x))
            out = np.concatenate([out, x[keep]])
        return out[:n]

    def rotate(self, dphi: float):
        for p in self.primitives:
            p.set_location((p.get_location() + dphi) % 1.0)

    # -- reference user-API long tail (templates/lctemplate.py) ------------
    def copy(self) -> "LCTemplate":
        """Deep copy (reference ``lctemplate.py copy``)."""
        import copy as _copy

        return _copy.deepcopy(self)

    def _norms_energy_dependent(self) -> bool:
        return getattr(self.norms, "is_energy_dependent", lambda: False)()

    def _require_plain_norms(self, what: str) -> None:
        if self._norms_energy_dependent():
            raise NotImplementedError(
                f"{what} on an energy-dependent template would silently "
                "discard the norm slopes; take get_fixed_energy_version() "
                "first or edit the ENormAngles directly")

    def add_primitive(self, prim, norm: float = 0.1) -> None:
        """Append a pulse component with amplitude ``norm``, scaling the
        existing amplitudes by (1 - norm) so the total stays normalized
        (reference ``lctemplate.py add_primitive``)."""
        self._require_plain_norms("add_primitive")
        amps = self.get_amplitudes()
        new = np.concatenate([amps * (1.0 - norm), [norm]])
        old_free = np.asarray(self.norms.free, dtype=bool)
        self.primitives.append(prim)
        self.norms = NormAngles(new)
        self.norms.free[:len(old_free)] = old_free

    def delete_primitive(self, index: int = -1) -> None:
        """Remove a pulse component, redistributing its amplitude over the
        rest (reference ``lctemplate.py delete_primitive``)."""
        if len(self.primitives) == 1:
            raise ValueError("Template must retain at least one component")
        self._require_plain_norms("delete_primitive")
        amps = self.get_amplitudes()
        keep = np.delete(amps, index)
        total = keep.sum()
        if total > 0:
            keep = keep * amps.sum() / total
        old_free = np.delete(np.asarray(self.norms.free, dtype=bool), index)
        self.primitives.pop(index)
        self.norms = NormAngles(keep)
        self.norms.free[:] = old_free

    def cdf(self, x, log10_ens=None) -> np.ndarray:
        """Cumulative profile on [0, 1] (reference ``lctemplate.py
        cdf``), by dense trapezoid integration of the pdf."""
        grid = np.linspace(0.0, 1.0, 2049)
        pdf = np.asarray(self(grid, log10_ens=log10_ens))
        c = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5
                                             * np.diff(grid))])
        c /= c[-1]
        # clip, not mod: cdf(1.0) must be 1, not wrap to cdf(0)
        return np.interp(np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0),
                         grid, c)

    def norm(self) -> float:
        """Total pulsed fraction (sum of component amplitudes; reference
        ``lctemplate.py norm``)."""
        return float(np.sum(self.get_amplitudes()))

    def delta(self, index=None) -> float:
        """Radio-lag-convention peak position Delta (reference
        ``lctemplate.py delta``): location of the highest-amplitude (or
        ``index``-th) component.  Delegates to :meth:`get_location` so
        "peak" has exactly one definition."""
        if index is None:
            return float(self.get_location())
        return float(self.primitives[int(index)].get_location())

    #: reference spelling
    Delta = delta

    def get_fixed_energy_version(self, log10_en: float = 3.0) -> "LCTemplate":
        """Snapshot pinned at ``log10_en`` (reference ``lctemplate.py
        get_fixed_energy_version``): the copy evaluates energy-dependent
        primitives/norms at that energy whenever no per-photon energies are
        given; energy-independent templates copy unchanged."""
        out = self.copy()
        if self.is_energy_dependent():
            out._fixed_log10_en = np.atleast_1d(np.float64(log10_en))
        return out

    def closest_to_peak(self, phases) -> float:
        """Smallest |phase - peak| over the given phases (reference
        ``lctemplate.py closest_to_peak``)."""
        d = np.abs((np.asarray(phases, dtype=np.float64)
                    - self.delta() + 0.5) % 1.0 - 0.5)
        return float(np.min(d))

    def mean_value(self, phases, log10_ens=None) -> float:
        """Mean template value over the given phases."""
        return float(np.mean(np.asarray(self(phases,
                                             log10_ens=log10_ens))))

    def max_value(self, resolution: int = 2048) -> float:
        """Maximum of the profile on a dense grid."""
        grid = np.linspace(0.0, 1.0, int(resolution), endpoint=False)
        return float(np.max(np.asarray(self(grid))))

    def check_bounds(self) -> bool:
        """True when every free parameter is inside its domain (reference
        ``lctemplate.py check_bounds``)."""
        try:
            p = self.get_parameters()
            return bool(np.all(np.isfinite(p)))
        except Exception:
            return False

    def approx_gradient(self, phases, log10_ens=None,
                        eps: float = 1e-6, free: bool = True) -> np.ndarray:
        """(nparam, nphase) finite-difference gradient of the pdf wrt the
        free (or, with ``free=False``, all) parameters (reference
        ``lctemplate.py approx_gradient``)."""
        p0 = self.get_parameters(free=free).copy()
        out = np.empty((len(p0), len(np.atleast_1d(phases))))
        for i in range(len(p0)):
            for s, sign in ((eps, +1.0), (-2 * eps, -1.0)):
                p0[i] += s
                self.set_parameters(p0, free=free)
                v = np.asarray(self(phases, log10_ens=log10_ens))
                if sign > 0:
                    hi = v
                else:
                    lo = v
            p0[i] += eps
            self.set_parameters(p0, free=free)
            out[i] = (hi - lo) / (2 * eps)
        return out

    #: reference offers both spellings
    approx_derivative = approx_gradient

    def check_gradient(self, phases=None, quiet: bool = True) -> bool:
        """Self-consistency of the finite-difference gradient at two eps
        scales (reference ``lctemplate.py check_gradient``)."""
        if phases is None:
            phases = np.linspace(0.05, 0.95, 19)
        g1 = self.approx_gradient(phases, eps=1e-5)
        g2 = self.approx_gradient(phases, eps=1e-6)
        ok = np.allclose(g1, g2, rtol=1e-2, atol=1e-6)
        if not quiet and not ok:
            print("check_gradient: eps-scales disagree")
        return bool(ok)

    def set_overall_phase(self, ph: float) -> None:
        """Move the FIRST component's peak to phase ``ph``, shifting every
        component rigidly (reference ``lctemplate.py:313``; delegates to
        :meth:`rotate`)."""
        self.rotate(float(ph) - self.primitives[0].get_location())

    def norm_ok(self) -> bool:
        """Total amplitude within [0, 1] (reference
        ``lctemplate.py:339``)."""
        return self.norm() <= 1.0

    def has_bridge(self) -> bool:
        """Reference ``lctemplate.py:86``: bridge components are modeled
        as ordinary wide primitives here."""
        return False

    def max(self, resolution: int = 2048) -> float:
        """Maximum of the profile (reference spelling of
        :meth:`max_value`)."""
        return self.max_value(resolution=resolution)

    def get_parameter_names(self, free: bool = True) -> list:
        """Flat parameter-name list, primitives then norms (reference
        ``lctemplate.py get_parameter_names``)."""
        out = []
        for i, prim in enumerate(self.primitives):
            n = prim.num_parameters(free=free)
            base = getattr(prim, "name", type(prim).__name__)
            out += [f"P{i}_{base}_p{j}" for j in range(n)]
        out += [f"Norm_a{j}" for j in
                range(len(self.norms.get_parameters(free=free)))]
        return out

    def get_free_mask(self) -> np.ndarray:
        """Boolean mask of free entries over the full parameter vector
        (reference ``lctemplate.py get_free_mask``)."""
        masks = [np.asarray(p.free, dtype=bool) for p in self.primitives]
        masks.append(np.asarray(self.norms.free, dtype=bool))
        return np.concatenate(masks)

    def free_parameters(self) -> None:
        """Unfreeze everything (reference ``lctemplate.py
        free_parameters``)."""
        for p in self.primitives:
            p.free[:] = True
        self.norms.free[:] = True

    def freeze_parameters(self) -> None:
        """Freeze everything (reference ``lctemplate.py
        freeze_parameters``)."""
        for p in self.primitives:
            p.free[:] = False
        self.norms.free[:] = False

    def set_errors(self, errs, free: bool = True) -> None:
        """Distribute a flat (free-length by default) error vector onto the
        components (reference ``lctemplate.py set_errors``); each component
        stores a FULL-length vector so its free mask indexes it."""
        errs = np.asarray(errs, dtype=np.float64)
        i = 0
        for p in self.primitives:
            n = p.num_parameters(free=free)
            sub = errs[i:i + n]
            if free:
                full = np.zeros_like(np.asarray(p.p, dtype=np.float64))
                full[np.asarray(p.free, dtype=bool)] = sub
                p.errors = full
            else:
                p.errors = sub.copy()
            i += n
        self.norms.set_errors(errs[i:], free=free)

    def derivative(self, phases, log10_ens=None,
                   eps: float = 1e-6) -> np.ndarray:
        """d(pdf)/d(phase) by central difference (reference
        ``lctemplate.py derivative``); one implementation shared with
        :meth:`gradient_phases`."""
        if log10_ens is None:
            return self.gradient_phases(phases, eps=eps)
        ph = np.asarray(phases, dtype=np.float64)
        hi = np.asarray(self((ph + eps) % 1.0, log10_ens=log10_ens))
        lo = np.asarray(self((ph - eps) % 1.0, log10_ens=log10_ens))
        return (hi - lo) / (2 * eps)

    def gradient(self, phases, log10_ens=None, free: bool = True):
        """Gradient of the pdf wrt the (free or all) parameters — the
        finite-difference implementation (reference has hand-coded
        gradients; autodiff/FD replaces them here)."""
        return self.approx_gradient(phases, log10_ens=log10_ens, free=free)

    def approx_hessian(self, phases, log10_ens=None,
                       eps: float = 1e-4) -> np.ndarray:
        """(nparam, nparam, nphase) finite-difference Hessian of the pdf
        (reference ``lctemplate.py approx_hessian``)."""
        p0 = self.get_parameters().copy()
        n = len(p0)
        ph = np.atleast_1d(np.asarray(phases, dtype=np.float64))

        def f(p):
            self.set_parameters(p)
            return np.asarray(self(ph, log10_ens=log10_ens))

        H = np.empty((n, n, len(ph)))
        for i in range(n):
            for j in range(i, n):
                pp = p0.copy(); pp[i] += eps; pp[j] += eps; fpp = f(pp)
                pm = p0.copy(); pm[i] += eps; pm[j] -= eps; fpm = f(pm)
                mp = p0.copy(); mp[i] -= eps; mp[j] += eps; fmp = f(mp)
                mm = p0.copy(); mm[i] -= eps; mm[j] -= eps; fmm = f(mm)
                H[i, j] = H[j, i] = (fpp - fpm - fmp + fmm) / (4 * eps**2)
        self.set_parameters(p0)
        return H

    hessian = approx_hessian

    def check_derivative(self, phases=None, eps: float = 1e-6,
                         quiet: bool = True) -> bool:
        """Phase-derivative self-consistency at two eps scales (reference
        ``lctemplate.py check_derivative``)."""
        if phases is None:
            phases = np.linspace(0.05, 0.95, 19)
        d1 = self.derivative(phases, eps=eps)
        d2 = self.derivative(phases, eps=eps * 10)
        return bool(np.allclose(d1, d2, rtol=1e-2, atol=1e-4))

    def single_component(self, index: int) -> "LCTemplate":
        """Template of one component alone at unit amplitude (reference
        ``lctemplate.py single_component``)."""
        import copy as _copy

        return LCTemplate([_copy.deepcopy(self.primitives[index])], [1.0])

    def mean_single_component(self, index: int, phases,
                              log10_ens=None) -> float:
        """Mean pdf of one component over the given phases."""
        return float(np.mean(np.asarray(
            self.single_component(index)(phases, log10_ens=log10_ens))))

    def _permute_norms(self, order) -> None:
        """Reorder norm components in place, preserving the norms object
        TYPE (ENormAngles keeps its slopes) and free mask."""
        if self._norms_energy_dependent():
            amps = self.norms._angles_to_norms(self.norms.p[:self.norms.dim])
            angles = self.norms._norms_to_angles(amps[order])
            self.norms.p[:self.norms.dim] = angles
            self.norms.p[self.norms.dim:] = self.norms.p[self.norms.dim:][order]
            f = self.norms.free
            f[:self.norms.dim] = f[:self.norms.dim][order]
            f[self.norms.dim:] = f[self.norms.dim:][order]
        else:
            amps = self.get_amplitudes()
            free = np.asarray(self.norms.free, dtype=bool)[order]
            self.norms.p[:] = self.norms._norms_to_angles(amps[order])
            self.norms.free[:] = free

    def order_primitives(self) -> None:
        """Sort components by peak location (reference
        ``lctemplate.py order_primitives``)."""
        order = np.argsort([p.get_location() for p in self.primitives])
        self.primitives = [self.primitives[i] for i in order]
        self._permute_norms(order)

    def swap_primitive(self, i: int, j: int = None) -> None:
        """Swap two components (reference ``lctemplate.py
        swap_primitive``); default swaps ``i`` with ``i+1``."""
        j = i + 1 if j is None else j
        self.primitives[i], self.primitives[j] = \
            self.primitives[j], self.primitives[i]
        order = np.arange(len(self.primitives))
        order[i], order[j] = order[j], order[i]
        self._permute_norms(order)

    def get_gaussian_prior(self) -> "GaussianPrior":
        """Default gaussian prior over the free parameters: weak width
        priors on each primitive's parameters, none on the norms
        (reference ``lctemplate.py:288``)."""
        locs, widths, mods = [], [], []
        for prim in self.primitives:
            p = prim.get_parameters(free=False)
            locs += list(p)
            # generous widths: half the parameter scale, min 0.1
            widths += [max(0.1, abs(v) * 0.5) for v in p]
            # ONLY the actual location parameter lives on the circle:
            # energy-dependent primitives append slopes after the base
            # vector, so "last entry" would wrap a slope instead
            loc_idx = getattr(prim, "nb", len(p)) - 1
            mods += [k == loc_idx for k in range(len(p))]
        t = self.norms.get_parameters(free=False)
        locs += list(t)
        widths += [10.0] * len(t)  # effectively unconstrained
        mods += [False] * len(t)
        return GaussianPrior(locs, widths, mods, mask=self.get_free_mask())

    def prof_string(self, outputfile=None) -> str:
        """Tempo-style .prof text block (reference ``lctemplate.py
        prof_string``)."""
        lines = [f"# {type(p).__name__} loc={p.get_location():.6f}"
                 for p in self.primitives]
        s = "\n".join(lines) + "\n"
        if outputfile:
            with open(outputfile, "w") as f:
                f.write(s)
        return s

    def __repr__(self):
        lines = [f"LCTemplate: norms={self.norms()}, bg={1 - self.norms().sum():.4f}"]
        lines += [f"  {p!r}" for p in self.primitives]
        return "\n".join(lines)

    # -- IO ------------------------------------------------------------------
    def write_profile(self, fname: str):
        """pygaussfit-compatible ascii (const/phas/fwhm/ampl lines)."""
        norms = self.norms()
        with open(fname, "w") as f:
            f.write(f"const = {1 - norms.sum():.6f}\n")
            for n, p in zip(norms, self.primitives):
                f.write(f"phas{1} = {p.get_location():.6f}\n"
                        .replace("phas1", "phas"))
                f.write(f"fwhm = {p.get_width() * 2.35482:.6f}\n")
                f.write(f"ampl = {n:.6f}\n")


def prim_io(template: str):
    """Read a pygaussfit-style gaussian template file -> (primitives, norms)
    (reference ``lctemplate.py`` gaussian reader used by event_optimize)."""
    phass, ampls, fwhms = [], [], []
    for line in open(template):
        ls = line.lstrip()
        if ls.startswith("phas"):
            phass.append(float(line.split("=")[-1].split()[0]))
        elif ls.startswith("ampl"):
            ampls.append(float(line.split("=")[-1].split()[0]))
        elif ls.startswith("fwhm"):
            fwhms.append(float(line.split("=")[-1].split()[0]))
    if not (len(phass) == len(ampls) == len(fwhms)) or not phass:
        raise ValueError(f"Malformed gaussian template file {template}")
    prims = [LCGaussian([f / 2.35482, ph % 1.0]) for ph, f in zip(phass, fwhms)]
    norms = np.asarray(ampls, dtype=np.float64)
    total = norms.sum()
    if total > 1.0:
        # renormalize with a 1-ulp margin: a/total can still sum above 1.0
        # in float64, which NormAngles rightly rejects
        norms = norms / (total * (1.0 + 1e-12))
    return prims, list(norms)


def gauss_template_from_file(fname: str) -> LCTemplate:
    prims, norms = prim_io(fname)
    return LCTemplate(prims, norms)


def make_twoside_gaussian(center: float, width1: float, width2: float,
                          norm: float = 1.0) -> LCTemplate:
    """Asymmetric peak approximated by two half-weighted gaussians
    (reference helper)."""
    g1 = LCGaussian([width1, center])
    g2 = LCGaussian([width2, center])
    return LCTemplate([g1, g2], [norm / 2, norm / 2])


#: reference re-export (each template module offers isvector)
from pint_torch.templates.lcnorm import isvector  # noqa: E402,F401


# ---------------------------------------------------------------------------
# template factory helpers (reference lctemplate.py:892-948,975)
# ---------------------------------------------------------------------------

def get_gauss1(pulse_frac=1, x1=0.5, width1=0.01) -> LCTemplate:
    """One-gaussian template (reference ``lctemplate.py:923``)."""
    return LCTemplate([LCGaussian(p=[width1, x1])], [pulse_frac])


def get_gauss2(pulse_frac=1, x1=0.1, x2=0.55, ratio=1.5,
               width1=0.01, width2=0.02, lorentzian=False,
               bridge_frac=0, skew=False) -> LCTemplate:
    """Two-peak template, optionally Lorentzian/skewed/bridged (reference
    ``lctemplate.py:892``)."""
    from pint_torch.templates.lcprimitives import (LCGaussian2, LCLorentzian,
                                                 LCLorentzian2)

    n1, n2 = (np.asarray([ratio, 1.0]) * (1 - bridge_frac)
              * (pulse_frac / (1.0 + ratio)))
    if skew:
        prim = LCLorentzian2 if lorentzian else LCGaussian2
        p1 = [width1, width1 * (1 + skew), x1]
        p2 = [width2 * (1 + skew), width2, x2]
    else:
        if lorentzian:
            # NO 2*pi conversion: this port's LCLorentzian takes gamma in
            # phase units (the reference's engine works in radians)
            prim = LCLorentzian
        else:
            prim = LCGaussian
        p1, p2 = [width1, x1], [width2, x2]
    if bridge_frac > 0:
        nb = bridge_frac * pulse_frac
        b = LCGaussian(p=[0.1, (x2 + x1) / 2])
        return LCTemplate([prim(p=p1), b, prim(p=p2)], [n1, nb, n2])
    return LCTemplate([prim(p=p1), prim(p=p2)], [n1, n2])


def get_2pb(pulse_frac=0.9, lorentzian=False) -> LCTemplate:
    """Two peaks + gaussian bridge (reference ``lctemplate.py:928``)."""
    from pint_torch.templates.lcprimitives import LCLorentzian

    prim = LCLorentzian if lorentzian else LCGaussian
    p1 = prim(p=[0.03, 0.1])
    b = LCGaussian(p=[0.15, 0.3])
    p2 = prim(p=[0.03, 0.55])
    return LCTemplate([p1, b, p2], [0.3 * pulse_frac, 0.4 * pulse_frac,
                                    0.3 * pulse_frac])


def adaptive_samples(func, npt: int, log10_ens=3, nres: int = 200):
    """Phase sample points concentrated where ``func`` varies fastest
    (reference ``lctemplate.py:950``): inverse-CDF placement on the
    |df/dphi|-weighted measure."""
    grid = np.linspace(0.0, 1.0, nres + 1)
    try:
        vals = np.asarray(func(grid, log10_ens))
    except TypeError:
        vals = np.asarray(func(grid))
    dens = np.abs(np.gradient(vals)) + 1e-9
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (dens[1:] + dens[:-1]))])
    cdf /= cdf[-1]
    return np.interp(np.linspace(0.0, 1.0, npt), cdf, grid)


class GaussianPrior:
    """Quadratic (gaussian) penalty on selected template parameters
    (reference ``lctemplate.py:975``; used by the template MCMC)."""

    def __init__(self, locations, widths, mod, mask=None):
        locations = np.asarray(locations, dtype=np.float64)
        self.mod = np.asarray(mod, dtype=bool)
        self.x0 = np.where(self.mod, np.mod(locations, 1), locations)
        self.s0 = np.asarray(widths, dtype=np.float64) * 2**0.5
        if mask is None:
            self.mask = np.ones(len(locations), dtype=bool)
        else:
            self.mask = np.asarray(mask, dtype=bool)
            self.x0 = self.x0[self.mask]
            self.s0 = self.s0[self.mask]
            self.mod = self.mod[self.mask]

    def __len__(self) -> int:
        return int(self.mask.sum())

    def __call__(self, parameters) -> float:
        if not np.any(self.mask):
            return 0.0
        p = np.asarray(parameters, dtype=np.float64)[self.mask]
        p = np.where(self.mod, np.mod(p, 1), p)
        return float(np.sum(((p - self.x0) / self.s0) ** 2))

    def gradient(self, parameters) -> np.ndarray:
        parameters = np.asarray(parameters, dtype=np.float64)
        out = np.zeros(len(self.mask))
        if not np.any(self.mask):
            return out
        p = parameters[self.mask]
        p = np.where(self.mod, np.mod(p, 1), p)
        out[self.mask] = 2.0 * (p - self.x0) / self.s0**2
        return out


def gradient_derivative(templ, phases, eps: float = 1e-5) -> np.ndarray:
    """d/dphi of the parameter gradient, (nparam, nphase) — the mixed
    second derivative used by TOA-uncertainty propagation (reference
    ``lctemplate.py gradient_derivative``); central difference in phase of
    the same gradient the fit uses."""
    ph = np.asarray(phases, dtype=np.float64)
    gp = np.asarray(templ.gradient((ph + eps) % 1.0, free=False))
    gm = np.asarray(templ.gradient((ph - eps) % 1.0, free=False))
    return (gp - gm) / (2 * eps)


def check_gradient_derivative(templ, n: int = 10001, quiet: bool = True):
    """Validate :func:`gradient_derivative` against coarse differencing of
    the gradient over a phase grid (reference ``lctemplate.py:1065``).
    Returns ``(pcs, gd, ngd)`` — bin centers, analytic-path values, and the
    numeric reference."""
    dom = np.linspace(0, 1, n)
    pcs = 0.5 * (dom[:-1] + dom[1:])
    g = np.asarray(templ.gradient(dom, free=False))
    ngd = (g[:, 1:] - g[:, :-1]) / (dom[1] - dom[0])
    gd = gradient_derivative(templ, pcs)
    if not quiet:
        for i in range(gd.shape[0]):
            print(f"param {i}: max |delta| = {np.max(np.abs(gd[i] - ngd[i])):.3g}")
    return pcs, gd, ngd
