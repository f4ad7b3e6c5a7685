"""TEMPO-style polycos: piecewise polynomial phase predictors (port of
``pint_tpu/polycos.py``: ``PolycoEntry`` ``:33``, ``Polycos`` ``:97``, the
host generator ``:106``, the TEMPO table reader and writer ``:278,300``).

Evaluation semantics (TEMPO convention): with dt = (t - tmid) in minutes,

    phase(t) = rphase + 60 * f0 * dt + sum_{i} c_i * dt^i
    freq(t)  = f0 + (1/60) * sum_{i>=1} i * c_i * dt^(i-1)

Generation fits the residual polynomial (after removing the linear
60*f0*dt ramp) with a least-squares Vandermonde solve on Chebyshev-spaced
nodes; all segments' nodes are one host-layer TOA table evaluated by the
model in one batch, and the fits run on the host in numpy (the batched
device generator is :mod:`pint_torch.predict.generate`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pint_torch.logging import log
from pint_torch.phase import Phase

__all__ = ["PolycoEntry", "Polycos", "tempo_polyco_table_reader",
           "tempo_polyco_table_writer"]

MIN_PER_DAY = 1440.0


class PolycoEntry:
    def __init__(self, tmid: float, mjdspan_min: float, rphase_int: int,
                 rphase_frac: float, f0: float, ncoeff: int, coeffs,
                 obs: str = "@", obsfreq: float = 1400.0, psrname: str = "",
                 binary_phase: Optional[float] = None):
        self.tmid = float(tmid)
        self.mjdspan = float(mjdspan_min)
        self.rphase_int = int(rphase_int)
        self.rphase_frac = float(rphase_frac)
        self.f0 = float(f0)
        self.ncoeff = int(ncoeff)
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.obs = obs
        self.obsfreq = float(obsfreq)
        self.psrname = psrname
        self.binary_phase = binary_phase

    @property
    def tstart(self) -> float:
        return self.tmid - self.mjdspan / (2 * MIN_PER_DAY)

    @property
    def tstop(self) -> float:
        return self.tmid + self.mjdspan / (2 * MIN_PER_DAY)

    def valid(self, t_mjd) -> np.ndarray:
        t = np.asarray(t_mjd, dtype=np.float64)
        return (t >= self.tstart) & (t < self.tstop)

    def evalabsphase(self, t_mjd) -> Phase:
        """Absolute phase as an (int, frac) Phase."""
        dt_min = (np.asarray(t_mjd, dtype=np.longdouble) - np.longdouble(self.tmid)) * MIN_PER_DAY
        dt64 = np.asarray(dt_min, dtype=np.float64)
        poly = np.zeros_like(dt64)
        for i in range(self.ncoeff - 1, -1, -1):
            poly = poly * dt64 + self.coeffs[i]
        # carry the big linear ramp in longdouble, split int/frac exactly
        ramp = np.longdouble(60.0) * np.longdouble(self.f0) * dt_min
        total = (np.longdouble(self.rphase_int)
                 + np.longdouble(self.rphase_frac) + ramp
                 + np.asarray(poly, dtype=np.longdouble))
        ip = np.floor(total)
        return Phase(np.asarray(ip, dtype=np.float64),
                     np.asarray(total - ip, dtype=np.float64))

    def evalphase(self, t_mjd) -> np.ndarray:
        """Fractional phase in [0, 1)."""
        return np.asarray(self.evalabsphase(t_mjd).frac) % 1.0

    def evalfreq(self, t_mjd) -> np.ndarray:
        dt = (np.asarray(t_mjd, dtype=np.float64) - self.tmid) * MIN_PER_DAY
        out = np.zeros_like(dt)
        for i in range(self.ncoeff - 1, 0, -1):
            out = out * dt + i * self.coeffs[i]
        return self.f0 + out / 60.0

    def evalfreqderiv(self, t_mjd) -> np.ndarray:
        dt = (np.asarray(t_mjd, dtype=np.float64) - self.tmid) * MIN_PER_DAY
        out = np.zeros_like(dt)
        for i in range(self.ncoeff - 1, 1, -1):
            out = out * dt + i * (i - 1) * self.coeffs[i]
        return out / 3600.0


class Polycos:
    """A set of PolycoEntry segments with dispatch by epoch
    (reference ``polycos.py:484``)."""

    def __init__(self, entries: Optional[List[PolycoEntry]] = None):
        self.entries: List[PolycoEntry] = entries or []

    # -- generation ----------------------------------------------------------
    @classmethod
    def generate_polycos(cls, model, mjdStart: float, mjdEnd: float,
                         obs: str, segLength: float = 60.0, ncoeff: int = 12,
                         obsFreq: float = 1400.0) -> "Polycos":
        """Fit per-segment polynomials to the model phase
        (reference ``polycos.py:~700 generate_polycos``).  segLength in
        minutes."""
        from pint_torch.toa import TOAs
        from pint_torch.observatory import get_observatory

        obsname = get_observatory(obs).name
        span_d = segLength / MIN_PER_DAY
        nseg = max(1, int(np.ceil((mjdEnd - mjdStart) / span_d - 1e-9)))
        nnode = max(2 * ncoeff, ncoeff + 4)
        entries = []
        # Chebyshev-spaced nodes per segment, all segments in one TOA batch
        k = np.arange(nnode)
        cheb = np.cos(np.pi * (k + 0.5) / nnode)[::-1]  # (-1, 1)
        all_mjds = []
        tmids = []
        for s in range(nseg):
            t0 = mjdStart + s * span_d
            # quantize tmid to the TEMPO text format's %.11f precision UP
            # FRONT so the coefficients are fit against the exact value the
            # file will carry — otherwise the write/read round trip shifts
            # the evaluation epoch by up to 0.5e-11 d (~0.4 us) and the
            # prediction degrades by f0*dt (~3e-5 cycles at 60 Hz).
            # (find_entry's EDGE_TOL absorbs the ~1e-11 d coverage shifts
            # the rounding introduces at segment boundaries.)
            tmid = round(t0 + span_d / 2, 11)
            tmids.append(tmid)
            all_mjds.append(tmid + cheb * span_d / 2)
        mjds = np.concatenate(all_mjds)
        n = len(mjds)
        ts = TOAs(
            utc_mjd=np.asarray(mjds, dtype=np.longdouble),
            error_us=np.ones(n), freq_mhz=np.full(n, obsFreq),
            obs=np.array([obsname] * n, dtype=object),
            flags=[{} for _ in range(n)],
        )
        include_bipm = str(model["CLOCK"].value or "").upper() \
            .startswith("TT(BIPM")
        if obsname != "barycenter":
            ts.apply_clock_corrections(include_bipm=include_bipm)
        else:
            ts.clock_corr_s = np.zeros(n)
        ephem = model["EPHEM"].value or "DE440"
        ts.compute_TDBs(ephem=ephem)
        ts.compute_posvels(ephem=ephem,
                           planets=bool(model["PLANET_SHAPIRO"].value))
        ph = model.phase(ts, abs_phase="AbsPhase" in model.components)
        ph_int = ph.int_.cpu().numpy()
        ph_frac = ph.frac.cpu().numpy()
        f0 = float(model["F0"].value)
        psr = str(model["PSR"].value or "")
        for s in range(nseg):
            sl = slice(s * nnode, (s + 1) * nnode)
            tmid = tmids[s]
            dt_min = (mjds[sl] - tmid) * MIN_PER_DAY
            # reference phase: value at the node closest to tmid
            imid = np.argmin(np.abs(dt_min))
            rint = ph_int[sl][imid]
            rfrac = ph_frac[sl][imid]
            # target: phase - rphase - 60 f0 dt  (all small numbers)
            y = (ph_int[sl] - rint) + (ph_frac[sl] - rfrac) \
                - 60.0 * f0 * dt_min
            # fit in x = dt/halfspan (Vandermonde in raw minutes is
            # hopelessly ill-conditioned: 60^11 ~ 4e19), then rescale the
            # power-series coefficients back to per-minute powers for the
            # TEMPO evaluation convention
            half = segLength / 2.0
            V = np.vander(dt_min / half, ncoeff, increasing=True)
            cx, *_ = np.linalg.lstsq(V, y, rcond=None)
            coeffs = cx / half ** np.arange(ncoeff)
            resid = V @ cx - y
            rms = float(np.sqrt(np.mean(resid**2)))
            if rms > 1e-8:
                log.warning(f"polyco segment {s}: fit rms {rms:.2e} cycles")
            entries.append(PolycoEntry(
                tmid, segLength, int(rint), float(rfrac), f0, ncoeff, coeffs,
                obs=obsname, obsfreq=obsFreq, psrname=psr))
        return cls(entries)

    # -- dispatch ------------------------------------------------------------
    #: boundary tolerance [days]: segment edges derive from tmid values
    #: quantized to the file format's 1e-11-day precision, which can open
    #: ~1e-11-day gaps at the span boundaries; the polynomial is perfectly
    #: valid that far outside its nominal window
    EDGE_TOL = 1e-9

    def find_entry(self, t_mjd: float) -> PolycoEntry:
        for e in self.entries:
            if e.tstart <= t_mjd < e.tstop:
                return e
        best, dist = None, np.inf
        for e in self.entries:
            d = max(e.tstart - t_mjd, t_mjd - e.tstop, 0.0)
            if d < dist:
                best, dist = e, d
        if best is not None and dist <= self.EDGE_TOL:
            return best
        raise ValueError(f"No polyco entry covers MJD {t_mjd}")

    def eval_abs_phase(self, t_mjd) -> Phase:
        t = np.atleast_1d(np.asarray(t_mjd, dtype=np.float64))
        ints = np.empty(len(t))
        fracs = np.empty(len(t))
        for i, ti in enumerate(t):
            ph = self.find_entry(ti).evalabsphase(ti)
            ints[i] = np.asarray(ph.int_)
            fracs[i] = np.asarray(ph.frac)
        return Phase(ints, fracs)

    def eval_phase(self, t_mjd) -> np.ndarray:
        return np.asarray(self.eval_abs_phase(t_mjd).frac) % 1.0

    def eval_spin_freq(self, t_mjd) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t_mjd, dtype=np.float64))
        return np.array([float(self.find_entry(ti).evalfreq(ti)) for ti in t])

    def eval_spin_freq_derivative(self, t_mjd) -> np.ndarray:
        """Spin frequency derivative [Hz/s] at each time (reference
        ``polycos.py:1008``)."""
        t = np.atleast_1d(np.asarray(t_mjd, dtype=np.float64))
        return np.array([float(self.find_entry(ti).evalfreqderiv(ti))
                         for ti in t])

    # -- IO ------------------------------------------------------------------
    def write_polyco_file(self, filename: str):
        tempo_polyco_table_writer(self.entries, filename)

    @classmethod
    def read_polyco_file(cls, filename: str) -> "Polycos":
        return cls(tempo_polyco_table_reader(filename))

    #: reference-parity alias (``polycos.py:549``)
    read = read_polyco_file

    #: registered file formats: {name: {"read": fn, "write": fn}}
    polycoFormats: dict = {"tempo": {"read": None, "write": None}}

    @classmethod
    def add_polyco_file_format(cls, formatName: str, methodMood: str,
                               readMethod=None, writeMethod=None) -> None:
        """Register a custom polyco file format (reference
        ``polycos.py:567``): ``methodMood`` in 'r'/'w'/'rw'; the read
        method takes a filename and returns a list of PolycoEntry, the
        write method takes (entries, filename)."""
        if methodMood not in ("r", "w", "rw"):
            raise ValueError("methodMood must be 'r', 'w', or 'rw'")
        if "r" in methodMood and readMethod is None:
            raise ValueError(f"format {formatName!r}: mood {methodMood!r} "
                             "needs a readMethod")
        if "w" in methodMood and writeMethod is None:
            raise ValueError(f"format {formatName!r}: mood {methodMood!r} "
                             "needs a writeMethod")
        entry = cls.polycoFormats.setdefault(
            formatName, {"read": None, "write": None})
        if readMethod is not None:
            entry["read"] = readMethod
        if writeMethod is not None:
            entry["write"] = writeMethod

    @classmethod
    def read_polyco_file_format(cls, filename: str,
                                format: str = "tempo") -> "Polycos":
        """Read using a registered format (defaults to TEMPO)."""
        if format == "tempo":
            return cls.read_polyco_file(filename)
        fmt = cls.polycoFormats.get(format)
        if fmt is None or fmt["read"] is None:
            raise ValueError(f"No registered reader for format {format!r}")
        return cls(fmt["read"](filename))


def tempo_polyco_table_writer(entries: List[PolycoEntry], filename: str):
    """TEMPO polyco.dat format (reference ``polycos.py:360``)."""
    with open(filename, "w") as f:
        for e in entries:
            mjd_int = int(e.tmid)
            mjd_frac = e.tmid - mjd_int
            date = "DD-MMM-YY"
            utc = f"{(mjd_frac * 24):02.0f}0000.00"
            f.write(f"{e.psrname:<10s} {date:>9s} {utc:>11s} "
                    f"{e.tmid:20.11f} {0.0:21.6f} {0.0:6.3f} {-6.0:7.3f}\n")
            # Phase frac lives in [-0.5, 0.5): recombine and split so the
            # written reference phase never gains a spurious cycle
            total = e.rphase_int + e.rphase_frac
            ip = int(np.floor(total))
            rphase = f"{ip}.{f'{total - ip:.6f}'[2:]}"
            f.write(f"{rphase:>20s} {e.f0:18.12f} {e.obs:>5s} "
                    f"{e.mjdspan:5.0f} {e.ncoeff:5d} {e.obsfreq:10.3f}\n")
            for i in range(0, e.ncoeff, 3):
                row = e.coeffs[i:i + 3]
                f.write("".join(f"{c:25.17e}" for c in row) + "\n")


def tempo_polyco_table_reader(filename: str) -> List[PolycoEntry]:
    """Parse a TEMPO polyco.dat (reference ``polycos.py:232``)."""
    entries = []
    with open(filename) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        h1 = lines[i].split()
        psrname = h1[0]
        tmid = float(h1[3])
        h2 = lines[i + 1].split()
        rphase_s = h2[0]
        f0 = float(h2[1])
        obs = h2[2]
        span = float(h2[3])
        ncoeff = int(h2[4])
        obsfreq = float(h2[5])
        if "." in rphase_s:
            ip, fp = rphase_s.split(".")
            rint, rfrac = int(ip), float("0." + fp)
        else:
            rint, rfrac = int(rphase_s), 0.0
        ncl = (ncoeff + 2) // 3
        coeffs = []
        for j in range(ncl):
            coeffs += [float(x.replace("D", "E"))
                       for x in lines[i + 2 + j].split()]
        entries.append(PolycoEntry(tmid, span, rint, rfrac, f0, ncoeff,
                                   coeffs[:ncoeff], obs=obs, obsfreq=obsfreq,
                                   psrname=psrname))
        i += 2 + ncl
    return entries
