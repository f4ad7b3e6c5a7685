"""IFUNC: tabulated phase offsets (port of ``pint_tpu/models/ifunc.py:
23-72``): phase += F0 interp(t), t the barycentric MJD, on the (MJD,
offset [s]) points of the pair parameters IFUNCk, sorted on the host
(context ``x``, ``y``).  SIFUNC 0 takes the preceding point's value (the
first one's before it), SIFUNC 2 interpolates linearly with flat
extrapolation, by :func:`interp`, ``jnp.interp``'s formula."""

from __future__ import annotations

import numpy as np
import torch

from pint_torch.exceptions import MissingParameter
from pint_torch.models.parameter import intParameter, pairParameter
from pint_torch.models.timing_model import PhaseComponent
from pint_torch.phase import Phase

__all__ = ["IFunc", "interp"]

DAY_S = 86400.0
#: jnp.interp's threshold below which an interval counts as empty
_EPS = float(np.spacing(np.finfo(np.float64).eps))


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` term for term: the interval from a
    right-sided search clipped to [1, n-1], fp[i-1] + (delta / dx) df (or
    fp[i-1] on an empty interval), fp[0] left of xp[0] and fp[-1] right of
    xp[-1]."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _EPS
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class IFunc(PhaseComponent):
    """Config: ``sifunc`` (0 or 2); context: ``x``, ``y`` (the sorted
    points)."""

    register = True
    category = "ifunc"

    def declare(self):
        self.add_param(intParameter("SIFUNC", continuous=False,
                                    description="Type of interpolation"))
        self.add_param(pairParameter(
            "IFUNC1", units="s", continuous=False,
            description="(MJD, offset) interpolation point"))

    def finish_config(self):
        self.config["sifunc"] = int(self._value("SIFUNC"))

    def validate(self):
        if self.SIFUNC.value is None:
            raise MissingParameter("IFunc", "SIFUNC")
        if int(self.SIFUNC.value) not in (0, 2):
            raise MissingParameter(
                "IFunc", "SIFUNC",
                f"Interpolation type {self.SIFUNC.value} not supported")

    def host_context(self, toas):
        """The IFUNCk points sorted by MJD (reference ``ifunc.py:46-59``)."""
        table = self._parent.params_table
        pts = []
        for n in self.params:
            v = table[n].value
            if n.startswith("IFUNC") and n[5:].isdigit() and v is not None:
                pts.append((float(v[0]), float(v[1])))
        pts.sort()
        return {"x": np.array([p[0] for p in pts]),
                "y": np.array([p[1] for p in pts])}

    def phase_func(self, pv, batch, ctx, delay):
        x, y = ctx["x"], ctx["y"]
        ts = (batch.tdb.hi + batch.tdb.lo) - delay / DAY_S
        ts = ts.contiguous()
        if int(self.config.get("sifunc", 0)) == 0:
            idx = torch.clamp(torch.searchsorted(x, ts) - 1, 0,
                              x.shape[0] - 1)
            times = y[idx]
        else:
            times = interp(ts, x, y)
        return Phase.from_float(times * pv.get("F0", 0.0))
