"""The device-side TOA batch (port of ``pint_tpu/toa.py:120-149``, with
the wideband DM data of ``:520-545``).

Positions are in light-seconds and velocities in ls/s; ``tdb`` is the
double-double TDB MJD and ``tdb_s`` the seconds since ``tdb0`` (an integer
MJD near the data midpoint) as an exact host-built pair.  Host ingest
(par/tim parsing, clocks, TDB, ephemeris) is not part of this package yet:
batches come from a snapshot of the reference package's state
(:mod:`pint_torch.bridge`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch.dd import DD

__all__ = ["TOABatch"]


@dataclass(frozen=True, eq=False)  # identity hash: batches key caches
class TOABatch:
    """Frozen TOA data as float64 tensors on one device."""

    tdb: DD                   # (N,) MJD, double-double
    tdb0: float               # reference MJD (integer-valued)
    tdb_s: DD                 # (N,) seconds since tdb0, exact pair
    freq: torch.Tensor        # (N,) MHz
    error_us: torch.Tensor    # (N,) microseconds
    ssb_obs_pos: torch.Tensor  # (N, 3) light-seconds
    ssb_obs_vel: torch.Tensor  # (N, 3) ls/s
    obs_sun_pos: torch.Tensor  # (N, 3) light-seconds
    planet_pos: Dict[str, torch.Tensor] = field(default_factory=dict)
    #: (N,) MJDs as float64 (the reference's ``toas.get_mjds()``), which the
    #: DMX masks and noise bases read on the host
    mjds: Optional[np.ndarray] = None
    #: the one-row batch of an absolute phase's TZR TOA
    tzr: bool = False
    #: (N,) wideband DM measurements and their uncertainties [pc/cm^3]
    #: (the reference's ``-pp_dm``/``-pp_dme`` flags), or None
    dm: Optional[torch.Tensor] = None
    dm_error: Optional[torch.Tensor] = None
    #: each component's context for these TOAs, by component name, where
    #: they are not the model's own TOAs (the TZR row); None: the
    #: components' own contexts apply
    contexts: Optional[dict] = None
    #: the solar-system ephemeris the TOAs were made with (the
    #: reference's ``toas.ephem``), or None
    ephem: Optional[str] = None

    @property
    def ntoas(self) -> int:
        return self.freq.shape[0]

    @property
    def device(self) -> torch.device:
        return self.freq.device

    @property
    def wideband(self) -> bool:
        """Every TOA carries a wideband DM measurement."""
        return self.ntoas > 0 and self.dm is not None

    def tdb_seconds(self) -> DD:
        return self.tdb_s

    def to(self, device) -> "TOABatch":
        """A copy of the batch on ``device``."""
        def mv(x):
            return x.to(device=device, dtype=F64)

        return TOABatch(
            tdb=DD(mv(self.tdb.hi), mv(self.tdb.lo)), tdb0=self.tdb0,
            tdb_s=DD(mv(self.tdb_s.hi), mv(self.tdb_s.lo)),
            freq=mv(self.freq), error_us=mv(self.error_us),
            ssb_obs_pos=mv(self.ssb_obs_pos), ssb_obs_vel=mv(self.ssb_obs_vel),
            obs_sun_pos=mv(self.obs_sun_pos),
            planet_pos={k: mv(v) for k, v in self.planet_pos.items()},
            mjds=self.mjds, tzr=self.tzr, ephem=self.ephem,
            dm=None if self.dm is None else mv(self.dm),
            dm_error=None if self.dm_error is None else mv(self.dm_error),
            contexts=None if self.contexts is None else {
                n: {k: v.to(device) if torch.is_tensor(v) else v
                    for k, v in c.items()}
                for n, c in self.contexts.items()})

    @classmethod
    def from_numpy(cls, arrays: dict, device, **kw) -> "TOABatch":
        """Build on ``device`` from host arrays keyed like the snapshot
        (``tdb_hi``, ``tdb_lo``, ``tdb0``, ``tdb_s_hi``, ``tdb_s_lo``,
        ``freq``, ``error_us``, ``ssb_obs_pos``, ``ssb_obs_vel``,
        ``obs_sun_pos``, ``planet_pos/<name>``, ``mjds`` and, for wideband
        TOAs, ``dm`` and ``dm_error``); ``kw`` sets ``tzr`` and
        ``contexts``."""
        def t(name):
            return torch.tensor(np.asarray(arrays[name], dtype=np.float64),
                                dtype=F64, device=device)

        planets = {k.split("/", 1)[1]: t(k) for k in arrays
                   if k.startswith("planet_pos/")}
        return cls(tdb=DD(t("tdb_hi"), t("tdb_lo")),
                   tdb0=float(arrays["tdb0"]),
                   tdb_s=DD(t("tdb_s_hi"), t("tdb_s_lo")),
                   freq=t("freq"), error_us=t("error_us"),
                   ssb_obs_pos=t("ssb_obs_pos"), ssb_obs_vel=t("ssb_obs_vel"),
                   obs_sun_pos=t("obs_sun_pos"), planet_pos=planets,
                   mjds=np.asarray(arrays["mjds"], dtype=np.float64),
                   dm=t("dm") if "dm" in arrays else None,
                   dm_error=t("dm_error") if "dm_error" in arrays else None,
                   **kw)
