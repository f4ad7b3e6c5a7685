"""Observatory registry: ground sites, special locations, clock chains, TDB.

Native counterpart of reference ``src/pint/observatory/`` (registry +
``TopoObs`` + special locations).  Each observatory provides:

* ``clock_corrections(utc_mjd, ...)`` — site clock chain -> UTC(GPS) -> UTC
  [+ TT(BIPM)-TT(TAI) when requested], in seconds (reference
  ``observatory/__init__.py:387``),
* ``get_TDBs(utc_mjd)`` — corrected UTC -> TDB MJD, longdouble (reference
  ``observatory/__init__.py:443``),
* ``posvel(utc_mjd, tdb_mjd, ephem)`` — site position/velocity wrt the SSB in
  km, km/s (reference ``observatory/__init__.py:507``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from pint_torch import ephemeris as ephem_mod
from pint_torch.earth import gcrs_posvel_from_itrf
from pint_torch.exceptions import NoClockCorrections
from pint_torch.logging import log
from pint_torch.observatory.clock_file import ClockFile, find_clock_file
from pint_torch.observatory.sites import SITES
from pint_torch.timescales import utc_to_tdb_mjd, utc_to_tt_mjd
from pint_torch.utils import PosVel

__all__ = ["Observatory", "TopoObs", "SpecialLocation",
           "load_special_locations", "BarycenterObs", "GeocenterObs",
           "T2SpacecraftObs",
           "get_observatory", "list_observatories",
           "update_clock_files", "export_all_clock_files",
           "load_observatories", "load_observatories_from_usual_locations"]

_registry: Dict[str, "Observatory"] = {}
_alias_map: Dict[str, str] = {}


class Observatory:
    """Base observatory: named location with clock chain and SSB posvel."""

    def __init__(self, name: str, aliases: List[str] = (), include_gps=True,
                 include_bipm=True, bipm_version="BIPM2021"):
        self.name = name.lower()
        self.aliases = [a.lower() for a in aliases]
        self.include_gps = include_gps
        self.include_bipm = include_bipm
        self.bipm_version = bipm_version
        _registry[self.name] = self
        _alias_map[self.name] = self.name
        for a in self.aliases:
            _alias_map.setdefault(a, self.name)

    # -- registry ----------------------------------------------------------
    @classmethod
    def get(cls, name: str) -> "Observatory":
        key = name.lower().strip()
        if key in _alias_map:
            return _registry[_alias_map[key]]
        raise KeyError(f"Unknown observatory {name!r}")

    @classmethod
    def names(cls):
        """All registered observatory names (an independent snapshot, so
        callers can register/clear while iterating; reference
        ``observatory/__init__.py:260``)."""
        _ensure_builtin()
        return list(_registry.keys())

    @classmethod
    def names_and_aliases(cls) -> Dict[str, List[str]]:
        """{name: aliases} for every registered observatory (reference
        ``observatory/__init__.py:269``)."""
        _ensure_builtin()
        return {name: obs.aliases for name, obs in _registry.items()}

    @property
    def timescale(self) -> str:
        """Timescale of clock-corrected TOAs from this site (reference
        ``observatory/__init__.py:380``); BarycenterObs overrides with
        'tdb'."""
        return "utc"

    @staticmethod
    def gps_correction(t, limits: str = "warn") -> np.ndarray:
        """GPS->UTC clock correction [s] at UTC MJDs ``t`` (reference
        ``observatory/__init__.py:221``)."""
        gps = find_clock_file("gps2utc.clk", fmt="tempo2", limits=limits)
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        return gps.evaluate(t, limits=limits) if gps is not None \
            else np.zeros_like(t)

    @staticmethod
    def bipm_correction(t, bipm_version: str = "BIPM2021",
                        limits: str = "warn") -> np.ndarray:
        """TT(TAI)->TT(BIPM) correction [s] (~27 us; reference
        ``observatory/__init__.py:235``)."""
        f = find_clock_file(f"tai2tt_{bipm_version.lower()}.clk",
                            fmt="tempo2", limits=limits)
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        return f.evaluate(t, limits=limits) - 32.184 if f is not None \
            else np.zeros_like(t)

    def last_clock_correction_mjd(self, limits: str = "warn") -> float:
        """Last MJD every clock file in this site's chain covers
        (reference ``observatory/__init__.py last_clock_correction_mjd``);
        -inf when a needed file is missing."""
        last = np.inf
        files = [cf for cf in self._site_clock_files(limits=limits)
                 if cf is not None]
        wanted = len(getattr(self, "clock_file_names", ()) or ())
        if wanted and len(files) < wanted:
            # ANY missing link breaks the chain: coverage is -inf, not the
            # coverage of whichever files happened to resolve
            return -np.inf
        for cf in files:
            last = min(last, cf.last_correction_mjd())
        if self.include_gps:
            gps = find_clock_file("gps2utc.clk", fmt="tempo2", limits=limits)
            last = min(last, gps.last_correction_mjd()
                       if gps is not None else -np.inf)
        if self.include_bipm:
            b = find_clock_file(f"tai2tt_{self.bipm_version.lower()}.clk",
                                fmt="tempo2", limits=limits)
            last = min(last, b.last_correction_mjd()
                       if b is not None else -np.inf)
        return float(last)

    @classmethod
    def clear_registry(cls):
        """Empty the registry (reference ``Observatory.clear_registry``);
        the builtins reload on the next lookup."""
        _registry.clear()
        _alias_map.clear()

    # -- clock chain -------------------------------------------------------
    def _site_clock_files(self, limits: str = "warn") -> List[ClockFile]:
        return []

    def clock_corrections(self, utc_mjd, include_gps=None, include_bipm=None,
                          bipm_version=None, limits="warn") -> np.ndarray:
        """Total additive clock correction [s] bringing site TOAs to UTC
        (+ optionally TT(BIPM)-TT(TAI))."""
        utc_mjd = np.atleast_1d(np.asarray(utc_mjd, dtype=np.float64))
        include_gps = self.include_gps if include_gps is None else include_gps
        include_bipm = self.include_bipm if include_bipm is None else include_bipm
        bipm_version = bipm_version or self.bipm_version
        corr = np.zeros_like(utc_mjd)
        for cf in self._site_clock_files(limits=limits):
            if cf is not None:
                corr = corr + cf.evaluate(utc_mjd, limits=limits)
        if include_gps:
            gps = find_clock_file("gps2utc.clk", fmt="tempo2", limits=limits)
            if gps is not None:
                corr = corr + gps.evaluate(utc_mjd, limits=limits)
        if include_bipm:
            bipm = find_clock_file(f"tai2tt_{bipm_version.lower()}.clk",
                                   fmt="tempo2", limits=limits)
            if bipm is not None:
                # file gives TT(BIPM)-ideal TAI+32.184s; subtract the constant
                corr = corr + bipm.evaluate(utc_mjd, limits=limits) - 32.184
        return corr

    # -- time scales -------------------------------------------------------
    def get_TDBs(self, utc_mjd, method="default", ephem=None):
        """Corrected-UTC MJD -> TDB MJD (longdouble)."""
        return utc_to_tdb_mjd(utc_mjd, ephem=ephem)

    def get_TDB_offset_seconds(self, utc_mjd, method="default", ephem=None):
        """(TDB - corrected UTC) in seconds, float64 — offset form used by
        the degraded-longdouble pair pipeline (no absolute-MJD rounding)."""
        from pint_torch.timescales import utc_to_tdb_offset_seconds

        return utc_to_tdb_offset_seconds(utc_mjd, ephem=ephem)

    # -- geometry ----------------------------------------------------------
    def earth_location_itrf(self):
        return None

    def get_gcrs(self, utc_mjd, tt_mjd=None):
        raise NotImplementedError

    def posvel(self, utc_mjd, tdb_mjd, ephem="DE440") -> PosVel:
        raise NotImplementedError


class TopoObs(Observatory):
    """Ground-based observatory at fixed ITRF coordinates (reference
    ``topo_obs.py:65``)."""

    def __init__(self, name, itrf_xyz_m, tempo_code="", itoa_code="",
                 aliases=(), clock_files=(), clock_fmt="tempo", **kw):
        al = list(aliases)
        if tempo_code:
            al.append(tempo_code)
        if itoa_code:
            al += [itoa_code.lower()]
        super().__init__(name, al, **kw)
        self.itrf_xyz = np.asarray(itrf_xyz_m, dtype=np.float64)
        self.tempo_code = tempo_code
        self.itoa_code = itoa_code
        self.clock_file_names = list(clock_files)
        self.clock_fmt = clock_fmt

    def earth_location_itrf(self):
        return self.itrf_xyz

    def get_dict(self) -> dict:
        """Site definition as an ``observatories.json``-style dict
        (reference ``topo_obs.py:242``)."""
        out = {"itrf_xyz": [float(v) for v in self.itrf_xyz],
               "aliases": list(self.aliases)}
        if self.tempo_code:
            out["tempo_code"] = self.tempo_code
        if self.itoa_code:
            out["itoa_code"] = self.itoa_code
        if self.clock_file_names:
            out["clock_file"] = list(self.clock_file_names)
            out["clock_fmt"] = self.clock_fmt
        return {self.name: out}

    def get_json(self) -> str:
        """Site definition as JSON (reference ``topo_obs.py:257``)."""
        import json as _json

        return _json.dumps(self.get_dict())

    def separation(self, other, method: str = "cartesian") -> float:
        """Distance [m] to another ground site (reference
        ``topo_obs.py:261``): straight-line ('cartesian') or
        great-circle at the mean radius ('geodesic')."""
        a = np.asarray(self.itrf_xyz, dtype=np.float64)
        b = np.asarray(other.itrf_xyz, dtype=np.float64)
        if method == "cartesian":
            return float(np.linalg.norm(a - b))
        if method == "geodesic":
            ra, rb = np.linalg.norm(a), np.linalg.norm(b)
            cosang = np.clip(np.dot(a, b) / (ra * rb), -1.0, 1.0)
            return float(0.5 * (ra + rb) * np.arccos(cosang))
        raise ValueError("method must be 'cartesian' or 'geodesic'")


    def _site_clock_files(self, limits: str = "warn"):
        return [
            find_clock_file(n, fmt=self.clock_fmt, limits=limits)
            for n in self.clock_file_names
        ]

    def get_gcrs(self, utc_mjd, tt_mjd=None):
        """Site GCRS posvel: ([m], [m/s])."""
        return gcrs_posvel_from_itrf(self.itrf_xyz, utc_mjd, tt_mjd)

    def posvel(self, utc_mjd, tdb_mjd, ephem="DE440") -> PosVel:
        eph = ephem_mod.load_ephemeris(ephem)
        epos, evel = eph.posvel_ssb("earth", tdb_mjd)  # km, km/s
        gpos, gvel = self.get_gcrs(utc_mjd)  # m, m/s
        return PosVel(epos + gpos / 1e3, evel + gvel / 1e3, obj=self.name, origin="ssb")

    # -- topocentric TDB ---------------------------------------------------
    def _topocentric_tdb_seconds(self, utc64, ephem=None) -> np.ndarray:
        """(v_earth . r_site_GCRS)/c^2 — the ~2.1 us diurnal part of TDB-TT
        at the observatory, which the geocentric series omits (the reference
        gets it from ERFA dtdb's (u, v) observer terms,
        ``observatory/__init__.py:443``)."""
        from pint_torch import c as _C_M_S

        c_km_s = _C_M_S / 1e3
        tdb64 = utc64 + 69.184 / 86400.0  # minute-level epoch is plenty
        _, evel = ephem_mod.load_ephemeris(ephem or "DE440").posvel_ssb(
            "earth", tdb64)  # km/s
        gpos_m, _ = self.get_gcrs(utc64)
        return np.sum(evel * (gpos_m / 1e3), axis=-1) / c_km_s**2

    def get_TDBs(self, utc_mjd, method="default", ephem=None):
        utc64 = np.atleast_1d(np.asarray(utc_mjd, dtype=np.float64))
        base = utc_to_tdb_mjd(utc_mjd, ephem=ephem)
        topo = self._topocentric_tdb_seconds(utc64, ephem=ephem)
        return base + np.asarray(topo, dtype=np.longdouble).reshape(
            np.shape(base)) / np.longdouble(86400.0)

    def get_TDB_offset_seconds(self, utc_mjd, method="default", ephem=None):
        from pint_torch.timescales import utc_to_tdb_offset_seconds

        utc64 = np.atleast_1d(np.asarray(utc_mjd, dtype=np.float64))
        out = (utc_to_tdb_offset_seconds(utc_mjd, ephem=ephem)
               + self._topocentric_tdb_seconds(utc64, ephem=ephem))
        return np.asarray(out).reshape(np.shape(utc_mjd))


class SpecialLocation(Observatory):
    """Marker base for non-observatory TOA locations (barycenter,
    geocenter, spacecraft; reference ``special_locations.py:33``).  Site
    clock corrections are zero via the base-class default (no site clock
    files)."""


class GeocenterObs(SpecialLocation):
    """Earth geocenter pseudo-observatory (reference ``special_locations.py:117``)."""

    def __init__(self):
        super().__init__("geocenter", aliases=["0", "o", "coe", "geo"])

    def get_gcrs(self, utc_mjd, tt_mjd=None):
        utc_mjd = np.atleast_1d(np.asarray(utc_mjd, dtype=np.float64))
        z = np.zeros(utc_mjd.shape + (3,))
        return z, z

    def posvel(self, utc_mjd, tdb_mjd, ephem="DE440") -> PosVel:
        eph = ephem_mod.load_ephemeris(ephem)
        epos, evel = eph.posvel_ssb("earth", tdb_mjd)
        return PosVel(epos, evel, obj=self.name, origin="ssb")


class T2SpacecraftObs(SpecialLocation):
    """Spacecraft whose GCRS position rides in per-TOA tim-file flags
    (tempo2 -telx/-tely/-telz [km], -vx/-vy/-vz [km/s]; reference
    ``special_locations.py:161``).  GPS clock corrections are not applied —
    the spacecraft's time source is unknown."""

    needs_flags = True

    def __init__(self, name="stl_geo", aliases=("spacecraft",)):
        super().__init__(name, aliases=list(aliases), include_gps=False)

    def clock_corrections(self, utc_mjd, include_gps=None, **kw):
        # site policy wins over the pipeline's include_gps=True default: the
        # spacecraft's time source is not GPS-steered (reference
        # special_locations.py:170 apply_gps2utc=False)
        return super().clock_corrections(utc_mjd, include_gps=False, **kw)

    @staticmethod
    def _flag_vec(flags, keys, what):
        try:
            return np.array([[float(fl[k]) for k in keys] for fl in flags])
        except KeyError as e:
            raise ValueError(
                f"TOA line must carry {'/'.join(keys)} flags for the GCRS "
                f"{what} of a spacecraft observatory") from e

    def posvel_flags(self, utc_mjd, tdb_mjd, flags, ephem="DE440") -> PosVel:
        eph = ephem_mod.load_ephemeris(ephem)
        epos, evel = eph.posvel_ssb("earth", np.atleast_1d(
            np.asarray(tdb_mjd, dtype=np.float64)))
        pos_km = self._flag_vec(flags, ("telx", "tely", "telz"), "position")
        vel_kms = self._flag_vec(flags, ("vx", "vy", "vz"), "velocity")
        return PosVel(epos + pos_km, evel + vel_kms, obj=self.name,
                      origin="ssb")

    def posvel(self, utc_mjd, tdb_mjd, ephem="DE440") -> PosVel:
        raise ValueError(
            "T2SpacecraftObs needs per-TOA flags; use posvel_flags "
            "(compute_posvels routes here automatically)")


class BarycenterObs(SpecialLocation):
    """SSB pseudo-observatory: TOAs already barycentred (reference
    ``special_locations.py:71``)."""

    def __init__(self):
        super().__init__("barycenter", aliases=["@", "bat", "ssb", "bary"],
                         include_gps=False, include_bipm=False)

    @property
    def timescale(self) -> str:
        return "tdb"  # barycentred TOAs arrive in TDB already

    def clock_corrections(self, utc_mjd, **kw):
        return np.zeros_like(np.atleast_1d(np.asarray(utc_mjd, dtype=np.float64)))

    def get_TDBs(self, utc_mjd, method="default", ephem=None):
        # barycentric TOAs are already TDB
        return np.asarray(utc_mjd, dtype=np.longdouble)

    def get_TDB_offset_seconds(self, utc_mjd, method="default", ephem=None):
        return np.zeros_like(np.atleast_1d(np.asarray(utc_mjd,
                                                      dtype=np.float64)))

    def posvel(self, utc_mjd, tdb_mjd, ephem="DE440") -> PosVel:
        tdb_mjd = np.atleast_1d(np.asarray(tdb_mjd, dtype=np.float64))
        z = np.zeros(tdb_mjd.shape + (3,))
        return PosVel(z, z, obj=self.name, origin="ssb")


def _ensure_builtin():
    import os

    if "gbt" in _registry:
        return
    _ensure_builtin_sites_only()
    if os.environ.get("PINT_OBS_OVERRIDE"):
        try:
            load_observatories(os.environ["PINT_OBS_OVERRIDE"],
                               overwrite=True)
        except Exception as e:
            log.warning(f"Failed to load $PINT_OBS_OVERRIDE "
                        f"({os.environ['PINT_OBS_OVERRIDE']}): {e}")


def get_observatory(name: str, include_gps=None, include_bipm=None,
                    bipm_version=None) -> Observatory:
    """Reference-parity accessor (``observatory/__init__.py:519``).

    Clock-chain options are only applied when passed explicitly, so a default
    lookup never clobbers an earlier caller's configuration of the shared
    registry entry.
    """
    _ensure_builtin()
    obs = Observatory.get(name)
    if include_gps is not None:
        obs.include_gps = include_gps
    if include_bipm is not None:
        obs.include_bipm = include_bipm
    if bipm_version is not None:
        obs.bipm_version = bipm_version
    return obs


def list_observatories() -> List[str]:
    _ensure_builtin()
    return sorted(_registry)


def load_observatories(filename, overwrite: bool = False) -> List[str]:
    """Register :class:`TopoObs` sites from a JSON definition file using the
    reference's ``observatories.json`` schema (reference ``topo_obs.py:457``):
    per-site ``itrf_xyz`` (meters) plus optional ``tempo_code`` /
    ``itoa_code`` / ``aliases`` / ``clock_file``(s) / ``clock_fmt`` /
    ``apply_gps2utc`` / ``bipm_version`` / ``fullname`` / ``origin``.

    With ``overwrite=False`` redefining an existing site raises ValueError
    (unless the entry itself carries ``"overwrite": true``).  Returns the
    registered names.
    """
    import json

    from pint_torch.utils import open_or_use

    with open_or_use(filename, "r") as f:
        defs = json.load(f)
    _ensure_builtin_sites_only()
    # validate EVERY entry before touching the registry, so a malformed
    # file can never leave sites deleted or a partial load behind
    for name, d in defs.items():
        key = name.lower()
        allow = overwrite or bool(d.get("overwrite", False))
        if key in _registry and not allow:
            raise ValueError(
                f"Observatory {name!r} already present; pass overwrite=True "
                "to replace it")
        if "itrf_xyz" not in d:
            raise ValueError(f"Observatory {name!r} has no itrf_xyz")
        if len(np.atleast_1d(np.asarray(d["itrf_xyz"],
                                        dtype=np.float64))) != 3:
            raise ValueError(f"Observatory {name!r} itrf_xyz must be "
                             "3 numbers (meters)")
    # snapshot so a constructor failure mid-loop (alias clash, bad
    # clock_fmt, ...) rolls the registry back instead of leaving earlier
    # sites replaced and later ones untouched
    reg_snapshot = dict(_registry)
    alias_snapshot = dict(_alias_map)
    added = []
    try:
        for name, d in defs.items():
            key = name.lower()
            if key in _registry:
                _registry.pop(key)
                for a, tgt in list(_alias_map.items()):
                    if tgt == key:
                        _alias_map.pop(a)
            clk = d.get("clock_file", d.get("clock_files", ()))
            if isinstance(clk, str):
                clk = [clk]
            kw = {}
            if "apply_gps2utc" in d:
                kw["include_gps"] = bool(d["apply_gps2utc"])
            if "bipm_version" in d:
                kw["bipm_version"] = d["bipm_version"]
            obs = TopoObs(name, d["itrf_xyz"],
                          tempo_code=d.get("tempo_code", ""),
                          itoa_code=d.get("itoa_code", ""),
                          aliases=d.get("aliases", ()),
                          clock_files=list(clk),
                          clock_fmt=d.get("clock_fmt", "tempo"), **kw)
            obs.fullname = d.get("fullname", name)
            origin = d.get("origin", "")
            obs.origin = "\n".join(origin) if isinstance(origin, list) else origin
            added.append(obs.name)
    except Exception:
        _registry.clear()
        _registry.update(reg_snapshot)
        _alias_map.clear()
        _alias_map.update(alias_snapshot)
        raise
    return added


def _ensure_builtin_sites_only():
    """_ensure_builtin minus the $PINT_OBS_OVERRIDE hook (which would
    recurse through load_observatories)."""
    if "gbt" in _registry:
        return
    GeocenterObs()
    BarycenterObs()
    T2SpacecraftObs()
    for name, (x, y, z, tc, ic, aliases, clk, fmt) in SITES.items():
        TopoObs(name, (x, y, z), tempo_code=tc, itoa_code=ic, aliases=aliases,
                clock_files=clk, clock_fmt=fmt)


def load_observatories_from_usual_locations(clear: bool = False) -> List[str]:
    """Builtins + ``$PINT_OBS_OVERRIDE`` (reference ``topo_obs.py:491``);
    ``clear=True`` resets the registry first."""
    import os

    if clear:
        Observatory.clear_registry()
    _ensure_builtin_sites_only()
    if os.environ.get("PINT_OBS_OVERRIDE"):
        return load_observatories(os.environ["PINT_OBS_OVERRIDE"],
                                  overwrite=True)
    return []


def update_clock_files(bipm_versions: Optional[List[str]] = None) -> List[str]:
    """Refresh every clock file the registered observatories use from the
    global repository cache (reference ``observatory/__init__.py:802``).

    Covers each site's own clock files plus ``gps2utc.clk`` and the
    ``tai2tt_<version>.clk`` files for in-use (and any extra requested) BIPM
    versions.  Files the repository cannot provide are skipped with a
    warning.  Returns the refreshed names.
    """
    from pint_torch.observatory import clock_file as _cf
    from pint_torch.observatory import global_clock_corrections as _gcc

    _ensure_builtin()
    names: Dict[str, None] = {}
    versions = set(v.lower() for v in (bipm_versions or []))
    for obs in _registry.values():
        for n in getattr(obs, "clock_file_names", []):
            names[n] = None
        if obs.include_gps:
            names["gps2utc.clk"] = None
        if obs.include_bipm:
            versions.add(obs.bipm_version.lower())
    for v in versions:
        names[f"tai2tt_{v}.clk"] = None
    done = []
    index = _gcc.Index() if _gcc._repo_dir(None) is not None else None
    for n in names:
        try:
            if index is not None:
                details = index.files[n]
                path = _gcc.get_file(
                    details.file,
                    update_interval_days=details.update_interval_days,
                    download_policy="if_expired",
                    invalid_if_older_than=details.invalid_if_older_than)
            else:
                path = _gcc.get_clock_correction_file(
                    n, download_policy="if_expired")
        except KeyError:
            log.warning(f"update_clock_files: {n} not in the repository index")
            continue
        except FileNotFoundError:
            log.warning(f"update_clock_files: {n} listed in the index but "
                        "not available from the repository; skipped")
            continue
        if path is not None:
            done.append(n)
    # refreshed copies must win over memoized parses of the old ones
    _cf._cache.clear()
    return done


def export_all_clock_files(directory) -> List[str]:
    """Write every clock file loaded in this session to *directory*
    (reference ``topo_obs.py:425``): point $PINT_CLOCK_OVERRIDE at the
    result to pin exactly these versions.  Returns the written paths."""
    import os

    from pint_torch.observatory import clock_file as _cf

    os.makedirs(directory, exist_ok=True)
    out = []
    for (name, fmt, _vbe), cf in _cf._cache.items():
        if cf is None:
            continue
        dest = os.path.join(directory, os.path.basename(name))
        if dest in out:
            log.warning(
                f"export_all_clock_files: {os.path.basename(name)} is "
                f"loaded more than once (different format options); only "
                "the first parse was exported")
            continue
        if fmt == "tempo2":
            cf.write_tempo2_clock_file(dest)
        else:
            cf.write_tempo_clock_file(dest)
        out.append(dest)
    return out


# ---------------------------------------------------------------------------
# maintenance/reporting helpers (reference observatory/__init__.py:74,549,
# 556,647,771)
# ---------------------------------------------------------------------------

def earth_location_distance(loc1, loc2) -> float:
    """Distance [m] between two geocentric locations given as (x, y, z)
    triples in meters (reference ``observatory/__init__.py:549``, minus the
    astropy Quantity wrapper)."""
    a = np.asarray(loc1, dtype=np.float64)
    b = np.asarray(loc2, dtype=np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2)))


def find_latest_bipm(bipm_default: str = "BIPM2021") -> int:
    """Most recent TT(BIPMYYYY) realization available LOCALLY.

    The reference polls the BIPM FTP server for successive years
    (``observatory/__init__.py:74``); this zero-egress build scans the local
    clock search paths for ``tai2tt_bipmYYYY.clk`` files instead and returns
    the latest year found (falling back to the default version's year).
    """
    import re

    from pint_torch.observatory.clock_file import _clock_search_paths

    years = []
    for d in _clock_search_paths():
        try:
            for fn in os.listdir(d):
                m = re.fullmatch(r"tai2tt_bipm(\d{4})\.clk", fn.lower())
                if m:
                    years.append(int(m.group(1)))
        except OSError:
            continue
    if not years:
        log.warning("No local tai2tt_bipmYYYY.clk files found; reporting the "
                    f"default {bipm_default}")
        return int(bipm_default[4:])
    return max(years)


def list_last_correction_mjds(file=None) -> None:
    """Print, per observatory, each clock file and its last valid MJD
    (reference ``observatory/__init__.py:771``).  Sites whose clock files
    cannot be found locally print MISSING."""
    import sys

    out = file or sys.stdout
    _ensure_builtin()
    for name in sorted(_registry):
        site = _registry[name]
        files = [cf for cf in site._site_clock_files(limits="warn")
                 if cf is not None]
        if not getattr(site, "clock_file_names", None) and not files:
            continue
        last = min((cf.last_correction_mjd() for cf in files),
                   default=-np.inf)
        if np.isfinite(last):
            print(f"{name:<20} {last:.1f}", file=out)
        else:
            print(f"{name:<20} MISSING", file=out)
        for cf in files:
            lm = cf.last_correction_mjd()
            tag = f"{lm:.1f}" if np.isfinite(lm) else "MISSING"
            print(f"  {getattr(cf, 'filename', '?'):<20} {tag}", file=out)


def _geodetic_to_itrf_m(lat_deg: float, lon_deg: float, height_m: float):
    """WGS84 geodetic -> geocentric ITRF XYZ [m] (closed form)."""
    a = 6378137.0
    f = 1.0 / 298.257223563
    e2 = f * (2.0 - f)
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    N = a / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    x = (N + height_m) * np.cos(lat) * np.cos(lon)
    y = (N + height_m) * np.cos(lat) * np.sin(lon)
    z = (N * (1.0 - e2) + height_m) * np.sin(lat)
    return float(x), float(y), float(z)


def _topo_obs_entry(name: str, x: float, y: float, z: float,
                    aliases=()) -> str:
    import json as _json

    entry = {"itrf_xyz": [x, y, z]}
    if aliases:
        entry["aliases"] = list(aliases)
    return _json.dumps({name: entry}, indent=4)[1:-1].strip()


def compare_t2_observatories_dat(t2dir: "str | None" = None) -> dict:
    """Compare a tempo2 ``observatory/observatories.dat`` against the
    registry (reference ``observatory/__init__.py:556``).  Returns
    ``{"different": [...], "missing": [...]}`` where each entry carries a
    ready-to-paste observatories.json snippet."""
    t2dir = t2dir or os.getenv("TEMPO2")
    if t2dir is None:
        raise ValueError("TEMPO2 directory not provided and TEMPO2 "
                         "environment variable not set")
    path = os.path.join(t2dir, "observatory", "observatories.dat")
    report: dict = {"different": [], "missing": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                x, y, z, full_name, short_name = line.split()
                x, y, z = float(x), float(y), float(z)
            except ValueError as e:
                raise ValueError(f"unrecognized line {line!r}") from e
            full_name, short_name = full_name.lower(), short_name.lower()
            entry = _topo_obs_entry(full_name, x, y, z, [short_name])
            try:
                obs = get_observatory(full_name)
            except KeyError:
                try:
                    obs = get_observatory(short_name)
                except KeyError:
                    report["missing"].append(
                        dict(name=full_name, topo_obs_entry=entry))
                    continue
            oloc = obs.earth_location_itrf()
            d = earth_location_distance((x, y, z), oloc)
            if d > 1.0:
                report["different"].append(dict(
                    name=full_name, t2_short_name=short_name,
                    t2=(x, y, z), pint=tuple(oloc), position_difference=d,
                    pint_name=obs.name, pint_aliases=obs.aliases,
                    topo_obs_entry=entry))
    return report


def compare_tempo_obsys_dat(tempodir: "str | None" = None) -> dict:
    """Compare a tempo ``obsys.dat`` against the registry (reference
    ``observatory/__init__.py:647``); geodetic entries (icoord=0, ddmmss.s
    lat / +west-longitude convention) are converted to ITRF."""
    tempodir = tempodir or os.getenv("TEMPO")
    if tempodir is None:
        raise ValueError("TEMPO directory not provided and TEMPO "
                         "environment variable not set")
    path = os.path.join(tempodir, "obsys.dat")

    def dms(v: float) -> float:
        s = np.sign(v)
        v = abs(v)
        return float(s * (v // 10000 + (v % 10000) // 100 / 60.0
                          + (v % 100) / 3600.0))

    report: dict = {"different": [], "missing": []}
    with open(path) as f:
        for line in f:
            if not line.strip() or line.strip().startswith("#"):
                continue
            try:
                x = float(line[0:15])
                y = float(line[15:30])
                z = float(line[30:45])
                icoord = line[47:48].strip()
                icoord = int(icoord) if icoord else 0
                obsnam = line[51:71].strip().lower()
                tempo_code = line[71:72].strip("-")
                itoa_code = line[74:76].strip()
            except (ValueError, IndexError) as e:
                raise ValueError(f"unrecognized line {line!r}") from e
            if not icoord:
                # geodetic: x = lat ddmmss.s, y = WEST longitude ddmmss.s
                x, y, z = _geodetic_to_itrf_m(dms(x), -dms(y), z)
            name = obsnam.replace(" ", "_")
            entry = _topo_obs_entry(
                name, x, y, z,
                [a for a in (itoa_code.lower(),) if a])
            obs = None
            for key in (name, itoa_code.lower(), tempo_code.lower()):
                if not key:
                    continue
                try:
                    obs = get_observatory(key)
                    break
                except KeyError:
                    continue
            if obs is None:
                report["missing"].append(
                    dict(name=name, itoa_code=itoa_code,
                         tempo_code=tempo_code, topo_obs_entry=entry))
                continue
            d = earth_location_distance((x, y, z), obs.earth_location_itrf())
            if d > 1.0:
                report["different"].append(dict(
                    name=name, itoa_code=itoa_code, tempo_code=tempo_code,
                    tempo=(x, y, z), pint=tuple(obs.earth_location_itrf()),
                    position_difference=d, pint_name=obs.name,
                    topo_obs_entry=entry))
    return report


def load_special_locations() -> None:
    """Ensure the barycenter/geocenter/spacecraft pseudo-observatories are
    registered (reference ``special_locations.py:270``; the builtin loader
    calls this implicitly)."""
    for name, cls in (("barycenter", BarycenterObs),
                      ("geocenter", GeocenterObs),
                      ("stl_geo", T2SpacecraftObs)):
        if name not in _registry:
            cls()
