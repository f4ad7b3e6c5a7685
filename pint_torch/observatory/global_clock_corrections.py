"""Global clock-correction repository access.

Counterpart of reference ``global_clock_corrections.py:40,150,188,229``
(``get_file`` / ``Index`` / ``get_clock_correction_file`` / ``update_all``).

The reference downloads versioned clock files from the IPTA github
repository into the astropy cache, refreshing them per the repository's
``index.txt`` (per-file update interval + invalid-if-older-than stamps).
This deployment is zero-egress, so the transport is swapped while the full
policy machinery is kept: a *repository* is any local directory (or
``file://`` URL) laid out like the IPTA repo — ``index.txt`` plus the files
it lists — typically a mirror of
https://ipta.github.io/pulsar-clock-corrections/.  Files are copied from
the repository into a cache directory with the same ``download_policy``
semantics the reference implements ("always" / "never" / "if_expired" /
"if_missing" + invalid_if_older_than); mtimes track when the cache copy
was refreshed.

Configuration:

* ``$PINT_CLOCK_REPO`` — the repository directory (index.txt + files).
* ``$PINT_CLOCK_CACHE`` — cache directory (default
  ``~/.pint_torch/clock_cache``).
* ``$PINT_CLOCK_DIR``, ``$TEMPO2/clock``, ``$TEMPO/clock`` — plain local
  search directories honored as a repository-less fallback (the same
  override order :mod:`pint_torch.observatory.clock_file` uses).
"""

from __future__ import annotations

import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from pint_torch.logging import log

__all__ = ["Index", "IndexEntry", "get_file", "get_clock_correction_file",
           "update_all", "clock_search_dirs", "index_name",
           "index_update_interval_days"]

index_name = "index.txt"
#: the index itself is refreshed when older than this (reference
#: ``global_clock_corrections.py:37``)
index_update_interval_days = 1.0

_POLICIES = ("always", "never", "if_expired", "if_missing")


def clock_search_dirs() -> List[str]:
    """Repository-less local directories searched for clock files."""
    dirs = []
    if os.environ.get("PINT_CLOCK_DIR"):
        dirs.append(os.environ["PINT_CLOCK_DIR"])
    if os.environ.get("TEMPO2"):
        dirs.append(os.path.join(os.environ["TEMPO2"], "clock"))
    if os.environ.get("TEMPO"):
        dirs.append(os.path.join(os.environ["TEMPO"], "clock"))
    return [d for d in dirs if os.path.isdir(d)]


def _repo_dir(url_base: Optional[str]) -> Optional[Path]:
    base = url_base or os.environ.get("PINT_CLOCK_REPO")
    if base is None:
        return None
    if base.startswith("file://"):
        base = base[len("file://"):]
    if base.startswith(("http://", "https://")):
        log.warning(f"Clock repository {base} needs network access, which "
                    "this deployment does not have; set $PINT_CLOCK_REPO to "
                    "a local mirror instead")
        return None
    return Path(base)


def _cache_dir() -> Path:
    d = Path(os.environ.get("PINT_CLOCK_CACHE",
                            Path.home() / ".pint_torch" / "clock_cache"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_file(name: str, update_interval_days: float = 7.0,
             download_policy: str = "if_expired",
             url_base: Optional[str] = None,
             invalid_if_older_than: Optional[float] = None) -> Path:
    """Return a cached local path for repository file *name*, refreshing the
    cache copy per *download_policy* (reference
    ``global_clock_corrections.py:40 get_file``).

    ``invalid_if_older_than`` is a unix timestamp (the reference uses an
    astropy Time); a cache copy older than it is refreshed regardless of
    the update interval.  Raises FileNotFoundError when the policy forbids
    (or the repository cannot provide) a copy.
    """
    if download_policy not in _POLICIES:
        raise ValueError(f"Unknown download policy {download_policy!r}")
    cache = _cache_dir() / Path(name).name
    local = cache if cache.exists() else None

    if download_policy == "never":
        if local is None:
            raise FileNotFoundError(name)
        return local
    if download_policy == "if_missing" and local is not None:
        return local

    if local is not None and invalid_if_older_than is not None \
            and local.stat().st_mtime < invalid_if_older_than:
        log.info(f"Clock file {name} cache copy is older than its "
                 "invalid-if-older-than stamp; refreshing")
        local = None

    if download_policy == "if_expired" and local is not None:
        age = time.time() - local.stat().st_mtime
        if age < update_interval_days * 86400.0:
            return local

    # refresh from the repository ("download" = copy from local mirror)
    repo = _repo_dir(url_base)
    src = None
    if repo is not None:
        for cand in (repo / name, repo / Path(name).name):
            if cand.exists():
                src = cand
                break
    if src is None:
        for d in clock_search_dirs():
            cand = Path(d) / Path(name).name
            if cand.exists():
                src = cand
                break
    if src is None:
        if local is not None:
            if download_policy == "always":
                # 'always' promises a guaranteed refresh (the reference
                # raises here); silently serving a stale copy breaks it
                raise FileNotFoundError(
                    f"Clock file {name}: download_policy='always' but no "
                    "repository copy is available to refresh from (stale "
                    f"cache copy exists at {local})")
            log.warning(f"Clock file {name} is due for refresh but no "
                        "repository copy is available; using the stale "
                        f"cache copy {local}")
            return local
        raise FileNotFoundError(
            f"Clock file {name} not available: no cache copy and no "
            "repository (set $PINT_CLOCK_REPO to a local mirror of "
            "https://ipta.github.io/pulsar-clock-corrections/)")
    shutil.copy2(src, cache)
    os.utime(cache)  # mtime records when the cache copy was refreshed
    return cache


class IndexEntry(NamedTuple):
    file: str
    update_interval_days: float
    invalid_if_older_than: Optional[float]  # unix timestamp
    extra: str = ""


class Index:
    """Parsed repository ``index.txt`` (reference
    ``global_clock_corrections.py:150``): maps basenames to
    :class:`IndexEntry` rows (repo-relative path, update interval [days],
    invalid-if-older-than ISO date or ``---``, free-form description)."""

    def __init__(self, download_policy: str = "if_expired",
                 url_base: Optional[str] = None):
        index_file = get_file(index_name, index_update_interval_days,
                              download_policy=download_policy,
                              url_base=url_base)
        self.files: Dict[str, IndexEntry] = {}
        with open(index_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                e = line.split(maxsplit=3)
                if len(e) < 2:
                    continue
                stamp = None
                if len(e) > 2 and e[2] != "---":
                    import calendar

                    stamp = calendar.timegm(time.strptime(
                        e[2].split()[0], "%Y-%m-%d"))
                entry = IndexEntry(
                    file=e[0],
                    update_interval_days=float(e[1]),
                    invalid_if_older_than=stamp,
                    extra=e[3] if len(e) > 3 else "")
                self.files[Path(e[0]).name] = entry


def get_clock_correction_file(filename: str,
                              download_policy: str = "if_expired",
                              url_base: Optional[str] = None) -> Optional[str]:
    """Resolve a named clock file through the repository index when one is
    configured, falling back to the plain local search directories
    (reference ``global_clock_corrections.py:188``).

    With a repository: unknown names raise KeyError; known names honor the
    index's per-file expiry.  Without one: returns the first local-search
    hit, else None with a warning (the historical zero-egress behavior).
    """
    if _repo_dir(url_base) is not None:
        index = Index(download_policy=download_policy, url_base=url_base)
        details = index.files[filename]
        return str(get_file(details.file,
                            update_interval_days=details.update_interval_days,
                            download_policy=download_policy,
                            url_base=url_base,
                            invalid_if_older_than=details.invalid_if_older_than))
    for d in clock_search_dirs():
        cand = os.path.join(d, filename)
        if os.path.exists(cand):
            return cand
    if download_policy != "never":
        log.warning(
            f"Clock file {filename} not found locally and this deployment "
            "cannot download (zero egress); set $PINT_CLOCK_REPO or "
            "$PINT_CLOCK_DIR to a mirror of "
            "https://ipta.github.io/pulsar-clock-corrections/")
    return None


def update_all(export_to: Optional[str] = None,
               download_policy: str = "if_expired",
               url_base: Optional[str] = None) -> List[str]:
    """Refresh every file in the repository index, optionally exporting the
    copies to a directory (reference ``global_clock_corrections.py:229``).
    Returns the refreshed file names."""
    if _repo_dir(url_base) is None:
        log.warning("update_all: no clock repository configured; set "
                    "$PINT_CLOCK_REPO to a local mirror")
        return []
    index = Index(download_policy=download_policy, url_base=url_base)
    done = []
    for filename, details in index.files.items():
        try:
            f = get_file(details.file,
                         update_interval_days=details.update_interval_days,
                         download_policy=download_policy, url_base=url_base,
                         invalid_if_older_than=details.invalid_if_older_than)
        except FileNotFoundError:
            log.warning(f"update_all: {filename} listed in index but not "
                        "present in the repository")
            continue
        if export_to is not None:
            Path(export_to).mkdir(parents=True, exist_ok=True)
            shutil.copy2(f, Path(export_to) / Path(filename).name)
        done.append(filename)
    return done
