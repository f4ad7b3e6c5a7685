"""Cached boolean-mask TOA selection for mask parameters (port of
``pint_tpu/toa_select.py``): JUMP/EFAC/DMX-style
conditions are resolved to index arrays once and cached against a hash of
the condition + column data, so repeated design-matrix builds don't re-scan
the TOA table (the reference profile shows ``select_toa_mask`` at 8.6 s of
the 176 s benchmark, SURVEY §3.2).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["TOASelect"]


class TOASelect:
    def __init__(self, is_range: bool, use_hash: bool = True):
        self.is_range = is_range
        self.use_hash = use_hash
        self.select_result: Dict[str, np.ndarray] = {}
        self.hash_dict: Dict[str, str] = {}

    def check_condition(self, new_cond: dict):
        """Split a new condition dict into (changed, unchanged) vs the last
        call, updating the stored condition (reference
        ``toa_select.py:38``)."""
        if not hasattr(self, "condition"):
            self.condition = dict(new_cond)
            return dict(new_cond), {}
        # values may be lists (flag selections) — compare by equality, not
        # set membership, so unhashable values work
        chg, unchg = {}, {}
        for k, v in new_cond.items():
            if k in self.condition and self.condition[k] == v:
                unchg[k] = v
            else:
                chg[k] = v
        self.condition = dict(new_cond)
        return chg, unchg

    def check_table_column(self, new_column) -> bool:
        """True when the named data column is unchanged since last seen
        (hash comparison; reference ``toa_select.py:67``).  ``new_column``
        must expose ``.name`` and be array-like."""
        if not self.use_hash:
            # without hashing there is nothing to compare against; skip
            # the (large-column) hash work entirely
            return False
        import hashlib as _hashlib

        name = getattr(new_column, "name", "col")
        h = _hashlib.sha1(
            np.ascontiguousarray(np.asarray(new_column))).hexdigest()
        same = self.hash_dict.get(name) == h
        self.hash_dict[name] = h
        return same

    # -- hashing -------------------------------------------------------------
    def get_has_key(self, key, key_value) -> str:
        return f"{key}{key_value}"

    def _data_hash(self, condition, col) -> str:
        h = hashlib.sha1()
        h.update(repr(sorted(condition.items())).encode())
        h.update(np.ascontiguousarray(np.asarray(col, dtype=object)
                                      .astype(str)).tobytes()
                 if np.asarray(col).dtype == object
                 else np.ascontiguousarray(col).tobytes())
        return h.hexdigest()

    # -- selection -----------------------------------------------------------
    def get_select_range(self, condition: Dict[str, Tuple[float, float]],
                         col) -> Dict[str, np.ndarray]:
        col = np.asarray(col, dtype=np.float64)
        out = {}
        for name, (r1, r2) in condition.items():
            out[name] = np.nonzero((col >= float(r1)) & (col <= float(r2)))[0]
        return out

    def get_select_non_range(self, condition: Dict[str, object],
                             col) -> Dict[str, np.ndarray]:
        col = np.asarray(col)
        out = {}
        for name, key_value in condition.items():
            if isinstance(key_value, (list, tuple, set)):
                mask = np.isin(col, list(key_value))
            else:
                mask = col == type(col.flat[0])(key_value) \
                    if len(col) else col == key_value
            out[name] = np.nonzero(mask)[0]
        return out

    def get_select_index(self, condition, col) -> Dict[str, np.ndarray]:
        """Dispatch + cache (reference ``toa_select.py get_select_index``)."""
        if self.use_hash:
            key = self._data_hash(condition, col)
            cached = self.hash_dict.get("key")
            if cached == key and self.select_result:
                return self.select_result
            self.hash_dict["key"] = key
        result = (self.get_select_range(condition, col) if self.is_range
                  else self.get_select_non_range(condition, col))
        self.select_result = result
        return result
