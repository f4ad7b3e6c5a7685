"""Labelled matrices: design, covariance and correlation matrices whose axes
carry {name: (start, end, unit)} maps (a copy of ``pint_tpu/pint_matrix.py``:
``PintMatrix``, ``DesignMatrix``, ``CovarianceMatrix``,
``CorrelationMatrix``, the makers and the ``combine_*`` functions).

The numbers come from the port's design matrices and covariances
(``TimingModel.designmatrix``, ``dm_designmatrix``,
``toa_covariance_matrix``), tensors on the batch's device; the labelled
form is bookkeeping for people and the combinators, so it holds host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "PintMatrix",
    "DesignMatrix",
    "CovarianceMatrix",
    "CorrelationMatrix",
    "DesignMatrixMaker",
    "PhaseDesignMatrixMaker",
    "TOADesignMatrixMaker",
    "NoiseDesignMatrixMaker",
    "CovarianceMatrixMaker",
    "combine_design_matrices_by_quantity",
    "combine_design_matrices_by_param",
    "combine_covariance_matrix",
]

#: axis labels: per axis, a dict {label_name: (start, end, unit)}
AxisLabels = List[Dict[str, Tuple[int, int, str]]]


class PintMatrix:
    """A numpy matrix with named index ranges on every axis
    (reference ``pint_matrix.py:38``)."""

    def __init__(self, matrix: np.ndarray, axis_labels: AxisLabels):
        self.matrix = np.asarray(matrix)
        self.axis_labels = [dict(a) for a in axis_labels]
        if len(self.axis_labels) != self.matrix.ndim:
            raise ValueError(
                f"matrix has {self.matrix.ndim} axes but "
                f"{len(self.axis_labels)} label sets were given")
        for ax, labels in enumerate(self.axis_labels):
            cover = sorted((s, e) for s, e, _ in labels.values())
            for (s1, e1), (s2, e2) in zip(cover, cover[1:]):
                if s2 < e1:
                    raise ValueError(f"Axis {ax} labels overlap: {labels}")

    # -- basic introspection -------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.matrix.ndim

    @property
    def shape(self) -> tuple:
        return self.matrix.shape

    @property
    def labels(self) -> List[List[str]]:
        return [list(a.keys()) for a in self.axis_labels]

    def diag(self, k: int = 0) -> np.ndarray:
        return np.diag(self.matrix, k)

    def get_label_names(self, axis: Optional[int] = None):
        if axis is not None:
            return list(self.axis_labels[axis].keys())
        return [list(a.keys()) for a in self.axis_labels]

    def get_unique_label_names(self) -> List[str]:
        seen: List[str] = []
        for a in self.axis_labels:
            for n in a:
                if n not in seen:
                    seen.append(n)
        return seen

    def get_label(self, label: str, axis: Optional[int] = None):
        """(axis, start, end, unit) entries for a label name."""
        hits = []
        axes = range(self.ndim) if axis is None else [axis]
        for ax in axes:
            if label in self.axis_labels[ax]:
                s, e, u = self.axis_labels[ax][label]
                hits.append((label, ax, s, e, u))
        if not hits:
            raise KeyError(f"Label {label!r} not found")
        return hits

    def get_label_size(self, label: str, axis: int = 0) -> int:
        _, _, s, e, _ = self.get_label(label, axis)[0]
        return e - s

    def get_label_matrix(self, labels: List[str]) -> "PintMatrix":
        """Submatrix covering the named labels on every axis
        (reference ``pint_matrix.py:100``)."""
        slices = []
        new_labels: AxisLabels = []
        for ax in range(self.ndim):
            entries = [(n,) + tuple(self.axis_labels[ax][n])
                       for n in labels if n in self.axis_labels[ax]]
            if not entries:
                slices.append(slice(None))
                new_labels.append(dict(self.axis_labels[ax]))
                continue
            entries.sort(key=lambda t: t[1])
            idx = np.concatenate([np.arange(s, e) for _, s, e, _ in entries])
            slices.append(idx)
            off, lab = 0, {}
            for n, s, e, u in entries:
                lab[n] = (off, off + (e - s), u)
                off += e - s
            new_labels.append(lab)
        sub = self.matrix
        for ax, sl in enumerate(slices):
            sub = np.take(sub, sl, axis=ax) if isinstance(sl, np.ndarray) else sub
        return type(self)(sub, new_labels)

    def append_along_axis(self, other: "PintMatrix", axis: int) -> "PintMatrix":
        off = self.shape[axis]
        labels = [dict(a) for a in self.axis_labels]
        for n, (s, e, u) in other.axis_labels[axis].items():
            labels[axis][n] = (s + off, e + off, u)
        return type(self)(np.concatenate([self.matrix, other.matrix], axis=axis),
                          labels)

    def __repr__(self):
        return f"{type(self).__name__}(shape={self.shape}, labels={self.labels})"


class DesignMatrix(PintMatrix):
    """Design matrix: axis 0 = data quantity, axis 1 = parameters
    (reference ``pint_matrix.py:137``)."""

    matrix_type = "design"

    @property
    def derivative_params(self) -> List[str]:
        # preserve column order
        items = sorted(self.axis_labels[1].items(), key=lambda kv: kv[1][0])
        return [k for k, _ in items]

    @property
    def param_units(self) -> List[str]:
        items = sorted(self.axis_labels[1].items(), key=lambda kv: kv[1][0])
        return [u for _, (_, _, u) in items]

    @property
    def derivative_quantity(self) -> List[str]:
        return list(self.axis_labels[0].keys())


class CovarianceMatrix(PintMatrix):
    """Symmetric labeled covariance (reference ``pint_matrix.py:159``)."""

    matrix_type = "covariance"

    def to_correlation_matrix(self) -> "CorrelationMatrix":
        d = np.sqrt(np.diag(self.matrix))
        return CorrelationMatrix((self.matrix / d).T / d, self.axis_labels)

    def prettyprint(self, prec: int = 3, offset: bool = False) -> str:
        names = [n for n, _ in sorted(self.axis_labels[0].items(),
                                      key=lambda kv: kv[1][0])]
        if not offset and "Offset" in names:
            keep = [n for n in names if n != "Offset"]
            return self.get_label_matrix(keep).prettyprint(prec=prec, offset=True)
        w = max(len(n) for n in names) + 1
        lines = [" " * w + " ".join(f"{n:>{prec + 7}}" for n in names)]
        for i, n in enumerate(names):
            row = " ".join(f"{self.matrix[i, j]:>{prec + 7}.{prec}e}"
                           for j in range(i + 1))
            lines.append(f"{n:<{w}}{row}")
        return "\n".join(lines)


class CorrelationMatrix(CovarianceMatrix):
    matrix_type = "correlation"


# ---------------------------------------------------------------------------
# Makers: build labelled matrices from (batch, model)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class DesignMatrixMaker:
    """Build the labelled design matrix of a data quantity (reference
    ``pint_matrix.py:189``): 'toa'/'phase' (timing derivatives), 'dm'
    (wideband DM derivatives) or 'toa_noise' (the noise basis)."""

    def __init__(self, derivative_quantity: str = "toa",
                 quantity_unit: str = "s"):
        self.derivative_quantity = derivative_quantity
        self.quantity_unit = quantity_unit

    def __call__(self, data, model, derivative_params=None,
                 offset: bool = True) -> Optional[DesignMatrix]:
        q = self.derivative_quantity
        if q in ("toa", "phase"):
            M, names = model.designmatrix(data, incoffset=offset)
            units = [("s/s" if n == "Offset" else f"s/({model[n].units})")
                     for n in names]
        elif q == "dm":
            M, names = model.dm_designmatrix(data)
            if not offset and names and names[0] == "Offset":
                M, names = M[:, 1:], names[1:]
            units = [("pc/cm3" if n == "Offset"
                      else f"pc/cm3/({model[n].units})") for n in names]
        else:
            M = names = units = None
        if M is not None:
            M = _host(M)
        if M is not None and derivative_params is not None:
            # restrict to the requested columns
            want = (["Offset"] if offset and "Offset" in names else []) \
                + [p for p in derivative_params if p != "Offset"]
            missing = [p for p in want if p not in names]
            if missing:
                raise KeyError(f"Parameters {missing} have no design column "
                               f"(frozen or unknown)")
            idx = [names.index(p) for p in want]
            M, names = M[:, idx], want
            units = [units[i] for i in idx]
        if M is not None:
            col = {n: (i, i + 1, u)
                   for i, (n, u) in enumerate(zip(names, units))}
            return DesignMatrix(M,
                                [{q: (0, M.shape[0], self.quantity_unit)}, col])
        if q == "toa_noise":
            Mn = model.noise_model_designmatrix(data)
            if Mn is None:
                return None
            dims = model.noise_model_dimensions(data)
            labels = {comp: (off, off + size, "s")
                      for comp, (off, size) in dims.items()}
            return DesignMatrix(Mn, [{q: (0, Mn.shape[0], self.quantity_unit)},
                                     labels])
        raise ValueError(f"Unknown derivative quantity {q!r}")


class PhaseDesignMatrixMaker(DesignMatrixMaker):
    """Phase-quantity maker."""

    def __init__(self, derivative_quantity: str = "phase",
                 quantity_unit: str = ""):
        super().__init__(derivative_quantity, quantity_unit)


class TOADesignMatrixMaker(DesignMatrixMaker):
    """TOA-quantity maker."""

    def __init__(self, derivative_quantity: str = "toa",
                 quantity_unit: str = "s"):
        super().__init__(derivative_quantity, quantity_unit)


class NoiseDesignMatrixMaker(DesignMatrixMaker):
    """Noise-basis maker."""

    def __init__(self, derivative_quantity: str = "toa_noise",
                 quantity_unit: str = "s"):
        super().__init__(derivative_quantity, quantity_unit)


class CovarianceMatrixMaker:
    """Build the labelled data covariance of a quantity (reference
    ``pint_matrix.py:262``)."""

    def __init__(self, covariance_quantity: str = "toa",
                 quantity_unit: str = "s"):
        self.covariance_quantity = covariance_quantity
        self.quantity_unit = quantity_unit

    def __call__(self, data, model) -> CovarianceMatrix:
        if self.covariance_quantity == "toa":
            cov = _host(model.toa_covariance_matrix(data))
        elif self.covariance_quantity == "dm":
            cov = _host(model.dm_covariance_matrix(data))
        else:
            raise ValueError(
                f"Unknown covariance quantity {self.covariance_quantity!r}")
        lab = {self.covariance_quantity: (0, cov.shape[0], self.quantity_unit)}
        return CovarianceMatrix(cov, [lab, lab])


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------

def combine_design_matrices_by_quantity(design_matrices) -> DesignMatrix:
    """Stack row blocks of different data quantities sharing the same
    parameter columns (reference ``pint_matrix.py:288``)."""
    mats = [m for m in design_matrices if m is not None]
    base = mats[0]
    for m in mats[1:]:
        if m.derivative_params != base.derivative_params:
            raise ValueError("Parameter columns do not match: "
                             f"{m.derivative_params} vs {base.derivative_params}")
    rows = np.concatenate([m.matrix for m in mats], axis=0)
    row_labels: Dict[str, Tuple[int, int, str]] = {}
    off = 0
    for m in mats:
        for n, (s, e, u) in m.axis_labels[0].items():
            row_labels[n] = (s + off, e + off, u)
        off += m.shape[0]
    return DesignMatrix(rows, [row_labels, dict(base.axis_labels[1])])


def combine_design_matrices_by_param(matrix1: DesignMatrix,
                                     matrix2: DesignMatrix,
                                     padding: float = 0.0) -> DesignMatrix:
    """Append the columns of *matrix2*; rows of matrix2 may cover only a
    leading subset of matrix1's rows — missing rows are padded
    (reference ``pint_matrix.py:307``)."""
    n1, n2 = matrix1.shape[0], matrix2.shape[0]
    m2 = matrix2.matrix
    if n2 < n1:
        m2 = np.vstack([m2, np.full((n1 - n2, m2.shape[1]), padding)])
    elif n2 > n1:
        raise ValueError("Second design matrix has more rows than the first")
    cols = np.hstack([matrix1.matrix, m2])
    off = matrix1.shape[1]
    col_labels = dict(matrix1.axis_labels[1])
    for n, (s, e, u) in matrix2.axis_labels[1].items():
        col_labels[n] = (s + off, e + off, u)
    return DesignMatrix(cols, [dict(matrix1.axis_labels[0]), col_labels])


def combine_covariance_matrix(covariance_matrices,
                              crossterm_padding: float = 0.0) -> CovarianceMatrix:
    """Block-diagonal combination (reference ``pint_matrix.py:327``)."""
    mats = list(covariance_matrices)
    n = sum(m.shape[0] for m in mats)
    out = np.full((n, n), crossterm_padding)
    labels: Dict[str, Tuple[int, int, str]] = {}
    off = 0
    for m in mats:
        k = m.shape[0]
        out[off:off + k, off:off + k] = m.matrix
        for nm, (s, e, u) in m.axis_labels[0].items():
            labels[nm] = (s + off, e + off, u)
        off += k
    return CovarianceMatrix(out, [labels, dict(labels)])
