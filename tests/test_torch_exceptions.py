"""The port's exception taxonomy (``pint_torch/exceptions.py``) against the
JAX package's (``pint_tpu/exceptions.py``) on the CPU.

Every exception or warning class the reference defines exists in the port
under the same name with the same method resolution order, by class
names: so ``except ConvergenceFailure`` catches a singular solve and
``except ValueError`` lets a ``StepProblem`` through, in both packages.
The modules that raised these classes before the port had one taxonomy
still export them, as the same objects.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import pint_tpu.exceptions as ref
import pint_torch.exceptions as port

NAMES = sorted(n for n, c in vars(ref).items()
               if inspect.isclass(c) and issubclass(c, (BaseException,
                                                        Warning))
               and c.__module__ == ref.__name__)

#: the modules that defined one of these classes before the taxonomy was
#: ported, and the names they keep exporting
OLD_PATHS = [
    ("pint_torch.fitter", n) for n in (
        "UsageError", "CorrelatedErrors", "ConvergenceFailure",
        "StepProblem", "MaxiterReached", "DegeneracyWarning",
        "NonFiniteSystemError")] + [
    ("pint_torch.runtime.solve", "NonFiniteSystemError"),
    ("pint_torch.runtime.solve", "SingularMatrixError"),
    ("pint_torch.runtime.checkpoint", "CheckpointError"),
    ("pint_torch.toa", "TOAIntegrityError"),
    ("pint_torch.models.timing_model", "MissingComponent"),
    ("pint_torch.models.binary.components", "MissingParameter"),
    ("pint_torch.models.binary.components", "TimingModelError")]


def _mro_names(cls):
    return [c.__name__ for c in cls.__mro__]


@pytest.mark.parametrize("name", NAMES)
def test_exception_mro_matches_the_reference(name):
    cls = getattr(port, name)
    assert _mro_names(cls) == _mro_names(getattr(ref, name))
    assert cls.__module__ == port.__name__
    if not issubclass(cls, Warning):
        assert issubclass(cls, port.PintError)


def test_every_exported_name_is_the_references():
    assert set(port.__all__) == set(NAMES)


@pytest.mark.parametrize("module, name", OLD_PATHS,
                         ids=[f"{m}.{n}" for m, n in OLD_PATHS])
def test_old_import_paths_resolve_to_the_taxonomy(module, name):
    assert getattr(importlib.import_module(module), name) \
        is getattr(port, name)


def test_constructors_take_the_references_arguments():
    for cls in (port, ref):
        e = cls.MissingParameter("BinaryDD", "A1")
        assert (e.module, e.param, str(e)) == (
            "BinaryDD", "A1", "BinaryDD requires parameter A1")
        assert cls.TOAIntegrityError("bad", report=3).report == 3
    assert str(port.MissingParameter(msg="x")) == "x"


def test_handlers_catch_what_the_references_catch():
    """A singular solve is a ``ConvergenceFailure``; a ``StepProblem`` is
    no ``ValueError``; a ``UsageError`` still is one."""
    from pint_torch.runtime.solve import hardened_cholesky

    with pytest.raises(port.ConvergenceFailure):
        hardened_cholesky(-torch.eye(3, dtype=torch.float64))
    with pytest.raises(port.ConvergenceFailure):
        hardened_cholesky(torch.full((2, 2), np.nan, dtype=torch.float64))
    for cls, is_value_error in ((port.StepProblem, False),
                                (port.MaxiterReached, False),
                                (port.CheckpointError, False),
                                (port.UsageError, True),
                                (port.TOAIntegrityError, True)):
        try:
            raise cls("x")
        except ValueError:
            caught = True
        except port.PintError:
            caught = False
        assert caught == is_value_error, cls
