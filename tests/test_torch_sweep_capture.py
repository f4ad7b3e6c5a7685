"""Each model family's grid chunk function scanned on the CPU for the calls
a CUDA graph cannot capture (``grid_chisq(fuse=)`` captures it on the
card): a host-to-device copy, a device-to-host read, a Python-sequence or
numpy index, a data-dependent shape.  The scan runs under a
``TorchFunctionMode`` re-entered inside the port's ``autograd.Function``s;
it reads the code path, not the data, so a full-width stand-in is scanned
on every :data:`SCAN_STRIDE`-th of its TOAs (a subset that keeps each DMX
window and backend populated).  The scan's own check: it finds a host copy
of a frozen value in ``evaluate`` and a list index inside a kernel
wrapper's ``jvp``.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

#: a full-width stand-in is scanned on every SCAN_STRIDE-th TOA
SCAN_STRIDE = 16

#: each binary family's GLS stand-in: a committed snapshot, or (DDGR,
#: whose snapshots are WLS) the small DDGR stand-in with five red-noise
#: modes, built through the reference
CAPTURE_MODELS = {
    "dd": "STANDIN_PATH", "dds": "DDS_SMALL_PATH", "ddh": "DDH_SMALL_PATH",
    "ddk": "DDK_PATH", "bt": "BT_SMALL_PATH",
    "bt_piecewise": "BT_PIECEWISE_SMALL_PATH",
    "dd_fbx": "DD_FBX_SMALL_PATH", "swx": "WB_SMALL_PATH",
    "ddgr": dict(standin.SMALL_DDGR_SETTINGS, rn_modes=5)}
#: the families committed only as WLS stand-ins (ELL1, ELL1H, ELL1 with
#: FB, glitches, PHOFF): their WLS chunk function runs the same
#: ``evaluate`` a GLS model of the family would
CAPTURE_WLS_MODELS = {
    "ell1": "ELL1_PATH", "ell1h": "ELL1H_PATH", "bw": "BW_PATH",
    "young": "YOUNG_SMALL_PATH", "ngc_phoff": "NGC_PHOFF_PATH"}


def _in_functions(mode, monkeypatch):
    """Run the port's ``torch.autograd.Function`` methods (the kernels'
    wrappers, the double-double helpers) under ``mode`` too: PyTorch
    turns torch-function modes off inside them."""
    import importlib
    import pkgutil

    import torch

    import pint_torch.kernels

    def under_mode(f):
        def run(*args, **kwargs):
            with mode():
                return f(*args, **kwargs)
        return run

    mods = [importlib.import_module("pint_torch.dd")] + [
        importlib.import_module(f"pint_torch.kernels.{m.name}")
        for m in pkgutil.iter_modules(pint_torch.kernels.__path__)]
    for mod in mods:
        for cls in vars(mod).values():
            if isinstance(cls, type) and cls.__module__ == mod.__name__ \
                    and issubclass(cls, torch.autograd.Function):
                for name in ("forward", "setup_context", "jvp", "vmap"):
                    f = cls.__dict__.get(name)
                    if isinstance(f, staticmethod):
                        monkeypatch.setattr(cls, name, staticmethod(
                            under_mode(f.__func__)))


def _host_syncs(fn, pts, monkeypatch):
    """Run ``fn(pts)`` and return the calls under a chunk function that a
    CUDA graph refuses to capture: a host-to-device copy (``torch.tensor``,
    ``as_tensor``, ``from_numpy``), a device-to-host read (``item``,
    ``cpu``, ``tolist``, ``numpy``, ``float``/``int``/``bool`` of a
    tensor), an index of a Python sequence or a numpy array (copied to
    the device at each call) or a data-dependent shape (``nonzero``, a
    boolean mask index); each as (call, the innermost repo frames)."""
    import traceback

    import torch
    from torch.overrides import TorchFunctionMode

    syncs = {torch.tensor, torch.as_tensor, torch.from_numpy, torch.nonzero,
             torch.Tensor.nonzero, torch.Tensor.item, torch.Tensor.cpu,
             torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.__bool__,
             torch.Tensor.__float__, torch.Tensor.__int__}

    class Scan(TorchFunctionMode):
        hits = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            bad = func in syncs
            if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
                idx = args[1] if isinstance(args[1], tuple) else (args[1],)
                bad = any(torch.is_tensor(i) and i.dtype == torch.bool
                          or isinstance(i, (list, np.ndarray)) for i in idx)
            if bad:
                stack = traceback.extract_stack()
                if any(f.name == "chunk_fn" for f in stack):
                    self.hits.append((getattr(func, "__name__", str(func)), [
                        f"{os.path.basename(f.filename)}:{f.lineno}"
                        for f in stack[-5:-1]]))
            return func(*args, **(kwargs or {}))

    _in_functions(Scan, monkeypatch)
    with Scan():
        fn(pts)
    return Scan.hits


@pytest.mark.parametrize("frozen", [False, True], ids=["fitted", "frozen"])
@pytest.mark.parametrize("family", sorted(CAPTURE_MODELS)
                         + sorted(CAPTURE_WLS_MODELS))
def test_gls_chunk_is_capturable(family, frozen, monkeypatch):
    """Each binary family's GLS chunk function (the WLS one where the
    family has no GLS stand-in) makes no call a CUDA graph refuses, so
    ``grid_chisq(fuse=)`` can capture it on the card: with its parameters
    as fitted, and with every parameter but F0, F1 and the grid pair
    frozen (a frozen value reaches ``evaluate`` as a number, not a
    tensor)."""
    from pint_torch import bridge
    from pint_torch.grid import build_grid_chi2_fn, point_spans

    src = CAPTURE_MODELS.get(family) or CAPTURE_WLS_MODELS[family]
    if isinstance(src, dict):
        m, b = standin.port_and_reference(src)[2:]
    else:
        m, b = bridge.load_snapshot(getattr(bridge, src), device="cpu")
    if b.ntoas > 1000:
        b = b.select(np.arange(b.ntoas) % SCAN_STRIDE == 0, m)
    assert bool(m.noise_basis_by_component(b)[0]) \
        == (family in CAPTURE_MODELS)
    free = [n for n, p in m.params_table.items() if not p.frozen]
    grid = tuple(n for n in free if n not in ("F0", "F1"))[-2:]
    if frozen:
        for n in free:
            if n not in ("F0", "F1") + grid:
                m[n].frozen = True
    pts = np.array([[m.value(grid[0]), m.value(grid[1])]] * 2)
    fn, _, _ = build_grid_chi2_fn(m, b, grid, niter=1, chunk=2,
                                  grid_spans=point_spans(m, grid, pts))
    assert _host_syncs(fn, pts, monkeypatch) == []


@pytest.mark.parametrize("fault", ["frozen_value_copied", "list_index_in_jvp"])
def test_the_capture_scan_sees_a_host_copy(fault, monkeypatch):
    """The scan above finds a ``torch.tensor`` of a frozen value inside
    ``evaluate`` (the former form of the DDS sine's SHAPMAX), and a list
    index inside a kernel wrapper's ``jvp`` (the former form of K2's row
    gather), where PyTorch turns torch-function modes off."""
    import torch

    from pint_torch import bridge
    from pint_torch.grid import build_grid_chi2_fn, point_spans
    from pint_torch.kernels.dd_binary import DDBinaryFn
    from pint_torch.models.binary import engines

    if fault == "frozen_value_copied":
        def on_host(v, like):
            return v if torch.is_tensor(v) else torch.tensor(
                [[float(v)]], dtype=like.dtype, device=like.device)

        monkeypatch.setattr(engines, "_tensor", on_host)
        want, where = "tensor", "engines.py"
    else:
        jvp = DDBinaryFn.jvp

        def listed(ctx, d_tt0, d_params, *rest):
            if d_params is not None:
                d_params = d_params[..., list(range(d_params.shape[-1]))]
            return jvp(ctx, d_tt0, d_params, *rest)

        monkeypatch.setattr(DDBinaryFn, "jvp", staticmethod(listed))
        want, where = "__getitem__", "test_torch_sweep_capture.py"
    m, b = bridge.load_snapshot(bridge.DDS_SMALL_PATH, device="cpu")
    m["SHAPMAX"].frozen = True
    pts = np.array([[m.value("M2"), m.value("A1")]] * 2)
    fn, _, _ = build_grid_chi2_fn(m, b, ("M2", "A1"), niter=1, chunk=2,
                                  grid_spans=point_spans(m, ("M2", "A1"),
                                                         pts))
    hits = _host_syncs(fn, pts, monkeypatch)
    assert hits and all(h[0] == want for h in hits)
    assert any(where in f for h in hits for f in h[1])


