"""Rules the port keeps: no JAX, float64 throughout, the GPU by default.

* ``import pint_torch`` and loading a snapshot leave ``jax`` and
  ``pint_tpu`` out of ``sys.modules`` (checked in a fresh interpreter);
* no module of ``pint_torch``, nor ``chip_smoke.py`` or
  ``tools/torch_grid_profile.py``, imports either;
* the slice's outputs are float64 and the global default dtype is
  untouched;
* entry points run on the card unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "pint_tpu")


def _port_sources():
    files = sorted((REPO / "pint_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py",
                    REPO / "tools" / "torch_grid_profile.py"]


def test_import_and_load_pull_in_no_jax():
    code = (
        "import sys\n"
        "import pint_torch, pint_torch.bridge, pint_torch.gls_fitter, "
        "pint_torch.grid, pint_torch.kernels\n"
        "from pint_torch.bridge import load_snapshot, STANDIN_PATH\n"
        "load_snapshot(STANDIN_PATH, device='cpu')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {n}"


def test_outputs_are_float64_and_default_dtype_untouched():
    from pint_torch.bridge import STANDIN_PATH, load_snapshot
    from pint_torch.residuals import Residuals

    before = torch.get_default_dtype()
    m, b = load_snapshot(STANDIN_PATH, device="cpu")
    for t in (b.tdb.hi, b.tdb.lo, b.tdb_s.hi, b.freq, b.ssb_obs_pos):
        assert t.dtype == torch.float64
    ph = m.phase(b)
    assert ph.int_.dtype == ph.frac.dtype == torch.float64
    assert m.delay(b).dtype == torch.float64
    assert Residuals(b, m).time_resids.dtype == torch.float64
    dmx = m.components["DispersionDMX"].context["masks"]
    assert dmx.dtype == torch.float64
    assert torch.get_default_dtype() == before


def test_entry_points_default_to_the_gpu():
    from pint_torch import NoGPUError, resolve_device
    from pint_torch.bridge import STANDIN_PATH, load_snapshot

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(NoGPUError):
        resolve_device(None)
    with pytest.raises(NoGPUError):
        load_snapshot(STANDIN_PATH)


def test_cpu_tensors_never_reach_a_kernel():
    from pint_torch import kernels
    from pint_torch.kernels.dd_binary import dd_binary

    kernels.reset_counts()
    tt0 = torch.zeros((2, 5), dtype=torch.float64)
    params = torch.tensor([[12.3, 0, 0, 9.2, 0, 1e-5, 0, 276.0, 0, 0.27,
                            0.99, 0, 0, 0, 0, 0]] * 2, dtype=torch.float64)
    d = dd_binary(tt0, params)
    assert d.shape == (2, 5) and bool(torch.isfinite(d).all())
    assert kernels.launch_counts() == dict.fromkeys(
        ("spin_phase_primal", "spin_phase_dual", "dd_binary_primal",
         "dd_binary_dual", "schur_cholesky_solve"), 0)


def test_kernel_sources_ship_with_the_package():
    csrc = REPO / "pint_torch" / "kernels" / "csrc"
    for name in ("spin_phase", "dd_binary", "schur_cholesky_solve"):
        src = (csrc / f"{name}.cu").read_text()
        assert "extern \"C\"" in src and f"{name}_launch" in src
    assert np.load(REPO / "pint_torch" / "data" / "b1855_standin.npz",
                   allow_pickle=False)["tdb_hi"].shape == (4005,)
