"""The committed stand-ins read from their par and tim files: b1855 (DD,
72 DMX windows, ECORR, red noise, FD, JUMP and EFAC/EQUAD by flag), ell1
(ecliptic astrometry, ELL1) at full width and ngc (AbsPhase from
TZRMJD/TZRSITE/TZRFRQ), each through
``pint_torch.models.get_model_and_toas`` and ``to_batch(device="cpu")``,
against the reference's run on the same files (``ref/files/``): parsed
MJDs, tim columns, host pipeline columns, parameter table, component
configs, free and design parameters, contexts and batch fields bitwise;
residuals within 1e-10 s; the fits' chi2 1e-6 rel, values 1e-2 sigma,
uncertainties 1e-6 rel; ngc's absolute-phase integers exactly; the grid
(all of ngc's 16 x 16, b1855's first point; ell1's only on the card)
within 1e-6 rel with the same argmin and rungs.  This is
``chip_smoke.py``'s files phase run on the CPU."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from pint_torch import bridge, kernels


@pytest.mark.parametrize("label,attr,grid_every", [
    ("ngc", "NGC_PATH", 1), ("b1855", "STANDIN_PATH", 16),
    ("ell1", "ELL1_PATH", 0)])
def test_committed_files_main_path(label, attr, grid_every, monkeypatch,
                                   capsys):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers at once
    try:
        counts, _ = chip_smoke._files_phase(label, getattr(bridge, attr),
                                            kernels, "[cpu]", device="cpu",
                                            grid_every=grid_every)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert f"phase files parity {label}:" in out
    assert "parser native" in out
    assert not any(counts.values())  # the plain versions ran on the CPU
