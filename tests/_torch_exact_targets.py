"""The predictor node targets of both packages against the same targets in
exact rational arithmetic, on the CPU.

The port's spin phase at every node (and at the TZR row) is recomputed
with ``fractions.Fraction`` from the float64 inputs the port's K1 plain
version received there -- the TDB pair, PEPOCH, the delay and the spin
frequencies -- as ``sum_i F_i dt^(i+1) / (i+1)!`` with ``dt`` exact; the
exact targets are ``(P - P_mid) - 60 F0 dt_min`` with the same float64
``dt_min``.  Printed: each package's largest and mean distance from them
in cycles and in granules q = ulp(F0 max|delay|), and at how many nodes
each is the nearer.  Run from the repository root::

    JAX_PLATFORMS=cpu python tests/_torch_exact_targets.py [ell1|b1855]
"""

import math
import os
import sys
from fractions import Fraction as Fr

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

#: the windows: two days of 60-minute windows from MJD 55000, 12
#: coefficients (24 nodes a window), at GBT and 1400 MHz
SEG, NC, SPAN_D, OBS, FREQ = 60.0, 12, 2.0, "gbt", 1400.0


def _exact_phases(args):
    """Exact phases (Fractions) of one K1 call's rows, and its delays."""
    th, tl, tdb0, pe, dl, F, has_pe = args[:7]
    th, tl = th.numpy(), tl.numpy()
    dl, pe, F = dl.numpy()[0], pe.numpy()[0], F.numpy()[0]
    off = ((Fr(float(pe[0])) - Fr(float(tdb0))) * 86400
           + Fr(float(pe[1])) * 86400) if has_pe else Fr(0)
    out = []
    for i in range(len(dl)):
        dt = Fr(float(th[i])) + Fr(float(tl[i])) - Fr(float(dl[i])) - off
        out.append(sum(Fr(float(f)) * dt ** (j + 1) / math.factorial(j + 1)
                       for j, f in enumerate(F)))
    return out, dl


def main(which: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    import _torch_standin as standin
    import pint_torch.kernels.spin_phase as K1
    from pint_torch.bridge import load_snapshot
    from pint_torch.predict import generate as pg
    from pint_tpu import toa as rtoa
    from pint_tpu.models import get_model
    from pint_tpu.predict import generate as rg

    par = {"ell1": standin.j1909_par(standin.ELL1_SETTINGS),
           "b1855": standin.standin_par(standin.FULL_SETTINGS,
                                        full=True)}[which]
    model = get_model(par.splitlines(keepends=True))
    toas = rtoa.get_TOAs_array(np.linspace(55000.1, 55003.3, 8), OBS,
                               freqs=FREQ, ephem="DE440")
    m, _ = load_snapshot(standin.export_state(model, toas), device="cpu")
    tm = rg.window_tmids(55000.0, 55000.0 + SPAN_D, SEG)
    calls = []
    plain = K1.spin_phase_reference

    def spy(*a, **k):
        calls.append(a)
        return plain(*a, **k)

    K1.spin_phase_reference = spy
    try:
        p = pg.node_targets(m, tm, SEG, NC, OBS, FREQ)
    finally:
        K1.spin_phase_reference = plain
    r = rg.node_targets(model, tm, SEG, NC, OBS, FREQ)
    nodes, dl = _exact_phases(calls[0])
    tzr = _exact_phases(calls[1])[0][0] if len(calls) > 1 else Fr(0)
    W, nn = p["y"].shape
    mjds, _ = pg.node_mjds(tm, SEG, NC)
    dt_min = (mjds - tm[:, None]) * 1440.0
    imid = np.argmin(np.abs(dt_min), axis=1)
    f0 = float(p["f0"])
    gp, gr = [], []
    for w in range(W):
        mid = nodes[w * nn + imid[w]] - tzr
        for j in range(nn):
            ex = (nodes[w * nn + j] - tzr) - mid \
                - Fr(60.0) * Fr(f0) * Fr(float(dt_min[w, j]))
            gp.append(abs(float(Fr(float(p["y"][w, j])) - ex)))
            gr.append(abs(float(Fr(float(r["y"][w, j])) - ex)))
    gp, gr = np.array(gp), np.array(gr)
    q = float(np.spacing(f0 * np.abs(dl).max()))
    print(f"{which}: {W} windows x {nn} nodes; F0 {f0}; max|delay| "
          f"{np.abs(dl).max():.3f} s; q = ulp(F0 max|delay|) {q:.3e} cycles")
    for name, g in (("port", gp), ("reference", gr)):
        print(f"{name} |y - exact|: max {g.max():.3e} ({g.max() / q:.2f} q), "
              f"mean {g.mean():.3e} ({g.mean() / q:.2f} q)")
    print(f"port nearer at {int((gp < gr).sum())} nodes, the reference at "
          f"{int((gr < gp).sum())}, tied at {int((gp == gr).sum())} of "
          f"{len(gp)}; |y_port - y_reference| max "
          f"{np.abs(p['y'] - r['y']).max():.3e}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "ell1")
