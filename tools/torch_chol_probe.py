#!/usr/bin/env python3
"""Build K9 (``chol_rank_update``) and K10 (``hd_cross_lnlike``, with K12's
value-and-gradient sequence) on one CUDA GPU, hold each kernel against its
plain version at the main paths' widths, and time it.

Run from the root of a checkout on a machine with one CUDA GPU and nvcc::

    python3 tools/torch_chol_probe.py [--skip-k10] [--skip-k9] [--reps N]
                                      [--variants] [--k9-variants]
                                      [--k12-variants] [--micro]

K10: pta67_catalog's G and u (the catalogue loaded, ingested and put into
a ``JointLikelihood`` from its snapshot values, no fit pass), the bench's
first B points, bitwise its plain version at B = 16, 32 and 48, exactly
0.0 at zero amplitude; its time at B = 32 (median of ``--reps`` calls,
CUDA events), the library yardstick (``cholesky_ex`` + ``solve_triangular``
+ log-det of the formed M) and launches a call; then K12 (value and
gradient from one factor): the value bitwise K10's and the gradient
bitwise its plain version at B = 16, 32, 48 and 64, in the wrapper's
chunks and in chunks of 3, timed at B = 32 and 64 beside K10 alone with
the device time by kernel; with ``--k12-variants`` K12's inverse built
otherwise (``K12_VARIANTS``), bitwise the committed and timed beside it.
K9: random SPD factors
at K = 150 (shared memory) and 233 (global) with zero rows interleaved,
k = 4, 16 and 64 rows (3, 9 and 45 of them nonzero, as on the stream
path), each sign, alone and fused with the ingest: bitwise its plain
versions; the time of each, its chain of dependent column steps and the
library's ``cholesky_ex`` of the updated Gram.  With ``--variants``, K10's
source is also built with other blockings (one constant changed: the panel
width, the panel's rows a CTA, the register tile, the panel columns staged
at a time) into ``pint_torch/_build/variants/`` and each is held bitwise
against the plain
version and timed at B = 32 beside the committed blocking, in two rounds
(the second in reverse order); and one committed call's device time is
split by kernel under ``torch.profiler``.  With ``--k9-variants``, K9's
source built with other thread counts (its ``PAIRS``: pairs a thread takes
a step at full rows) is held bitwise against its plain version and
timed at K = 150 beside the committed one.  With ``--micro``, the clock
cycles of one dependent float64 division, square root, multiply-subtract
and add and of one 128-thread barrier (``tools/csrc/fp64_latency.cu``,
the kernels' nvcc flags).  Prints one line a check and the card's name and
power limit.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _ms(torch, fn, reps):
    """Median device ms of ``reps`` calls, each timed by ``chip_smoke``'s
    ``_time_ms`` (CUDA events, the call queued behind a spin kernel so
    that the host's launch cost stays out of the window)."""
    from chip_smoke import _time_ms

    fn()
    return statistics.median(_time_ms(fn, 1, warmup=0) for _ in range(reps))


#: K10 blockings timed beside the committed one (``--variants``)
K10_VARIANTS = {
    "rb64": [("constexpr int RB = 128;", "constexpr int RB = 64;")],
    "nb32": [("constexpr int NB = 64;", "constexpr int NB = 32;")],
    "tile4x4": [("constexpr int TM = 8;", "constexpr int TM = 4;")],
    "kc16": [("constexpr int KC = 32;", "constexpr int KC = 16;")]}


#: K12's inverse built otherwise (one constant or line changed): 128-column
#: tiles (every thread a column in the in-block phase, an 8 x 8 register
#: tile), the in-block phase's shifting loop for whole blocks too, a ring
#: of 8-row stages, three CTAs an SM (a register cap)
K12_VARIANTS = {
    "itc128": [("constexpr int ITC = 64;", "constexpr int ITC = 128;")],
    "shift": [("  if (nbw == NB) {\n    // a whole block",
               "  if (false) {\n    // a whole block")],
    "ks8": [("constexpr int KS = 16;         // rows j a stage",
             "constexpr int KS = 8;         // rows j a stage")],
    "lb3": [("__launch_bounds__(IT)\nhd_cross_inv_left",
             "__launch_bounds__(IT, 3)\nhd_cross_inv_left")]}


def _same(a, b) -> bool:
    """Bitwise equal, NaN where the other is NaN."""
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _patched(kernel, name, pairs):
    """The committed ``csrc/<kernel>.cu`` with each (old, new) of ``pairs``
    replaced once, written beside the variant libraries; returns (source,
    library) paths."""
    from pint_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} not once in {kernel}")
        src = src.replace(old, new)
    cu = out_dir / f"{kernel}-{name}.cu"
    cu.write_text(src)
    return cu, out_dir / f"{kernel}-{name}.so"


def _variant_libs(variants=None):
    """Build each K10 (or K12) variant; returns {name: loaded library}."""
    from pint_torch.kernels import _build

    procs = {}
    for name, pairs in (variants or K10_VARIANTS).items():
        cu, so = _patched("hd_cross_lnlike", name, pairs)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for K10 {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"probe ptxas k10 {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.hd_cross_lnlike_error_string.argtypes = [ctypes.c_int]
        lib.hd_cross_lnlike_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def k10_variants(torch, K10, args32, want, reps, tag):
    from pint_torch.kernels import _build

    committed = _build.load("hd_cross_lnlike")
    libs = {"committed": committed, **_variant_libs()}
    for lib in libs.values():
        lib.hd_cross_lnlike_launch.argtypes = \
            committed.hd_cross_lnlike_launch.argtypes
        lib.hd_cross_lnlike_launch.restype = ctypes.c_int
    ok, times = True, {n: [] for n in libs}
    order = list(libs)
    for rnd in (order, order[::-1]):
        for name in rnd:
            _build._loaded["hd_cross_lnlike"] = libs[name]
            got = K10._launch(*args32)
            bit = bool(torch.equal(got, want))
            ok = ok and bit
            times[name].append(_ms(torch, lambda: K10._launch(*args32), reps))
            if not bit:
                print(f"probe k10 variant {name}: DIFFERS {tag}", flush=True)
    _build._loaded["hd_cross_lnlike"] = committed
    cap = K10.WORKSPACE_CAP_BYTES
    for c in (cap, cap // 2):
        K10.WORKSPACE_CAP_BYTES = c
        print(f"probe k10 cap {c / 2**20:.0f} MiB (chunks of "
              f"{K10.walkers_per_chunk(32, args32[0].shape[0])}): "
              f"{_ms(torch, lambda: K10._launch(*args32), reps):.4f} ms "
              f"{tag}", flush=True)
    K10.WORKSPACE_CAP_BYTES = cap
    for name, ts in times.items():
        print(f"probe k10 variant {name}: {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"(rounds 1 / 2, B=32) {tag}", flush=True)
    split = _profile_split(lambda: K10._launch(*args32), K10.KERNELS.values())
    print(f"probe k10 split (torch.profiler, device ms a B=32 call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" {tag}",
          flush=True)
    return ok


def _profile_split(fn, names) -> dict:
    """Device ms of one call of ``fn`` by kernel, for each of ``names``
    among ``torch.profiler``'s averages (empty where the profiler shows no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        for n in names:
            if n in ev.key and us:
                out[n] = out.get(n, 0.0) + us / 1e3
    return out


def k10(torch, reps, tag, variants=False, k12_variants_too=False):
    import numpy as np

    from pint_torch.bridge import (CATALOG_PATH, load_catalog_snapshot,
                                   read_snapshot)
    from pint_torch.catalog import (CatalogFitter, JointLikelihood,
                                    ingest_catalog)
    from pint_torch.kernels import hd_cross_lnlike as K10

    meta, ref = read_snapshot(CATALOG_PATH)
    S = meta["reference"]["settings"]
    cf = CatalogFitter(ingest_catalog(load_catalog_snapshot(CATALOG_PATH,
                                                            device="cuda")))
    jl = JointLikelihood(cf, n_modes=S["n_modes"])
    G, u, f, T = jl.G, jl.u, jl._freqs_t, jl.Tspan
    R, m = G.shape[0], f.shape[0]
    pts = torch.as_tensor(ref["ref/catalog/likelihood/points"],
                          dtype=torch.float64, device="cuda")
    ok = True
    for B in (16, 32, 48):
        la, ga = pts[:B, 0].contiguous(), pts[:B, 1].contiguous()
        got = K10._launch(G, u, la, ga, f, T)
        want = K10.hd_cross_lnlike_reference(G, u, la, ga, f, T)
        bit = bool(torch.equal(got, want))
        ok = ok and bit
        print(f"probe k10 B={B} R={R}: {'bitwise' if bit else 'DIFFERS'} "
              f"(max abs {float((got - want).abs().max()):.3e}), chunk "
              f"{K10.walkers_per_chunk(B, R)} {tag}", flush=True)
    zl = torch.tensor([-np.inf, -14.0], dtype=torch.float64, device="cuda")
    zg = torch.tensor([4.33, 4.33], dtype=torch.float64, device="cuda")
    z0 = K10._launch(G, u, zl, zg, f, T).cpu()
    ok = ok and float(z0[0]) == 0.0 and float(z0[1]) != 0.0
    print(f"probe k10 zero amplitude: {z0.tolist()} {tag}", flush=True)
    la, ga = pts[:32, 0].contiguous(), pts[:32, 1].contiguous()
    before = dict(K10.launch_counts)
    K10._launch(G, u, la, ga, f, T)
    per_call = {k: v - before[k] for k, v in K10.launch_counts.items()}
    ms = _ms(torch, lambda: K10._launch(G, u, la, ga, f, T), reps)
    eye = torch.eye(R, dtype=torch.float64, device="cuda")
    d = K10._sqrt_phi(la, ga, f, T).repeat_interleave(2, dim=1).repeat(
        1, R // (2 * m))
    M, v = (d[:, :, None] * G) * d[:, None, :] + eye, d * u

    def library():
        L, _ = torch.linalg.cholesky_ex(M)
        z = torch.linalg.solve_triangular(L, v[..., None], upper=False)
        return 0.5 * (z[..., 0] ** 2).sum(-1) - torch.log(
            torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)

    lib = _ms(torch, library, reps)
    print(f"probe k10 B=32: {ms:.4f} ms (median of {reps}), library "
          f"{lib:.4f} ms, launches a call {per_call} {tag}", flush=True)
    if variants:
        want = K10.hd_cross_lnlike_reference(G, u, la, ga, f, T)
        ok = k10_variants(torch, K10, (G, u, la, ga, f, T), want, reps,
                          tag) and ok
    return k12(torch, K10, (G, u, f, T), pts, reps, tag,
               k12_variants_too) and ok


def k12_variants(torch, K10, data, pts, reps, tag):
    """K12's sequence at B = 32 with each of :data:`K12_VARIANTS` beside
    the committed source, in two rounds (the second in reverse order):
    value and gradient bitwise the committed library's."""
    from pint_torch.kernels import _build

    G, u, f, T = data
    la, ga = pts[:32, 0].contiguous(), pts[:32, 1].contiguous()
    committed = _build.load("hd_cross_lnlike")
    want = K10._launch_value_and_grad(G, u, la, ga, f, T)
    libs = {"committed": committed, **_variant_libs(K12_VARIANTS)}
    ok, times = True, {n: [] for n in libs}
    order = list(libs)
    for rnd in (order, order[::-1]):
        for name in rnd:
            _build._loaded["hd_cross_lnlike"] = libs[name]
            got = K10._launch_value_and_grad(G, u, la, ga, f, T)
            bit = all(bool(torch.equal(x, y)) for x, y in zip(got, want))
            ok = ok and bit
            times[name].append(_ms(torch, lambda: K10._launch_value_and_grad(
                G, u, la, ga, f, T), reps))
            if not bit:
                print(f"probe k12 variant {name}: DIFFERS {tag}", flush=True)
    _build._loaded["hd_cross_lnlike"] = committed
    for name, ts in times.items():
        print(f"probe k12 variant {name}: {ts[0]:.4f} / {ts[1]:.4f} ms "
              f"(rounds 1 / 2, B=32) {tag}", flush=True)
    return ok


def k12(torch, K10, data, pts, reps, tag, variants=False):
    """K12's launch sequence (value and gradient from one factor) on the
    bench's points, the first 48 and 16 more at their mean moved by
    seeded steps: the value bitwise K10's and the gradient bitwise its
    plain version at B = 16, 32, 48 and 64, in the wrapper's chunks and in
    chunks of 3; timed at B = 32 and 64 beside K10 alone."""
    G, u, f, T = data
    R = G.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(64)
    extra = pts.mean(0) + 0.1 * torch.randn(16, 2, generator=gen,
                                             dtype=torch.float64,
                                             device="cuda")
    pts = torch.cat([pts, extra])
    per = 8 * (R * (R + 1) + (K10.NB + 2) * R)
    ok = True
    for B in (16, 32, 48, 64):
        la, ga = pts[:B, 0].contiguous(), pts[:B, 1].contiguous()
        v, g = K10._launch_value_and_grad(G, u, la, ga, f, T)
        cap = K10.WORKSPACE_CAP_BYTES
        K10.WORKSPACE_CAP_BYTES = 3 * per
        try:
            v3, g3 = K10._launch_value_and_grad(G, u, la, ga, f, T)
        finally:
            K10.WORKSPACE_CAP_BYTES = cap
        want_v = K10._launch(G, u, la, ga, f, T)
        want_g = K10.hd_cross_grad_reference(G, u, la, ga, f, T)
        bit = all(bool(torch.equal(x, y)) for x, y in (
            (v, want_v), (v3, want_v), (g, want_g), (g3, want_g)))
        ok = ok and bit
        print(f"probe k12 B={B} R={R}: {'bitwise' if bit else 'DIFFERS'} "
              f"(value {float((v - want_v).abs().max()):.3e}, gradient "
              f"{float((g - want_g).abs().max()):.3e}) {tag}", flush=True)
    for B in (32, 64):
        la, ga = pts[:B, 0].contiguous(), pts[:B, 1].contiguous()
        before = dict(K10.launch_counts)
        K10._launch_value_and_grad(G, u, la, ga, f, T)
        per_call = {k: v - before[k] for k, v in K10.launch_counts.items()
                    if v != before[k]}
        ms = _ms(torch, lambda: K10._launch_value_and_grad(
            G, u, la, ga, f, T), reps)
        ms10 = _ms(torch, lambda: K10._launch(G, u, la, ga, f, T), reps)
        split = _profile_split(lambda: K10._launch_value_and_grad(
            G, u, la, ga, f, T), ("hd_cross_form", "hd_cross_panel",
                                  "hd_cross_trail", "hd_cross_sum",
                                  "hd_cross_inv_left", "hd_cross_colsum",
                                  "hd_cross_bins"))
        print(f"probe k12 B={B}: value and gradient {ms:.4f} ms, K10 alone "
              f"{ms10:.4f} ms (medians of {reps}); launches a call "
              f"{per_call}; device ms by kernel {split} {tag}", flush=True)
    if variants:
        ok = k12_variants(torch, K10, data, pts, reps, tag) and ok
    return ok


def k9(torch, reps, tag):
    from pint_torch.kernels import chol_rank_update as K9

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    ok = True

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device="cuda")

    for K in (150, 233):
        A = rnd(K + 9, K)
        L = torch.linalg.cholesky(A.T @ A + torch.eye(
            K, dtype=torch.float64, device="cuda")).contiguous()
        # the fixed cost (no row), and one, two and four rows' chains
        for n in (0, 1, 2, 4):
            V = torch.zeros((4, K), dtype=torch.float64, device="cuda")
            V[:n] = rnd(n, K)
            ms = _ms(torch, lambda: K9._launch(L, V, 1.0), reps)
            print(f"probe k9 K={K} {n} of 4 rows nonzero: {ms:.4f} ms "
                  f"({K9.chain_steps(K, n)} steps) {tag}", flush=True)
        for k, nz in ((4, 3), (16, 9), (64, 45)):
            V = rnd(k, K)
            keep = torch.randperm(k, generator=torch.Generator().manual_seed(
                k))[:nz].sort().values
            mask = torch.zeros(k, dtype=torch.bool)
            mask[keep] = True
            V[~mask.cuda()] = 0.0
            w = torch.rand(k, generator=gen, dtype=torch.float64,
                           device="cuda") + 0.5
            r, dx = rnd(k), 1e-3 * rnd(K)
            b, c2 = rnd(K), torch.tensor(7.0, dtype=torch.float64,
                                         device="cuda")
            up = K9._launch(L, V, 1.0)
            bits = [_same(up, K9.chol_rank_update_reference(L, V, 1.0))]
            down = K9._launch(up, V, -1.0)
            bits.append(_same(down, K9.chol_rank_update_reference(
                up, V, -1.0)))
            for sign, L0 in ((1.0, L), (-1.0, up)):
                got = K9._launch(L0, V, sign, (b, c2, r, w, dx))
                want = K9.stream_ingest_reference(L0, b, c2, V, r, w, dx,
                                                  sign)
                bits.append(_same(got[0], want[0])
                            and float(got[3]) == float(want[3]))
            ok = ok and all(bits)
            ms_rank = _ms(torch, lambda: K9._launch(L, V, 1.0), reps)
            ms_ing = _ms(torch, lambda: K9._launch(L, V, 1.0,
                                                   (b, c2, r, w, dx)), reps)
            Vw = torch.sqrt(w)[:, None] * V
            Gm = L @ L.T + Vw.T @ Vw
            lib = _ms(torch, lambda: torch.linalg.cholesky_ex(Gm), reps)
            steps = K9.chain_steps(K, nz)
            print(f"probe k9 K={K} k={k} ({nz} rows; smem "
                  f"{K9.uses_smem(K)}, pass {K9.pass_rows(K)} rows): "
                  f"update/downdate/ingest +/- "
                  f"{['bitwise' if x else 'DIFFERS' for x in bits]}; "
                  f"chol_rank_update {ms_rank:.4f} ms, stream_ingest "
                  f"{ms_ing:.4f} ms ({1e3 * ms_ing / steps:.3f} us a step "
                  f"of {steps}), library cholesky_ex {lib:.4f} ms {tag}",
                  flush=True)
    return ok


#: K9 thread counts timed beside the committed one (``--k9-variants``)
K9_VARIANTS = {
    n: [("constexpr int PAIRS = 4;", f"constexpr int PAIRS = {v};")]
    for n, v in (("pairs2", 2), ("pairs8", 8), ("pairs16", 16))}


def k9_variants(torch, reps, tag):
    from pint_torch.kernels import _build
    from pint_torch.kernels import chol_rank_update as K9

    committed = _build.load("chol_rank_update")
    libs = {"committed": committed}
    for name, pairs in K9_VARIANTS.items():
        cu, so = _patched("chol_rank_update", name, pairs)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(so), str(cu)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.chol_rank_update_error_string.argtypes = [ctypes.c_int]
        lib.chol_rank_update_error_string.restype = ctypes.c_char_p
        for f in ("chol_rank_update_launch", "chol_rank_update_uses_smem",
                  "chol_rank_update_pass_rows"):
            getattr(lib, f).argtypes = getattr(committed, f).argtypes
            getattr(lib, f).restype = getattr(committed, f).restype
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(7)
    K = 150
    A = torch.randn((K + 9, K), generator=gen, dtype=torch.float64,
                    device="cuda")
    L = torch.linalg.cholesky(A.T @ A + torch.eye(
        K, dtype=torch.float64, device="cuda")).contiguous()
    ok = True
    for k, nz in ((4, 3), (16, 9), (64, 45)):
        V = torch.randn((k, K), generator=gen, dtype=torch.float64,
                        device="cuda")
        V[nz:] = 0.0
        w = torch.rand(k, generator=gen, dtype=torch.float64,
                       device="cuda") + 0.5
        vecs = (torch.randn(K, generator=gen, dtype=torch.float64,
                            device="cuda"),
                torch.tensor(7.0, dtype=torch.float64, device="cuda"),
                torch.randn(k, generator=gen, dtype=torch.float64,
                            device="cuda"), w,
                1e-3 * torch.randn(K, generator=gen, dtype=torch.float64,
                                   device="cuda"))
        want = K9.stream_ingest_reference(L, vecs[0], vecs[1], V, vecs[2],
                                          vecs[3], vecs[4], 1.0)[0]
        times = {n: [] for n in libs}
        for rnd in (list(libs), list(libs)[::-1]):
            for name in rnd:
                _build._loaded["chol_rank_update"] = libs[name]
                bit = _same(K9._launch(L, V, 1.0, vecs)[0], want)
                ok = ok and bit
                times[name].append(_ms(torch, lambda: K9._launch(
                    L, V, 1.0, vecs), reps))
                if not bit:
                    print(f"probe k9 variant {name}: DIFFERS {tag}",
                          flush=True)
        _build._loaded["chol_rank_update"] = committed
        print(f"probe k9 variants K={K} k={k} ({nz} rows) stream_ingest "
              "(rounds 1 / 2): " + ", ".join(
                  f"{n} {a:.4f} / {b:.4f} ms" for n, (a, b) in times.items())
              + f" {tag}", flush=True)
    return ok


def micro(torch, tag):
    from pint_torch.kernels import _build

    src = ROOT / "tools" / "csrc" / "fp64_latency.cu"
    so = _build.BUILD_DIR / "variants" / "fp64_latency.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.fp64_latency_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
    n = 1 << 14
    sink = torch.zeros(1, dtype=torch.float64, device="cuda")
    out = torch.zeros(5, dtype=torch.int64, device="cuda")
    for threads in (128, 1024):
        args = (n, threads, ctypes.c_void_p(sink.data_ptr()),
                ctypes.c_void_p(out.data_ptr()))
        lib.fp64_latency_launch(*args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rc = lib.fp64_latency_launch(*args)
        b.record()
        torch.cuda.synchronize()
        c = [v / n for v in out.tolist()]
        mhz = sum(out.tolist()) / (a.elapsed_time(b) * 1e3)
        print(f"probe micro ({threads} threads, rc {rc}): cycles a dependent "
              f"division + add {c[0]:.1f}, sqrt + add {c[1]:.1f}, "
              f"multiply-subtract {c[2]:.1f}, barrier {c[3]:.1f}, add "
              f"{c[4]:.1f}; SM clock {mhz:.0f} MHz (cycles over the launch's "
              f"event time) {tag}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-k10", action="store_true")
    ap.add_argument("--skip-k9", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--k9-variants", action="store_true")
    ap.add_argument("--k12-variants", action="store_true")

    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_chol_probe: no CUDA GPU", file=sys.stderr)
        return 2
    from pint_torch.kernels import _build

    tag = f"[{_card()}]"
    t0 = time.perf_counter()
    _build.build(["chol_rank_update", "hd_cross_lnlike"])
    print(f"probe build {time.perf_counter() - t0:.2f} s {tag}", flush=True)
    for name in ("chol_rank_update", "hd_cross_lnlike"):
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"probe ptxas {name}: {line.strip()}", flush=True)
    ok = True
    if args.micro:
        micro(torch, tag)
    if not args.skip_k9:
        ok = k9(torch, args.reps, tag) and ok
    if args.k9_variants:
        ok = k9_variants(torch, args.reps, tag) and ok
    if not args.skip_k10:
        ok = k10(torch, args.reps, tag, args.variants,
                 args.k12_variants) and ok
    print(f"probe {'ok' if ok else 'FAILED'} {tag}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
