#!/usr/bin/env python3
"""Count the float64 instructions CUDA's math library spends per call.

The kernels' bounds (``chip_smoke.py``'s ``SASS_OPS``, ``K7_OPS``,
``_k6_ops``) count a library function -- ``cos``, ``sin``, ``sincos``,
``atan``, ``atan2``, ``log``, ``exp``, ``pow``, ``sqrt``, ``hypot`` and
a division -- by the instructions the compiler emits for it.  This tool
builds one tiny kernel per function with the kernels' own nvcc flags
(``pint_torch/kernels/_build.py`` ``NVCC_FLAGS``, ``-fmad=false``), each
loading its arguments, calling the function once and storing its results,
dumps the SASS with ``cuobjdump -sass`` and counts, in program order from
the kernel's entry to its first unpredicated ``EXIT``:

* ``fp64``: the instructions of the float64 pipe (``DADD``, ``DMUL``,
  ``DFMA``, ``DSETP``, ``DMNMX`` and the conversions to or from F64), the
  count the bounds divide by the float64 instruction rate;
* ``mufu``: the special-function unit's (``MUFU.RCP64H``, ``MUFU.RSQ64H``);
* ``total``: every instruction, less those of a kernel that only loads and
  stores the same arguments.

The slow paths (a huge argument's Payne-Hanek reduction, a subnormal
input, a division's exceptional cases) are calls or branches to code laid
out after the first ``EXIT`` and are not counted; an instruction before
that ``EXIT`` that the fast path branches over or predicates off is, so
the count is the fast path's or a little more.  A call that no predicated
branch skips (``pow`` keeps its core out of line) is followed to its
``RET`` and counted.  For K6's, K7's and K8's built libraries it prints
each loop's count a pass (K7's node loop, K8's Gaussian peak loop).  The SASS is written under
``--out`` (default ``pint_torch/_build/sass/``) for reading.

Run on a machine with the CUDA toolkit, from the repository root::

    python3 tools/torch_sass_ops.py [--out DIR]

It prints one JSON object, the counts by function, as its last line.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

#: function -> (arguments in, results out, the expression); the result
#: ``r`` (two results: ``r``, ``r2``) is stored
FUNCTIONS = {
    "base11": (1, 1, "r = a;"),
    "base21": (2, 1, "r = __longlong_as_double(__double_as_longlong(a) "
                     "^ __double_as_longlong(b));"),
    "base12": (1, 2, "r = a; r2 = a;"),
    "cos": (1, 1, "r = cos(a);"),
    "sin": (1, 1, "r = sin(a);"),
    "sincos": (1, 2, "sincos(a, &r, &r2);"),
    "atan": (1, 1, "r = atan(a);"),
    "atan2": (2, 1, "r = atan2(a, b);"),
    "log": (1, 1, "r = log(a);"),
    "exp": (1, 1, "r = exp(a);"),
    "pow": (2, 1, "r = pow(a, b);"),
    "sqrt": (1, 1, "r = sqrt(a);"),
    "hypot": (2, 1, "r = hypot(a, b);"),
    "div": (2, 1, "r = a / b;"),
}
BASE = {1: {1: "base11", 2: "base12"}, 2: {1: "base21"}}

_FP64 = re.compile(r"^(DADD|DMUL|DFMA|DSETP|DMNMX|DSET)\b")
_CVT = re.compile(r"^(F2F|I2F|F2I)\b.*F64")


def source() -> str:
    out = ["#include <math.h>\n"]
    for name, (nin, nout, expr) in FUNCTIONS.items():
        out.append(
            f'extern "C" __global__ void k_{name}(const double* __restrict__ '
            f"x, double* __restrict__ y, int n) {{\n"
            "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "  const double a = x[i];\n"
            + ("  const double b = x[n + i];\n" if nin == 2 else "")
            + "  double r, r2 = 0.0;\n"
            f"  {expr}\n"
            "  y[i] = r;\n"
            + ("  y[n + i] = r2;\n" if nout == 2 else "")
            + "}\n")
    return "\n".join(out)


def functions(sass: str) -> dict:
    """SASS by function name, from cuobjdump's text: (address,
    instruction) pairs in program order."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _bare(ins: str) -> str:
    """The instruction without its predicate."""
    return re.sub(r"^@!?U?P[T0-9]+\s+", "", ins)


def _target(ins: str) -> int:
    return int(re.search(r"0x([0-9a-f]+)\s*$", ins).group(1), 16)


def _conditional_call(code, i) -> bool:
    """True when the nearest branch before the call at ``code[i]`` (within
    eight instructions) is a predicated one that jumps past it: a slow
    path that the fast path skips."""
    for j in range(i - 1, max(i - 9, -1), -1):
        ins = code[j][1]
        if "BRA" in _bare(ins).split()[0]:
            return ins.startswith("@") and _target(ins) > code[i][0]
    return False


def count(code, start: int = 0, stop: str = "EXIT", end=None) -> dict:
    """fp64, mufu and total instructions in program order from address
    ``start`` to the first unpredicated ``stop`` (``EXIT``; ``RET`` in a
    subroutine) or to address ``end``, adding the body of every call that
    no predicated branch skips (a function the compiler keeps out of
    line, as ``pow``'s core)."""
    at = {a: i for i, (a, _) in enumerate(code)}
    c = {"fp64": 0, "mufu": 0, "total": 0}
    for i in range(at[start], len(code)):
        a, ins = code[i]
        bare = _bare(ins)
        op = bare.split()[0]
        if (end is None and ins.split()[0].startswith(stop)) or \
                (end is not None and a > end):
            break
        c["total"] += 1
        c["fp64"] += bool(_FP64.match(bare) or _CVT.match(bare))
        c["mufu"] += op.startswith("MUFU") and "64" in op
        if op.startswith("CALL.REL") and not _conditional_call(code, i):
            for k, v in count(code, _target(bare), "RET").items():
                c[k] += v
    return c


def loops(code) -> list:
    """(first, last) addresses of each loop: a branch back to an earlier
    address."""
    return [(_target(ins), a) for a, ins in code
            if _bare(ins).split()[0] == "BRA" and _target(ins) < a]


def main() -> int:
    sys.path.insert(0, str(REPO))
    from pint_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "sass"),
                    help="directory for the SASS listings")
    out_dir = Path(ap.parse_args().out)
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    out_dir.mkdir(parents=True, exist_ok=True)
    work = _build.BUILD_DIR / "sass"
    work.mkdir(parents=True, exist_ok=True)
    cu = work / "sass_ops.cu"
    cu.write_text(source())
    lib = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True, text=True)
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    (out_dir / "sass_ops.sass").write_text(sass)
    per = {name.removeprefix("k_"): count(code)
           for name, code in functions(sass).items()}
    result = {}
    for name, (nin, nout, _) in FUNCTIONS.items():
        if name.startswith("base"):
            continue
        c = dict(per[name])
        c["total"] -= per[BASE[nin][nout]]["total"]
        result[name] = c
        print(f"{name}: {c['fp64']} fp64, {c['mufu']} mufu, {c['total']} "
              "instructions in all", flush=True)
    # K6's, K7's and K8's libraries: each loop's instructions a pass (K7's
    # node loop: its cosine or sincos, logarithm, exponential and
    # arithmetic; K8's peak loop: 13 images, each an exponential)
    from pint_torch import kernels

    kernels.build_all()
    for name in ("solar_wind_pl", "binary_orbits", "photon_lnlike"):
        path = _build.library_path(name)
        text = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                              capture_output=True, text=True).stdout
        (out_dir / f"{name}.sass").write_text(text)
        for fn, code in functions(text).items():
            for first, last in loops(code):
                c = count(code, first, end=last)
                print(f"library {name} {fn}: loop {first:#x}-{last:#x}: "
                      f"{c['fp64']} fp64, {c['mufu']} mufu, {c['total']} "
                      "instructions a pass", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
