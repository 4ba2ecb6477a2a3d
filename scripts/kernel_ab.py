#!/usr/bin/env python3
"""A/B of the block-tridiagonal factor and the stage-Hessian solve kernels
against another commit's, on one NVIDIA GPU.

    python3 scripts/kernel_ab.py --parent DIR [--captures PATH]

DIR holds the other commit's ``successiveconvexification_tpu_torch/csrc``
(kkt.cu and its headers), for example unpacked from ``git archive`` under
``build/``. The script builds DIR/kkt.cu with the port's nvcc flags into a
library of its own under ``build/`` and loads it with ctypes beside the
port's own ``csrc/kkt.cu``. For ``tridiag_factor`` and ``cho_solve_vec`` it
runs both builds on the same inputs:

  - synthetic, made from a seeded ``torch.Generator``: the models' widths
    (tridiag_factor (256, 49, 13), the penalized path's; cho_solve_vec
    12,800 x 17, 7,680 x 11 and 50 x 17, every path's) and one generic
    width (n = 20), in float32 and float64;
  - captured, float32, from ``python3 chip_smoke.py --save-captures PATH``
    (the penalized path's tridiag_factor calls, every path's cho_solve_vec
    calls).

For each call it prints whether the outputs are equal bit for bit (NaN
where NaN), and the two kernels' device times in the order other, this,
this, other (chip_smoke's ``_time_ms``: CUDA events around 20 launches)
beside the call's bound (chip_smoke's ``_work``). Then ptxas's registers,
spills and stack for this build's instantiations of the two kernels, and
the dynamic shared memory a CTA their launchers ask for at these shapes.
Exits 1 if an output differs anywhere but in a lane where this build's
factor holds an infinite diagonal entry (the other commit may treat an
infinite pivot as a breakdown).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KERNELS = ("tridiag_factor", "cho_solve_vec")


def build_other(csrc: Path):
    """DIR/kkt.cu built into build/, loaded with ctypes."""
    from successiveconvexification_tpu_torch.ops import _build

    h = hashlib.sha256((csrc / "kkt.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    out = _build.BUILD / f"ab_other_kkt-{h.hexdigest()[:12]}.so"
    if not out.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        log = _build.BUILD / "ab_other_kkt.log"
        with open(log, "w") as f:
            rc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                 str(out), str(csrc / "kkt.cu")],
                                stdout=f, stderr=subprocess.STDOUT).returncode
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {csrc / 'kkt.cu'}:\n"
                               f"{log.read_text()}")
    return ctypes.CDLL(str(out))


def other_wrappers(lib):
    """The other build's kernels, called as ops/cuda_kkt.py calls them."""
    import torch

    from successiveconvexification_tpu_torch.ops import _build

    def tridiag_factor(D, O):
        sfx = _build.suffix("tridiag_factor", D, O)
        D, O = D.contiguous(), O.contiguous()
        B, N, n, _ = D.shape
        L, C = torch.empty_like(D), torch.empty_like(D)
        err = _build.declare(lib, f"scvx_tridiag_factor_{sfx}", 4, 3)(
            D.data_ptr(), O.data_ptr(), L.data_ptr(), C.data_ptr(), B, N, n,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "other tridiag_factor")
        return L, C

    def cho_solve_vec(L, b):
        sfx = _build.suffix("cho_solve_vec", L, b)
        L, b = L.contiguous(), b.contiguous()
        n = L.shape[-1]
        x = torch.empty_like(b)
        err = _build.declare(lib, f"scvx_cho_solve_vec_{sfx}", 3, 2)(
            L.data_ptr(), b.data_ptr(), x.data_ptr(), b.numel() // n, n,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "other cho_solve_vec")
        return x

    return {"tridiag_factor": tridiag_factor, "cho_solve_vec": cho_solve_vec}


def synthetic():
    """(kernel, label, args) at the paths' shapes and n = 20, f32 and f64."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(7)
    f64 = torch.float64
    calls = []

    def spd(count, n):
        R = torch.randn(count, n, n, generator=g, dtype=f64)
        return R @ R.transpose(-1, -2) + n * torch.eye(n, dtype=f64)

    for B, N, n in ((256, 49, 13), (64, 49, 20)):
        D = spd(B * N, n).reshape(B, N, n, n) + 4.0 * n * torch.eye(n, dtype=f64)
        O = 0.5 * torch.randn(B, N - 1, n, n, generator=g, dtype=f64)
        calls.append(("tridiag_factor", f"synthetic ({B}, {N}, {n})", (D, O)))
    for N, n in ((12800, 17), (7680, 11), (50, 17), (4096, 20)):
        # contiguous, as the paths' factors are (cholesky's output is not,
        # and a wrapper's .contiguous() would time a copy with the kernel)
        L = torch.linalg.cholesky(spd(N, n)).contiguous()
        b = torch.randn(N, n, generator=g, dtype=f64)
        calls.append(("cho_solve_vec", f"synthetic {N} x {n}", (L, b)))
    out = []
    for name, label, args in calls:
        for dt in (torch.float32, f64):
            out.append((name, f"{label} {str(dt)[6:]}",
                        tuple(a.to(dt).cuda() for a in args)))
    return out


def captured(path: str):
    import torch

    saved = torch.load(path, map_location="cuda")
    return [(name, f"captured: {label}", tuple(args))
            for name in KERNELS for label, args in saved[name]]


def _equal(a, b):
    import torch

    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def compare(name, args, this, other):
    """(equal everywhere, lanes that differ, of those the ones where this
    build's factor holds an infinite entry)."""
    import torch

    outs = [cs._tuple(f(*args)) for f in (this, other)]
    torch.cuda.synchronize()
    diff = torch.zeros(args[0].shape[0], dtype=torch.bool, device="cuda")
    has_inf = torch.zeros_like(diff)
    for a, b in zip(*outs):
        diff |= ~_equal(a, b).reshape(a.shape[0], -1).all(1)
        has_inf |= torch.isinf(a).reshape(a.shape[0], -1).any(1)
    return (not bool(diff.any()), int(diff.sum()),
            int((diff & has_inf).sum()))


def ptxas_lines(log: Path) -> list[str]:
    """ptxas -v's lines for the two kernels' entry functions, demangled."""
    if not log.exists():
        return [f"{log}: no build log (the library was built before)"]
    filt = shutil.which("c++filt")
    out, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(_Z\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and any(k + "_kernel" in cur for k in KERNELS) and (
                "registers" in line or "spill" in line):
            nm = cur
            if filt:
                nm = subprocess.run([filt, cur], capture_output=True,
                                    text=True).stdout.strip()
            nm = re.sub(r"\(anonymous namespace\)::", "", nm).split("(")[0]
            out.append(f"{nm}: {line.split(':', 1)[-1].strip()}")
    return out


def dynamic_smem(name, args) -> int:
    """The launchers' dynamic shared memory a CTA (csrc/kkt.cu)."""
    esize = args[0].element_size()
    a16 = lambda b: (b + 15) // 16 * 16  # noqa: E731
    two_per_sm = 112 * 1024
    n = args[0].shape[-1]
    if name == "tridiag_factor":
        nn = n * n
        for ch in (4, 3, 2, 1):
            smem = a16(3 * 8) + a16(2 * nn * esize) + 3 * ch * 2 * nn * esize
            if smem <= two_per_sm:
                break
        return smem
    for nbw in range(32, 0, -1):
        smem = a16(nbw * (n * n | 1) * esize) + nbw * (n | 1) * esize
        if smem <= two_per_sm:
            break
    return smem


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the other commit's csrc/ files")
    ap.add_argument("--captures", help="chip_smoke.py --save-captures output")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from successiveconvexification_tpu_torch.ops import _build, cuda_kkt, precision

    precision.full_precision()
    card = cs._card_line()
    print(card)
    _build.library("kkt")
    this = {k: getattr(cuda_kkt, k) for k in KERNELS}
    other = other_wrappers(build_other(Path(opts.parent)))
    calls = synthetic() + (captured(opts.captures) if opts.captures else [])
    bad = []
    for name, label, args in calls:
        same, n_diff, n_inf = compare(name, args, this[name], other[name])
        times = [cs._time_ms(lambda f=f: f(*args))
                 for f in (other[name], this[name], this[name], other[name])]
        nbytes, flops = cs._work(name, args, args[0].element_size())
        peak = cs.PEAK_FLOPS["float64" if args[0].element_size() == 8
                             else "float32"]
        bound = max(nbytes / cs.PEAK_BYTES_PER_S, flops / peak) * 1e3
        print(f"{name} {label} {[tuple(a.shape) for a in args]}: bit for bit "
              f"{'yes' if same else f'NO in {n_diff} lanes ({n_inf} with an infinite entry here)'}; "
              f"other/this/this/other "
              f"{'/'.join(f'{t:.4f}' for t in times)} ms, bound "
              f"{bound:.5f} ms; dynamic shared memory "
              f"{dynamic_smem(name, args)} B a CTA; {card}")
        if n_diff > n_inf:
            bad.append(f"{name} {label}")
    for line in ptxas_lines(_build.BUILD / "kkt.log"):
        print(f"ptxas (this build) {line}")
    if bad:
        print(f"kernel_ab: outputs differ: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
