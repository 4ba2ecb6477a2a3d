#!/usr/bin/env python3
"""Where tridiag_factor's time goes, step by step, on one NVIDIA GPU.

    python3 scripts/kernel_stamps.py [--captures PATH]

Builds two copies of the port's ``csrc/kkt.cu`` (with its headers) under
``build/stamps/`` and loads each with ctypes:

  - "stamped": clock64() stamps around each phase of ``warp_tri_step``
    (the coupling solve C_k, the Schur update S_k, the Cholesky L_k, the
    stores) and of the kernel's loop (the wait for a chunk, the issue of the
    next one), summed per CTA (one CTA a lane) into a ``__device__`` array;
  - "fast": the step's divisions by ``__fdividef`` and its square roots by
    ``sqrt.approx.f32`` (float32 only; its results differ: a timing probe,
    to show what the IEEE division's and square root's checked slow paths
    cost on a given input).

Inputs: a synthetic (256, 49, 13) float32 call, and with ``--captures`` the
penalized path's tridiag_factor calls saved by ``python3 chip_smoke.py
--save-captures PATH``. For each call it prints the device ms of the port's
kernel, of the stamped copy and of the fast one (chip_smoke's
``_time_ms``), the mean cycles a step of each phase over the lanes, and
the share of the inputs D (lower triangle) and O and of the outputs C and
L (lower triangle) that are zero or subnormal.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402

CSRC = ROOT / "successiveconvexification_tpu_torch" / "csrc"
MAX_CTAS = 4096
SLOTS = 8
PHASES = ("C", "S", "chol", "store", "wait", "issue", "kernel")

STAMP_DEFS = f"""
__device__ unsigned long long g_stamps[{MAX_CTAS}][{SLOTS}];
#define STAMP_T(v) long long v = clock64()
#define STAMP_ADD(p, t)                                                     \\
  do {{                                                                     \\
    if (threadIdx.x == 0 && blockIdx.x < {MAX_CTAS})                         \\
      atomicAdd(&g_stamps[blockIdx.x][p],                                  \\
                (unsigned long long)(clock64() - (t)));                     \\
  }} while (0)
"""

STAMP_API = f"""
extern "C" int scvx_stamps_read(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}}
extern "C" int scvx_stamps_clear() {{
  static unsigned long long zero[{MAX_CTAS}][{SLOTS}];
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
}}
"""

FAST_DEFS = """
__device__ __forceinline__ float step_div(float a, float b) {
  return __fdividef(a, b);
}
__device__ __forceinline__ double step_div(double a, double b) { return a / b; }
__device__ __forceinline__ float step_sqrt(float a) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ double step_sqrt(double a) { return sqrt(a); }
"""


def _sub(text: str, old: str, new: str, start: int = 0) -> str:
    """Replace the first ``old`` at or after ``start``; it must be there."""
    i = text.find(old, start)
    if i < 0:
        raise RuntimeError(f"anchor not found in the source: {old[:60]!r}")
    return text[:i] + new + text[i + len(old):]


def _header_end(text: str) -> int:
    return text.index("#include <cuda_runtime.h>\n") + len(
        "#include <cuda_runtime.h>\n")


def stamped_sources() -> dict:
    bt = (CSRC / "blocktri.cuh").read_text()
    bt = bt[:_header_end(bt)] + STAMP_DEFS + bt[_header_end(bt):]
    k = bt.index("__device__ __forceinline__ bool warp_tri_step(")
    bt = _sub(bt, "  __syncwarp();\n  T cc[NMAX];",
              "  __syncwarp();\n  STAMP_T(st0);\n  T cc[NMAX];", k)
    bt = _sub(bt, "  __syncwarp();\n  T srow[NMAX];",
              "  __syncwarp();\n  STAMP_ADD(0, st0);\n  STAMP_T(st1);\n"
              "  T srow[NMAX];", k)
    bt = _sub(bt, "  const bool bad = warp_chol_rows<T, NMAX>(srow, n, li);",
              "  STAMP_ADD(1, st1);\n  STAMP_T(st2);\n"
              "  const bool bad = warp_chol_rows<T, NMAX>(srow, n, li);\n"
              "  STAMP_ADD(2, st2);\n  STAMP_T(st3);", k)
    bt = _sub(bt, "  __syncwarp();\n  return bad;\n}",
              "  __syncwarp();\n  STAMP_ADD(3, st3);\n  return bad;\n}", k)
    kk = (CSRC / "kkt.cu").read_text()
    k = kk.index("    tridiag_factor_kernel(const T* __restrict__ D")
    kk = _sub(kk, "  if (EXACT) n = NMAX;\n",
              "  if (EXACT) n = NMAX;\n  STAMP_T(sk);\n", k)
    kk = _sub(kk, "    mbar_wait(&bar[c % nslots], (c / nslots) & 1);\n"
              "    __syncwarp();  // every lane is done with the slot issue(c + 2) refills\n"
              "    issue(c + 2);\n",
              "    STAMP_T(sw);\n"
              "    mbar_wait(&bar[c % nslots], (c / nslots) & 1);\n"
              "    __syncwarp();\n    STAMP_ADD(4, sw);\n    STAMP_T(si);\n"
              "    issue(c + 2);\n    STAMP_ADD(5, si);\n", k)
    kk = _sub(kk, "                             Lb + k * nn);\n    }\n  }\n}",
              "                             Lb + k * nn);\n    }\n  }\n"
              "  STAMP_ADD(6, sk);\n}", k)
    return {"blocktri.cuh": bt, "kkt.cu": kk + STAMP_API}


def fast_sources() -> dict:
    bt = (CSRC / "blocktri.cuh").read_text()
    bt = bt[:_header_end(bt)] + FAST_DEFS + bt[_header_end(bt):]
    k = bt.index("__device__ __forceinline__ bool warp_chol_rows(")
    bt = _sub(bt, "      const T d = sqrt(piv);\n      const T q = row[j] / d;",
              "      const T d = step_sqrt(piv);\n"
              "      const T q = step_div(row[j], d);", k)
    k = bt.index("__device__ __forceinline__ bool warp_tri_step(")
    bt = _sub(bt, "        cc[a] = s / Lp[a * n + a];",
              "        cc[a] = step_div(s, Lp[a * n + a]);", k)
    return {"blocktri.cuh": bt, "kkt.cu": (CSRC / "kkt.cu").read_text()}


def write_copy(name: str, sources: dict) -> Path:
    d = ROOT / "build" / "stamps" / name
    d.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    for fname, text in sources.items():
        (d / fname).write_text(text)
    return d


def tiny_share(x, lower: bool) -> tuple[float, float]:
    """Shares of the (lower-triangle) entries that are 0 and subnormal."""
    import torch

    if lower:
        x = x[..., torch.tril_indices(x.shape[-1], x.shape[-1])[0],
              torch.tril_indices(x.shape[-1], x.shape[-1])[1]]
    x = x[torch.isfinite(x)].abs()
    if x.numel() == 0:
        return 0.0, 0.0
    tiny = torch.finfo(x.dtype).tiny
    return (float((x == 0).float().mean()),
            float(((x > 0) & (x < tiny)).float().mean()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--captures", help="chip_smoke.py --save-captures output")
    opts = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_stamps: no CUDA device", file=sys.stderr)
        return 2
    from successiveconvexification_tpu_torch.ops import cuda_kkt, precision

    precision.full_precision()
    card = cs._card_line()
    print(card)
    stamped = kernel_ab.build_other(write_copy("stamped", stamped_sources()),
                                    tag="stamps_stamped")
    fast = kernel_ab.build_other(write_copy("fast", fast_sources()),
                                 tag="stamps_fast")
    run_stamped = kernel_ab.other_wrappers({"kkt": stamped})["tridiag_factor"]
    run_fast = kernel_ab.other_wrappers({"kkt": fast})["tridiag_factor"]
    read, clear = stamped.scvx_stamps_read, stamped.scvx_stamps_clear
    read.argtypes, clear.argtypes = [ctypes.c_void_p], []
    read.restype = clear.restype = ctypes.c_int

    calls = [(label, args) for name, label, args in kernel_ab.synthetic()
             if name == "tridiag_factor" and "13)" in label
             and args[0].dtype == torch.float32]
    if opts.captures:
        calls += [(label, args) for name, label, args
                  in kernel_ab.captured(opts.captures, ("tridiag_factor",))]
    for label, (D, O) in calls:
        B, N = D.shape[:2]
        t_port = cs._time_ms(lambda: cuda_kkt.tridiag_factor(D, O))
        t_stamped = cs._time_ms(lambda: run_stamped(D, O))
        t_fast = cs._time_ms(lambda: run_fast(D, O))
        torch.cuda.synchronize()
        if clear() != 0:
            raise RuntimeError("scvx_stamps_clear failed")
        run_stamped(D, O)
        torch.cuda.synchronize()
        buf = np.zeros((MAX_CTAS, SLOTS), dtype=np.uint64)
        if read(buf.ctypes.data) != 0:
            raise RuntimeError("scvx_stamps_read failed")
        per_step = buf[:B, :len(PHASES)].astype(np.float64) / N
        L, C = cuda_kkt.tridiag_factor(D, O)
        shares = {nm: tiny_share(x, low) for nm, x, low in (
            ("D", D, True), ("O", O, False), ("C", C[:, 1:], False),
            ("L", L, True))}
        print(f"tridiag_factor {label} {tuple(D.shape)}: port {t_port:.4f} ms, "
              f"stamped {t_stamped:.4f} ms, fast division and sqrt "
              f"{t_fast:.4f} ms; cycles a step, mean (max) over the "
              f"{B} lanes: " + ", ".join(
                  f"{p} {per_step[:, i].mean():.0f} ({per_step[:, i].max():.0f})"
                  for i, p in enumerate(PHASES))
              + "; zero / subnormal shares: " + ", ".join(
                  f"{nm} {z:.3f} / {s:.2e}" for nm, (z, s) in shares.items())
              + f"; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
