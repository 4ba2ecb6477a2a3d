#!/usr/bin/env python3
"""Where discretize_lanes' time goes, phase by phase, on one NVIDIA GPU.

    python3 scripts/disc_stamps.py [--parent DIR] [--captures PATH]

Builds a copy of the port's ``csrc/disc.cu`` (and, with ``--parent``, of
the other commit's ``DIR/disc.cu``) under ``build/stamps/`` with clock64()
stamps at the phase boundaries of each RK4 stage and loads it with ctypes:
A (the dual-number evaluations of the dynamics), B (w = sA x + sB u), C
(the owned derivatives: sA Phi, P sA and the P rows' extras) and U (the RK4
update, and the next stage's u), each summed over the stages of a lane by
the lane's thread 0, then F (Phi Bm, Phi Bp, Phi S, Phi z and the stores)
and the lane's whole time, written to a ``__device__`` array read back with
``cudaMemcpyFromSymbol``. A warp-wide sync before each stamp makes every
boundary one the whole warp has passed (the C/U boundary in the first
design is inside its branch for the 2 nx threads that own a column or a
row, and syncs those).

Inputs: the float32 synthetic calls of ``scripts/kernel_ab.py`` (the main
path's (256, 50) initial guess, and a perturbed one, and the point mass's
(256, 30)), and with ``--captures`` every discretize call saved by
``python3 chip_smoke.py --save-captures PATH``. For each call and build it
prints the device ms of the unstamped kernel and of the stamped copy
(chip_smoke's ``_time_ms``), and the mean (max) cycles a stage of each
phase over the lanes, the final phase's and the whole lane's cycles.
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
MAX_LANES = 16384
PHASES = ("A", "B", "C", "U", "F", "lane")

STAMP_DEFS = f"""
__device__ unsigned long long g_stamps[{MAX_LANES}][{len(PHASES)}];
#define STAMP_MARK(slot, mask)                                              \\
  do {{                                                                     \\
    __syncwarp(mask);                                                       \\
    const long long _c = clock64();                                         \\
    st_acc[slot] += _c - st_prev;                                           \\
    st_prev = _c;                                                           \\
  }} while (0)
"""

STAMP_API = f"""
extern "C" int scvx_stamps_read(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}}
"""

FULL = "0xffffffffu"
# the first design's C/U boundary lies inside `if (col || row)`: its 2 nx
# threads sync there
OWNERS = "((2 * NX) >= 32 ? 0xffffffffu : ((1u << (2 * NX)) - 1u))"


def _sub(text: str, old: str, new: str) -> str:
    """Replace the one occurrence of ``old``; it must be there once."""
    if text.count(old) != 1:
        raise RuntimeError(f"anchor not found once in disc.cu: {old[:60]!r}")
    return text.replace(old, new)


def stamped_source(text: str) -> str:
    """disc.cu with the stamps (either design: the anchors are the phase
    comments and statements both keep)."""
    head = "#include <cuda_runtime.h>\n"
    text = _sub(text, head, head + STAMP_DEFS)
    first = "if (col || row) {\n        T kv[NX], ke[NE];" in text
    text = _sub(text, "  const int b = lane / Lk, k = lane - b * Lk;\n",
                "  const int b = lane / Lk, k = lane - b * Lk;\n"
                "  const long long st_k0 = clock64();\n"
                "  long long st_prev = st_k0;\n"
                "  long long st_acc[6] = {0, 0, 0, 0, 0, 0};\n")
    text = _sub(text, "  for (int it = 0; it < substeps; ++it) {\n",
                "  st_prev = clock64();\n"
                "  for (int it = 0; it < substeps; ++it) {\n")
    text = _sub(text, "      // A. column t",
                f"      STAMP_MARK(3, {FULL});\n      // A. column t")
    text = _sub(text, "      // B. w = sA x + sB u",
                f"      STAMP_MARK(0, {FULL});\n      // B. w = sA x + sB u")
    text = _sub(text, "      // C. the owned derivatives",
                f"      STAMP_MARK(1, {FULL});\n      // C. the owned derivatives")
    text = _sub(text, "        // acc = ((k1 + 2 k2) + 2 k3) + k4;",
                f"        STAMP_MARK(2, {OWNERS if first else FULL});\n"
                "        // acc = ((k1 + 2 k2) + 2 k3) + k4;")
    text = _sub(text, "  // Phi@Bm, Phi@Bp, Phi@S, Phi@z",
                f"  STAMP_MARK(3, {FULL});\n  // Phi@Bm, Phi@Bp, Phi@S, Phi@z")
    end = "    o1[lo * NX + r] = a;\n  }\n}\n"
    text = _sub(text, end,
                "    o1[lo * NX + r] = a;\n  }\n"
                f"  STAMP_MARK(4, {FULL});\n"
                f"  if (t == 0 && lane < {MAX_LANES}) {{\n"
                "    for (int i = 0; i < 5; ++i) g_stamps[lane][i] = st_acc[i];\n"
                "    g_stamps[lane][5] = clock64() - st_k0;\n"
                "  }\n}\n")
    return text + STAMP_API


def build(tag: str, csrc: Path):
    """The stamped copy of csrc/disc.cu (with csrc's headers) under
    build/stamps/<tag>/, built and loaded."""
    d = ROOT / "build" / "stamps" / tag
    d.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    (d / "disc.cu").write_text(stamped_source((csrc / "disc.cu").read_text()))
    lib = kernel_ab.build_other(d, "disc", tag=f"stamps_{tag}")
    read = lib.scvx_stamps_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory holding the other commit's "
                    "csrc/ files (stamped too, as the first design)")
    ap.add_argument("--captures", help="chip_smoke.py --save-captures output")
    opts = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("disc_stamps: no CUDA device", file=sys.stderr)
        return 2
    from successiveconvexification_tpu_torch.ops import (_build, cuda_disc,
                                                         precision)

    precision.full_precision()
    card = cs._card_line()
    print(card)
    _build.library("disc")
    builds = [("this", CSRC)]
    if opts.parent:
        builds.append(("other", Path(opts.parent)))
    libs = {tag: build(tag, csrc) for tag, csrc in builds}
    calls = [(label, args) for name, label, args in kernel_ab.synthetic()
             if name == "discretize_lanes" and args[2].dtype == torch.float32]
    if opts.captures:
        calls += [(label, args) for _, label, args in kernel_ab.captured(
            opts.captures, ("discretize_lanes",))]
    for label, args in calls:
        model, X, substeps = args[0], args[2], args[5]
        n_lanes = X.numel() // (X.shape[-2] * X.shape[-1]) * (X.shape[-2] - 1)
        stages = 4 * substeps
        t_port = cs._time_ms(lambda: cuda_disc.discretize_lanes(*args))
        for tag, lib in libs.items():
            run = kernel_ab.disc_entry(lib)
            t_stamped = cs._time_ms(lambda: run(*args))
            torch.cuda.synchronize()
            run(*args)
            torch.cuda.synchronize()
            buf = np.zeros((MAX_LANES, len(PHASES)), dtype=np.uint64)
            if lib.scvx_stamps_read(buf.ctypes.data) != 0:
                raise RuntimeError("scvx_stamps_read failed")
            cyc = buf[:min(n_lanes, MAX_LANES)].astype(np.float64)
            per_stage = ", ".join(
                f"{p} {cyc[:, i].mean() / stages:.0f} "
                f"({cyc[:, i].max() / stages:.0f})"
                for i, p in enumerate(PHASES[:4]))
            print(f"discretize_lanes {label} {model.name} {tuple(X.shape)} "
                  f"{stages} stages, {tag} build stamped: {t_stamped:.4f} ms "
                  f"(the port's kernel unstamped {t_port:.4f} ms); cycles a "
                  f"stage, mean (max) over {cyc.shape[0]} lanes: {per_stage}; "
                  f"final {cyc[:, 4].mean():.0f}, lane {cyc[:, 5].mean():.0f} "
                  f"({cyc[:, 5].max():.0f}); {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
