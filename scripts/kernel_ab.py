#!/usr/bin/env python3
"""A/B of the KKT and discretize kernels against another commit's, on one
NVIDIA GPU.

    python3 scripts/kernel_ab.py --parent DIR [--captures PATH]
        [--kernels NAME,...]

DIR holds the other commit's ``successiveconvexification_tpu_torch/csrc``
(kkt.cu, disc.cu and their headers), for example unpacked from ``git
archive`` under ``build/``. The script builds DIR/kkt.cu and DIR/disc.cu
with the port's nvcc flags into libraries of their own under ``build/`` and
loads them with ctypes beside the port's own. For ``tridiag_factor``,
``cho_solve_vec``, ``cho_solve``, ``discretize_lanes``, ``chol`` and
``fused_chol_solve`` (or the ones ``--kernels`` names) it runs both builds
on the same inputs:

  - synthetic, made from a seeded ``torch.Generator``: the models' widths
    (tridiag_factor (256, 49, 13), the penalized path's; cho_solve_vec
    12,800 x 17, 7,680 x 11 and 50 x 17, every path's; cho_solve (49, 17,
    13) and (12,544, 17, 13), B row-major and as the transpose of E-like
    blocks with a quarter exact zeros, L read with the penalized path's
    lane stride; discretize_lanes at the main path's (256, 50) and the
    point mass's (256, 30), and once with drag and one NaN node; chol
    (50, 17) and (12,800, 17), the replan and penalized paths'; and
    fused_chol_solve (300, 13, 2), its vehicle's, and (12,800, 17, 13))
    and one generic width (tridiag_factor and cho_solve_vec n = 20,
    cho_solve and fused_chol_solve (64, 20, 7), chol (64, 20)), in float32
    and float64. The chol and fused_chol_solve blocks have a quarter of
    their lower triangle exact zeros, one an infinite pivot and one a
    negative pivot; each kernel also runs at a ragged N, one that is not a
    multiple of the blocks a warp or a CTA takes (chol (9,001, 20),
    fused_chol_solve (4,099, 17, 13) and (4,099, 20, 7));
  - captured, float32, from ``python3 chip_smoke.py --save-captures PATH``
    (the penalized path's tridiag_factor calls, every path's cho_solve_vec
    calls, the penalized and replan paths' chol calls and cho_solve calls
    as the IPM makes them, and every path's discretize calls).

The other build's kernels are called as that commit's wrappers called them
(cho_solve with L and B read in place, given as layout arguments). For
each call it prints whether the outputs are equal bit for bit (NaN where
NaN), and the two
kernels' device times in the order other, this, this, other (chip_smoke's
``_time_ms``: CUDA events around 20 launches) beside the call's bound
(chip_smoke's ``_work``). Then ptxas's registers, spills and stack for both
builds' instantiations of these kernels, and the dynamic shared memory a
CTA and the resident warps an SM each build's launchers give at the
paths' shapes (chol and fused_chol_solve: the most a CTA takes; their
launchers size the grid by occupancy). Exits 1 if an output differs
anywhere but in a lane where this build's factor holds an infinite
diagonal entry (the other commit may treat an infinite pivot as a
breakdown).
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

KERNELS = ("tridiag_factor", "cho_solve_vec", "cho_solve", "discretize_lanes",
           "chol", "fused_chol_solve")
SOURCE = {"tridiag_factor": "kkt", "cho_solve_vec": "kkt", "cho_solve": "kkt",
          "discretize_lanes": "disc", "chol": "kkt", "fused_chol_solve": "kkt"}
DEVICE_FN = {"tridiag_factor": "tridiag_factor_kernel",
             "cho_solve_vec": "cho_solve_vec_kernel",
             "cho_solve": "cho_solve_kernel",
             "discretize_lanes": "discretize_kernel",
             "chol": "chol_kernel",
             "fused_chol_solve": "fused_chol_solve_kernel"}


def build_other(csrc: Path, name: str = "kkt", tag: str = "ab_other"):
    """DIR/<name>.cu built into build/ (the log beside it), loaded with
    ctypes."""
    from successiveconvexification_tpu_torch.ops import _build

    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    out = _build.BUILD / f"{tag}_{name}-{h.hexdigest()[:12]}.so"
    if not out.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        log = _build.BUILD / f"{tag}_{name}.log"
        with open(log, "w") as f:
            rc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                 str(out), str(csrc / f"{name}.cu")],
                                stdout=f, stderr=subprocess.STDOUT).returncode
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {csrc / (name + '.cu')}:\n"
                               f"{log.read_text()}")
    return ctypes.CDLL(str(out))


def build_others(csrc: Path, names, tag: str = "ab_other") -> dict:
    """build_other for each source in ``names``, the nvcc runs in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(names)) as pool:
        libs = pool.map(lambda nm: build_other(csrc, nm, tag), names)
    return dict(zip(names, libs))


def disc_entry(lib):
    """discretize_lanes on ``lib``'s entry points, called as
    ops/cuda_disc.py calls them (packed params, contiguous inputs)."""
    import torch

    from successiveconvexification_tpu_torch.ops import _build

    def discretize_lanes(model, params, X, U, sigma, substeps, foh=True):
        dyn = model.cuda_dynamics.name
        pk = model.cuda_dynamics.pack(params)
        sfx = _build.suffix("discretize_lanes", X, U, sigma, pk)
        K, nx, nu = X.shape[-2], X.shape[-1], U.shape[-1]
        lead = X.shape[:-2]
        X, U = X.contiguous(), U.contiguous()
        sg = sigma.expand(lead).contiguous()
        pk = pk.expand(lead + pk.shape[-1:]).contiguous()
        outs = [torch.empty(lead + (K - 1,) + tail, dtype=X.dtype,
                            device=X.device)
                for tail in ((nx, nx), (nx, nu), (nx, nu), (nx,), (nx,),
                             (nx,))]
        err = _build.declare(lib, f"scvx_discretize_lanes_{dyn}_{sfx}", 10, 4)(
            pk.data_ptr(), X.data_ptr(), U.data_ptr(), sg.data_ptr(),
            *[o.data_ptr() for o in outs], X.numel() // (K * nx), K,
            substeps, int(bool(foh)), torch.cuda.current_stream().cuda_stream)
        _build.check(err, "other discretize_lanes")
        return tuple(outs)

    return discretize_lanes


def other_wrappers(libs):
    """The other build's kernels, called as that commit's wrappers called
    them; ``libs`` maps a source name ("kkt", "disc") to its library."""
    import torch

    from successiveconvexification_tpu_torch.ops import _build

    from successiveconvexification_tpu_torch.ops import cuda_kkt

    lib = libs.get("kkt")

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

    def cho_solve(L, B):
        # the redesigned wrapper's call (L and B read in place)
        sfx = _build.suffix("cho_solve", L, B)
        l_inner, l_outer, b_trans = cuda_kkt.cho_solve_layout(L, B)
        n, m = L.shape[-1], B.shape[-1]
        X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
        err = _build.declare(lib, f"scvx_cho_solve_{sfx}", 3, 6)(
            L.data_ptr(), B.data_ptr(), X.data_ptr(), B.numel() // (n * m), n,
            m, l_inner, l_outer, b_trans,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "other cho_solve")
        return X

    def chol(A):
        sfx = _build.suffix("chol", A)
        A = A.contiguous()
        n = A.shape[-1]
        L = torch.empty_like(A)
        err = _build.declare(lib, f"scvx_chol_{sfx}", 2, 2)(
            A.data_ptr(), L.data_ptr(), A.numel() // (n * n), n,
            torch.cuda.current_stream().cuda_stream)
        _build.check(err, "other chol")
        return L

    def fused_chol_solve(A, B):
        sfx = _build.suffix("fused_chol_solve", A, B)
        A, B = A.contiguous(), B.contiguous()
        n, m = A.shape[-1], B.shape[-1]
        X = torch.empty_like(B)
        err = _build.declare(lib, f"scvx_fused_chol_solve_{sfx}", 3, 3)(
            A.data_ptr(), B.data_ptr(), X.data_ptr(), A.numel() // (n * n),
            n, m, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "other fused_chol_solve")
        return X

    out = {}
    if lib is not None:
        out.update(tridiag_factor=tridiag_factor, cho_solve_vec=cho_solve_vec,
                   cho_solve=cho_solve, chol=chol,
                   fused_chol_solve=fused_chol_solve)
    if "disc" in libs:
        out["discretize_lanes"] = disc_entry(libs["disc"])
    return out


def synthetic():
    """(kernel, label, args) at the paths' shapes and a generic width, f32
    and f64."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(7)
    f64 = torch.float64
    calls = []

    def spd(count, n):
        R = torch.randn(count, n, n, generator=g, dtype=f64)
        return R @ R.transpose(-1, -2) + n * torch.eye(n, dtype=f64)

    def plain(*args):
        return lambda dt: tuple(a.to(dt).cuda() for a in args)

    for B, N, n in ((256, 49, 13), (64, 49, 20)):
        D = spd(B * N, n).reshape(B, N, n, n) + 4.0 * n * torch.eye(n, dtype=f64)
        O = 0.5 * torch.randn(B, N - 1, n, n, generator=g, dtype=f64)
        calls.append(("tridiag_factor", f"synthetic ({B}, {N}, {n})",
                      plain(D, O)))
    for N, n in ((12800, 17), (7680, 11), (50, 17), (4096, 20)):
        # contiguous, as the paths' factors are (cholesky's output is not,
        # and a wrapper's .contiguous() would time a copy with the kernel)
        L = torch.linalg.cholesky(spd(N, n)).contiguous()
        b = torch.randn(N, n, generator=g, dtype=f64)
        calls.append(("cho_solve_vec", f"synthetic {N} x {n}", plain(L, b)))
    # cho_solve as the unfused factorize calls it: L = chol_Hw[:, :-1] of a
    # (B, K, n, n) factor (a lane stride), B = E' of a contiguous E (B, K-1,
    # m, n) with a quarter of its entries exact zeros, or B row-major
    for B, K, n, m in ((1, 50, 17, 13), (256, 50, 17, 13), (8, 9, 20, 7)):
        Lf = torch.linalg.cholesky(spd(B * K, n)).reshape(B, K, n, n)
        E = torch.randn(B, K - 1, m, n, generator=g, dtype=f64)
        E[torch.rand(E.shape, generator=g, dtype=f64) < 0.25] = 0.0
        for trans in (True, False):
            def make(dt, Lf=Lf, E=E, trans=trans):
                Lc, Ec = Lf.to(dt).cuda().contiguous(), E.to(dt).cuda()
                Bm = Ec.transpose(-1, -2)
                return Lc[:, :-1], Bm if trans else Bm.contiguous()
            calls.append(("cho_solve", f"synthetic ({B * (K - 1)}, {n}, {m}), "
                          f"B {'transposed' if trans else 'row-major'}, L "
                          f"{'strided' if B > 1 else 'contiguous'}, 25% zeros",
                          make))
    # chol and fused_chol_solve on SPD blocks with a quarter of the lower
    # triangle exact zeros (mirrored; the diagonal shifted so the block
    # stays positive definite), block 1 with an infinite pivot and block 3
    # indefinite; chol reads only the lower triangle, so the upper one is
    # noise
    def sparse_spd(N, n, noisy_upper):
        A = cs._sparse_spd(g, N, n)
        A[1, 5, 5] = float("inf")
        A[3] -= (torch.linalg.eigvalsh(A[3])[0] + 1.0) * torch.eye(n, dtype=f64)
        if noisy_upper:
            A = torch.tril(A) + torch.triu(
                torch.randn(N, n, n, generator=g, dtype=f64), 1)
        return A

    for N, n in ((50, 17), (12800, 17), (64, 20), (9001, 20)):
        calls.append(("chol", f"synthetic {N} x {n}, 25% zeros, an infinite "
                      "and a negative pivot", plain(sparse_spd(N, n, True))))
    for N, n, m in ((300, 13, 2), (12800, 17, 13), (64, 20, 7),
                    (4099, 17, 13), (4099, 20, 7)):
        calls.append(("fused_chol_solve", f"synthetic ({N}, {n}, {m}), 25% "
                      "zeros, an infinite and a negative pivot",
                      plain(sparse_spd(N, n, False),
                            torch.randn(N, n, m, generator=g, dtype=f64))))
    # discretize_lanes at the main path's and the point mass's shapes (the
    # initial guess, as the first SCvx iteration sees it, and a perturbed
    # one with drag and a NaN node)
    from successiveconvexification_tpu_torch.models import pointmass3dof as pm
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    P = cs._import_port()[0]
    for mod, model, K, label in (
            (rk, P.rocket6dof_model(), cs.MAIN_K, "initial guess"),
            (rk, P.rocket6dof_model(), cs.MAIN_K, "perturbed, drag, a NaN node"),
            (pm, P.pointmass3dof_model(), cs.PM_K, "perturbed")):
        params = cs._dispersed(P, cs.MAIN_B, f64, "cpu",
                               pointmass=mod is pm)
        X, U, sig = model.initial_guess(params, K)
        if label != "initial guess":
            X = X + 0.01 * torch.randn(X.shape, generator=g, dtype=f64)
            U = U + 0.1 * torch.randn(U.shape, generator=g, dtype=f64)
        if "drag" in label:
            params = params.replace(cd_a=torch.linspace(0.0, 0.3, X.shape[0],
                                                        dtype=f64))
            X[1, 3] = float("nan")

        def make(dt, model=model, params=params, X=X, U=U, sig=sig):
            return (model, params.map(lambda v, tail: v.to(dt).cuda()),
                    X.to(dt).cuda(), U.to(dt).cuda(), sig.to(dt).cuda(),
                    cs.MAIN_SUBSTEPS, True)
        calls.append(("discretize_lanes", f"synthetic {model.name} "
                      f"({X.shape[0]}, {K}), {label}", make))
    out = []
    for name, label, make in calls:
        for dt in (torch.float32, f64):
            out.append((name, f"{label} {str(dt)[6:]}", make(dt)))
    return out


def captured(path: str, kernels=KERNELS):
    """The saved calls; a discretize call is saved as (model name, params
    fields, X, U, sigma, substeps, foh) and comes back with the model."""
    import torch

    from successiveconvexification_tpu_torch.models import pointmass3dof as pm
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    P = cs._import_port()[0]
    models = {"rocket6dof": (P.rocket6dof_model(), rk.Rocket6DoFParams),
              "pointmass3dof": (P.pointmass3dof_model(),
                                pm.PointMass3DoFParams)}
    saved = torch.load(path, map_location="cuda")
    out = []
    for name in kernels:
        for label, args in saved.get(name, []):
            if name == "discretize_lanes":
                mname, fields, *rest = args
                model, params_type = models[mname]
                args = (model, params_type(**fields), *rest)
            out.append((name, f"captured: {label}", tuple(args)))
    return out


def _equal(a, b):
    import torch

    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _tensors(args):
    import torch

    return [a for a in args if torch.is_tensor(a)]


def compare(name, args, this, other):
    """(equal everywhere, lanes that differ, of those the ones where this
    build's output holds an infinite entry); a lane is an index of the
    outputs' first axis."""
    import torch

    outs = [cs._tuple(f(*args)) for f in (this, other)]
    torch.cuda.synchronize()
    diff = torch.zeros(outs[0][0].shape[0], dtype=torch.bool, device="cuda")
    has_inf = torch.zeros_like(diff)
    for a, b in zip(*outs):
        diff |= ~_equal(a, b).reshape(a.shape[0], -1).all(1)
        has_inf |= torch.isinf(a).reshape(a.shape[0], -1).any(1)
    return (not bool(diff.any()), int(diff.sum()),
            int((diff & has_inf).sum()))


def ptxas_lines(log: Path) -> list[tuple[str, str]]:
    """(demangled kernel, ptxas -v's line) for the entry functions of
    KERNELS in a build log."""
    if not log.exists():
        return [(str(log), "no build log (the library was built before)")]
    filt = shutil.which("c++filt")
    out, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(_Z\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and any(fn in cur for fn in DEVICE_FN.values()) and (
                "registers" in line or "spill" in line):
            nm = cur
            if filt:
                nm = subprocess.run([filt, cur], capture_output=True,
                                    text=True).stdout.strip()
            nm = re.sub(r"\(anonymous namespace\)::", "", nm).split("(")[0]
            out.append((nm, line.split(":", 1)[-1].strip()))
    return out


def _a16(b: int) -> int:
    return (b + 15) // 16 * 16


DISC_DIMS = {"Rocket6DoF": (14, 3), "PointMass3DoF": (7, 3)}


def _slot(nn: int, v: int) -> int:
    """csrc/kkt.cu cho_l_slot: a block's n*n elements and room for its
    phase, rounded to 16 bytes."""
    return -(-(nn + v - 1) // v) * v


def _xcol(n: int, v: int) -> int:
    """csrc/kkt.cu xcol_len: a column exchange buffer's values."""
    return -(-n // v) * v


def fcs_shape(n: int, m: int, es: int, nbc: int = 32):
    """(threads, dynamic shared memory) of a fused_chol_solve CTA of nbc
    blocks (csrc/kkt.cu launch_fused_chol_solve_n)."""
    v = 16 // es
    threads = max(-(-nbc * m // 32), min(nbc, 16)) * 32
    return threads, (nbc * _slot(n * n, v) * es
                     + _a16((nbc * n * m + v) * es)
                     + threads // 32 * 2 * _xcol(n, v) * es + _a16(nbc * 4))


def fcs_nmax(n: int, m: int, es: int) -> int:
    """The most blocks a fused_chol_solve CTA takes."""
    nbc = 32
    while nbc > 1 and (fcs_shape(n, m, es, nbc)[1] > 112 * 1024
                       or fcs_shape(n, m, es, nbc)[0] > 512):
        nbc -= 1
    return nbc


def launch_shape(kernel: str):
    """(threads, dynamic shared memory) a CTA of a kernel instantiation at
    the paths' shapes, as the launchers of csrc/kkt.cu and csrc/disc.cu
    give them, or, for a first design of chol, fused_chol_solve or
    cho_solve (its instantiation named by its type alone), that design's
    (one warp a block, four a CTA, at n = 17). chol and fused_chol_solve:
    their largest CTA (four warps; nmax blocks). None where the width is
    not compiled in."""
    es = 8 if "<double" in kernel else 4
    v = 16 // es
    # a first design's instantiation has the type alone (chol_kernel<float>);
    # a redesign's has its widths, and where they are not compiled in
    # (false) the shape is the call's
    first = re.search(r"_kernel<(float|double)>", kernel) is not None
    if "fused_chol_solve_kernel" in kernel:
        if first:   # the first design at the stage-Hessian shape
            return 128, 4 * 17 * 17 * es
        mt = re.search(r"fused_chol_solve_kernel<\w+, (\d+), (\d+), true>",
                       kernel)
        if not mt:
            return None
        n, mm = int(mt.group(1)), int(mt.group(2))
        return fcs_shape(n, mm, es, fcs_nmax(n, mm, es))
    if "chol_kernel" in kernel:
        if first:
            return 128, 4 * 17 * 17 * es
        mt = re.search(r"chol_kernel<\w+, (\d+), true>", kernel)
        if not mt:
            return None
        n = int(mt.group(1))
        return 128, 4 * (2 * _slot(n * n, v) + 2 * _xcol(n, v)) * es
    if "discretize_kernel" in kernel:
        nx, nu = next(d for k, d in DISC_DIMS.items() if k in kernel)
        ld = -(-nx // v) * v
        ld += 0 if (ld // v) % 2 else v
        lane = max((2 * nx + nu + 4) * ld, nx * nx + 2 * nx * nu + 2 * nx)
        lane = -(-lane // v) * v
        return 128, 4 * lane * es
    if "cho_solve_kernel" in kernel:
        if first:   # the first design at the rocket's n = 17
            return 128, 4 * 17 * 17 * es
        m = re.search(r"cho_solve_kernel<\w+, (\d+), (\d+), true>", kernel)
        if not m:
            return None
        n, mm = int(m.group(1)), int(m.group(2))
        slot = _slot(n * n, v)
        for nbc in range(32, 0, -1):
            smem = nbc * slot * es + _a16((nbc * n * mm + v) * es)
            if smem <= 112 * 1024 and nbc * mm <= 512:
                break
        return -(-nbc * mm // 32) * 32, smem
    return None


def resident_warps(regs: int, threads: int, smem: int) -> int:
    """Warps an SM holds (the H100's limits: 64K registers allocated 256 a
    warp, 228 KB of shared memory with 1 KB reserved a CTA, 2,048 threads,
    32 CTAs)."""
    wpc = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    ctas = min(65536 // (per_warp * wpc), 233472 // (smem + 1024),
               2048 // threads, 32)
    return ctas * wpc


def report_builds(logs) -> list[str]:
    """ptxas's registers and spills, and the launch's shared memory and
    resident warps an SM, for each build's kernels."""
    lines = []
    for tag, log in logs:
        for nm, line in ptxas_lines(log):
            text = f"ptxas ({tag}) {nm}: {line}"
            m = re.search(r"Used (\d+) registers", line)
            shape = launch_shape(nm) if m else None
            if shape:
                threads, smem = shape
                text += (f"; {threads} threads and {smem} B of dynamic shared "
                         f"memory a CTA at the paths' shapes: "
                         f"{resident_warps(int(m.group(1)), threads, smem)} "
                         f"resident warps an SM")
            lines.append(text)
    return lines


def dynamic_smem(name, args) -> int:
    """This build's launchers' dynamic shared memory a CTA (csrc/kkt.cu,
    csrc/disc.cu; chol and fused_chol_solve: their largest CTA)."""
    ts = _tensors(args)
    esize = ts[0].element_size()
    two_per_sm = 112 * 1024
    if name == "discretize_lanes":
        dyn = "Rocket6DoF" if args[0].nx == 14 else "PointMass3DoF"
        return launch_shape(f"discretize_kernel<{'double' if esize == 8 else 'float'}, {dyn}>")[1]
    n = ts[0].shape[-1]
    if name == "chol":
        return launch_shape(f"chol_kernel<{'double' if esize == 8 else 'float'}"
                            f", {n}, true>")[1]
    if name == "fused_chol_solve":
        m = ts[1].shape[-1]
        return fcs_shape(n, m, esize, fcs_nmax(n, m, esize))[1]
    if name == "tridiag_factor":
        nn = n * n
        for ch in (4, 3, 2, 1):
            smem = _a16(3 * 8) + _a16(2 * nn * esize) + 3 * ch * 2 * nn * esize
            if smem <= two_per_sm:
                break
        return smem
    if name == "cho_solve":
        m, v = ts[1].shape[-1], 16 // esize
        slot = _slot(n * n, v)
        for nbc in range(32, 0, -1):
            smem = nbc * slot * esize + _a16((nbc * n * m + v) * esize)
            if smem <= two_per_sm and nbc * m <= 512:
                break
        return smem
    for nbw in range(32, 0, -1):
        smem = _a16(nbw * (n * n | 1) * esize) + nbw * (n | 1) * esize
        if smem <= two_per_sm:
            break
    return smem


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the other commit's csrc/ files")
    ap.add_argument("--captures", help="chip_smoke.py --save-captures output")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to hold (default: all)")
    opts = ap.parse_args()
    kernels = tuple(k for k in opts.kernels.split(",") if k)
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels: one of {KERNELS}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from successiveconvexification_tpu_torch.ops import (_build, cuda_disc,
                                                         cuda_kkt, precision)

    precision.full_precision()
    card = cs._card_line()
    print(card)
    sources = sorted({SOURCE[k] for k in kernels})
    _build.build_all()
    this = {k: getattr(cuda_disc if SOURCE[k] == "disc" else cuda_kkt, k)
            for k in kernels}
    other = other_wrappers(build_others(Path(opts.parent), sources))
    calls = [c for c in synthetic() if c[0] in kernels]
    if opts.captures:
        calls += captured(opts.captures, kernels)
    bad = []
    for name, label, args in calls:
        same, n_diff, n_inf = compare(name, args, this[name], other[name])
        times = [cs._time_ms(lambda f=f: f(*args))
                 for f in (other[name], this[name], this[name], other[name])]
        esize = _tensors(args)[0].element_size()
        nbytes, flops = cs._work(name, args, esize)
        peak = cs.PEAK_FLOPS["float64" if esize == 8 else "float32"]
        bound = max(nbytes / cs.PEAK_BYTES_PER_S, flops / peak) * 1e3
        print(f"{name} {label} {[tuple(a.shape) for a in _tensors(args)]}: "
              f"bit for bit "
              f"{'yes' if same else f'NO in {n_diff} lanes ({n_inf} with an infinite entry here)'}; "
              f"other/this/this/other "
              f"{'/'.join(f'{t:.4f}' for t in times)} ms, bound "
              f"{bound:.5f} ms; dynamic shared memory "
              f"{dynamic_smem(name, args)} B a CTA; {card}")
        if n_diff > n_inf:
            bad.append(f"{name} {label}")
    logs = [("this build", _build.BUILD / f"{src}.log") for src in sources]
    logs += [("other build", _build.BUILD / f"ab_other_{src}.log")
             for src in sources]
    for line in report_builds(logs):
        print(line)
    if bad:
        print(f"kernel_ab: outputs differ: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
