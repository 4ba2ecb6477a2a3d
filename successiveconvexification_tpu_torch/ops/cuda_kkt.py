"""CUDA kernels for the block solves of the KKT system (csrc/kkt.cu).

The counterpart of the JAX package's ``ops/pallas_kkt.py`` for the two
kernels the main path runs:

  - ``cho_solve_vec``: (L L') x = b for N tiny blocks, vector rhs
    (replaces ``pallas_kkt.cho_solve_vec`` / ``_cho_solve_kernel``);
  - ``tridiag_solve``: forward and backward block-tridiagonal sweeps in ONE
    launch (replaces ``pallas_kkt.tridiag_solve``, which took two).

Each wrapper launches its kernel on a CUDA tensor (or raises) and uses its
plain PyTorch version on a CPU tensor, only because the tensor lies on the
CPU. ``<wrapper>.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from successiveconvexification_tpu_torch.ops import _build, smallla

def _fn(fn, suffix, n_ptr, n_int):
    return _build.declare(_build.library("kkt"), f"scvx_{fn}_{suffix}",
                          n_ptr, n_int)


def cho_solve_vec_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return smallla.cho_solve(L, b)


def cho_solve_vec(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L_i L_i') x_i = b_i; L (..., n, n), b (..., n), n <= 32."""
    if L.device.type == "cpu" and b.device.type == "cpu":
        return cho_solve_vec_plain(L, b)
    sfx = _build.suffix("cho_solve_vec", L, b)
    n = L.shape[-1]
    if L.shape[-2] != n or b.shape != L.shape[:-1] or n > 32:
        raise ValueError(f"cho_solve_vec: shapes {tuple(L.shape)}, "
                         f"{tuple(b.shape)}")
    Lc, bc = L.contiguous(), b.contiguous()
    x = torch.empty_like(bc)
    N = bc.numel() // n
    err = _fn("cho_solve_vec", sfx, 3, 2)(
        Lc.data_ptr(), bc.data_ptr(), x.data_ptr(), N, n,
        torch.cuda.current_stream(L.device).cuda_stream)
    _build.check(err, "cho_solve_vec")
    cho_solve_vec.launches += 1
    return x


cho_solve_vec.launches = 0


def tridiag_solve_plain(L: torch.Tensor, C: torch.Tensor,
                        r: torch.Tensor) -> torch.Tensor:
    return smallla.blocktridiag_solve(L, C, r)


def tridiag_solve(L: torch.Tensor, C: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
    """Solve M u = r from the block factors; L, C (B, N, n, n), r (B, N, n)."""
    if all(t.device.type == "cpu" for t in (L, C, r)):
        return tridiag_solve_plain(L, C, r)
    sfx = _build.suffix("tridiag_solve", L, C, r)
    if L.dim() != 4 or C.shape != L.shape or r.shape != L.shape[:-1] \
            or L.shape[-1] > 32:
        raise ValueError(f"tridiag_solve: shapes {tuple(L.shape)}, "
                         f"{tuple(C.shape)}, {tuple(r.shape)}")
    B, N, n, _ = L.shape
    Lc, Cc, rc = L.contiguous(), C.contiguous(), r.contiguous()
    u = torch.empty_like(rc)
    err = _fn("tridiag_solve", sfx, 4, 3)(
        Lc.data_ptr(), Cc.data_ptr(), rc.data_ptr(), u.data_ptr(), B, N, n,
        torch.cuda.current_stream(L.device).cuda_stream)
    _build.check(err, "tridiag_solve")
    tridiag_solve.launches += 1
    return u


tridiag_solve.launches = 0
