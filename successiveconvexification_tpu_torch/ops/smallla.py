"""Batched small-matrix linear algebra: the plain versions the kernels are held to.

The PyTorch counterpart of the JAX package's ``ops/smallla.py``. Every
function takes any number of leading batch dimensions. These are plain
``torch.linalg`` compositions: the port's hot path runs the CUDA kernels of
``ops/cuda_kkt.py`` and ``ops/cuda_fused.py`` on the card, and these serve
CPU tensors and the kernel-vs-plain checks.
"""

from __future__ import annotations

import torch


def chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of SPD (..., n, n).

    A block that is not positive definite gives NaNs instead of raising —
    the JAX package's semantics, which the masked IPM relies on: frozen or
    failed lanes may carry garbage that is selected away afterwards."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _as_mat(L, b):
    vec = b.dim() == L.dim() - 1
    return (b[..., None] if vec else b), vec


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b, L lower-triangular (..., n, n); b (..., n) or (..., n, m)."""
    bb, vec = _as_mat(L, b)
    out = torch.linalg.solve_triangular(L, bb, upper=False)
    return out[..., 0] if vec else out


def solve_upper_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L' x = b with L lower-triangular; b (..., n) or (..., n, m)."""
    bb, vec = _as_mat(L, b)
    out = torch.linalg.solve_triangular(L.transpose(-1, -2), bb, upper=True)
    return out[..., 0] if vec else out


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L') x = b."""
    return solve_upper_t(L, solve_lower(L, b))


def blocktridiag_factor(D: torch.Tensor, O: torch.Tensor):
    """Block-tridiagonal Cholesky along axis -3.

    D (..., N, n, n) diagonal blocks, O (..., N-1, n, n) couplings
    M[k, k+1] = O_k. Returns the lower factors L_k and the forward couplings
    C_k = L_{k-1}^{-1} O_{k-1} (C_0 = 0): S_k = D_k - C_k' C_k, L_k = chol(S_k).
    """
    N = D.shape[-3]
    Ls = [chol(D[..., 0, :, :])]
    Cs = [torch.zeros_like(D[..., 0, :, :])]
    for k in range(1, N):
        Ck = solve_lower(Ls[-1], O[..., k - 1, :, :])
        S = D[..., k, :, :] - Ck.transpose(-1, -2) @ Ck
        Ls.append(chol(S))
        Cs.append(Ck)
    return torch.stack(Ls, dim=-3), torch.stack(Cs, dim=-3)


def blocktridiag_solve(chol_D: torch.Tensor, Coff: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """Solve M u = rhs given the block factorization; rhs (..., N, n) or
    (..., N, n, m)."""
    N = chol_D.shape[-3]
    vec = rhs.dim() == chol_D.dim() - 1
    b = rhs[..., None] if vec else rhs
    v = []
    v_prev = torch.zeros_like(b[..., 0, :, :])
    for k in range(N):
        r = b[..., k, :, :] - Coff[..., k, :, :].transpose(-1, -2) @ v_prev
        v_prev = solve_lower(chol_D[..., k, :, :], r)
        v.append(v_prev)
    u = [None] * N
    u_next = torch.zeros_like(b[..., 0, :, :])
    for k in range(N - 1, -1, -1):
        r = v[k]
        if k + 1 < N:
            r = r - Coff[..., k + 1, :, :] @ u_next
        u_next = solve_upper_t(chol_D[..., k, :, :], r)
        u[k] = u_next
    out = torch.stack(u, dim=-3)
    return out[..., 0] if vec else out
