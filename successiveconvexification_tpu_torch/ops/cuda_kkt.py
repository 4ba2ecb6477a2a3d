"""CUDA kernels for the block solves of the KKT system (csrc/kkt.cu).

The counterpart of the JAX package's ``ops/pallas_kkt.py`` for the
kernels the ported paths run:

  - ``cho_solve_vec``: (L L') x = b for N tiny blocks, vector rhs
    (replaces ``pallas_kkt.cho_solve_vec`` / ``_cho_solve_kernel``);
  - ``tridiag_solve``: forward and backward block-tridiagonal sweeps in ONE
    launch (replaces ``pallas_kkt.tridiag_solve``, which took two);
    ``tridiag_solve_mat`` runs it on a matrix right-hand side;
  - ``chol``: lower Cholesky of N tiny SPD blocks (replaces
    ``pallas_kkt.chol`` / ``_chol_kernel``);
  - ``cho_solve``: (L L') X = B for N tiny blocks, matrix rhs (replaces
    ``pallas_kkt.cho_solve`` / ``_cho_solve_kernel``);
  - ``tridiag_factor``: the block Cholesky factors of B block-tridiagonal
    systems (replaces ``pallas_kkt.tridiag_factor`` /
    ``_tridiag_factor_kernel``);
  - ``fused_chol_solve``: A X = B for N tiny SPD blocks, factor and solves in
    one launch (replaces ``pallas_kkt.fused_chol_solve`` /
    ``_fused_chol_solve_kernel``).

The first two run on the main path (fused ``scan`` factorization), the
next two on the single-lane replan path (unfused factorization, PCR);
``cho_solve_vec`` runs on both. The unfused ``scan`` factorization (a
subproblem with rank-one quadratic rows) runs ``chol``, ``cho_solve``,
``tridiag_factor``, ``tridiag_solve`` and ``cho_solve_vec``; the
``ksharded`` backend (``parallel/kkt_sharded.py``) runs the same five,
its interior chains and its reduced system on ``tridiag_factor`` and
``tridiag_solve``. ``fused_chol_solve`` is on no path, as in the JAX
package, whose tests alone call it.

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


def tridiag_solve_mat_plain(L: torch.Tensor, C: torch.Tensor,
                            R: torch.Tensor) -> torch.Tensor:
    return smallla.blocktridiag_solve(L, C, R)


def fold_columns(L: torch.Tensor, C: torch.Tensor, R: torch.Tensor):
    """(L, C, r) of B * m lanes from L, C (B, N, n, n) and R (B, N, n, m):
    lane b * m + j is column j of lane b, with L and C repeated for each
    column. The repeated factors are m times the size of L and C: at the
    rocket's width (n = m = 13, N = 49) and B = 256, about 108 MB each in
    float32."""
    if L.dim() != 4 or C.shape != L.shape or R.shape[:-1] != L.shape[:-1]:
        raise ValueError(f"tridiag_solve_mat: shapes {tuple(L.shape)}, "
                         f"{tuple(C.shape)}, {tuple(R.shape)}")
    B, N, n, _ = L.shape
    m = R.shape[-1]

    def rep(t):
        return t[:, None].expand(B, m, N, n, n).reshape(B * m, N, n, n)

    return rep(L), rep(C), R.permute(0, 3, 1, 2).reshape(B * m, N, n)


def unfold_columns(u: torch.Tensor, m: int) -> torch.Tensor:
    """The (B, N, n, m) solution from ``fold_columns``' lanes (B * m, N, n)."""
    BM, N, n = u.shape
    return u.reshape(BM // m, m, N, n).permute(0, 2, 3, 1)


def tridiag_solve_mat(L: torch.Tensor, C: torch.Tensor,
                      R: torch.Tensor) -> torch.Tensor:
    """Solve M U = R from the block factors for a matrix right-hand side;
    L, C (B, N, n, n), R (B, N, n, m). One ``tridiag_solve`` launch on the
    columns folded into the lane axis (``fold_columns``): the kernel takes
    one right-hand side a lane."""
    if all(t.device.type == "cpu" for t in (L, C, R)):
        return tridiag_solve_mat_plain(L, C, R)
    return unfold_columns(tridiag_solve(*fold_columns(L, C, R)), R.shape[-1])


def chol_plain(A: torch.Tensor) -> torch.Tensor:
    return smallla.chol(A)


def chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of SPD blocks A (..., n, n), n <= 32; a block with a
    pivot <= 0 or NaN comes out entirely NaN, and an infinite pivot factors
    on (LAPACK potrf's test, ``smallla.chol``'s)."""
    if A.device.type == "cpu":
        return chol_plain(A)
    sfx = _build.suffix("chol", A)
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= 32:
        raise ValueError(f"chol: shape {tuple(A.shape)}")
    Ac = A.contiguous()
    L = torch.empty_like(Ac)
    err = _fn("chol", sfx, 2, 2)(
        Ac.data_ptr(), L.data_ptr(), Ac.numel() // (n * n), n,
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "chol")
    chol.launches += 1
    return L


chol.launches = 0


def cho_solve_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return smallla.cho_solve(L, B)


def _folded(shape, strides):
    """The axes (size, stride) with the size-1 ones dropped and each run of
    axes that address one evenly spaced sequence folded into one."""
    out = []
    for size, stride in zip(shape, strides):
        if size == 1:
            continue
        if out and out[-1][1] == stride * size:
            out[-1] = (out[-1][0] * size, stride)
        else:
            out.append((size, stride))
    return out


def _axis_stride(t: torch.Tensor, dim: int, want: int) -> bool:
    return t.shape[dim] == 1 or t.stride(dim) == want


def cho_solve_layout(L: torch.Tensor, B: torch.Tensor):
    """How the cho_solve kernel reads ``L`` and ``B`` in place, as
    ``(l_inner, l_outer, b_trans)``: L's blocks are n x n row-major, l_inner
    consecutive ones a lane and lanes l_outer elements apart (the IPM's
    ``chol_Hw[:, :-1]``); B's blocks follow each other at a stride of n*m,
    row-major (``b_trans`` 0) or the transpose of a row-major m x n block
    (``b_trans`` 1: the IPM's ``E.transpose(-1, -2)``). Raises ValueError
    for any other layout; nothing is copied."""
    n, m = L.shape[-1], B.shape[-1]
    if L.dim() < 2 or L.shape[-2] != n or B.shape[:-1] != L.shape[:-1] \
            or not 1 <= n <= 32 or not 1 <= m <= 32:
        raise ValueError(f"cho_solve: shapes {tuple(L.shape)}, "
                         f"{tuple(B.shape)}")
    nn = n * n
    if not (_axis_stride(L, -1, 1) and _axis_stride(L, -2, n)):
        raise ValueError(f"cho_solve: L's blocks are not row-major (strides "
                         f"{L.stride()})")
    lead = _folded(L.shape[:-2], L.stride()[:-2])
    if not lead:
        l_inner, l_outer = 1, nn
    elif lead[-1][1] != nn or len(lead) > 2:
        raise ValueError(f"cho_solve: L's blocks are not {nn} elements "
                         f"apart within a lane (strides {L.stride()})")
    else:
        l_inner = lead[-1][0]
        l_outer = lead[0][1] if len(lead) == 2 else l_inner * nn
    if _axis_stride(B, -1, 1) and _axis_stride(B, -2, m):
        b_trans = 0
    elif _axis_stride(B, -2, 1) and _axis_stride(B, -1, n):
        b_trans = 1
    else:
        raise ValueError(f"cho_solve: B's blocks are neither row-major nor "
                         f"transposed row-major (strides {B.stride()})")
    b_lead = _folded(B.shape[:-2], B.stride()[:-2])
    if b_lead and (len(b_lead) > 1 or b_lead[0][1] != n * m):
        raise ValueError(f"cho_solve: B's blocks are not {n * m} elements "
                         f"apart (strides {B.stride()})")
    if l_outer >= 2 ** 31 or B.numel() >= 2 ** 31:
        raise ValueError("cho_solve: 2^31 elements or more")
    return l_inner, l_outer, b_trans


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L_i L_i') X_i = B_i; L (..., n, n), B (..., n, m), n, m <= 32.

    The kernel reads both in place in the layouts ``cho_solve_layout``
    takes (the IPM's slices of one factor and transposed E, F among them)
    and refuses any other; X is row-major."""
    if L.device.type == "cpu" and B.device.type == "cpu":
        return cho_solve_plain(L, B)
    sfx = _build.suffix("cho_solve", L, B)
    l_inner, l_outer, b_trans = cho_solve_layout(L, B)
    n, m = L.shape[-1], B.shape[-1]
    X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    err = _fn("cho_solve", sfx, 3, 6)(
        L.data_ptr(), B.data_ptr(), X.data_ptr(), B.numel() // (n * m), n, m,
        l_inner, l_outer, b_trans,
        torch.cuda.current_stream(L.device).cuda_stream)
    _build.check(err, "cho_solve")
    cho_solve.launches += 1
    return X


cho_solve.launches = 0


def tridiag_factor_plain(D: torch.Tensor, O: torch.Tensor):
    return smallla.blocktridiag_factor(D, O)


def tridiag_factor(D: torch.Tensor, O: torch.Tensor):
    """Block Cholesky of SPD block-tridiagonal systems: D (B, N, n, n)
    diagonal blocks, O (B, N-1, n, n) couplings M[k, k+1] = O_k, n <= 32.
    Returns L, C (B, N, n, n): L_k = chol(D_k - C_k' C_k), C_k =
    L_{k-1}^-1 O_{k-1}, C_0 = 0. From a block with a pivot <= 0 or NaN
    on, every block of the lane comes out NaN; an infinite pivot factors on,
    as ``chol``'s does."""
    if D.device.type == "cpu" and O.device.type == "cpu":
        return tridiag_factor_plain(D, O)
    sfx = _build.suffix("tridiag_factor", D, O)
    if (D.dim() != 4 or D.shape[-2] != D.shape[-1] or D.shape[1] < 1
            or O.shape != (D.shape[0], D.shape[1] - 1) + D.shape[2:]
            or D.shape[-1] > 32):
        raise ValueError(f"tridiag_factor: shapes {tuple(D.shape)}, "
                         f"{tuple(O.shape)}")
    B, N, n, _ = D.shape
    Dc, Oc = D.contiguous(), O.contiguous()
    L = torch.empty_like(Dc)
    C = torch.empty_like(Dc)
    err = _fn("tridiag_factor", sfx, 4, 3)(
        Dc.data_ptr(), Oc.data_ptr(), L.data_ptr(), C.data_ptr(), B, N, n,
        torch.cuda.current_stream(D.device).cuda_stream)
    _build.check(err, "tridiag_factor")
    tridiag_factor.launches += 1
    return L, C


tridiag_factor.launches = 0


def fused_chol_solve_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return smallla.cho_solve(smallla.chol(A), B)


def fused_chol_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A_i X_i = B_i; A (..., n, n) SPD, B (..., n, m), n, m <= 32.
    A block whose Cholesky factor breaks down (``chol``'s test) comes out
    entirely NaN."""
    if A.device.type == "cpu" and B.device.type == "cpu":
        return fused_chol_solve_plain(A, B)
    sfx = _build.suffix("fused_chol_solve", A, B)
    n, m = A.shape[-1], B.shape[-1]
    if (A.dim() < 2 or A.shape[-2] != n or B.shape[:-1] != A.shape[:-1]
            or not 1 <= n <= 32 or not 1 <= m <= 32):
        raise ValueError(f"fused_chol_solve: shapes {tuple(A.shape)}, "
                         f"{tuple(B.shape)}")
    Ac, Bc = A.contiguous(), B.contiguous()
    X = torch.empty_like(Bc)
    err = _fn("fused_chol_solve", sfx, 3, 3)(
        Ac.data_ptr(), Bc.data_ptr(), X.data_ptr(), Ac.numel() // (n * n),
        n, m, torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "fused_chol_solve")
    fused_chol_solve.launches += 1
    return X


fused_chol_solve.launches = 0
