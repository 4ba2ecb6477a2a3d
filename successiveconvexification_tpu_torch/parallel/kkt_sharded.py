"""K-sharded block-tridiagonal KKT solve over ``torch.distributed`` ranks.

The counterpart of the JAX package's ``parallel/kkt_sharded.py``. The
Schur system of the IPM's KKT solve (block tridiagonal and SPD along the
node axis K) is solved by substructuring, split along K over the ranks of
a ``parallel.mesh.Mesh``:

  1. the block chain is padded with decoupled identity blocks to m blocks a
     rank (m >= 3; padding rows solve to exactly 0), and rank p keeps the
     contiguous tile [p m, (p + 1) m), JAX's ``P(axis)`` tile; the last
     block of each tile is its separator;
  2. each rank factors its (m - 1)-block interior chain and condenses it
     onto its separators; one neighbour exchange sends the coupling b
     forward and one sends the contributions to the previous separator
     back;
  3. each solve gathers the reduced (P blocks) separator system on every
     rank, which every rank factors and solves;
  4. the interiors back-substitute against the separator values, and every
     rank gathers every rank's piece, so each holds the same whole u, bit
     for bit.

Where JAX runs one SPMD program and shards only this system over a mesh
axis, here every rank runs the same IPM on the same whole subproblem and
only ``ksharded_factor`` and ``ksharded_solve`` split the work: the
final gather keeps the replicated rest of the IPM identical on every rank.
At world size 1 no collective and no point-to-point operation is called.
NCCL cannot run two ranks on one card, so two or more ranks run on gloo
between CPU processes (or on NCCL across cards).

Tensors are batched, (B, N, n, n) as every port KKT function is. The
interior chains and the reduced system are factored by
``cuda_kkt.tridiag_factor`` and solved by ``cuda_kkt.tridiag_solve`` (the
columns of a matrix right-hand side by ``tridiag_solve_mat``): kernels on
the card, their plain versions on CPU tensors. Select the backend with
``IPMConfig.kkt_solver = "ksharded"`` after ``set_kkt_mesh(mesh)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from successiveconvexification_tpu_torch.ops import cuda_kkt
from successiveconvexification_tpu_torch.parallel.mesh import Mesh

# IPMConfig is a static dataclass and cannot carry a mesh, so the backend
# reads the one installed here, as the JAX package's does
_KKT_MESH: dict = {"mesh": None}


def set_kkt_mesh(mesh: Optional[Mesh]) -> None:
    """Install the mesh used by ``kkt_solver="ksharded"`` (None: uninstall)."""
    _KKT_MESH["mesh"] = mesh


def get_kkt_mesh() -> Optional[Mesh]:
    return _KKT_MESH["mesh"]


class KShardedFactors(NamedTuple):
    """This rank's substructuring factors (its tile of the chain)."""

    Ls: torch.Tensor      # (B, m-1, nb, nb) interior block-Cholesky factors
    Cs: torch.Tensor      # (B, m-1, nb, nb) interior forward couplings
    Ya: torch.Tensor      # (B, m-1, nb, nb) T^-1 e_last a   (own-separator col)
    Zb: torch.Tensor      # (B, m-1, nb, nb) T^-1 e_0 b_prev' (prev-separator col)
    a: torch.Tensor       # (B, nb, nb) interior-last -> own-separator coupling
    b_prev: torch.Tensor  # (B, nb, nb) prev-separator -> interior-first coupling
    S: torch.Tensor       # (B, nb, nb) reduced separator diagonal block
    C: torch.Tensor       # (B, nb, nb) reduced separator coupling p -> p+1
    n_orig: int           # unpadded block count
    m: int                # blocks a rank (separator included)
    nshards: int          # the world size at factor time


def _installed(tensor: torch.Tensor) -> Mesh:
    mesh = get_kkt_mesh()
    if mesh is None:
        raise ValueError("ksharded backend needs set_kkt_mesh(mesh) first")
    dev = mesh.device
    if tensor.device.type != dev.type or (
            dev.index is not None and tensor.device.index != dev.index):
        raise ValueError(f"ksharded: the mesh's device is {dev}, the "
                         f"tensors lie on {tensor.device}")
    return mesh


def _pad_chain(D: torch.Tensor, O: torch.Tensor, nshards: int):
    """Pad (D, O) along axis 1 with decoupled identity blocks to m blocks a
    shard, m >= 3. Returns (D, O_full, N_pad, m), O_full (B, N_pad, nb, nb)
    with O_full[:, k] = O[:, k] for k < N - 1 and zeros after."""
    Bn, N, nb = D.shape[0], D.shape[1], D.shape[-1]
    m = max(-(-N // nshards), 3)
    N_pad = m * nshards
    if N_pad > N:
        eye = torch.eye(nb, dtype=D.dtype, device=D.device)
        D = torch.cat([D, eye.expand(Bn, N_pad - N, nb, nb)], dim=1)
    O_full = torch.zeros((Bn, N_pad, nb, nb), dtype=D.dtype, device=D.device)
    O_full[:, : N - 1] = O[:, : N - 1]
    return D, O_full, N_pad, m


def _tile(t: torch.Tensor, mesh: Mesh, m: int) -> torch.Tensor:
    return t[:, mesh.rank * m:(mesh.rank + 1) * m]


def _factor_body(D: torch.Tensor, O_pad: torch.Tensor, mesh: Mesh):
    """This rank's factors from its tile D, O_pad (B, m, nb, nb)."""
    m = D.shape[1]
    D_int, D_sep = D[:, : m - 1], D[:, m - 1]
    O_int = O_pad[:, : m - 2]
    a = O_pad[:, m - 2]               # interior last -> separator_p
    b = O_pad[:, m - 1]               # separator_p -> next shard's interior 0

    b_prev = mesh.shift(b, 1)         # zeros on rank 0

    Ls, Cs = cuda_kkt.tridiag_factor(D_int, O_int)
    col_a = torch.zeros_like(D_int)
    col_a[:, m - 2] = a
    Ya = cuda_kkt.tridiag_solve_mat(Ls, Cs, col_a)
    col_b = torch.zeros_like(D_int)
    col_b[:, 0] = b_prev.transpose(-1, -2)
    Zb = cuda_kkt.tridiag_solve_mat(Ls, Cs, col_b)

    # Schur contributions: own separator, and (through our interior) back
    # onto separator p-1, sent back one rank
    S_own = D_sep - a.transpose(-1, -2) @ Ya[:, m - 2]
    S_back = b_prev @ Zb[:, 0]
    C_back = b_prev @ Ya[:, 0]
    S_from_next = mesh.shift(S_back, -1)
    C_from_next = mesh.shift(C_back, -1)
    return Ls, Cs, Ya, Zb, a, b_prev, S_own - S_from_next, -C_from_next


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _solve_body(f: KShardedFactors, rhs: torch.Tensor, mesh: Mesh):
    """This rank's piece (B, m, nb) of u from its tile of rhs."""
    m, P = f.m, mesh.world
    r_int, r_sep = rhs[:, : m - 1], rhs[:, m - 1]
    R = cuda_kkt.tridiag_solve(f.Ls, f.Cs, r_int)
    r_own = r_sep - _mv(f.a.transpose(-1, -2), R[:, m - 2])
    r_back = _mv(f.b_prev, R[:, 0])
    rr_p = r_own - mesh.shift(r_back, -1)

    # the reduced (P, nb) separator system, gathered and solved on every
    # rank: P tiny blocks, cheaper than a second round of collectives
    S_all = mesh.all_gather(f.S).transpose(0, 1)
    C_all = mesh.all_gather(f.C).transpose(0, 1)
    rr_all = mesh.all_gather(rr_p).transpose(0, 1)
    Lr, Cr = cuda_kkt.tridiag_factor(S_all, C_all[:, : P - 1])
    u_sep_all = cuda_kkt.tridiag_solve(Lr, Cr, rr_all)

    p = mesh.rank
    u_sep = u_sep_all[:, p]
    u_prev = (u_sep_all[:, p - 1] if p > 0 else torch.zeros_like(u_sep))
    u_int = (R - torch.einsum("bkij,bj->bki", f.Ya, u_sep)
             - torch.einsum("bkij,bj->bki", f.Zb, u_prev))
    return torch.cat([u_int, u_sep[:, None]], dim=1)


def ksharded_factor(D: torch.Tensor, O: torch.Tensor) -> KShardedFactors:
    """Factor the SPD block-tridiagonal systems D (B, N, nb, nb), O (B, N-1,
    nb, nb) with the block axis split over the installed mesh's ranks. N is
    padded to a multiple of the world size (>= 3 blocks a rank), so any
    N >= 2 works at any world size."""
    mesh = _installed(D)
    N = D.shape[1]
    D_pad, O_pad, _, m = _pad_chain(D, O, mesh.world)
    Ls, Cs, Ya, Zb, a, b_prev, S, C = _factor_body(
        _tile(D_pad, mesh, m), _tile(O_pad, mesh, m), mesh)
    return KShardedFactors(Ls=Ls, Cs=Cs, Ya=Ya, Zb=Zb, a=a, b_prev=b_prev,
                           S=S, C=C, n_orig=N, m=m, nshards=mesh.world)


def ksharded_solve(f: KShardedFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M u = rhs (B, N, nb) against ``ksharded_factor``'s output. The
    installed mesh must have the world size the factors were built with;
    every rank returns the same whole u."""
    mesh = _installed(rhs)
    if mesh.world != f.nshards:
        raise ValueError(
            f"ksharded_solve: the installed mesh has {mesh.world} ranks but "
            f"the factors were built with {f.nshards}: set_kkt_mesh must not "
            "change between factor and solve")
    Bn, N, nb = rhs.shape
    N_pad = f.m * mesh.world
    if N_pad > N:
        rhs = torch.cat([rhs, rhs.new_zeros((Bn, N_pad - N, nb))], dim=1)
    piece = _solve_body(f, _tile(rhs, mesh, f.m), mesh)
    u = mesh.all_gather(piece).transpose(0, 1).reshape(Bn, N_pad, nb)
    return u[:, :N]


def solve_blocktridiag_ksharded(D: torch.Tensor, O: torch.Tensor,
                                rhs: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One factor and one solve on ``mesh`` (for tests and standalone use);
    the installed mesh is restored afterwards."""
    prev = get_kkt_mesh()
    set_kkt_mesh(mesh)
    try:
        return ksharded_solve(ksharded_factor(D, O), rhs)
    finally:
        set_kkt_mesh(prev)
