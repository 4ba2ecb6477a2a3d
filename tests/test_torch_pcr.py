"""The PCR Schur solve of the replan path's KKT systems (``ops/ipm.py``).

PCR is not backward stable, so the port reduces in float64 whatever the
system's dtype (``ipm._pcr_factor`` says why): a float32 system's answer is
the float64 answer for its (float32) inputs, rounded. No JAX here; the
float64 reduction itself is held against the JAX package's in
tests/test_torch_replan.py.
"""

import numpy as np
import pytest
import torch

from successiveconvexification_tpu_torch.ops import ipm

U32 = 2.0 ** -24


def _system(seed, N=8, n=13):
    """M = R'R with R block upper bidiagonal: SPD, block tridiagonal,
    condition about 1e4 (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    R = np.zeros((N * n, N * n))
    for i in range(N):
        R[i * n:(i + 1) * n, i * n:(i + 1) * n] = (
            np.eye(n) + 0.1 * rng.standard_normal((n, n)))
        if i + 1 < N:
            R[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = (
                0.3 * rng.standard_normal((n, n)))
    M = R.T @ R
    D = np.stack([M[i * n:(i + 1) * n, i * n:(i + 1) * n] for i in range(N)])
    O = np.stack([M[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n]
                  for i in range(N - 1)])
    return M, D[None], O[None], rng


@pytest.mark.parametrize("m", [None, 3], ids=["vector", "matrix"])
def test_float32_system_is_reduced_in_float64(m):
    """The float32 answer is bitwise the float64 reduction's answer for the
    float32 inputs, rounded; the factors are float64."""
    _, D, O, rng = _system(0)
    r = rng.standard_normal(D.shape[:2] + (D.shape[-1],) + (() if m is None
                                                            else (m,)))
    D32, O32, r32 = (torch.tensor(a, dtype=torch.float32) for a in (D, O, r))
    f = ipm._pcr_factor(D32, O32)
    assert f[1].dtype == torch.float64
    u = ipm._pcr_solve(f, r32)
    want = ipm._pcr_back(ipm._pcr_reduce(D32.double(), O32.double()),
                         r32.double()).float()
    assert u.dtype == torch.float32 and u.shape == r32.shape
    assert torch.equal(u, want)


def test_float32_residual_within_rounding():
    """Normwise residual of the float32 answer against the float64 system
    within 4 float32 ulps: one for rounding the inputs, one for rounding
    the answer, and the float64 reduction's own error (1e-14 here). A
    reduction carried out in float32 leaves about 160."""
    M, D, O, rng = _system(1)
    r = rng.standard_normal(D.shape[:2] + (D.shape[-1],))
    D32, O32, r32 = (torch.tensor(a, dtype=torch.float32) for a in (D, O, r))
    u = ipm._pcr_solve(ipm._pcr_factor(D32, O32), r32).double().numpy()
    u, rv = u.reshape(-1), r32.double().numpy().reshape(-1)
    res = np.linalg.norm(M @ u - rv) / (np.linalg.norm(M, 2)
                                        * np.linalg.norm(u))
    assert res <= 4 * U32


def test_float64_system_unchanged():
    """A float64 system goes through the same reduction untouched."""
    _, D, O, rng = _system(2)
    r = rng.standard_normal(D.shape[:2] + (D.shape[-1],))
    D64, O64, r64 = (torch.tensor(a) for a in (D, O, r))
    u = ipm._pcr_solve(ipm._pcr_factor(D64, O64), r64)
    assert u.dtype == torch.float64
    assert torch.equal(u, ipm._pcr_back(ipm._pcr_reduce(D64, O64), r64))
