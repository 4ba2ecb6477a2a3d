"""The frozen work functions give the kernel table's figures at its shapes
(PERF.md section 6: bytes of kernels 1-3 at B=256, K=50; discretize at
12,544 rocket lanes and 7,424 point-mass lanes)."""

import pytest
import torch

from harness import work

B, K = 256, 50


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_fused_factor_bytes():
    rng = torch.tensor([[3, 6], [6, 9], [9, 13], [13, 17], [17, 21],
                        [21, 38]], dtype=torch.int32)
    args = (_t(B, K, 38, 17), _t(B, K, 38), _t(B, K, 38), _t(B, K, 6),
            _t(B, K, 17), _t(B, K - 1, 13, 17), _t(B, K - 1, 13, 17),
            _t(B, K - 1, 13), rng)
    nbytes, _ = work.work("fused_factor", args, 4)
    assert nbytes / 1e6 == pytest.approx(92.7, abs=0.05)


def test_kkt_solve_bytes():
    nbytes, _ = work.work("tridiag_solve", (_t(B, K - 1, 13, 13),
                                            _t(B, K - 1, 13, 13),
                                            _t(B, K - 1, 13)), 4)
    assert nbytes / 1e6 == pytest.approx(14.35, abs=0.005)
    nbytes, _ = work.work("cho_solve_vec", (_t(B, K, 17, 17), _t(B, K, 17)), 4)
    assert nbytes / 1e6 == pytest.approx(9.57, abs=0.005)


def _disc_args(model, params, lanes_b, k):
    X = _t(lanes_b, k, model.nx)
    U = _t(lanes_b, k, model.nu)
    pb = params.map(lambda v, tail: v.expand((lanes_b,) + v.shape))
    return (model, pb, X, U, _t(lanes_b), 8, True)


def test_discretize_work():
    import successiveconvexification_tpu_torch as P
    from successiveconvexification_tpu_torch.models import pointmass3dof as pm
    from successiveconvexification_tpu_torch.models import rocket6dof as rk

    nbytes, flops = work.work("discretize_lanes", _disc_args(
        P.rocket6dof_model(), rk.default_params(), B, K), 4)
    assert B * (K - 1) == 12544
    assert flops / 1e9 == pytest.approx(7.94, abs=0.005)
    assert nbytes / 1e6 == pytest.approx(17.0, abs=0.05)
    _, flops = work.work("discretize_lanes", _disc_args(
        P.pointmass3dof_model(), pm.default_params(), B, 30), 4)
    assert B * 29 == 7424
    assert flops / 1e9 == pytest.approx(0.694, abs=0.0005)


def test_bound_takes_the_larger_side():
    args = (_t(B, K - 1, 13, 13), _t(B, K - 1, 13, 13), _t(B, K - 1, 13))
    nbytes, flops = work.work("tridiag_solve", args, 4)
    assert work.bound_s("tridiag_solve", args, 4) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))
