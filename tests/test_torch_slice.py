"""The port's batched SCvx iteration against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
first iteration starts from ``scvx_init``: its carry is invalid (gap = inf),
so the cold IPM init and Ruiz equilibration run. The second is warm: every
lane's carry is valid and warm-starts the IPM. Both iterations take the
general branch (``assume_warm_valid=False``) on both sides, so the JAX side
compiles once. f64 on both sides; X, U and sigma agree within 1e-8 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.ops import scvx as jscvx

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import rocket6dof as trk

K, SUBSTEPS, B = 6, 2, 2
RTOL = 1e-8


def _params_np(seed, batch):
    """Dispersed rocket params as numpy arrays (both packages read these)."""
    base = jrk.default_params(jnp.float64)
    rng = np.random.default_rng(seed)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (batch,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] + 0.2 * rng.standard_normal((batch, 3))
    d["v_init"] = d["v_init"] + 0.1 * rng.standard_normal((batch, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + 0.03 * rng.standard_normal(batch))
    return d


def _jax_params(d):
    return jrk.Rocket6DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})


def _close(a_t, a_j, name):
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j),
                               rtol=RTOL, atol=RTOL, err_msg=name)


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    try:
        yield _run()
    finally:
        torch.set_num_threads(threads)


def _run():
    cfg_j = J.SolverConfig(dtype="float64",
                           disc=J.DiscretizationConfig(K=K, substeps=SUBSTEPS))
    cfg_t = T.SolverConfig.from_dict(cfg_j.to_dict())
    d = _params_np(0, B)
    pj = _jax_params(d)
    pt = trk.params_from_numpy(d, device="cpu", dtype=torch.float64)
    mj = J.rocket6dof_model()
    mt = T.rocket6dof_model()

    sj = [jax.jit(jax.vmap(lambda p: jscvx.scvx_init(mj, p, cfg_j)))(pj)]
    st = [T.scvx_init(mt, pt, cfg_t)]
    step = jax.jit(jax.vmap(lambda p, s: jscvx.scvx_iteration(mj, p, cfg_j, s)))
    valid = []
    for _ in range(2):
        valid.append(bool(np.all(np.isfinite(np.asarray(sj[-1].ipm_carry.gap)))))
        sj.append(step(pj, sj[-1]))
        st.append(T.scvx_iteration(mt, pt, cfg_t, st[-1]))
    # the JAX state after iteration 1, carried across with its IPM carry
    carried = trk.state_from_numpy(jax.tree.map(np.asarray, sj[1]),
                                   device="cpu", dtype=torch.float64)
    st.append(T.scvx_iteration(mt, pt, cfg_t, carried))
    return sj, st, valid


def test_init_matches(runs):
    sj, st, _ = runs
    for f in ("X", "U", "sigma", "obj_nl", "defect_nl", "viol_nl"):
        _close(getattr(st[0], f), getattr(sj[0], f), f)


@pytest.mark.parametrize("it", [1, 2])
def test_iteration_matches(runs, it):
    sj, st, valid = runs
    assert valid == [False, True]   # cold first iteration, warm second
    a, b = st[it], sj[it]
    for f in ("X", "U", "sigma"):
        _close(getattr(a, f), getattr(b, f), f)
    for f in ("accepted", "converged", "n_accept", "n_reject", "n_bump",
              "iterations", "ipm_iters"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert np.all(np.isfinite(a.ipm_carry.gap.numpy())) == \
        np.all(np.isfinite(np.asarray(b.ipm_carry.gap)))


def test_iteration_from_carried_jax_state(runs):
    """state_from_numpy carries a JAX ScvxState (IPM carry included) into
    the port; one port iteration from it lands on JAX's iteration 2."""
    sj, st, _ = runs
    for f in ("X", "U", "sigma"):
        _close(getattr(st[3], f), getattr(sj[2], f), f)
    np.testing.assert_array_equal(st[3].ipm_iters.numpy(),
                                  np.asarray(sj[2].ipm_iters))


def test_entry_point_needs_card_or_cpu():
    """device=None means the card: without one the entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pt = trk.params_from_numpy(_params_np(1, 1), device="cpu",
                               dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.solve_batch(T.rocket6dof_model(), pt, T.SolverConfig())
