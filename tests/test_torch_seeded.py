"""The port's nominal-seeded sweep (``solve_batch_seeded``) against JAX's.

One cold nominal solve, every dispersed lane warm-started from it with the
STM correction (``scvx_warm_start``), then the compacting sweep. The
nominal is solved once by the port on the CPU, and the same numpy (X, U,
sigma) is handed to both packages as ``nominal_solution``; the dispersions
are made with numpy from a seed. f64, K=8, 4 substeps, Ruiz on every solve
(as the f64 comparisons run, ROADMAP Queue 3). The JAX side compiles one
bucket of its compacting sweep, with the IPM's warm start off so that it
holds one SCvx graph (with it on, a ``lax.cond`` compiles two); the
seeded lanes' warm start is the SCvx-level one either way. The JAX side
runs in a thread beside the port's own solves.
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.parallel import batch as jbatch

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.parallel import batch as tbatch

F64 = torch.float64
K, B = 8, 3


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


def _cfg_dict():
    # the SCvx cap 40: at K=8 one cold lane takes 30 iterations
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=K, substeps=4),
        ipm=J.IPMConfig(max_iters=25, equilibrate_cold_only=False,
                        warm_start=False),
        scvx=dataclasses.replace(J.ScvxConfig(), max_iters=40)).to_dict()


def _params_np(seed, batch, r_std=0.15, v_std=0.08, m_frac_std=0.02):
    """Dispersions of the default scenario with test_seeded.py's stds."""
    base = jrk.default_params(jnp.float64)
    rng = np.random.default_rng(seed)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (batch,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] + r_std * rng.standard_normal((batch, 3))
    d["v_init"] = d["v_init"] + v_std * rng.standard_normal((batch, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + m_frac_std * rng.standard_normal(batch))
    return d


def test_default_nominal_is_the_per_field_mean(monkeypatch):
    """With no ``nominal_params`` the nominal solved is the mean of every
    params field over the batch axis (against numpy), on the params' device
    in the config's dtype."""
    d = _params_np(11, 5)
    seen = {}

    class Stop(Exception):
        pass

    def fake_solve(model, params, cfg, device=None):
        seen["params"], seen["device"] = params, device
        raise Stop

    monkeypatch.setattr(tbatch, "scvx_solve", fake_solve)
    with pytest.raises(Stop):
        T.solve_batch_seeded(T.rocket6dof_model(),
                             trk.params_from_numpy(d, dtype=torch.float32),
                             T.SolverConfig.from_dict(_cfg_dict()),
                             device="cpu")
    p = seen["params"]
    assert p.batch_shape == () and p.dtype == F64
    assert torch.device(seen["device"]).type == "cpu"
    for k, v in d.items():
        np.testing.assert_allclose(_np(getattr(p, k)),
                                   np.float32(v).astype(np.float64).mean(0),
                                   rtol=1e-14, err_msg=k)


@pytest.fixture(scope="module")
def sweeps():
    """The nominal (port, CPU), then the seeded sweep in both packages from
    it, and the port's cold sweep of the same lanes."""
    cfg_t = T.SolverConfig.from_dict(_cfg_dict())
    cfg_j = J.SolverConfig.from_dict(_cfg_dict())
    mt, mj = trk.rocket6dof_model(), jrk.rocket6dof_model()
    d = _params_np(3, B)
    pt = trk.params_from_numpy(d, dtype=F64)
    pj = jrk.Rocket6DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})
    nom = T.scvx_solve(mt, trk.default_params(F64), cfg_t, device="cpu")
    assert bool(nom.converged[0])
    nominal = tuple(_np(a[0]) for a in (nom.X, nom.U, nom.sigma))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # min_bucket >= B: no repack, one compiled bucket on the JAX side
        seeded_j = pool.submit(
            jbatch.solve_batch_seeded, mj, pj, cfg_j, min_bucket=4,
            nominal_solution=tuple(jnp.asarray(a) for a in nominal))
        seeded_t = T.solve_batch_seeded(mt, pt, cfg_t, nominal_solution=nominal,
                                        min_bucket=4, device="cpu")
        cold_t = T.solve_batch(mt, pt, cfg_t, device="cpu")
        return seeded_t, seeded_j.result(), cold_t, cfg_t


def test_seeded_sweep_matches_jax(sweeps):
    """Identical iteration counts and converged flags, sigma within 1e-6
    relative (per-lane results depend on the packing at the 1e-8 level,
    ROADMAP Queue 3)."""
    st, sj, _, _ = sweeps
    for f in ("iterations", "converged"):
        np.testing.assert_array_equal(_np(getattr(st, f)),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    np.testing.assert_allclose(_np(st.sigma), np.asarray(sj.sigma), rtol=1e-6)


def test_seeded_sweep_quality_gates(sweeps):
    """The JAX package's ``test_seeded.py`` gates, on the port against its
    own cold sweep of the same lanes: every lane converges both ways, the
    seeded lanes meet the feasibility tolerance, sigma agrees within 5e-2,
    and the seeded lanes need strictly fewer iterations on the mean."""
    st, _, cold, cfg = sweeps
    assert bool(cold.converged.all()) and bool(st.converged.all())
    assert float(st.defect_nl.max()) < cfg.scvx.conv_tol_feas
    assert float((st.sigma - cold.sigma).abs().max()) < 5e-2, (st.sigma,
                                                               cold.sigma)
    assert float(st.iterations.double().mean()) < float(
        cold.iterations.double().mean()), (st.iterations, cold.iterations)
