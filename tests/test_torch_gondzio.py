"""The port's Gondzio centrality correctors against the JAX package's.

``IPMConfig.gondzio_correctors=g`` adds g unrefined KKT solves an IPM
iteration on the iteration's factors, kept per lane only where they lengthen
the step. The subproblems are the JAX package's ``prob3`` and ``prob6``
(``tests/test_ipm_structured.py``: the point mass at K=8 and the rocket at
K=7 about their initial guesses, 8 substeps, a soft trust region of radius
2, f64), each also with its thrust direction penalized (``penalized_dirs``:
rank-one quadratic rows, so ``scan`` takes the unfused route). Both
packages build them from the same default params.

Held against JAX's ``ipm_solve`` at g=2: ``prob3`` on the fused ``scan``,
on ``pcr`` and, penalized, on the unfused ``scan``; equal IPM iteration
counts, w within atol 1e-6 and sig within 1e-8 (the gate of
``tests/test_torch_ksharded.py``). Each JAX solve is one jitted graph in a
child process of its own, the three side by side while this process runs
the port. A JAX IPM graph of the point mass takes about 18 s to trace and
compile on one CPU core, the rocket's about 35 s after 12 s of eager
assembly, so the rocket is held to the JAX test's own gate alone and the
file stays under a minute. Every case, the rocket's too, is held to that gate
against g=0: both converge, g=2 takes at most two more iterations, w
within atol 5e-6 (``tests/test_ipm_structured.py:185-196``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from successiveconvexification_tpu_torch.config import IPMConfig, ScvxConfig
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.models.base import safe_norm
from successiveconvexification_tpu_torch.ops import ipm as tipm
from successiveconvexification_tpu_torch.ops import socp as tsocp
from successiveconvexification_tpu_torch.ops.discretize import discretize
from successiveconvexification_tpu_torch.utils.tree import tree_map

from torch_helpers import finish, kill, spawn

F64 = torch.float64
G = 2
W_DIR = 1.0
TR = 2.0
# (route, problem) held against JAX, and every (route, problem) of the port
JAX_CASES = [("scan", "prob3"), ("pcr", "prob3"), ("scan", "prob3_penalized")]
CASES = [(kkt, p) for p in ("prob3", "prob6") for kkt in ("scan", "pcr")]
CASES += [("scan", "prob3_penalized"), ("scan", "prob6_penalized")]
K = {"prob3": 8, "prob6": 7}
IPM = dict(max_iters=60, tol_gap=1e-8, tol_feas=1e-8, refine_steps=2)

_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from successiveconvexification_tpu.config import IPMConfig, ScvxConfig
from successiveconvexification_tpu.models import pointmass3dof as pm
from successiveconvexification_tpu.models.base import safe_norm
from successiveconvexification_tpu.ops import ipm, socp
from successiveconvexification_tpu.ops.discretize import discretize

kkt, name, K, g, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
ipm_kw = json.loads(sys.argv[6])
w_dir = float(sys.argv[7])
tr = float(sys.argv[8])
model = pm.pointmass3dof_model()
if name.endswith("_penalized"):
    def dirs(params, xk, uk):
        return jnp.concatenate([jnp.zeros_like(xk), uk / safe_norm(uk)])[None]
    model = dataclasses.replace(model, name="pointmass3dof_thrust",
                                penalized_dirs=dirs)
else:
    w_dir = 0.0
params = pm.default_params(dtype=jnp.float64)
cfg = dataclasses.replace(ScvxConfig(), tr_mode="soft", w_dir_penalty=w_dir)
X, U, sig = model.initial_guess(params, K)
d = socp.assemble(model, cfg, params, discretize(model, params, X, U, sig,
                                                 substeps=8),
                  X, U, sig, jnp.asarray(tr, jnp.float64), free_final_time=True)
icfg = IPMConfig(kkt_solver=kkt, gondzio_correctors=g, **ipm_kw)
st = jax.jit(lambda d: ipm.ipm_solve(d, icfg))(d)
np.savez(out, w=np.asarray(st.x.w), sig=np.asarray(st.x.sig),
         iters=np.asarray(st.iters), converged=np.asarray(st.converged),
         Q_r1=np.asarray(d.Q_r1), c_w=np.asarray(d.c_w))
"""


def _thrust_dirs(params, xk, uk):
    """(..., 1, nx+nu): the unit thrust direction at each node."""
    n = uk / safe_norm(uk)[..., None]
    return torch.cat([torch.zeros_like(xk), n], dim=-1)[..., None, :]


def subproblem(name: str):
    """``name`` assembled by the port, B=1, from the default params."""
    mod = tpm if name.startswith("prob3") else trk
    model = tpm.pointmass3dof_model() if mod is tpm else trk.rocket6dof_model()
    w_dir = 0.0
    if name.endswith("_penalized"):
        model = dataclasses.replace(model, name=model.name + "_thrust",
                                    penalized_dirs=_thrust_dirs)
        w_dir = W_DIR
    p = mod.default_params(F64).map(lambda v, tail: v[None])
    X, U, sig = model.initial_guess(p, K[name.split("_")[0]])
    cfg = dataclasses.replace(ScvxConfig(), tr_mode="soft",
                              w_dir_penalty=w_dir)
    return tsocp.assemble(model, cfg, p, discretize(model, p, X, U, sig,
                                                    substeps=8),
                          X, U, sig, torch.full((1,), TR, dtype=F64),
                          free_final_time=True)


def _cfg(kkt: str, g: int) -> IPMConfig:
    """The JAX test's settings (tests/test_ipm_structured.py:187-190)."""
    return IPMConfig(kkt_solver=kkt, gondzio_correctors=g, **IPM)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """JAX's solves at g=2 (children) and every case's port solves at g=0
    and g=2 (this process, meanwhile)."""
    out = tmp_path_factory.mktemp("gondzio")
    script = out / "worker.py"
    script.write_text(_WORKER)
    npz = {c: out / f"{c[0]}_{c[1]}.npz" for c in JAX_CASES}
    procs = spawn([[str(script), kkt, name, str(K["prob3"]), str(G),
                    str(npz[kkt, name]), json.dumps(IPM), str(W_DIR), str(TR)]
                   for kkt, name in JAX_CASES])
    try:
        probs = {name: subproblem(name) for name in
                 {name for _, name in CASES}}
        port = {(kkt, name): {g: tipm.ipm_solve(probs[name], _cfg(kkt, g))
                              for g in (0, G)} for kkt, name in CASES}
        lanes = _per_lane(probs["prob6"])
        finish(procs, timeout=240)
    finally:
        kill(procs)
    jax_out = {}
    for c, q in npz.items():
        with np.load(q) as z:
            jax_out[c] = dict(z)
    return probs, port, jax_out, lanes


def _per_lane(d):
    """prob6 and a copy with every objective term doubled, solved at g=2 in
    one batch and each alone."""
    d2 = d._replace(c_w=2.0 * d.c_w, c_p=2.0 * d.c_p, c_q=2.0 * d.c_q,
                    c_sig=2.0 * d.c_sig)
    cfg = _cfg("scan", G)
    pair = tipm.ipm_solve(tree_map(lambda a, b: torch.cat([a, b]), d, d2), cfg)
    return pair, [tipm.ipm_solve(one, cfg) for one in (d, d2)]


def test_penalized_subproblems_take_the_unfused_route(solves):
    """The penalized subproblems have one rank-one row a node, JAX's rows
    within f64 round-off, so ``scan`` factors without the fused kernel; the
    others have none."""
    probs, _, jax_out, _ = solves
    for name, d in probs.items():
        assert d.Q_r1.shape[2] == (1 if name.endswith("_penalized") else 0)
    for (_, name), j in jax_out.items():
        np.testing.assert_allclose(probs[name].Q_r1[0].numpy(), j["Q_r1"],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(probs[name].c_w[0].numpy(), j["c_w"],
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kkt,name", JAX_CASES)
def test_correctors_match_jax(solves, kkt, name):
    """At g=2 the port's ``ipm_solve`` converges where JAX's does, in as many
    IPM iterations, with w within atol 1e-6 and sig within 1e-8."""
    _, port, jax_out, _ = solves
    j, t = jax_out[kkt, name], port[kkt, name][G]
    assert bool(j["converged"]) and bool(t.converged[0])
    assert int(t.iters[0]) == int(j["iters"])
    np.testing.assert_allclose(t.x.w[0].numpy(), j["w"], rtol=0, atol=1e-6)
    assert abs(float(t.x.sig[0]) - float(j["sig"])) <= 1e-8


@pytest.mark.parametrize("kkt,name", CASES)
def test_correctors_keep_the_solution(solves, kkt, name):
    """The JAX test's gate on the port: g=2 and g=0 both converge, g=2
    takes at most two more IPM iterations, and w agrees within atol 5e-6."""
    st0, st2 = solves[1][kkt, name][0], solves[1][kkt, name][G]
    assert bool(st0.converged[0]) and bool(st2.converged[0])
    assert int(st2.iters[0]) <= int(st0.iters[0]) + 2
    np.testing.assert_allclose(st2.x.w.numpy(), st0.x.w.numpy(), atol=5e-6)


def test_correctors_are_per_lane(solves):
    """Two lanes of different subproblems in one batch (prob6 and a copy
    with every objective term doubled) are each solved as alone: the clip
    bounds, the target step and the keep-or-drop choice are the lane's own.
    Equal iteration counts, w within atol 1e-9."""
    pair, alone = solves[3]
    for i, one in enumerate(alone):
        assert int(pair.iters[i]) == int(one.iters[0])
        np.testing.assert_allclose(pair.x.w[i].numpy(), one.x.w[0].numpy(),
                                   rtol=0, atol=1e-9)
