"""The port's K-sharded KKT backend (``kkt_solver="ksharded"``) against the
JAX package's.

The block-tridiagonal Schur system is split along K over gloo ranks on the
CPU (child processes; 1, 2 and 4 of them, all started at once). Each rank
solves the JAX package's ``tests/test_parallel.py`` systems (N = 48, 49
and 10 blocks of 7, here a batch of 3 lanes); the 2-rank run also solves
a K=12 rocket subproblem with the IPM on ``ksharded``, without and with
two Gondzio correctors an iteration. The parent holds them against the
port's local solve, against JAX's ``solve_blocktridiag_ksharded`` on a
mesh of as many virtual devices, and against JAX's ``ipm_solve`` with
``ksharded`` on a 2-device mesh (with the correctors, in a child of its
own), while the children run. Every rank must hold the same bits, and no
rank may import JAX.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as JP

import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import rocket6dof as jrk
from successiveconvexification_tpu.ops import ipm as jipm
from successiveconvexification_tpu.ops import socp as jsocp
from successiveconvexification_tpu.ops.discretize import discretize as jdisc
from successiveconvexification_tpu.ops.scvx import scvx_init as jinit
from successiveconvexification_tpu.parallel import kkt_sharded as jks

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.ops import cuda_kkt, ipm as tipm
from successiveconvexification_tpu_torch.ops import smallla
from successiveconvexification_tpu_torch.parallel import kkt_sharded as ks
from successiveconvexification_tpu_torch.parallel import mesh as mesh_lib
from successiveconvexification_tpu_torch.utils.tree import tree_leaves

from torch_helpers import finish, free_port, kill, spawn

NS = (48, 49, 10)        # tests/test_parallel.py: divides 8, K-1, padded
NB, LANES = 7, 3
WORLDS = (1, 2, 4)
IPM_K, IPM_WORLD = 12, 2
GONDZIO = 2               # the correctors of the second ksharded IPM solve
CPU = torch.device("cpu")

_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
GONDZIO = int(sys.argv[5])
torch.set_num_threads(1)
import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.ops import discretize, ipm, socp
from successiveconvexification_tpu_torch.parallel import kkt_sharded as ks, mesh as M
from successiveconvexification_tpu_torch.utils.tree import tree_leaves

mesh = M.init_distributed(f"localhost:{port}", world, rank, "cpu")
try:
    arrs = {}
    with np.load(out + "/systems.npz") as z:
        for N in json.load(open(out + "/ns.json")):
            D, O, r = (torch.as_tensor(z[f"{k}{N}"]) for k in "DOr")
            arrs[f"u{N}"] = ks.solve_blocktridiag_ksharded(D, O, r, mesh).numpy()
    if world == 2:
        cfg = T.SolverConfig.from_dict(json.load(open(out + "/cfg.json")))
        with np.load(out + "/params.npz") as z:
            p = trk.params_from_numpy({k: z[k][None] for k in z.files})
        model = T.rocket6dof_model()
        st = T.scvx_init(model, p, cfg)
        d = socp.assemble(model, cfg.scvx, p, discretize.discretize(
            model, p, st.X, st.U, st.sigma, cfg.disc.substeps), st.X, st.U,
            st.sigma, st.tr_radius, True, st.penalty_scale)
        ks.set_kkt_mesh(mesh)
        for g in (0, GONDZIO):
            sol = ipm.ipm_solve(d, dataclasses.replace(
                cfg.ipm, kkt_solver="ksharded", gondzio_correctors=g))
            pre = "" if g == 0 else f"g{g}_"
            for i, t in enumerate(tree_leaves(sol)):
                arrs[f"{pre}ipm_{i}"] = t.numpy()
            arrs.update({f"{pre}w": sol.x.w.numpy(),
                         f"{pre}sig": sol.x.sig.numpy(),
                         f"{pre}converged": sol.converged.numpy(),
                         f"{pre}iters": sol.iters.numpy()})
    arrs["jax_imported"] = np.asarray(any(
        m == "jax" or m.startswith(("jax.", "successiveconvexification_tpu."))
        or m == "successiveconvexification_tpu" for m in sys.modules))
    np.savez(f"{out}/rank{rank}.npz", **arrs)
finally:
    M.destroy_process_group()
"""


# JAX's ksharded IPM solve with Gondzio correctors on a 2-device mesh, in a
# child of its own (its graph compiles while the parent's do)
_JAX_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import Mesh
import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import rocket6dof as rk
from successiveconvexification_tpu.ops import ipm, socp
from successiveconvexification_tpu.ops.discretize import discretize
from successiveconvexification_tpu.ops.scvx import scvx_init
from successiveconvexification_tpu.parallel import kkt_sharded as ks

cfg = J.SolverConfig.from_dict(json.load(open(sys.argv[1])))
icfg = dataclasses.replace(cfg.ipm, kkt_solver="ksharded",
                           gondzio_correctors=int(sys.argv[2]))
model = J.rocket6dof_model()


def solve(p):
    st = scvx_init(model, p, cfg)
    d = socp.assemble(model, cfg.scvx, p, discretize(
        model, p, st.X, st.U, st.sigma, substeps=cfg.disc.substeps),
        st.X, st.U, st.sigma, st.tr_radius, True, st.penalty_scale)
    return ipm.ipm_solve(d, icfg)


ks.set_kkt_mesh(Mesh(np.asarray(jax.devices()[:int(sys.argv[3])]), ("kkt",)),
                "kkt")
sol = jax.jit(solve)(rk.default_params(jnp.float64))
np.savez(sys.argv[4], w=np.asarray(sol.x.w), sig=np.asarray(sol.x.sig),
         iters=np.asarray(sol.iters), converged=np.asarray(sol.converged))
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


def _systems():
    """The SPD block-tridiagonal systems of tests/test_parallel.py's gate
    (its construction, seeded), a batch of LANES lanes each."""
    rng = np.random.default_rng(0)
    out = {}
    for N in NS:
        O = rng.standard_normal((LANES, N - 1, NB, NB))
        Ds = rng.standard_normal((LANES, N, NB, NB))
        out[f"D{N}"] = Ds @ np.swapaxes(Ds, -1, -2) + 4.0 * NB * np.eye(NB)
        out[f"O{N}"] = O
        out[f"r{N}"] = rng.standard_normal((LANES, N, NB))
    return out


def _cfg():
    """tests/test_parallel.py:147's subproblem settings at K=12."""
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=IPM_K, substeps=3),
        ipm=J.IPMConfig(max_iters=45, refine_steps=1))


def _params_np():
    base = jrk.default_params(jnp.float64)
    return {f.name: np.asarray(getattr(base, f.name))
            for f in dataclasses.fields(base)}


def _jmesh(world):
    return JMesh(np.asarray(jax.devices()[:world]), ("kkt",))


def _jax_ksharded_solve(cfg, params):
    """JAX's subproblem assembled and solved with ``ksharded`` under the
    installed mesh: one jitted graph."""
    model = J.rocket6dof_model()
    icfg = dataclasses.replace(cfg.ipm, kkt_solver="ksharded")
    st = jinit(model, params, cfg)
    d = jsocp.assemble(
        model, cfg.scvx, params,
        jdisc(model, params, st.X, st.U, st.sigma, substeps=cfg.disc.substeps),
        st.X, st.U, st.sigma, st.tr_radius, True, st.penalty_scale)
    return jipm.ipm_solve(d, icfg)


def _port_subproblem(cfg):
    from successiveconvexification_tpu_torch.models import rocket6dof as trk
    from successiveconvexification_tpu_torch.ops import discretize, socp

    p = trk.params_from_numpy({k: v[None] for k, v in _params_np().items()})
    model = T.rocket6dof_model()
    st = T.scvx_init(model, p, cfg)
    return socp.assemble(model, cfg.scvx, p, discretize.discretize(
        model, p, st.X, st.U, st.sigma, cfg.disc.substeps), st.X, st.U,
        st.sigma, st.tr_radius, True, st.penalty_scale)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's outputs for world sizes 1, 2 and 4, JAX's sharded
    solves at the same shard counts and its ksharded IPM solve on 2
    devices; the JAX work runs while the ranks do."""
    out = tmp_path_factory.mktemp("ksharded")
    systems = _systems()
    cfg_d = _cfg().to_dict()
    dirs = {}
    for world in WORLDS:
        d = out / f"w{world}"
        d.mkdir()
        np.savez(d / "systems.npz", **systems)
        (d / "ns.json").write_text(json.dumps(NS))
        (d / "cfg.json").write_text(json.dumps(cfg_d))
        np.savez(d / "params.npz", **_params_np())
        dirs[world] = d
    script = out / "worker.py"
    script.write_text(_WORKER)
    jax_script = out / "jax_worker.py"
    jax_script.write_text(_JAX_WORKER)
    argvs = [[str(jax_script), str(dirs[IPM_WORLD] / "cfg.json"),
              str(GONDZIO), str(IPM_WORLD), str(out / "jax_gondzio.npz")]]
    for world in WORLDS:
        port = free_port()
        argvs += [[str(script), str(r), str(world), str(port),
                   str(dirs[world]), str(GONDZIO)] for r in range(world)]
    procs = spawn(argvs)
    try:
        jax_u = {}
        for world in WORLDS:
            for N in NS:
                jax_u[world, N] = np.stack([np.asarray(
                    jks.solve_blocktridiag_ksharded(
                        jnp.asarray(systems[f"D{N}"][i]),
                        jnp.asarray(systems[f"O{N}"][i]),
                        jnp.asarray(systems[f"r{N}"][i]),
                        mesh=_jmesh(world), axis="kkt"))
                    for i in range(LANES)])
        cfg = _cfg()
        jks.set_kkt_mesh(_jmesh(IPM_WORLD), "kkt")
        try:
            jsol = jax.jit(lambda p: _jax_ksharded_solve(cfg, p))(
                jrk.default_params(jnp.float64))
            jsol = jax.tree.map(np.asarray, jsol)
        finally:
            jks.set_kkt_mesh(None)
        finish(procs, timeout=150)
    finally:
        kill(procs)
    got = {}
    for world in WORLDS:
        for r in range(world):
            with np.load(dirs[world] / f"rank{r}.npz") as z:
                got[world, r] = dict(z)
    with np.load(out / "jax_gondzio.npz") as z:
        jsol_g = dict(z)
    return systems, got, jax_u, jsol, jsol_g


def test_pad_chain_and_tiles_match_jax():
    """``_pad_chain``'s blocks a rank and padded length are JAX's for N in
    2..60 and 1..8 shards (JAX's traced, not run), its padded blocks are
    JAX's at a few of them, and rank p's tile is the one JAX's ``P("kkt")``
    gives device p (no processes)."""
    rng = np.random.default_rng(3)
    devs = jax.devices()
    nb = 2
    for N in range(2, 61):
        D = rng.standard_normal((N, nb, nb))
        O = rng.standard_normal((N - 1, nb, nb))
        Dt, Ot = torch.as_tensor(D)[None], torch.as_tensor(O)[None]
        for P in range(1, 9):
            jout = []
            jax.eval_shape(lambda a, b: jout.append(jks._pad_chain(a, b, P)),
                           jax.ShapeDtypeStruct(D.shape, D.dtype),
                           jax.ShapeDtypeStruct(O.shape, O.dtype))
            Dj, Oj, Npj, mj = jout[0]
            Dp, Op, Npt, mt = ks._pad_chain(Dt, Ot, P)
            assert (Npt, mt) == (Npj, mj), (N, P)
            assert (tuple(Dp.shape[1:]), tuple(Op.shape[1:])) == (
                Dj.shape, Oj.shape)
            if N in (2, 10, 49) and P in (1, 3, 8):
                Dj, Oj, _, _ = jks._pad_chain(jnp.asarray(D), jnp.asarray(O), P)
                np.testing.assert_array_equal(Dp[0].numpy(), np.asarray(Dj))
                np.testing.assert_array_equal(Op[0].numpy(), np.asarray(Oj))
            tiles = NamedSharding(JMesh(np.asarray(devs[:P]), ("kkt",)),
                                  JP("kkt")).devices_indices_map((Npj, nb, nb))
            idx = torch.arange(Npt)[None, :, None, None]
            for p in range(P):
                got = ks._tile(idx, mesh_lib.Mesh(p, P, CPU), mt)[0, :, 0, 0]
                assert got.tolist() == list(
                    range(Npj))[tiles[devs[p]][0]], (N, P, p)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_matches_local_and_jax(ranks, world):
    """On ``world`` gloo ranks the substructured solve equals the port's
    local block solve within rtol and atol 1e-9 (JAX's gate), and JAX's
    ``solve_blocktridiag_ksharded`` on as many virtual devices within atol
    1e-12; every rank holds the same u, bit for bit, and no rank imported
    JAX."""
    systems, got, jax_u, _, _ = ranks
    for N in NS:
        D, O, r = (torch.as_tensor(systems[f"{k}{N}"]) for k in "DOr")
        u_ref = smallla.blocktridiag_solve(*smallla.blocktridiag_factor(D, O),
                                           r).numpy()
        u0 = got[world, 0][f"u{N}"]
        np.testing.assert_allclose(u0, u_ref, rtol=1e-9, atol=1e-9,
                                   err_msg=f"N={N}")
        np.testing.assert_allclose(u0, jax_u[world, N], rtol=0, atol=1e-12,
                                   err_msg=f"N={N} against JAX")
        for rank in range(1, world):
            np.testing.assert_array_equal(got[world, rank][f"u{N}"], u0)
    for rank in range(world):
        assert not got[world, rank]["jax_imported"]


def test_ksharded_ipm_matches_scan_and_jax(ranks):
    """A K=12 rocket subproblem (tests/test_parallel.py:147's settings),
    solved by the port's ``ipm_solve`` with ``ksharded`` on 2 gloo ranks,
    matches the port's ``scan`` and JAX's ``ksharded`` on a 2-device mesh:
    converged on all three, w within atol 1e-6 and sig within 1e-8 (JAX's
    gate), the same iteration counts, and the same bits on both ranks."""
    _, got, _, jsol, _ = ranks
    cfg = T.SolverConfig.from_dict(_cfg().to_dict())
    scan = tipm.ipm_solve(_port_subproblem(cfg), cfg.ipm)
    r0, r1 = got[IPM_WORLD, 0], got[IPM_WORLD, 1]
    n_leaves = sum(k.startswith("ipm_") for k in r0)
    assert n_leaves == len(tree_leaves(scan))
    for i in range(n_leaves):
        np.testing.assert_array_equal(r0[f"ipm_{i}"], r1[f"ipm_{i}"])
    assert bool(scan.converged[0]) and bool(r0["converged"][0])
    assert bool(jsol.converged)
    assert int(r0["iters"][0]) == int(scan.iters[0]) == int(jsol.iters)
    for ref in (scan.x.w[0].numpy(), np.asarray(jsol.x.w)):
        np.testing.assert_allclose(r0["w"][0], ref, rtol=0, atol=1e-6)
    for ref in (float(scan.x.sig[0]), float(jsol.x.sig)):
        assert abs(float(r0["sig"][0]) - ref) <= 1e-8


def test_ksharded_ipm_with_correctors_matches_scan_and_jax(ranks):
    """The same subproblem with two Gondzio correctors an iteration (each
    one more ``ksharded_solve`` on both ranks): on 2 gloo ranks it matches
    the port's local ``scan`` at g=2 and JAX's ``ksharded`` at g=2 on a
    2-device mesh: converged on all three, the same iteration counts, w
    within atol 1e-6 and sig within 1e-8, the same bits on both ranks, and
    the JAX test's gate against g=0 (at most two more iterations, w within
    atol 5e-6)."""
    _, got, _, _, jsol = ranks
    cfg = T.SolverConfig.from_dict(_cfg().to_dict())
    scan = tipm.ipm_solve(_port_subproblem(cfg), dataclasses.replace(
        cfg.ipm, gondzio_correctors=GONDZIO))
    r0, r1 = got[IPM_WORLD, 0], got[IPM_WORLD, 1]
    pre = f"g{GONDZIO}_"
    n_leaves = sum(k.startswith(pre + "ipm_") for k in r0)
    assert n_leaves == len(tree_leaves(scan))
    for i in range(n_leaves):
        np.testing.assert_array_equal(r0[f"{pre}ipm_{i}"], r1[f"{pre}ipm_{i}"])
    assert bool(scan.converged[0]) and bool(r0[pre + "converged"][0])
    assert bool(jsol["converged"])
    assert (int(r0[pre + "iters"][0]) == int(scan.iters[0])
            == int(jsol["iters"]))
    for ref in (scan.x.w[0].numpy(), jsol["w"]):
        np.testing.assert_allclose(r0[pre + "w"][0], ref, rtol=0, atol=1e-6)
    for ref in (float(scan.x.sig[0]), float(jsol["sig"])):
        assert abs(float(r0[pre + "sig"][0]) - ref) <= 1e-8
    assert int(r0[pre + "iters"][0]) <= int(r0["iters"][0]) + 2
    np.testing.assert_allclose(r0[pre + "w"], r0["w"], rtol=0, atol=5e-6)


def test_ksharded_refuses_without_its_mesh():
    """No mesh installed: factor and solve raise. A world size changed
    between factor and solve, or a mesh on another device than the
    tensors: the solve raises before any exchange."""
    sy = _systems()
    D, O, r = (torch.as_tensor(sy[f"{k}10"]) for k in "DOr")
    assert ks.get_kkt_mesh() is None
    with pytest.raises(ValueError, match="set_kkt_mesh"):
        ks.ksharded_factor(D, O)
    ks.set_kkt_mesh(mesh_lib.make_mesh("cpu"))
    try:
        f = ks.ksharded_factor(D, O)
        assert f.nshards == 1 and f.m == 10 and f.n_orig == 10
        ks.set_kkt_mesh(mesh_lib.Mesh(0, 2, CPU))
        with pytest.raises(ValueError, match="must not change"):
            ks.ksharded_solve(f, r)
        ks.set_kkt_mesh(mesh_lib.Mesh(0, 1, torch.device("cuda", 0)))
        with pytest.raises(ValueError, match="device"):
            ks.ksharded_solve(f, r)
        ks.set_kkt_mesh(None)
        with pytest.raises(ValueError, match="set_kkt_mesh"):
            ks.ksharded_solve(f, r)
    finally:
        ks.set_kkt_mesh(None)


def test_matrix_rhs_solve_matches_columns():
    """``smallla.blocktridiag_solve`` on a matrix right-hand side (..., N,
    n, m) equals its vector solves column by column, and the columns folded
    into lanes (``cuda_kkt.fold_columns``, the kernel's layout) solved by
    the vector plain version and unfolded give the same."""
    rng = np.random.default_rng(5)
    sy = _systems()
    D, O = (torch.as_tensor(sy[f"{k}49"]) for k in "DO")
    L, C = smallla.blocktridiag_factor(D, O)
    R = torch.as_tensor(rng.standard_normal((LANES, 49, NB, 5)))
    U = smallla.blocktridiag_solve(L, C, R)
    cols = torch.stack([smallla.blocktridiag_solve(L, C, R[..., j])
                        for j in range(5)], dim=-1)
    np.testing.assert_allclose(U.numpy(), cols.numpy(), rtol=1e-12,
                               atol=1e-14)
    folded = cuda_kkt.unfold_columns(
        cuda_kkt.tridiag_solve_plain(*cuda_kkt.fold_columns(L, C, R)), 5)
    np.testing.assert_array_equal(folded.numpy(), cols.numpy())
    np.testing.assert_array_equal(cuda_kkt.tridiag_solve_mat(L, C, R).numpy(),
                                  U.numpy())
