"""The port's scenario-sharded sweep and sharded checkpoints against the
JAX package's.

Two gloo ranks on the CPU run ``solve_batch_sharded`` on the point mass
(K=8, f64, B=8, the JAX package's ``tests/test_parallel.py`` small config
with ``tr_mode="soft"``: hard trust-region decisions sit on knife edges
that the batch's packing can flip). The gathered state is held against the
port's unsharded ``solve_batch`` (per-lane results depend on the packing
at the 1e-8 level on the CPU, so counts and flags identical and sigma
within 1e-8) and against JAX's ``solve_batch_sharded`` on the 8 virtual
devices (sigma at rtol 1e-6, counts identical). The same ranks check that
the warm test is global: one lane of rank 1 without a valid carry sends
rank 0's lanes down the cold branch. ``save_sharded`` and
``restore_sharded`` are checked in this process with meshes of two ranks
and no process group, and against a file JAX's ``save_sharded`` wrote.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import successiveconvexification_tpu as J
from successiveconvexification_tpu.io import checkpoint as jckpt
from successiveconvexification_tpu.models import pointmass3dof as jpm
from successiveconvexification_tpu.ops.scvx import scvx_init as jinit
from successiveconvexification_tpu.parallel import batch as jbatch

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.io import checkpoint as ckpt
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.parallel import mesh as mesh_lib
from successiveconvexification_tpu_torch.utils.tree import tree_leaves, tree_map

from torch_helpers import (assert_same_by_name, finish, free_port, kill,
                           random_like, spawn)

B = 8
CPU = torch.device("cpu")
COUNTS = ("converged", "iterations", "n_accept", "n_reject", "n_bump")

_WORKER = r"""
import json, sys
import numpy as np
import torch

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.parallel import batch, mesh as M
from successiveconvexification_tpu_torch.utils.tree import tree_leaves

cfg = T.SolverConfig.from_dict(json.load(open(out + "/cfg.json")))
pb = tpm.params_from_numpy(dict(np.load(out + "/params.npz")))
model = T.pointmass3dof_model()
mesh = M.init_distributed(f"localhost:{port}", world, rank, "cpu")
try:
    # the sharded sweep, gathered in lane order, and its statistics
    st = batch.solve_batch_sharded(model, pb, cfg, mesh=mesh)
    full = M.gather_scenario_tree(st, mesh)
    stats = batch.batch_stats(st, mesh)
    # the warm test: two lockstep iterations give every lane a valid
    # carry; then rank 1 loses one lane's carry
    local = M.shard_scenario_tree(pb, mesh)
    s = T.scvx_init(model, local, cfg)
    for _ in range(2):
        s = batch._batch_body(model, local, cfg, s, mesh)
    warm_before = int(mesh.all_reduce(torch.isfinite(
        s.ipm_carry.gap).all().to(torch.int32).reshape(1),
        torch.distributed.ReduceOp.MIN))
    if rank == 1:
        gap = s.ipm_carry.gap.clone()
        gap[0] = float("inf")
        s = s._replace(ipm_carry=s.ipm_carry._replace(gap=gap))
    got = batch._batch_body(model, local, cfg, s, mesh)
    if rank == 0:
        arrs = {"warm_before": np.asarray(warm_before),
                "stats": np.asarray([float(v) for v in stats])}
        runs = {"full": full, "got": got,
                "cold": T.scvx_iteration(model, local, cfg, s,
                                         assume_warm_valid=False),
                "warm": T.scvx_iteration(model, local, cfg, s,
                                         assume_warm_valid=True)}
        for name, tree in runs.items():
            for i, t in enumerate(tree_leaves(tree)):
                arrs[f"{name}_{i}"] = t.numpy()
        np.savez(out + "/rank0.npz", **arrs)
finally:
    M.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


def _cfg_dict():
    """The JAX package's ``tests/test_parallel.py`` small config."""
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=8, substeps=3),
        ipm=J.IPMConfig(max_iters=12, refine_steps=1),
        scvx=dataclasses.replace(J.ScvxConfig(), max_iters=4,
                                 tr_mode="soft")).to_dict()


def _params_np(seed: int, batch: int) -> dict:
    base = jpm.default_params(jnp.float64)
    rng = np.random.default_rng(seed)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (batch,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] + 0.2 * rng.standard_normal((batch, 3))
    d["v_init"] = d["v_init"] + 0.1 * rng.standard_normal((batch, 3))
    d["m_wet"] = d["m_wet"] * (1.0 + 0.02 * rng.standard_normal(batch))
    return d


def _unflatten(like, data, prefix):
    it = iter(torch.as_tensor(data[f"{prefix}_{i}"])
              for i in range(len(tree_leaves(like))))
    return tree_map(lambda t: next(it), like)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The 2-rank run's rank-0 outputs, the port's unsharded sweep and
    JAX's sharded sweep of the same lanes. The ranks run beside the two
    in-process sweeps."""
    out = tmp_path_factory.mktemp("sharded")
    d = _params_np(0, B)
    np.savez(out / "params.npz", **d)
    (out / "cfg.json").write_text(json.dumps(_cfg_dict()))
    script = out / "worker.py"
    script.write_text(_WORKER)
    port = free_port()
    procs = spawn([[str(script), str(r), "2", str(port), str(out)]
                   for r in range(2)])
    try:
        cfg = T.SolverConfig.from_dict(_cfg_dict())
        model = T.pointmass3dof_model()
        local = T.solve_batch(model, tpm.params_from_numpy(d), cfg,
                              device="cpu")
        pj = jpm.PointMass3DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})
        jst = jbatch.solve_batch_sharded(
            J.pointmass3dof_model(), pj, J.SolverConfig.from_dict(_cfg_dict()),
            mesh=JMesh(np.asarray(jax.devices()), ("scenario",)))
        finish(procs, timeout=150)
    finally:
        kill(procs)
    with np.load(out / "rank0.npz") as z:
        data = dict(z)
    return data, local, jst


def test_scenario_slice_is_jax_named_sharding_tile():
    """Rank r's tile of B lanes is the tile JAX's ``P("scenario")`` gives
    device r of a mesh of W devices; a B that W does not divide is refused
    by both."""
    devs = jax.devices()
    assert len(devs) == 8
    for world in (1, 2, 4, 8):
        sh = NamedSharding(JMesh(np.asarray(devs[:world]), ("scenario",)),
                           P("scenario"))
        for batch in (8, 16, 24):
            tiles = sh.devices_indices_map((batch,))
            for r, dev in enumerate(devs[:world]):
                ours = mesh_lib.Mesh(r, world, CPU).scenario_slice(batch)
                assert (range(*ours.indices(batch))
                        == range(*tiles[dev][0].indices(batch)))
    sh4 = NamedSharding(JMesh(np.asarray(devs[:4]), ("scenario",)),
                        P("scenario"))
    with pytest.raises(ValueError):
        jax.device_put(np.zeros(6), sh4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.Mesh(1, 4, CPU).scenario_slice(6)


@pytest.mark.parametrize("device,nccl,backend", [
    ("cuda", True, "nccl"), ("cpu", True, "gloo"), ("cpu", False, "gloo"),
    ("cuda", False, None)])
def test_init_distributed_picks_nccl_for_a_card_and_never_falls_back(
        monkeypatch, device, nccl, backend):
    """A CUDA device joins with NCCL, the CPU with gloo; a CUDA device
    without NCCL raises and joins nothing (no gloo in its place). The group
    gets the TCP address, the world size, the rank and a 60 s timeout."""
    calls = []
    monkeypatch.setattr(mesh_lib, "resolve_device", torch.device)
    monkeypatch.setattr(mesh_lib.dist, "is_nccl_available", lambda: nccl)
    monkeypatch.setattr(mesh_lib.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    if backend is None:
        with pytest.raises(RuntimeError, match="NCCL"):
            mesh_lib.init_distributed("localhost:1234", 2, 1, dev)
        assert calls == []
        return
    m = mesh_lib.init_distributed("localhost:1234", 2, 1, dev)
    (args, kw), = calls
    assert args == (backend,)
    assert kw["init_method"] == "tcp://localhost:1234"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["timeout"].total_seconds() == 60
    assert kw.get("device_id") == (dev if backend == "nccl" else None)
    assert (m.rank, m.world, m.device) == (1, 2, dev)


def test_without_a_card_the_default_device_raises():
    """``device=None`` means the card: without one, joining a group and
    making a mesh raise ``resolve_device``'s error."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_distributed("localhost:1234", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_mesh()


def test_two_ranks_meet_the_packing_gate_against_solve_batch(sharded):
    """Two gloo ranks give the unsharded sweep's counts and flags, and its
    sigma within 1e-8; the record over the gathered lanes is the unsharded
    record's statistics of the same lanes."""
    data, local, _ = sharded
    full = _unflatten(local, data, "full")
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(full, f).numpy(),
                                      getattr(local, f).numpy(), err_msg=f)
    np.testing.assert_allclose(full.sigma.numpy(), local.sigma.numpy(),
                               rtol=0, atol=1e-8)
    stats = T.batch_stats(full)
    np.testing.assert_array_equal(data["stats"],
                                  [float(v) for v in stats])
    assert int(stats.n_total) == B


def test_two_ranks_match_jax_solve_batch_sharded(sharded):
    """Against JAX's ``solve_batch_sharded`` on the 8 virtual devices: the
    same counts and flags, sigma at rtol 1e-6."""
    data, local, jst = sharded
    full = _unflatten(local, data, "full")
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(full, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    np.testing.assert_allclose(full.sigma.numpy(), np.asarray(jst.sigma),
                               rtol=1e-6)


def test_warm_test_is_global(sharded):
    """Every lane was warm; then one lane of rank 1 loses its carry. Rank
    0's lanes, all warm themselves, must take the cold branch, as one
    unsharded batch would: bit for bit ``scvx_iteration(...,
    assume_warm_valid=False)`` on the same lanes, which differs from the
    warm branch (Ruiz runs on cold solves only)."""
    data, local, _ = sharded
    assert int(data["warm_before"]) == 1
    n = len(tree_leaves(local))
    for i in range(n):
        np.testing.assert_array_equal(data[f"got_{i}"], data[f"cold_{i}"],
                                      err_msg=f"leaf {i}")
    assert any(not np.array_equal(data[f"warm_{i}"], data[f"cold_{i}"])
               for i in range(n))


# ------------------------------------------------------ sharded checkpoints
@pytest.fixture(scope="module")
def state():
    cfg = T.SolverConfig.from_dict(_cfg_dict())
    model = T.pointmass3dof_model()
    pb = tpm.params_from_numpy(_params_np(3, B))
    st = T.scvx_init(model, pb, cfg)
    for _ in range(2):
        st = T.scvx_iteration(model, pb, cfg, st)
    return cfg, st


def _meshes(world):
    return [mesh_lib.Mesh(r, world, CPU) for r in range(world)]


def _save_ranks(path, st, world, cfg, steps):
    for m, step in zip(_meshes(world), steps):
        ckpt.save_sharded(path, mesh_lib.shard_scenario_tree(st, m), mesh=m,
                          cfg=cfg, step=step)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_sharded_roundtrip_and_fewer_ranks(tmp_path, state):
    """Each of two ranks writes its own tiles under JAX's keys; each rank
    restores its lanes bit for bit, and so does one rank alone (the
    recovery ensemble may be smaller than the one that crashed), and a
    rank of four. A leftover ``.tmp`` of an interrupted write is
    ignored."""
    cfg, st = state
    path = str(tmp_path / "sw")
    _save_ranks(path, st, 2, cfg, (4, 4))
    with np.load(path + ".shard1.npz") as z:
        assert "leaf0|4_8|_|_" in z.files and "leaf2|4_8" in z.files
        assert json.loads(str(z["_meta"])) == {
            "step": 4, "config_hash": ckpt.config_hash(cfg)}
    with open(path + ".shard0.npz.tmp", "wb") as fh:
        fh.write(b"garbage")
    for world in (2, 4):
        for m in _meshes(world):
            mine = mesh_lib.shard_scenario_tree(st, m)
            back = ckpt.restore_sharded(path, tree_map(torch.zeros_like, mine),
                                        mesh=m, cfg=cfg)
            assert _equal(back, mine)
    assert _equal(ckpt.restore_sharded(path, tree_map(torch.zeros_like, st),
                                       cfg=cfg), st)
    assert ckpt.sharded_step(path) == 4


def test_sharded_restore_refuses_missing_tiles_mixed_steps_and_config(
        tmp_path, state):
    """A shard file that lost a leaf's tiles, shard files of two steps, a
    missing shard file, another config or a tile of another batch size:
    ``ValueError``, never a made-up state (the JAX package's
    ``test_sharded_restore_refuses_missing_tiles`` and more)."""
    cfg, st = state
    like = tree_map(torch.zeros_like, st)
    path = str(tmp_path / "sw")
    _save_ranks(path, st, 2, cfg, (2, 2))
    with np.load(path + ".shard1.npz") as z:
        kept = {k: z[k] for k in z.files if not k.startswith("leaf0|")}
    np.savez(path + ".shard1.npz", **kept)
    with pytest.raises(ValueError, match="do not cover"):
        ckpt.restore_sharded(path, like)
    _save_ranks(path, st, 2, cfg, (2, 3))
    with pytest.raises(ValueError, match="do not cover one step"):
        ckpt.restore_sharded(path, like)
    with pytest.raises(ValueError, match="do not cover one step"):
        ckpt.sharded_step(path)
    os.remove(path + ".shard1.npz")
    with pytest.raises(ValueError, match="do not cover"):
        ckpt.restore_sharded(path, like)
    one = str(tmp_path / "one_lane")
    ckpt.save_sharded(one, tree_map(lambda t: t[:1], st), cfg=cfg)
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore_sharded(one, like)
    with pytest.raises(ValueError, match="different config"):
        ckpt.restore_sharded(path, like, mesh=_meshes(2)[0],
                             cfg=cfg.replace(dtype="float32"))


def test_restores_a_file_jax_save_sharded_wrote_on_eight_devices(tmp_path):
    """JAX's ``save_sharded`` of a state sharded over the 8 virtual devices
    (one tile a lane, distinct random leaves) restores into the port's
    state bit for bit, matched leaf by leaf by field name: in one process,
    and as rank 1 of 2 and rank 3 of 4."""
    d = _params_np(5, B)
    cfg_j = J.SolverConfig.from_dict(_cfg_dict())
    pj = jpm.PointMass3DoFParams(**{k: jnp.asarray(v) for k, v in d.items()})
    shapes = jax.eval_shape(jax.vmap(
        lambda p: jinit(J.pointmass3dof_model(), p, cfg_j)), pj)
    mesh8 = JMesh(np.asarray(jax.devices()), ("scenario",))
    sj = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(
            mesh8, P("scenario", *([None] * (a.ndim - 1))))),
        random_like(shapes, np.random.default_rng(2)))
    assert len(sj.X.addressable_shards) == 8
    path = str(tmp_path / "jax_sw")
    jckpt.save_sharded(path, sj, cfg=cfg_j, step=7)
    cfg = T.SolverConfig.from_dict(_cfg_dict())
    like = T.scvx_init(T.pointmass3dof_model(), tpm.params_from_numpy(d), cfg)
    assert_same_by_name(ckpt.restore_sharded(path, like, cfg=cfg), sj)
    for world, r in ((2, 1), (4, 3)):
        m = mesh_lib.Mesh(r, world, CPU)
        back = ckpt.restore_sharded(path, mesh_lib.shard_scenario_tree(like, m),
                                    mesh=m, cfg=cfg)
        assert_same_by_name(back, jax.tree.map(
            lambda a: np.asarray(a)[m.scenario_slice(B)], sj))
    assert ckpt.sharded_step(path) == 7
