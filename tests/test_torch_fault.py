"""Crash and resume of the port's sharded sweep, and ``cli sweep
--distributed``: the counterparts of the JAX package's
``tests/test_fault_recovery.py`` and ``tests/test_cli_distributed.py``.

Two gloo ranks on the CPU run ``run_batch`` on the point mass (K=8, B=4,
f64, a commit after every SCvx iteration) three times:

  1. FULL: uninterrupted; each rank prints the SHA-256 of its lanes' bytes.
  2. CRASH: rank 1 hard-exits (``os._exit``) right after its step-2
     commit. Rank 0 cannot pass the barrier of the next commit; once both
     shard files carry step 2, the test kills it by its PID.
  3. RESUME: two fresh ranks restore the crashed run's shard files and
     finish; their digests must be FULL's, bit for bit.

One rank alone also resumes the two ranks' checkpoint: per-lane results
depend on the batch's packing at the 1e-8 level on the CPU, so counts and
flags identical and sigma within 1e-8. ``tr_mode="soft"`` as in the JAX
package's ``tests/test_parallel.py``: hard trust-region decisions sit on
knife edges that the packing can flip.
"""

import dataclasses
import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.models import pointmass3dof as jpm

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.io import checkpoint as ckpt
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.parallel.batch import run_batch
from successiveconvexification_tpu_torch.utils.tree import tree_leaves, tree_map

from torch_helpers import finish, free_port, kill, spawn

B = 4
CKPT_STEP = 2
COUNTS = ("converged", "iterations", "n_accept", "n_reject", "n_bump")

_WORKER = r"""
import hashlib, json, os, sys
import numpy as np
import torch

rank, world, port, mode, ck, out = sys.argv[1:7]
rank, world, crash_step = int(rank), int(world), int(sys.argv[7])
torch.set_num_threads(1)
import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.io import checkpoint
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.parallel.batch import run_batch
from successiveconvexification_tpu_torch.parallel import batch, mesh as M
from successiveconvexification_tpu_torch.utils.tree import tree_leaves

cfg = T.SolverConfig.from_dict(json.load(open(out + "/cfg.json")))
pb = tpm.params_from_numpy(dict(np.load(out + "/params.npz")))
model = T.pointmass3dof_model()
if mode == "crash" and rank == 1:
    save = checkpoint.save_sharded

    def save_then_exit(path, state, mesh=None, cfg=None, step=0):
        save(path, state, mesh=mesh, cfg=cfg, step=step)
        if step == crash_step:
            os._exit(9)        # an uncoordinated failure mid-sweep

    checkpoint.save_sharded = save_then_exit
mesh = M.init_distributed(f"localhost:{port}", world, rank, "cpu")
try:
    st = batch.run_batch(model, pb, cfg, mesh=mesh, ckpt_path=ck,
                         ckpt_every=1, device="cpu")
    h = hashlib.sha256()
    for t in tree_leaves(st):
        h.update(t.numpy().tobytes())
    print(f"rank{rank} digest={h.hexdigest()}", flush=True)
    full = M.gather_scenario_tree(st, mesh)
    if rank == 0:
        np.savez(out + f"/{mode}_final.npz",
                 **{str(i): t.numpy() for i, t in enumerate(tree_leaves(full))})
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
    """The JAX package's fault-injection config, with a soft trust region
    and a cap of four SCvx iterations (four commits)."""
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=8, substeps=3),
        ipm=J.IPMConfig(max_iters=10, refine_steps=1),
        scvx=dataclasses.replace(J.ScvxConfig(), max_iters=4,
                                 tr_mode="soft")).to_dict()


def _params_np() -> dict:
    """The JAX fault test's lanes: r_init scaled by 1 + 0.02 i."""
    base = jpm.default_params(jnp.float64)
    d = {f.name: np.broadcast_to(np.asarray(getattr(base, f.name)),
                                 (B,) + np.shape(getattr(base, f.name))).copy()
         for f in dataclasses.fields(base)}
    d["r_init"] = d["r_init"] * (1.0 + 0.02 * np.arange(B))[:, None]
    return d


def _step(path: str) -> int:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["_meta"]))["step"]


def _start(out, mode: str, ck: str):
    port = free_port()
    return spawn([[str(out / "worker.py"), str(r), "2", str(port), mode, ck,
                   str(out), str(CKPT_STEP)] for r in range(2)])


def _digests(outs):
    return sorted(o.split("digest=")[1].split()[0] for o in outs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """FULL and CRASH side by side, then RESUME from CRASH's files."""
    out = tmp_path_factory.mktemp("fault")
    d = _params_np()
    np.savez(out / "params.npz", **d)
    (out / "cfg.json").write_text(json.dumps(_cfg_dict()))
    (out / "worker.py").write_text(_WORKER)
    ck = {m: str(out / m / "sweep") for m in ("full", "crash", "resume")}
    for m in ck:
        (out / m).mkdir()
    full = _start(out, "full", ck["full"])
    crash = _start(out, "crash", ck["crash"])
    resume = []
    try:
        full_outs = finish(full, timeout=120)
        crash_outs = [None, crash[1].communicate(timeout=120)[0]]
        assert crash[1].returncode == 9, crash_outs[1][-3000:]
        shards = [f"{ck['crash']}.shard{r}.npz" for r in range(2)]
        deadline = time.time() + 60
        while not (all(os.path.exists(f) for f in shards)
                   and all(_step(f) == CKPT_STEP for f in shards)):
            assert time.time() < deadline, "the step-2 commit never landed"
            time.sleep(0.2)
        kill(crash[:1])          # rank 0, by the PID this test started
        crash_steps = [_step(f) for f in shards]
        for f in shards:
            shutil.copy(f, out / "resume")
        resume = _start(out, "resume", ck["resume"])
        resume_outs = finish(resume, timeout=120)
    finally:
        kill(full + crash + resume)
    return dict(out=out, d=d, ck=ck, full=full_outs, resume=resume_outs,
                crash_steps=crash_steps)


def test_kill_one_rank_resume_bit_for_bit(runs):
    """The crash leaves both shard files at step 2, and two fresh ranks
    resume them to FULL's final lanes, bit for bit."""
    assert runs["crash_steps"] == [CKPT_STEP, CKPT_STEP]
    assert _digests(runs["resume"]) == _digests(runs["full"])
    with np.load(runs["out"] / "full_final.npz") as a, \
            np.load(runs["out"] / "resume_final.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_one_rank_resumes_two_ranks_checkpoint(runs, tmp_path):
    """One process restores the crashed two ranks' files (all four lanes,
    step 2) and finishes: FULL's counts and flags, sigma within 1e-8."""
    for r in range(2):
        shutil.copy(f"{runs['ck']['crash']}.shard{r}.npz", tmp_path)
    cfg = T.SolverConfig.from_dict(_cfg_dict())
    model = T.pointmass3dof_model()
    pb = tpm.params_from_numpy(runs["d"])
    st = run_batch(model, pb, cfg, ckpt_path=str(tmp_path / "sweep"),
                     ckpt_every=1, device="cpu")
    with np.load(runs["out"] / "full_final.npz") as z:
        it = iter(torch.as_tensor(z[str(i)]) for i in range(len(z.files)))
        full = tree_map(lambda t: next(it), st)
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      getattr(full, f).numpy(), err_msg=f)
    np.testing.assert_allclose(st.sigma.numpy(), full.sigma.numpy(), rtol=0,
                               atol=1e-8)
    assert int(st.iterations.max()) == cfg.scvx.max_iters
    assert ckpt.sharded_step(str(tmp_path / "sweep")) == cfg.scvx.max_iters
    assert len(tree_leaves(st)) == len(tree_leaves(full))


# ---------------------------------------------------------------- the CLI
def _cli_pair(ckpt_path: str):
    port = free_port()
    argv = ["sweep", "--model", "pointmass3dof", "--batch", "8", "--seed", "1",
            "--checkpoint", ckpt_path, "--ckpt-every", "2", "--distributed",
            "--coordinator", f"localhost:{port}", "--num-processes", "2",
            "--disc.K=8", "--disc.substeps=3", "--ipm.max_iters=10",
            "--scvx.max_iters=5", "--device", "cpu"]
    code = ("import sys\n"
            "from successiveconvexification_tpu_torch import cli\n"
            "cli.main(sys.argv[1:])\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m.startswith('successiveconvexification_tpu.') "
            "for m in sys.modules), 'the JAX package imported'\n")
    procs = spawn([["-c", code, *argv, "--process-id", str(r)]
                   for r in range(2)])
    try:
        outs = finish(procs, timeout=120)
    finally:
        kill(procs)
    assert "{" not in outs[1]           # rank 0 alone prints the record
    return json.loads("{" + outs[0].split("{", 1)[1].rsplit("}", 1)[0] + "}")


def test_cli_distributed_sweep_and_resume(tmp_path):
    """``cli sweep --distributed`` on two gloo ranks (the JAX package's
    ``test_cli_distributed_sweep_with_checkpoint_and_resume``, with
    ``--device cpu``): rank 0 prints the record over the whole batch, each
    rank commits its shard file, and a second run resumes the finished
    sweep with the same record; neither imports JAX."""
    ck = str(tmp_path / "sweep_ck")
    rec = _cli_pair(ck)
    assert rec["n_total"] == 8 and rec["mean_iterations"] > 0
    for r in (0, 1):
        assert _step(f"{ck}.shard{r}.npz") >= 2
    rec2 = _cli_pair(ck)
    assert rec2["n_total"] == rec["n_total"]
    assert rec2["mean_iterations"] == rec["mean_iterations"]
    assert rec2["n_converged"] == rec["n_converged"]
