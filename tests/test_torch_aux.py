"""The port's checkpoint, metrics and CLI against the JAX package's.

``io/checkpoint.py`` writes the JAX package's ``.npz`` (the leaves in the
order ``utils/tree.py`` flattens them, ``_meta`` with the step and the
config's hash), reads the file the JAX package's ``save`` writes, and
refuses another config or other shapes;
``utils/metrics.py`` counts flops and bytes as XLA's ``cost_analysis``
does on a matrix product; ``cli.py`` runs in child processes with
``--device cpu`` and imports no JAX. f64 point mass at K=10, B=4 for the
state tests; no JAX SCvx graph.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import successiveconvexification_tpu as J
from successiveconvexification_tpu.io import checkpoint as jckpt
from successiveconvexification_tpu.utils import metrics as jmetrics

import successiveconvexification_tpu_torch as T
from successiveconvexification_tpu_torch.io import checkpoint as ckpt
from successiveconvexification_tpu_torch.models import pointmass3dof as tpm
from successiveconvexification_tpu_torch.models import rocket6dof as trk
from successiveconvexification_tpu_torch.utils import metrics
from successiveconvexification_tpu_torch.utils.tree import tree_leaves, tree_map

from torch_helpers import assert_same_by_name, random_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
# the JAX CLI's sweep record (successiveconvexification_tpu/cli.py:195-202)
SWEEP_KEYS = {"n_converged", "n_total", "mean_iterations", "mean_sigma",
              "max_nu_norm", "wall_s", "solves_per_s"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny tensors: one thread is the fastest here
    yield
    torch.set_num_threads(threads)


def _small_cfg_dict():
    """The JAX package's ``tests/test_aux.py`` small config."""
    return J.SolverConfig(
        dtype="float64", disc=J.DiscretizationConfig(K=10, substeps=4),
        ipm=J.IPMConfig(max_iters=20, refine_steps=1),
        scvx=dataclasses.replace(J.ScvxConfig(), max_iters=25)).to_dict()


@pytest.mark.parametrize("change", [
    {},
    {"dtype": "float64", "disc": {"K": 20, "substeps": 4, "foh": False}},
    {"ipm": {"kkt_solver": "pcr", "static_reg": 1e-6},
     "scvx": {"tr_mode": "soft", "w_nu": 100.0}},
])
def test_config_hash_matches_jax(change):
    """``config_hash`` gives the JAX package's hash of the same config."""
    d = J.SolverConfig().to_dict()
    for k, v in change.items():
        d[k] = {**d[k], **v} if isinstance(v, dict) else v
    h = ckpt.config_hash(T.SolverConfig.from_dict(d))
    assert h == jckpt.config_hash(J.SolverConfig.from_dict(d))
    assert len(h) == 16
    if change:
        assert h != ckpt.config_hash(T.SolverConfig())


@pytest.fixture(scope="module")
def sweep():
    """A point-mass B=4, K=10 f64 sweep state after 3 iterations, and the
    pieces to continue it."""
    cfg = T.SolverConfig.from_dict(_small_cfg_dict())
    model = T.pointmass3dof_model()
    gen = torch.Generator().manual_seed(7)
    pb = T.sample_dispersions(tpm.default_params(F64), gen, 4)
    st = T.scvx_init(model, pb, cfg)
    for _ in range(3):
        st = T.scvx_iteration(model, pb, cfg, st)
    return model, pb, cfg, st


def test_checkpoint_roundtrip_bit_for_bit(tmp_path, sweep):
    """save then restore into a zero state gives every leaf back bit for
    bit, in the ``like``'s dtypes; the file is the JAX package's npz
    layout (``arr_i`` in tree order, ``_meta`` with step and hash)."""
    _, _, cfg, st = sweep
    path = str(tmp_path / "sub" / "ck")
    ckpt.save(path, st, cfg=cfg, step=3)
    like = tree_map(torch.zeros_like, st)
    back = ckpt.restore(path, like, cfg=cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(st)):
        assert a.dtype == b.dtype and a.device == b.device
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with np.load(path + ".npz", allow_pickle=False) as z:
        meta = json.loads(str(z["_meta"]))
        assert meta == {"step": 3, "config_hash": ckpt.config_hash(cfg)}
        assert len([k for k in z.files if k.startswith("arr_")]) == len(
            tree_leaves(st))
        np.testing.assert_array_equal(z["arr_0"], st.X.numpy())


def test_checkpoint_refuses_another_config_or_shape(tmp_path, sweep):
    """A different config's hash, another batch size or another K raises
    ``ValueError`` (never a reshape)."""
    model, pb, cfg, st = sweep
    path = str(tmp_path / "ck")
    ckpt.save(path, st, cfg=cfg)
    like = tree_map(torch.zeros_like, st)
    with pytest.raises(ValueError, match="different config"):
        ckpt.restore(path, like, cfg=cfg.replace(dtype="float32"))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, T.scvx_init(model, pb.index(slice(0, 2)), cfg))
    cfg12 = cfg.replace(disc=dataclasses.replace(cfg.disc, K=12))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, T.scvx_init(model, pb, cfg12))


def test_deterministic_resume_equals_uninterrupted(tmp_path, sweep):
    """Resuming from a checkpoint reproduces the uninterrupted sweep
    exactly (the JAX package's ``test_deterministic_resume_equals_
    uninterrupted``)."""
    model, pb, cfg, st = sweep
    path = str(tmp_path / "mid")
    ckpt.save(path, st, cfg=cfg, step=3)
    st_a = st
    for _ in range(3):
        st_a = T.scvx_iteration(model, pb, cfg, st_a)
    st_b = ckpt.restore(path, tree_map(torch.zeros_like, st), cfg=cfg)
    for _ in range(3):
        st_b = T.scvx_iteration(model, pb, cfg, st_b)
    assert torch.equal(st_a.X, st_b.X) and torch.equal(st_a.sigma, st_b.sigma)
    assert torch.equal(st_a.iterations, st_b.iterations)


def test_checkpoint_restores_a_file_jax_wrote(tmp_path, monkeypatch, sweep):
    """The JAX package's ``save`` (its ``.npz``, written when Orbax is
    missing) restores into the port's state with every leaf bit for bit,
    matched by field name: the leaf orders of the two packages agree."""
    from successiveconvexification_tpu.ops.scvx import scvx_init as jinit
    from successiveconvexification_tpu.models import pointmass3dof as jpm

    _, pb, cfg, st = sweep
    cfg_j = J.SolverConfig.from_dict(_small_cfg_dict())
    pj = jpm.PointMass3DoFParams(**{
        k: jnp.asarray(v.numpy()) for k, v in pb.fields().items()})
    shapes = jax.eval_shape(jax.vmap(
        lambda p: jinit(J.pointmass3dof_model(), p, cfg_j)), pj)
    sj = random_like(shapes, np.random.default_rng(11))
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    path = str(tmp_path / "jax_ck")
    jckpt.save(path, sj, cfg=cfg_j, step=5)
    assert os.path.exists(path + ".npz")
    back = ckpt.restore(path, tree_map(torch.zeros_like, st), cfg=cfg)
    assert_same_by_name(back, sj)


def test_jsonl_logger_writes_jax_lines(tmp_path):
    """The same records give the JAX logger's lines (its ``_t`` dropped):
    tensors, numpy arrays and numpy scalars become JSON numbers and lists."""
    def records(arr):
        return [{"a": 1, "b": arr(2.5), "c": arr([1.0, 2.0]),
                 "d": np.float32(0.1), "e": np.int64(3), "f": "text"},
                {"n": arr([[1, 2], [3, 4]])}]

    lines = []
    for logger, arr in ((metrics.JsonlLogger, lambda v: torch.tensor(v)),
                        (jmetrics.JsonlLogger, lambda v: jnp.asarray(v))):
        path = str(tmp_path / f"{len(lines)}.jsonl")
        lg = logger(path, manifest={"run": "test", "batch": 4})
        for r in records(arr):
            lg.log(r)
        lg.close()
        got = [json.loads(x) for x in open(path)]
        assert got[0].pop("_t") > 0
        lines.append(got)
    assert lines[0] == lines[1]
    assert lines[0][1]["b"] == 2.5 and lines[0][2]["n"] == [[1, 2], [3, 4]]


def test_cost_analysis_and_sol_fraction_match_jax():
    """flops and bytes of ``x @ x`` at 64 x 64 float32 equal XLA's in the
    JAX package (524,288 and 49,152: each operand and the output once);
    ``sol_fraction`` is the JAX function."""
    ours = metrics.cost_analysis(lambda x: x @ x, torch.ones(64, 64))
    theirs = jmetrics.cost_analysis(lambda x: x @ x,
                                    jnp.ones((64, 64), jnp.float32))
    assert ours == {"flops": 524288.0, "bytes_accessed": 49152.0}
    assert ours["flops"] == theirs["flops"]
    assert ours["bytes_accessed"] == theirs["bytes_accessed"]
    for args in ((1e9, 1e-3, 67e12), (1.0, 0.0, 1.0), (5.0, 2.0, 0.0)):
        assert metrics.sol_fraction(*args) == jmetrics.sol_fraction(*args)
    peaks = metrics.CHIP_PEAKS["NVIDIA H100 80GB HBM3, 700 W"]
    assert peaks == {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12,
                     "f64_flops": 34e12}
    assert list(metrics.CHIP_PEAKS) == ["NVIDIA H100 80GB HBM3, 700 W"]


# ---------------------------------------------------------------- the CLI
def _run(args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT, **kw)


def test_cli_solve_imports_no_jax(tmp_path):
    """The JAX package's ``test_cli_solve_smoke`` arguments, with
    ``--device cpu``, through ``cli.main`` in a child process: it returns,
    writes X of shape (8, 7) and prints the JAX CLI's solve record, and
    ``jax`` is not in ``sys.modules`` afterwards."""
    argv = ["solve", "--model", "pointmass3dof", "--K", "8", "--dtype",
            "float64", "--out", str(tmp_path / "t.npz"), "--scvx.max_iters=4",
            "--ipm.max_iters=12", "--disc.substeps=3", "--device", "cpu"]
    code = ("import sys\n"
            "from successiveconvexification_tpu_torch import cli\n"
            f"cli.main({argv!r})\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m.startswith('successiveconvexification_tpu.') "
            "for m in sys.modules), 'the JAX package imported'\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr[-2000:]
    data = np.load(tmp_path / "t.npz")
    assert data["X"].shape == (8, 7) and data["U"].shape == (8, 3)
    rec = json.loads(out.stdout[:out.stdout.index("}") + 1])
    assert set(rec) == {"model", "converged", "iterations", "sigma_tof",
                        "final_mass", "nu_norm", "wall_s"}
    assert rec["model"] == "pointmass3dof" and rec["iterations"] == 4


def test_cli_seeded_sweep_metrics_and_checkpoint(tmp_path):
    """``sweep --seeded`` with ``--metrics`` and ``--checkpoint`` (a short
    SCvx cap keeps it cheap): rc 0, the JSONL manifest with the device and
    one record with the JAX CLI's keys, and a checkpoint that restores into
    a state of the sweep's shapes under its config, matching the record."""
    out = _run(["-m", "successiveconvexification_tpu_torch.cli", "sweep",
                "--seeded", "--batch", "4", "--disc.K=8", "--disc.substeps=2",
                "--scvx.max_iters=3", "--metrics", str(tmp_path / "m.jsonl"),
                "--checkpoint", str(tmp_path / "ck"), "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    man, rec = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert man["_manifest"]["devices"] == ["cpu"]
    assert man["_manifest"]["cmd"] == "sweep" and man["_manifest"]["batch"] == 4
    assert set(rec) == SWEEP_KEYS and rec["n_total"] == 4
    cfg = T.SolverConfig.from_dict(man["_manifest"]["config"])
    assert cfg.disc.K == 8 and cfg.scvx.max_iters == 3
    like = T.scvx_init(T.rocket6dof_model(), T.sample_dispersions(
        trk.default_params(), torch.Generator(), 4), cfg)
    st = ckpt.restore(str(tmp_path / "ck"), like, cfg=cfg)
    assert int(st.converged.sum()) == rec["n_converged"]
    assert float(st.sigma.mean()) == pytest.approx(rec["mean_sigma"], rel=1e-6)
    assert int(st.iterations.max()) <= 3


def test_cli_without_a_card_exits_with_resolve_devices_message():
    """Without ``--device`` the CLI asks for the card; with none it exits
    non-zero with ``resolve_device``'s message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = _run(["-m", "successiveconvexification_tpu_torch.cli", "solve",
                "--K", "8"])
    assert out.returncode != 0
    assert "no CUDA device: pass device='cpu'" in out.stderr
