"""``correct`` comes out false when the timed path is broken underneath,
and the control fails a limit; true for a sound run. Each drives the rest
of a run (``runner.run_cell`` or a ``runner.Session``, past the look for a
card) on the CPU at a small size: K=8, 2 RK4 substeps, 4 lanes a batch,
the reference on one sampled lane (and the nominal) for at most 12
iterations, the configuration's limits."""

import pytest
import torch

from harness import cells, check, runner
from reference import conic

SMALL = {"solver": {"disc": {"K": 8, "substeps": 2}},
         "check": {"sample": 1, "reference_iters": 12}}
MIX = {"batch": 4, "min_bucket": 2}
# The benchmark's cells, and the 6-DoF rocket's seeded cell, which its
# configuration, mix and reference keep for a later cell on the card.
KEPT = {"name": "rocket6dof_k50.seeded_b512", "config": "rocket6dof_k50",
        "traffic": "seeded_b512", "chips": 1, "why": "kept on the CPU"}


def _spec():
    spec = cells.spec(cells.BENCH.parent)
    spec["workloads"] = spec["workloads"] + [KEPT]
    return spec


CELLS = tuple(w["name"] for w in _spec()["workloads"])


def _run(workload, hook=None):
    torch.set_num_threads(1)
    return runner.run_cell(_spec(), workload,
                           seed=2 ** 31 + 11, seconds=0.5, trace=False,
                           device="cpu", config_over=SMALL, mix_over=MIX,
                           program_hook=hook)


def _wrap_solve(change):
    """A hook that passes each batch's answer through ``change``."""
    def hook(prog):
        solve = prog.solve

        def broken(fields):
            return change(solve(fields))

        prog.solve = broken
    return hook


def _state_unchanged(monkeypatch):
    """Every lockstep SCvx step returns its state unchanged (its counters
    advance, so the sweep still ends at the iteration cap)."""
    def step(model, params, cfg, st, assume_warm_valid=False):
        return st._replace(iterations=st.iterations + 1)

    def hook(prog):
        monkeypatch.setattr(prog.modules["batch"], "scvx_iteration", step)
    return hook


def _half_left_out(st):
    """Half the batch solved; the other half answered by the first half."""
    B = st.X.shape[0]
    idx = torch.arange(B) % max(B // 2, 1)
    return st._replace(X=st.X[idx], U=st.U[idx], sigma=st.sigma[idx])


def _answer_altered(st):
    """One lane's answer altered where it is produced: a position at the
    middle node moved by 1e-2."""
    X = st.X.clone()
    X[0, X.shape[1] // 2, 1] += 1e-2
    return st._replace(X=X)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    if fault == "state_unchanged":
        hook = _state_unchanged(monkeypatch)
    else:
        hook = _wrap_solve({"half_left_out": _half_left_out,
                            "answer_altered": _answer_altered}[fault])
    res = _run(workload, hook)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload):
    """The reference's own solve in TF32, in the program's place on the
    run's sample, fails one of the numbers' limits; the run itself is
    correct."""
    torch.set_num_threads(1)
    s = runner.Session(_spec(), workload, "cpu",
                       config_over=SMALL, mix_over=MIX)
    res = s.measure(2 ** 31 + 13, 0.5, False, control=True)
    assert res["correct"], res["checks"]
    ctrl = {k[len("control."):]: v for k, v in res["checks"].items()
            if k.startswith("control.")}
    assert set(ctrl) == set(check.NUMBERS)
    assert any(v["value"] > v["limit"] for v in ctrl.values()), ctrl


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -9, 3.0])
    assert conic.tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, 3.0]


def test_sample_is_drawn_from_the_seed():
    a = check.pick(2 ** 31 + 5, [512, 512, 300], 4)
    assert a == check.pick(2 ** 31 + 5, [512, 512, 300], 4)
    assert a != check.pick(2 ** 31 + 6, [512, 512, 300], 4)
    assert len(set(a)) == 4
    assert all(0 <= lane < [512, 512, 300][b] for b, lane in a)
