"""How ``correct`` is decided: the plain reference's readings of the answers
the window produced (and of the nominal set-up solved), each compared with
its limit from the configuration file's ``check``.

- ``feas_ratio``: the largest, over every lane of every batch, of the
  reference's float64 defect plus violation (``reference/judge.py``) over
  the configuration's stated feasibility floor. A lane the program did not
  solve fails it too: every lane of a campaign is due.
- ``bc_gap``: the largest gap of a pinned boundary value (and of a fixed
  final time) over every lane.
- ``merit_excess``: on a sample of ``check.sample`` lanes drawn from the
  seed, and the nominal, which the reference solves itself from each
  scenario (``reference/scvx.py``, float64): the largest of (J(answer) -
  J(reference's)) / |reference's objective|, J the configuration's merit:
  its objective plus w_nu times the judged defect plus violation. A
  feasible answer above the optimum, or an infeasible one, reads high.

The control is the reference's own solve in TF32 (``conic.Arith("tf32")``)
put in the program's place on the same sample, judged the same way.
"""

from __future__ import annotations

import math
import time

import torch

from harness.traffic import stream_seed
from reference import conic
from reference import judge as ref
from reference import scvx

NUMBERS = ("feas_ratio", "bc_gap", "merit_excess")


def pick(seed: int, sizes, count: int) -> list:
    """``count`` (batch, lane) pairs drawn from the seed among the window's
    batches of ``sizes`` lanes, without repeats."""
    total = sum(sizes)
    gen = torch.Generator()
    gen.manual_seed(stream_seed(seed, -2))
    flat = torch.randperm(total, generator=gen)[:min(count, total)].tolist()
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    out = []
    for f in sorted(flat):
        b = max(i for i, s in enumerate(starts) if s <= f)
        out.append((b, f - starts[b]))
    return out


def gather(answers, picks, extra=None):
    """The picked lanes of ``answers`` (a list of (fields, X, U, sigma)
    batches), with every lane of ``extra`` after them, as one batch."""
    rows = [tuple(t[lane:lane + 1] if torch.is_tensor(t) else
                  {k: v[lane:lane + 1] for k, v in t.items()}
                  for t in answers[b]) for b, lane in picks]
    if extra is not None:
        rows.append(extra)
    fields = {k: torch.cat([r[0][k] for r in rows]) for k in rows[0][0]}
    return (fields,) + tuple(torch.cat([r[i] for r in rows]) for i in (1, 2, 3))


def merit(config: dict, fields, X, U, sigma):
    """(J, objective) per lane, in float64."""
    s = config["solver"]["scvx"]
    v = ref.judge(config, fields, X, U, sigma)
    sig = sigma.to(torch.float64)
    obj = s["w_sigma"] * sig - s["w_mass"] * X[:, -1, 0].to(torch.float64)
    return obj + s["w_nu"] * v["feas"], obj


def solve_reference(config: dict, fields, arith: str = "float64"):
    """The reference's own answers (X, U, sigma) to the scenarios, and how
    many of its lanes reached a stationary point."""
    out = scvx.solve(config, fields, conic.Arith(arith),
                     max_iters=config["check"]["reference_iters"])
    return (out["X"], out["U"], out["sigma"]), int(out["stationary"].sum())


def readings(config: dict, answers, sampled, reference) -> dict:
    """The numbers of ``answers`` (a list of (fields, X, U, sigma)
    batches), with ``sampled`` the answers on the reference's sample and
    ``reference`` the reference's (X, U, sigma) there."""
    floor = ref.feasibility_floor(config)
    feas, bc = 0.0, 0.0
    for fields, X, U, sigma in answers:
        v = ref.judge(config, fields, X, U, sigma)
        feas = max(feas, float(v["feas"].max()) / floor)
        bc = max(bc, float(v["bc"].max()))
    fields = sampled[0]
    j_ans, _ = merit(config, *sampled)
    j_ref, obj_ref = merit(config, fields, *reference)
    excess = float(((j_ans - j_ref) / obj_ref.abs()).max())
    if not math.isfinite(excess):
        excess = math.inf
    return {"feas_ratio": feas, "bc_gap": bc, "merit_excess": excess}


def judge_run(config: dict, answers, nominal, seed: int,
              control: bool = False) -> tuple[dict, dict | None, dict]:
    """The run's numbers and, with ``control``, the control's on the same
    sample; and the seconds each solve of the reference took, with how many
    of the sample's lanes it brought to a stationary point."""
    picks = pick(seed, [a[1].shape[0] for a in answers],
                 config["check"]["sample"])
    sampled = gather(answers, picks, nominal)
    t0 = time.perf_counter()
    reference, stationary = solve_reference(config, sampled[0])
    secs = {"reference_s": time.perf_counter() - t0,
            "reference_stationary": stationary,
            "reference_lanes": sampled[1].shape[0]}
    numbers = readings(config, answers + ([nominal] if nominal else []),
                       sampled, reference)
    ctrl = None
    if control:
        t0 = time.perf_counter()
        c, _ = solve_reference(config, sampled[0], "tf32")
        secs["control_s"] = time.perf_counter() - t0
        ctrl = readings(config, [(sampled[0],) + c], (sampled[0],) + c,
                        reference)
    return numbers, ctrl, secs


def verdict(config: dict, numbers: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); a number passes when it is
    at most its limit, and no limit set reads as failed."""
    limits = config.get("check", {})
    checks, ok = {}, True
    for name in NUMBERS:
        value, limit = numbers[name], limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) \
            and value <= limit
    return ok, checks
