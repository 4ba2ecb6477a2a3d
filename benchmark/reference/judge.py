"""The plain reference's verdict on a batch of solved trajectories.

A solve is judged by what it says: a trajectory (X, U, sigma) that meets
the dynamics, every path constraint and the boundary conditions of its
scenario. The reference integrates each interval of the multiple-shooting
transcription again in float64 (classic RK4 with the configuration's
substeps, first-order hold on the controls, the time dilated by sigma),
with its own model file (``reference/<model>.py``), and reads:

- ``feas``: the L1 sum of the dynamics defect over the intervals plus the
  sum over the nodes of the worst constraint violation: the quantity whose
  floor the configuration states as its feasibility guarantee;
- ``bc``: the largest gap of a pinned boundary value, and of the final
  time where the configuration fixes it.

It imports torch and the model files beside it, nothing of the program,
and takes nothing from the program but the answers it judges.
"""

from __future__ import annotations

import importlib
import math

import torch

EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52}


def model(name: str):
    """The plain model file ``reference/<name>.py``."""
    return importlib.import_module(f"reference.{name}")


def feasibility_floor(config: dict) -> float:
    """The configuration's stated feasibility guarantee: a converged lane's
    defect plus violation lies below max(conv_tol_feas, conv_feas_eps_mult
    * eps * K * nx), eps the machine epsilon of the stated dtype."""
    s, m = config["solver"], model(config["model"])
    eps = EPS[s["dtype"]]
    return max(s["scvx"]["conv_tol_feas"],
               s["scvx"]["conv_feas_eps_mult"] * eps * s["disc"]["K"] * m.NX)


def propagate(m, p: dict, X, U, sigma, substeps: int, foh: bool):
    """End states of every interval, (L, K-1, nx), by RK4 from each node."""
    K = X.shape[1]
    h = 1.0 / (K - 1)
    dt = h / substeps
    uk, uk1 = U[:, :-1], U[:, 1:]
    sig = sigma[:, None, None]

    def xdot(tau, x):
        lam = tau / h if foh else 0.0
        return sig * m.dynamics(p, x, (1.0 - lam) * uk + lam * uk1)

    x = X[:, :-1]
    for i in range(substeps):
        tau = i * dt
        k1 = xdot(tau, x)
        k2 = xdot(tau + dt / 2, x + dt / 2 * k1)
        k3 = xdot(tau + dt / 2, x + dt / 2 * k2)
        k4 = xdot(tau + dt, x + dt * k3)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return m.retract(x)


def judge(config: dict, params: dict, X, U, sigma, block: int = 512) -> dict:
    """Per-lane ``feas`` and ``bc`` (float64 tensors on X's device) of the
    answers (X (L, K, nx), U (L, K, nu), sigma (L,)) to the scenarios
    ``params`` (field -> (L, ...) tensor), computed in blocks of lanes."""
    s = config["solver"]
    m = model(config["model"])
    feas, bc = [], []
    for a in range(0, X.shape[0], block):
        sl = slice(a, a + block)
        p = {k: v[sl].to(torch.float64) for k, v in params.items()}
        x, u, sg = (t[sl].to(torch.float64) for t in (X, U, sigma))
        x_end = propagate(m, p, x, u, sg, s["disc"]["substeps"],
                          s["disc"]["foh"])
        raw = m.defect_coordinates(x[:, 1:], x_end - x[:, 1:])
        defect = raw.abs().sum(dim=(1, 2))
        viol = m.violation(p, x, u).sum(dim=1)
        feas.append(defect + viol)
        gap = m.boundary_gap(p, x)
        if not s["free_final_time"]:
            gap = torch.maximum(gap, (sg - p["tf_guess"]).abs())
        bc.append(gap)
    feas, bc = torch.cat(feas), torch.cat(bc)
    # a lane that is not a number says nothing: it fails both
    bad = ~torch.isfinite(feas) | ~torch.isfinite(bc)
    inf = torch.full_like(feas, math.inf)
    return {"feas": torch.where(bad, inf, feas), "bc": torch.where(bad, inf, bc)}
