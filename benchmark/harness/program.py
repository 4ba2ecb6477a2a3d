"""The system under test: the PyTorch and CUDA port, driven through its
public entry points only.

A configuration file names the model (``<model>_model()`` in the package,
its params class in ``models/<model>.py``) and the solver settings
(``SolverConfig.from_dict``); a traffic mix names the sweep entry
(``solve_batch_seeded`` or ``solve_batch_compact_device``) with its chunk
and minimum bucket, and whether a nominal is solved first.
"""

from __future__ import annotations

import importlib

import torch

PACKAGE = "successiveconvexification_tpu_torch"


class Program:
    def __init__(self, config: dict, mix: dict, device):
        self.P = importlib.import_module(PACKAGE)
        self.modules = {
            "batch": importlib.import_module(f"{PACKAGE}.parallel.batch"),
            "scvx": importlib.import_module(f"{PACKAGE}.ops.scvx"),
            "socp": importlib.import_module(f"{PACKAGE}.ops.socp"),
            "ipm": importlib.import_module(f"{PACKAGE}.ops.ipm"),
            "cuda_fused": importlib.import_module(f"{PACKAGE}.ops.cuda_fused"),
            "cuda_kkt": importlib.import_module(f"{PACKAGE}.ops.cuda_kkt"),
            "cuda_disc": importlib.import_module(f"{PACKAGE}.ops.cuda_disc"),
        }
        models = importlib.import_module(f"{PACKAGE}.models.{config['model']}")
        self.model = getattr(self.P, f"{config['model']}_model")()
        self.params_type = type(models.default_params())
        self.cfg = self.P.SolverConfig.from_dict(config["solver"])
        self.mix = mix
        self.device = torch.device(device)
        self.nominal = None

    def build(self) -> None:
        """Build (first run in a checkout) and load the kernels."""
        if self.device.type == "cuda":
            build = importlib.import_module(f"{PACKAGE}.ops._build")
            build.build_all()
            for name in build.SOURCES:
                build.library(name)

    def params(self, fields: dict, lane: int | None = None):
        pick = (lambda v: v) if lane is None else (lambda v: v[lane])
        return self.params_type(**{k: pick(fields[k])
                                   for k in self.params_type.TAIL})

    def solve_nominal(self, fields: dict):
        """The nominal solved cold (``scvx_solve``), kept for the batches;
        returns its state (a batch of one lane)."""
        st = self.P.scvx_solve(self.model, self.params(fields, lane=0),
                               self.cfg, device=self.device)
        self.nominal = (st.X[0], st.U[0], st.sigma[0])
        return st

    def solve(self, fields: dict):
        """One batch through the mix's sweep entry."""
        entry = getattr(self.P, self.mix["entry"])
        kw = {"chunk": self.mix["chunk"], "min_bucket": self.mix["min_bucket"],
              "device": self.device}
        if self.mix["nominal"]:
            kw["nominal_solution"] = self.nominal
        return entry(self.model, self.params(fields), self.cfg, **kw)

    def warm_up(self, fields: dict) -> None:
        """One lockstep iteration of each branch (cold init, warm) at the
        batch's width, from the state the entry starts from."""
        P, pb = self.P, self.params(fields)
        if self.mix["nominal"]:
            st = P.scvx_warm_start(self.model, pb, self.cfg, *self.nominal)
        else:
            st = P.scvx_init(self.model, pb, self.cfg)
        st = P.scvx_iteration(self.model, pb, self.cfg, st)
        P.scvx_iteration(self.model, pb, self.cfg, st,
                         assume_warm_valid=bool(
                             torch.isfinite(st.ipm_carry.gap).all()))

    def floor_met(self, st) -> torch.Tensor:
        """Lanes the program reports converged within its feasibility floor."""
        s = self.cfg.scvx
        tol = max(s.conv_tol_feas, s.conv_feas_eps_mult
                  * torch.finfo(st.X.dtype).eps * st.X[0].numel())
        return st.converged & ((st.defect_nl + st.viol_nl) < tol)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
