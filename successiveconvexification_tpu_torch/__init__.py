"""PyTorch/CUDA port of the successive convexification (SCvx) engine.

A second package beside ``successiveconvexification_tpu`` (the JAX
reference), with the same module names where a reader looks for a
counterpart. It imports ``torch`` only. Plain tensor code is PyTorch; the
discretize kernel and the KKT kernels of the IPM (six kernels so far) are
CUDA C++ for Hopper (``csrc/``), built with nvcc on first use and bound
with ctypes. Every tensor carries an explicit
scenario axis where the JAX package used ``vmap``.

Entry points take ``device=None``, meaning the card; they raise when no card
is present unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions.
"""

from successiveconvexification_tpu_torch.config import (
    DiscretizationConfig,
    IPMConfig,
    ScvxConfig,
    SolverConfig,
)
from successiveconvexification_tpu_torch.models import (
    Rocket6DoFParams,
    rocket6dof_model,
)
from successiveconvexification_tpu_torch.ops.scvx import (
    ScvxState,
    scvx_init,
    scvx_iteration,
    scvx_solve,
    scvx_warm_start,
)
from successiveconvexification_tpu_torch.parallel.batch import (
    batch_stats,
    sample_dispersions,
    solve_batch,
    solve_batch_compact_device,
)

__all__ = [
    "DiscretizationConfig",
    "IPMConfig",
    "ScvxConfig",
    "SolverConfig",
    "Rocket6DoFParams",
    "rocket6dof_model",
    "ScvxState",
    "scvx_init",
    "scvx_iteration",
    "scvx_solve",
    "scvx_warm_start",
    "solve_batch",
    "solve_batch_compact_device",
    "batch_stats",
    "sample_dispersions",
]
