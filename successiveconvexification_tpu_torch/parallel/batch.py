"""Batched Monte-Carlo SCvx sweeps (PyTorch port).

The counterpart of the JAX package's ``parallel/batch.py``: the SCvx
iteration advances in lockstep over a batch of dispersed scenarios, with
per-lane convergence masks inside ``scvx_iteration``. The batch-level
``lax.cond`` of the JAX package (warm path vs. general path) is a host branch
on ``torch.isfinite(carry.gap).all()``, and ``lax.while_loop`` a Python loop
that reads the alive count from the device.

``solve_batch_compact_device`` repacks the still-active lanes into smaller
power-of-two buckets every ``chunk`` iterations with a stable argsort and a
gather, so finished lanes stop costing compute. ``solve_batch_seeded`` is
the production dispersion sweep: one cold nominal solve, every lane
warm-started from it, then the compacting sweep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from successiveconvexification_tpu_torch.config import SolverConfig
from successiveconvexification_tpu_torch.models.base import Model
from successiveconvexification_tpu_torch.ops.scvx import (
    ScvxState,
    scvx_init,
    scvx_iteration,
    scvx_solve,
    scvx_warm_start,
    to_device,
)
from successiveconvexification_tpu_torch.utils.tree import tree_map


class BatchStats(NamedTuple):
    n_converged: torch.Tensor
    n_total: torch.Tensor
    mean_iterations: torch.Tensor
    max_iterations: torch.Tensor
    mean_sigma: torch.Tensor
    max_nu_norm: torch.Tensor


def _alive(st: ScvxState, max_iters: int) -> torch.Tensor:
    return (~st.converged) & (st.iterations < max_iters)


def _batch_body(model: Model, params_batch, cfg: SolverConfig,
                st: ScvxState) -> ScvxState:
    """One lockstep batched SCvx iteration (shared by all batch drivers)."""
    if not cfg.ipm.warm_start:
        return scvx_iteration(model, params_batch, cfg, st)
    # one host read decides whether ANY lane needs the cold init this
    # iteration; the all-warm case skips it (and Ruiz, when cold-only)
    warm = bool(torch.isfinite(st.ipm_carry.gap).all())
    return scvx_iteration(model, params_batch, cfg, st, assume_warm_valid=warm)


def _solve_chunk(model: Model, params_batch, cfg: SolverConfig, chunk: int,
                 st: ScvxState) -> ScvxState:
    """Up to ``chunk`` lockstep iterations, stopping early when all are done."""
    for _ in range(chunk):
        if not bool(_alive(st, cfg.scvx.max_iters).any()):
            break
        st = _batch_body(model, params_batch, cfg, st)
    return st


def solve_batch(model: Model, params_batch, cfg: SolverConfig,
                device=None) -> ScvxState:
    """Solve a batch of scenarios (params leaves have a leading batch axis).

    ``device=None`` means the card; pass ``device="cpu"`` for the plain path.
    """
    pb = to_device(params_batch, cfg, device)
    st = scvx_init(model, pb, cfg)
    while bool(_alive(st, cfg.scvx.max_iters).any()):
        st = _batch_body(model, pb, cfg, st)
    return st


def solve_batch_compact_device(model: Model, params_batch, cfg: SolverConfig,
                               chunk: int = 10, min_bucket: int = 64,
                               st0: Optional[ScvxState] = None,
                               bucket_sizes: Optional[tuple] = None,
                               device=None) -> ScvxState:
    """solve_batch with on-device compaction of the unconverged lanes.

    Every ``chunk`` iterations the alive count (one scalar) comes to the
    host and picks the next bucket: the smallest power of two >= the count
    and >= ``min_bucket``, or the smallest allowed size in ``bucket_sizes``.
    The alive lanes are gathered first, in their original order (stable
    argsort), padded with finished lanes, which stay inert. Each lane's math
    is untouched, so per-lane results match ``solve_batch``.
    """
    max_iters = cfg.scvx.max_iters
    pb = to_device(params_batch, cfg, device)
    B = pb.batch_shape[0]
    st = scvx_init(model, pb, cfg) if st0 is None else st0

    def pick_bucket(n):
        if bucket_sizes is not None:
            fits = [b for b in bucket_sizes if b >= max(n, 1)]
            return min(fits) if fits else B
        return max(min_bucket, 1 << (n - 1).bit_length())

    result = st
    idx = torch.arange(B, device=pb.device)
    cur = st
    cur_size = B
    while True:
        cur = _solve_chunk(model, pb, cfg, chunk, cur)
        result = tree_map(lambda r, p: r.index_copy(0, idx, p), result, cur)
        alive = _alive(cur, max_iters)
        n = int(alive.sum())          # the one scalar host read per chunk
        if n == 0:
            break
        bucket = pick_bucket(n)
        if bucket >= cur_size:
            continue
        sel = torch.argsort((~alive).to(torch.int8), stable=True)[:bucket]
        pb = pb.index(sel)
        cur = tree_map(lambda a: a.index_select(0, sel), cur)
        idx = idx.index_select(0, sel)
        cur_size = bucket
    return result


def solve_batch_seeded(model: Model, params_batch, cfg: SolverConfig,
                       nominal_params=None, chunk: int = 10,
                       min_bucket: int = 64, nominal_solution=None,
                       tr_radius=None, bucket_sizes: Optional[tuple] = None,
                       device=None) -> ScvxState:
    """Nominal-seeded Monte-Carlo sweep: solve ONE nominal scenario cold,
    then warm-start every dispersed lane from its trajectory.

    ``scvx_warm_start``'s STM correction carries each lane's initial-state
    offset through the nominal's linearized dynamics, so the lanes start
    dynamically consistent to first order and need far fewer iterations
    than a cold sweep.

    ``nominal_params``: the undispersed scenario (unbatched). Default: the
    per-field mean over the batch axis, which recovers the nominal of
    Gaussian dispersions. ``nominal_solution``: (X (K, nx), U (K, nu),
    sigma) of an already-solved nominal, tensors or arrays, for a campaign
    that solves the nominal once for many batches; it is put on the
    params' device in the config's dtype. ``tr_radius``: the seeded lanes'
    initial trust radius (``scvx_warm_start``'s default when None).
    ``device=None`` means the card.
    """
    pb = to_device(params_batch, cfg, device)
    if nominal_solution is None:
        if nominal_params is None:
            nominal_params = pb.map(lambda v, tail: v.mean(dim=0))
        nom = scvx_solve(model, nominal_params, cfg, device=pb.device)
        nominal_solution = (nom.X[0], nom.U[0], nom.sigma[0])
    dtype = getattr(torch, cfg.dtype)
    Xn, Un, sn = (torch.as_tensor(a, dtype=dtype, device=pb.device)
                  for a in nominal_solution)
    st0 = scvx_warm_start(model, pb, cfg, Xn, Un, sn, tr_radius=tr_radius)
    return solve_batch_compact_device(model, pb, cfg, chunk=chunk,
                                      min_bucket=min_bucket, st0=st0,
                                      bucket_sizes=bucket_sizes,
                                      device=pb.device)

def batch_stats(st: ScvxState) -> BatchStats:
    conv = st.converged
    return BatchStats(
        n_converged=conv.to(torch.int32).sum(),
        n_total=torch.tensor(conv.shape[0], dtype=torch.int32),
        mean_iterations=st.iterations.to(torch.float32).mean(),
        max_iterations=st.iterations.max(),
        mean_sigma=st.sigma.mean(),
        max_nu_norm=st.nu_norm.max(),
    )


def sample_dispersions(params, generator: torch.Generator, batch: int, *,
                       r_std=0.3, v_std=0.2, m_frac_std=0.05):
    """Monte-Carlo dispersion sampler: perturb the initial position, velocity
    and wet mass of unbatched ``params``. Deterministic in the generator's
    state; the draws come from the generator's device and land on the
    params' device. (The numbers differ from the JAX package's
    ``jax.random`` draws for the same seed.)"""
    dtype, dev = params.dtype, params.device
    gdev = generator.device

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=gdev).to(dev)

    pb = params.map(lambda v, tail: v.expand((batch,) + v.shape).clone())
    r0 = pb.r_init + r_std * randn(batch, 3)
    v0 = pb.v_init + v_std * randn(batch, 3)
    m0 = pb.m_wet * (1.0 + m_frac_std * randn(batch))
    return pb.replace(r_init=r0, v_init=v0, m_wet=m0)
