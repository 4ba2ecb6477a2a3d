"""Batched Monte-Carlo SCvx sweeps (PyTorch port).

The counterpart of the JAX package's ``parallel/batch.py``: the SCvx
iteration advances in lockstep over a batch of dispersed scenarios, with
per-lane convergence masks inside ``scvx_iteration``. The batch-level
``lax.cond`` of the JAX package (warm path vs. general path) is a host branch
on ``torch.isfinite(carry.gap).all()``, and ``lax.while_loop`` a Python loop
that reads the alive count from the device.

``solve_batch_compact_device`` repacks the still-active lanes into smaller
power-of-two buckets every ``chunk`` iterations with a stable argsort and a
gather, so finished lanes stop costing compute; ``solve_batch_compact``
packs the same way on the host, from a copy of the whole state it pulls
down every chunk. ``solve_batch_seeded`` is
the production dispersion sweep: one cold nominal solve, every lane
warm-started from it, then the compacting sweep.

Over several processes (``parallel/mesh.py``) each rank sweeps its own
tile of lanes. In the JAX package the sharded sweep is one program over
global arrays, so its warm test and its alive test see the whole batch;
here the drivers that take a ``mesh`` reduce both over every rank, one
small ``all_reduce`` at each host read, so a rank's lanes follow the same
branches as in the unsharded sweep and every rank runs the same number of
iterations. ``run_batch`` is the production driver on top: the sharded
sweep in chunks, each chunk committed as a sharded checkpoint
(``io/checkpoint.py``), and a resume from the last commit on restart.
"""

from __future__ import annotations

import glob
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from successiveconvexification_tpu_torch.config import SolverConfig
from successiveconvexification_tpu_torch.io import checkpoint as ckpt_lib
from successiveconvexification_tpu_torch.models.base import Model
from successiveconvexification_tpu_torch.ops.scvx import (
    ScvxState,
    scvx_init,
    scvx_iteration,
    scvx_solve,
    scvx_warm_start,
    to_device,
)
from successiveconvexification_tpu_torch.parallel import mesh as mesh_lib
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


def _any_alive(st: ScvxState, max_iters: int, mesh=None) -> bool:
    """Whether any lane of the whole batch is alive: one host read, and with
    a mesh one all-reduce of the alive count over every rank."""
    if mesh is None:
        return bool(_alive(st, max_iters).any())
    n = _alive(st, max_iters).sum(dtype=torch.int32).reshape(1)
    return int(mesh.all_reduce(n, dist.ReduceOp.SUM)) > 0


def _batch_body(model: Model, params_batch, cfg: SolverConfig,
                st: ScvxState, mesh=None) -> ScvxState:
    """One lockstep batched SCvx iteration (shared by all batch drivers)."""
    if not cfg.ipm.warm_start:
        return scvx_iteration(model, params_batch, cfg, st)
    # one host read decides whether ANY lane needs the cold init this
    # iteration; the all-warm case skips it (and Ruiz, when cold-only).
    # With a mesh the flag is the minimum over every rank's lanes, so a
    # rank whose own lanes are all warm still takes the cold branch when
    # another rank's are not, as the unsharded sweep does.
    warm = torch.isfinite(st.ipm_carry.gap).all()
    if mesh is not None:
        warm = mesh.all_reduce(warm.to(torch.int32).reshape(1),
                               dist.ReduceOp.MIN)
    return scvx_iteration(model, params_batch, cfg, st,
                          assume_warm_valid=bool(warm))


def _solve_chunk(model: Model, params_batch, cfg: SolverConfig, chunk: int,
                 st: ScvxState, mesh=None) -> ScvxState:
    """Up to ``chunk`` lockstep iterations, stopping early when all are done."""
    for _ in range(chunk):
        if not _any_alive(st, cfg.scvx.max_iters, mesh):
            break
        st = _batch_body(model, params_batch, cfg, st, mesh)
    return st


def solve_batch(model: Model, params_batch, cfg: SolverConfig,
                device=None, mesh=None) -> ScvxState:
    """Solve a batch of scenarios (params leaves have a leading batch axis).

    ``device=None`` means the card; pass ``device="cpu"`` for the plain path.
    With a ``mesh``, ``params_batch`` holds this rank's lanes, and the loop
    runs while any lane of any rank is alive.
    """
    pb = to_device(params_batch, cfg, device)
    st = scvx_init(model, pb, cfg)
    while _any_alive(st, cfg.scvx.max_iters, mesh):
        st = _batch_body(model, pb, cfg, st, mesh)
    return st


def solve_batch_compact(model: Model, params_batch, cfg: SolverConfig,
                        chunk: int = 10, min_bucket: int = 8,
                        device=None) -> ScvxState:
    """solve_batch with host-side compaction of the unconverged lanes.

    Every ``chunk`` iterations the whole state comes to the host (numpy)
    and is scattered into a full-size host result by the packed -> original
    index; the alive mask is read from that copy and picks the next bucket,
    the smallest power of two >= the count and >= ``min_bucket`` (no repack
    where it does not shrink). The alive lanes go first in their order,
    padded with the lowest finished lanes, which stay inert; the params are
    regathered from the original host copy and the state goes back to the
    device. The packing is ``solve_batch_compact_device``'s, so at the same
    ``chunk`` and ``min_bucket`` both give the same final state. The result
    is on the params' device.
    """
    max_iters = cfg.scvx.max_iters
    pb = to_device(params_batch, cfg, device)
    dev = pb.device
    B = pb.batch_shape[0]
    cur = scvx_init(model, pb, cfg)

    def to_host(t):
        return t.detach().to("cpu", copy=True).numpy()

    params_np = pb.map(lambda v, tail: to_host(v))
    result = tree_map(to_host, cur)               # full-size host buffers
    idx = np.arange(B)                            # packed -> original map

    def scatter(r, p):
        r[idx] = p
        return r

    while True:
        cur = _solve_chunk(model, pb, cfg, chunk, cur)
        host = tree_map(to_host, cur)
        result = tree_map(scatter, result, host)
        alive = (~host.converged) & (host.iterations < max_iters)
        n = int(alive.sum())
        if n == 0:
            break
        bucket = max(min_bucket, 1 << (n - 1).bit_length())
        if bucket >= len(idx):
            continue    # no repack win; keep the current packing
        sel = np.concatenate([np.flatnonzero(alive),
                              np.flatnonzero(~alive)[: bucket - n]])
        idx = idx[sel]
        pb = params_np.map(lambda v, tail: torch.from_numpy(v[idx]).to(dev))
        cur = tree_map(lambda a: torch.from_numpy(a[sel]).to(dev), host)

    return tree_map(lambda a: torch.from_numpy(a).to(dev), result)


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

def _mesh_device(mesh, device):
    """The device of a sharded run: ``device``, else the mesh's."""
    return device if device is not None or mesh is None else mesh.device


def solve_batch_sharded(model: Model, params_batch, cfg: SolverConfig,
                        mesh=None, device=None) -> ScvxState:
    """``solve_batch`` with the scenario axis split over the ranks of
    ``mesh`` (default: this process alone). ``params_batch`` is the GLOBAL
    batch, the same on every rank; the result is this rank's lanes
    (``mesh_lib.gather_scenario_tree`` puts the batch back together)."""
    if mesh is None:
        mesh = mesh_lib.make_mesh(device)
    pb = mesh_lib.shard_scenario_tree(params_batch, mesh)
    return solve_batch(model, pb, cfg, device=_mesh_device(mesh, device),
                       mesh=mesh)


class _Committer:
    """``run_batch``'s commits: each rank writes its lanes' shard file
    (``checkpoint.save_sharded``), on a writer thread when ``async_ckpt``.

    Torch tensors are mutable and may live on the card, so the host copies
    are taken on the calling thread before the writer starts (``.to("cpu",
    copy=True)`` waits for the stream), and the writer holds only them: it
    cannot write a later state than the step it names. The previous writer
    is joined before the next commit and at the end, and then every rank
    meets at a barrier: no rank starts writing step s before every rank's
    step before it is on disk, so the files on disk hold one step, or two
    while a commit is being written. Past that barrier, rank 0 removes the
    shard files of ranks this world does not have (a larger ensemble's,
    resumed by a smaller one), whose older step would mix the checkpoint."""

    def __init__(self, path: str, cfg: SolverConfig, mesh, async_ckpt: bool):
        self.path, self.cfg, self.mesh = path, cfg, mesh
        self.async_ckpt = async_ckpt
        self.writer: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None
        self.committed = False

    def _write(self, host, step: int) -> None:
        try:
            ckpt_lib.save_sharded(self.path, host, mesh=self.mesh,
                                  cfg=self.cfg, step=step)
        except Exception as e:   # re-raised on the calling thread by join
            self.error = e

    def join(self) -> None:
        if self.writer is not None:
            self.writer.join()
            self.writer = None
        if self.error is not None:
            raise RuntimeError("writing a sweep checkpoint failed") \
                from self.error

    def _settle(self) -> None:
        """Join, meet every rank, and drop the files of absent ranks."""
        self.join()
        self.mesh.barrier()
        if self.committed and self.mesh.rank == 0:
            ckpt_lib.remove_shards(self.path, first=self.mesh.world)

    def __call__(self, st: ScvxState, step: int) -> None:
        self._settle()
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), st)
        self.committed = True
        if self.async_ckpt:
            self.writer = threading.Thread(target=self._write,
                                           args=(host, step))
            self.writer.start()
        else:
            self._write(host, step)

    def close(self) -> None:
        """The last commit on disk on every rank."""
        self._settle()


def run_batch(model: Model, params_batch, cfg: SolverConfig, *,
              mesh=None, ckpt_path: Optional[str] = None,
              ckpt_every: int = 10, resume: bool = True,
              async_ckpt: bool = True, device=None) -> ScvxState:
    """Production sweep driver (the JAX package's ``run_batch``).

    ``params_batch`` is the GLOBAL batch; the scenario axis is split over
    the ranks of ``mesh`` (default: this process alone), and the result is
    this rank's lanes. The sweep runs in chunks of ``ckpt_every`` lockstep
    iterations while any lane of the whole batch is alive. After each
    chunk, with ``ckpt_path``, every rank commits its lanes to
    ``{ckpt_path}.shard{rank}.npz`` (``_Committer``). With ``resume`` and
    shard files present, the sweep restores them
    (``checkpoint.restore_sharded``, which refuses missing tiles, another
    config and mixed steps) and goes on from their step.
    """
    if mesh is None:
        mesh = mesh_lib.make_mesh(device)
    pb = to_device(mesh_lib.shard_scenario_tree(params_batch, mesh), cfg,
                   _mesh_device(mesh, device))
    st = scvx_init(model, pb, cfg)

    outer = 0
    if ckpt_path and resume and glob.glob(f"{ckpt_path}.shard*.npz"):
        st = ckpt_lib.restore_sharded(ckpt_path, st, mesh=mesh, cfg=cfg)
        outer = ckpt_lib.sharded_step(ckpt_path)

    commit = _Committer(ckpt_path, cfg, mesh, async_ckpt) if ckpt_path else None
    try:
        while _any_alive(st, cfg.scvx.max_iters, mesh):
            st = _solve_chunk(model, pb, cfg, ckpt_every, st, mesh)
            outer += ckpt_every
            if commit is not None:
                commit(st, outer)
        if commit is not None:
            commit.close()
    finally:
        if commit is not None:
            commit.join()     # on an error: no barrier a lost peer would hold
    return st


def batch_stats(st: ScvxState, mesh=None) -> BatchStats:
    """The sweep's statistics. With a ``mesh``, over the whole batch: the
    per-lane vectors are gathered in lane order and reduced as one batch, so
    the record is the unsharded sweep's."""
    lanes = (st.converged, st.iterations, st.sigma, st.nu_norm)
    if mesh is not None:
        lanes = mesh_lib.gather_scenario_tree(lanes, mesh)
    conv, iterations, sigma, nu_norm = lanes
    return BatchStats(
        n_converged=conv.to(torch.int32).sum(),
        n_total=torch.tensor(conv.shape[0], dtype=torch.int32),
        mean_iterations=iterations.to(torch.float32).mean(),
        max_iterations=iterations.max(),
        mean_sigma=sigma.mean(),
        max_nu_norm=nu_norm.max(),
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
