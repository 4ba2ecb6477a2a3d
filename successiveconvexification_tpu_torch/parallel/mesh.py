"""The scenario axis of a sweep split over ``torch.distributed`` ranks.

The counterpart of the JAX package's ``parallel/mesh.py``. There a
``jax.sharding.Mesh`` spans every process's chips and XLA compiles the
reductions of a sharded sweep; here each rank is one process with one
device, and the few reductions a sweep needs (the warm test, the alive
count, the statistics) are explicit collectives over the process group:
NCCL between cards, gloo between CPU processes.

A ``Mesh`` holds the rank, the world size, the rank's device and the
process group (``None`` for a single process). Rank r keeps the contiguous
tile ``[r B / W, (r + 1) B / W)`` of a batch of B lanes, the tile JAX's
``P("scenario")`` gives, so lane i is the same scenario whatever the world
size. Every rank draws the whole batch from the same seed and keeps its own
lanes (``shard_scenario_tree``); ``gather_scenario_tree`` puts the lanes
back together in lane order. The K-sharded KKT backend
(``parallel/kkt_sharded.py``) splits the node axis over the same ranks,
with ``Mesh.shift`` (a neighbour exchange) and ``Mesh.all_gather``.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from successiveconvexification_tpu_torch.ops.precision import resolve_device
from successiveconvexification_tpu_torch.utils.tree import tree_map

# a lost peer ends a collective with an error after this long, not a hang
TIMEOUT = datetime.timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the scenario axis."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None   # torch.distributed.ProcessGroup

    def scenario_slice(self, batch: int) -> slice:
        """This rank's contiguous tile of a batch of ``batch`` lanes."""
        if batch % self.world:
            raise ValueError(f"a batch of {batch} lanes does not divide over "
                             f"{self.world} ranks")
        b = batch // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` reduced over every rank (``t`` itself for one process)."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """Rank r's ``t`` as rank r + step receives it (step +1 or -1); the
        rank that no neighbour sends to gets zeros (JAX's ``ppermute``)."""
        src, dst = self.rank - step, self.rank + step
        out = torch.zeros_like(t)
        ops = []
        if 0 <= dst < self.world:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst,
                                  group=self.group))
        if 0 <= src < self.world:
            ops.append(dist.P2POp(dist.irecv, out, src, group=self.group))
        if ops:   # none for one process
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked on a new leading axis, in rank order,
        on every rank (``t[None]`` for one process)."""
        if self.world == 1:
            return t[None]
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)

    def barrier(self) -> None:
        """Return once every rank has called it (a no-op for one process)."""
        self.all_reduce(torch.zeros(1, device=self.device),
                        dist.ReduceOp.SUM)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device=None) -> Mesh:
    """Join the process group at ``coordinator`` (``HOST:PORT``; rank 0
    listens there) as rank ``process_id`` of ``num_processes`` and return
    its mesh. NCCL for a CUDA device (``device=None`` means the card), gloo
    for the CPU; NCCL is never replaced by gloo. A peer that does not answer
    within ``TIMEOUT`` ends the run with an error. Call
    ``destroy_process_group`` when the run ends."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA device needs the NCCL backend, and "
                               "this torch has none")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        backend, extra = "nccl", {"device_id": dev}
    else:
        backend, extra = "gloo", {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT, **extra)
    return Mesh(rank=process_id, world=num_processes, device=dev,
                group=dist.group.WORLD)


def destroy_process_group() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(device=None) -> Mesh:
    """The mesh of a single process: world size 1, no process group."""
    return Mesh(rank=0, world=1, device=resolve_device(device))


def shard_scenario_tree(tree, mesh: Mesh):
    """This rank's lanes of a batched tree (tensors, or a model's params):
    every leaf's leading axis cut to ``mesh.scenario_slice``. Leaves
    without a batch axis are kept whole."""
    if hasattr(tree, "map"):          # models.base.Params
        sl = mesh.scenario_slice(tree.batch_shape[0])
        return tree.map(lambda v, tail: v[sl])
    return tree_map(lambda t: t if t.dim() == 0
                    else t[mesh.scenario_slice(t.shape[0])], tree)


def gather_scenario_tree(tree, mesh: Mesh):
    """The whole batch from every rank's lanes, in lane order, on every
    rank. Leaves without a batch axis are returned as they are."""
    if mesh.group is None:
        return tree

    def gather(t):
        if t.dim() == 0:
            return t
        # gloo has no bool collectives: carry flags as bytes
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.world)]
        dist.all_gather(parts, src, group=mesh.group)
        out = torch.cat(parts, dim=0)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    return tree_map(gather, tree)
