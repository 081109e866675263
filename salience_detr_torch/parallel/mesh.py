"""Process group, rank layout and batch sharding (port of
salience_detr_tpu/parallel/mesh.py).

The JAX package shards the global batch over a 1-D ``dp`` mesh and lets XLA
insert the gradient all-reduce.  The port runs one process per card under a
launcher (``torchrun --nproc_per_node N -m salience_detr_torch.train ...``),
each holding a slice of every global batch, with the collectives below:

* :func:`init_distributed` joins the process group the launcher's variables
  describe (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU.  Without
  those variables (one process, no launcher) it joins nothing, as the JAX
  ``init_distributed`` does without a coordinator.  A group that fails to
  form raises; the program never carries on as a single process.
* :class:`Mesh` (:func:`make_mesh`) holds the rank, the world size, the
  device and a gloo side group for host tensors and pickled objects, so that
  neither the per-step gt counts nor the evaluator's predictions pass
  through the card.
* :func:`shard_batch` takes the rank's rows of a global batch: with A
  micro-batches, micro-batch ``a`` is rows [a B / A, (a + 1) B / A) of the
  global batch (the JAX step's split), and the rank holds slice ``rank`` of
  each, so its own A consecutive micro-batches are its slices of the global
  ones.
* The collectives use only ``all_reduce`` and ``broadcast`` on device
  tensors (gloo supports no other collective on CUDA tensors) and
  ``all_gather_object`` on the host group.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """The data-parallel layout of this process: ``rank`` of ``world``, its
    ``device``, and ``host_group``, a gloo group over the same ranks for host
    tensors and objects (None in a single process)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    host_group: Any = None

    @property
    def distributed(self) -> bool:
        """Whether this process is one rank of a process group (a world of
        one under the launcher included)."""
        return self.host_group is not None

    def rows(self, batch: int, accumulate_steps: int = 1) -> List[int]:
        """This rank's rows of a global batch (:func:`shard_rows`)."""
        return shard_rows(batch, self.rank, self.world, accumulate_steps)

    def barrier(self):
        if self.distributed:
            dist.barrier(group=self.host_group)

    def all_gather_object(self, obj) -> List[Any]:
        """Every rank's ``obj``, in rank order, pickled over the host group."""
        if not self.distributed:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        return box[0]

    def host_sum(self, values: torch.Tensor) -> torch.Tensor:
        """Sum of a host (CPU) tensor over the ranks, on the host group: no
        device synchronisation."""
        if not self.distributed:
            return values
        values = values.clone()
        dist.all_reduce(values, group=self.host_group)
        return values


def shard_rows(batch: int, rank: int, world: int, accumulate_steps: int = 1) -> List[int]:
    """Rank ``rank``'s rows of a global batch of ``batch`` images, micro-batch
    by micro-batch: slice ``rank`` of each of the ``accumulate_steps``
    micro-batches; raises when ``batch`` is not divisible by
    ``accumulate_steps * world``."""
    A = max(accumulate_steps, 1)
    if batch % (A * world):
        raise ValueError(f"global batch {batch} is not divisible by --accumulate-steps {A} x world size {world}")
    micro, local = batch // A, batch // (A * world)
    return [a * micro + rank * local + j for a in range(A) for j in range(local)]


def launched() -> bool:
    """Whether the launcher's variables describe a process group."""
    return all(v in os.environ for v in LAUNCHER_VARS)


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> Mesh:
    """Join the process group of the launcher's variables; returns this
    process's :class:`Mesh`.  ``device`` "cuda" means ``cuda:LOCAL_RANK``
    under the launcher (it raises when that device is missing), "cpu" the
    CPU; ``backend`` defaults to NCCL on CUDA and gloo on the CPU (gloo on
    CUDA runs several ranks on one card, which NCCL refuses).  Without the
    launcher's variables it joins nothing and returns a one-process mesh on
    ``device``."""
    dev = torch.device(device)
    if not launched():
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
        return Mesh(device=dev)
    rank, world, local = (int(os.environ[v]) for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if dev.type == "cuda":
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: device cuda:{local} (LOCAL_RANK) requested but "
                               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA devices "
                               "are available")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, timeout=timeout)
    host_group = dist.new_group(backend="gloo", timeout=timeout) if backend != "gloo" else dist.group.WORLD
    return Mesh(rank, world, dev, host_group)


def make_mesh(device: str = "cuda", backend: Optional[str] = None) -> Mesh:
    """The JAX package's name: :func:`init_distributed`."""
    return init_distributed(device, backend)


def shutdown(mesh: Mesh):
    """Leave the process group (a no-op in a single process)."""
    if mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()


def take_rows(x, rows: Sequence[int]):
    """Rows of an array or tensor (a copy), of a list or tuple (a tuple)."""
    if isinstance(x, np.ndarray):
        return x[np.asarray(rows, np.int64)]
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(rows, dtype=torch.long, device=x.device)]
    return tuple(x[i] for i in rows)


def shard_batch(batch: Dict[str, Any], mesh: Mesh, accumulate_steps: int = 1) -> Dict[str, Any]:
    """The rank's rows (:meth:`Mesh.rows`) of a global batch: a ``pack_batch``
    dict of arrays or a device batch whose ``targets`` is a ``Targets``."""
    from salience_detr_torch.models.bricks.criterion import Targets

    first = batch["images"]
    rows = mesh.rows(len(first), accumulate_steps)
    out = {}
    for k, v in batch.items():
        if isinstance(v, Targets):
            out[k] = Targets(*(take_rows(x, rows) for x in v[:4]))
        else:
            out[k] = take_rows(v, rows)
    return out


class AllReduceSum(torch.autograd.Function):
    """Differentiable sum over the ranks of ``group``: the backward of a sum
    all-reduce is the sum all-reduce of the gradients (each rank's loss
    reads the summed value).  ``torch.distributed.nn.functional.all_reduce``
    would do the same, and warns that it is deprecated."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, differentiable: bool = False, group=None) -> torch.Tensor:
    """Sum of a device tensor over the ranks of ``group`` (the default group
    when None; the identity outside a process group)."""
    if not dist.is_initialized():
        return x
    if differentiable:
        return AllReduceSum.apply(x, group)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the ranks of the default group, in one
    all-reduce (the metrics themselves outside a process group): the global
    batch's losses from the ranks' own."""
    if not dist.is_initialized() or not metrics:
        return metrics
    keys = list(metrics)
    stacked = all_reduce_sum(torch.stack([metrics[k].float() for k in keys])) / dist.get_world_size()
    return dict(zip(keys, stacked.unbind(0)))
