"""The data-parallel process group (port of ``xview2_tpu/parallel/mesh.py``).

JAX runs ``--gpus N`` as one program over a 1-D ``data`` mesh: the batch is
sharded on axis 0, parameters and optimizer state are replicated, and GSPMD
derives the collectives (the gradient all-reduce, sync-BN's moment
all-reduce, the loss and F1 reductions).  The port runs it the PyTorch way,
one process per GPU, and spells those collectives out:

- :func:`global_sum` sums tensors over the ranks: every batch statistic of
  BatchNorm, K2's per-channel sums, each loss's numerator and denominator
  and the F1 counts go through it, so each rank computes the single-device
  value on the global batch;
- :func:`average_gradients` all-reduces the gradients as one flat bucket
  per dtype and divides by N between the backward and the update;
- :func:`broadcast_module` copies rank 0's parameters and buffers to the
  others before the first step, as DDP does;
- :func:`run_on_main` lets rank 0 alone write a file every rank reads
  (the index, the checkpoints, the eval dumps' clean-up), then waits.

Why SUM in the forward, SUM of the cotangent in the backward, then a mean
of the gradients gives the exact global gradient: the loss ``L`` is a
function of global sums ``S = sum_r s_r`` only, so every rank computes the
same ``L`` and seeds its own copy with 1.  Rank r's backward reaches each
``global_sum`` with the cotangent its own part of the graph gives; the
all-reduce of those cotangents is ``N`` times ``dL/dS`` at the loss (all
ranks hold the same seed there) and, by induction down the graph, ``N``
times the true cotangent at every inner sum.  Rank r's parameter gradient
is then ``N`` times its rows' share of ``dL/dtheta``; the sum over the
ranks divided by ``N`` (:func:`average_gradients`) is ``dL/dtheta``
exactly.  ``tests/test_torch_data_parallel.py`` holds this in float64.

Without a group (``--gpus 1`` and no launcher) every function here is the
identity or a no-op and sends nothing.  With a group every collective is
sent even at world size 1, so the NCCL path can be watched on one card;
``collective.calls`` counts them beside the kernels' launch counters.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)   # a rank that dies fails the others, not hangs them


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the group: ``world`` ranks, its ``rank`` and
    the device it runs on."""

    world: int
    rank: int
    device: torch.device


_ACTIVE: Optional[DataParallel] = None


def init_data_parallel(world: int, rank: int, *, backend: str, device, init_method=None,
                       store=None, timeout: datetime.timedelta = TIMEOUT) -> DataParallel:
    """Join the group of ``world`` ranks as ``rank``: ``backend`` is
    ``"nccl"`` on the card and ``"gloo"`` on the CPU (gloo also carries
    CUDA tensors, through the host); the rendezvous is ``init_method``
    (``env://`` under ``torchrun``, ``file://...``) or a ``store``."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(f"a process group is already initialized: {_ACTIVE}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, store=store, world_size=world,
                            rank=rank, timeout=timeout, **kw)
    _ACTIVE = DataParallel(world, rank, dev)
    return _ACTIVE


def shutdown() -> None:
    """Leave the group (a no-op without one)."""
    global _ACTIVE
    if _ACTIVE is not None:
        dist.destroy_process_group()
        _ACTIVE = None


def active() -> Optional[DataParallel]:
    return _ACTIVE


def world_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.world


def rank() -> int:
    return 0 if _ACTIVE is None else _ACTIVE.rank


def is_main() -> bool:
    return rank() == 0


def check_world(gpus: int) -> None:
    """Raise unless the group (or its absence) has ``--gpus`` ranks."""
    if world_size() != gpus:
        raise ValueError(f"--gpus {gpus} needs a process group of {gpus} ranks, this process "
                         f"is in one of {world_size()} (run through xview2_tpu_torch.main, "
                         "which spawns the ranks, or under torchrun)")


def collective(op: str, tensor: Optional[torch.Tensor] = None) -> None:
    """Run one collective on the group and count it: ``"sum"`` all-reduces
    ``tensor`` in place, ``"broadcast"`` copies rank 0's ``tensor`` to every
    rank, ``"barrier"`` waits for all."""
    if op == "sum":
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    elif op == "broadcast":
        dist.broadcast(tensor, src=0)
    elif op == "barrier":
        dist.barrier()
    else:
        raise ValueError(f"unknown collective {op!r}")
    collective.calls += 1


collective.calls = 0


def barrier() -> None:
    if _ACTIVE is not None:
        collective("barrier")


def run_on_main(fn: Callable, *args, **kwargs) -> None:
    """``fn(*args, **kwargs)`` on rank 0 alone, then a barrier, so every
    rank finds what it wrote; a lone process just calls it."""
    if is_main():
        fn(*args, **kwargs)
    barrier()


def _sum_flat(tensors: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """ONE all-reduce SUM of the tensors' concatenation, in their promoted
    dtype; each comes back in its own shape and dtype."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    collective("sum", flat)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return tuple(p.reshape(t.shape).to(t.dtype) for p, t in zip(parts, tensors))


class _GlobalSum(torch.autograd.Function):
    """All-reduce SUM forward; all-reduce SUM of the cotangents backward
    (see the module docstring for why that is the exact gradient once
    :func:`average_gradients` divides by N)."""

    @staticmethod
    def forward(ctx, *tensors):
        return _sum_flat(tensors)

    @staticmethod
    def backward(ctx, *grads):
        return _sum_flat(grads)


def global_sum(*tensors: torch.Tensor):
    """The sum of each tensor over the ranks, by one collective on their
    concatenation; differentiable (:class:`_GlobalSum`) where grad mode is
    on and a tensor requires grad, a plain all-reduce otherwise (the eval
    step's ``inference_mode``).  The identity without a group.  Returns one
    tensor for one argument, else a tuple."""
    if _ACTIVE is None:
        out = tensors
    elif torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out = _GlobalSum.apply(*tensors)
    else:
        out = _sum_flat(tensors)
    return out[0] if len(tensors) == 1 else tuple(out)


def _buckets(tensors: Iterable[torch.Tensor]):
    """The tensors grouped by (device, dtype), in order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient by its mean over the ranks: one all-reduce of
    a flat bucket per dtype, then a division by N.  A no-op without a group."""
    if _ACTIVE is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        collective("sum", flat)
        flat.div_(_ACTIVE.world)
        for g, part in zip(bucket, torch.split(flat, [g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


@torch.no_grad()
def broadcast_module(model: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank, one broadcast per
    dtype.  A no-op without a group."""
    if _ACTIVE is None:
        return
    tensors = list(model.parameters()) + list(model.buffers())
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective("broadcast", flat)
        for t, part in zip(bucket, torch.split(flat, [t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
