"""Data parallelism over processes (counterpart of
``pixelwiseregression_tpu/parallel/mesh.py``).

The JAX package shards the batch on a 1-D ``('data',)`` mesh and lets XLA
insert the gradient all-reduce; the same program spans hosts. Here each
process (rank) holds a replica of the model and ``batch_size // world``
samples of the global batch, and the train and eval steps
(``train/loop.py``) compute what the JAX steps compute over the global
batch:

* the loss denominators (valid-sample counts) are all-reduced;
* BatchNorm takes the global batch's statistics (``all_reduce_sum_grad``,
  differentiable: its backward all-reduces the cotangent);
* the anchored norm's EMA takes the mean over the global batch
  (``global_mean``);
* the gradients are summed over the ranks (each rank's loss is its share
  of the global loss), so every replica takes the same optimizer step;
* the augmentation draws are the global batch's, from one generator
  seeded alike on every rank; each rank takes its slice (``local_slice``).

``init`` sets up the process group, from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
explicit arguments: NCCL for ``cuda``, gloo for ``cpu``. Without a process
group every helper is the identity (one process).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def active() -> bool:
    """Whether a process group is set up: the steps then run as one rank of it."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def launched() -> bool:
    """Whether this process was started by torchrun (or anything that sets
    ``WORLD_SIZE`` and ``RANK``)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init(device_type: str, rank_: Optional[int] = None, world: Optional[int] = None,
         init_method: Optional[str] = None, backend: Optional[str] = None,
         timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device: ``cuda:LOCAL_RANK``
    (``cuda:rank`` without ``LOCAL_RANK``) or the CPU.

    Without arguments, reads torchrun's environment (``init_method``
    ``env://``). The backend is NCCL on the card and gloo on the CPU unless
    ``backend`` says otherwise (gloo takes CUDA tensors too, through host
    memory: two ranks on one card need it, as NCCL refuses them).
    """
    rank_ = int(os.environ["RANK"]) if rank_ is None else rank_
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda rank needs a visible CUDA device")
        local = int(os.environ.get("LOCAL_RANK", rank_))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank_,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return device


def shutdown():
    if active():
        dist.destroy_process_group()


def process_local_lines(lines: Sequence, shuffle_order: Optional[Sequence[int]] = None):
    """Partition dataset index lines across processes: rank i takes every
    world-th line (after an optional shared shuffle order), so the global
    batch is the concatenation of the local batches (a copy of the JAX
    package's ``process_local_lines``)."""
    n, i = world_size(), rank()
    if shuffle_order is not None:
        lines = [lines[k] for k in shuffle_order]
    return lines[i::n]


def local_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (axis 0 split in ``world``
    equal parts, in rank order)."""
    n = world_size()
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {n} ranks")
    b = x.shape[0] // n
    return x[rank() * b:(rank() + 1) * b]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; no gradient)."""
    if not active():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the cotangent of each rank's input is the sum of
    the ranks' cotangents (each rank's loss reads the global sum)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum`` that autograd differentiates."""
    return _AllReduceSum.apply(t) if active() else t


def global_mean(local_sum: torch.Tensor, local_count: int) -> torch.Tensor:
    """The mean over the global batch from each rank's sum over its
    ``local_count`` samples (every rank holds as many)."""
    return all_reduce_sum(local_sum) / (local_count * world_size())


def all_reduce_grads(params) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks, in one flat all-reduce."""
    if not active():
        return
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s value of a picklable ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers to every rank."""
    if not active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)
