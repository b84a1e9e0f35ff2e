"""Data parallelism over processes with torch.distributed
(`audiolcm_tpu/parallel/mesh.py`).

The reference trains with NCCL DDP (`main.py:613`) and shards batches by
rank (`DDPIndexBatchSampler`); the JAX package runs one program over a
data mesh, where XLA sums the gradients over the global batch. The port
runs one process per card, as torchrun starts them: `init_distributed`
joins the group that torchrun's environment describes (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the card), on NCCL on the card
and gloo on the CPU, and does nothing when that environment is absent (one
process). Each rank loads its own batches (`batches[rank::world]`), the
DiT trainers wrap the trained network in DistributedDataParallel
(`wrap_ddp`), and the GAN trainers average their gradients over the ranks
(`average_gradients`, the same sum DDP makes, after R1's double backward
and the adaptive weight's extra gradients). Every rank draws the global
batch's random numbers from the same seed and keeps its slice
(`shard_slice`), and reported losses are averaged over the ranks, so one
step of N ranks equals one single-process step over the N local batches.

The VAE GAN discriminator's BatchNorm takes the global batch's statistics
(`models/discriminators.py:FlaxBatchNorm`), as the JAX package's mesh
does. FSDP (`fsdp_shardings`, `shard_params_fsdp`) has no
caller in the JAX package and is not ported.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_device(device=None) -> Optional[torch.device]:
    """`device`, or under torchrun on a machine with cards cuda:LOCAL_RANK;
    None otherwise (the caller's own default)."""
    if device is not None:
        return torch.device(device)
    if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return None


def init_distributed(device: torch.device) -> bool:
    """Join the process group of torchrun's environment (NCCL for a card,
    gloo for the CPU); False, and nothing done, without that environment."""
    if is_distributed():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def wrap_ddp(module: nn.Module) -> nn.Module:
    """DistributedDataParallel around `module` inside a process group, else
    `module` itself. Parameters a step leaves unused (the DiT's guidance
    projection in teacher training) are allowed."""
    if not is_distributed():
        return module
    dev = next(module.parameters()).device
    return DistributedDataParallel(module, device_ids=[dev] if dev.type == "cuda" else None,
                                   find_unused_parameters=True)


def unwrap(module: nn.Module) -> nn.Module:
    return module.module if isinstance(module, DistributedDataParallel) else module


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks (`t` itself in one process)."""
    if not is_distributed():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / world_size()


def average_gradients(params: Iterable[nn.Parameter]) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, as
    DDP leaves it (one flattened all-reduce)."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def shard_slice(local_batch: int) -> slice:
    """This rank's rows of a global batch of world_size() local batches."""
    r = rank()
    return slice(r * local_batch, (r + 1) * local_batch)


def global_std(x: torch.Tensor) -> torch.Tensor:
    """The population std of `x` over every rank's rows (two passes, as
    jnp.std over the global batch)."""
    if not is_distributed():
        return torch.std(x, unbiased=False)
    n = torch.tensor(float(x.numel()), device=x.device)
    s = x.detach().sum()
    for t in (n, s):
        dist.all_reduce(t)
    mean = s / n
    sq = ((x.detach() - mean) ** 2).sum()
    dist.all_reduce(sq)
    return torch.sqrt(sq / n)


def draw_shard(make, local_batch: int) -> torch.Tensor:
    """make(n) draws n rows; every rank draws the global batch's rows from
    its generator (seeded alike on every rank) and keeps its own."""
    return make(local_batch * world_size())[shard_slice(local_batch)]


def mean_metrics_over_ranks(metrics: dict) -> dict:
    """Every 0-dim tensor metric averaged over the ranks in one all-reduce."""
    if not is_distributed():
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    return dict(zip(keys, stacked / world_size()))


def common_count(n: int) -> int:
    """The least of the ranks' `n` (per-rank batch counts differ by one
    when the batches do not divide evenly; every rank must run as many
    steps as the others)."""
    if not is_distributed():
        return n
    t = torch.tensor([n], device="cuda" if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def broadcast_object(obj):
    """Rank 0's `obj` on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
