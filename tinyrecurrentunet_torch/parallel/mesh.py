"""Data parallelism over processes, counterpart of `tinyrecurrentunet_tpu/parallel/mesh.py`.

The JAX package jits its train step over a device mesh with the batch
sharded on the `data` axis. What it computes is the step of the whole
global batch: flax's BatchNorm takes its statistics over every item, and so
do the loss's reductions (the spectral convergence ||Y - X|| / ||Y||, the
per-item weights' mean rms, every mean). The port runs one process per card
under `torch.distributed` and computes that same function, which is not what
`DistributedDataParallel` computes (local BatchNorm and local losses,
gradients averaged):

- train-mode BatchNorm all-reduces its sums Σx, Σx² and its count
  (`models/blocks.py`);
- the loss reduces its batch sums across ranks (`losses/`, `across_ranks`),
  so every rank holds the global loss, its terms and the metrics;
- the step sums the parameter gradients across ranks (`sum_gradients_`),
  then takes the global norm, clips and runs AdamW on every rank alike, so
  the replicas stay bit-equal.

`all_reduce_sum` is a sum across ranks that autograd passes through: its
backward sums the upstream gradient across ranks, the adjoint of "sum, then
hand the total to every rank". That is what a rank-local consumer of the
total needs (a BatchNorm normalising its shard by the global statistics:
the gradient of the statistics gathers every rank's share). The replicated
part of the graph, which every rank computes alike from the totals (the loss
itself, the spectral convergence from its two global norms), is then counted
once per rank: every gradient comes out exactly W times the rank's share of
the global gradient, W the world size, so `sum_gradients_` divides the sum
by W. An all-reduce whose backward is the identity would need no division
but drops the other ranks' share from the statistics' gradient, which is
wrong for BatchNorm (tests/test_torch_parallel.py holds both the factor and
the statistics against the JAX mesh step).

The data-parallel path is taken wherever a process group is initialized
(`is_distributed`), a group of one rank included, as a JAX mesh of one
device is still the mesh program: its collectives run, over one rank.
They can be captured into a CUDA graph where the backend is NCCL; gloo
passes through the host, and a step over a gloo group runs uncaptured
(`capturable_collectives`).

A loader shard is `num_shards=world_size(), shard_index=rank()`: rank r
reads the items perm[r::W] of the shared per-epoch permutation, and the
global batch is the ranks' batches stacked rank-major, the order of JAX's
`make_array_from_process_local_data`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tinyrecurrentunet_torch.config import DistConfig


def default_backend(device: torch.device) -> str:
    """nccl for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device: str | torch.device) -> torch.device:
    """The device this process trains on. A bare `cuda` under a launcher that
    sets LOCAL_RANK (torchrun) is that card, `cuda:LOCAL_RANK`, which must
    exist; any other request (`cpu`, `cuda:0`) is honoured as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or "LOCAL_RANK" not in os.environ:
        return device
    index = int(os.environ["LOCAL_RANK"])
    if torch.cuda.is_available() and index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {index} asks for cuda:{index}, but this host has "
                           f"{torch.cuda.device_count()} card(s); pass --device cuda:<index> to share one")
    return torch.device("cuda", index)


def initialize_distributed(cfg: DistConfig, backend: str) -> int:
    """Join the process group once; returns the world size.

    From torchrun's environment when WORLD_SIZE > 1 (RANK, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT), else from `cfg` when it asks for several
    processes, one per host (`coordinator_address` host:port,
    `num_processes`, `process_id`), as `jax.distributed.initialize` is
    called; else nothing: one process. `backend` ("nccl" or "gloo") is used
    as given: NCCL refuses two ranks on one card, where gloo works (it
    all-reduces CUDA tensors through the host)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
    elif cfg.num_processes > 1:
        dist.init_process_group(backend, init_method=f"tcp://{cfg.coordinator_address}",
                                world_size=cfg.num_processes, rank=cfg.process_id)
    return world_size()


def is_distributed() -> bool:
    """Whether a process group is initialized: the data-parallel path, at
    any world size."""
    return dist.is_available() and dist.is_initialized()


def capturable_collectives() -> bool:
    """Whether this process's collectives can go into a CUDA graph: none
    (no group), or an NCCL group's; a gloo group's pass through the host."""
    return not is_distributed() or dist.get_backend() == "nccl"


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def loader_shard() -> dict:
    """`DataLoader` arguments of this rank's shard of the index space."""
    return {"num_shards": world_size(), "shard_index": rank()}


def barrier():
    if is_distributed():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, on every rank; differentiable, its
    backward the same sum of the upstream gradient (see the module
    docstring for the factor W this gives)."""
    return _AllReduceSum.apply(t) if is_distributed() else t


def batch_mean(t: torch.Tensor, across_ranks: bool = False) -> torch.Tensor:
    """The mean of every entry of `t`; across_ranks: over the global batch,
    whose equal shards the ranks hold."""
    if not across_ranks:
        return torch.mean(t)
    return all_reduce_sum(torch.sum(t)) / (t.numel() * world_size())


@torch.no_grad()
def sum_gradients_(tensors: list[torch.Tensor]):
    """Each rank's gradients, W times its share of the global batch's
    gradient (module docstring), become the global gradient: one all-reduce
    of them all, divided by W. Every rank receives the same sum."""
    if not is_distributed():
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def broadcast_state_(module: torch.nn.Module):
    """Rank 0's parameters and buffers on every rank."""
    if not is_distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t, src=0)
