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

`launch` is the counterpart of the JAX package's `make_mesh()` over every
local device (`--data_parallel`): with no launcher around it (no WORLD_SIZE
in the environment) it runs a function as one rank per local card, in
processes it starts with the `spawn` method, each given RANK, LOCAL_RANK,
WORLD_SIZE, LOCAL_WORLD_SIZE and the rendezvous, a TCP store the launching
process holds (as torchrun's agent holds its own). One rank in all (one
card, the CPU) runs in the launching process itself, where
`initialize_distributed` makes a group of one under `data_parallel`. Under
`cfg.dist` with several processes, one a host, each host starts as many
ranks as it has cards, every host the same count (checked through the
store at `coordinator_address`, which process 0 holds): world size
num_processes x local ranks, rank process_id x local ranks + local rank.
Under torchrun it runs the function as it is. A rank that fails ends the
others, on every host, and the launch raises: nothing falls back to fewer
cards. (torch's elastic agent, `elastic_launch`, would end only its own
host's ranks: with a static rendezvous an agent never learns that another
host's rank failed, and its ranks would wait in the step's collectives.)
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import multiprocessing
import multiprocessing.connection
import os
import signal
import sys
import traceback

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


def initialize_distributed(cfg: DistConfig, backend: str, data_parallel: bool = False) -> int:
    """Join the process group once; returns the world size.

    From a launcher's environment (torchrun's or `launch`'s: WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) at several ranks, or at one
    under `data_parallel`; else from `cfg` when it asks for several
    processes, one per host (`coordinator_address` host:port,
    `num_processes`, `process_id`), as `jax.distributed.initialize` is
    called; else, under `data_parallel`, a group of one rank in this process
    (the JAX package's mesh of one device); else nothing: one process.
    `backend` ("nccl" or "gloo") is used as given: NCCL refuses two ranks on
    one card, where gloo works (it all-reduces CUDA tensors through the
    host)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    ranks = int(os.environ.get("WORLD_SIZE", "0"))
    if ranks > 1 or (ranks == 1 and data_parallel):
        dist.init_process_group(backend, init_method="env://")
    elif cfg.num_processes > 1:
        dist.init_process_group(backend, init_method=f"tcp://{cfg.coordinator_address}",
                                world_size=cfg.num_processes, rank=cfg.process_id)
    elif data_parallel:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True, wait_for_workers=False)
        dist.init_process_group(backend, store=store, world_size=1, rank=0)
    return world_size()


def launched() -> bool:
    """Whether a launcher started this process as a rank (WORLD_SIZE in its
    environment)."""
    return "WORLD_SIZE" in os.environ


def local_rank_count(device: str | torch.device, requested: int | None = None) -> int:
    """The ranks `launch` starts on this host: `requested`, else one per
    visible card for a bare `cuda`, else one (the CPU, or a card named by
    its index)."""
    device = torch.device(device)
    every_card = device.type == "cuda" and device.index is None
    # the count of cards only: no CUDA context is made in the launching process
    cards = torch.cuda.device_count() if every_card else None
    if requested is not None:
        if requested < 1:
            raise ValueError(f"{requested} local ranks: at least one")
        if every_card and requested > cards:
            raise ValueError(f"{requested} local ranks on {cards} visible card(s): NCCL takes one rank a card")
        return requested
    if not every_card:
        return 1
    if cards < 1:
        raise RuntimeError("data parallelism on cuda found no card")
    return cards


STORE_TIMEOUT = datetime.timedelta(seconds=300)  # a rendezvous, or the wait for every host's end
_KEYS = "trunet_launch"


def _die_with_parent(parent: int):
    """Have Linux end this process when the launching process dies
    (PR_SET_PDEATHSIG), killed or not: no rank outlives its launcher."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(fn, args: tuple, parent: int, env: dict):
    """A spawned rank: fn(*args) with the rank's variables `env` in its
    environment; an exception is printed and ends the process at once with
    exit code 1 (no teardown that could wait on the other ranks)."""
    _die_with_parent(parent)
    os.environ.update(env)
    try:
        fn(*args)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _end(procs: list):
    """Every process of `procs` ended: SIGTERM, then SIGKILL after 10 s."""
    for p in procs:
        if p.exitcode is None:
            p.terminate()
    for p in procs:
        p.join(10)
        if p.exitcode is None:
            p.kill()
            p.join()


def _run_ranks(fn, args: tuple, envs: list, store, host: int, hosts: int):
    """Spawn a rank per environment of `envs`, wait for all; the first to
    fail (or word through the store that a rank of another host failed)
    ends the rest, and raises."""
    ctx = multiprocessing.get_context("spawn")
    procs, failure = [], None
    try:
        for env in envs:
            proc = ctx.Process(target=_rank_main, args=(fn, args, os.getpid(), env), name=f"rank {env['RANK']}")
            proc.start()
            procs.append(proc)
        while failure is None:
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            running = [p for p in procs if p.exitcode is None]
            if failed:
                failure = f"{failed[0].name} exited with {failed[0].exitcode}"
            elif not running:
                break
            elif hosts > 1:
                try:
                    if store.check([f"{_KEYS}/failed"]):
                        failure = f"a rank of another host failed ({store.get(f'{_KEYS}/failed').decode()})"
                except RuntimeError as e:  # the coordinator's store is gone (DistStoreError)
                    failure = f"the coordinator's store is unreachable ({e})"
            if failure is None:
                multiprocessing.connection.wait([p.sentinel for p in running], timeout=0.5)
    finally:
        _end(procs)
    if failure is not None:
        if hosts > 1:
            with contextlib.suppress(RuntimeError):  # the store may be gone with its host
                store.set(f"{_KEYS}/failed", f"host {host}: {failure}")
        raise RuntimeError(f"data parallelism: {failure}; every other rank of this host was ended")
    if hosts > 1:
        # process 0 holds the store: it stays until every host's ranks have ended
        store.set(f"{_KEYS}/done/{host}", "1")
        if host == 0:
            store.wait([f"{_KEYS}/done/{h}" for h in range(hosts)], STORE_TIMEOUT)


def launch(fn, args: tuple, cfg: DistConfig, device: str | torch.device, local_ranks: int | None = None):
    """Run fn(*args) as every rank of this host (module docstring): under a
    launcher as it is; else one rank per local card (`local_rank_count`) in
    spawned processes, or, one rank in all, in this process (where
    `initialize_distributed` makes the group of one). Returns fn's result
    where this process ran it, else None; raises if a rank failed."""
    if launched():
        return fn(*args)
    local = local_rank_count(device, local_ranks)
    hosts = max(cfg.num_processes, 1)
    if hosts * local == 1:
        return fn(*args)
    host = cfg.process_id if hosts > 1 else 0
    if hosts > 1:
        addr, port = cfg.coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(addr, int(port), is_master=host == 0, wait_for_workers=False, timeout=STORE_TIMEOUT)
        store.set(f"{_KEYS}/local_ranks/{host}", str(local))
        counts = [int(store.get(f"{_KEYS}/local_ranks/{h}")) for h in range(hosts)]
        store.set(f"{_KEYS}/counted/{host}", "1")
        if host == 0:  # its store stays until every host has read the counts
            store.wait([f"{_KEYS}/counted/{h}" for h in range(hosts)], STORE_TIMEOUT)
        if len(set(counts)) > 1:
            raise RuntimeError(f"every host must start as many ranks; by process_id: {counts}")
    else:
        addr = "127.0.0.1"
        store = dist.TCPStore(addr, 0, is_master=True, wait_for_workers=False, timeout=STORE_TIMEOUT)
        port = store.port
    world = hosts * local
    envs = [{"RANK": str(host * local + r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
             "LOCAL_WORLD_SIZE": str(local), "MASTER_ADDR": addr, "MASTER_PORT": str(port),
             # the ranks join the store this process holds, as torchrun's workers join its agent's
             "TORCHELASTIC_USE_AGENT_STORE": "True"} for r in range(local)]
    _run_ranks(fn, args, envs, store, host, hosts)
    return None


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
