"""Multi-GPU runtime: the process group, each rank's share of a batch, and
the collectives of data-parallel training. Counterpart of
`difashion_tpu/core/distributed.py`.

One process drives one device (torchrun's layout): a rank reads its place
in the group from torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) where the JAX package reads
`JAX_NUM_PROCESSES` and its kin. The backend is always named by the caller,
never guessed: `nccl` for CUDA devices (one card per rank), `gloo` for the
CPU, or for CUDA tensors where ranks share a card.

Every rank builds the same global batch (the loader's permutation is a pure
function of (seed, epoch)) and keeps its contiguous shard (`host_shard`),
which stays on its own device: the JAX package's `make_global_batch`, which
assembles the shards into one global array, has no counterpart. The
gradient mean across ranks is an explicit bucketed all-reduce
(`all_reduce_mean_`), and `check_same_parameters` is the startup check that
the JAX package's `assert_same_across_hosts_note` asks multi-host runs for.
"""
from __future__ import annotations

import os
import socket
from collections import Counter
from datetime import timedelta
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 32 << 20     # flat all-reduce / all-gather buckets
BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600             # seconds a collective may wait for the other ranks


class DistInfo(NamedTuple):
    """This process's place in the data-parallel group: rank, world size,
    local rank (its index on its host) and its device."""

    rank: int
    world: int
    local_rank: int
    device: torch.device


def single(device="cuda") -> DistInfo:
    """The DistInfo of a run without a group."""
    return DistInfo(0, 1, 0, torch.device(device))


def rank_device(device: str, local_rank: int) -> torch.device:
    """The rank's device: `cuda` means the card of index LOCAL_RANK (which
    must exist); `cuda:N` and `cpu` are taken as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise ValueError(f"LOCAL_RANK {local_rank} has no card of its own: {n} visible. "
                         "Start at most one rank per card (torchrun --nproc_per_node "
                         f"{max(n, 1)}), or name a shared card (cuda:0) under gloo")
    return torch.device("cuda", local_rank)


def shared_devices(ids: Sequence[str]) -> Dict[str, List[int]]:
    """{device id: ranks} for each device that more than one rank holds."""
    counts = Counter(ids)
    return {d: [r for r, x in enumerate(ids) if x == d] for d, c in counts.items() if c > 1}


def initialize_distributed(backend: str, device: str = "cuda") -> DistInfo:
    """Join the process group that torchrun's environment describes, on
    `backend` ("nccl" or "gloo"). A single process joins nothing unless a
    rendezvous is given (MASTER_ADDR), as the JAX function joins a
    coordinator it is given: then it forms a group of one. Sets the rank's
    device (`rank_device`). Under NCCL each rank must hold a card of its
    own: two ranks on one card raise."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if world <= 1 and "MASTER_ADDR" not in os.environ:
        return single(device)
    if not 0 <= rank < world:
        raise ValueError(f"RANK {rank} outside WORLD_SIZE {world}")
    missing = [v for v in ("MASTER_ADDR", "MASTER_PORT") if v not in os.environ]
    if missing:
        raise ValueError(f"WORLD_SIZE {world} without {', '.join(missing)}: launch with "
                         "torchrun, which sets them")
    dev = rank_device(device, local_rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl runs on CUDA devices, not {dev}: use gloo on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                            timeout=timedelta(seconds=TIMEOUT_S))
    if backend == "nccl":
        ident = f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"
        ids: List[Optional[str]] = [None] * world
        dist.all_gather_object(ids, ident)
        shared = shared_devices(ids)
        if shared:
            dist.destroy_process_group()
            raise RuntimeError(f"NCCL needs one card per rank; ranks share cards: {shared}")
    return DistInfo(rank, world, local_rank, dev)


def destroy() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The group's world size; before a group is joined, the one torchrun's
    environment announces (1 without torchrun)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def host_shard(batch: dict, rank: int, world: int) -> dict:
    """This rank's contiguous share of a *global* host batch (every value
    sliced along its leading axis), which every rank builds alike: the
    replacement for torch's DistributedSampler, with the global batch's
    semantics intact."""
    if world == 1:
        return batch

    def slice_one(x):
        n = len(x)
        if n % world != 0:
            raise ValueError(f"global batch {n} not divisible by process count {world}")
        per = n // world
        return x[rank * per:(rank + 1) * per]

    return {k: slice_one(np.asarray(v)) for k, v in batch.items()}


def buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Consecutive indices of `tensors`, each run of one dtype and at most
    BUCKET_BYTES (one tensor at least)."""
    out: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        b = t.numel() * t.element_size()
        if not out or size + b > BUCKET_BYTES or tensors[out[-1][-1]].dtype != t.dtype:
            out.append([])
            size = 0
        out[-1].append(i)
        size += b
    return out


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], world: int) -> None:
    """Replace each tensor by its mean over the ranks, in place: flat
    buckets summed across the group, then divided by the world size (gloo
    has no ReduceOp.AVG). Every rank receives the same sums."""
    if world == 1:
        return
    for idx in buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat.div_(world)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def gather_rows(x: torch.Tensor, world: int) -> torch.Tensor:
    """Every rank's `x` (one shape on all) concatenated along axis 0, in
    rank order, on every rank."""
    if world == 1:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """An exact checksum of a tensor's bits: its elements' bit patterns as
    integers, weighted by position (so a permutation changes it), summed in
    int64 (wrapping, order-independent)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    bits = t.detach().reshape(-1).view(ints).long()
    w = torch.arange(bits.numel(), device=bits.device, dtype=torch.long) % 65521 + 1
    return (bits * w).sum()


@torch.no_grad()
def parameter_checksums(model: torch.nn.Module, towers: Sequence[str]) -> torch.Tensor:
    """One int64 checksum per tower of `model` over its parameters."""
    out = []
    for tower in towers:
        total = torch.zeros((), dtype=torch.long, device=next(model.parameters()).device)
        for p in getattr(model, tower).parameters():
            total = total + _checksum(p)
        out.append(total)
    return torch.stack(out)


def check_same_parameters(model: torch.nn.Module, towers: Sequence[str], world: int) -> None:
    """Raise unless every rank holds the same parameters, bit for bit: the
    per-tower checksums gathered across the group, held against rank 0's."""
    if world == 1:
        return
    sums = gather_rows(parameter_checksums(model, towers)[None], world)
    bad = {towers[t]: [q for q in range(world) if int(sums[q, t]) != int(sums[0, t])]
           for t in range(len(towers))}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        raise RuntimeError(f"ranks disagree with rank 0 on the parameters of {bad}: the same "
                           "seed, weights and checkpoint must reach every rank")
