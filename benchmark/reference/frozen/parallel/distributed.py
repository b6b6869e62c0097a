"""Multi-process launch helpers (port of ``apnerf/parallel/distributed.py``).

The JAX package initialises ``jax.distributed`` and splits the host-side
ray sampling per process. Here a process is a rank of a
``torch.distributed`` group: NCCL with one process a card on CUDA, gloo on
the CPU (the tests). Every rank draws the *same* global batch from the
same host random stream (the stream a stage-2 checkpoint carries as
``host_rng``); ``local_batch_slice`` / ``host_local_batch`` give a rank its
part of it where a caller wants only that.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize(world_size: Optional[int] = None, rank: Optional[int] = None,
               init_method: Optional[str] = None,
               store_path: Optional[str] = None,
               device=None) -> Tuple[int, int]:
    """Form the process group unless one exists -> (world size, rank).

    The group's size and this process's rank come from the arguments or,
    under ``torchrun``, from ``WORLD_SIZE`` / ``RANK`` (with
    ``MASTER_ADDR`` / ``MASTER_PORT`` as the rendezvous); ``store_path``
    rendezvous through a file (``torch.distributed.FileStore``, the tests),
    ``init_method`` through an address (``tcp://localhost:<port>``).
    Without any of them a single process stays without a group: (1, 0).
    ``device``: a CUDA device (``None``: ``cuda`` when there is one) takes
    NCCL and this process's card, ``LOCAL_RANK`` or the rank; the CPU
    takes gloo. A group that does not form raises; there is no fallback to
    another backend or to one process."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and init_method is None and store_path is None:
        return 1, 0
    world_size = int(world_size or 1)
    rank = int(rank or 0)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        backend = "nccl"
        local = int(env.get("LOCAL_RANK", rank))
        n_cards = torch.cuda.device_count()
        if local >= n_cards:
            raise RuntimeError(f"rank {rank} needs card {local}; this host "
                               f"has {n_cards}")
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world_size)
    elif init_method is not None:
        kw["init_method"] = init_method
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(backend, world_size=world_size, rank=rank, **kw)
    # a collective now, so that a group that cannot communicate fails here
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"process group check: {probe.item()} ranks "
                           f"answered of {world_size}")
    return world_size, rank


def shutdown() -> None:
    """Leave the process group (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's slice of a global ray batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} rays does not divide "
                         f"over {n} ranks")
    per = global_batch // n
    return i * per, per


def host_local_batch(sample_fn, global_batch: int, seed_step: int):
    """This rank's part of a global batch: ``sample_fn(start, size,
    seed)``, which must be deterministic in the seed, so that every rank
    cuts the same global draw."""
    start, per = local_batch_slice(global_batch)
    return sample_fn(start, per, seed_step)
