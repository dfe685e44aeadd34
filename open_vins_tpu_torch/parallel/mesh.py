"""Process-group helpers: the port's communication backend.

Counterpart of `open_vins_tpu/parallel/mesh.py`.  The JAX package lays a
device mesh over one program and lets GSPMD insert the collectives; the
port runs one process per rank over `torch.distributed` and calls each
collective itself (`parallel/sharded_ekf.py`, `parallel/distributed_ba.py`).
In place of `make_mesh` and `data_mesh` this module gives the rank, the
world size and the rank's device.

The backend is always the caller's choice, never guessed: "nccl" where each
rank has a card of its own, "gloo" for CPU tensors or for several ranks on
one card (NCCL refuses two ranks on one GPU; gloo moves CUDA tensors
through the host for `all_reduce`, `all_gather` and `all_to_all_single`,
the only collectives the port uses).  Ranks that use CUDA must be started
with the "spawn" start method (`spawn` below): a fork after CUDA's
initialization fails.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from open_vins_tpu_torch import resolve_device

BACKENDS = ("nccl", "gloo")


def init_distributed(backend, rank=None, world_size=None,
                     init_method="env://", timeout_s=300.0):
    """Join the process group, from the environment unless told: RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT (`init_method="env://"`), or
    the given rank and world size with an explicit `init_method` such as
    "tcp://localhost:29500".  Returns (rank, world_size); a no-op but for
    the return when the group exists already.  A collective that waits
    longer than `timeout_s` fails instead of hanging."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw["rank"] = rank
        if world_size is not None:
            kw["world_size"] = world_size
        dist.init_process_group(
            backend, init_method=init_method,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_rank(), dist.get_world_size()


def world(group=None):
    """(rank, world size) in `group` (None = the default group); (0, 1)
    when no process group is initialized — a single-process run, in which
    every function of the parallel layer is its single-process form (in a
    group, of one rank too, the collectives run)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def rank_device(device=None, group=None):
    """The rank's device: `device` (None = CUDA); a CUDA device without an
    index is the card rank % card count (every rank shares card 0 where
    there is one card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank, _ = world(group)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def free_port():
    """A free TCP port on localhost for a new group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world_size, backend, port, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size))
    init_distributed(backend)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size, backend, args=()):
    """Run `fn(rank, world_size, *args)` on `world_size` new processes
    (start method "spawn"), each a rank of one new process group with the
    given backend, rendezvous at localhost on a free port; returns when all
    have ended and raises if one failed.  `fn` must be importable by name
    (a module-level function)."""
    import torch.multiprocessing as mp

    mp.spawn(_entry, args=(fn, world_size, backend, free_port(), args),
             nprocs=world_size, join=True)
