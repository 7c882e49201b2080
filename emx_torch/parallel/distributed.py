"""Multi-process initialisation and cross-node data parallelism (port of
emx/parallel/distributed.py), on torch.distributed.

  * `initialize()` is init_process_group: NCCL with one card per rank
    where CUDA is present, gloo on the CPU; the address, world size and
    rank come from its arguments or from torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT. It does nothing in exactly emx's cases:
    one process with nothing set, or a group already initialised.
  * `make_pod_mesh()` builds a ('dcn', 'data', 'spatial') mesh whose outer
    axis spans nodes (torchrun numbers a node's ranks together), so a
    gradient all-reduce over the batch axes sums within a node first in
    NCCL's own rings and trees.
  * `host_batch_slice()` is which rows of the global batch this rank
    loads.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from emx_torch.parallel.mesh import Mesh, initialised, rank, world_size


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join (or create) the process group. `coordinator_address` is
    host:port of rank 0 (or an init_method URL such as file:///path);
    without it MASTER_ADDR:MASTER_PORT. `backend` defaults to nccl with
    CUDA and gloo without; under NCCL this rank's card is LOCAL_RANK (or
    the rank modulo the card count) and the default communicator is
    created here."""
    if num_processes in (None, 1) and "WORLD_SIZE" not in os.environ \
            and coordinator_address is None:
        return
    if initialised():
        return
    world = num_processes if num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", 1))
    rank_ = process_id if process_id is not None else \
        int(os.environ.get("RANK", 0))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                               f":{os.environ.get('MASTER_PORT', '29500')}")
    init_method = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank_ % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_,
                            timeout=datetime.timedelta(minutes=10), **kwargs)


def nodes() -> int:
    """Nodes of the world: WORLD_SIZE / LOCAL_WORLD_SIZE under torchrun,
    else 1."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
    return world_size() // local if local and world_size() % local == 0 \
        else 1


def make_pod_mesh(dcn_data: int | None = None, spatial: int = 1,
                  device: str | torch.device | None = None) -> Mesh:
    """Mesh over every rank: ('dcn', 'data', 'spatial') with 'dcn' across
    nodes (`dcn_data`, by default the node count) and 'data' x 'spatial'
    within one."""
    n = world_size()
    n_slices = dcn_data if dcn_data is not None else max(1, nodes())
    if n % n_slices or (n // n_slices) % spatial:
        raise ValueError(f"{n} ranks do not split into dcn={n_slices} x "
                         f"data x spatial={spatial}")
    per_slice = n // n_slices
    ranks = np.arange(n).reshape(n_slices, per_slice // spatial, spatial)
    return Mesh(ranks, ("dcn", "data", "spatial"), device)


def host_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this rank's share of the global batch."""
    per_host = global_batch // world_size()
    return rank() * per_host, per_host
