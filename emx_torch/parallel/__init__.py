"""Data, pod and spatial parallelism on torch.distributed (port of
emx/parallel): meshes of ranks (`mesh`), process groups and pod meshes
(`distributed`), halo-exchange spatial parallelism (`halo`) and the
multi-rank dry run (`dryrun`, imported on first use, so that
`python -m emx_torch.parallel.dryrun` runs it as a script)."""

import importlib

from emx_torch.parallel import distributed, halo
from emx_torch.parallel.mesh import (batch_sharding, make_mesh,
                                     make_mesh_for_batch, replicated,
                                     shard_batch)

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch",
           "make_mesh_for_batch", "distributed", "halo", "dryrun"]


def __getattr__(name: str):
    if name == "dryrun":
        return importlib.import_module("emx_torch.parallel.dryrun")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
