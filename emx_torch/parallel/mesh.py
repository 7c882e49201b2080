"""Meshes of ranks and sharding rules (port of emx/parallel/mesh.py), on
torch.distributed.

emx's mesh is a grid of JAX devices; here it is a grid of ranks with one
device per rank (a card under NCCL, the CPU under gloo), and XLA's
collectives become the process groups of its axes. At construction the
mesh makes a group for each axis, for the batch axes together and for the
whole mesh (each rank is in one group of each: the ranks that share its
coordinates on the other axes); every rank of the world calls
`make_mesh` with the same arguments, as torch's `new_group` needs.

  * At world size 1 with no process group the mesh is 1x1 on the default
    card and holds no group: there is nothing to reduce, and nothing
    initialises NCCL.
  * Over an initialised group, of any size and including size 1, the mesh
    holds its groups and the code that reads it issues the collectives.

Axis conventions:
  data    - data parallelism (batch dimension)
  spatial - spatial context parallelism for big-micrograph halo convs
            (emx_torch.parallel.halo)
  dcn     - the outer data axis of a pod mesh
            (emx_torch.parallel.distributed.make_pod_mesh)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from emx_torch.utils.device import resolve_device

BATCH_AXES = ("dcn", "data")


def initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialised() else 1


def rank() -> int:
    return dist.get_rank() if initialised() else 0


def default_device() -> torch.device:
    """This rank's device: the current card under NCCL, the CPU under
    gloo, the default card with no process group."""
    if initialised():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    device = resolve_device("cuda")
    return torch.device("cuda", torch.cuda.current_device()) \
        if device.index is None else device


class Mesh:
    """Ranks laid out on named axes, one device per rank (emx's
    jax.sharding.Mesh). `devices` is the array of ranks, `shape` maps
    each axis to its size, `coords` is this rank's coordinate on each
    axis (None for a rank outside the mesh, which holds no shard), and
    `device` this rank's device."""

    def __init__(self, devices, axis_names: tuple[str, ...],
                 device: str | torch.device | None = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d ranks for axes "
                             f"{self.axis_names}")
        if len(set(self.devices.flat)) != self.devices.size:
            raise ValueError(f"a rank appears twice in {self.devices}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = rank()
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self.device = default_device() if device is None else \
            torch.device(device)
        self._groups: dict[tuple[str, ...], object] = {}
        self._chains: dict[tuple[str, ...], list[int]] = {}
        if initialised():
            for axes in self._group_axes():
                self._make_group(axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.tolist()})"

    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if a in self.axis_names)

    def _group_axes(self) -> list[tuple[str, ...]]:
        combos = [(a,) for a in self.axis_names]
        for axes in (self.batch_axes(), self.axis_names):
            if axes and axes not in combos:
                combos.append(axes)
        return combos

    def _make_group(self, axes: tuple[str, ...]) -> None:
        """One group per set of ranks that share their coordinates off
        `axes`, each rank in chain order (row-major over `axes`). Every
        rank of the world makes every group, in the same order."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        rows = np.transpose(self.devices, rest + idx).reshape(
            -1, math.prod(self.devices.shape[i] for i in idx))
        everyone = set(range(world_size()))
        for row in rows.tolist():
            group = dist.group.WORLD if set(row) == everyone else \
                dist.new_group(sorted(row))
            if self.rank in row:
                self._groups[axes] = group
                self._chains[axes] = row

    def _key(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r}: {self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def index(self, axes) -> int | None:
        """This rank's place along `axes` (row-major), None outside."""
        if self.coords is None:
            return None
        out = 0
        for a in self._key(axes):
            out = out * self.shape[a] + self.coords[a]
        return out

    def group(self, axes):
        """This rank's process group over `axes` (an axis or a tuple of
        them; each axis, the batch axes and all axes have one), or None
        with no process group or outside the mesh."""
        axes = self._key(axes)
        if not initialised() or self.coords is None:
            return None
        if axes not in self._groups:
            raise ValueError(f"no group over {axes}: the mesh makes "
                             f"{self._group_axes()}")
        return self._groups[axes]

    def chain(self, axes) -> list[int]:
        """The global ranks of this rank's group over `axes`, in order of
        their place along the axes."""
        axes = self._key(axes)
        if self.group(axes) is None:
            return [self.rank]
        return self._chains[axes]


def all_reduce_mean_(tensors: list[torch.Tensor], group, n: int) -> None:
    """Average `tensors` over `group` of `n` ranks in place: one
    all-reduce of each dtype's tensors flattened into one buffer and
    copied back (at n = 1 the copy leaves every value as it was). The
    reduce runs after the backward, with nothing to overlap, so one
    buffer is as fast as any split of it."""
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if n != 1:
            flat.div_(n)
        _unflatten(flat, same)


def broadcast_(tensors: list[torch.Tensor], src: int, group) -> None:
    """Copy global rank `src`'s `tensors` to every rank of `group`, in
    place, one buffer per dtype as all_reduce_mean_."""
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        _unflatten(flat, same)


def _by_dtype(tensors) -> list[list[torch.Tensor]]:
    by: dict = {}
    for t in tensors:
        by.setdefault((t.dtype, t.device), []).append(t)
    return list(by.values())


@torch.no_grad()
def _unflatten(flat: torch.Tensor, tensors) -> None:
    """Copy `flat`'s consecutive pieces into `tensors` in one
    multi-tensor launch (a copy_ each would be a device copy and a host
    call per tensor)."""
    pieces = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors),
                         [p.view_as(t) for p, t in zip(pieces, tensors)])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Which block of an array each rank holds (emx's NamedSharding with
    its PartitionSpec): `spec` gives each leading dim an axis, a tuple of
    axes (row-major) or None (whole)."""

    mesh: Mesh
    spec: tuple = ()

    def _entries(self):
        for dim, entry in enumerate(self.spec):
            if entry is not None:
                yield dim, ((entry,) if isinstance(entry, str)
                            else tuple(entry))

    def index(self, shape) -> tuple[slice, ...]:
        """This rank's block of an array of `shape`, as slices (empty on
        the partitioned dims of a rank outside the mesh)."""
        out = [slice(None)] * len(shape)
        for dim, axes in self._entries():
            n = self.mesh.axis_size(axes)
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split over {axes} ({n} ranks)")
            k = self.mesh.index(axes)
            size = shape[dim] // n
            out[dim] = slice(0, 0) if k is None else \
                slice(k * size, (k + 1) * size)
        return tuple(out)

    def shard(self, x) -> torch.Tensor:
        """This rank's block of `x` (a global array) on its device."""
        x = torch.as_tensor(x)
        return x[self.index(x.shape)].to(self.mesh.device)

    def gather(self, local) -> torch.Tensor:
        """The global array from every rank's block (`local` this rank's,
        on its device): all-gathered over each partitioned dim's group,
        the last dim first."""
        out = torch.as_tensor(local).to(self.mesh.device)
        for dim, axes in reversed(list(self._entries())):
            out = gather_rows(out.movedim(dim, 0), self.mesh.group(axes),
                              self.mesh.chain(axes)).movedim(0, dim)
        return out

    def broadcast_(self, tensors: list[torch.Tensor]) -> None:
        """Make `tensors` equal on every rank of the mesh: the mesh's
        first rank's values, copied in place (a replicated sharding)."""
        if self.spec:
            raise ValueError(f"broadcast_ replicates; the spec is "
                             f"{self.spec}")
        group = self.mesh.group(self.mesh.axis_names)
        if group is not None and tensors:
            broadcast_(tensors, int(self.mesh.devices.flat[0]), group)


def make_mesh(data: int | None = None, spatial: int = 1,
              devices: list | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """Build a (data, spatial) mesh over `devices` (ranks; all of them by
    default). Defaults to all ranks on 'data'. `device` overrides this
    rank's device (default_device)."""
    devices = list(range(world_size())) if devices is None else \
        list(devices)
    n = len(devices)
    if data is None:
        data = n // spatial
    if data * spatial != n:
        raise ValueError(f"mesh {data}x{spatial} != {n} devices")
    return Mesh(np.asarray(devices).reshape(data, spatial),
                ("data", "spatial"), device)


def make_mesh_for_batch(batch_size: int, spatial: int = 1,
                        devices: list | None = None,
                        device: str | torch.device | None = None) -> Mesh:
    """Largest 'data' axis that both divides `batch_size` and fits the
    rank count - lets small debug batches run on big meshes (the ranks
    past it hold no shard)."""
    devices = list(range(world_size())) if devices is None else \
        list(devices)
    n = len(devices) // spatial
    data = math.gcd(batch_size, n)
    return make_mesh(data=data, spatial=spatial,
                     devices=devices[: data * spatial], device=device)


def batch_sharding(mesh: Mesh, spatial_dims: int = 0) -> NamedSharding:
    """Sharding for a batch array: batch dim over 'data' - and over 'dcn'
    too on pod meshes, so data parallelism spans nodes. Optionally the
    leading spatial (H) dim goes over 'spatial' for halo-parallel
    images."""
    batch_axes = mesh.batch_axes()
    if not batch_axes:
        raise ValueError(f"mesh has no batch axis: {mesh.axis_names}")
    spec_batch = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    if spatial_dims:
        return NamedSharding(mesh, (spec_batch, "spatial"))
    return NamedSharding(mesh, (spec_batch,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a host batch (an array, or a tuple, list or
    dict of them) on its device, sharded along the batch dim."""
    sharding = batch_sharding(mesh)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return sharding.shard(batch)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; its gradient is the sum of the ranks' gradients,
    so that averaging the ranks' parameter gradients afterwards gives the
    gradient of the mean of their losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (x itself for None),
    differentiable."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


def gather_rows(x: torch.Tensor, group, chain: list[int]) -> torch.Tensor:
    """Every rank's `x` (equal shapes) stacked along dim 0 in the order of
    `chain` (global ranks); x itself for no group. Not differentiable."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in chain]
    dist.all_gather(parts, x, group=group)
    by_rank = dict(zip(sorted(chain), parts))
    return torch.cat([by_rank[r] for r in chain])


def microbatch_rows(x, block: int, blocks: int, runs: int = 1):
    """Row block `block` of `blocks` of each of `runs` equal runs of a
    global batch `x` (an array or tensor, or a tuple or list of them), as
    one batch: a data-parallel rank's rows when the global batch splits
    into `runs` microbatches, so that each microbatch's rows stay
    together across the ranks. One block is the batch itself."""
    if blocks == 1:
        return x
    if isinstance(x, (tuple, list)):
        return type(x)(microbatch_rows(v, block, blocks, runs) for v in x)
    n = x.shape[0]
    if n % (runs * blocks):
        raise ValueError(f"a batch of {n} does not split into {runs} "
                         f"microbatches of {blocks} rank blocks")
    c = n // (runs * blocks)
    rest = tuple(x.shape[1:])
    return x.reshape((runs, blocks, c) + rest)[:, block].reshape(
        (runs * c,) + rest)
