"""Spatial context parallelism: process ONE huge micrograph across the
mesh by sharding its rows and exchanging halo strips between neighbours
(port of emx/parallel/halo.py).

Each rank of the 'spatial' axis takes a block of rows, receives `halo`
rows from the rank above and below it (send and receive in one
batch_isend_irecv along the non-wrapping chain; the edge ranks reflect
their own rows instead), runs the model on the padded block and crops
the halo off; the blocks are then all-gathered, so every rank returns
the whole output, as emx's global array is. Exact whenever the model's
receptive-field radius <= halo.

At world size 1 with no process group the chain is one rank and nothing
is sent: both edges reflect.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from emx_torch.parallel.mesh import Mesh, NamedSharding


def exchange_halo(x: torch.Tensor, halo: int, group,
                  chain: list[int] | None = None) -> torch.Tensor:
    """Prepend/append `halo` rows from the previous/next rank of `chain`
    (global ranks in row order; by default `group`'s ranks ascending)
    along dim 0; the first and last rank reflect their own rows, without
    the edge row (x[1:halo+1] reversed). x: (h, ...). `group` None: one
    rank, no exchange."""
    if group is None:
        chain, me = [0], 0
    else:
        chain = dist.get_process_group_ranks(group) if chain is None \
            else chain
        me = chain.index(dist.get_rank())
    n = len(chain)
    x = x.contiguous()
    ops, from_prev, from_next = [], None, None
    if me > 0:
        from_prev = torch.empty_like(x[:halo])
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), chain[me - 1],
                           group),
                dist.P2POp(dist.irecv, from_prev, chain[me - 1], group)]
    if me < n - 1:
        from_next = torch.empty_like(x[-halo:])
        ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(),
                           chain[me + 1], group),
                dist.P2POp(dist.irecv, from_next, chain[me + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # Edge shards have no neighbour: reflect own rows (matches the
    # behaviour of SAME padding closely enough for restoration nets).
    top = x[1:halo + 1].flip(0) if from_prev is None else from_prev
    bot = x[-halo - 1:-1].flip(0) if from_next is None else from_next
    return torch.cat([top, x, bot], dim=0)


def spatial_apply(apply_fn, img, mesh: Mesh, halo: int = 64,
                  axis_name: str = "spatial", grid: int = 1
                  ) -> torch.Tensor:
    """Apply `apply_fn((h, w) -> (h, w))` to a huge image (the whole
    image, on every rank) sharded over `axis_name`; returns the whole
    output on this rank's device.

    `halo` should cover the model's effective receptive-field radius
    (DenoiserConfig.receptive_field_radius() is the hard upper bound;
    the reference's 80 px tiling overlap is the practical anchor).

    `grid` is the model's alignment unit (DenoiserConfig.halo_grid():
    space_to_depth x total stride). The halo is rounded UP to a multiple
    of it so every shard's strided-conv grid coincides with the global
    grid, and the image height is reflect-padded (with the edge row) up
    to a multiple of n x grid - arbitrary heights work, not just exact
    divisors.
    """
    n = mesh.shape[axis_name]
    img = torch.as_tensor(img)
    h = img.shape[0]
    if grid > 1:
        halo = -(-halo // grid) * grid
    unit = n * max(1, grid)
    h_pad = -(-h // unit) * unit
    pad = h_pad - h
    if pad:
        if pad > h:
            raise ValueError(
                f"image height {h} too small for {n}x{grid} padding unit")
        img = torch.cat([img, img[h - pad:].flip(0)], dim=0)
    if halo >= h_pad // n:
        raise ValueError(
            f"halo {halo} must be smaller than the shard height "
            f"{h_pad // n} - use fewer spatial shards or a bigger image")
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh}")

    rows = NamedSharding(mesh, (axis_name,))
    shard = rows.shard(img)
    padded = exchange_halo(shard, halo, mesh.group(axis_name),
                           mesh.chain(axis_name))
    out = apply_fn(padded)
    out = rows.gather(out[halo:out.shape[0] - halo])
    return out[:h] if pad else out


def spatial_sharded_image(img, mesh: Mesh, axis_name: str = "spatial"
                          ) -> torch.Tensor:
    """This rank's rows of a big image, on its device."""
    return NamedSharding(mesh, (axis_name, None)).shard(img)


def halo_denoise(model, img, mesh: Mesh, halo: int | None = None,
                 axis_name: str = "spatial") -> torch.Tensor:
    """Denoise ONE huge micrograph across the mesh - the multi-rank
    serving path for images too large for one device (the replacement
    for host-side tiling).

    Wires the Denoiser's own geometry in: the halo defaults to the
    reference's 80 px tiling overlap and both the halo and the shard
    heights are aligned to model.config.halo_grid() by spatial_apply, so
    any s2d / any image height works. `model` is a Denoiser (its weights
    in it) on this rank's device; its own forward runs in inference mode.
    """
    grid = model.config.halo_grid()
    if halo is None:
        halo = max(80, grid)
    device = next(model.parameters()).device

    def apply_fn(x):
        with torch.inference_mode():
            return model(x[None].to(device, torch.float32), train=False)[0]

    return spatial_apply(apply_fn, img, mesh, halo=halo,
                         axis_name=axis_name, grid=grid)
