"""The multi-rank dry run (twin of __graft_entry__.dryrun_multichip): the
FULL training step (on-device degradation + forward + backward +
gradient accumulation + optimizer) data-parallel over n ranks on tiny
shapes, then the multi-rank SERVING path, halo spatial parallelism of
one image over n ranks, against the full-image pass.

    python -m emx_torch.parallel.dryrun 4      # one NCCL rank a card
    python -m emx_torch.parallel.dryrun 4 --device=cpu   # gloo ranks
    torchrun --nproc_per_node=4 -m emx_torch.parallel.dryrun 4

Inside a process group of world size n (torchrun, or chip_smoke's one
NCCL rank) it runs as this rank; otherwise it spawns n processes over a
file store in a temporary directory: NCCL ranks, one a card, on a host
with CUDA (fewer than n cards is an error), gloo ranks on the CPU where
the CPU is asked for or no CUDA exists.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _run(n: int) -> dict:
    """The dry run as this rank of a world of n."""
    from emx_torch.data.degrade import denoiser_example
    from emx_torch.nn import Denoiser, DenoiserConfig
    from emx_torch.nn.init import init_parameters
    from emx_torch.parallel.halo import halo_denoise
    from emx_torch.parallel.mesh import make_mesh
    from emx_torch.train import TrainConfig, Trainer

    mesh = make_mesh(data=n, spatial=1)
    cfg = DenoiserConfig(features=(8, 12, 16, 24, 24), num_middle_blocks=1,
                         aspp_filters=16, aspp_out=16, norm="group")
    trainer = Trainer(
        Denoiser(cfg, device=mesh.device),
        TrainConfig(learning_rate=1e-3, optimizer="adam", grad_accum=2,
                    log_every=0),
        mesh=mesh, example_fn=denoiser_example)
    batch_size = 2 * n
    state = trainer.init()
    batch = np.random.default_rng(0).random(
        (batch_size, 32, 32)).astype(np.float32)
    state, metrics = trainer.step_fn(state, batch)
    loss = float(metrics["loss"])
    assert state.step == 1
    assert np.isfinite(loss), loss

    # The serving path: one image row-sharded over all n ranks, halos
    # exchanged between neighbours, against the unsharded full-image
    # pass. The norm-free deployment graph (a served model is always
    # BatchNorm-folded): GroupNorm statistics are whole-image-dependent
    # and would differ per shard by construction.
    smesh = make_mesh(data=1, spatial=n)
    serve_model = Denoiser(dataclasses.replace(cfg, norm="none"),
                           device=smesh.device)
    init_parameters(serve_model, torch.Generator().manual_seed(2))
    grid = serve_model.config.halo_grid()
    h = grid * n * 2  # two grid rows per shard
    img = torch.from_numpy(np.random.default_rng(1).random(
        (h, 2 * grid)).astype(np.float32))
    out = halo_denoise(serve_model, img, smesh, halo=grid)
    assert tuple(out.shape) == tuple(img.shape)
    assert bool(torch.isfinite(out).all())
    with torch.inference_mode():
        full = serve_model(img[None].to(smesh.device), train=False)[0]
    # Agreement is up to halo truncation of the receptive field (the tiny
    # model's field far exceeds any practical halo): a bound on the mean.
    err = float(torch.mean(torch.abs(out - full)))
    assert err < 0.1, f"halo vs full-image mean mismatch: {err}"
    return {"n": n, "backend": dist.get_backend() if dist.is_initialized()
            else None, "device": str(mesh.device), "loss": loss,
            "halo_err": err}


def _worker(rank: int, n: int, store: str, backend: str) -> None:
    from emx_torch.parallel.distributed import initialize

    torch.set_num_threads(1)
    initialize(f"file://{store}/rendezvous", n, rank, backend=backend)
    try:
        out = _run(n)
        if rank == 0:
            with open(os.path.join(store, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | None = None) -> dict:
    """Run the dry run over `n_devices` ranks; returns rank 0's loss and
    halo error. Raises if a rank fails. In a process group it runs as
    this rank of it; otherwise `device` "cuda" spawns one NCCL rank a
    card and "cpu" gloo ranks, and None means "cuda" where CUDA exists
    and "cpu" where it does not."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is initialised, not {n_devices}")
        return _run(n_devices)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: cuda or cpu")
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} NCCL ranks need {n_devices} cards; "
                           f"{torch.cuda.device_count()} present (pass "
                           f"device='cpu' for gloo ranks on the CPU)")
    backend = "nccl" if device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as store:
        torch.multiprocessing.spawn(_worker, (n_devices, store, backend),
                                    nprocs=n_devices, join=True)
        with open(os.path.join(store, "result.json")) as f:
            return json.load(f)


if __name__ == "__main__":
    import argparse

    from emx_torch.parallel.distributed import initialize

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda: one NCCL rank a card; cpu: gloo ranks "
                         "(default: cuda where CUDA exists)")
    args = ap.parse_args()
    # Joins torchrun's group where its variables are set.
    initialize(backend=None if args.device is None else
               {"cuda": "nccl", "cpu": "gloo"}[args.device])
    print(json.dumps(dryrun_multichip(args.n, args.device)))
