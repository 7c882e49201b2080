"""PSNR of the zoo ladder's latent_ae family along its training, for
several seeds: how many steps a cut run needs before its PSNR is above
the best constant predictor (chip_smoke.py's zoo gate).

Trains exactly as emx_torch.bench.zoo_ladder.run_latent_ae does (scale
0.25, 128^2, batch 8, Adam 1e-3, dropout drawn from the run's generator)
under cuDNN's deterministic algorithms and with TF32 off, as chip_smoke.py
runs it, and scores the held-out batch every `every` steps. Scoring reads
the BatchNorm statistics and draws nothing, so the PSNR at step L is that
of a run cut to L steps.

Usage, on a CUDA card: python scripts/zoo_latent_curve.py [steps] [every]
[seed ...]   (defaults 4000, 250, seeds 0-4); one JSON line per seed.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from emx_torch.bench import zoo_ladder as zl  # noqa: E402
from emx_torch.nn.latent import LatentAutoencoder  # noqa: E402
from emx_torch.utils.device import (card_name_and_power,  # noqa: E402
                                    cudnn_deterministic, resolve_device)


def curve(seed: int, steps: int, every: int, device) -> dict:
    dev = resolve_device(device)
    model = zl._init(LatentAutoencoder(zl.latent_ae_config(0.25),
                                       device="cpu"), seed, dev)
    train = zl._data(256, zl.LATENT_SIZE, 3, dev)
    val = zl._data(16, zl.LATENT_SIZE, 97, dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = zl._generator(dev, seed + 1)
    psnr = {}
    for i in range(1, steps + 1):
        idx = torch.randint(0, train.shape[0], (8,), generator=gen,
                            device=dev)
        zl.recon_step(model, opt, train[idx], generator=gen)
        if i % every == 0:
            with torch.no_grad():
                psnr[i] = round(zl._psnr_mean(model(val, train=False),
                                              val), 2)
    return {"seed": seed, "anchor_const_psnr": round(zl._const_anchor(val),
                                                     2), "psnr": psnr}


def main(argv: list[str]) -> None:
    steps = int(argv[0]) if argv else 4000
    every = int(argv[1]) if len(argv) > 1 else 250
    seeds = [int(s) for s in argv[2:]] or [0, 1, 2, 3, 4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_name_and_power(), flush=True)
    with cudnn_deterministic():
        for seed in seeds:
            print(json.dumps(curve(seed, steps, every, "cuda")), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
