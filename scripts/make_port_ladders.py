"""Write the Poisson counts of the flagship's five evaluation ladders for
the PyTorch port: docs/runs/port_ladders/ladders.npz.

emx's ladders (emx/bench/quant_check.py:_val_ladder, _ood_ladder) draw
their shot noise with `jax.random.poisson`, which the port cannot
reproduce. This script draws the counts with emx, exactly as the
ladders do, checks that they give emx's noisy images and targets bit
for bit, and stores them as uint8 with what the port needs to rebuild
the rest on its own device (emx_torch.bench.ladders):

  <family>_counts          (32, 512, 512) uint8 Poisson counts
  <family>_doses           (32,) float32, linspace(25, 150, 32)
  <family>_seed            the clean images' generator seed
  <family>_key             the noise key (jax.random.key)
  <family>_sha256          sha256 of emx's clean images' float32 bytes
  <family>_fingerprint     (32, 3) float64 per clean image: mean, mean
                           square, projection on a fixed +-1 pattern
                           (emx_torch.bench.ladders.fingerprint), which
                           the port's images must meet within 1e-5
  <family>_identity_psnr   emx's per-image PSNR of noisy against target

Usage (CPU, about two minutes):
    JAX_PLATFORMS=cpu python scripts/make_port_ladders.py [out.npz]
"""

from __future__ import annotations

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from emx.bench.flagship_decision import FAMILIES  # noqa: E402
from emx.bench.quant_check import _ood_ladder, _val_ladder  # noqa: E402
from emx.data.pipeline import (ctf_micrographs, filament_micrographs,  # noqa: E402
                               grain_micrographs, porous_micrographs,
                               synthetic_micrographs)
from emx.utils.image import psnr, sanitize, scale0to1  # noqa: E402
from emx_torch.bench import ladders  # noqa: E402

OUT = "docs/runs/port_ladders/ladders.npz"
# family -> (clean-image generator, seed, noise key), as quant_check has them.
SOURCES = {
    "val": (synthetic_micrographs, 999, 7),
    "ood_ctf": (ctf_micrographs, 555, 13),
    "ood_grains": (grain_micrographs, 321, 13),
    "ood_filaments": (filament_micrographs, 777, 13),
    "ood_porous": (porous_micrographs, 444, 13),
}


def _record(family: str, n: int, size: int, clean: np.ndarray) -> dict:
    """sha256 and fingerprint of emx's clean images; the port's numpy
    families must equal them bit for bit on this machine."""
    if family != "ood_ctf":
        port = ladders.clean_images(family, n, size, device="cpu").numpy()
        if not np.array_equal(port, clean):
            raise AssertionError(f"{family}: the port's clean images "
                                 f"differ")
    return {"sha256": hashlib.sha256(np.ascontiguousarray(
                clean, np.float32).tobytes()).hexdigest(),
            "fingerprint": ladders.fingerprint(
                torch.tensor(clean)).numpy()}


def family_counts(family: str, n: int = 32, size: int = 512) -> dict:
    """emx's ladder for `family` with its Poisson counts: the counts are
    drawn as emx.data.degrade.poisson_dose draws them inside the ladder,
    and scale0to1 of them must equal emx's noisy images exactly."""
    gen, seed, key = SOURCES[family]
    clean = np.asarray(gen(n, size, seed=seed), np.float32)
    doses = np.linspace(25.0, 150.0, n).astype(np.float32)

    @jax.jit
    def draw(imgs, doses):
        def one(k, img, dose):
            img = scale0to1(sanitize(img))
            return jax.random.poisson(k, img * dose)

        keys = jax.random.split(jax.random.key(key), imgs.shape[0])
        return jax.vmap(one)(keys, imgs, doses)

    counts = np.asarray(draw(jnp.asarray(clean), jnp.asarray(doses)))
    noisy, target = (_val_ladder(n, size) if family == "val" else
                     _ood_ladder(n, size, family=family.split("_", 1)[1]))
    noisy, target = np.asarray(noisy), np.asarray(target)
    lq = np.asarray(jax.vmap(lambda c: scale0to1(c))(
        jnp.asarray(counts, jnp.float32)))
    if not np.array_equal(lq, noisy):
        raise AssertionError(f"{family}: counts do not give emx's ladder")
    if counts.min() < 0 or counts.max() > 255:
        raise AssertionError(f"{family}: counts outside uint8: "
                             f"[{counts.min()}, {counts.max()}]")
    ident = np.asarray(jax.vmap(psnr)(jnp.asarray(noisy),
                                      jnp.asarray(target)), np.float32)
    return {"clean": clean, "doses": doses, "seed": seed, "key": key,
            "counts": counts.astype(np.uint8), "noisy": noisy,
            "target": target, "identity_psnr": ident,
            **_record(family, n, size, clean)}


def main(out: str = OUT, n: int = 32, size: int = 512) -> None:
    arrays = {}
    for fam in FAMILIES:
        r = family_counts(fam, n, size)
        arrays.update({f"{fam}_counts": r["counts"],
                       f"{fam}_doses": r["doses"],
                       f"{fam}_seed": np.int64(r["seed"]),
                       f"{fam}_key": np.int64(r["key"]),
                       f"{fam}_sha256": np.array(r["sha256"]),
                       f"{fam}_fingerprint": r["fingerprint"],
                       f"{fam}_identity_psnr": r["identity_psnr"]})
        print(f"{fam}: max count {int(r['counts'].max())}, identity PSNR "
              f"{float(np.mean(r['identity_psnr'])):.3f} dB", flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {os.path.getsize(out) / 2 ** 20:.2f} MiB")


if __name__ == "__main__":
    main(*sys.argv[1:])
