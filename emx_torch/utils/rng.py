"""Counter-derived seeds: one 64-bit seed per (seed, step, ...) tuple.

The port's randomness is keyed like emx's `jax.random.fold_in`: a run's
seed and a position (epoch, step, stream) give a seed of their own, so a
resumed run draws exactly what an uninterrupted one draws. The mix is
SplitMix64 (Steele, Lea and Flood, OOPSLA 2014).
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A seed in [0, 2^64) derived from `seed` and each of `data`."""
    x = _splitmix64(seed & _M64)
    for d in data:
        x = _splitmix64(x ^ (d & _M64))
    return x
