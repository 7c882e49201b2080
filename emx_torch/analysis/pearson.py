"""Pearson-system CDFs from the first four moments (copy of
emx/analysis/pearson.py: numpy and scipy only).

Capability rebuild of reference misc_py/moments_to_cdf.py:1-249 (which
assembled per-family CDFs from scipy.special/mpmath): classify the
Pearson family from (mean, variance, skewness, kurtosis) with the
standard kappa criterion and return a distribution object exposing
.cdf/.pdf. Families I/II/III/V/VI/VII map onto scipy.stats forms;
type IV (no closed scipy form) integrates its density numerically.

Used with emx_torch.physics.image_stats moments to model micrograph statistic
distributions (the "profiles" feature-equalisation workflow).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np


@dataclasses.dataclass
class PearsonDist:
    family: str
    cdf: Callable[[np.ndarray], np.ndarray]
    pdf: Callable[[np.ndarray], np.ndarray]


def classify_family(skew: float, kurt: float) -> str:
    """Pearson plane classification via kappa = b1*(b3+3)^2 /
    (4*(4*b2-3*b1)*(2*b2-3*b1-6)) with b1=skew^2, b2=kurt."""
    b1 = skew**2
    b2 = kurt
    if abs(b1) < 1e-10:
        # Symmetric: platykurtic -> II (beta), leptokurtic -> VII (t).
        if abs(b2 - 3) < 1e-8:
            return "normal"
        return "VII" if b2 > 3 else "II"
    denom = 4 * (4 * b2 - 3 * b1) * (2 * b2 - 3 * b1 - 6)
    if abs(denom) < 1e-12:
        return "III" if abs(2 * b2 - 3 * b1 - 6) < 1e-8 else "normal"
    kappa = b1 * (b2 + 3) ** 2 / denom
    if kappa < 0:
        return "I"
    if abs(kappa) < 1e-10:
        return "normal"
    if abs(kappa - 1) < 1e-8:
        return "V"
    if kappa > 1:
        return "VI"
    return "IV"  # 0 < kappa < 1


def pearson_from_moments(
    mean: float, var: float, skew: float = 0.0, kurt: float = 3.0
) -> PearsonDist:
    from scipy import integrate, stats

    sd = math.sqrt(max(var, 1e-300))
    family = classify_family(skew, kurt)

    if family == "normal" or (abs(skew) < 1e-9 and abs(kurt - 3.0) < 1e-9):
        d = stats.norm(loc=mean, scale=sd)
        return PearsonDist("normal", d.cdf, d.pdf)

    if family in ("I", "II"):
        # Beta: moment-match a, b on a support [lo, hi].
        b1, b2 = skew**2, kurt
        r = 6 * (b2 - b1 - 1) / (6 + 3 * b1 - 2 * b2)
        disc = max(b1 * (r + 2) ** 2 + 16 * (r + 1), 0.0)
        if skew >= 0:
            a = r / 2 * (1 - (r + 2) * abs(skew) / math.sqrt(disc))
            b = r - a
        else:
            b = r / 2 * (1 - (r + 2) * abs(skew) / math.sqrt(disc))
            a = r - b
        a, b = max(a, 1e-3), max(b, 1e-3)
        span = sd * math.sqrt((a + b) ** 2 * (a + b + 1) / (a * b))
        lo = mean - a * span / (a + b)
        d = stats.beta(a, b, loc=lo, scale=span)
        return PearsonDist(family, d.cdf, d.pdf)

    if family == "III":
        # Gamma (Pearson type III): shape from skewness.
        shape = 4.0 / max(skew**2, 1e-10)
        scale = sd * abs(skew) / 2.0
        if skew >= 0:
            d = stats.gamma(shape, loc=mean - shape * scale, scale=scale)
            return PearsonDist("III", d.cdf, d.pdf)
        d = stats.gamma(shape, loc=-(mean + shape * scale), scale=scale)
        return PearsonDist(
            "III",
            lambda x: 1.0 - d.cdf(-np.asarray(x)),
            lambda x: d.pdf(-np.asarray(x)),
        )

    if family == "V":
        # Inverse gamma.
        b1 = skew**2
        shape = 4 + (8 + 4 * math.sqrt(4 + b1)) / max(b1, 1e-10)
        scale = sd * (shape - 1) * math.sqrt(shape - 2)
        d = stats.invgamma(shape, loc=mean - scale / (shape - 1), scale=scale)
        return PearsonDist("V", d.cdf, d.pdf)

    if family == "VI":
        # Beta prime; moment-fit via scipy's betaprime with location/scale.
        b1 = max(skew**2, 1e-8)
        b2 = kurt
        r = 6 * (b2 - b1 - 1) / (6 + 3 * b1 - 2 * b2)
        # Fall back to a lognormal-shaped fit when the closed form
        # degenerates (scipy handles the heavy tail similarly).
        try:
            a = max(2.5, abs(r))
            bshape = a + 2 + 8 / b1
            d = stats.betaprime(a, bshape)
            m, v = d.stats("mv")
            scale = sd / math.sqrt(float(v))
            loc = mean - float(m) * scale
            dd = stats.betaprime(a, bshape, loc=loc, scale=scale)
            return PearsonDist("VI", dd.cdf, dd.pdf)
        except Exception:
            d = stats.norm(loc=mean, scale=sd)
            return PearsonDist("VI~normal", d.cdf, d.pdf)

    if family == "VII" or (abs(skew) < 1e-9 and kurt > 3.0):
        # Student-t scaled: kurt = 3 + 6/(nu - 4).
        nu = 4 + 6.0 / max(kurt - 3.0, 1e-10)
        scale = sd * math.sqrt((nu - 2) / nu)
        d = stats.t(nu, loc=mean, scale=scale)
        return PearsonDist("VII", d.cdf, d.pdf)

    # Type IV: numeric CDF of the Pearson IV density.
    b1, b2 = skew**2, kurt
    r = 6 * (b2 - b1 - 1) / (2 * b2 - 3 * b1 - 6)
    m = 1 + r / 2
    nu = -r * (r - 2) * skew / math.sqrt(max(16 * (r - 1) - b1 * (r - 2) ** 2,
                                             1e-12))
    a = sd * math.sqrt(max(16 * (r - 1) - b1 * (r - 2) ** 2, 1e-12)) / 4
    lam = mean - ((r - 2) * skew * sd) / 4

    def pdf(x):
        x = np.asarray(x, np.float64)
        z = (x - lam) / a
        logp = -m * np.log1p(z**2) - nu * np.arctan(z)
        p = np.exp(logp)
        # Normalise numerically over a wide grid.
        grid = np.linspace(lam - 40 * a, lam + 40 * a, 20001)
        gz = (grid - lam) / a
        gp = np.exp(-m * np.log1p(gz**2) - nu * np.arctan(gz))
        norm = np.trapezoid(gp, grid)
        return p / norm

    def cdf(x):
        from scipy import integrate

        x = np.atleast_1d(np.asarray(x, np.float64))
        out = np.empty_like(x)
        lo = lam - 40 * a
        for i, xi in enumerate(x):
            out[i], _ = integrate.quad(
                lambda t: pdf(t), lo, min(xi, lam + 40 * a), limit=200
            )
        out = np.clip(out, 0.0, 1.0)
        return out if out.size > 1 else float(out[0])

    return PearsonDist("IV", cdf, pdf)


def moment_redistributor(values: np.ndarray, num_bins: int = 100):
    """Empirical-CDF "redistributor" used to equalise the 37 image
    statistics before the profile MLP (reference misc_py/profiles_miner.py:
    min/max/mean + 100-bin CDF)."""
    vals = np.sort(np.asarray(values, np.float64))
    qs = np.quantile(vals, np.linspace(0, 1, num_bins + 1))

    def transform(x):
        return np.clip(np.interp(x, qs, np.linspace(0, 1, num_bins + 1)), 0, 1)

    return {
        "min": float(vals.min()),
        "max": float(vals.max()),
        "mean": float(vals.mean()),
        "quantiles": qs,
        "transform": transform,
    }
