"""Record emx's serial evaluation of the committed autofocus policy,
episode by episode, for the port to be held to on the card, and emx's
own spread under last-bit changes of its propagation.

    JAX_PLATFORMS=cpu python scripts/make_port_dqn_trace.py
    JAX_PLATFORMS=cpu python scripts/make_port_dqn_trace.py --spread
    JAX_PLATFORMS=cpu python scripts/make_port_dqn_trace.py --frames

Runs emx's six serial rows (emx.bench.dqn_run.make_env, emx's Q-network
on docs/runs/dqn_autofocus_v2/policy.npz, 50 episodes each) through
emx_torch.bench.dqn_vec.serial_eval's tracing, checks that the rows equal
docs/runs/dqn_autofocus_v2/quality.json, and writes every episode (the
digests of the frames, the focal scan's target, the start, each step's
shift, reward, distance and Q values) to
docs/runs/port_dqn_eval/emx_trace.json (~1 min on a CPU).

--spread instead runs emx's evaluation once for each of NUDGES, with
every propagated wave changed in its last bits, six processes at a time,
and writes their rows to docs/runs/port_dqn_eval/emx_nudged_rows.json
(~35 min): emx's own spread, which scripts/port_dqn_spread.py
--summary prints. "up" and "down" scale the whole wave by 1 +- 2^-23; an
integer seed scales each pixel of each frame by 1 + 2^-23 k, k a whole
number drawn from N(0, 1.3) with that seed, a change like another FFT's
rounding and as large as the port's (PERF.md §6). --frames prints how
far the port's noiseless frames lie from emx's, which sets that size.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = "docs/runs/port_dqn_eval/emx_trace.json"
SPREAD = "docs/runs/port_dqn_eval/emx_nudged_rows.json"
POLICY = "docs/runs/dqn_autofocus_v2/policy.npz"
RECORD = "docs/runs/dqn_autofocus_v2/quality.json"
NUDGES = ("up", "down", *map(str, range(1, 199)))


def emx_rows(nudge: str | None = None):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    jax.config.update("jax_platforms", "cpu")
    import emx.physics.propagate as prop
    from emx.bench.dqn_run import make_env
    from emx.scope.dqn import QNetwork
    from emx_torch.bench.dqn_vec import serial_eval

    if nudge is not None:
        plain = prop.propagate_back_to_defocus
        rng = np.random.default_rng(0 if nudge in ("up", "down")
                                    else int(nudge))

        def nudged(*a, **k):
            out = plain(*a, **k)
            if nudge in ("up", "down"):
                return out * jnp.float32(1.0 + (1 if nudge == "up" else -1)
                                         * 2.0 ** -23)
            # Each pixel's amplitude moved by a whole number of float32
            # ulps, N(0, 1.3): the intensities then differ from the
            # unnudged ones as the port's do (mean 2.5e-7, largest
            # ~1.2e-6 of the mean; PERF.md §6).
            k_ulps = np.rint(rng.normal(0.0, 1.3, out.shape[-2:]))
            return out * jnp.asarray(1.0 + k_ulps * 2.0 ** -23, jnp.float32)

        prop.propagate_back_to_defocus = nudged
    with np.load(POLICY) as z:
        tree = unflatten_dict({tuple(p[2:-2] for p in k.split("/")):
                               jnp.asarray(v) for k, v in z.items()})
    apply = jax.jit(QNetwork(7, (32, 64)).apply)
    trace: dict = {}
    rows = serial_eval(lambda o: np.asarray(apply(tree, o)),
                       np.linspace(-1.0, 1.0, 7), 50,
                       make_env=lambda seed: make_env(seed=seed),
                       trace=trace)
    for episodes in trace.values():
        for ep in episodes:
            ep.pop("obs", None)
    return rows, trace


def frame_gap() -> None:
    """Print how far the port's noiseless propagation (torch's FFT on the
    CPU) lies from emx's (XLA's) on the eval env's field: the largest and
    the mean difference of the intensities, over their mean."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from emx.physics.propagate import propagate_back_to_defocus as emx_prop
    from emx_torch.physics.propagate import propagate_back_to_defocus
    from emx_torch.scope.sim import disc_specimen

    field = disc_specimen(1, 192, seed=123)[0][:48, :48]
    for z in (0.02, 0.3, 1.0, 1.5, 3.0, 9.0):
        ref = np.asarray(jnp.abs(emx_prop(jnp.exp(1j * jnp.asarray(field))
                                          .astype(jnp.complex64),
                                          z * 200.0, 0.025)) ** 2)
        got = (propagate_back_to_defocus(
            torch.exp(1j * torch.from_numpy(field)).to(torch.complex64),
            z * 200.0, 0.025).abs() ** 2).numpy()
        gap = np.abs(got - ref) / ref.mean()
        print(f"z {z}: largest {gap.max():.3g}, mean {gap.mean():.3g}")


def _nudged_rows(nudge: str) -> tuple[str, dict]:
    return nudge, emx_rows(nudge)[0]


def main(argv: list[str]) -> None:
    with open(RECORD) as f:
        record = json.load(f)["results"]
    if "--frames" in argv:
        frame_gap()
        return
    if "--spread" in argv:
        with multiprocessing.get_context("spawn").Pool(6) as pool:
            spread = dict(pool.map(_nudged_rows, NUDGES))
        with open(SPREAD, "w") as f:
            json.dump({"nudges": list(NUDGES), "rows": spread}, f,
                      separators=(",", ":"))
        print(f"wrote {SPREAD}")
        return
    rows, trace = emx_rows()
    for name, r in rows.items():
        print(name, "equal to the record" if r == record[name] else
              f"differs: {r} against {record[name]}", flush=True)
    if rows != record:
        raise SystemExit("emx's rows are not the record's: not written")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(trace, f, separators=(",", ":"))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:])
