"""DQN autofocus training to convergence (port of emx/bench/dqn_run.py).

Trains the DQN on the simulated microscope's FresnelEnv until the
greedy policy focuses the scope, then scores it against a random policy
and a reward-feedback hill-climb sweep — the evidence that the RL loop
is solved, not just interface-tested. Reference training loop:
em_env/fresnel_remover.py:93-118 (keras-rl DQN, 1.75M steps on
hardware); the simulator stands in for the column (SURVEY.md §7 hard
part 6: the simulator is the source of truth for tests).

Usage: python -m emx_torch.bench.dqn_run [out_dir] [episodes] [--device=cpu]
Writes <out_dir>/metrics.jsonl + quality.json and prints a summary line.
The simulator's propagation and the agent run on `device` (the card by
default); the Poisson counts, the exploration and the replay indices
come from numpy, as emx's do.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def make_env(seed: int = 0, image_size: int = 48, device="cuda"):
    from emx_torch.scope.env import FresnelEnv, StackedFresnelEnv
    from emx_torch.scope.protocol import MicroscopeClient
    from emx_torch.scope.sim import InProcessTransport, SimulatedMicroscope

    scope = SimulatedMicroscope(image_size=image_size, dose=2000.0,
                                optimal_z=0.0, seed=seed, device=device)
    # scan_halfwidth=1.5 keeps the focal scan inside the kurtosis
    # metric's monotone basin (see FresnelEnv); episode starts still
    # span the full +-max_z_dist like training.
    env = FresnelEnv(MicroscopeClient(InProcessTransport(scope)),
                     max_shift=1.0, max_z_dist=3.0, z_scan_points=9,
                     proximity=0.15, max_episode_steps=16, seed=seed,
                     scan_halfwidth=1.5)
    return StackedFresnelEnv(env)


def run_policy(env, policy, episodes: int, seed: int = 0,
               true_z: float | None = None,
               target_override: float | None = None) -> dict:
    """Evaluate a policy(obs, env, state) -> (shift, state).

    `true_z`: the simulator's actual optimum, when known — reported as
    mean_final_true_distance / true_solve_rate alongside the env's own
    scan-estimate-based scoring (the estimate carries the focal scan's
    residual error, the truth does not).

    `target_override`: GROUND-TRUTH-TARGET evaluation (round-4 verdict
    next-7): after each reset, replace the env's scan-estimated target_z
    with the simulator's true optimum, so reward, termination, and the
    distance metric all measure the policy against the truth. The
    default (None) keeps the operational protocol — the scan estimate —
    whose own error otherwise confounds the policy's score."""
    rng = np.random.default_rng(seed)
    returns, dists, true_dists, steps_l = [], [], [], []
    for ep in range(episodes):
        obs = env.reset()
        if target_override is not None:
            inner = getattr(env, "env", env)
            inner.target_z = float(target_override)
            inner.prev_diff = abs(inner.target_z - inner.z)
        state = None
        total, done, steps = 0.0, False, 0
        info = {"distance": abs(env.target_z - env.z)}
        while not done:
            shift, state = policy(obs, rng, state)
            obs, r, done, info = env.step([shift])
            total += r
            steps += 1
        returns.append(total)
        dists.append(info["distance"])
        if true_z is not None:
            true_dists.append(abs(env.z - true_z))
        steps_l.append(steps)
    out = {
        "mean_return": round(float(np.mean(returns)), 3),
        "mean_final_distance": round(float(np.mean(dists)), 3),
        "mean_steps": round(float(np.mean(steps_l)), 2),
        "solve_rate": round(float(np.mean(
            [d < 0.15 for d in dists])), 3),
    }
    if true_z is not None:
        out["mean_final_true_distance"] = round(float(np.mean(true_dists)), 3)
        out["true_solve_rate"] = round(float(np.mean(
            [d < 0.15 for d in true_dists])), 3)
    return out


def random_policy(obs, rng, state):
    return float(rng.uniform(-1.0, 1.0)), None


def hillclimb_policy(obs, rng, state):
    """Reward-feedback sweep: keep direction while the observed frame
    pair shows improvement (encoded in the stacked obs is NOT used —
    this baseline tracks its own last reward via env feedback through
    the distance-coupled fringe contrast proxy: mean |Laplacian|)."""
    from emx_torch.scope.env import fresnel_quantifier

    sharp = fresnel_quantifier(obs[..., 1])
    if state is None:
        return 1.0, (1.0, sharp)
    direction, prev = state
    if sharp > prev:  # fringes got worse -> reverse and shrink
        direction = -direction * 0.5
    return float(np.clip(direction, -1, 1)), (direction, sharp)


def main(out_dir: str = "docs/runs/dqn_autofocus",
         episodes: int = 400, device="cuda") -> dict:
    from emx_torch.scope.dqn import DQNAgent, DQNConfig
    from emx_torch.utils.device import resolve_device
    from emx_torch.utils.metrics import MetricsLogger

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    env = make_env(seed=0, device=device)
    obs0 = env.reset()
    cfg = DQNConfig(num_actions=7, features=(32, 64), max_shift=1.0,
                    eps_decay_steps=12000, warmup=400,
                    target_update_every=500, learning_rate=5e-4,
                    buffer_size=30000, seed=0)
    agent = DQNAgent(obs0.shape, cfg, device=device)
    logger = MetricsLogger(out_dir)

    t0 = time.perf_counter()
    window: list[float] = []
    for ep in range(episodes):
        obs = env.reset()
        total, done = 0.0, False
        prev_d = abs(env.target_z - env.z)
        while not done:
            a = agent.act(obs)
            next_obs, r, done, info = env.step([agent.action_to_shift(a)])
            # Potential-based shaping for TRAINING ONLY: the env's
            # reference-faithful +-1 improvement reward
            # (em_env/fresnel_env.py:114-124) is maximised by farming
            # tiny improvements forever; shaping by the distance
            # actually closed (telescoping to d0 - d_final) aligns
            # return-maximisation with focusing fast. Evaluation uses
            # the raw env reward.
            shaped = prev_d - info["distance"]
            if done and info["distance"] < env.env.proximity:
                shaped += 2.0  # terminal success bonus: value CROSSING
                # the proximity window, not just approaching it
            prev_d = info["distance"]
            agent.observe(obs, a, shaped, next_obs, done)
            obs = next_obs
            total += r
        window.append(total)
        if len(window) >= 20:
            logger.log(ep, mean_return_20=float(np.mean(window)),
                       epsilon=agent.epsilon(),
                       final_distance=float(info["distance"]))
            window = []
    train_s = time.perf_counter() - t0

    # Evaluation: fresh env seeds, greedy DQN vs baselines.
    eval_env = make_env(seed=123, device=device)
    n_eval = 50

    def dqn_policy(obs, rng, state):
        return agent.action_to_shift(agent.act(obs, greedy=True)), None

    results = {
        "dqn": run_policy(eval_env, dqn_policy, n_eval),
        "random": run_policy(eval_env, random_policy, n_eval),
        "hillclimb": run_policy(eval_env, hillclimb_policy, n_eval),
    }
    summary = {
        "metric": "dqn_autofocus",
        "train_episodes": episodes,
        "train_env_steps": agent.step_count,
        "train_s": round(train_s, 1),
        "eval_episodes": n_eval,
        **{f"{k}_{m}": v for k, r in results.items() for m, v in r.items()},
        "beats_random": results["dqn"]["mean_return"]
        > results["random"]["mean_return"],
        "beats_hillclimb": results["dqn"]["mean_return"]
        > results["hillclimb"]["mean_return"],
        "beats_random_solve": results["dqn"]["solve_rate"]
        > results["random"]["solve_rate"],
        "beats_random_distance": results["dqn"]["mean_final_distance"]
        < results["random"]["mean_final_distance"],
    }
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump({"results": results, **summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    argv = sys.argv[1:]
    a = [x for x in argv if not x.startswith("-")]
    dev = [x.split("=", 1)[1] for x in argv if x.startswith("--device=")]
    main(a[0] if a else "docs/runs/dqn_autofocus",
         int(a[1]) if len(a) > 1 else 400, device=dev[-1] if dev else "cuda")
