"""Reference-scale DQN autofocus on the batched simulator (port of
emx/bench/dqn_vec.py).

VecFresnelEnv advances B episodes per call on the card, and the agent's
batched path (act_batch/observe_batch, Double-DQN targets) trains from a
replay buffer on the card, which reaches the reference's budget
(em_env/fresnel_remover.py:93-118: 1.75M steps) in minutes.

Trains on a 512-specimen pool. Evaluation is emx's: greedy policy on the
serial FresnelEnv (scan-estimated target, unseen specimen seed) against
the random and hill-climb baselines, plus ground-truth-target rows, so
the numbers compare with emx's records (docs/runs/dqn_autofocus*/).
The serial evaluation draws its noise from numpy as emx's does, on one
stream for a whole row. A Poisson count can move by one where a float32
rate differs in its last bits between two FFT libraries, and then the
stream can fall out of step: the rows reproduce emx's only while the
frames agree, and `compare_traces` holds them that far (PERF.md §6).

Usage: python -m emx_torch.bench.dqn_vec [out_dir] [total_env_steps]
       [batch] [policy.npz] [--device=cpu]
       python -m emx_torch.bench.dqn_vec --compare <out_dir>  (against
       emx's record of the budget, docs/runs/dqn_autofocus)
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch


def _save_policy(agent, out_dir: str) -> None:
    """policy.npz under emx's flat keys (emx's dqn_vec loads it)."""
    from emx_torch.scope.dqn import policy_arrays

    # np.savez appends ".npz" unless the name already ends with it —
    # the temp name must keep that suffix or os.replace misses the file.
    tmp = os.path.join(out_dir, "policy.tmp.npz")
    np.savez(tmp, **policy_arrays(agent))
    os.replace(tmp, os.path.join(out_dir, "policy.npz"))


def make_trainer(total_steps: int, batch_envs: int = 128, device="cuda",
                 warmup: int = 5_000):
    """(env, agent): emx's vec env and Double-DQN agent configuration for
    a run of `total_steps` env steps (epsilon decays over half of it);
    gradient steps start once the buffer holds `warmup` transitions."""
    from emx_torch.scope.dqn import DQNAgent, DQNConfig
    from emx_torch.scope.vec_env import VecFresnelConfig, VecFresnelEnv

    vcfg = VecFresnelConfig(batch=batch_envs, image_size=48,
                            num_specimens=512, max_z_dist=3.0,
                            proximity=0.15, max_episode_steps=16,
                            specimen_seed=7)
    env = VecFresnelEnv(vcfg, device=device)
    cfg = DQNConfig(num_actions=7, features=(32, 64), max_shift=1.0,
                    gamma=0.95, learning_rate=3e-4,
                    eps_decay_steps=max(1, total_steps // 2), warmup=warmup,
                    target_update_every=1_000, buffer_size=80_000,
                    batch_size=256, double=True, seed=0)
    agent = DQNAgent((vcfg.image_size, vcfg.image_size, 3), cfg,
                     device=device)
    return env, agent


def train_iteration(env, agent, state, obs, train_steps: int = 2):
    """One batched iteration: act on every lane, step the env, store the
    transitions and take `train_steps` gradient steps. Returns (state,
    next obs, done, info, the last step's loss or None in the warm-up);
    next obs, done and info on the env's device."""
    actions = agent.act_batch(obs)
    state, next_obs, shaped, done, info = env.step(
        state, agent.shifts[actions])
    # Same shaping as the serial trainer: distance closed, plus a
    # terminal bonus for crossing the proximity window.
    rewards = shaped + 2.0 * info["solved"]
    loss = agent.observe_batch(obs, actions, rewards, next_obs, done,
                               train_steps=train_steps)
    return state, next_obs, done, info, loss


def vec_greedy_eval(env, agent, episodes: int = 200, seed: int = 4242
                    ) -> dict:
    """Greedy episodes on the vec env itself until `episodes` have ended:
    separates "policy didn't learn" from "serial-eval-env mismatch"."""
    vstate, vobs = env.reset(seed=seed)
    dists, solved = [], []
    while len(dists) < episodes:
        a = agent.act_batch(vobs, greedy=True)
        vstate, vobs, _, vdone, vinfo = env.step(vstate, agent.shifts[a])
        d = vdone.cpu().numpy()
        if d.any():
            dists.extend(vinfo["distance"].cpu().numpy()[d].tolist())
            solved.extend(vinfo["solved"].cpu().numpy()[d]
                          .astype(np.float32).tolist())
    return {"solve_rate": round(float(np.mean(solved)), 3),
            "mean_final_distance": round(float(np.mean(dists)), 3),
            "episodes": len(dists)}


def frame_digest(frame) -> str:
    """A short digest of a frame's bits: two frames with equal digests
    hold the same Poisson counts (the simulator rescales them in numpy)."""
    return hashlib.blake2b(np.ascontiguousarray(frame, np.float32).tobytes(),
                           digest_size=6).hexdigest()


class TracedEnv:
    """A StackedFresnelEnv that records each episode for `compare_traces`:
    the digests of the frames its reset acquired (the focal scan, then the
    start's frame) and the scan's target, the start z, and every step's
    shift, reward, distance and frame digest (the DQN's steps add their Q
    values and observations in serial_eval). `episodes` is the current
    row's list; run_policy reaches the inner FresnelEnv through `env`."""

    def __init__(self, stacked):
        self.stacked, self.env = stacked, stacked.env
        self.episodes: list = []
        self._frames: list = []
        client = self.env.client
        get_image = client.get_image

        def traced_get_image():
            img = get_image()
            self._frames.append(frame_digest(img))
            return img

        client.get_image = traced_get_image

    @property
    def target_z(self):
        return self.stacked.target_z

    @property
    def z(self):
        return self.stacked.z

    def reset(self):
        self._frames.clear()
        obs = self.stacked.reset()
        self.episodes.append({"scan": self._frames[:],
                              "target": self.env.target_z,
                              "start": self.env.z, "shift": [],
                              "reward": [], "distance": [], "frame": [],
                              "q": []})
        return obs

    def step(self, action):
        self._frames.clear()
        obs, r, done, info = self.stacked.step(action)
        ep = self.episodes[-1]
        ep["shift"].append(float(np.asarray(action).ravel()[0]))
        ep["reward"].append(float(r))
        ep["distance"].append(float(info["distance"]))
        ep["frame"].append("".join(self._frames))
        return obs, r, done, info


def serial_eval(q_values, shifts, n_eval: int = 50, device="cuda",
                make_env=None, trace: dict | None = None) -> dict:
    """emx's six serial rows: the greedy DQN, random and hill-climb on
    make_env(seed=123) (scan-estimated target), then the same three on
    make_env(seed=321) against the true optimum. `q_values(obs batch)`
    gives the Q-network's values (argmax is the greedy action, the first
    of equal values, as numpy's and torch's); `make_env(seed)` defaults
    to dqn_run.make_env on `device`. With `trace`, each row's episodes
    are recorded there (TracedEnv), each DQN step with its Q values and
    its observation (`obs`, a float32 array)."""
    from emx_torch.bench import dqn_run
    from emx_torch.bench.dqn_run import (hillclimb_policy, random_policy,
                                         run_policy)

    if make_env is None:
        def make_env(seed):
            return dqn_run.make_env(seed=seed, device=device)
    traced = None

    def dqn_policy(o, rng, st):
        q = q_values(o[None])
        if isinstance(q, torch.Tensor):
            q = q.detach().float().cpu()
        q = np.asarray(q, np.float32)[0]
        if traced is not None:
            ep = traced.episodes[-1]
            ep["q"].append(q.tolist())
            ep.setdefault("obs", []).append(np.array(o, np.float32))
        return float(shifts[int(np.argmax(q))]), None

    def rows(seed, named, **kw):
        nonlocal traced
        env = make_env(seed)
        if trace is not None:
            env = traced = TracedEnv(env)
        out = {}
        for name, pol in named:
            if traced is not None:
                traced.episodes = trace[name] = []
            # true_z=0.0: make_env's SimulatedMicroscope has optimal_z=0,
            # so the ground-truth focusing error is reported beside the
            # env's scan-estimate-based scoring.
            out[name] = run_policy(env, pol, n_eval, true_z=0.0, **kw)
        return out

    return {**rows(123, (("dqn", dqn_policy), ("random", random_policy),
                         ("hillclimb", hillclimb_policy))),
            **rows(321, (("dqn_true_target", dqn_policy),
                         ("random_true_target", random_policy),
                         ("hillclimb_true_target", hillclimb_policy)),
                   target_override=0.0)}


# Q values of the same frames: the port's against emx's (float32 on both
# sides), or against the policy's float64 forward.
Q_TOL = 1e-5
# serial_eval's rows, in order, by the env (and noise stream) they share.
_ROW_GROUPS = (("dqn", "random", "hillclimb"),
               ("dqn_true_target", "random_true_target",
                "hillclimb_true_target"))
_OUTCOME = ("target", "start", "shift", "reward", "distance")


def _hold_episode(a: dict, b: dict, res: dict):
    """One episode of the port (`a`) held to the reference's (`b`) while
    both saw the same frames. Returns where the frames (or a near-tie)
    first parted, None if they never did; a fault goes to res["fault"]."""
    def fault(why, s=None):
        res["fault"] = {"step": s, "why": why}

    if a["scan"] != b["scan"]:
        return {"step": None, "cause": "scan"}
    if (a["target"], a["start"]) != (b["target"], b["start"]):
        return fault(f"target/start {a['target']}/{a['start']} against "
                     f"{b['target']}/{b['start']} on the same scan")
    for s in range(max(len(a["shift"]), len(b["shift"]))):
        if s >= min(len(a["shift"]), len(b["shift"])):
            return fault("the episode ends at another step", s)
        if b["q"]:
            dq = float(np.max(np.abs(np.subtract(a["q"][s], b["q"][s]))))
            res["q_max_diff"] = max(res["q_max_diff"], dq)
            res["compared_q_steps"] += 1
            if dq > Q_TOL:
                return fault(f"Q values {dq:.3g} apart on the same frames", s)
        if a["shift"][s] != b["shift"][s]:
            top = sorted(b["q"][s])[-2:] if b["q"] else [0.0, 1.0]
            if top[1] - top[0] <= 2 * Q_TOL:
                return {"step": s, "cause": "near-tie"}
            return fault(f"shift {a['shift'][s]} against {b['shift'][s]} "
                         "on the same frames", s)
        if (a["reward"][s], a["distance"][s]) != (b["reward"][s],
                                                  b["distance"][s]):
            return fault("reward/distance differ on the same shifts", s)
        res["compared_steps"] += 1
        if a["frame"][s] != b["frame"][s]:
            return {"step": s + 1, "cause": "observation"}
    return None


def compare_traces(port: dict, ref: dict) -> dict:
    """Per row, the port's episodes against the reference's (emx's,
    `docs/runs/port_dqn_eval/emx_trace.json`), held only while the env has
    shown both sides the same frames (equal digests). A frame of other
    bits means a Poisson count moved with the FFT's last bits; from there
    the rows of that env draw from a noise stream that may be out of step,
    and nothing more of the env is compared. While the frames agree, each
    episode must have the same target and start, and each step the same
    shift, reward and distance and, on the DQN's rows, Q values within
    Q_TOL; a greedy action may differ only at a near-tie (the
    reference's two best values within 2 Q_TOL), which also ends the
    comparison. Anything else is a `fault`. Per row: the steps compared
    (with Q values), the largest Q difference, `parted` (the row, episode,
    step and cause where the env's frames first parted, maybe in an
    earlier row), `first_episode` (the first whose target, start or steps
    differ; None if none) and `fault` (None, or where and why)."""
    out = {}
    for group in _ROW_GROUPS:
        parted = None
        for row in group:
            eps, ref_eps = port[row], ref[row]
            res = {"episodes": len(eps), "compared_steps": 0,
                   "compared_q_steps": 0, "q_max_diff": 0.0, "fault": None,
                   "first_episode": next(
                       (k for k, (a, b) in enumerate(zip(eps, ref_eps))
                        if any(a[x] != b[x] for x in _OUTCOME)), None)}
            if len(eps) != len(ref_eps):
                res["fault"] = {"why": f"{len(eps)} episodes against "
                                       f"{len(ref_eps)}"}
            for k, (a, b) in enumerate(zip(eps, ref_eps)):
                if parted is not None or res["fault"] is not None:
                    break
                where = _hold_episode(a, b, res)
                if res["fault"] is not None:
                    res["fault"]["episode"] = k
                elif where is not None:
                    parted = {"row": row, "episode": k, **where}
            res["parted"] = parted
            out[row] = res
    return out


def main(out_dir: str = "docs/runs/dqn_autofocus",
         total_steps: int = 1_500_000, batch_envs: int = 128,
         train_steps_per_iter: int = 2, device="cuda",
         policy_npz: str | None = None, trace: dict | None = None,
         n_eval: int = 50) -> dict:
    """Train (unless `policy_npz`), evaluate, write quality.json and
    policy.npz under `out_dir`; returns the summary. With `trace`, the
    serial rows' episodes are recorded there (serial_eval); `n_eval`
    episodes a row (emx's 50)."""
    from emx_torch.scope.dqn import load_policy
    from emx_torch.utils.device import card_name_and_power, resolve_device
    from emx_torch.utils.metrics import MetricsLogger

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    env, agent = make_trainer(total_steps, batch_envs, device)
    logger = MetricsLogger(out_dir)

    if policy_npz:  # evaluate an already-trained policy (skip training)
        load_policy(agent, policy_npz)
        total_steps = 0

    state, obs = env.reset(seed=0)
    t0 = time.perf_counter()
    iters = total_steps // batch_envs
    done_dists: list[float] = []
    done_solved: list[float] = []
    for it in range(iters):
        state, obs, done, info, _ = train_iteration(env, agent, state, obs,
                                                    train_steps_per_iter)
        # One read a step of what the log needs.
        d, dist, solved = torch.stack([
            done.float(), info["distance"], info["solved"].float()]).cpu()
        d = d.numpy() > 0.5
        if d.any():
            done_dists.extend(dist.numpy()[d].tolist())
            done_solved.extend(solved.numpy()[d].tolist())
        if (it + 1) % 200 == 0:
            rate = agent.step_count / (time.perf_counter() - t0)
            logger.log(agent.step_count,
                       train_solve_rate=float(np.mean(done_solved or [0])),
                       train_final_distance=float(np.mean(done_dists or [0])),
                       epsilon=agent.epsilon(), env_steps_per_s=rate)
            done_dists, done_solved = [], []
        if (it + 1) % 1000 == 0:
            # Crash/timeout insurance: snapshot the policy so a killed
            # run can still be evaluated via policy_npz.
            _save_policy(agent, out_dir)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0

    vec_eval = vec_greedy_eval(env, agent)
    results = serial_eval(agent.q_values, agent.shifts, n_eval, device,
                          trace=trace)
    card = card_name_and_power() if device.type == "cuda" else None
    summary = {
        "metric": "dqn_autofocus",
        "trainer": "vec",
        "policy_npz": policy_npz,
        "train_env_steps": agent.step_count,
        "train_gradient_steps": agent.train_count,
        "batch_envs": batch_envs,
        "train_s": round(train_s, 1),
        # Rates are the card's; a CPU run records none.
        "env_steps_per_s": (round(agent.step_count / train_s, 1)
                            if card and train_s > 0 else None),
        "gradient_steps_per_s": (round(agent.train_count / train_s, 1)
                                 if card and train_s > 0 else None),
        "card": card,
        "vec_greedy_eval": vec_eval,
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
        "beats_random_true_distance":
            results["dqn"]["mean_final_true_distance"]
            < results["random"]["mean_final_true_distance"],
        "beats_hillclimb_true_distance":
            results["dqn"]["mean_final_true_distance"]
            < results["hillclimb"]["mean_final_true_distance"],
        "gt_solve_rate": results["dqn_true_target"]["solve_rate"],
        "gt_mean_final_distance":
            results["dqn_true_target"]["mean_final_distance"],
        "beats_random_gt":
            results["dqn_true_target"]["mean_final_distance"]
            < results["random_true_target"]["mean_final_distance"],
        "beats_hillclimb_gt":
            results["dqn_true_target"]["mean_final_distance"]
            < results["hillclimb_true_target"]["mean_final_distance"],
    }
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump({"results": results, **summary}, f, indent=1)
    # Policy weights for reuse (emx's flat npz keys).
    _save_policy(agent, out_dir)
    print(json.dumps(summary), flush=True)
    return summary


# emx's record of the same budget (trained on a CPU), and its policy's
# evaluation with the true-target rows.
RECORD_DIR = "docs/runs/dqn_autofocus"
RECORD_V2 = "docs/runs/dqn_autofocus_v2/quality.json"
TRUE_TARGET_FLAGS = ("beats_random_true_distance",
                     "beats_hillclimb_true_distance", "beats_random_gt",
                     "beats_hillclimb_gt")


def compare_run(out_dir: str, gt_tol: float = 0.2,
                train_tol: float = 0.03) -> dict:
    """A trained run's quality.json and metrics.jsonl against emx's
    record: the true-target comparisons as the record has them, the
    dqn_true_target solve rate within `gt_tol` of the record's, the last
    logged train_solve_rate within `train_tol` of the record's; the
    budgets and the rates beside each other."""
    from emx_torch.utils.metrics import read_jsonl

    def last_train_solve(d):
        rows = [r for r in read_jsonl(os.path.join(d, "metrics.jsonl"))
                if "train_solve_rate" in r]
        return rows[-1]["train_solve_rate"] if rows else None

    with open(os.path.join(out_dir, "quality.json")) as f:
        run = json.load(f)
    with open(os.path.join(RECORD_DIR, "quality.json")) as f:
        rec = json.load(f)
    with open(RECORD_V2) as f:
        rec2 = json.load(f)
    checks = {k: {"port": run[k], "record": rec2[k],
                  "ok": run[k] == rec2[k]} for k in TRUE_TARGET_FLAGS}
    gt, gt_rec = run["gt_solve_rate"], rec2["gt_solve_rate"]
    checks["gt_solve_rate"] = {"port": gt, "record": gt_rec,
                               "ok": abs(gt - gt_rec) <= gt_tol + 1e-9}
    tr, tr_rec = last_train_solve(out_dir), last_train_solve(RECORD_DIR)
    checks["last_train_solve_rate"] = {
        "port": tr, "record": tr_rec,
        "ok": tr is not None and abs(tr - tr_rec) <= train_tol + 1e-9}
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks,
            "train_env_steps": [run["train_env_steps"],
                                rec["train_env_steps"]],
            "train_gradient_steps": [run["train_gradient_steps"],
                                     rec["train_gradient_steps"]],
            "train_s": [run["train_s"], rec["train_s"]],
            "env_steps_per_s": run["env_steps_per_s"],
            "gradient_steps_per_s": run.get("gradient_steps_per_s"),
            "card": run.get("card"),
            "record_env_steps_per_s": f"{rec['env_steps_per_s']} (emx, a "
                                      "CPU: not the port's)"}


if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--compare" in argv:
        out = compare_run(next(x for x in argv if not x.startswith("-")))
        print(json.dumps(out, indent=1), flush=True)
        raise SystemExit(0 if out["ok"] else 1)
    a = [x for x in argv if not x.startswith("-")]
    dev = [x.split("=", 1)[1] for x in argv if x.startswith("--device=")]
    main(a[0] if a else "docs/runs/dqn_autofocus",
         int(a[1]) if len(a) > 1 else 1_500_000,
         int(a[2]) if len(a) > 2 else 128,
         device=dev[-1] if dev else "cuda",
         policy_npz=a[3] if len(a) > 3 else None)
