"""DQN autofocus agent (port of emx/scope/dqn.py; reference keras-rl
training script em_env/fresnel_remover.py:93-118): a small CNN Q-network
over discretised z-shifts, epsilon-greedy exploration, replay buffer,
target network.

The agent's numpy generator draws what emx's draws, in the same order:
exploration in `act`/`act_batch` and the replay indices of `sample`. So
on the same weights and observations the port acts and samples as emx
does. The replay buffer lives on the agent's device; a batch is gathered
there at numpy's indices. The update is autograd plus torch's Adam, which
is optax's `adam` (eps outside the root, bias correction on both moments).

`QNetwork` is flax's module in the port's NHWC convention: a stride-2
SAME conv pads (0, 1) on an even side, and the conv features are
flattened in NHWC order before `Dense_0`, as flax's reshape does; its
children carry flax's names, so `load_policy` reads emx's weights as they
are saved (`emx/bench/dqn_vec.py` `_save_policy`).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch

from emx_torch.nn.blocks import Conv, Dense, Named
from emx_torch.nn.init import init_parameters
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.utils.device import full_float32, resolve_device


class QNetwork(Named):
    """Conv(f, 3x3, stride 2) + relu per feature, flatten, Dense(128) +
    relu, Dense(num_actions). `obs_shape` is (H, W) or (H, W, C): torch
    needs `Dense_0`'s input width, which flax infers at init."""

    def __init__(self, num_actions: int, features: tuple = (16, 32),
                 obs_shape: tuple = (48, 48, 3),
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        super().__init__()
        h, w = obs_shape[:2]
        c = obs_shape[2] if len(obs_shape) == 3 else 1
        self.convs = []
        for f in features:
            self.convs.append(self._add(Conv(c, f, 3, strides=2,
                                             dtype=dtype)))
            c, h, w = f, -(-h // 2), -(-w // 2)
        self.hidden = self._add(Dense(h * w * c, 128, dtype=dtype))
        self.head = self._add(Dense(128, num_actions, dtype=dtype))
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        m = self._modules
        for name in self.convs:
            x = torch.relu(m[name](x))
        x = x.reshape(x.shape[0], -1)       # NHWC order, as flax's reshape
        return m[self.head](torch.relu(m[self.hidden](x)))


def reference_q_values(flat: dict, obs) -> np.ndarray:
    """QNetwork's values in numpy float64, computed apart from the module
    from flax's parameters (`flat_flax_params`'s keys): each Conv a SAME
    3x3 stride-2 product of patches (padding (0, 1) on an even side,
    (1, 1) on an odd one) and relu, the NHWC flatten, Dense_0 and relu,
    Dense_1. The plain version that holds the module's values on the
    card."""
    x = np.asarray(obs, np.float64)
    i = 0
    while f"Conv_{i}/kernel" in flat:
        k = np.asarray(flat[f"Conv_{i}/kernel"], np.float64)
        n, h, w, c = x.shape
        oh, ow = -(-h // 2), -(-w // 2)
        ph, pw = 2 * oh + 1 - h, 2 * ow + 1 - w      # flax's SAME
        xp = np.pad(x, ((0, 0), (ph // 2, ph - ph // 2),
                        (pw // 2, pw - pw // 2), (0, 0)))
        patches = np.concatenate(
            [xp[:, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2]
             for dy in range(3) for dx in range(3)], axis=-1)
        x = np.maximum(patches @ k.reshape(9 * c, -1)
                       + flat[f"Conv_{i}/bias"], 0.0)
        i += 1
    x = np.maximum(x.reshape(len(x), -1) @ flat["Dense_0/kernel"]
                   + flat["Dense_0/bias"], 0.0)
    return x @ flat["Dense_1/kernel"] + flat["Dense_1/bias"]


@dataclasses.dataclass
class DQNConfig:
    num_actions: int = 7  # symmetric z-shift bins
    features: tuple = (16, 32)  # Q-network conv widths
    max_shift: float = 1.0
    gamma: float = 0.95
    learning_rate: float = 1e-3
    buffer_size: int = 10_000
    batch_size: int = 32
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 2_000
    target_update_every: int = 200
    train_every: int = 1
    warmup: int = 200
    seed: int = 0
    # Double-DQN targets (argmax by the online net, value by the target
    # net); off by default to keep the serial trainer's semantics.
    double: bool = False


class ReplayBuffer:
    """emx's ring buffer, held on `device`: float32 observations, int64
    actions, float32 rewards and dones."""

    def __init__(self, capacity: int, obs_shape,
                 device: str | torch.device = "cuda"):
        self.capacity = capacity
        self.device = resolve_device(device)
        z = dict(device=self.device)
        self.obs = torch.zeros((capacity, *obs_shape), **z)
        self.next_obs = torch.zeros((capacity, *obs_shape), **z)
        self.actions = torch.zeros(capacity, dtype=torch.int64, **z)
        self.rewards = torch.zeros(capacity, **z)
        self.dones = torch.zeros(capacity, **z)
        self.idx = 0
        self.full = False

    def _put(self, at, obs, action, reward, next_obs, done) -> None:
        for dst, v in ((self.obs, obs), (self.actions, action),
                       (self.rewards, reward), (self.next_obs, next_obs),
                       (self.dones, done)):
            dst[at] = torch.as_tensor(v, device=self.device).to(dst.dtype)

    def add(self, obs, action, reward, next_obs, done):
        i = self.idx
        self._put(i, obs, action, reward, next_obs, done)
        self.idx = (i + 1) % self.capacity
        self.full = self.full or self.idx == 0

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        n = len(actions)
        idxs = (self.idx + np.arange(n)) % self.capacity
        self._put(torch.from_numpy(idxs).to(self.device), obs, actions,
                  rewards, next_obs, dones)
        self.full = self.full or self.idx + n >= self.capacity
        self.idx = int((self.idx + n) % self.capacity)

    def __len__(self):
        return self.capacity if self.full else self.idx

    def sample(self, rng: np.random.Generator, n: int):
        idxs = torch.from_numpy(rng.integers(0, len(self), n)).to(
            self.device)
        return (self.obs[idxs], self.actions[idxs], self.rewards[idxs],
                self.next_obs[idxs], self.dones[idxs])


def q_loss(net: torch.nn.Module, target_net: torch.nn.Module, batch,
           gamma: float, double: bool) -> torch.Tensor:
    """Mean squared TD error of `net` on a replay batch; the target (plain
    or Double-DQN) carries no gradient (emx/scope/dqn.py:121-133)."""
    obs, actions, rewards, next_obs, dones = batch
    q_sel = net(obs).gather(1, actions[:, None].long())[:, 0]
    with torch.no_grad():
        q_tgt = target_net(next_obs)
        if double:
            sel = net(next_obs).argmax(1)
            q_next = q_tgt.gather(1, sel[:, None])[:, 0]
        else:
            q_next = q_tgt.max(1).values
        target = rewards + gamma * (1.0 - dones) * q_next
    return torch.mean((q_sel - target) ** 2)


class DQNAgent:
    """emx's agent on `device`. The Q-network starts from flax's default
    distributions (`emx_torch.nn.init`) at `cfg.seed`, not from flax's
    numbers; `load_policy` carries trained weights in."""

    def __init__(self, obs_shape, cfg: DQNConfig = DQNConfig(),
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = QNetwork(cfg.num_actions, tuple(cfg.features),
                            tuple(obs_shape), dtype, self.device)
        init_parameters(self.net, torch.Generator().manual_seed(cfg.seed))
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.opt = torch.optim.Adam(self.net.parameters(),
                                    lr=cfg.learning_rate)
        self.buffer = ReplayBuffer(cfg.buffer_size, obs_shape, self.device)
        self.rng = np.random.default_rng(cfg.seed)
        self.step_count = 0
        self.train_count = 0  # gradient steps (batched path's clock)
        # Discrete action -> z shift.
        self.shifts = np.linspace(-cfg.max_shift, cfg.max_shift,
                                  cfg.num_actions)

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.step_count / c.eps_decay_steps)
        return c.eps_start + frac * (c.eps_end - c.eps_start)

    @torch.no_grad()
    def q_values(self, obs) -> torch.Tensor:
        """The online net's Q values in full float32, as emx computes them
        on a CPU: every greedy action (acting, evaluating) reads them, and
        TF32's rounding, cuDNN's default, flips an argmax at a near-tie."""
        with full_float32():
            return self.net(torch.as_tensor(obs, device=self.device))

    def act(self, obs: np.ndarray, greedy: bool = False) -> int:
        if not greedy and self.rng.random() < self.epsilon():
            return int(self.rng.integers(self.cfg.num_actions))
        return int(self.q_values(np.asarray(obs)[None])[0].argmax())

    def act_batch(self, obs, greedy: bool = False) -> np.ndarray:
        """Epsilon-greedy actions for a batch of observations (one Q
        evaluation for all B lanes: the VecFresnelEnv path)."""
        a = self.q_values(obs).argmax(1).cpu().numpy().astype(np.int32)
        if not greedy:
            explore = self.rng.random(len(a)) < self.epsilon()
            a = np.where(explore,
                         self.rng.integers(0, self.cfg.num_actions, len(a)),
                         a).astype(np.int32)
        return a

    def train_step(self, batch) -> torch.Tensor:
        """One Adam step on a replay batch; the loss before the step."""
        loss = q_loss(self.net, self.target_net, batch, self.cfg.gamma,
                      self.cfg.double)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def update_target(self) -> None:
        self.target_net.load_state_dict(self.net.state_dict())

    def observe_batch(self, obs, actions, rewards, next_obs, dones,
                      train_steps: int = 1) -> float | None:
        """Store B transitions, advance the step count by B, and run
        `train_steps` gradient steps (each on a fresh replay sample)."""
        c = self.cfg
        self.buffer.add_batch(obs, actions, rewards, next_obs, dones)
        self.step_count += len(actions)
        loss = None
        if len(self.buffer) >= c.warmup:
            for _ in range(train_steps):
                loss_t = self.train_step(
                    self.buffer.sample(self.rng, c.batch_size))
                # Batched path clocks the target net in gradient steps
                # (env steps arrive B at a time, too coarse a unit).
                self.train_count += 1
                if self.train_count % c.target_update_every == 0:
                    self.update_target()
            loss = float(loss_t)
        return loss

    def observe(self, obs, action, reward, next_obs, done) -> float | None:
        c = self.cfg
        self.buffer.add(obs, action, reward, next_obs, done)
        self.step_count += 1
        loss = None
        if len(self.buffer) >= c.warmup and self.step_count % c.train_every == 0:
            loss = float(self.train_step(
                self.buffer.sample(self.rng, c.batch_size)))
        if self.step_count % c.target_update_every == 0:
            self.update_target()
        return loss

    def action_to_shift(self, action: int) -> float:
        return float(self.shifts[action])


def train_autofocus(env, agent: DQNAgent, episodes: int = 20) -> list[float]:
    """Run the training loop (reference fresnel_remover.py:93-106 shape).
    Returns per-episode total rewards."""
    returns = []
    for _ in range(episodes):
        obs = env.reset()
        total = 0.0
        done = False
        while not done:
            action = agent.act(obs)
            next_obs, reward, done, _ = env.step([agent.action_to_shift(action)])
            agent.observe(obs, action, reward, next_obs, done)
            obs = next_obs
            total += reward
        returns.append(total)
    return returns


def flat_flax_params(source) -> dict[str, np.ndarray]:
    """`{"Conv_0/kernel": array}` from a flax parameter tree (with or
    without its "params" level), from emx's flat policy keys
    (`"['params']/['Conv_0']/['kernel']"`), or from such a flat dict
    already."""
    if isinstance(source, (str, os.PathLike)):
        with np.load(source) as z:
            source = dict(z)
    flat: dict[str, np.ndarray] = {}

    def walk(prefix: tuple, node) -> None:
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(prefix + tuple(str(k).split("/")), v)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk((), source)
    out = {}
    for key, v in flat.items():
        parts = [p[2:-2] if p.startswith("['") and p.endswith("']") else p
                 for p in key.split("/")]
        if parts[0] == "params":
            parts = parts[1:]
        out["/".join(parts)] = v
    return out


def load_policy(agent: DQNAgent, path_or_flat) -> DQNAgent:
    """Carry a trained Q-network into `agent.net` (the online net, as
    emx's `dqn_vec.main(policy_npz=...)` loads it): an npz path or dict of
    emx's flat keys, or a flax tree as numpy. Returns `agent`."""
    load_flax_params(agent.net, flat_flax_params(path_or_flat))
    return agent


def policy_arrays(agent: DQNAgent) -> dict[str, np.ndarray]:
    """The online net's parameters under emx's flat policy keys
    (`"['params']/['Conv_0']/['kernel']"`, flax's HWIO kernels), which
    emx's `dqn_vec.main(policy_npz=...)` loads."""
    return {"/".join(f"['{p}']" for p in ("params", *k.split("/"))): v
            for k, v in to_flax_params(agent.net)[0].items()}
