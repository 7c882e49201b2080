"""The port's DQN (emx_torch/scope/dqn.py, emx_torch/bench/dqn_{run,vec}.py)
against emx's on the CPU: the Q-network on the committed policy, the
train step (plain and Double-DQN), the agent's numpy draws, the replay
buffer, the serial evaluation's first episodes, and policies carried
both ways.

emx's agents here are built with QNetwork.init answered from the
committed policy (an eager flax init costs seconds), so the jitted
closures of emx/scope/dqn.py are emx's own.

Tolerances: Q values within 1e-5 of flax's (float32) on the same frames,
equal argmax; the
train step in float64 (emx under jax.enable_x64) within 1e-9 in the
loss and the parameters after Adam; everything else equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import emx.bench.dqn_run as emx_dqn_run
import emx.scope.dqn as emx_dqn
from emx_torch.bench import dqn_run, dqn_vec
from emx_torch.scope import dqn

CPU = torch.device("cpu")
POLICY = "docs/runs/dqn_autofocus_v2/policy.npz"
TRACE = "docs/runs/port_dqn_eval/emx_trace.json"
OBS = (48, 48, 3)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def policy():
    with np.load(POLICY) as z:
        return dict(z)


def _tree(flat: dict, dtype=jnp.float32) -> dict:
    """emx's flat policy keys -> flax's nested tree."""
    return unflatten_dict({tuple(p[2:-2] for p in k.split("/")):
                           jnp.asarray(v, dtype) for k, v in flat.items()})


def emx_agent(monkeypatch, flat: dict, cfg, dtype=jnp.float32):
    """emx's DQNAgent whose init returns `flat`'s tree."""
    monkeypatch.setattr(emx_dqn.QNetwork, "init",
                        lambda self, key, x: _tree(flat, dtype))
    return emx_dqn.DQNAgent(OBS, cfg)


def port_agent(flat: dict, cfg, dtype=torch.float32):
    return dqn.load_policy(dqn.DQNAgent(OBS, cfg, device=CPU, dtype=dtype),
                           flat)


CFG = dict(num_actions=7, features=(32, 64), buffer_size=64, batch_size=8,
           seed=3)


@pytest.fixture(scope="module")
def observations():
    """Stacked frames of the serial eval env (make_env(seed=123)): a
    reset and five steps."""
    env = dqn_run.make_env(seed=123, device=CPU)
    obs = [env.reset()]
    for shift in (1.0, -0.5, 0.25, 1.0, -1.0):
        obs.append(env.step([shift])[0])
    return np.stack(obs)


def test_qnetwork_on_the_committed_policy(policy, observations):
    net = emx_dqn.QNetwork(7, (32, 64))
    ref = np.asarray(jax.jit(net.apply)(_tree(policy), observations))
    port = port_agent(policy, dqn.DQNConfig(**CFG))
    got = port.q_values(observations).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
    # Dense_0 reads the conv features in NHWC order: 12 x 12 x 64.
    assert port.net.Dense_0.kernel.shape == (9216, 128)


@pytest.mark.parametrize("double", [False, True])
def test_train_step_matches_emx_in_float64(monkeypatch, policy, double):
    """One step on the same replay batch: the online net from the policy,
    the target net from a perturbed copy; loss and Adam's update."""
    rng = np.random.default_rng(1)
    target = {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in policy.items()}
    b = 8
    batch = (rng.random((b, *OBS)).astype(np.float32),
             rng.integers(0, 7, b).astype(np.int32),
             rng.standard_normal(b).astype(np.float32),
             rng.random((b, *OBS)).astype(np.float32),
             (rng.random(b) < 0.3).astype(np.float32))
    cfg = dqn.DQNConfig(**CFG, double=double)
    with jax.enable_x64():
        ref_agent = emx_agent(monkeypatch, policy,
                              emx_dqn.DQNConfig(**CFG, double=double),
                              jnp.float64)
        p64, t64 = _tree(policy, jnp.float64), _tree(target, jnp.float64)
        new, _, loss = ref_agent._train_step(
            p64, t64, ref_agent.opt.init(p64),
            tuple(jnp.asarray(x) for x in batch))
        new = {"/".join(f"['{q.key}']" for q in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(new)[0]}
    agent = port_agent(policy, cfg, torch.float64)
    agent.target_net.load_state_dict(
        dqn.load_policy(dqn.DQNAgent(OBS, cfg, CPU, torch.float64),
                        target).net.state_dict())
    got = agent.train_step(tuple(torch.from_numpy(x) for x in batch))
    assert abs(float(got) - float(loss)) < 1e-9
    mine = {k: v for k, v in _policy64(agent).items()}
    for k, v in new.items():
        np.testing.assert_allclose(mine[k], v, rtol=0, atol=1e-9,
                                   err_msg=k)


def _policy64(agent) -> dict:
    """The online net under emx's flat keys, float64, flax's layouts."""
    out = {}
    for name, mod in agent.net.named_children():
        w = (mod.weight.detach().numpy().transpose(2, 3, 1, 0)
             if hasattr(mod, "weight") else mod.kernel.detach().numpy())
        out[f"['params']/['{name}']/['kernel']"] = w
        out[f"['params']/['{name}']/['bias']"] = mod.bias.detach().numpy()
    return out


def test_act_batch_and_act_draw_emx_numbers(monkeypatch, policy,
                                            observations):
    """Exploration and greedy actions equal emx's over many calls at
    epsilon ~0.5: the same numpy generator, drawn in the same order."""
    ref = emx_agent(monkeypatch, policy, emx_dqn.DQNConfig(**CFG))
    port = port_agent(policy, dqn.DQNConfig(**CFG))
    for a in (ref, port):
        a.step_count = 1000
    for _ in range(5):
        np.testing.assert_array_equal(port.act_batch(observations),
                                      ref.act_batch(observations))
        assert [port.act(o) for o in observations] == \
            [ref.act(o) for o in observations]
    np.testing.assert_array_equal(
        port.act_batch(observations, greedy=True),
        ref.act_batch(observations, greedy=True))
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def test_replay_buffer_wraps_and_samples_as_emx():
    rng = np.random.default_rng(0)
    ref = emx_dqn.ReplayBuffer(10, (4, 4, 3))
    port = dqn.ReplayBuffer(10, (4, 4, 3), device=CPU)
    for n in (4, 4, 4, 7, 1):
        tr = (rng.random((n, 4, 4, 3)).astype(np.float32),
              rng.integers(0, 7, n).astype(np.int32),
              rng.standard_normal(n).astype(np.float32),
              rng.random((n, 4, 4, 3)).astype(np.float32),
              rng.random(n) < 0.5)
        ref.add_batch(*tr)
        port.add_batch(*tr)
        assert (port.idx, port.full, len(port)) == \
            (ref.idx, ref.full, len(ref))
    port.add(*(x[0] for x in tr))
    ref.add(*(x[0] for x in tr))
    assert (port.idx, port.full) == (ref.idx, ref.full)
    for name in ("obs", "actions", "rewards", "next_obs", "dones"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      getattr(ref, name), err_msg=name)
    got = port.sample(np.random.default_rng(5), 6)
    want = ref.sample(np.random.default_rng(5), 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_observe_batch_trains_and_clocks_the_target(policy):
    """Warm-up, gradient steps per call, target copies every
    `target_update_every` gradient steps."""
    cfg = dqn.DQNConfig(**{**CFG, "buffer_size": 32}, warmup=12,
                        target_update_every=3)
    agent = port_agent(policy, cfg)
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(4):
        obs = rng.random((6, *OBS)).astype(np.float32)
        losses.append(agent.observe_batch(
            obs, agent.act_batch(obs), rng.standard_normal(6), obs,
            np.zeros(6, bool), train_steps=2))
    assert losses[0] is None and all(np.isfinite(losses[1:]))
    assert agent.step_count == 24 and agent.train_count == 6
    for p, q in zip(agent.net.parameters(), agent.target_net.parameters()):
        torch.testing.assert_close(p, q)


def test_first_true_target_episodes_equal_emx(policy):
    """The dqn_true_target row's first three episodes (make_env(seed=321),
    target at the true optimum, the committed policy), port against emx,
    episode by episode, and to emx's record of the row: target, start and
    every step's shift (the greedy action), reward and distance equal.
    The frames are not the same bits (Poisson counts move with the FFT's
    last bits, and the stream can fall out of step for a while), so their
    Q values are not compared here: test_qnetwork_on_the_committed_policy
    holds Q on the same frames."""
    net = jax.jit(emx_dqn.QNetwork(7, (32, 64)).apply)
    tree = _tree(policy)
    port = port_agent(policy, dqn.DQNConfig(**CFG))
    traces = {}
    for name, env, q in (
            ("emx", emx_dqn_run.make_env(seed=321),
             lambda o: np.asarray(net(tree, o))),
            ("port", dqn_run.make_env(seed=321, device=CPU),
             port.q_values)):
        traced = dqn_vec.TracedEnv(env)

        def policy_fn(o, rng, st, q=q, traced=traced):
            v = np.asarray(q(o[None]), np.float32)[0]
            traced.episodes[-1]["q"].append(v.tolist())
            return float(port.shifts[int(np.argmax(v))]), None

        for _ in range(3):
            dqn_run.run_policy(traced, policy_fn, 1, true_z=0.0,
                               target_override=0.0)
        traces[name] = traced.episodes
    with open(TRACE) as f:
        record = json.load(f)["dqn_true_target"][:3]
    for ep, (a, b, r) in enumerate(zip(traces["port"], traces["emx"],
                                       record)):
        for k in ("target", "start", "shift", "reward", "distance"):
            assert a[k] == b[k] == r[k], (ep, k)


def test_a_port_policy_loads_in_emx_dqn_vec(monkeypatch, tmp_path, policy):
    """dqn_vec._save_policy's file, read by emx's dqn_vec.main(policy_npz=)
    (its training and evaluation stubbed): the same parameters, and emx's
    greedy action equal to the port's."""
    import emx.bench.dqn_vec as emx_dqn_vec
    import emx.scope.vec_env as emx_vec

    agent = dqn.DQNAgent(OBS, dqn.DQNConfig(**CFG), device=CPU)  # fresh init
    dqn_vec._save_policy(agent, str(tmp_path))
    seen = {}

    class Vec:
        def __init__(self, cfg):
            self.b = cfg.batch

        def reset(self, seed=0):
            return None, np.zeros((self.b, *OBS), np.float32)

        def step(self, state, shift):
            z = np.zeros(self.b, np.float32)
            return (state, np.zeros((self.b, *OBS), np.float32), z,
                    np.ones(self.b, bool), {"distance": z, "solved": z > 0})

    obs = np.random.default_rng(4).random(OBS).astype(np.float32)

    def run_policy(env, pol, n, seed=0, true_z=None, target_override=None):
        if "agent" not in seen:             # the first row is the DQN's
            seen["shift"] = pol(obs, None, None)[0]
            seen["agent"] = pol.__closure__[0].cell_contents
        row = dict(mean_return=0.0, mean_final_distance=0.0, mean_steps=1.0,
                   solve_rate=0.0, mean_final_true_distance=0.0,
                   true_solve_rate=0.0)
        return row

    monkeypatch.setattr(emx_vec, "VecFresnelEnv", Vec)
    monkeypatch.setattr(emx_dqn_run, "run_policy", run_policy)
    monkeypatch.setattr(emx_dqn_run, "make_env", lambda seed=0: None)
    monkeypatch.setattr(emx_dqn.QNetwork, "init",
                        lambda self, key, x: _tree(policy))  # any tree
    emx_dqn_vec.main(str(tmp_path / "emx"), 256, 128,
                     policy_npz=str(tmp_path / "policy.npz"))
    params = {"/".join(f"['{q.key}']" for q in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  seen["agent"].params)[0]}
    saved = dqn.policy_arrays(agent)
    assert set(params) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(params[k], v)
    assert seen["shift"] == agent.action_to_shift(agent.act(obs,
                                                            greedy=True))
    # And back: emx's layout into a fresh port agent.
    back = dqn.load_policy(dqn.DQNAgent(OBS, dqn.DQNConfig(**CFG),
                                        device=CPU), params)
    torch.testing.assert_close(back.q_values(obs[None]),
                               agent.q_values(obs[None]))


def _episode(target, shifts, q=None):
    n = len(shifts)
    return {"scan": [f"s{target}"], "target": target, "start": target + 1.0,
            "shift": shifts, "reward": [1.0] * n, "distance": [0.5] * n,
            "frame": [f"f{target}.{i}" for i in range(n)], "q": q or []}


def _trace():
    q = [[0.0, 1.0, 1.00001], [0.0, 2.0, 1.0]]
    return {"dqn": [_episode(0.1, [1.0, 0.0], q), _episode(0.2, [1.0],
                                                           q[1:])],
            "random": [_episode(0.3, [0.5])],
            "hillclimb": [_episode(0.4, [1.0, -0.5])],
            "dqn_true_target": [_episode(0.1, [1.0, 0.0], q)],
            "random_true_target": [_episode(0.3, [0.5])],
            "hillclimb_true_target": [_episode(0.4, [1.0, -0.5])]}


def test_compare_traces_names_each_cause():
    """Held while the frames agree: what differs there is a fault, what
    differs after the frames parted is not compared."""
    ref = _trace()
    out = dqn_vec.compare_traces(_trace(), ref)
    assert all(r["fault"] is None and r["parted"] is None
               and r["first_episode"] is None for r in out.values())
    assert out["dqn"]["compared_steps"] == 3
    assert out["dqn"]["compared_q_steps"] == 3
    # The dqn row's scan parts: nothing more of its env is compared, so
    # the rows after it may differ; the other env is held still.
    port = _trace()
    port["dqn"][0]["scan"] = ["other"]
    port["dqn"][0]["target"] = port["random"][0]["target"] = 0.9
    port["dqn_true_target"][0]["start"] = 0.0
    out = dqn_vec.compare_traces(port, ref)
    assert out["dqn"]["parted"] == {"row": "dqn", "episode": 0,
                                    "step": None, "cause": "scan"}
    assert out["random"]["parted"] == out["dqn"]["parted"]
    assert out["dqn"]["fault"] is out["random"]["fault"] is None
    assert out["random"]["first_episode"] == 0
    assert out["dqn_true_target"]["fault"]["episode"] == 0
    assert "target/start" in out["dqn_true_target"]["fault"]["why"]
    # A near-tie (the reference's gap 1e-5, Q equal) ends the comparison;
    # an action off a clear maximum on the same frames is a fault, as are
    # Q values apart and a random shift that differs.
    port = _trace()
    port["dqn"][0]["shift"] = [0.0, 0.0]
    port["dqn_true_target"][0]["shift"] = [1.0, 1.0]
    port["random_true_target"][0]["shift"] = [-0.5]
    out = dqn_vec.compare_traces(port, ref)
    assert out["dqn"]["parted"]["cause"] == "near-tie"
    assert out["dqn"]["fault"] is None
    assert out["dqn_true_target"]["fault"] == {
        "step": 1, "why": "shift 1.0 against 0.0 on the same frames",
        "episode": 0}
    port = _trace()
    port["dqn_true_target"][0]["q"][0][1] += 2e-5
    port["random"][0]["shift"] = [-0.5]
    out = dqn_vec.compare_traces(port, ref)
    assert "Q values 2e-05 apart" in out["dqn_true_target"]["fault"]["why"]
    assert out["random"]["fault"]["why"].startswith("shift -0.5")
    # A step's frame parts: the steps after it are not held.
    port = _trace()
    port["hillclimb_true_target"][0]["frame"][0] = "other"
    port["hillclimb_true_target"][0]["shift"][1] = 0.5
    port["dqn_true_target"][0]["distance"][1] = 0.25
    port["dqn"][1:] = []
    out = dqn_vec.compare_traces(port, ref)
    assert out["dqn_true_target"]["fault"]["why"] == \
        "reward/distance differ on the same shifts"
    assert out["dqn"]["fault"]["why"] == "1 episodes against 2"
    # A fault is its row's: the rows after it are still held.
    assert out["hillclimb_true_target"]["parted"] == {
        "row": "hillclimb_true_target", "episode": 0, "step": 1,
        "cause": "observation"}
    assert out["hillclimb_true_target"]["fault"] is None


def test_a_wrong_qnetwork_on_emx_frames_is_a_fault(policy):
    """emx's own environment (its frames, so the digests agree with its
    trace) driven by a Q-network that flattens NCHW (Dense_0's rows
    permuted): compare_traces finds Q values apart on the same frames in
    both DQN rows at their first step; the right network is held there."""
    perm = np.arange(9216).reshape(64, 12, 12).transpose(1, 2, 0).ravel()
    wrong = dict(policy)
    key = "['params']/['Dense_0']/['kernel']"
    wrong[key] = policy[key][perm]
    apply, tree = jax.jit(emx_dqn.QNetwork(7, (32, 64)).apply), _tree(wrong)
    trace = {}
    dqn_vec.serial_eval(lambda o: np.asarray(apply(tree, o)),
                        np.linspace(-1.0, 1.0, 7), 1,
                        make_env=lambda seed: emx_dqn_run.make_env(seed=seed),
                        trace=trace)
    with open(TRACE) as f:
        ref = {k: v[:1] for k, v in json.load(f).items()}
    out = dqn_vec.compare_traces(trace, ref)
    for row in ("dqn", "dqn_true_target"):
        assert out[row]["fault"]["episode"] == 0, row
        assert out[row]["fault"]["step"] == 0, row
        assert "apart on the same frames" in out[row]["fault"]["why"], row
    # The right network on the same frames: every step held.
    apply_ok, tree_ok = apply, _tree(policy)
    trace = {}
    dqn_vec.serial_eval(lambda o: np.asarray(apply_ok(tree_ok, o)),
                        np.linspace(-1.0, 1.0, 7), 1,
                        make_env=lambda seed: emx_dqn_run.make_env(seed=seed),
                        trace=trace)
    out = dqn_vec.compare_traces(trace, ref)
    for row in ("dqn", "dqn_true_target"):
        assert out[row]["fault"] is out[row]["parted"] is None, row
        assert out[row]["compared_q_steps"] == len(ref[row][0]["shift"])
    # A row of one episode leaves the env elsewhere than the record's
    # 50 did: the next row's scan sees other frames, which is not held.
    for row in ("random", "hillclimb", "random_true_target",
                "hillclimb_true_target"):
        assert out[row]["fault"] is None, row
        assert out[row]["parted"]["cause"] == "scan", row


@pytest.mark.parametrize("size", [48, 13])
def test_reference_q_values_equal_flax(policy, observations, size):
    """dqn.reference_q_values (numpy float64, the plain version chip_smoke
    holds the card's Q values to) against flax's QNetwork: the committed
    policy on the eval env's frames, and random weights on an odd side
    (SAME pads (1, 1) there)."""
    if size == 48:
        flat, obs, feats = policy, observations, (32, 64)
    else:
        rng = np.random.default_rng(size)
        obs = rng.random((4, size, size, 3)).astype(np.float32)
        feats = (4, 8)
        shapes = jax.eval_shape(emx_dqn.QNetwork(7, feats).init,
                                jax.random.PRNGKey(0), obs)
        flat = {"/".join(f"['{q.key}']" for q in path):
                rng.standard_normal(v.shape).astype(np.float32) * 0.3
                for path, v in jax.tree_util.tree_flatten_with_path(
                    shapes)[0]}
    want = np.asarray(jax.jit(emx_dqn.QNetwork(7, feats).apply)(
        _tree(flat), obs))
    got = dqn.reference_q_values(dqn.flat_flax_params(flat), obs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
