"""CPU rehearsal of chip_smoke.py's `scope` and `sweep` phases at cut
budgets, and of their gates. No JAX: the parity tests are
test_torch_{scope,dqn,vec_env,tools}.py.

The rehearsal evaluates the committed policy for two episodes a row
against emx's trace of the record's run and the float64 forward (the
rows against emx's runs need their 50 episodes, so that gate is checked
on the record itself), trains
the vec agent at 128 lanes for a few iterations past a lowered warm-up, runs
`dqn-autofocus` for one episode through the CLI's entry point, and
trains the classifier on 12 frames a class."""

import json

import pytest
import torch

import chip_smoke

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# 128 lanes as on the card: the vec greedy evaluation counts the first 200
# episodes to end, so fewer lanes weigh it towards longer episodes.
SCOPE_TINY = dict(n_eval=2, vec_batch=128, train_iters=3, train_warmup=256,
                  profile_iters=1, cli_episodes=1, classifier_per_class=12,
                  classifier_size=32, classifier_steps=120)


def test_scope_phase(capsys):
    out = chip_smoke.phase_scope(CPU, chip_smoke.ScopeSmokeConfig(
        **SCOPE_TINY))
    assert out["launches"] == (0, 0)
    assert out["train"]["gradient_steps"] == 2 * (3 - 256 // 128 + 1)
    assert out["eval"]["vec_greedy_eval"]["episodes"] >= 200
    assert out["cli"]["train_episodes"] == 1
    assert out["classifier_accuracy"] > 0.8
    for row, c in out["eval"]["compared"].items():
        assert c["fault"] is None, row
    assert out["eval"]["q"]["max_diff"] <= 1e-5
    assert out["eval"]["q"]["flips"] == 0 and out["eval"]["q"]["steps"] > 0
    assert out["eval"]["frames_max_diff"] == 0.0     # the CPU against itself
    text = capsys.readouterr().out
    assert "[scope] vec training: 3 iterations of 128 lanes" in text
    assert "no rate (CPU)" in text
    assert "K1/K2 launches in the phase: 0/0" in text


def test_scope_phase_fails_on_a_fault(monkeypatch):
    """A Q-network that flattens NCHW (Dense_0 reads the committed
    weights in another order, and still runs) fails the phase: its Q
    values leave the float64 forward on the DQN rows' frames."""
    from emx_torch.scope import dqn

    def forward_nchw(self, x):
        m = self._modules
        for name in self.convs:
            x = torch.relu(m[name](x))
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return m[self.head](torch.relu(m[self.hidden](x)))

    monkeypatch.setattr(dqn.QNetwork, "forward", forward_nchw)
    failures = []
    out = chip_smoke.scope_eval(CPU, chip_smoke.ScopeSmokeConfig(
        **SCOPE_TINY), failures)
    assert out["q"]["max_diff"] > 0.1 and out["q"]["flips"] > 0
    assert failures[0].startswith("Q values against the float64 forward")
    # Nor does it focus the vec env's lanes.
    assert len(failures) == 2 and failures[1].startswith(
        "vec greedy evaluation")


@pytest.mark.parametrize("nudged", [False, True])
def test_random_row_metrics_are_frame_free(monkeypatch, nudged):
    """The random row's metrics that the scope phase holds equal to the
    record (DQN_FRAME_FREE) come out equal after another policy's 50
    episodes in place of the dqn row's (the env's own draws advance by
    50 resets; its noise stream and parked focus go elsewhere), and with
    every propagated frame scaled by 1 + 2^-22."""
    import emx_torch.physics.propagate as prop
    from emx_torch.bench import dqn_run

    if nudged:
        plain = prop.propagate_back_to_defocus
        monkeypatch.setattr(prop, "propagate_back_to_defocus",
                            lambda *a, **k: plain(*a, **k)
                            * (1.0 + 2.0 ** -22))
    with open(chip_smoke.DQN_RECORD) as f:
        record = json.load(f)["results"]["random"]
    env = dqn_run.make_env(seed=123, device=CPU)
    dqn_run.run_policy(env, lambda o, rng, st: (1.0, None), 50)
    got = dqn_run.run_policy(env, dqn_run.random_policy, 50, true_z=0.0)
    for k in chip_smoke.DQN_FRAME_FREE:
        assert got[k] == record[k], k


def test_dqn_rows_against_record():
    """Each metric against the span of the record and emx's nudged runs,
    widened by DQN_ROW_TOL."""
    with open(chip_smoke.DQN_RECORD) as f:
        record = json.load(f)
    with open(chip_smoke.DQN_NUDGED) as f:
        nudged = list(json.load(f)["rows"].values())
    assert len(nudged) == 200
    rows = json.loads(json.dumps(record["results"]))
    table = chip_smoke.dqn_rows_against_record(rows, record["results"],
                                               nudged)
    assert len(table) == 36 and all(t["within"] for t in table)
    span = {(t["row"], t["metric"]): t["emx"] for t in table}
    assert span[("random", "solve_rate")] == [0.36, 0.36]
    rows["random"]["solve_rate"] = 0.36 + 0.05
    rows["hillclimb"]["mean_steps"] = \
        span[("hillclimb", "mean_steps")][0] - 0.25
    table = chip_smoke.dqn_rows_against_record(rows, record["results"],
                                               nudged)
    assert [(t["row"], t["metric"]) for t in table if not t["within"]] == \
        [("random", "solve_rate")]
    assert all(record[k] is True for k in chip_smoke.DQN_BEATS)


def test_sweep_phase(capsys):
    out = chip_smoke.phase_sweep(CPU, chip_smoke.SweepSmokeConfig(
        n_iters=2, size=32, batch=1, scale=0.02))
    assert out["launches"] == (0, 0) and out["variant"] == "base16"
    assert "(CPU: not a card rate)" in capsys.readouterr().out
