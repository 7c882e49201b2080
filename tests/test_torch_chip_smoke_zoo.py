"""CPU rehearsal of chip_smoke.py's model-zoo and style phases (`zoo`,
`style`) at cut budgets, and of their gates; a file of its own beside
test_torch_chip_smoke_gan.py. No JAX: the parity tests are
test_torch_zoo_*.py and test_torch_style.py.

At two steps a family cannot reach its anchor, so the rehearsal expects
the phase to fail on exactly the gates a cut run cannot meet (PSNR
direction, falling loss) and on no other: every numpy-only anchor equals
emx's record, no family errors, no kernel launches."""

import copy
import json
import re

import pytest
import torch

import chip_smoke

CPU = torch.device("cpu")
DIRECTION = re.compile(r"not above its const anchor|not above the "
                       r"Gaussian|not below first_")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _failures(err: AssertionError, phase: str) -> list[str]:
    msg = str(err)
    assert msg.startswith(f"{phase}: ")
    return msg[len(phase) + 2:].split("; ")


def test_zoo_phase(capsys):
    """Every family at 1 step through zoo_ladder.main, then one family
    at full width: the anchors hold, only direction gates fail."""
    cfg = chip_smoke.ZooSmokeConfig(steps=1, family_steps=(),
                                    full_width=("manifold",),
                                    full_width_steps=1)
    with pytest.raises(AssertionError) as e:
        chip_smoke.phase_zoo(CPU, cfg)
    fails = _failures(e.value, "zoo")
    assert fails and all(DIRECTION.search(f) for f in fails), fails
    out = capsys.readouterr().out
    from emx_torch.bench.zoo_ladder import FAMILIES
    for name in FAMILIES:
        assert f"[zoo] {name} (1 steps at scale 0.25, 96^2)" in out
    assert "[zoo] full width manifold: no rate (CPU)" in out
    assert "K1/K2 launches in the phase: 0/0" in out


def _passing_results(records: dict) -> dict:
    """Results that meet every gate: the records with falling losses."""
    out = copy.deepcopy(records)
    for r in out.values():
        r.pop("seconds", None)
        for first, last in chip_smoke.ZOO_LOSSES:
            if last in r:
                r[first] = r[last] + 0.1
    return out


def test_zoo_gates():
    records = chip_smoke.zoo_records()
    assert set(records) == set(__import__(
        "emx_torch.bench.zoo_ladder", fromlist=["FAMILIES"]).FAMILIES)
    ok = _passing_results(records)
    assert chip_smoke.zoo_gates(ok, records, 0.01) == []
    for name, key, value, pattern in (
            ("small_ae", "anchor_const_psnr", 15.14, "small_ae anchor"),
            ("embedder", "chance", 0.0261, "embedder chance"),
            ("manifold", "anchor_identity_psnr", 6.3001,
             "manifold anchor_identity"),
            ("latent_ae", "psnr", 15.0, "latent_ae psnr"),
            ("kernels", "best_psnr", 26.0, "kernels best"),
            ("vaegan", "final_mse", 1.0, "vaegan final_mse"),
            ("xception_ae", "final_loss", float("nan"), "xception_ae final")):
        bad = copy.deepcopy(ok)
        bad[name][key] = value
        fails = chip_smoke.zoo_gates(bad, records, 0.01)
        assert len(fails) == 1 and fails[0].startswith(pattern), fails
    bad = copy.deepcopy(ok)
    bad["manifold"] = {"error": "RuntimeError: boom"}
    assert chip_smoke.zoo_gates(bad, records, 0.01) == [
        "manifold: RuntimeError: boom"]


def test_style_phase_gates(capsys):
    """The style artifact cut to 2 steps fails the record's budget and
    both values' gates, and says so."""
    with pytest.raises(AssertionError) as e:
        chip_smoke.phase_style(CPU, chip_smoke.StyleSmokeConfig(steps=2))
    fails = _failures(e.value, "style")
    assert fails[0].startswith("the record ran 800 steps at 128")
    assert any(f.startswith("gram_gap_closed") for f in fails)
    assert "[style] content_correlation: port" in capsys.readouterr().out


def test_configs_are_the_records():
    with open(chip_smoke.STYLE_JSON) as f:
        style = json.load(f)
    cfg = chip_smoke.StyleSmokeConfig()
    assert (cfg.steps, cfg.size, cfg.style_weight) == (
        style["steps"], style["size"], style["style_weight"])
    zoo = chip_smoke.ZooSmokeConfig()
    for path in chip_smoke.ZOO_RECORDS:
        with open(path) as f:
            rec = json.load(f)
        assert (rec["scale"], rec["size"]) == (zoo.scale, zoo.size)
