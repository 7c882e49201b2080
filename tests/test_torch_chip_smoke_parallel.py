"""CPU rehearsal of chip_smoke.py's parallel phase: a gloo group of one
rank (the card's phase runs NCCL), the flagship-shaped tiny training
config, a tiny int8 bundle written by the port, and a 512x512 "big"
micrograph. On the CPU no kernel launches (the wrappers run their plain
versions) and Trainer's CUDA graph is stood in for by eager replays
(tests/test_torch_train.py::_EagerGraph). The phase's gates fail on two
faults: an exchange_halo that hands back the strips swapped, and a K2
that ignores its image offset."""

import dataclasses

import pytest
import torch

import chip_smoke
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.nn.init import init_parameters
from emx_torch.parallel import halo
from emx_torch.serve.artifact import save_denoiser_artifact
from emx_torch.serve.convert import to_flax_params
from emx_torch.serve.quantize import calibrate
from emx_torch.train import engine
from test_torch_train import _EagerGraph

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _CpuGraph(_EagerGraph):
    """The eager stand-in, counting what its replays launch on the CPU:
    no kernel."""

    def __init__(self, *args):
        super().__init__(*args)
        self.k2_per_replay = 0


@pytest.fixture
def eager_graph(monkeypatch):
    monkeypatch.setattr(engine, "StepGraph", _CpuGraph)


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    """The phase at tiny size: the flagship-shaped tiny BatchNorm model
    (bf16, s2d 4, folded head, remat), batch 4 of 64x64, graphs of 2
    steps; a tiny int8 mxu bundle (s2d 4, folded head 16, norm none,
    bf16, random weights calibrated on random images); a 512x512 big
    image and a 256x256 one for the float model, 64-pixel tiles."""
    mcfg = dataclasses.replace(DenoiserConfig.tiny(), norm="none",
                               space_to_depth=4, folded_head=16,
                               dtype=torch.bfloat16)
    model = Denoiser(mcfg, device=CPU)
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.rand((2, 64, 64), generator=torch.Generator().manual_seed(1))
    path = str(tmp_path_factory.mktemp("parallel") / "artifact_int8.npz")
    save_denoiser_artifact(path, mcfg, {"params": to_flax_params(model)[0]},
                           quant={"mode": "mxu",
                                  "amax": calibrate(model, [x])})
    return chip_smoke.ParallelSmokeConfig(
        model=dataclasses.replace(DenoiserConfig.tiny(), norm="batch",
                                  dtype=torch.bfloat16, space_to_depth=4,
                                  folded_head=16, remat_middle=True),
        n_images=8, size=64, batch=4, steps=2, k=2, pre_steps=1,
        k2_per_step=0, offsets=(1, 3), bundle=path, fused_rows=8, big=512,
        float_big=256, tile=64, overlap=16, tile_batch=4,
        min_launches_per_forward=0)


def test_parallel_phase(tiny_cfg, eager_graph, capsys):
    """Every gate holds: the one-rank mesh equals no mesh and the graph
    equals eager exactly, K2's offsets equal the whole launch's rows,
    the halo outputs meet emx's rule, the dry run passes; the group is
    left at the end."""
    import torch.distributed as dist

    res = chip_smoke.phase_parallel(CPU, tiny_cfg)
    assert not dist.is_initialized()
    assert res["train"]["mesh_diff"] == 0.0
    assert res["train"]["graph_diff"] == 0.0
    assert res["offsets"]["max_abs_err"] == 0.0
    assert res["launches"] == (0, 0)
    for name in ("int8", "float"):
        r = res["halo"][name]
        assert r["err_halo"] <= max(2 * r["err_tiled"], 5e-3)
        assert r["one_rank_diff"] <= chip_smoke.BF16_STEP
    assert res["dryrun"]["n"] == 1 and res["dryrun"]["halo_err"] < 0.1
    # The blocks at 16384 pixels or more: those at body resolution
    # (160x128 after s2d 4 of the 512x512 image and its halo rows).
    assert len(res["halo"]["k1_checks"]) >= 1
    assert all(c["ok"] for c in res["halo"]["k1_checks"])
    out = capsys.readouterr().out
    assert "backend gloo, world 1" in out and "dryrun_multichip(1)" in out


def _swapped_exchange(x, halo_rows, group, chain=None):
    """A fault: the strip for the top handed back at the bottom and the
    bottom one at the top."""
    padded = _exchange(x, halo_rows, group, chain)
    top, bot = padded[:halo_rows], padded[-halo_rows:]
    return torch.cat([bot, x, top], dim=0)


_exchange = halo.exchange_halo


def test_parallel_phase_fails_on_swapped_strips(tiny_cfg, eager_graph,
                                                monkeypatch):
    monkeypatch.setattr(halo, "exchange_halo", _swapped_exchange)
    with pytest.raises(AssertionError, match="departs from the one-rank"):
        chip_smoke.phase_parallel(CPU, tiny_cfg)


def test_parallel_phase_fails_on_an_ignored_offset(tiny_cfg, eager_graph,
                                                   monkeypatch):
    plain = chip_smoke.fused_poisson_degrade

    def ignoring(seed, imgs, scales, image_offset=0):
        return plain(seed, imgs, scales)

    monkeypatch.setattr(chip_smoke, "fused_poisson_degrade", ignoring)
    with pytest.raises(AssertionError, match="K2 at offset 1 departs"):
        chip_smoke.phase_parallel(CPU, tiny_cfg)
