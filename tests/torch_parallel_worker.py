"""One gloo rank of the port's multi-rank tests, on the CPU (run by
tests/test_torch_parallel.py and tests/test_torch_chip_smoke_parallel.py,
one process per rank):

    python tests/torch_parallel_worker.py <world> <rank> <dir> <scenario>,...

Joins a gloo group of <world> ranks over a file store in <dir>, reads the
inputs that the parent wrote to <dir>/inputs.npz (images, batches, and
emx's weights as flat "params/..." keys), runs each scenario and saves
what it returns to <dir>/<scenario>_<rank>.pt. Imports torch and the
port only, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

CPU = "cpu"
# The Denoiser of emx's dry run and of tests/test_distributed_mp.py.
DRYRUN_CFG = dict(features=(8, 12, 16, 24, 24), num_middle_blocks=1,
                  aspp_filters=16, aspp_out=16, norm="group")
# emx's tests/test_parallel_ops.py model for halo_denoise.
HALO_CFG = dict(features=(8, 8, 8, 8, 8), num_middle_blocks=0,
                aspp_filters=8, aspp_out=8, norm="group", space_to_depth=2)
SHIFT = 3          # rows the "shift" cases move (under a halo of 4)


def flat_weights(inputs: dict, prefix: str) -> tuple[dict, dict]:
    """emx's flat params and batch_stats stored under `prefix`."""
    params = {k.split("/", 2)[2]: v for k, v in inputs.items()
              if k.startswith(f"{prefix}/params/")}
    stats = {k.split("/", 2)[2]: v for k, v in inputs.items()
             if k.startswith(f"{prefix}/batch_stats/")}
    return params, stats


def denoiser(inputs: dict, prefix: str, **cfg):
    from emx_torch.nn import Denoiser, DenoiserConfig
    from emx_torch.serve.convert import load_flax_params

    model = Denoiser(DenoiserConfig(**cfg), device=CPU)
    return load_flax_params(model, *flat_weights(inputs, prefix))


def state_arrays(model) -> dict:
    """Parameters and buffers by flax name, as numpy."""
    from emx_torch.serve.convert import to_flax_params

    params, stats = to_flax_params(model)
    return {**{f"params/{k}": v for k, v in params.items()},
            **{f"batch_stats/{k}": v for k, v in stats.items()}}


def _slices(index, shape) -> list:
    return [s.indices(n)[:2] for s, n in zip(index, shape)]


def sc_mesh(inputs: dict) -> dict:
    """Shapes, coordinates, shard slices and errors of the mesh builders."""
    from emx_torch.parallel import (batch_sharding, make_mesh,
                                    make_mesh_for_batch)
    from emx_torch.parallel.distributed import host_batch_slice, make_pod_mesh

    flat = make_mesh()
    grid = make_mesh(data=2, spatial=2)
    trimmed = make_mesh_for_batch(6)
    pod = make_pod_mesh(dcn_data=2)
    out = {
        "flat": (flat.shape, flat.coords,
                 _slices(batch_sharding(flat).index((8, 5)), (8, 5))),
        "grid": (grid.shape, grid.coords,
                 _slices(batch_sharding(grid, spatial_dims=1).index(
                     (4, 8, 3)), (4, 8, 3))),
        "trimmed": (trimmed.shape, trimmed.coords, trimmed.devices.tolist(),
                    _slices(batch_sharding(trimmed).index((6, 2)), (6, 2))
                    if trimmed.coords else None),
        "pod": (pod.shape, pod.coords,
                _slices(batch_sharding(pod).index((8, 5)), (8, 5))),
        "host_batch_slice": host_batch_slice(8),
        "as_global": as_global_rows(inputs["clean"], flat),
    }
    for name, call in (("err_mesh", lambda: make_mesh(data=3)),
                       ("err_pod", lambda: make_pod_mesh(dcn_data=3))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def as_global_rows(global_batch, mesh):
    """DataPipeline.as_global of this rank's rows of `global_batch`."""
    from emx_torch.data.pipeline import DataPipeline, PipelineConfig
    from emx_torch.parallel import batch_sharding

    sharding = batch_sharding(mesh)
    pipe = DataPipeline(global_batch, PipelineConfig(
        batch_size=2, crop_size=global_batch.shape[-1]))
    local = global_batch[sharding.index(global_batch.shape)]
    return pipe.as_global(local, sharding).numpy()


def spatial_cases(inputs: dict) -> dict:
    """(image, apply_fn, halo, grid) of each spatial_apply case."""
    kernel = torch.from_numpy(inputs["kernel5"])

    def conv(x):
        return torch.nn.functional.conv2d(x[None, None], kernel[None, None],
                                          padding=2)[0, 0]

    img = inputs["img256"]
    return {
        "identity256": (img, lambda x: x, 4, 4),
        "identity250": (inputs["img250"], lambda x: x, 4, 4),
        "halo5_grid8": (img, lambda x: x, 5, 8),
        "conv5": (img, conv, 4, 1),
        "shift_down": (img, lambda x: torch.roll(x, SHIFT, 0), 4, 1),
        "shift_up": (img, lambda x: torch.roll(x, -SHIFT, 0), 4, 1),
        "oversized": (inputs["img32"], lambda x: x, 8, 1),
    }


def sc_spatial(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh
    from emx_torch.parallel.halo import spatial_apply

    mesh = make_mesh(data=1, spatial=dist.get_world_size())
    out = {}
    for name, (img, fn, halo, grid) in spatial_cases(inputs).items():
        try:
            out[name] = spatial_apply(fn, img, mesh, halo=halo,
                                      grid=grid).numpy()
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


def sc_halo_denoise(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh
    from emx_torch.parallel.halo import halo_denoise

    model = denoiser(inputs, "halo", **HALO_CFG, dtype=torch.float64)
    mesh = make_mesh(data=1, spatial=dist.get_world_size())
    return {"out": halo_denoise(model, inputs["img1024"], mesh).numpy()}


def train_config(**kw):
    from emx_torch.train import TrainConfig

    return TrainConfig(**{**dict(learning_rate=1e-3, optimizer="adam",
                                 grad_accum=2, log_every=0), **kw})


def train_steps(mesh, example: bool, steps: int, inputs: dict,
                grad_accum: int = 2) -> dict:
    """`steps` steps of the dry run's Denoiser from emx's weights, with
    the forward and backward in float64 (float32 parameters): on the
    global clean batch through denoiser_example, or on the (x, t)
    pair."""
    from emx_torch.data.degrade import denoiser_example
    from emx_torch.train import Trainer, TrainState, make_optimizer

    model = denoiser(inputs, "train", **DRYRUN_CFG, dtype=torch.float64)
    cfg = train_config(grad_accum=grad_accum)
    trainer = Trainer(model, cfg, mesh=mesh,
                      example_fn=denoiser_example if example else None)
    state = TrainState(0, model, make_optimizer(cfg, model.parameters()))
    trainer.replicate(state)
    batch = inputs["clean"] if example else (
        torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]))
    losses = []
    for _ in range(steps):
        state, m = trainer.step_fn(state, batch)
        losses.append({k: float(v) for k, v in m.items()})
    return {"metrics": losses, "state": state_arrays(model)}


def sc_train(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh

    return train_steps(make_mesh(), True, 2, inputs)


def sc_train_pairs(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh

    return {acc: train_steps(make_mesh(), False, 1, inputs, acc)
            for acc in (1, 2)}


def sc_train_pod(inputs: dict) -> dict:
    from emx_torch.parallel.distributed import make_pod_mesh

    return train_steps(make_pod_mesh(dcn_data=2), True, 2, inputs)


def bn_run(mesh, inputs: dict, grad_accum: int, steps: int = 2) -> dict:
    """Two nesterov steps of the tiny BatchNorm Denoiser on the (x, t)
    pair, computing in float64."""
    from emx_torch.nn import DenoiserConfig
    from emx_torch.train import Trainer, TrainState, make_optimizer

    model = denoiser(inputs, "bn", **{
        **vars(DenoiserConfig.tiny()), "norm": "batch",
        "dtype": torch.float64})
    cfg = train_config(learning_rate=1e-2, optimizer="nesterov",
                       grad_accum=grad_accum)
    trainer = Trainer(model, cfg, mesh=mesh)
    state = TrainState(0, model, make_optimizer(cfg, model.parameters()))
    batch = (torch.from_numpy(inputs["bn_x"]), torch.from_numpy(inputs["bn_t"]))
    metrics = []
    for _ in range(steps):
        state, m = trainer.step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": state_arrays(model)}


def sc_bn(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh

    return {acc: bn_run(make_mesh(), inputs, acc) for acc in (1, 2)}


def fit_run(mesh, inputs: dict, model_dir: str, steps: int = 4) -> dict:
    """Trainer.fit of the dry run's Denoiser (float64 compute, adam,
    K2's plain version) for `steps` steps on a DataPipeline of the clean
    images, logging every step, a checkpoint every 2 steps, and a
    learning_rate.txt that halves the rate after the first step; then a
    fresh state restored from the last checkpoint."""
    from emx_torch.data.degrade import denoiser_example
    from emx_torch.data.pipeline import DataPipeline, PipelineConfig
    from emx_torch.train import Checkpointer, Trainer, TrainState
    from emx_torch.train import make_optimizer

    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "learning_rate.txt"), "w") as f:
        f.write("5e-4\n")
    model = denoiser(inputs, "train", **DRYRUN_CFG, dtype=torch.float64)
    cfg = train_config(grad_accum=1, log_every=1, ckpt_every_steps=2,
                       model_dir=model_dir)
    trainer = Trainer(model, cfg, mesh=mesh, example_fn=denoiser_example)
    state = TrainState(0, model, make_optimizer(cfg, model.parameters()))
    pipe = DataPipeline(inputs["clean"], PipelineConfig(batch_size=4,
                                                        crop_size=32))
    ckpt = Checkpointer(os.path.join(model_dir, "ckpt"))
    trainer.fit(state, pipe, steps, checkpointer=ckpt)
    live = state_arrays(model)
    fresh = denoiser(inputs, "train", **DRYRUN_CFG, dtype=torch.float64)
    restored, cursor = ckpt.restore(TrainState(0, fresh, make_optimizer(
        cfg, fresh.parameters())))
    return {"state": live, "restored": state_arrays(fresh),
            "step": restored.step, "cursor": cursor,
            "lr": [g["lr"] for g in state.optimizer.param_groups]}


def sc_fit(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh

    store = os.path.dirname(inputs["__path__"])
    return fit_run(make_mesh(), inputs, os.path.join(store, "fit"))


def gan_run(mesh, inputs: dict, steps: int = 4) -> dict:
    """`steps` steps of GANTrainer.fit on the tiny nets (float64) at
    32x32 with partial scans; each step's trainee decision and
    metrics."""
    from emx_torch.data.degrade import fixed_scan_mask, infilling_example
    from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                        MultiscaleDiscriminator)
    from emx_torch.train.gan import GANConfig, GANTrainer

    cfg = dataclasses.replace(InfillingConfig.tiny(), dtype=torch.float64)
    trainer = GANTrainer(
        InfillingGenerator(cfg, device=CPU),
        MultiscaleDiscriminator(cfg, device=CPU),
        GANConfig(log_every=0, seed=3), mesh=mesh,
        example_fn=infilling_example(fixed_scan_mask((32, 32), 0.25)))
    state = trainer.init()
    decisions, metrics = [], []
    step_fn = trainer.step_fn

    def recording(state, batch, do_gen, do_disc, draws=None):
        decisions.append((bool(do_gen), bool(do_disc)))
        state, m = step_fn(state, batch, do_gen, do_disc, draws)
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    trainer.step_fn = recording
    batches = [inputs["gan_clean"][i] for i in range(steps)]
    state = trainer.fit(state, batches, steps)
    gen = state_arrays(state.gen)
    disc = state_arrays(state.disc)
    return {"decisions": decisions, "metrics": metrics,
            "state": {**{f"gen/{k}": v for k, v in gen.items()},
                      **{f"disc/{k}": v for k, v in disc.items()}},
            "pred_avg": float(state.pred_avg)}


def sc_gan(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh

    return gan_run(make_mesh(), inputs)


GAN_KW = dict(gen_lr=1e-3, disc_lr=1e-3, mse_weight=10.0, log_every=0)
GAN_STEPS = ((True, False), (False, True))   # a G step, then a D step


def gan_draws(inputs: dict, i: int, rows=slice(None)) -> dict:
    """Step i's draws as the parent stored them (emx's), in step_draws'
    layout, with the example's rows `rows`."""
    u = inputs[f"gan_draws/u_{i}"].tolist()
    return {"example": {"d4": torch.from_numpy(
                inputs[f"gan_draws/d4_{i}"][rows])},
            "crops_f": tuple(map(tuple, inputs[f"gan_draws/crops_f_{i}"]
                                 .tolist())),
            "crops_r": tuple(map(tuple, inputs[f"gan_draws/crops_r_{i}"]
                                 .tolist())),
            "flip_f": u[0], "flip_r": u[1], "label": u[2]}


def gan_emx_run(mesh, inputs: dict) -> dict:
    """GAN_STEPS on the tiny nets from emx's weights (float64 compute,
    float32 parameters) on the gan_x batch with 1/16 partial scans, on
    emx's draws: each step's metrics, then both nets and the EMAs."""
    from emx_torch.data.degrade import fixed_scan_mask, infilling_example
    from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                        MultiscaleDiscriminator)
    from emx_torch.serve.convert import load_flax_params
    from emx_torch.train.gan import GANConfig, GANTrainer

    cfg = dataclasses.replace(InfillingConfig.tiny(), dtype=torch.float64)
    gen = load_flax_params(InfillingGenerator(cfg, device=CPU),
                           flat_weights(inputs, "gan_gen")[0])
    disc = load_flax_params(MultiscaleDiscriminator(cfg, device=CPU),
                            flat_weights(inputs, "gan_disc")[0])
    trainer = GANTrainer(gen, disc, GANConfig(**GAN_KW), mesh=mesh,
                         example_fn=infilling_example(fixed_scan_mask(
                             inputs["gan_x"].shape[1:], 1 / 16)))
    state = trainer.new_state()
    state.pred_avg = state.pred_avg.double()
    state.pred_avg_real = state.pred_avg_real.double()
    batch = inputs["gan_x"]
    b = batch.shape[0] // trainer.blocks
    rows = slice(trainer.block * b, (trainer.block + 1) * b)
    metrics = []
    for i, (do_gen, do_disc) in enumerate(GAN_STEPS):
        state, m = trainer.step_fn(state, batch, do_gen, do_disc,
                                   draws=gan_draws(inputs, i, rows))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "gen": state_arrays(state.gen), "disc": state_arrays(state.disc),
            "pred_avg": (float(state.pred_avg), float(state.pred_avg_real))}


def sc_gan_emx(inputs: dict) -> dict:
    from emx_torch.parallel import make_mesh

    return gan_emx_run(make_mesh(), inputs)


def sc_one_train(inputs: dict) -> dict:
    return train_steps(None, True, 2, inputs)


def sc_one_bn(inputs: dict) -> dict:
    return {acc: bn_run(None, inputs, acc) for acc in (1, 2)}


def sc_one_gan(inputs: dict) -> dict:
    return gan_run(None, inputs)


def sc_one_fit(inputs: dict) -> dict:
    store = os.path.dirname(inputs["__path__"])
    return fit_run(None, inputs, os.path.join(store, "one_fit"))


def sc_dryrun(inputs: dict) -> dict:
    from emx_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(dist.get_world_size())


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


def main() -> None:
    world, rank, store, names = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4].split(","))
    torch.set_num_threads(1)
    from emx_torch.parallel.distributed import initialize

    initialize(f"file://{store}/rendezvous", world, rank, backend="gloo")
    inputs = dict(np.load(os.path.join(store, "inputs.npz")))
    inputs["__path__"] = os.path.join(store, "inputs.npz")
    try:
        for name in names:
            torch.save(SCENARIOS[name](inputs),
                       os.path.join(store, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
