"""emx_torch.parallel against emx.parallel on the CPU.

The port's side runs in gloo ranks: one module fixture starts four
worker processes, two more and one for the port's world-size-1 runs
(tests/torch_parallel_worker.py, which imports the port and never JAX)
over file stores in a temporary directory, and while they run, computes
emx's side in three more processes, on sub-meshes of the eight
virtual devices (make_mesh(..., devices=jax.devices()[:4])). Weights come from
jax.eval_shape of emx's init with numpy values
(tests/torch_zoo_helpers.py), so both sides hold the same ones.

Held: the Denoiser's halo geometry for every head; the mesh builders'
shapes, shard slices and errors; spatial_apply over four ranks (the
identity at heights 256 and 250, halo 5 on grid 8, a 5x5 conv, row
shifts that read the neighbours' strips and the reflected edges, and
the oversized halo's error) and halo_denoise of emx's tiny s2d-2 model;
the data-parallel Trainer against its world-size-1 step (K2's plain
version at the ranks' image offsets), against emx's step on a 4-device
data mesh, and on a (dcn=2, data=2) pod mesh against the flat mesh;
BatchNorm over two ranks against one at grad_accum 1 and 2, and against
emx's step on a 2-device data mesh; the GANTrainer over two ranks
against one, trainee decisions included, and a G and a D step against
emx's GANTrainer on a 2-device mesh with emx's draws; Trainer.fit's
writes, learning-rate reload and restore over two ranks; the CLI under
torchrun's variables, also with ranks past make_mesh_for_batch's cut;
world size 1 with no group; and dryrun_multichip(4). Marked slow (two more compiles of emx's step):
grad_accum=2 against emx on one device, and emx's own 4-device step
there, which returns another gradient (ROADMAP Queue 3)."""

import dataclasses
import functools
import os
import subprocess
import sys
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.parallel import batch_sharding as emx_batch_sharding
from emx.parallel import make_mesh as emx_make_mesh
from emx.parallel import replicated as emx_replicated
from emx.parallel.halo import halo_denoise as emx_halo_denoise
from emx.parallel.halo import spatial_apply as emx_spatial_apply
from emx.parallel.mesh import make_mesh_for_batch as emx_make_mesh_for_batch
from emx.data.degrade import fixed_scan_mask as flax_mask
from emx.data.degrade import infilling_example as flax_example
from emx.nn.infilling import InfillingConfig as FlaxInfillingConfig
from emx.nn.infilling import InfillingGenerator as FlaxGenerator
from emx.nn.infilling import MultiscaleDiscriminator as FlaxDiscriminator
from emx.nn.infilling import multiscale_crops as emx_multiscale_crops
from emx.train import TrainConfig as FlaxTrainConfig
from emx.train import Trainer as FlaxTrainer
from emx.train.engine import TrainState as FlaxTrainState
from emx.train.gan import GANConfig as FlaxGANConfig
from emx.train.gan import GANState as FlaxGANState
from emx.train.gan import GANTrainer as FlaxGANTrainer
from emx_torch.nn import DenoiserConfig
from emx_torch.serve.tiling import TiledApplier
from test_torch_gan import emx_draws
from torch_zoo_helpers import as_emx, emx_variables, flat, ref_jit
import torch_parallel_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD4 = ("mesh", "spatial", "halo_denoise", "train", "train_pairs",
          "train_pod")
WORLD2 = ("bn", "gan", "gan_emx", "fit")
# The same runs without a mesh, in a process of their own.
WORLD1 = ("one_train", "one_bn", "one_gan", "one_fit")
GAN_KEY = 7        # emx's GAN state's rng in the comparison with emx
# Its image side: at 32 the tiny discriminator's last blocks hold one
# pixel, which its GroupNorm maps to its bias, so D would not see its
# input.
GAN_SIZE = 64
TIMEOUT = 180


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def launch(world: int, store: str, scenarios) -> list:
    """The `world` worker processes of `scenarios`, over `store` (which
    holds inputs.npz)."""
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         str(world), str(r), store, ",".join(scenarios)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def collect(procs, store: str, scenarios) -> dict:
    """{scenario: [rank 0's result, rank 1's, ...]}; raises with a rank's
    output if it failed."""
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return {s: [torch.load(os.path.join(store, f"{s}_{r}.pt"),
                           weights_only=False) for r in range(len(procs))]
            for s in scenarios}


def _emx_weights(cfg: dict, size: int, seed: int) -> dict:
    return emx_variables(FlaxDenoiser(FlaxConfig(**cfg)),
                         jnp.zeros((1, size, size)), train=False, seed=seed)


def _inputs() -> tuple[dict, dict]:
    rng = np.random.default_rng(0)
    f32 = np.float32
    inputs = {
        "img256": rng.random((256, 64)).astype(f32),
        "img250": rng.random((250, 64)).astype(f32),
        "img32": rng.random((32, 16)).astype(f32),
        "kernel5": rng.random((5, 5)).astype(f32),
        "img1024": rng.random((1024, 512)).astype(f32),
        "clean": rng.random((8, 32, 32)).astype(f32),
        "x": rng.random((8, 32, 32)).astype(f32),
        "bn_x": rng.random((4, 64, 64)).astype(f32),
        "gan_clean": rng.random((4, 4, 32, 32)).astype(f32),
        "gan_x": rng.random((4, GAN_SIZE, GAN_SIZE)).astype(f32),
    }
    inputs["t"] = (0.8 * inputs["x"] + 0.1).astype(f32)
    inputs["bn_t"] = (0.7 * inputs["bn_x"] + 0.2).astype(f32)
    bn_cfg = {**dataclasses.asdict(FlaxConfig.tiny()), "norm": "batch"}
    weights = {"halo": _emx_weights(worker.HALO_CFG, 64, 1),
               "train": _emx_weights(worker.DRYRUN_CFG, 32, 2),
               "bn": _emx_weights(bn_cfg, 32, 3),
               "gan_gen": emx_variables(
                   FlaxGenerator(FlaxInfillingConfig.tiny()),
                   jnp.zeros((1, GAN_SIZE, GAN_SIZE)), train=False, seed=4),
               "gan_disc": emx_variables(
                   FlaxDiscriminator(FlaxInfillingConfig.tiny()),
                   emx_multiscale_crops(jax.random.key(0),
                                        jnp.zeros((1, GAN_SIZE, GAN_SIZE))),
                   train=False, seed=5)}
    # The draws of emx's step, which _emx_gan runs under x64: jax.random
    # draws other values there.
    with jax.enable_x64():
        key = jax.random.key_data(jax.random.key(GAN_KEY))
        draws = [emx_draws(key, i, 4, GAN_SIZE)
                 for i in range(len(worker.GAN_STEPS))]
    for i, d in enumerate(draws):
        inputs.update({
            f"gan_draws/d4_{i}": d["example"]["d4"].numpy(),
            f"gan_draws/crops_f_{i}": np.asarray(d["crops_f"]),
            f"gan_draws/crops_r_{i}": np.asarray(d["crops_r"]),
            f"gan_draws/u_{i}": np.asarray([d["flip_f"], d["flip_r"],
                                            d["label"]])})
    for prefix, w in weights.items():
        for coll, tree in w.items():
            inputs.update({f"{prefix}/{coll}/{k}": v for k, v in tree.items()})
    return inputs, weights


def _emx_spatial(inputs: dict) -> dict:
    mesh = emx_make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    kernel = jnp.asarray(inputs["kernel5"])

    def conv(x):
        return jax.lax.conv_general_dilated(
            x[None, None], kernel[None, None], (1, 1), padding="SAME")[0, 0]

    fns = {"conv5": conv,
           "shift_down": lambda x: jnp.roll(x, worker.SHIFT, 0),
           "shift_up": lambda x: jnp.roll(x, -worker.SHIFT, 0)}
    out = {}
    for name, (img, _, halo, grid) in worker.spatial_cases(inputs).items():
        fn = fns.get(name, lambda x: x)
        try:
            out[name] = np.asarray(emx_spatial_apply(
                fn, jnp.asarray(img), mesh, halo=halo, grid=grid))
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


def _emx_halo(inputs: dict, weights: dict) -> np.ndarray:
    """emx's halo_denoise over a 4-device spatial mesh, computing in
    float64 (as the port's side does): in float32, flax's two-pass
    GroupNorm and the port's one-pass one part by up to 1e-3 on this
    model (tests/test_torch_denoiser.py), which would hide the halo."""
    mesh = emx_make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    with jax.enable_x64():
        model = FlaxDenoiser(FlaxConfig(**worker.HALO_CFG,
                                        dtype=jnp.float64))
        run = ref_jit(lambda v, img: emx_halo_denoise(model, v, img, mesh))
        return np.asarray(run(as_emx(weights["halo"]),
                              jnp.asarray(inputs["img1024"])))


def _emx_train_pairs(inputs: dict, weights: dict, devices: int,
                     grad_accum: int) -> dict:
    """emx's Trainer step on (x, t) over a data mesh of `devices`, the
    forward and backward in float64 (float32 parameters), as the port's
    side computes: in float32 the conv biases ahead of one-channel
    GroupNorm groups get gradients of rounding noise, which Adam's first
    step turns into full-size moves."""
    mesh = emx_make_mesh(data=devices, spatial=1,
                         devices=jax.devices()[:devices])
    with jax.enable_x64():
        trainer = FlaxTrainer(
            FlaxDenoiser(FlaxConfig(**worker.DRYRUN_CFG, dtype=jnp.float64)),
            FlaxTrainConfig(learning_rate=1e-3, optimizer="adam",
                            grad_accum=grad_accum, log_every=0), mesh=mesh)
        params = as_emx(weights["train"])["params"]
        state = FlaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats={},
                               opt_state=trainer.optimizer.init(params),
                               rng=jax.random.key_data(jax.random.key(0)))
        batch = jax.device_put((jnp.asarray(inputs["x"]),
                                jnp.asarray(inputs["t"])),
                               emx_batch_sharding(mesh))
        state, m = trainer.step_fn(state, batch)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "params": flat(state.params)}


def _emx_bn(inputs: dict, weights: dict) -> dict:
    """emx's Trainer on the tiny BatchNorm Denoiser over a 2-device data
    mesh: two nesterov steps (learning rate 1e-2, grad_accum 1) on
    (bn_x, bn_t), computing in float64 as the port's side does
    (tests/test_torch_train.py)."""
    mesh = emx_make_mesh(data=2, spatial=1, devices=jax.devices()[:2])
    with jax.enable_x64():
        trainer = FlaxTrainer(
            FlaxDenoiser(dataclasses.replace(FlaxConfig.tiny(), norm="batch",
                                             dtype=jnp.float64)),
            FlaxTrainConfig(learning_rate=1e-2, log_every=0), mesh=mesh)
        variables = as_emx(weights["bn"])
        state = FlaxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            # float64, as the steps return them (the same values: the
            # first update promotes them).
            batch_stats=jax.tree_util.tree_map(
                lambda v: v.astype(jnp.float64), variables["batch_stats"]),
            opt_state=trainer.optimizer.init(variables["params"]),
            rng=jax.random.key_data(jax.random.key(0)))
        # Placed as the steps return it, so the second step compiles
        # nothing new.
        state = jax.device_put(state, emx_replicated(mesh))
        batch = jax.device_put((jnp.asarray(inputs["bn_x"]),
                                jnp.asarray(inputs["bn_t"])),
                               emx_batch_sharding(mesh))
        metrics = []
        for _ in range(2):
            state, m = trainer.step_fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics,
                "state": {**{f"params/{k}": v
                             for k, v in flat(state.params).items()},
                          **{f"batch_stats/{k}": v
                             for k, v in flat(state.batch_stats).items()}}}


def _emx_gan(inputs: dict, weights: dict) -> dict:
    """emx's GANTrainer on the tiny nets over a 2-device data mesh, the
    batch sharded: a G step, then a D step (worker.GAN_STEPS), computing
    in float64 (tests/test_torch_gan.py); the draws are those that
    _inputs stored for the port's ranks."""
    mesh = emx_make_mesh(data=2, spatial=1, devices=jax.devices()[:2])
    example = functools.partial(flax_example,
                                mask=flax_mask((GAN_SIZE,) * 2, 1 / 16))
    with jax.enable_x64():
        cfg = dataclasses.replace(FlaxInfillingConfig.tiny(),
                                  dtype=jnp.float64)
        trainer = FlaxGANTrainer(FlaxGenerator(cfg), FlaxDiscriminator(cfg),
                                 FlaxGANConfig(**worker.GAN_KW), mesh=mesh,
                                 example_fn=example)
        gen = as_emx(weights["gan_gen"])["params"]
        disc = as_emx(weights["gan_disc"])["params"]
        state = FlaxGANState(
            step=jnp.zeros((), jnp.int32), gen_params=gen, gen_stats={},
            disc_params=disc, disc_stats={},
            gen_opt=trainer.gen_opt.init(gen),
            disc_opt=trainer.disc_opt.init(disc),
            rng=jax.random.key_data(jax.random.key(GAN_KEY)),
            pred_avg=jnp.asarray(0.5, jnp.float32),
            pred_avg_real=jnp.asarray(0.5, jnp.float32))
        # Placed and typed as the steps return it (the EMAs float32), so
        # the second step compiles nothing new.
        state = jax.device_put(state, emx_replicated(mesh))
        batch = jax.device_put(jnp.asarray(inputs["gan_x"]),
                               emx_batch_sharding(mesh))
        metrics = []
        for do_gen, do_disc in worker.GAN_STEPS:
            state, m = trainer.step_fn(state, batch, jnp.asarray(do_gen),
                                       jnp.asarray(do_disc))
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics, "gen": flat(state.gen_params),
                "disc": flat(state.disc_params),
                "pred_avg": (float(state.pred_avg),
                             float(state.pred_avg_real))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo runs, emx's references and the port's world-size-1
    runs."""
    inputs, weights = _inputs()
    root = tmp_path_factory.mktemp("parallel")
    np.savez(root / "inputs.npz", **inputs)
    worlds = {4: WORLD4, 2: WORLD2, 1: WORLD1}
    for w in worlds:
        os.makedirs(root / f"w{w}")
        os.symlink(root / "inputs.npz", root / f"w{w}" / "inputs.npz")
    procs = {w: launch(w, str(root / f"w{w}"), names)
             for w, names in worlds.items()}
    try:
        # emx's side in three processes (tracing holds the GIL), the
        # longest first.
        with ProcessPoolExecutor(
                3, mp_context=multiprocessing.get_context("spawn")) as pool:
            pending = {
                "gan": pool.submit(_emx_gan, inputs, weights),
                "bn": pool.submit(_emx_bn, inputs, weights),
                "train_pairs": pool.submit(_emx_train_pairs, inputs,
                                           weights, 4, 1),
                "halo": pool.submit(_emx_halo, inputs, weights),
                "spatial": pool.submit(_emx_spatial, inputs)}
            ref = {k: f.result() for k, f in pending.items()}
    except BaseException:
        for p in sum(procs.values(), []):
            p.kill()
        raise
    got = {}
    for w, names in worlds.items():
        got.update(collect(procs[w], str(root / f"w{w}"), names))
    ref.update({name: got.pop(name)[0] for name in WORLD1})
    return {"inputs": inputs, "weights": weights, "ref": ref, "got": got,
            "root": root}


def _same_state(a: dict, b: dict, rtol: float, atol: float = 0.0) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("heads", [
    {}, "tiny", "scaled", {"folded_head": 16, "folded_head_depth": 3},
    {"mid_res_head": 16, "mid_res_factor": 2, "mid_res_depth": 2,
     "space_to_depth": 4},
    {"kernel_pred_head": 2, "space_to_depth": 4}])
def test_halo_geometry_matches_emx(heads):
    """halo_grid() and receptive_field_radius() for the default, tiny,
    scaled(0.25), folded-head, mid-resolution-head and kernel-prediction
    configs."""
    if heads == "tiny":
        cfgs = (FlaxConfig.tiny(), DenoiserConfig.tiny())
    elif heads == "scaled":
        cfgs = (FlaxConfig().scaled(0.25), DenoiserConfig().scaled(0.25))
    else:
        cfgs = (FlaxConfig(**heads), DenoiserConfig(**heads))
    ref, port = cfgs
    assert port.halo_grid() == ref.halo_grid()
    assert port.receptive_field_radius() == ref.receptive_field_radius()


def _slice_pairs(index, shape) -> list:
    return [s.indices(n)[:2] for s, n in zip(index, shape)]


def test_mesh_builders_match_emx(runs):
    """Each rank's shape, coordinates and shard slices against emx's
    mesh of four devices (device i is rank i); the gcd-trimmed mesh's
    outer ranks hold no shard; emx's errors."""
    got = runs["got"]["mesh"]
    devs = jax.devices()[:4]
    flat = emx_make_mesh(devices=devs)
    grid = emx_make_mesh(data=2, spatial=2, devices=devs)
    trimmed = emx_make_mesh_for_batch(6, devices=devs)
    maps = {
        "flat": emx_batch_sharding(flat).devices_indices_map((8, 5)),
        "grid": emx_batch_sharding(grid, spatial_dims=1).devices_indices_map(
            (4, 8, 3)),
    }
    shapes = {"flat": (8, 5), "grid": (4, 8, 3)}
    for r, out in enumerate(got):
        for name, mesh in (("flat", flat), ("grid", grid)):
            shape, coords, slices = out[name]
            assert shape == dict(mesh.shape)
            pos = np.argwhere(mesh.devices == devs[r])[0]
            assert coords == dict(zip(mesh.axis_names, map(int, pos)))
            want = _slice_pairs(maps[name][devs[r]], shapes[name])
            assert [tuple(s) for s in slices] == want
        shape, coords, ranks, slices = out["trimmed"]
        assert shape == dict(trimmed.shape)
        assert ranks == [[d.id] for d in trimmed.devices.flat]
        if r < 2:
            want = emx_batch_sharding(trimmed).devices_indices_map((6, 2))
            assert [tuple(s) for s in slices] == _slice_pairs(
                want[devs[r]], (6, 2))
        else:
            assert coords is None and slices is None
        shape, coords, slices = out["pod"]
        assert shape == {"dcn": 2, "data": 2, "spatial": 1}
        assert slices == out["flat"][2]        # dcn x data: 8 rows / 4
        assert out["host_batch_slice"] == (2 * r, 2)
        np.testing.assert_array_equal(out["as_global"],
                                      runs["inputs"]["clean"])
        with pytest.raises(ValueError) as e:
            emx_make_mesh(data=3, devices=devs)
        assert out["err_mesh"] == str(e.value)
        assert out["err_pod"] is not None


@pytest.mark.parametrize("case", ["identity256", "identity250",
                                  "halo5_grid8", "conv5", "shift_down",
                                  "shift_up", "oversized"])
def test_spatial_apply_matches_emx(runs, case):
    """spatial_apply over four gloo ranks against emx's over a 4-device
    spatial mesh, on every rank; the oversized halo raises on both."""
    ref = runs["ref"]["spatial"][case]
    for out in runs["got"]["spatial"]:
        got = out[case]
        if isinstance(ref, str):
            assert isinstance(got, str) and got.startswith("ValueError")
            assert ref.startswith("ValueError")
            continue
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5)
    if case.startswith("identity") or case == "halo5_grid8":
        img = runs["inputs"]["img250" if case.endswith("250") else "img256"]
        np.testing.assert_array_equal(runs["got"]["spatial"][0][case], img)


def test_halo_denoise_matches_emx_and_tiling(runs):
    """halo_denoise of emx's tiny s2d-2 model on 1024x512 over four ranks
    within 1e-4 of emx's (both computing in float64, float32 out), and,
    in float32, as close to the full-image pass as the TiledApplier rule
    asks (tests/test_parallel_ops.py)."""
    ref = runs["ref"]["halo"]
    outs = [o["out"] for o in runs["got"]["halo_denoise"]]
    for got in outs:
        assert got.shape == (1024, 512)
        np.testing.assert_allclose(got, ref, atol=1e-4)
    model = worker.denoiser(runs["inputs"], "halo", **worker.HALO_CFG)
    img = torch.from_numpy(runs["inputs"]["img1024"])
    with torch.inference_mode():
        full = model(img[None], train=False)[0].numpy()
    tiled = TiledApplier(model, tile=256, overlap=64, preprocess=False)(
        img).numpy()
    err_halo = float(np.abs(outs[0] - full).mean())
    err_tiled = float(np.abs(tiled - full).mean())
    assert err_halo <= max(2 * err_tiled, 5e-3), (err_halo, err_tiled)


def test_trainer_over_four_ranks_matches_one(runs):
    """Two steps of group norm, grad_accum=2, adam, K2's plain version
    on the global batch: each rank draws its rows at its image offset,
    so the four ranks' loss is the world-size-1 loss within 1e-6 and
    every parameter within rel 1e-5, equal on every rank."""
    one = runs["ref"]["one_train"]
    got = runs["got"]["train"]
    for out in got:
        for m, ref in zip(out["metrics"], one["metrics"]):
            assert m["loss"] == pytest.approx(ref["loss"], abs=1e-6)
            assert m["mse"] == pytest.approx(ref["mse"], abs=1e-6)
            assert m["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                   rel=1e-5)
        _same_state(out["state"], one["state"], rtol=1e-5, atol=1e-7)
        _same_state(out["state"], got[0]["state"], rtol=0)


def _emx_digest(params: dict) -> float:
    return sum(float(np.abs(v).sum()) for v in params.values())


def _matches_emx_step(ref: dict, out: dict) -> None:
    """emx's own tolerances (tests/test_distributed_mp.py: loss 1e-5,
    parameter digest rel 1e-5), grad_norm within rel 1e-5 and every
    parameter within 1e-5."""
    digest = _emx_digest(ref["params"])
    m = out["metrics"][0]
    assert m["loss"] == pytest.approx(ref["metrics"]["loss"], abs=1e-5)
    assert m["grad_norm"] == pytest.approx(ref["metrics"]["grad_norm"],
                                           rel=1e-5)
    params = {k[len("params/"):]: v for k, v in out["state"].items()}
    assert sum(float(np.abs(v).sum()) for v in params.values()) == \
        pytest.approx(digest, rel=1e-5)
    _same_state(params, ref["params"], rtol=1e-5, atol=1e-5)


def test_trainer_over_four_ranks_matches_emx(runs):
    """example_fn=None on (x, t), adam, grad_accum=1: the four ranks'
    step against emx's Trainer on make_mesh(data=4), on every rank."""
    for out in runs["got"]["train_pairs"]:
        _matches_emx_step(runs["ref"]["train_pairs"], out[1])


@pytest.fixture(scope="module")
def emx_grad_accum(runs):
    """emx's step at grad_accum=2 on one device and on a 4-device data
    mesh (two more compiles of emx's step, the slowest part of the
    file)."""
    return {d: _emx_train_pairs(runs["inputs"], runs["weights"], d, 2)
            for d in (1, 4)}


@pytest.mark.slow
def test_trainer_grad_accum_matches_emx(runs, emx_grad_accum):
    """grad_accum=2: the four ranks' step (each rank holding its rows of
    both microbatches) against emx's on one device."""
    for out in runs["got"]["train_pairs"]:
        _matches_emx_step(emx_grad_accum[1], out[2])


@pytest.mark.slow
def test_emx_grad_accum_on_four_devices_is_a_fault(runs, emx_grad_accum):
    """emx's jit of the step over a 4-device data mesh at grad_accum=2
    (the microbatch reshape of the row-sharded batch) returns the loss of
    one device but another gradient: grad_norm 28% higher with XLA on
    the CPU; jax.grad of the same loss with the input sharded does the
    same.
    The port's four ranks give one device's gradient."""
    one = emx_grad_accum[1]["metrics"]
    four = emx_grad_accum[4]["metrics"]
    assert four["loss"] == pytest.approx(one["loss"], abs=1e-5)
    assert four["grad_norm"] > 1.2 * one["grad_norm"]
    port = runs["got"]["train_pairs"][0][2]["metrics"][0]
    assert port["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-5)


def test_pod_mesh_matches_flat_mesh(runs):
    """A (dcn=2, data=2) pod mesh: the batch splits over both axes, and
    the two steps equal the flat data=4 mesh's."""
    for flat, pod in zip(runs["got"]["train"], runs["got"]["train_pod"]):
        for a, b in zip(flat["metrics"], pod["metrics"]):
            for k in a:
                assert b[k] == pytest.approx(a[k], rel=1e-6, abs=1e-7), k
        _same_state(pod["state"], flat["state"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_batch_norm_over_two_ranks_matches_one(runs, grad_accum):
    """Cross-rank BatchNorm: two nesterov steps over two ranks normalise
    over the global (micro)batch - at grad_accum=2 each rank holds its
    half of each of emx's microbatches, global rows [m B/2, (m+1) B/2) -
    so the running statistics lie within 1e-6 and the parameters within
    rel 1e-5 of one rank's, on both ranks."""
    one = runs["ref"]["one_bn"][grad_accum]
    got = [out[grad_accum] for out in runs["got"]["bn"]]
    for out in got:
        for m, ref in zip(out["metrics"], one["metrics"]):
            assert m["loss"] == pytest.approx(ref["loss"], abs=1e-6)
        stats = {k: v for k, v in out["state"].items()
                 if k.startswith("batch_stats/")}
        ref_stats = {k: v for k, v in one["state"].items()
                     if k.startswith("batch_stats/")}
        assert stats
        _same_state(stats, ref_stats, rtol=0, atol=1e-6)
        _same_state(out["state"], one["state"], rtol=1e-5, atol=1e-6)
    moved = [k for k in ref_stats if k.endswith("/mean")]
    init = runs["weights"]["bn"]["batch_stats"]
    assert any(not np.allclose(one["state"][k], init[k[len("batch_stats/"):]])
               for k in moved)


def test_batch_norm_over_two_ranks_matches_emx(runs):
    """grad_accum=1: the two ranks' nesterov steps against emx's Trainer
    on a 2-device data mesh, both computing in float64 (float32
    parameters): the loss, mse and grad_norm of each step within rel
    1e-5, the running statistics and the parameters within atol 1e-6,
    rel 1e-5 (tests/test_torch_train.py's tolerances), on both ranks."""
    ref = runs["ref"]["bn"]
    for out in runs["got"]["bn"]:
        got = out[1]
        for m, want in zip(got["metrics"], ref["metrics"]):
            for k, v in want.items():
                assert m[k] == pytest.approx(v, rel=1e-5), k
        assert any(k.startswith("batch_stats/") for k in ref["state"])
        _same_state(got["state"], ref["state"], rtol=1e-5, atol=1e-6)


def test_gan_over_two_ranks_matches_emx(runs):
    """A generator step, then a discriminator step, over two ranks
    against emx's GANTrainer on a 2-device mesh with the batch sharded,
    on emx's draws (each rank takes its rows' D4 choices): every metric
    within rel 1e-5 (abs 1e-7), the EMAs within 1e-7, both nets within
    atol 1e-6, rel 1e-5 (tests/test_torch_gan.py's tolerances), on both
    ranks."""
    ref = runs["ref"]["gan"]
    for out in runs["got"]["gan_emx"]:
        for m, want in zip(out["metrics"], ref["metrics"]):
            for k, v in want.items():
                assert m[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
        assert out["pred_avg"] == pytest.approx(ref["pred_avg"], abs=1e-7)
        for net in ("gen", "disc"):
            got = {k[len("params/"):]: v for k, v in out[net].items()}
            _same_state(got, ref[net], rtol=1e-5, atol=1e-6)


def test_gan_over_two_ranks_matches_one(runs):
    """GANTrainer.fit for four steps over two ranks: the same trainee
    decision at every step on both ranks and at world size 1, the
    metrics and both nets within rel 1e-5."""
    one = runs["ref"]["one_gan"]
    got = runs["got"]["gan"]
    for out in got:
        assert out["decisions"] == one["decisions"]
        for m, ref in zip(out["metrics"], one["metrics"]):
            for k in ref:
                assert m[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-6), k
        _same_state(out["state"], one["state"], rtol=1e-5, atol=1e-6)
        assert out["pred_avg"] == pytest.approx(one["pred_avg"], rel=1e-6)
    _same_state(got[1]["state"], got[0]["state"], rtol=0)


def test_fit_over_two_ranks_matches_one(runs, tmp_path_factory):
    """Trainer.fit over two ranks with a DataPipeline, a checkpoint every
    2 steps and learning_rate.txt: rank 0 alone writes the metrics log
    and the checkpoints, every step's logged loss equals one rank's
    within 1e-6, both ranks switch the learning rate at the same step
    (rank 0 reads the file, every rank takes its value), and every rank
    restores the last checkpoint to its live state."""
    import json

    root = runs["root"]
    one_dir, two_dir = root / "w1" / "one_fit", root / "w2" / "fit"

    def losses(d):
        with open(d / "metrics.jsonl") as f:
            return [json.loads(ln)["loss"] for ln in f]

    assert losses(two_dir) == pytest.approx(losses(one_dir), abs=1e-6)
    assert len(losses(two_dir)) == 4
    assert sorted(os.listdir(two_dir / "ckpt")) == sorted(
        os.listdir(one_dir / "ckpt"))
    one = runs["ref"]["one_fit"]
    for out in runs["got"]["fit"]:
        assert out["lr"] == one["lr"] == [5e-4]
        assert out["step"] == 4 and out["cursor"] == one["cursor"]
        _same_state(out["restored"], out["state"], rtol=0)
        _same_state(out["state"], one["state"], rtol=1e-5, atol=1e-7)


def test_dryrun_multichip_four_ranks():
    """emx_torch.parallel.dryrun.dryrun_multichip(4, "cpu"): four gloo
    processes, the train step and halo serving both pass."""
    from emx_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, "cpu")
    assert out["n"] == 4 and out["backend"] == "gloo"
    assert np.isfinite(out["loss"]) and out["halo_err"] < 0.1


def _cli_train_denoiser(tmp_path, world: int, batch: int) -> list[str]:
    """`train-denoiser --device=cpu` for two steps at batch `batch` in
    `world` processes under torchrun's variables (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), beside the same command without them (one
    rank, last); every process's output, each having exited 0."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = [f"--batch_size={batch}", "--crop_size=32", "--scale=0.02",
            "--steps=2", "--ckpt_every_steps=1", "--device=cpu"]

    def start(name, env):
        return subprocess.Popen(
            [sys.executable, "-m", "emx_torch.cli", "train-denoiser",
             f"--model_dir={tmp_path / name}", *args],
            env={**os.environ, "OMP_NUM_THREADS": "1", **env},
            cwd=os.path.dirname(HERE), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)

    procs = [start("ranks", {"RANK": str(r), "WORLD_SIZE": str(world),
                             "LOCAL_RANK": str(r),
                             "MASTER_ADDR": "127.0.0.1",
                             "MASTER_PORT": str(port)})
             for r in range(world)]
    procs.append(start("one", {}))
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _result(out: str) -> dict:
    import json

    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")][-1]


def test_cli_train_denoiser_over_two_ranks(tmp_path):
    """Two ranks at batch 4: the gloo group, make_mesh_for_batch's data=2
    mesh; rank 0 alone prints the result and writes the artifact, its
    loss that of the same command without the variables (one rank)
    within 1e-5."""
    *ranks, one = _cli_train_denoiser(tmp_path, 2, 4)
    last, ref = _result(ranks[0]), _result(one)
    assert last["step"] == ref["step"] == 2
    assert last["loss"] == pytest.approx(ref["loss"], abs=1e-5)
    assert not any(ln.startswith("{") for ln in ranks[1].splitlines())
    assert (tmp_path / "ranks" / "artifact" / "artifact.json").exists()


def test_cli_ranks_past_the_mesh_leave(tmp_path):
    """Three ranks at batch 4: make_mesh_for_batch cuts the mesh to
    gcd(4, 3) = 1 rank; ranks 1 and 2 lie outside it, say so, leave the
    group and exit 0 without training, and rank 0 trains the batch alone
    to the one-rank loss within 1e-5."""
    *ranks, one = _cli_train_denoiser(tmp_path, 3, 4)
    last, ref = _result(ranks[0]), _result(one)
    assert last["step"] == ref["step"] == 2
    assert last["loss"] == pytest.approx(ref["loss"], abs=1e-5)
    for out in ranks[1:]:
        assert "trains nothing" in out
        assert not any(ln.startswith("{") for ln in out.splitlines())


def test_meshed_trainer_takes_a_loss_of_the_mse(tmp_path):
    """Over a process group the Trainer averages the ranks' MSEs, one
    scalar, and applies the loss to that mean: a loss_fn that does not
    carry its function of the MSE (`of_mse`) is refused; huberised_mse
    carries `huberise` and is taken (ROADMAP Queue 3)."""
    import torch.distributed as dist

    from emx_torch.nn import Denoiser
    from emx_torch.parallel import make_mesh
    from emx_torch.parallel.distributed import initialize
    from emx_torch.train import Trainer, huberised_mse
    from emx_torch.train.losses import huberise

    assert huberised_mse.of_mse is huberise
    model = Denoiser(DenoiserConfig(**worker.DRYRUN_CFG), device="cpu")
    initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo")
    try:
        mesh = make_mesh(device="cpu")
        with pytest.raises(ValueError, match="of_mse"):
            Trainer(model, worker.train_config(), mesh=mesh,
                    loss_fn=lambda p, t: torch.mean(torch.abs(p - t)))
        assert Trainer(model, worker.train_config(),
                       mesh=mesh).loss_fn is huberised_mse
    finally:
        dist.destroy_process_group()


def test_dryrun_asks_for_cards_or_the_cpu():
    """Without a process group, dryrun_multichip's device says where its
    ranks run: "cuda" refuses a host with fewer cards than ranks (this
    one has none) instead of leaving for the CPU, and an unknown device
    is an error."""
    from emx_torch.parallel.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2, "cuda")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dryrun_multichip(2, "tpu")


def test_world_size_1_needs_no_group(monkeypatch):
    """With no process group and none of torchrun's variables:
    initialize() does nothing, make_mesh() is a 1x1 mesh with no group
    (on the card by default: here it asks for one), shards are the whole
    batch, the pod mesh is 1x1x1, this process loads the whole batch,
    and spatial_apply reflects at both edges of the one shard."""
    import torch.distributed as dist

    from emx_torch.parallel import batch_sharding, make_mesh, shard_batch
    from emx_torch.parallel.distributed import (host_batch_slice,
                                                initialize, make_pod_mesh)
    from emx_torch.parallel.halo import spatial_apply

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    initialize()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "spatial": 1}
    assert mesh.coords == {"data": 0, "spatial": 0}
    assert mesh.group("data") is None and mesh.chain("data") == [0]
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(shard_batch(x, mesh), x)
    assert torch.equal(batch_sharding(mesh).gather(x), x)
    assert make_pod_mesh(device="cpu").shape == {"dcn": 1, "data": 1,
                                                 "spatial": 1}
    assert host_batch_slice(8) == (0, 8)
    img = torch.rand((40, 8), generator=torch.Generator().manual_seed(0))
    out = spatial_apply(lambda v: torch.roll(v, 2, 0), img, mesh, halo=3)
    padded = torch.cat([img[1:4].flip(0), img, img[-4:-1].flip(0)])
    assert torch.equal(out, torch.roll(padded, 2, 0)[3:43])
    assert not dist.is_initialized()
