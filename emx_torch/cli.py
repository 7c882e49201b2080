"""Command-line entry points (port of emx/cli.py): emx's command names,
flags and argument order, and one more flag, `--device=` (cuda by
default; cpu runs a command on the CPU).

  python -m emx_torch.cli harvest --src=<dm corpus> --out=<dir>
  python -m emx_torch.cli train-denoiser --data_dir=<harvested TIFFs>
      --model_dir=... [--steps_per_launch=8]
  python -m emx_torch.cli bench-train [quick]
  python -m emx_torch.cli quality <out_dir> [s2d] [steps] [batch]
  python -m emx_torch.cli qat-finetune <artifact.npz> [out_dir] [steps]
      [psnr_gate] [--scope=head|refine|decoder|decoder2]
  python -m emx_torch.cli quant-check <artifact.npz> [out_dir]
  python -m emx_torch.cli serve --artifact=... --port=8501
  python -m emx_torch.cli train-infilling --model_dir=... [--steps=N]
  python -m emx_torch.cli gan-quality [out_dir] [steps]
  python -m emx_torch.cli gan-demo [out_dir] [steps]
  python -m emx_torch.cli ewrec --stack_dir=<focal-series TIFFs> --out=...
  python -m emx_torch.cli zoo-ladder [out_dir] [steps] [scale]
  python -m emx_torch.cli dqn-autofocus [out_dir] [episodes]
"""

from __future__ import annotations

import dataclasses
import glob
import json
import sys
import time

from emx_torch.utils.config import Config, config_field


@dataclasses.dataclass
class DenoiserCLIConfig(Config):
    data_dir: str = config_field("", "dir of float32 TIFF crops ('' = synthetic)")
    model_dir: str = config_field("runs/denoiser", "checkpoint/log dir")
    batch_size: int = config_field(8, "global batch")
    crop_size: int = config_field(512, "crop sidelength")
    steps: int = config_field(100_000, "train steps")
    learning_rate: float = config_field(1e-3, "lr")
    grad_accum: int = config_field(1, "grad accumulation factor")
    scale: float = config_field(1.0, "model width multiplier")
    ckpt_every_steps: int = config_field(5000, "checkpoint cadence")
    seed: int = config_field(0, "seed")
    steps_per_launch: int = config_field(
        1, "train steps per launch (a CUDA graph of them on the card)")
    device: str = config_field("cuda", "cuda, or cpu")


@dataclasses.dataclass
class InfillingCLIConfig(Config):
    data_dir: str = config_field("", "dir of float32 TIFF crops ('' = synthetic)")
    model_dir: str = config_field("runs/infilling", "checkpoint/log dir")
    batch_size: int = config_field(4, "global batch")
    crop_size: int = config_field(512, "crop sidelength")
    steps: int = config_field(700_000, "train steps (reference hard stop)")
    coverage: int = config_field(64, "1/coverage of pixels scanned")
    seed: int = config_field(0, "seed")
    log_every: int = config_field(100, "metric cadence")
    ckpt_every_steps: int = config_field(10_000, "checkpoint cadence")
    scale: float = config_field(1.0, "width multiplier (1.0 = reference)")
    device: str = config_field("cuda", "cuda, or cpu")


@dataclasses.dataclass
class ServeConfig(Config):
    artifact: str = config_field("", "artifact directory or .npz bundle")
    host: str = config_field("127.0.0.1", "bind host")
    port: int = config_field(8501, "bind port")
    max_batch: int = config_field(8, "micro-batch size")
    tile: int = config_field(512, "native tile; other sizes are "
                             "served via overlapped tiling")
    overlap: int = config_field(80, "tile overlap (px)")
    device: str = config_field("cuda", "cuda, or cpu")


def _device(argv: list[str]) -> str:
    """The value of the last `--device=` flag, cuda by default."""
    found = [x.split("=", 1)[1] for x in argv if x.startswith("--device=")]
    return found[-1] if found else "cuda"


def _positional(argv: list[str]) -> list[str]:
    return [x for x in argv if not x.startswith("-")]


def _pipeline(data_dir: str, batch: int, crop: int, seed: int):
    from emx_torch.data.pipeline import (DataPipeline, PipelineConfig,
                                         synthetic_micrographs)

    cfg = PipelineConfig(batch_size=batch, crop_size=crop, seed=seed)
    if data_dir:
        paths = sorted(glob.glob(f"{data_dir}/**/*.tif", recursive=True))
        if not paths:
            raise SystemExit(f"no .tif files under {data_dir}")
        return DataPipeline(paths, cfg)
    return DataPipeline(synthetic_micrographs(max(64, 4 * batch), crop), cfg)


def train_denoiser(argv: list[str]) -> None:
    """Train the default Denoiser (group norm, s2d 2, full width unless
    --scale) on TIFF crops, resuming from model_dir/ckpt; write the
    directory artifact model_dir/artifact, which serve_artifact serves.
    Ends with one JSON line: the step, the last loss, the rate and the
    degrade kernel's launches (captured and replayed under
    --steps_per_launch > 1)."""
    from emx_torch.data.degrade import denoiser_example
    from emx_torch.nn import Denoiser, DenoiserConfig
    from emx_torch.ops.degrade_kernel import fused_poisson_degrade
    from emx_torch.serve.convert import to_flax_params
    from emx_torch.serve.export import nest, save_artifact
    from emx_torch.train import Checkpointer, TrainConfig, Trainer
    from emx_torch.utils.device import resolve_device

    c = DenoiserCLIConfig.from_args(argv)
    device = resolve_device(c.device)
    mcfg = DenoiserConfig().scaled(c.scale) if c.scale != 1.0 else \
        DenoiserConfig()
    trainer = Trainer(
        Denoiser(mcfg, device=device),
        TrainConfig(learning_rate=c.learning_rate, grad_accum=c.grad_accum,
                    model_dir=c.model_dir,
                    ckpt_every_steps=c.ckpt_every_steps, seed=c.seed,
                    steps_per_launch=c.steps_per_launch),
        example_fn=denoiser_example)
    pipe = _pipeline(c.data_dir, c.batch_size, c.crop_size, c.seed)
    state = trainer.init()
    ckpt = Checkpointer(f"{c.model_dir}/ckpt")
    try:
        state, pipe_state = ckpt.restore(state)
        if pipe_state:
            pipe.load_state_dict(pipe_state)
        print(f"resumed from step {state.step} at cursor "
              f"{pipe.state_dict()}", flush=True)
    except FileNotFoundError:
        pass
    start, launches = state.step, fused_poisson_degrade.launches
    t0 = time.perf_counter()
    state = trainer.fit(state, pipe, c.steps, checkpointer=ckpt)
    loss = (float(trainer.last_metrics["loss"])
            if trainer.last_metrics else None)
    seconds = time.perf_counter() - t0
    params, stats = to_flax_params(state.model)
    variables = {"params": nest(params),
                 **({"batch_stats": nest(stats)} if stats else {})}
    save_artifact(f"{c.model_dir}/artifact", "denoiser",
                  dataclasses.asdict(mcfg), variables)
    print(f"trained to step {state.step}; artifact at "
          f"{c.model_dir}/artifact", flush=True)
    g = trainer.graph_stats
    captured = g["captures"] * (trainer.graph.k2_per_replay
                                if trainer.graph else 0)
    print(json.dumps({
        "step": state.step, "start": start, "loss": loss,
        "fit_s": seconds, "img_per_s": (state.step - start) * c.batch_size
        / seconds if state.step > start else None,
        "cursor": pipe.state_dict(),
        "k2_launches": fused_poisson_degrade.launches - launches
        - captured + g["k2_replayed"],
        "graph": g}), flush=True)


def digest(obj) -> str:
    """sha256 of the bytes of every tensor in `obj` (nested dicts, lists
    and tuples; other leaves by repr): equal digests, equal contents."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, torch.Tensor):
            h.update(o.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif isinstance(o, dict):
            for k in sorted(o, key=str):
                h.update(str(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        else:
            h.update(repr(o).encode())

    walk(obj)
    return h.hexdigest()


def train_infilling(argv: list[str]) -> None:
    """Train the infilling GAN at the reference's full width
    (InfillingConfig(), float32; --scale shrinks it) on 1/coverage partial scans of TIFF
    crops or synthetic micrographs, resuming from model_dir/ckpt (a port
    addition: emx's command starts afresh). Ends with one JSON line: the
    steps, seconds, img/s, peak memory on a card, whether each net's
    parameters changed, and the state's digest after a resume and at the
    end."""
    import torch

    from emx_torch.data.degrade import fixed_scan_mask, infilling_example
    from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                        MultiscaleDiscriminator)
    from emx_torch.train import Checkpointer
    from emx_torch.train.gan import GANConfig, GANTrainer
    from emx_torch.utils.device import resolve_device

    c = InfillingCLIConfig.from_args(argv)
    device = resolve_device(c.device)
    mask = fixed_scan_mask((c.crop_size, c.crop_size), 1.0 / c.coverage)
    cfg = InfillingConfig().scaled(c.scale) if c.scale != 1.0 else \
        InfillingConfig()
    trainer = GANTrainer(
        InfillingGenerator(cfg, device=device),
        MultiscaleDiscriminator(cfg, device=device),
        GANConfig(model_dir=c.model_dir, ckpt_every_steps=c.ckpt_every_steps,
                  seed=c.seed, log_every=c.log_every),
        example_fn=infilling_example(mask))
    pipe = _pipeline(c.data_dir, c.batch_size, c.crop_size, c.seed)
    state = trainer.init()
    ckpt = Checkpointer(f"{c.model_dir}/ckpt")
    resumed = None
    try:
        state, pipe_state = ckpt.restore(state)
        if pipe_state:
            pipe.load_state_dict(pipe_state)
        resumed = {"step": state.step,
                   "digest": digest(state.state_dict())}
        print(f"resumed from step {state.step} at cursor "
              f"{pipe.state_dict()}", flush=True)
    except FileNotFoundError:
        pass
    start = state.step
    before = [digest(list(n.parameters())) for n in (state.gen, state.disc)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = trainer.fit(state, pipe, c.steps, checkpointer=ckpt)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    after = [digest(list(n.parameters())) for n in (state.gen, state.disc)]
    print(f"trained to step {state.step}", flush=True)
    print(json.dumps({
        "step": state.step, "start": start, "fit_s": seconds,
        "ms_per_step": (1e3 * seconds / (state.step - start)
                        if state.step > start else None),
        "img_per_s": ((state.step - start) * c.batch_size / seconds
                      if state.step > start else None),
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if device.type == "cuda" else None),
        "changed": {"gen": before[0] != after[0],
                    "disc": before[1] != after[1]},
        "cursor": pipe.state_dict(), "resumed": resumed,
        "digest": digest(state.state_dict()), **trainer.stats}), flush=True)


def harvest(argv: list[str]) -> None:
    @dataclasses.dataclass
    class HarvestConfig(Config):
        src: str = config_field("", "root of .dm3/.dm4 corpus")
        out: str = config_field("harvested", "output dir")
        shard_index: int = config_field(0, "this host's shard")
        shard_count: int = config_field(1, "total shards")
        size: int = config_field(2048, "output sidelength")
        device: str = config_field("cuda", "cuda, or cpu")

    from emx_torch.data.harvest import census, find_dm_files, reap

    c = HarvestConfig.from_args(argv)
    paths = find_dm_files(c.src)
    print("census:", census(paths), flush=True)
    m = reap(paths, c.out, c.shard_index, c.shard_count, c.size,
             device=c.device)
    print(f"reaped {len(m)} micrographs -> {c.out}", flush=True)


def bench_train(argv: list[str]) -> None:
    """Training-step throughput ladder (emx_torch.bench.train_bench)."""
    from emx_torch.bench.train_bench import LADDER, QUICK, main as run

    run(QUICK if "quick" in argv else LADDER, device=_device(argv))


def serve(argv: list[str]) -> None:
    from emx_torch.serve.server import serve_artifact

    c = ServeConfig.from_args(argv)
    srv = serve_artifact(c.artifact, host=c.host, port=c.port,
                         max_batch=c.max_batch, tile=c.tile,
                         overlap=c.overlap, device=c.device)
    print(f"serving {c.artifact} on {c.host}:{srv.port}", flush=True)
    while True:
        time.sleep(3600)


def quality(argv: list[str]) -> None:
    """Production-width quality anchoring run
    (emx_torch.bench.quality_run)."""
    from emx_torch.bench.quality_run import main as run

    a = _positional(argv)
    run(a[0] if a else "runs/quality",
        int(a[1]) if len(a) > 1 else 2,
        int(a[2]) if len(a) > 2 else 5000,
        int(a[3]) if len(a) > 3 else 8, device=_device(argv))


def quant_check(argv: list[str]) -> None:
    """Quantized-deployment PSNR/throughput check
    (emx_torch.bench.quant_check)."""
    from emx_torch.bench.quant_check import main as run

    a = _positional(argv)
    run(a[0] if a else "docs/runs/flagship/artifact.npz",
        a[1] if len(a) > 1 else "runs/quant_check", device=_device(argv))


def qat_finetune(argv: list[str]) -> None:
    """Quantization-aware finetune of a deployment bundle
    (emx_torch.bench.qat_finetune). `--scope=head|refine|decoder|
    decoder2` selects tail distillation instead of the full-model
    fake-quant finetune."""
    scope = next((x.split("=", 1)[1] for x in argv
                  if x.startswith("--scope=")), None)
    a = _positional(argv)
    art = a[0] if a else "docs/runs/flagship/artifact.npz"
    out = a[1] if len(a) > 1 else "runs/qat"
    steps = int(a[2]) if len(a) > 2 else 3000
    gate = float(a[3]) if len(a) > 3 else None
    if scope:
        from emx_torch.bench.qat_finetune import head_distill

        head_distill(art, out, steps, psnr_gate=gate, scope=scope,
                     device=_device(argv))
    else:
        from emx_torch.bench.qat_finetune import main as run

        run(art, out, steps, psnr_gate=gate, device=_device(argv))


def gan_demo(argv: list[str]) -> None:
    """GAN training-dynamics demonstration (emx_torch.bench.gan_demo)."""
    from emx_torch.bench.gan_demo import main as run

    a = _positional(argv)
    run(a[0] if a else "runs/gan_demo", int(a[1]) if len(a) > 1 else 560,
        device=_device(argv))


def gan_quality(argv: list[str]) -> None:
    """GAN infilling quality anchor (emx_torch.bench.gan_quality)."""
    from emx_torch.bench.gan_quality import main as run

    a = _positional(argv)
    run(a[0] if a else "runs/gan_quality",
        int(a[1]) if len(a) > 1 else 20000, device=_device(argv))


def zoo_ladder(argv: list[str]) -> None:
    """Model-zoo trained-quality ladder (emx_torch.bench.zoo_ladder)."""
    from emx_torch.bench.zoo_ladder import main as run

    a = _positional(argv)
    run(a[0] if a else "runs/zoo_ladder",
        int(a[1]) if len(a) > 1 else 1500,
        float(a[2]) if len(a) > 2 else 0.25, device=_device(argv))


def dqn_autofocus(argv: list[str]) -> None:
    """DQN autofocus training + policy evaluation
    (emx_torch.bench.dqn_run)."""
    from emx_torch.bench.dqn_run import main as run

    a = _positional(argv)
    run(a[0] if a else "runs/dqn_autofocus",
        int(a[1]) if len(a) > 1 else 800, device=_device(argv))


def run_ewrec(argv: list[str]) -> None:
    """Exit-wave reconstruction of a focal series of TIFFs (sorted by the
    digits in their names): align to the middle slice, search the
    defocus step, reconstruct; writes amplitude.tif and phase.tif."""
    @dataclasses.dataclass
    class EwrecConfig(Config):
        stack_dir: str = config_field("", "dir of focal-series TIFFs")
        wavelength: float = config_field(0.025, "electron wavelength (A)")
        num_iter: int = config_field(50, "GS iterations")
        out: str = config_field("ewrec_out", "output dir")
        device: str = config_field("cuda", "cuda, or cpu")

    import numpy as np
    import torch

    from emx_torch.io.tiff import read_tiff, write_tiff
    from emx_torch.recon import EWRECConfig, align_stack, ewrec
    from emx_torch.utils.device import resolve_device

    c = EwrecConfig.from_args(argv)
    paths = sorted(glob.glob(f"{c.stack_dir}/*.tif"),
                   key=lambda p: int("".join(ch for ch in p.split("/")[-1]
                                             if ch.isdigit()) or 0))
    if not paths:
        raise SystemExit(f"no TIFFs in {c.stack_dir}")
    device = resolve_device(c.device)
    stack = torch.stack([torch.from_numpy(read_tiff(p).astype(np.float32))
                         for p in paths]).to(device)
    aligned, _ = align_stack(stack)
    res = ewrec(aligned, EWRECConfig(wavelength=c.wavelength,
                                     num_iter=c.num_iter))
    write_tiff(f"{c.out}/amplitude.tif", res["amplitude"].cpu().numpy())
    write_tiff(f"{c.out}/phase.tif", res["phase"].cpu().numpy())
    dfs = [round(float(d), 2) for d in res["defocuses"].cpu()]
    print(f"defocuses: {dfs}", flush=True)
    print(f"loss: {float(res['loss']):.3e}; wrote {c.out}/amplitude.tif, "
          "phase.tif", flush=True)


COMMANDS = {
    "train-denoiser": train_denoiser,
    "harvest": harvest,
    "bench-train": bench_train,
    "serve": serve,
    "quality": quality,
    "quant-check": quant_check,
    "qat-finetune": qat_finetune,
    "train-infilling": train_infilling,
    "gan-demo": gan_demo,
    "gan-quality": gan_quality,
    "ewrec": run_ewrec,
    "zoo-ladder": zoo_ladder,
    "dqn-autofocus": dqn_autofocus,
}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m emx_torch.cli "
              f"{{{'|'.join(COMMANDS)}}} [--flag=value ...] [--device=cpu]")
        raise SystemExit(2)
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
