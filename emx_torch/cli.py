"""Command-line entry points (port of emx/cli.py): emx's command names,
flags and argument order, and one more flag, `--device=` (cuda by
default; cpu runs a command on the CPU).

  python -m emx_torch.cli quality <out_dir> [s2d] [steps] [batch]
  python -m emx_torch.cli qat-finetune <artifact.npz> [out_dir] [steps]
      [psnr_gate] [--scope=head|refine|decoder|decoder2]
  python -m emx_torch.cli quant-check <artifact.npz> [out_dir]
  python -m emx_torch.cli serve --artifact=... --port=8501

The other commands of emx's raise NotImplementedError naming the
ROADMAP.md Queue 1 item that ports them.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class InfillingCLIConfig(Config):
    data_dir: str = config_field("", "dir of float32 TIFF crops ('' = synthetic)")
    model_dir: str = config_field("runs/infilling", "checkpoint/log dir")
    batch_size: int = config_field(4, "global batch")
    crop_size: int = config_field(512, "crop sidelength")
    steps: int = config_field(700_000, "train steps (reference hard stop)")
    coverage: int = config_field(64, "1/coverage of pixels scanned")
    seed: int = config_field(0, "seed")


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


def _unported(name: str, item: int):
    def command(argv: list[str]) -> None:
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md "
                                  f"Queue 1 item {item})")
    return command


# ROADMAP.md Queue 1 item that ports each command not ported yet.
_QUEUE_ITEM = {"train-denoiser": 1, "train-infilling": 4, "harvest": 1,
               "ewrec": 4, "bench-train": 8, "gan-demo": 8,
               "gan-quality": 8, "zoo-ladder": 8, "dqn-autofocus": 8}
COMMANDS = {
    **{name: _unported(name, item) for name, item in _QUEUE_ITEM.items()},
    "serve": serve,
    "quality": quality,
    "quant-check": quant_check,
    "qat-finetune": qat_finetune,
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
