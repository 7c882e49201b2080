"""Quantization-aware finetuning of a deployment bundle (port of
emx/bench/qat_finetune.py).

  * `head_distill` (the flagship's recipe, scope 'decoder2'): capture
    the tail's input features from the int8 deployment graph, finetune
    the tail (FoldedHeadTail) with fake-quantized convs against the
    clean targets, write the tail back into the model, recalibrate,
    score the real int8 graph on the five ladders with the DECISION
    policy, and save the candidate bundle;
  * `main`: the whole model fake-quantized, trained toward the clean
    targets ('clean') or toward the float model's own output ('float',
    self-distillation), optionally only its last `trainable_last_n`
    convs; promotion behind `psnr_gate`.

Each step draws a batch from the corpus and degrades it on the fused
Poisson kernel (one launch per step), seeded by (1234, step).

Where the port meets optax: `optax.adam(lr)` is b1 0.9, b2 0.999 and eps
1e-8 added after the square root of the bias-corrected second moment,
no weight decay; `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`
computes the same update, lr * m_hat / (sqrt(v_hat) + eps).

Port additions to emx's API: `corpus_size` (emx's 1024 by default),
`log_every` (emx's 200) and `device`; and two keys in the record,
`tail_int8_psnr` (head_distill: the fake-quant tail against the int8
graph on the first batch, before and after training) and
`fq_int8_psnr` (main: the fake-quant model against the int8 graph on the
calibration slice, before the first step). Candidates and records go to
`out_dir` (runs/qat by default), never beside the source bundle.

Usage: python -m emx_torch.bench.qat_finetune <artifact.npz> [out_dir]
           [steps] [batch] [lr] [psnr_gate] [head|tail|decoder|decoder2
           [corpus] | float [clean_weight] | trainable_last_n]
"""

from __future__ import annotations

import os
import sys
import time

import torch

from emx_torch.bench import flagship_decision
from emx_torch.bench.flagship_decision import (all_ladders,
                                               capped_margin_sum,
                                               family_rows)
from emx_torch.bench.ladders import mean_psnr, ood_ladder, val_ladder
from emx_torch.bench.quant_check import (deployment_model, float_apply,
                                         incumbent_psnr, write_record)
from emx_torch.data.degrade import denoiser_example
from emx_torch.data.pipeline import mixed_micrographs, synthetic_micrographs
from emx_torch.nn.denoiser import Denoiser, FoldedHeadTail, tail_param_names
from emx_torch.serve.artifact import save_denoiser_artifact
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.serve.quantize import (calibrate, fake_quant_apply,
                                      quantized_apply)
from emx_torch.train.losses import huberised_mse
from emx_torch.utils.device import resolve_device
from emx_torch.utils.image import psnr
from emx_torch.utils.rng import fold_in

STEP_SEED = 1234
_RECORDS = {"head": "qat_head.json", "refine": "qat_tail.json",
            "decoder": "qat_tail_decoder.json",
            "decoder2": "qat_tail_decoder2.json"}


def adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr)'s update (see the module docstring)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def training_corpus(corpus: str, n: int, size: int,
                    device: torch.device) -> torch.Tensor:
    """The corpus the bundle was trained on: 'synthetic', 'mixed'
    (synthetic, ctf, grains) or 'mixed3' (and filaments), seed 0."""
    if corpus in ("mixed", "mixed3"):
        imgs = mixed_micrographs(n, size, seed=0,
                                 filaments=corpus == "mixed3", device=device)
    elif corpus == "synthetic":
        imgs = synthetic_micrographs(n, size, seed=0)
    else:
        raise ValueError(f"unknown corpus {corpus!r}")
    return torch.from_numpy(imgs).to(device)


def make_batch(corpus: torch.Tensor, batch: int, seed: int):
    """(noisy, target) of `batch` images drawn from `corpus` with
    replacement, degraded by denoiser_example (one K2 launch)."""
    gen = torch.Generator(device=corpus.device)
    gen.manual_seed(fold_in(seed, 0))
    idx = torch.randint(0, corpus.shape[0], (batch,), generator=gen,
                        device=corpus.device)
    return denoiser_example(fold_in(seed, 1), corpus.index_select(0, idx))


def capture_points(order: list[str], mapping: dict[str, str],
                   scope: str):
    """The conv path(s) whose input the tail takes: the tail's first
    conv; for 'decoder2' also the second decoder stage's first conv,
    whose input carries encoder tap 0."""
    if scope == "decoder2":
        inv = {v: k for k, v in mapping.items()}
        return tuple(next(p for p in order if p.split("/")[0] == inv[name])
                     for name in ("SepConvBlock_0", "SepConvBlock_2"))
    return next(p for p in order if p.split("/")[0] in mapping)


def tail_inputs(captured, lq: torch.Tensor, scope: str, f2: int):
    """The tail's input from the int8 graph's captured features and the
    network input. For 'decoder2' the second capture's first f2 channels
    are the tail's own DeconvBlock output, recomputed by the tail; the
    rest is encoder tap 0. Captures are copied out of inference mode so
    autograd may save them."""
    if scope == "decoder2":
        cat1, cat2 = captured
        return (cat1.clone(), cat2[..., f2:].clone(), lq)
    captured = captured.clone()
    return captured if scope == "head" else (captured, lq)


def _split(flat: dict, mapping: dict[str, str]) -> dict:
    """Flat params of the modules in `mapping`, renamed by it."""
    out = {}
    for key, v in flat.items():
        top, _, rest = key.partition("/")
        if top in mapping:
            out[f"{mapping[top]}/{rest}"] = v
    return out


def tail_module(cfg, flat: dict, mapping: dict[str, str], scope: str,
                device: torch.device) -> FoldedHeadTail:
    """FoldedHeadTail holding the mapped modules' float32 parameters,
    trainable."""
    tail = load_flax_params(FoldedHeadTail(cfg, scope, device="cpu"),
                            _split(flat, mapping))
    return tail.to(device)


def write_back(flat: dict, tail: FoldedHeadTail,
               mapping: dict[str, str]) -> dict:
    """The full model's flat params with the tail's in place."""
    new = dict(flat)
    for key, v in _split(to_flax_params(tail)[0],
                         {t: f for f, t in mapping.items()}).items():
        if key not in new:
            raise KeyError(f"the tail's {key!r} has no place in the model")
        new[key] = v
    return new


class TailDistiller:
    """head_distill's training setup: the tail of `model` (scope
    `scope`) as a FoldedHeadTail holding the bundle's parameters, the
    int8 graph that captures its input, the fake-quant tail calibrated
    on the first batch (`lq0`, seed 0) and Adam over the tail."""

    def __init__(self, cfg, flat: dict, model: torch.nn.Module, amax: dict,
                 order: list[str], scope: str, mode: str,
                 corpus: torch.Tensor, batch: int, lr: float):
        self.scope, self.f2 = scope, cfg.features[2]
        self.corpus, self.batch = corpus, batch
        self.mapping = tail_param_names(order, cfg.folded_head_depth,
                                        scope=scope)
        self.caps = capture_points(order, self.mapping, scope)
        self.capture_fn = quantized_apply(model, amax, mode,
                                          capture=self.caps)
        self.tail = tail_module(cfg, flat, self.mapping, scope, corpus.device)
        self.lq0, _ = make_batch(corpus, batch, 0)
        cat0 = self.inputs(self.capture_fn(self.lq0)[1], self.lq0)
        self.fq_tail = fake_quant_apply(self.tail, calibrate(self.tail,
                                                             [cat0]), mode)
        self.opt = adam(self.tail.parameters(), lr)

    def inputs(self, captured, lq: torch.Tensor):
        return tail_inputs(captured, lq, self.scope, self.f2)

    def agreement(self, graph_out: torch.Tensor, captured) -> float:
        """PSNR of the fake-quant tail on `captured` (an int8 graph's
        capture of `lq0`) against that graph's output."""
        with torch.no_grad():
            out = self.fq_tail(self.tail, self.inputs(captured, self.lq0))
        return _agreement(out, graph_out)

    def step(self, seed: int) -> torch.Tensor:
        """One step on a batch drawn with `seed`; returns the loss."""
        lq, tgt = make_batch(self.corpus, self.batch, seed)
        cat = self.inputs(self.capture_fn(lq)[1], lq)
        loss = huberised_mse(self.fq_tail(self.tail, cat).float(), tgt)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()


def _agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return round(float(psnr(a.detach().float(), b.float())), 3)


def _stage(t_start: float, msg: str) -> None:
    print(f"[stage +{time.perf_counter() - t_start:8.1f}s] {msg}",
          flush=True)


def _rate(fn, device: torch.device):
    """img/s at batch 96 on the card; None (not measured) on the CPU."""
    if device.type != "cuda":
        return None
    return round(flagship_decision.throughput(fn, device), 1)


def main(artifact: str, out_dir: str = "runs/qat", steps: int = 3000,
         batch: int = 16, lr: float = 2e-5, psnr_gate: float | None = None,
         mode: str = "mxu", trainable_last_n: int | None = None,
         target: str = "clean", clean_weight: float = 0.0,
         corpus_size: int = 1024, log_every: int = 200,
         device: str | torch.device = "cuda") -> dict:
    """Full-model fake-quant finetune. `target` 'clean': huberised MSE
    against the degradation's ground truth; 'float': self-distillation
    toward the float model's output on the same batch (its minimum, no
    quantization error, is what serving wants), `clean_weight` mixing
    the clean loss back in."""
    if target not in ("clean", "float"):
        raise ValueError(f"target must be 'clean' or 'float', not {target!r}")
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg, flat, model = deployment_model(artifact, device)
    noisy, clean = val_ladder(device)
    out: dict = {"metric": "qat_finetune", "artifact": artifact,
                 "mode": mode, "steps": steps, "batch": batch, "lr": lr,
                 "target": target, "clean_weight": clean_weight}
    out["float_psnr"] = mean_psnr(float_apply(model)(noisy), clean)
    amax, conv_order = calibrate(model, [noisy[:8]], return_order=True)
    ptq = quantized_apply(model, amax, mode)
    out["ptq_psnr"] = mean_psnr(ptq(noisy), clean)

    train_imgs = training_corpus("synthetic", corpus_size, noisy.shape[-1],
                                 device)
    student = load_flax_params(Denoiser(cfg, device="cpu"), flat).to(device)
    fq = fake_quant_apply(student, amax, mode=mode)
    trainable = list(student.parameters())
    if trainable_last_n:
        # Only the last n convs' modules, in execution order.
        tops = [p.split("/")[0] for p in conv_order]
        train_tops = sorted(set(tops[-trainable_last_n:]))
        out["trainable_tops"] = train_tops
        student.requires_grad_(False)
        trainable = []
        for top in train_tops:
            student.get_submodule(top).requires_grad_(True)
            trainable += list(student.get_submodule(top).parameters())
    opt = adam(trainable, lr)
    with torch.no_grad():
        out["fq_int8_psnr"] = _agreement(fq(student, noisy[:8]),
                                         ptq(noisy[:8]))

    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        lq, tgt = make_batch(train_imgs, batch, fold_in(STEP_SEED, i))
        pred = fq(student, lq).float()
        if target == "float":
            with torch.no_grad():
                tgt_f = model(lq).float()
            loss = huberised_mse(pred, tgt_f)
            if clean_weight:
                loss = loss + clean_weight * huberised_mse(pred, tgt)
        else:
            loss = huberised_mse(pred, tgt)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if (i + 1) % log_every == 0:
            losses.append(round(float(loss.detach()), 5))
    out["train_s"] = round(time.perf_counter() - t0, 1)
    out["loss_trace"] = losses

    # Recalibrate on the finetuned weights, score the real int8 graph.
    student.eval().requires_grad_(False)
    new_flat = to_flax_params(student)[0]
    amax2 = calibrate(student, [noisy[:8]])
    qfn = quantized_apply(student, amax2, mode)
    out["qat_psnr"] = mean_psnr(qfn(noisy), clean)
    out["qat_float_psnr"] = mean_psnr(float_apply(student)(noisy), clean)
    out["qat_img_per_s"] = _rate(qfn, device)

    if psnr_gate is not None:
        out["psnr_gate"] = psnr_gate
        out["incumbent_psnr"] = incumbent_psnr()
        promoted = out["qat_psnr"] > max(out["ptq_psnr"], psnr_gate,
                                         out["incumbent_psnr"])
        out["gate_passed"] = out["promoted"] = promoted
        if promoted:
            dest = os.path.join(out_dir, "bundle.npz")
            save_denoiser_artifact(dest, cfg, {"params": new_flat}, quant={
                "mode": mode, "amax": amax2, "psnr": out["qat_psnr"],
                "float_psnr": out["qat_float_psnr"],
                "psnr_gate": psnr_gate,
                "qat": {"kind": target, "steps": steps,
                        "clean_weight": clean_weight},
                "img_per_s_at_check": out["qat_img_per_s"]})
            out["promoted_artifact"] = dest
    name = "qat.json" if target == "clean" else f"qat_{target}.json"
    return write_record(out, out_dir, name)


def head_distill(artifact: str, out_dir: str = "runs/qat",
                 steps: int = 4000, batch: int = 16, lr: float = 1e-4,
                 psnr_gate: float | None = None, mode: str = "mxu",
                 scope: str = "head", corpus: str = "synthetic",
                 corpus_size: int = 1024, log_every: int = 200,
                 device: str | torch.device = "cuda") -> dict:
    """Tail distillation: train FoldedHeadTail alone on features
    captured from the int8 deployment graph, with fake-quantized convs,
    against the clean targets; the tail learns to correct the body's
    quantization error. `scope` ('head', 'refine', 'decoder',
    'decoder2') sets how deep the tail reaches. `corpus` 'synthetic',
    'mixed' or 'mixed3'. The candidate is scored on the five ladders
    with the DECISION policy and saved as `out_dir`/bundle.npz."""
    t_start = time.perf_counter()
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg, flat, model = deployment_model(artifact, device)
    noisy, clean = val_ladder(device)
    _stage(t_start, "ladder built")

    out: dict = {"metric": "qat_head_distill", "artifact": artifact,
                 "mode": mode, "steps": steps, "batch": batch, "lr": lr,
                 "scope": scope, "corpus": corpus}
    out["float_psnr"] = mean_psnr(float_apply(model)(noisy), clean)
    _stage(t_start, f"float psnr {out['float_psnr']}")
    amax, order = calibrate(model, [noisy[:8]], return_order=True)
    out["ptq_psnr"] = mean_psnr(quantized_apply(model, amax, mode)(noisy),
                                clean)
    _stage(t_start, f"ptq psnr {out['ptq_psnr']}")

    train_imgs = training_corpus(corpus, corpus_size, noisy.shape[-1],
                                 device)
    _stage(t_start, f"corpus resident {tuple(train_imgs.shape)}")
    d = TailDistiller(cfg, flat, model, amax, order, scope, mode,
                      train_imgs, batch, lr)
    out["head_modules"] = sorted(d.mapping)
    before = d.agreement(*d.capture_fn(d.lq0))
    _stage(t_start, f"tail calibrated; fake-quant tail against the int8 "
           f"graph {before} dB")

    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        loss = d.step(fold_in(STEP_SEED, i))
        if (i + 1) % log_every == 0:
            losses.append(round(float(loss), 5))
    out["train_s"] = round(time.perf_counter() - t0, 1)
    out["loss_trace"] = losses

    d.tail.eval().requires_grad_(False)
    new_flat = write_back(flat, d.tail, d.mapping)
    new_model = load_flax_params(Denoiser(cfg, device="cpu"), new_flat)
    new_model = new_model.to(device).eval().requires_grad_(False)
    amax2 = calibrate(new_model, [noisy[:8]])
    qfn = quantized_apply(new_model, amax2, mode)
    out["qat_psnr"] = mean_psnr(qfn(noisy), clean)
    out["qat_float_psnr"] = mean_psnr(float_apply(new_model)(noisy), clean)
    after = d.agreement(*quantized_apply(new_model, amax2, mode,
                                         capture=d.caps)(d.lq0))
    out["tail_int8_psnr"] = {"before": before, "after": after}
    out["qat_img_per_s"] = _rate(qfn, device)
    _stage(t_start, f"qat psnr {out['qat_psnr']}; tail against the "
           f"written-back int8 graph {after} dB")

    # The candidate on the full decision policy: every family, the
    # capped margin sum.
    fams = family_rows(qfn, all_ladders(device))
    out["families"] = fams
    out["capped_margin_sum"] = capped_margin_sum(fams)
    out["ood_psnr"] = fams["ood_ctf"]["nn_psnr"]
    ood_noisy, ood_clean = ood_ladder("ctf", device)
    out["ood_psnr_before"] = mean_psnr(
        quantized_apply(model, amax, mode)(ood_noisy), ood_clean)

    if psnr_gate is not None:
        # Gated against the shipped flagship's val PSNR; promotion itself
        # is the decision policy's (flagship_decision), never done here.
        out["psnr_gate"] = psnr_gate
        out["incumbent_psnr"] = incumbent_psnr()
        out["gate_passed"] = out["promoted"] = (
            out["qat_psnr"] > max(out["ptq_psnr"], psnr_gate,
                                  out["incumbent_psnr"]))
    cand = os.path.join(out_dir, "bundle.npz")
    save_denoiser_artifact(cand, cfg, {"params": new_flat}, quant={
        "mode": mode, "amax": amax2, "psnr": out["qat_psnr"],
        "float_psnr": out["qat_float_psnr"],
        "ood_psnr": out["ood_psnr"],
        "capped_margin_sum": out["capped_margin_sum"],
        "psnr_gate": psnr_gate,
        "img_per_s_at_check": out["qat_img_per_s"],
        "qat": {"kind": "tail_distill" if scope != "head" else "head_distill",
                "scope": scope, "corpus": corpus, "steps": steps,
                "head_modules": sorted(d.mapping)}})
    out["candidate_bundle"] = cand
    return write_record(out, out_dir, _RECORDS[scope])


if __name__ == "__main__":
    a = sys.argv[1:]
    kw = dict(
        out_dir=a[1] if len(a) > 1 else "runs/qat",
        steps=int(a[2]) if len(a) > 2 else 3000,
        batch=int(a[3]) if len(a) > 3 else 16,
        lr=float(a[4]) if len(a) > 4 else 2e-5,
        psnr_gate=float(a[5]) if len(a) > 5 else None,
    )
    art = a[0] if a else "docs/runs/flagship/artifact.npz"
    sel = a[6] if len(a) > 6 else None
    scopes = {"head": "head", "tail": "refine", "decoder": "decoder",
              "decoder2": "decoder2"}
    if sel in scopes:
        head_distill(art, scope=scopes[sel],
                     corpus=a[7] if len(a) > 7 else "synthetic", **kw)
    elif sel == "float":
        main(art, target="float",
             clean_weight=float(a[7]) if len(a) > 7 else 0.0, **kw)
    else:
        main(art, trainable_last_n=int(sel) if sel else None, **kw)
