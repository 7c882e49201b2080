"""Flagship low-dose micrograph denoiser (port of emx/nn/denoiser.py).

Space-to-depth, a DeepLabv3+ separable encoder, Xception middle
blocks, a separable ASPP, two decoder stages, a body-resolution
refinement, an optional folded-space head, and a clip to [0, 1].
Children are created in the order flax calls them and carry flax's
names, so each module's `path` is its flax parameter path.

Every head of emx's is here: plain, folded, mid-resolution,
kernel-prediction and full-resolution. `FoldedHeadTail` is the tail of
the folded-head model as a module of its own, for tail distillation
(emx_torch.bench.qat_finetune), and `tail_param_names` maps the full
model's names to its. `forward(x, train=True)` trains (BatchNorm on
batch statistics), with the middle blocks rematerialised under
`remat_middle`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from emx_torch.nn.blocks import (ASPP, BatchNorm, ConvBlock, DeconvBlock,
                                 Named, SepConvBlock, XceptionMiddleBlock,
                                 _resize_bilinear)
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    features: tuple[int, ...] = (64, 128, 256, 728, 728)
    num_middle_blocks: int = 11
    aspp_filters: int = 728
    aspp_out: int = 256
    aspp_rates: tuple[int, ...] = (6, 12, 18)
    norm: str = "group"
    axis_name: str | None = None
    aspp_separable: bool = True
    upsample: str = "transpose"
    space_to_depth: int = 2
    dtype: torch.dtype = torch.float32
    remat_middle: bool = False
    full_res_head: int = 0
    mid_res_head: int = 0
    mid_res_factor: int = 2
    mid_res_depth: int = 2
    kernel_pred_head: int = 0
    kernel_pred_sigmas: tuple[float, ...] = (1.0, 2.0, 4.0)
    folded_head: int = 0
    folded_head_depth: int = 2
    out_dtype: str = "float32"

    def scaled(self, scale: float) -> "DenoiserConfig":
        """Every width times `scale`, at least 8 (emx's scaled)."""
        return dataclasses.replace(
            self,
            features=tuple(max(8, int(f * scale)) for f in self.features),
            aspp_filters=max(8, int(self.aspp_filters * scale)),
            aspp_out=max(8, int(self.aspp_out * scale)),
        )

    @classmethod
    def tiny(cls) -> "DenoiserConfig":
        return cls(features=(8, 12, 16, 24, 24), num_middle_blocks=1,
                   aspp_filters=16, aspp_out=16)


def _space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """Fold f x f spatial blocks into channels (NHWC)."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // f, f, ww // f, f, c)
    return torch.movedim(x, 2, 4).reshape(b, hh // f, ww // f, f * f * c)


def _depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Unfold channels into f x f spatial blocks (NHWC)."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh, ww, f, f, c // (f * f))
    return torch.movedim(x, 3, 2).reshape(b, hh * f, ww * f, c // (f * f))


def _gaussian_blur_nhwc(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an NHWC (C=1) tensor, zero padding,
    in the tensor's dtype (emx's kernel-prediction basis)."""
    radius = max(1, int(3.0 * sigma))
    t = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = (k / torch.sum(k)).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), k.view(1, 1, -1, 1),
                 padding=(radius, 0))
    y = F.conv2d(y, k.view(1, 1, 1, -1), padding=(0, radius))
    return y.permute(0, 2, 3, 1).contiguous()


_OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _FlaxNamed(Named):
    """Children registered under flax's names, and the decoder,
    refinement and folded-head stages that Denoiser and FoldedHeadTail
    share."""

    def __init__(self, config: DenoiserConfig):
        super().__init__()
        self.config = config
        self._kw = dict(norm=config.norm, dtype=config.dtype)

    def _decoder_stage(self, cin: int, width: int) -> tuple[str, ...]:
        cfg, kw = self.config, self._kw
        return (self._add(SepConvBlock(cin, width, **kw)),
                self._add(SepConvBlock(width, width, **kw)),
                self._add(ConvBlock(cin, width, kernel=1, **kw)),
                self._add(DeconvBlock(width, width, norm=cfg.norm,
                                      mode=cfg.upsample, dtype=cfg.dtype)))

    def _run_decoder(self, names, cat: torch.Tensor,
                     train: bool) -> torch.Tensor:
        m = self._modules
        sep_a, sep_b, skip, deconv = names
        d = m[sep_b](m[sep_a](cat, train), train) + m[skip](cat, train)
        return m[deconv](d, train)

    def _refine_stage(self, cin: int) -> tuple[str, ...]:
        f0, kw = self.config.features[0], self._kw
        return (self._add(SepConvBlock(cin, f0, **kw)),
                self._add(SepConvBlock(f0, f0, **kw)),
                self._add(ConvBlock(cin, f0, kernel=1, **kw)))

    def _run_refine(self, names, h: torch.Tensor,
                    train: bool) -> torch.Tensor:
        m = self._modules
        sep_a, sep_b, skip = names
        return m[sep_b](m[sep_a](h, train), train) + m[skip](h, train)

    def _folded_stage(self, cin: int):
        cfg, kw = self.config, self._kw
        seps, r = [], cin
        for _ in range(cfg.folded_head_depth):
            seps.append(self._add(SepConvBlock(r, cfg.folded_head, **kw)))
            r = cfg.folded_head
        return seps, self._add(ConvBlock(cin, cfg.folded_head, kernel=1,
                                         **kw))

    def _run_folded(self, stage, cat: torch.Tensor,
                    train: bool) -> torch.Tensor:
        m = self._modules
        seps, skip = stage
        r = cat
        for name in seps:
            r = m[name](r, train)
        return r + m[skip](cat, train)

    def _finish(self, device: torch.device) -> None:
        """Give every module its flax path and move to `device`."""
        for name, mod in self.named_modules():
            if hasattr(mod, "path"):
                mod.path = name.replace(".", "/")
        self.to(device)


class Denoiser(_FlaxNamed):
    def __init__(self, config: DenoiserConfig = DenoiserConfig(),
                 device: str | torch.device = "cuda"):
        """Parameters start at zero: emx_torch.serve.convert fills them
        from a bundle, emx_torch.nn.init.init_parameters from a seed."""
        super().__init__(config)
        device = resolve_device(device)
        cfg, kw = config, self._kw
        f = cfg.features
        s2d = cfg.space_to_depth
        c = s2d * s2d
        self._encoder = []
        taps = []
        for i in range(4):
            run, emit = f[i], (f[1] if i == 0 else f[i])
            self._encoder.append((
                self._add(SepConvBlock(c, run, **kw)),
                self._add(SepConvBlock(run, run, **kw)),
                self._add(SepConvBlock(run, emit, strides=2, **kw)),
                self._add(ConvBlock(c, emit, kernel=1, strides=2, **kw)),
            ))
            c = emit
            taps.append(c)
        self._block4 = [self._add(SepConvBlock(c, f[4], **kw)),
                        self._add(SepConvBlock(f[4], f[4], **kw)),
                        self._add(SepConvBlock(f[4], f[4], **kw))]
        self._middle = []
        for i in range(cfg.num_middle_blocks):
            name = f"XceptionMiddleBlock_{i}"
            self.add_module(name, XceptionMiddleBlock(f[4], **kw))
            self._middle.append(name)
        self._aspp = self._add(ASPP(f[4], cfg.aspp_filters, cfg.aspp_out,
                                    cfg.aspp_rates,
                                    separable=cfg.aspp_separable, **kw))
        c = cfg.aspp_out
        self._decoder = []
        for width, tap in ((f[2], taps[1]), (f[1], taps[0])):
            self._decoder.append(self._decoder_stage(c + tap, width))
            c = width
        self._refine = self._refine_stage(c)
        c = f[0]
        self._folded = None
        if cfg.folded_head and s2d > 1:
            self._folded = self._folded_stage(c + s2d * s2d)
            c = cfg.folded_head
        self._build_heads(c)
        self._finish(device)

    def _build_heads(self, c: int) -> None:
        """The output stage after the body (and folded head), in flax's
        call order: a mid-resolution head, a kernel-prediction head or
        the plain head conv; then the full-resolution refinement."""
        cfg, kw = self.config, self._kw
        s2d = cfg.space_to_depth
        frh, mrh = cfg.full_res_head, cfg.mid_res_head
        head_ch = frh if frh else 1
        self._mid = self._kpn = self._head = self._full = None
        if mrh and s2d > 1:
            m = min(cfg.mid_res_factor, s2d)
            rem = s2d // m
            up = self._add(ConvBlock(c, m * m * mrh, kernel=3, **kw))
            cin = mrh + rem * rem
            seps, r = [], cin
            for _ in range(cfg.mid_res_depth):
                seps.append(self._add(SepConvBlock(r, mrh, **kw)))
                r = mrh
            skip = self._add(ConvBlock(cin, mrh, kernel=1, **kw))
            out = self._add(ConvBlock(mrh, rem * rem * head_ch, kernel=3,
                                      **kw))
            self._mid = (m, rem, up, (seps, skip), out)
            out_ch = head_ch
        elif cfg.kernel_pred_head and s2d > 1:
            sigmas = tuple(cfg.kernel_pred_sigmas[:cfg.kernel_pred_head])
            n_basis = 2 + len(sigmas)
            self._kpn = (sigmas, self._add(ConvBlock(
                c, s2d * s2d * (1 + n_basis), kernel=3, **kw)))
            out_ch = 1
        else:
            self._head = self._add(ConvBlock(c, s2d * s2d * head_ch,
                                             kernel=3, **kw))
            out_ch = head_ch
        if frh:
            self._full = (self._add(SepConvBlock(out_ch + 1, frh, **kw)),
                          self._add(ConvBlock(frh, 1, kernel=3, **kw)))

    def _middle_block(self, name: str, h: torch.Tensor,
                      train: bool) -> torch.Tensor:
        """One Xception middle block; with `remat_middle` in training its
        activations are recomputed in the backward pass (flax nn.remat).
        The recomputation runs with the block's BatchNorm updates off, so
        the running statistics move once per step, as under flax."""
        block = self._modules[name]
        if not (self.config.remat_middle and train
                and torch.is_grad_enabled()):
            return block(h, train)
        # The model draws no random numbers, so the RNG state is not
        # saved: reading it would not survive CUDA graph capture.
        return checkpoint(block, h, train, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _frozen_stats(block)))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W) or (B, H, W, 1) input -> prediction of that shape,
        clipped to [0, 1] in `out_dtype`. `train` normalises BatchNorm by
        the batch's statistics and updates the running ones, as flax's
        `train=True` with `mutable=["batch_stats"]` does."""
        cfg = self.config
        m = self._modules
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        x = x.to(cfg.dtype)
        x_in = x
        s2d = cfg.space_to_depth
        if s2d > 1:
            x = _space_to_depth(x, s2d)

        taps = []
        h = x
        for sep_a, sep_b, down, res in self._encoder:
            a = m[sep_b](m[sep_a](h, train), train)
            h = m[down](a, train) + m[res](h, train)
            taps.append(h)
        a = h
        for name in self._block4:
            a = m[name](a, train)
        h = a + h
        for name in self._middle:
            h = self._middle_block(name, h, train)
        h = m[self._aspp](h, train)

        h = _resize_bilinear(h, (h.shape[1] * 4, h.shape[2] * 4))
        h = h.to(cfg.dtype)
        for stage, tap in zip(self._decoder, (taps[1], taps[0])):
            h = self._run_decoder(stage, torch.cat([h, tap], dim=-1), train)

        d = self._run_refine(self._refine, h, train)
        if self._folded is not None:
            cat = torch.cat([d, _space_to_depth(x_in, s2d)], dim=-1)
            d = self._run_folded(self._folded, cat, train)
        out = self._run_heads(d, x_in, train)
        out = torch.clamp(out.to(_OUT_DTYPES[cfg.out_dtype]), 0.0, 1.0)
        return out[..., 0] if squeeze else out

    def _run_heads(self, d: torch.Tensor, x_in: torch.Tensor,
                   train: bool) -> torch.Tensor:
        cfg = self.config
        m = self._modules
        s2d = cfg.space_to_depth
        if self._mid is not None:
            # Unfold by the mid factor, refine beside the (rem-folded)
            # raw input, then predict the remaining rem x rem block.
            f, rem, up, stage, head = self._mid
            out = _depth_to_space(m[up](d, train), f)
            x_mid = _space_to_depth(x_in, rem) if rem > 1 else x_in
            r = self._run_folded(stage, torch.cat([out, x_mid], dim=-1),
                                 train)
            out = m[head](r, train)
            if rem > 1:
                out = _depth_to_space(out, rem)
        elif self._kpn is not None:
            # Per output pixel: a body value v and softmax weights over
            # the basis {v, x, blur_sigma(x) ...}.
            sigmas, name = self._kpn
            out = _depth_to_space(m[name](d, train), s2d)
            basis = torch.cat(
                [out[..., :1].float(), x_in.float()]
                + [_gaussian_blur_nhwc(x_in, s).float() for s in sigmas],
                dim=-1)
            w = torch.softmax(out[..., 1:].float(), dim=-1)
            out = torch.sum(w * basis, dim=-1, keepdim=True).to(cfg.dtype)
        else:
            out = m[self._head](d, train)
            if s2d > 1:
                out = _depth_to_space(out, s2d)
        if self._full is not None:
            sep, conv = self._full
            r = m[sep](torch.cat([out, x_in], dim=-1), train)
            out = m[conv](out + r, train)
        return out


TAIL_SCOPES = ("head", "refine", "decoder", "decoder2")


class FoldedHeadTail(_FlaxNamed):
    """The tail of `Denoiser` as a module of its own (emx's
    FoldedHeadTail); needs folded_head on and the other heads off.

    `tail_scope` sets how deep the tail reaches, and its input:
      * 'head': the folded head and the output conv; input the concat
        [body features, folded raw input] that feeds the first head conv;
      * 'refine': also the body-resolution refinement; input (h, x_raw),
        h before the refinement, x_raw the (B, H, W) network input;
      * 'decoder': also the second decoder stage; input (cat2, x_raw),
        cat2 the concat [decoder features, encoder tap 0] feeding it;
      * 'decoder2': the whole decoder; input (cat1, tap0, x_raw), cat1
        the concat feeding the first decoder stage, tap0 the encoder tap
        that the second stage concatenates.
    Blocks are created in Denoiser's call order, so `tail_param_names`
    maps parameters one to one. The output is float32 (B, H, W)."""

    def __init__(self, config: DenoiserConfig, tail_scope: str = "head",
                 device: str | torch.device = "cuda"):
        super().__init__(config)
        device = resolve_device(device)
        cfg = config
        if not cfg.folded_head or cfg.mid_res_head or cfg.full_res_head \
                or cfg.kernel_pred_head:
            raise ValueError("FoldedHeadTail needs folded_head and no "
                             "other head")
        if tail_scope not in TAIL_SCOPES:
            raise ValueError(f"tail_scope {tail_scope!r} is not one of "
                             f"{TAIL_SCOPES}")
        self.tail_scope = tail_scope
        f, s2d = cfg.features, cfg.space_to_depth
        tap = f[1]                  # encoder taps 0 and 1 both emit f[1]
        self._decoder = []
        if tail_scope == "decoder2":
            self._decoder.append(self._decoder_stage(cfg.aspp_out + tap,
                                                     f[2]))
        if tail_scope in ("decoder", "decoder2"):
            self._decoder.append(self._decoder_stage(f[2] + tap, f[1]))
        self._refine = (self._refine_stage(f[1])
                        if tail_scope != "head" else None)
        self._folded = self._folded_stage(f[0] + s2d * s2d)
        self._head = self._add(ConvBlock(cfg.folded_head, s2d * s2d,
                                         kernel=3, **self._kw))
        self._finish(device)

    def forward(self, inputs, train: bool = False) -> torch.Tensor:
        cfg = self.config
        dt, s2d, scope = cfg.dtype, cfg.space_to_depth, self.tail_scope
        if scope == "decoder2":
            cat1, tap0, x_raw = inputs
            h = self._run_decoder(self._decoder[0], cat1.to(dt), train)
            cat2 = torch.cat([h, tap0.to(dt)], dim=-1)
        elif scope == "decoder":
            cat2, x_raw = inputs
            cat2 = cat2.to(dt)
        elif scope == "refine":
            h, x_raw = inputs
            h = h.to(dt)
        if scope in ("decoder", "decoder2"):
            h = self._run_decoder(self._decoder[-1], cat2, train)
        if scope == "head":
            cat = inputs.to(dt)
        else:
            d = self._run_refine(self._refine, h, train)
            x_in = x_raw[..., None].to(dt)
            cat = torch.cat([d, _space_to_depth(x_in, s2d)], dim=-1)
        d = self._run_folded(self._folded, cat, train)
        out = self._modules[self._head](d, train)
        if s2d > 1:
            out = _depth_to_space(out, s2d)
        return torch.clamp(out.float(), 0.0, 1.0)[..., 0]


def tail_param_names(conv_order: list[str], depth: int,
                     scope: str = "head") -> dict[str, str]:
    """Map full-Denoiser top-level module names -> FoldedHeadTail names.

    `conv_order` is calibrate(return_order=True)'s execution-ordered conv
    paths; the tail is its last N distinct top-level conv-bearing
    modules: N = depth+2 ('head': depth SepConvBlocks, the 1x1 skip
    ConvBlock, the output ConvBlock), depth+5 ('refine': plus the two
    f[0] SepConvBlocks and their 1x1 skip), depth+8 ('decoder': plus the
    two f[1] SepConvBlocks and their 1x1 skip) or depth+11 ('decoder2':
    plus the first decoder stage's three). A DeconvBlock holds a
    transposed conv, which calibrate does not see; its names follow the
    convention that the highest-numbered DeconvBlock is the second
    decoder stage's. FoldedHeadTail creates blocks in the order Denoiser
    runs them, so renumbering in order is exact."""
    n_sep = depth + {"head": 0, "refine": 2, "decoder": 4,
                     "decoder2": 6}[scope]
    n_conv = {"head": 2, "refine": 3, "decoder": 4, "decoder2": 5}[scope]
    uniq = list(dict.fromkeys(p.split("/")[0] for p in conv_order))
    if scope in ("decoder", "decoder2") and any(
            u.startswith("DeconvBlock") for u in uniq):
        # resize_sep upsampling puts convs inside the DeconvBlock; only
        # the transpose mode (the flagship's) keeps this slice clean.
        raise ValueError("decoder scope requires upsample='transpose'")
    tail = uniq[-(n_sep + n_conv):]
    mapping: dict[str, str] = {}
    sep_i = conv_i = 0
    for t in tail:
        if t.startswith("SepConvBlock"):
            mapping[t] = f"SepConvBlock_{sep_i}"
            sep_i += 1
        else:
            mapping[t] = f"ConvBlock_{conv_i}"
            conv_i += 1
    if (sep_i, conv_i) != (n_sep, n_conv):
        raise ValueError(f"the conv order's tail {tail} is not a {scope} "
                         f"tail of depth {depth}")
    if scope == "decoder":
        # Denoiser has exactly two DeconvBlocks; the tail's is the last.
        mapping["DeconvBlock_1"] = "DeconvBlock_0"
    elif scope == "decoder2":
        # Both decoder stages are in the tail; numbering coincides.
        mapping["DeconvBlock_0"] = "DeconvBlock_0"
        mapping["DeconvBlock_1"] = "DeconvBlock_1"
    return mapping


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """BatchNorm running-statistic updates off inside `module`."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in norms:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in norms:
            bn.update_stats = True
