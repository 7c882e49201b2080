"""Training data (port of emx/data/pipeline.py).

  * `PipelineConfig`, as emx's;
  * `DataPipeline`: TIFF files (read by the port's own TIFF decoder,
    emx_torch.io.tiff) or an in-memory array, in emx's order: the same
    `SeedSequence([seed, epoch])` permutation, the same `[seed, epoch,
    pos, 17]` crop offsets, a thread pool for file sources, one gather
    for packed arrays, and the (epoch, index) cursor committed on
    consumption; it yields numpy batches, which the trainer uploads
    (through pinned memory). emx's `as_global` (a multi-host
    jax.Array) has no counterpart at world size 1 (ROADMAP.md);
  * `DeviceDataset`: the whole corpus lives on the device and batches are
    gathered there; the epoch order is a permutation from a generator
    seeded by (seed, epoch), and the (epoch, index) cursor is saved and
    restored with `state_dict` / `load_state_dict`, so a resumed run sees
    the batches an uninterrupted one sees;
  * `synthetic_micrographs`, `grain_micrographs`, `filament_micrographs`
    and `porous_micrographs`, verbatim copies (numpy only,
    bit-identical);
  * `ctf_micrographs`: its numpy lattice copied (bit-identical), its
    render on `torch.fft` in complex64 on a device;
  * `mixed_micrographs`, the training mixes of those families ('mixed',
    'mixed3'): emx's composition, seed offsets and shuffle.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from emx_torch.io.tiff import read_tiff
from emx_torch.physics.ctf import defocus_ctf, fftfreq
from emx_torch.utils.config import Config, config_field
from emx_torch.utils.device import resolve_device
from emx_torch.utils.rng import fold_in


@dataclasses.dataclass
class PipelineConfig(Config):
    batch_size: int = config_field(8, "global batch size")
    crop_size: int = config_field(512, "training crop sidelength")
    seed: int = config_field(0, "pipeline RNG seed")
    num_workers: int = config_field(4, "file-read threads")
    prefetch: int = config_field(4, "prefetched batches")
    drop_remainder: bool = config_field(True, "drop last partial batch")


class DataPipeline:
    """Iterates (batch,) float32 arrays of shape (B, crop, crop).

    Unlike emx's, it raises when batch_size exceeds the source, where
    emx's iterator would loop over empty epochs for ever. `source` is either a list of file paths (read as float32 images and
    random-cropped on host) or a numpy array (N, H, W) served from memory.
    State is (epoch, index): save/restore via state_dict/load_state_dict.
    """

    def __init__(
        self,
        source: list[str] | np.ndarray,
        config: PipelineConfig,
        reader: Callable[[str], np.ndarray] | None = None,
    ):
        self.cfg = config
        self.source = source
        self.reader = reader or (
            lambda p: read_tiff(p, fallback_shape=(config.crop_size, config.crop_size))
        )
        self.epoch = 0
        self.index = 0
        self._n = len(source)
        if self._n == 0:
            raise ValueError("empty data source")
        if config.batch_size > self._n:
            # emx's iterator would loop over empty epochs for ever.
            raise ValueError(f"batch_size {config.batch_size} exceeds the "
                             f"{self._n} images of the source")

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> dict[str, int]:
        return {"epoch": self.epoch, "index": self.index}

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.index = int(state["index"])

    # -- deterministic order -------------------------------------------------
    def _order(self, epoch: int) -> np.ndarray:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, epoch])
        ).permutation(self._n)

    def _load(self, item_idx: int, epoch: int, pos: int) -> np.ndarray:
        if isinstance(self.source, np.ndarray):
            img = self.source[item_idx]
        else:
            img = self.reader(self.source[item_idx])
        c = self.cfg.crop_size
        h, w = img.shape[-2:]
        if (h, w) == (c, c):
            return np.asarray(img, np.float32)
        if h < c or w < c:
            out = np.full((c, c), 0.5, np.float32)
            out[: min(h, c), : min(w, c)] = img[: min(h, c), : min(w, c)]
            return out
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, epoch, pos, 17])
        )
        y = rng.integers(0, h - c + 1)
        x = rng.integers(0, w - c + 1)
        return np.asarray(img[y : y + c, x : x + c], np.float32)

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator[np.ndarray]:
        return self._prefetching_iter()

    def _batches(self) -> Iterator[tuple[np.ndarray, int, int]]:
        """Yield (batch, epoch, index) where (epoch, index) is the cursor
        AFTER the batch: the state to resume from once the batch has been
        consumed. The prefetch worker never touches self.epoch/index; the
        consumer commits the cursor as batches are yielded, so a
        checkpoint taken mid-stream never skips prefetched-but-unconsumed
        batches on resume.

        File sources fan the reads out over `num_workers` threads (file
        IO and numpy's byte copies release the GIL). Array sources (incl.
        np.load(mmap_mode='r') packed stacks, see pack_crops) stay
        serial: they are memcpy-bound and threads only add overhead."""
        b = self.cfg.batch_size
        epoch, index = self.epoch, self.index
        pool = None
        if not isinstance(self.source, np.ndarray) and self.cfg.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.cfg.num_workers)
        c = self.cfg.crop_size
        fast_array = (isinstance(self.source, np.ndarray)
                      and self.source.shape[-2:] == (c, c))
        try:
            while True:
                order = self._order(epoch)
                while index + b <= self._n:
                    idxs = order[index : index + b]
                    if fast_array:
                        # Packed stacks at native crop size: one C-level
                        # fancy-index gather, dtype-preserving (integer
                        # packs convert on the device in the train step).
                        batch = self.source[idxs]
                    else:
                        args = [(int(i), epoch, index + j)
                                for j, i in enumerate(idxs)]
                        if pool is not None:
                            imgs = list(pool.map(lambda a: self._load(*a),
                                                 args))
                        else:
                            imgs = [self._load(*a) for a in args]
                        batch = np.stack(imgs)
                    index += b
                    yield batch, epoch, index
                epoch += 1
                index = 0
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)

    def _prefetching_iter(self) -> Iterator[np.ndarray]:
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for item in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # surface loader errors on the main thread
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                batch, epoch, index = item
                # Commit the resumable cursor only on consumption.
                self.epoch, self.index = epoch, index
                yield batch
        finally:
            stop.set()


class DeviceDataset:
    """Iterates (B, crop, crop) float32 batches of a corpus held on
    `device` (CUDA unless the caller asks for the CPU). An integer corpus
    is uploaded as it is and cast on the device.

    Unlike emx's, it raises when batch_size exceeds the corpus, where
    emx's iterator would loop over empty epochs for ever."""

    def __init__(self, data: np.ndarray, config: PipelineConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self._n = data.shape[0]
        if config.crop_size != data.shape[-1]:
            raise ValueError("DeviceDataset serves full images; pre-crop "
                             "to crop_size")
        if not 0 < config.batch_size <= self._n:
            raise ValueError(f"batch_size {config.batch_size} does not fit "
                             f"a corpus of {self._n} images")
        self.data = torch.as_tensor(data).to(self.device).float()
        self.epoch = 0
        self.index = 0

    def state_dict(self) -> dict[str, int]:
        return {"epoch": self.epoch, "index": self.index}

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.index = int(state["index"])

    def __iter__(self):
        b = self.cfg.batch_size
        while True:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(fold_in(self.cfg.seed, self.epoch))
            perm = torch.randperm(self._n, generator=gen, device=self.device)
            while self.index + b <= self._n:
                idx = perm[self.index:self.index + b]
                # Advance the cursor BEFORE yielding so state_dict() taken
                # between batches resumes at the right position.
                self.index += b
                yield self.data.index_select(0, idx)
            self.epoch += 1
            self.index = 0


def synthetic_micrographs(n: int, size: int = 512, seed: int = 0) -> np.ndarray:
    """Structured synthetic micrographs (Gaussian blobs + lattice fringes +
    smooth background) for tests and benchmarks — stands in for the
    harvested corpus, which cannot ship."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        img = 0.3 + 0.2 * np.sin(2 * np.pi * (rng.uniform(1, 4) * xx + rng.uniform(0, 1)))
        for _ in range(6):  # particles
            cy, cx = rng.uniform(0.1, 0.9, 2)
            s = rng.uniform(0.02, 0.12)
            a = rng.uniform(0.2, 0.6)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        f = rng.uniform(20, 60)
        ang = rng.uniform(0, np.pi)
        img = img + 0.08 * np.sin(2 * np.pi * f * (np.cos(ang) * xx + np.sin(ang) * yy))
        lo, hi = img.min(), img.max()
        out[i] = (img - lo) / (hi - lo)
    return out


def ctf_lattice(n: int, size: int = 512, seed: int = 0):
    """The numpy part of `ctf_micrographs`: (deltas (n, size, size),
    defocus (n,), sigma (n,)), float32, bit-identical to emx's."""
    rng = np.random.default_rng(seed)
    deltas = np.zeros((n, size, size), np.float32)
    for i in range(n):
        # Random 2D Bravais lattice with positional jitter + vacancies.
        spacing = rng.uniform(8.0, 20.0)
        ang = rng.uniform(0, np.pi)
        a1 = spacing * np.array([np.cos(ang), np.sin(ang)])
        ang2 = ang + rng.uniform(np.pi / 3, 2 * np.pi / 3)
        a2 = (spacing * rng.uniform(0.8, 1.2)
              * np.array([np.cos(ang2), np.sin(ang2)]))
        m = int(2 * size / spacing)
        ij = np.mgrid[-m:m + 1, -m:m + 1].reshape(2, -1).T.astype(
            np.float32)
        pos = ij @ np.stack([a1, a2]).astype(np.float32) + size / 2
        pos += rng.normal(0, 0.05 * spacing, pos.shape)
        pos = pos[rng.random(len(pos)) > 0.1]  # vacancies
        ok = ((pos[:, 0] >= 0) & (pos[:, 0] < size)
              & (pos[:, 1] >= 0) & (pos[:, 1] < size))
        pos = pos[ok]
        np.add.at(deltas[i], (pos[:, 0].astype(int),
                              pos[:, 1].astype(int)),
                  rng.uniform(0.5, 1.5, len(pos)).astype(np.float32))
        if rng.random() < 0.5:  # amorphous overlayer
            na = int(0.5 * size * size / spacing**2)
            ap = rng.uniform(0, size, (na, 2))
            np.add.at(deltas[i], (ap[:, 0].astype(int),
                                  ap[:, 1].astype(int)),
                      rng.uniform(0.3, 0.8, na).astype(np.float32))
    # Defocus range set so chi = pi*lambda*df*k^2 sweeps a few CTF
    # oscillations across the band (px_dim = 1, lambda ~ 300 kV in px).
    defocus = rng.uniform(2000.0, 12000.0, n).astype(np.float32)
    sigma = rng.uniform(1.0, 2.0, n).astype(np.float32)
    return deltas, defocus, sigma


def render_ctf(deltas: torch.Tensor, defocus: torch.Tensor,
               sigma: torch.Tensor) -> torch.Tensor:
    """Weak-phase HRTEM images of point potentials `deltas` (B, S, S)
    under a Gaussian blur of width `sigma` and a defocus CTF, each
    min-max scaled to [0, 1]; float32 on the inputs' device."""
    size = deltas.shape[-1]
    k = fftfreq(size, device=deltas.device)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    s = sigma[:, None, None]
    blur = torch.exp(-2.0 * (math.pi * s) ** 2 * k2)
    phi = torch.fft.ifft2(torch.fft.fft2(deltas) * blur).real
    peak = torch.amax(phi, dim=(-2, -1), keepdim=True)
    phi = 0.5 * phi / torch.clamp(peak, min=1e-6)
    psi = torch.exp(1j * phi.to(torch.complex64))
    ctf = defocus_ctf(size, 2.51e-3, defocus[:, None, None])
    img = torch.abs(torch.fft.ifft2(torch.fft.fft2(psi) * ctf)) ** 2
    lo = torch.amin(img, dim=(-2, -1), keepdim=True)
    hi = torch.amax(img, dim=(-2, -1), keepdim=True)
    return (img - lo) / torch.clamp(hi - lo, min=1e-9)


def ctf_micrographs(n: int, size: int = 512, seed: int = 0,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """OUT-OF-FAMILY evaluation micrographs: weak-phase HRTEM images of
    randomized crystalline (+ optional amorphous overlayer) atomic
    potentials under a defocus CTF — sharp atomic columns, defocus
    delocalisation and Thon-ring texture that `synthetic_micrographs`'
    blob/fringe family does not contain. Physics as in the EWREC
    transfer function (reference misc_py/ewrec_class.py:423-448).

    Returns (n, size, size) float32 on `device` (emx returns numpy);
    the render's float32 rounding differs from XLA's by ~1e-6."""
    device = resolve_device(device)
    deltas, defocus, sigma = ctf_lattice(n, size, seed)
    return render_ctf(*(torch.from_numpy(a).to(device)
                        for a in (deltas, defocus, sigma)))


def grain_micrographs(n: int, size: int = 512, seed: int = 0) -> np.ndarray:
    """SECOND out-of-family evaluation family: polycrystalline
    micrographs — Voronoi grains, each with its own lattice-fringe
    orientation/frequency/brightness, separated by dark boundary
    grooves. Distinct from the blob+global-fringe
    `synthetic_micrographs` and the point-atom CTF `ctf_micrographs`:
    piecewise-stationary texture with sharp orientation
    discontinuities. Eval-only through round 3 (where the flagship
    lost to a gaussian filter on it by ~5 dB); joined the round-4
    training mix (`mixed_micrographs` grains=True, training seed
    30_000 vs eval seed 321) — `filament_micrographs` is now the
    standing true-OOD probe (emx.bench.quant_check ood)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        k = int(rng.integers(6, 16))
        pts = rng.uniform(0, size, (k, 2)).astype(np.float32)
        d2 = ((yy[..., None] - pts[:, 0]) ** 2
              + (xx[..., None] - pts[:, 1]) ** 2)
        lab = np.argmin(d2, axis=-1)
        d2s = np.partition(d2, 1, axis=-1)
        # Distance-to-boundary proxy: gap between nearest two seeds.
        edge = np.sqrt(d2s[..., 1]) - np.sqrt(d2s[..., 0])
        img = np.zeros((size, size), np.float32)
        for g in range(k):
            f = rng.uniform(15.0, 50.0)
            ang = rng.uniform(0, np.pi)
            ph = rng.uniform(0, 2 * np.pi)
            base = rng.uniform(0.35, 0.7)
            fr = base + 0.15 * np.sin(
                2 * np.pi * f * (np.cos(ang) * xx + np.sin(ang) * yy)
                / size + ph)
            m = lab == g
            img[m] = fr[m]
        img = img * (1.0 - 0.5 * np.exp(-(edge / 2.0) ** 2))
        lo, hi = img.min(), img.max()
        out[i] = (img - lo) / max(hi - lo, 1e-9)
    return out


def filament_micrographs(n: int, size: int = 512, seed: int = 0) -> np.ndarray:
    """THIRD out-of-family evaluation family: curvilinear micrographs —
    worm-like filaments (random-walk tubes, e.g. nanotubes / polymer
    chains / biological fibrils) plus hollow vesicle rings with bright
    rims. Morphologically distinct from every training family: no
    straight lattice fringes (synthetic), no point-atom CTF texture
    (ctf), no piecewise-stationary Voronoi patches (grains) — smooth
    bent tubes with long-range curvature. EVAL-ONLY — never enters any
    training corpus; once grains joined the round-4 training mix this
    family became the true OOD probe (emx.bench.quant_check ood,
    family='filaments')."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        img = np.zeros((size, size), np.float32)
        # Worm-like filaments: random-walk paths rasterized as point
        # deposits, then blurred into tubes of per-filament width.
        for _ in range(int(rng.integers(4, 10))):
            length = int(rng.uniform(0.5, 2.0) * size)
            pos = rng.uniform(0.1 * size, 0.9 * size, 2)
            ang = rng.uniform(0, 2 * np.pi)
            stiff = rng.uniform(0.05, 0.3)  # turning-angle scale
            deposit = np.zeros((size, size), np.float32)
            angs = ang + np.cumsum(rng.normal(0, stiff, length))
            steps = np.stack([np.cos(angs), np.sin(angs)], axis=1)
            pts = pos + np.cumsum(steps, axis=0).astype(np.float32)
            # Reflect at the borders (triangle wave) so long walks stay
            # in frame without piling up on the edges.
            pts = np.abs(np.mod(pts, 2 * (size - 1)) - (size - 1))
            pts = (size - 1) - pts
            np.add.at(deposit, (pts[:, 0].astype(int),
                                pts[:, 1].astype(int)), 1.0)
            width = rng.uniform(1.5, 4.0)
            f = np.fft.fftfreq(size).astype(np.float32)
            g = np.exp(-2.0 * (np.pi * width) ** 2
                       * (f[:, None] ** 2 + f[None, :] ** 2))
            tube = np.fft.ifft2(np.fft.fft2(deposit) * g).real
            img += rng.uniform(0.4, 1.0) * tube / max(tube.max(), 1e-9)
        # Hollow vesicles: rings with a bright rim profile.
        for _ in range(int(rng.integers(1, 5))):
            cy, cx = rng.uniform(0.15, 0.85, 2) * size
            r = rng.uniform(0.04, 0.18) * size
            w = rng.uniform(1.5, 4.0)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            img += (rng.uniform(0.3, 0.8)
                    * np.exp(-((d - r) / w) ** 2).astype(np.float32))
        # Smooth illumination background.
        gy, gx = rng.uniform(-0.15, 0.15, 2)
        img += 0.3 + gy * (yy / size - 0.5) + gx * (xx / size - 0.5)
        lo, hi = img.min(), img.max()
        out[i] = (img - lo) / max(hi - lo, 1e-9)
    return out


def porous_micrographs(n: int, size: int = 512, seed: int = 0) -> np.ndarray:
    """FOURTH out-of-family evaluation family: bicontinuous porous /
    spinodal-foam micrographs — band-pass-filtered Gaussian noise,
    soft-thresholded into interpenetrating bright matrix and dark pore
    networks with a single characteristic length (e.g. nanoporous gold,
    block-copolymer morphologies, dealloyed foams). Morphologically
    distinct from every other family: isotropic labyrinthine domains —
    no lattice fringes (synthetic), no point-atom CTF texture (ctf), no
    piecewise-stationary Voronoi patches (grains), no sparse curvilinear
    tubes over smooth background (filaments). EVAL-ONLY — never enters
    any training corpus; once filaments joined the round-5 training mix
    this family became the true OOD probe (emx.bench.quant_check ood,
    family='porous'). Stands in for corpus breadth the reference gets
    from its real 65k-micrograph harvest
    (reference misc_py/denoiser-multi-gpu.py:84-92)."""
    rng = np.random.default_rng(seed)
    f = np.fft.fftfreq(size).astype(np.float32)
    k = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        # Annular band-pass around a random characteristic frequency:
        # the spinodal-decomposition spectrum (single dominant length).
        k0 = rng.uniform(8.0, 40.0) / size
        bw = k0 * rng.uniform(0.25, 0.6)
        band = np.exp(-0.5 * ((k - k0) / bw) ** 2).astype(np.float32)
        noise = rng.normal(0, 1, (size, size)).astype(np.float32)
        field = np.fft.ifft2(np.fft.fft2(noise) * band).real
        field /= max(field.std(), 1e-9)
        # Soft threshold -> two interpenetrating phases with smooth
        # interfaces; random volume fraction and interface sharpness.
        bias = rng.uniform(-0.4, 0.4)
        sharp = rng.uniform(1.5, 4.0)
        img = 0.5 * (1.0 + np.tanh(sharp * (field - bias)))
        # Mild pore-interior shading + smooth illumination gradient.
        img = img * rng.uniform(0.6, 0.9) + rng.uniform(0.05, 0.2)
        gy, gx = rng.uniform(-0.15, 0.15, 2)
        img = img + gy * (yy - 0.5) + gx * (xx - 0.5)
        lo, hi = img.min(), img.max()
        out[i] = (img - lo) / max(hi - lo, 1e-9)
    return out


def mixed_micrographs(n: int, size: int = 512, seed: int = 0,
                      grains: bool = True, filaments: bool = False,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """Diverse training corpus (emx's composition): n // 4 ctf
    micrographs, n // 4 grains when `grains`, n // 4 filaments when
    `filaments` (the 'mixed3' corpus), the rest synthetic; seeds offset
    by +10_000 (ctf), +30_000 (grains) and +40_000 (filaments) so no
    evaluation ladder leaks in; then shuffled by
    numpy.random.default_rng(seed + 20_000). The ctf part renders on
    `device` (torch.fft, within ~1e-6 of emx's XLA render); the result
    is float32 numpy, as emx's."""
    n_ctf = n // 4
    n_grain = n // 4 if grains else 0
    n_fil = n // 4 if filaments else 0
    a = synthetic_micrographs(n - n_ctf - n_grain - n_fil, size, seed=seed)
    b = ctf_micrographs(n_ctf, size, seed=seed + 10_000,
                        device=device).cpu().numpy()
    parts = [a, b]
    if n_grain:
        parts.append(grain_micrographs(n_grain, size, seed=seed + 30_000))
    if n_fil:
        parts.append(filament_micrographs(n_fil, size,
                                          seed=seed + 40_000))
    out = np.concatenate(parts, axis=0)
    rng = np.random.default_rng(seed + 20_000)
    rng.shuffle(out)
    return out
