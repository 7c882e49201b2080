"""Simulated microscope (port of emx/scope/sim.py): the testable source
of truth for the acquisition protocol (SURVEY.md §7 hard part 6 — the hardware side is unverifiable,
so the simulator defines correct behavior).

Physics: a synthetic specimen imaged through a defocus-dependent CTF
(emx_torch.physics, cuFFT on a card) — out-of-focus z produces Fresnel-fringe-like contrast whose
kurtosis-of-Laplacian rises away from the optimal z, exactly the signal
the reference's RL autofocus exploits (em_env/fresnel_env.py:163-208).
Poisson shot noise at a configurable dose, drawn on the host from the
scope's numpy generator, as emx draws it: the same seed gives the same
counts wherever the propagation ran (to within a count where float32
FFTs of two libraries put a rate within ~1e-4 of a rounding edge).

`SimulatedMicroscope.handle()` executes one instruction program — shared
by the in-process transport, the FileMarionette (stands in for the
DM-side DigitalMicrograph script), and mirrored in C++ by
native/scopectl.cc.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from emx_torch.scope.protocol import Instruction, decode_program
from emx_torch.utils.device import resolve_device


def disc_specimen(n: int, size: int, seed: int = 0, n_disc: int | None = None,
                  soft: float = 0.7, background: float = 0.3) -> np.ndarray:
    """Phase maps with sharp-edged discs (holey-film apertures /
    particles) on a smooth background.

    The autofocus metric — kurtosis of the Laplacian, minimised at focus
    (reference em_env/fresnel_env.py:163-208) — needs sharp phase edges:
    their defocus ringing produces the heavy-tailed Laplacian the metric
    detects, giving a deep global minimum exactly at focus. Smooth
    specimens invert the metric (shot noise dominates the kurtosis AT
    focus), which made scan-estimated targets land on CTF-oscillation
    dips ~1.5 z-units off — measured in docs/runs/dqn_autofocus notes.
    """
    rng = np.random.default_rng(seed)
    if n_disc is None:
        n_disc = max(2, (size * size) // 384)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        img = np.zeros((size, size), np.float32)
        if background > 0:
            f = rng.uniform(1.0, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            img += background * (
                0.5 + 0.25 * np.sin(2 * np.pi * f[0] * xx / size + ph[0])
                + 0.25 * np.sin(2 * np.pi * f[1] * yy / size + ph[1]))
        for _ in range(n_disc):
            cy, cx = rng.uniform(0, size, 2)
            r = rng.uniform(3.0, 9.0)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            img += 1.0 / (1.0 + np.exp((d - r) / soft))
        lo, hi = img.min(), img.max()
        out[i] = (img - lo) / (hi - lo) if hi > lo else 0.5
    return out


class SimulatedMicroscope:
    def __init__(
        self,
        image_size: int = 96,
        seed: int = 0,
        optimal_z: float = 0.0,
        defocus_per_z: float = 200.0,
        dose: float = 2000.0,
        specimen: np.ndarray | None = None,
        wavelength: float = 0.025,
        phase_strength: float = 1.0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.phase_strength = phase_strength
        self.size = image_size
        self.rng = np.random.default_rng(seed)
        self.x = self.y = 0.0
        self.z = 0.0
        self.focus = 0.0
        self.beam = [0.0, 0.0]
        self.optimal_z = optimal_z
        self.defocus_per_z = defocus_per_z
        self.dose = dose
        self.wavelength = wavelength
        self.terminated = False
        if specimen is None:
            # Large specimen; the stage pans a window over it. Sharp disc
            # features keep the focus metric well-posed (see
            # disc_specimen's docstring).
            self.specimen = disc_specimen(1, 4 * image_size, seed=seed)[0]
        else:
            self.specimen = np.asarray(specimen, np.float32)

    # -- imaging -----------------------------------------------------------
    def _window(self) -> np.ndarray:
        big = self.specimen.shape[0]
        cx = int(self.x + self.beam[0]) % max(1, big - self.size)
        cy = int(self.y + self.beam[1]) % max(1, big - self.size)
        return self.specimen[cy : cy + self.size, cx : cx + self.size]

    def acquire(self) -> np.ndarray:
        from emx_torch.physics.propagate import propagate_back_to_defocus

        img = torch.from_numpy(np.ascontiguousarray(self._window())).to(
            self.device)
        defocus = (self.z - self.optimal_z) * self.defocus_per_z + self.focus
        # Pure (strong-ish) phase object: in focus the image is featureless
        # (contrast only from shot noise — kurtosis-of-Laplacian ~ 0);
        # defocus produces Fresnel-fringe contrast with heavy-tailed
        # Laplacian, the signal the autofocus metric exploits
        # (reference em_env/fresnel_env.py:163-208).
        wave = torch.exp(1j * self.phase_strength * img).to(torch.complex64)
        out = propagate_back_to_defocus(wave, float(defocus), self.wavelength)
        intensity = (out.abs() ** 2).cpu().numpy().astype(np.float32)
        if self.dose > 0:
            counts = self.rng.poisson(
                np.clip(intensity, 0, None) * self.dose / max(intensity.mean(), 1e-9)
            )
            intensity = counts.astype(np.float32)
        lo, hi = intensity.min(), intensity.max()
        return (intensity - lo) / (hi - lo) if hi > lo else np.full_like(intensity, 0.5)

    # -- protocol ----------------------------------------------------------
    def handle(self, instructions: list[Instruction]):
        """Execute a program; return (state_rows, images) where images maps
        row index -> ndarray for get_img rows."""
        rows: list[list[str]] = []
        images: dict[int, np.ndarray] = {}
        for ins in instructions:
            op, a = ins.op, ins.args
            if op == "get_img":
                images[len(rows)] = self.acquire()
                rows.append(["0", str(a[0]) if a else "img"])
            elif op == "EMSetStageX":
                self.x += a[0]; rows.append(["1", str(self.x)])
            elif op == "EMSetStageY":
                self.y += a[0]; rows.append(["2", str(self.y)])
            elif op == "EMSetStageZ":
                self.z += a[0]; rows.append(["3", str(self.z)])
            elif op == "EMChangeBeamShift":
                self.beam[0] += a[0]; self.beam[1] += a[1]
                rows.append(["4", str(self.beam[0]), str(self.beam[1])])
            elif op == "EMSetStageX_Abs":
                self.x = a[0]; rows.append(["5", str(self.x)])
            elif op == "EMSetStageY_Abs":
                self.y = a[0]; rows.append(["6", str(self.y)])
            elif op == "EMSetStageZ_Abs":
                self.z = a[0]; rows.append(["7", str(self.z)])
            elif op == "EMGetStageX":
                rows.append(["8", str(self.x)])
            elif op == "EMGetStageY":
                rows.append(["9", str(self.y)])
            elif op == "EMGetStageZ":
                rows.append(["10", str(self.z)])
            elif op == "EMChangeFocus":
                self.focus += a[0]; rows.append(["11", str(self.focus)])
            elif op == "EMGetFocus":
                rows.append(["12", str(self.focus)])
            elif op == "EMSetFocus":
                self.focus = a[0]; rows.append(["13", str(self.focus)])
            elif op == "terminate":
                self.terminated = True
                rows.append(["14", "terminated"])
            else:
                rows.append(["-1", f"unknown op {op}"])
        return rows, images


class InProcessTransport:
    """Directly drives a SimulatedMicroscope — fast path for tests/RL."""

    def __init__(self, scope: SimulatedMicroscope):
        self.scope = scope
        self.last_image: np.ndarray | None = None

    def execute(self, instructions):
        rows, images = self.scope.handle(list(instructions))
        if images:
            self.last_image = images[max(images)]
        return rows

    def close(self):
        pass


class FileMarionette:
    """Background thread emulating the DigitalMicrograph-side marionette
    script against the file-RPC protocol: polls for the change-flag file,
    runs the program on a SimulatedMicroscope, writes images as TIFFs and
    the state file, removes the flag (reference em_env.py semantics)."""

    def __init__(self, scope: SimulatedMicroscope, change_path: str,
                 instr_path: str, state_path: str, img_dir: str,
                 poll_s: float = 0.02):
        self.scope = scope
        self.change_path = change_path
        self.instr_path = instr_path
        self.state_path = state_path
        self.img_dir = img_dir
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        os.makedirs(self.img_dir, exist_ok=True)
        self._thread.start()
        return self

    def _run(self):
        from emx_torch.io.tiff import write_tiff

        while not self._stop.is_set() and not self.scope.terminated:
            if not os.path.isfile(self.change_path):
                time.sleep(self.poll_s)
                continue
            with open(self.instr_path) as f:
                program = decode_program(f.read())
            rows, images = self.scope.handle(program)
            for idx, img in images.items():
                path = os.path.join(self.img_dir, f"{rows[idx][1]}.tif")
                write_tiff(path, img)
                rows[idx][1] = path
            with open(self.state_path, "w") as f:
                for row in rows:
                    f.write(",".join(row) + "\n")
            os.remove(self.change_path)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
