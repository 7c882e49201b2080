"""Optimizer sanity checks on the Rosenbrock function (port of
emx/analysis/optim_demo.py; reference misc_py/rosenbrock.py:1-113
compared TF optimizers; here each optimizer races to the known minimum
at (1, 1)).

emx races optax's optimizers; the port races torch's with optax's
hyperparameters, and writes the update itself where no torch optimizer
computes optax's:

  * adam(2e-2): torch.optim.Adam (betas 0.9/0.999, eps 1e-8 added to
    the root, as optax's);
  * sgd(2e-4, momentum 0.9, nesterov): torch.optim.SGD(nesterov=True)
    (the trace starts at the first gradient in both);
  * rmsprop(5e-3): `OptaxRMSprop`. optax's decay is 0.9 (torch's alpha
    0.99) and its eps 1e-8 sits inside the root, 1/sqrt(nu + eps), where
    torch adds eps to sqrt(nu);
  * adagrad(5e-1): `OptaxAdagrad`. optax's accumulator starts at 0.1
    with eps 1e-7 inside the root, where torch's starts at 0 and adds
    eps 1e-10 to the root.
"""

from __future__ import annotations

from typing import Callable

import torch

from emx_torch.utils.device import resolve_device

OptimizerFactory = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps) (no momentum, not centered):
    nu = decay * nu + (1 - decay) * g^2; p -= lr * g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).add_(
                    (1.0 - group["decay"]) * p.grad * p.grad)
                p.sub_(group["lr"] * p.grad * torch.rsqrt(nu + group["eps"]))


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad(lr, initial_accumulator_value, eps): s += g^2;
    p -= lr * g / sqrt(s + eps) where s > 0, else no move."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                s = self.state[p].setdefault(
                    "sum", torch.full_like(p, group["initial"]))
                s.add_(p.grad * p.grad)
                inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                                  torch.zeros_like(s))
                p.sub_(group["lr"] * p.grad * inv)


def rosenbrock(xy: torch.Tensor, a: float = 1.0, b: float = 100.0
               ) -> torch.Tensor:
    x, y = xy[0], xy[1]
    return (a - x) ** 2 + b * (y - x ** 2) ** 2


def optimize_rosenbrock(optimizer: OptimizerFactory | None = None,
                        steps: int = 2000, x0=(-1.5, 2.0),
                        device: str | torch.device = "cuda"):
    """Returns (trajectory (steps + 1, 2), final_loss). `optimizer` makes
    an optimizer of a parameter list; default Adam(2e-2)."""
    make = optimizer or (lambda ps: torch.optim.Adam(ps, lr=2e-2))
    xy = torch.tensor(x0, dtype=torch.float32,
                      device=resolve_device(device), requires_grad=True)
    opt = make([xy])
    traj = [xy.detach().clone()]
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        rosenbrock(xy).backward()
        opt.step()
        traj.append(xy.detach().clone())
    with torch.no_grad():
        return torch.stack(traj).cpu(), float(rosenbrock(xy))


CANDIDATES: dict[str, OptimizerFactory] = {
    "adam": lambda ps: torch.optim.Adam(ps, lr=2e-2),
    "nesterov": lambda ps: torch.optim.SGD(ps, lr=2e-4, momentum=0.9,
                                           nesterov=True),
    "rmsprop": lambda ps: OptaxRMSprop(ps, lr=5e-3),
    "adagrad": lambda ps: OptaxAdagrad(ps, lr=5e-1),
}


def compare_optimizers(steps: int = 2000,
                       device: str | torch.device = "cuda"
                       ) -> dict[str, float]:
    """Final Rosenbrock loss per optimizer family (the reference's demo)."""
    return {name: optimize_rosenbrock(make, steps, device=device)[1]
            for name, make in CANDIDATES.items()}
