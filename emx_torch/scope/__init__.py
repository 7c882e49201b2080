"""Microscope control and RL autofocus (port of emx/scope): the protocol
and its transports, the simulated microscope, the serial and batched
autofocus environments (`env`, `vec_env`), the DQN agent (`dqn`) and
the fringe classifier; `load_policy` and `load_classifier` read emx's
trained weights."""

from emx_torch.scope.protocol import (
    OPCODES,
    Instruction,
    FileTransport,
    SocketTransport,
    MicroscopeClient,
)
from emx_torch.scope.sim import SimulatedMicroscope, FileMarionette
from emx_torch.scope.env import FresnelEnv, fresnel_quantifier
from emx_torch.scope.classifier import (FringeClassifier, load_classifier,
                                        train_fringe_classifier)
from emx_torch.scope.dqn import load_policy

__all__ = [
    "OPCODES",
    "Instruction",
    "FileTransport",
    "SocketTransport",
    "MicroscopeClient",
    "SimulatedMicroscope",
    "FileMarionette",
    "FresnelEnv",
    "fresnel_quantifier",
    "FringeClassifier",
    "train_fringe_classifier",
    "load_classifier",
    "load_policy",
]
