from emx_torch.train.checkpoints import Checkpointer
from emx_torch.train.dose_probe import DoseProbe
from emx_torch.train.engine import (TrainConfig, Trainer, TrainState,
                                    make_optimizer, set_learning_rate)
from emx_torch.train.losses import huberised_mse, ms_ssim, ssim

__all__ = ["Checkpointer", "DoseProbe", "TrainConfig", "TrainState",
           "Trainer", "huberised_mse", "make_optimizer", "ms_ssim",
           "set_learning_rate", "ssim"]
