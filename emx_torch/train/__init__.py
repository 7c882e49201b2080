from emx_torch.train.checkpoints import Checkpointer
from emx_torch.train.engine import (TrainConfig, Trainer, TrainState,
                                    make_optimizer, set_learning_rate)
from emx_torch.train.losses import huberised_mse

__all__ = ["Checkpointer", "TrainConfig", "TrainState", "Trainer",
           "huberised_mse", "make_optimizer", "set_learning_rate"]
