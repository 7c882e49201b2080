from emx_torch.utils.config import (Config, config_field, iter_shards,
                                    load_overrides, watch_file)
from emx_torch.utils.device import card_name_and_power, resolve_device
from emx_torch.utils.image import psnr, sanitize, scale0to1
from emx_torch.utils.metrics import (MetricsLogger, ThroughputMeter,
                                     read_loss_log)

__all__ = ["Config", "MetricsLogger", "ThroughputMeter",
           "card_name_and_power", "config_field", "iter_shards",
           "load_overrides", "psnr", "read_loss_log", "resolve_device",
           "sanitize", "scale0to1", "watch_file"]
