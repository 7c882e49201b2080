from emx_torch.utils.device import card_name_and_power, resolve_device
from emx_torch.utils.image import psnr, sanitize, scale0to1

__all__ = ["card_name_and_power", "psnr", "resolve_device", "sanitize",
           "scale0to1"]
