from emx_torch.data.degrade import (denoiser_example, poisson_dose,
                                    sample_dose_scale)
from emx_torch.data.pipeline import (DeviceDataset, PipelineConfig,
                                     synthetic_micrographs)

__all__ = ["DeviceDataset", "PipelineConfig", "denoiser_example",
           "poisson_dose", "sample_dose_scale", "synthetic_micrographs"]
