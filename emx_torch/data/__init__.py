from emx_torch.data.crops import (box_resize, center_square_crop,
                                  random_crop, tile_grid)
from emx_torch.data.degrade import (SplitExample, denoiser_example,
                                    poisson_dose, sample_dose_scale)
from emx_torch.data.pipeline import (DataPipeline, DeviceDataset,
                                     PipelineConfig, synthetic_micrographs)

__all__ = ["DataPipeline", "DeviceDataset", "PipelineConfig", "SplitExample",
           "box_resize", "center_square_crop", "denoiser_example",
           "poisson_dose", "random_crop", "sample_dose_scale",
           "synthetic_micrographs", "tile_grid"]
