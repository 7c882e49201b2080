from emx_torch.data.crops import (box_resize, center_square_crop,
                                  random_crop, tile_grid)
from emx_torch.data.degrade import (SplitExample, apply_partial_scan,
                                    bernoulli_mask, box_downsample,
                                    denoiser_example, fixed_scan_mask,
                                    gaussian_blur, infilling_example,
                                    norm_neg1to1, occlude, poisson_dose,
                                    sample_dose_scale)
from emx_torch.data.pipeline import (DataPipeline, DeviceDataset,
                                     PipelineConfig, synthetic_micrographs)

__all__ = ["DataPipeline", "DeviceDataset", "PipelineConfig", "SplitExample",
           "apply_partial_scan", "bernoulli_mask", "box_downsample",
           "box_resize", "center_square_crop", "denoiser_example",
           "fixed_scan_mask", "gaussian_blur", "infilling_example",
           "norm_neg1to1", "occlude", "poisson_dose", "random_crop",
           "sample_dose_scale", "synthetic_micrographs", "tile_grid"]
