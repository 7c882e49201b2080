from emx_torch.analysis.filters import (DEFAULT_FILTERS, bilateral_filter,
                                        chambolle_tv, compare_denoisers,
                                        gaussian_filter, median_filter,
                                        save_err_hists, wavelet_denoise,
                                        wiener_filter)
from emx_torch.analysis.optim_demo import (compare_optimizers,
                                           optimize_rosenbrock, rosenbrock)
from emx_torch.analysis.pearson import (classify_family,
                                        moment_redistributor,
                                        pearson_from_moments)
from emx_torch.analysis.stats import (gram_histogram, gram_matrix,
                                      shannon_entropy)

__all__ = ["DEFAULT_FILTERS", "bilateral_filter", "chambolle_tv",
           "classify_family", "compare_denoisers", "compare_optimizers",
           "gaussian_filter", "gram_histogram", "gram_matrix",
           "median_filter", "moment_redistributor", "optimize_rosenbrock",
           "pearson_from_moments", "rosenbrock", "save_err_hists",
           "shannon_entropy", "wavelet_denoise", "wiener_filter"]
