from emx_torch.analysis.filters import (DEFAULT_FILTERS, bilateral_filter,
                                        chambolle_tv, compare_denoisers,
                                        gaussian_filter, median_filter,
                                        save_err_hists, wavelet_denoise,
                                        wiener_filter)

__all__ = ["DEFAULT_FILTERS", "bilateral_filter", "chambolle_tv",
           "compare_denoisers", "gaussian_filter", "median_filter",
           "save_err_hists", "wavelet_denoise", "wiener_filter"]
