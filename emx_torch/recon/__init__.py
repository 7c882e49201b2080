from emx_torch.recon.align import (affine_warp, align_stack,
                                   align_stack_affine, common_crop_slices,
                                   fourier_shift, phase_correlation,
                                   register_affine, relative_positions)
from emx_torch.recon.ewrec import (EWRECConfig, deconstruct, defocus_search,
                                   ewrec, reconstruct, reconstruction_loss,
                                   refine_defocuses, weak_phase_reconstruct,
                                   weak_phase_residual)
from emx_torch.recon.fit import AberrationFitConfig, fit_exit_wave

__all__ = ["AberrationFitConfig", "EWRECConfig", "affine_warp",
           "align_stack", "align_stack_affine", "common_crop_slices",
           "deconstruct", "defocus_search", "ewrec", "fit_exit_wave",
           "fourier_shift", "phase_correlation", "reconstruct",
           "reconstruction_loss", "refine_defocuses", "register_affine",
           "relative_positions", "weak_phase_reconstruct",
           "weak_phase_residual"]
