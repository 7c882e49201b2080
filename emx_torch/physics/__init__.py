from emx_torch.physics.ctf import (ABERRATION_ANGLES, ABERRATION_MAGNITUDES,
                                  Aberrations, aberration_chi,
                                  aperture_envelope, defocus_ctf,
                                  energy_to_wavelength, fftfreq, full_ctf,
                                  spatial_envelope, spatial_frequencies,
                                  temporal_envelope)
from emx_torch.physics.propagate import (propagate_back_to_defocus,
                                        propagate_stack_to_focus,
                                        propagate_to_focus, propagate_wave)

__all__ = ["ABERRATION_ANGLES", "ABERRATION_MAGNITUDES", "Aberrations",
           "aberration_chi", "aperture_envelope", "defocus_ctf",
           "energy_to_wavelength", "fftfreq", "full_ctf",
           "propagate_back_to_defocus", "propagate_stack_to_focus",
           "propagate_to_focus", "propagate_wave", "spatial_envelope",
           "spatial_frequencies", "temporal_envelope"]
