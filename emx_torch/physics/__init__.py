from emx_torch.physics.ctf import defocus_ctf, fftfreq, spatial_frequencies

__all__ = ["defocus_ctf", "fftfreq", "spatial_frequencies"]
