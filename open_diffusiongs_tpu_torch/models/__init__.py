"""Model components: the DiT stack and the DGS denoiser."""
