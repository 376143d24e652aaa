"""Compute ops: cameras, rays, Gaussian-splatting math, the rasterizer, and
the two CUDA kernels (attention, tile blend) with their plain twins."""
