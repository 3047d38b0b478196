"""Ops of the port: transforms, projection, SH, tiling, selective Adam, and
the packed rasterizer and segment sum with their CUDA kernels."""
