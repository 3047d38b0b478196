"""Ops of the port: transforms, projection (EWA, 2DGS, UT with the camera
models), SH, tiling, selective Adam, MCMC relocation, and the packed,
2DGS and eval3d rasterizers and the segment sum with their CUDA kernels."""
