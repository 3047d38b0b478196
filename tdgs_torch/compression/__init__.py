"""Splat compression (port of ``tdgs/compression``)."""

from tdgs_torch.compression.png_compression import PngCompression

__all__ = ["PngCompression"]
