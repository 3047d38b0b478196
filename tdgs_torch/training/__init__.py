"""Training: losses, configuration and the single-device 3DGS Runner."""
