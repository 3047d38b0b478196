"""Densification strategies (port of ``tdgs/strategy``). Only the
DefaultStrategy is ported; the MCMC strategy waits for a later slice."""

from tdgs_torch.strategy.base import Strategy
from tdgs_torch.strategy.default import DefaultStrategy

__all__ = ["Strategy", "DefaultStrategy"]
