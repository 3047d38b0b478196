"""Densification strategies (port of ``tdgs/strategy``): the DefaultStrategy
and the MCMCStrategy."""

from tdgs_torch.strategy.base import Strategy
from tdgs_torch.strategy.default import DefaultStrategy
from tdgs_torch.strategy.mcmc import MCMCStrategy

__all__ = ["Strategy", "DefaultStrategy", "MCMCStrategy"]
