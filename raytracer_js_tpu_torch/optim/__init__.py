"""Inverse rendering — optimize scene parameters from target images."""
from .fit import FitConfig, FitResult, fit, multiview_loss

__all__ = ["FitConfig", "FitResult", "fit", "multiview_loss"]
