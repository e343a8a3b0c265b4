"""Inverse rendering — optimize scene parameters from target images."""
from .fit import FitConfig, FitResult, FitStep, fit, multiview_loss

__all__ = ["FitConfig", "FitResult", "FitStep", "fit", "multiview_loss"]
