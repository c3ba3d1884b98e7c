from .diffusion import CDE, AnalyticGuidanceDPS, CDiffE, DiffusionModel, LossConfig, PosteriorDiffusionEstimator
from .refined import EnergyRefinedModel

__all__ = ["AnalyticGuidanceDPS", "CDE", "CDiffE", "DiffusionModel", "EnergyRefinedModel", "LossConfig",
           "PosteriorDiffusionEstimator"]
