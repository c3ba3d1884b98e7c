from .diffusion import CDE, AnalyticGuidanceDPS, CDiffE, DiffusionModel, LossConfig, PosteriorDiffusionEstimator

__all__ = ["AnalyticGuidanceDPS", "CDE", "CDiffE", "DiffusionModel", "LossConfig", "PosteriorDiffusionEstimator"]
