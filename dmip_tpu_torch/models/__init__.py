from .diffusion import CDE, DiffusionModel, LossConfig

__all__ = ["CDE", "DiffusionModel", "LossConfig"]
