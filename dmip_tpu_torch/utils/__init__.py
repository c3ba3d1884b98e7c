from .config import load_config, set_directories
from .metrics import MetricsWriter

__all__ = ["MetricsWriter", "load_config", "set_directories"]
