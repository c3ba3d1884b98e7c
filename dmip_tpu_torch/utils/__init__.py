from .config import load_config, set_directories

__all__ = ["load_config", "set_directories"]
