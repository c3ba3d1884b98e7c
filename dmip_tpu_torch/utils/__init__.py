from .config import check_wd, load_config, product_dict, set_directories
from .metrics import MetricsWriter

__all__ = ["MetricsWriter", "check_wd", "load_config", "product_dict", "set_directories"]
