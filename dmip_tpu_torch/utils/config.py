"""Config loading, the grid's Cartesian expansion and experiment-directory
management (port of ``dmip_tpu/utils/config.py``)."""

from __future__ import annotations

import itertools
import os
import shutil
from typing import Any, Dict, Iterator

import yaml

from ..parallel.mesh import is_writer


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def product_dict(**kwargs) -> Iterator[Dict[str, Any]]:
    """Cartesian product of a dict of lists, the last key varying fastest."""
    keys = kwargs.keys()
    for instance in itertools.product(*kwargs.values()):
        yield dict(zip(keys, instance))


def set_directories(train_dir: str, out_dir: str, resume_training: bool = False) -> str:
    """Wipe and recreate the out and log directories unless resuming;
    returns the log directory.  Off rank 0 of a multi-rank run it touches
    nothing (``parallel.is_writer``)."""
    log_dir = os.path.join(train_dir, "logs")
    if not is_writer():
        return log_dir
    if os.path.exists(out_dir) and not resume_training:
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(log_dir) and not resume_training:
        shutil.rmtree(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def check_wd(required_dir_name: str) -> None:
    """Raises unless the working directory's path ends with
    ``required_dir_name``."""
    current_path = os.getcwd()
    if not current_path.endswith(required_dir_name):
        raise ValueError(
            f"The script must be executed from the '{required_dir_name}' directory "
            f"of the project, current path is '{current_path}'."
        )
