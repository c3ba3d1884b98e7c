"""Config loading and experiment-directory management
(port of ``dmip_tpu/utils/config.py``)."""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import yaml


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def set_directories(train_dir: str, out_dir: str, resume_training: bool = False) -> str:
    """Wipe and recreate the out and log directories unless resuming;
    returns the log directory."""
    if os.path.exists(out_dir) and not resume_training:
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    log_dir = os.path.join(train_dir, "logs")
    if os.path.exists(log_dir) and not resume_training:
        shutil.rmtree(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir
