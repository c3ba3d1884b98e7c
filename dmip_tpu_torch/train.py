"""Model factory from config keys.

Only ``get_model_from_args`` (``dmip_tpu/train.py:367``) is ported so far,
enough to build a CDE for serving; the optimizer, the epoch loop and
``fit`` come with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from .models.diffusion import CDE, DiffusionModel, LossConfig


def get_model_from_args(
    config: Dict[str, Any], forward_model_params: Dict[str, Any]
) -> Tuple[DiffusionModel, LossConfig]:
    """Map the YAML keys ``model``, ``hidden_layers`` and ``loss_fn`` (and
    the loss weights) to (model, loss config)."""
    name = config["model"]
    if name in ("CDiffE", "Posterior"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet; see ROADMAP.md §A"
        )
    if name != "CDE":
        raise ValueError(
            'No valid value for "model" passed. Has to be one of '
            '"CDE", "CDiffE" or "Posterior".'
        )
    model = CDE(
        xdim=int(forward_model_params["xdim"]),
        ydim=int(forward_model_params["ydim"]),
        hidden_layers=tuple(config.get("hidden_layers", (512, 512, 512))),
    )
    loss_name = config.get("loss_fn")
    if loss_name is None:
        raise ValueError(
            'No valid loss_fn was specified. Options are: "PINNLoss", '
            '"PINNLoss2", "DSM" or "DSM_PDE".'
        )
    cfg = LossConfig(
        name=loss_name,
        lam=float(config.get("lam", 1.0)),
        lam2=float(config.get("lam2", 1.0)),
        pde_loss=config.get("pde_loss", "FPE"),
        pde_metric=config.get("pde_metric", "L1"),
        ic_metric=config.get("ic_metric", "L1"),
        divergence_method=config.get("divergence_method", "exact"),
    )
    return model, cfg
