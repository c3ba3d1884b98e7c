"""Hand-written CUDA kernels (sources in ``dmip_tpu_torch/csrc``), each with
its plain PyTorch version and a launch counter (``<wrapper>.launches``)."""

from .dps_kernel import fused_guided_em_sampler
from .dsm_train_kernel import fused_dsm_train_epochs
from .em_kernel import fused_em_sampler, fused_em_sampler_cdiffe
from .mh_kernel import fused_mh_scatterometry

__all__ = [
    "fused_dsm_train_epochs", "fused_em_sampler", "fused_em_sampler_cdiffe", "fused_guided_em_sampler",
    "fused_mh_scatterometry",
]
