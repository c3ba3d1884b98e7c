"""The two precisions the reference runs in.

``REFERENCE`` is float32 with TF32 off.  ``CONTROL`` is the step below what
each configuration states: the sampler's products take fp8 (e4m3) inputs
where the program's take bf16, and every float32 matmul runs in TF32.  A
comparison that the control passes could not tell the program from a
lower-precision one, so each cell's control must fail it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    sampler_dtype: torch.dtype  # the dtype every sampler product's inputs are rounded to
    tf32: bool                  # whether float32 matmuls may run in TF32

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """t rounded to the sampler's product dtype, back in float32."""
        if self.sampler_dtype == torch.float32:
            return t
        return t.to(self.sampler_dtype).to(torch.float32)

    @contextlib.contextmanager
    def matmuls(self):
        """float32 matmuls in this precision for the duration of the block."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


REFERENCE = Precision("reference", torch.float32, False)
CONTROL = Precision("control", torch.float8_e4m3fn, True)
