"""Plain PyTorch reference of what the benchmark's cells compute.

Written from the published semantics (the thesis configurations, the
Philox4x32-10 stream the sampler kernels document, optax's Adam) and
imports nothing of ``dmip_tpu_torch`` or the JAX package.  Every function
takes a ``Precision``: the reference runs in float32 with TF32 off, the
control one precision lower (fp8 e4m3 for the sampler's bf16 products,
TF32 for the float32 matmuls).
"""
