"""Fused analytic-guidance E-M sampler (B5): CUDA kernel and plain version.

Port of ``dmip_tpu/ops/dps_kernel.py :: fused_guided_em_sampler``.  Per
reverse-SDE step and sample row, with s = T - i/N T:

  * the prior net's score s_p = prior(x, s) and the Tweedie estimate
    x0 = (x + std^2 s_p) / alpha;
  * ``guidance='dps'``: the surrogate f = surr(x0) and
    ``losses.likelihood_score_target`` / alpha.  That target is linear in
    the heteroscedastic Gaussian gradient's three cotangents v1, v2, v3, so
    they are folded into v = -a^2 v1 + v2 + a^2 v3 before the backward
    passes: one surrogate VJP q = J^T v and one prior-net VJP at x (the
    chain rule through Tweedie), s_lik = (q + std^2 (ds_p/dx)^T q) / alpha;
  * ``guidance='pgdm'``: f and the Jacobian J = df/dx0 (three forward
    tangents through the ReLU chain), the Woodbury solve
    u = (D + r^2 J J^T)^-1 (y - f) with the 3 x 3 inner matrix inverted by
    its adjugate, q = J^T u, and one prior-net VJP:
    s_lik = (q + std^2 (ds_p/dx)^T q) / alpha;
  * the norm cap s_lik * min(1, clip / (|s_lik| + 1e-12)) and the E-M update
    with drift g (s_p + s_lik).

Everything is f32: the guidance divides by (a f)^2 + b^2 with b = 0.01, so
TF32 or bf16 products would be amplified a hundredfold.  The kernel
(``csrc/dps_kernel.cu``) is f32 SIMT; :func:`guided_em_reference` is its
plain PyTorch version, the same expressions in the same order as the TPU
kernel (the dps cotangents folded as in the kernel), with TF32 switched
off for its products.  :func:`fused_guided_em_sampler`
takes the plain version only for CPU tensors; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import build

Tensor = torch.Tensor

ROWS = 64            # sample rows per block
MAX_MID = 4          # hidden-to-hidden layers per net
MAX_XDIM = 4
MAX_YDIM = 32
WIDTHS = (64, 128, 256, 512)  # hidden widths are zero-padded up to one of these
# the step's phases, in the order the kernel's clock stamps end them ('pgdm'
# forms q = J^T u inside its solve, so its surr_vjp phase is empty)
PHASES = ("prior_fwd", "prior_out", "surr_fwd", "guidance", "surr_vjp", "prior_vjp", "update")


@contextlib.contextmanager
def _full_f32():
    """f32 products in full precision: TF32 off while the block runs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _check_nets(prior_params, surrogate_params, xdim: int, guidance: str) -> int:
    """Validate the two nets against x's width; returns ydim."""
    if guidance not in ("dps", "pgdm"):
        raise ValueError(f"unknown guidance {guidance!r}")
    if guidance == "pgdm" and xdim != 3:
        raise ValueError(f"the pgdm guidance's closed-form 3x3 Woodbury inverse requires xdim=3, got {xdim}")
    if len(surrogate_params) < 2:
        raise ValueError("the surrogate needs a ReLU hidden layer (>= 2 layers)")
    if len(prior_params) < 2:
        raise ValueError("the prior net needs a tanh hidden layer (>= 2 layers)")
    if prior_params[0][0].shape[0] != xdim + 1:
        raise ValueError(
            f"prior layer 0 consumes {prior_params[0][0].shape[0]} inputs; expected xdim+1={xdim + 1} "
            "([x, t] layout)"
        )
    if surrogate_params[0][0].shape[0] != xdim:
        raise ValueError(f"the surrogate takes {surrogate_params[0][0].shape[0]} inputs, not xdim={xdim}")
    return surrogate_params[-1][0].shape[1]


def _step_range(start_step: int, stop_step: Optional[int], num_steps: int) -> range:
    stop = num_steps if stop_step is None else int(stop_step)
    if not 0 <= start_step < stop <= num_steps:
        raise ValueError(f"need 0 <= start_step < stop_step <= num_steps={num_steps}, got {start_step}, {stop_step}")
    return range(int(start_step), stop)


def guided_em_reference(
    prior_params: Sequence[Tuple[Tensor, Tensor]],
    surrogate_params: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Tensor,
    *,
    a: float,
    b: float,
    guidance_clip: Optional[float] = 100.0,
    num_steps: int = 200,
    T: float = 1.0,
    beta_min: float = 0.1,
    beta_max: float = 20.0,
    lmbd: float = 0.0,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    guidance: str = "dps",
    start_step: int = 0,
    stop_step: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Plain PyTorch version of B5.  x0 (N, xdim), y (ydim,); runs steps
    [start_step, stop_step) of the num_steps grid (default: all of them)
    from x0.  ``noise`` (stop_step - start_step, N, xdim) replaces the
    per-step normals, else they are drawn from ``generator``.  Computes and
    returns (N, xdim) in ``dtype``: float32, as the kernel does, or float64
    to measure the f32 versions' rounding against."""
    n, xdim = x0.shape
    _check_nets(prior_params, surrogate_params, xdim, guidance)
    steps = _step_range(start_step, stop_step, num_steps)
    dev = x0.device
    cast = lambda t: t.to(device=dev, dtype=dtype)
    w1, b1 = prior_params[0]
    w1x, w1t, b1 = cast(w1[:xdim]), cast(w1[xdim]), cast(b1)
    pmid = [(cast(w), cast(bb)) for w, bb in prior_params[1:-1]]
    pwo, pbo = (cast(t) for t in prior_params[-1])
    surr = [(cast(w), cast(bb)) for w, bb in surrogate_params]
    yv = cast(y).reshape(1, -1)
    a2, b2 = a * a, b * b
    gen_dev = generator.device if generator is not None else "cpu"

    def prior_fwd(x, s):
        h = torch.tanh(x @ w1x + s * w1t + b1)
        hs = [h]
        for w, bb in pmid:
            h = torch.tanh(h @ w + bb)
            hs.append(h)
        return h @ pwo + pbo, hs

    def prior_vjp(e, hs):
        ws = [w for w, _ in pmid] + [pwo]
        for w, h in zip(reversed(ws), reversed(hs)):
            e = (e @ w.T) * (1.0 - h * h)
        return e @ w1x.T

    def surr_fwd(x):
        g, gs = x, []
        for w, bb in surr[:-1]:
            g = torch.relu(g @ w + bb)
            gs.append(g)
        return g @ surr[-1][0] + surr[-1][1], gs

    def surr_vjp(d, gs):
        for (w, _), g in zip(reversed(surr[1:]), reversed(gs)):
            d = (d @ w.T) * (g > 0.0).to(dtype)
        return d @ surr[0][0].T

    def dps_score(x_hat0, hs, sig2, alpha):
        f, gs = surr_fwd(x_hat0)
        pinv = 1.0 / ((a2 * f) * f + b2)
        resid = yv - f
        # the cotangents f pinv, resid pinv, resid^2 f pinv^2, folded
        v = (-a2 * (f * pinv) + resid * pinv) + a2 * (((resid * resid) * f) * (pinv * pinv))
        q = surr_vjp(v, gs)
        return (q + sig2 * prior_vjp(q, hs)) / alpha

    def pgdm_score(x_hat0, hs, sig2, alpha):
        r2 = sig2 / (alpha * alpha + sig2)
        (u1, c1), mids, (uo, co) = surr[0], surr[1:-1], surr[-1]
        g = torch.relu(x_hat0 @ u1 + c1)
        m = (g > 0.0).to(dtype)
        tang = torch.cat([m * u1[k : k + 1] for k in range(xdim)])
        for w, bb in mids:
            g = torch.relu(g @ w + bb)
            tang = (tang @ w) * (g > 0.0).to(dtype).repeat(xdim, 1)
        f = g @ uo + co
        j = (tang @ uo).split(n)  # xdim blocks of (N, ydim)
        dinv = 1.0 / ((a2 * f) * f + b2)
        dr = dinv * (yv - f)
        w = [torch.sum(j[k] * dr, dim=1, keepdim=True) for k in range(3)]
        mm = [[(1.0 if k == l else 0.0) + r2 * torch.sum(j[k] * dinv * j[l], dim=1, keepdim=True)
               for l in range(3)] for k in range(3)]
        c00 = mm[1][1] * mm[2][2] - mm[1][2] * mm[2][1]
        c01 = mm[0][2] * mm[2][1] - mm[0][1] * mm[2][2]
        c02 = mm[0][1] * mm[1][2] - mm[0][2] * mm[1][1]
        c11 = mm[0][0] * mm[2][2] - mm[0][2] * mm[2][0]
        c12 = mm[0][2] * mm[1][0] - mm[0][0] * mm[1][2]
        c22 = mm[0][0] * mm[1][1] - mm[0][1] * mm[1][0]
        det = mm[0][0] * c00 + mm[0][1] * (mm[1][2] * mm[2][0] - mm[1][0] * mm[2][2]) \
            + mm[0][2] * (mm[1][0] * mm[2][1] - mm[1][1] * mm[2][0])
        dinv3 = 1.0 / det
        z0 = (c00 * w[0] + c01 * w[1] + c02 * w[2]) * dinv3
        z1 = (c01 * w[0] + c11 * w[1] + c12 * w[2]) * dinv3
        z2 = (c02 * w[0] + c12 * w[1] + c22 * w[2]) * dinv3
        u = dr - r2 * (dinv * (z0 * j[0] + z1 * j[1] + z2 * j[2]))
        q = torch.cat([torch.sum(j[k] * u, dim=1, keepdim=True) for k in range(3)], dim=1)
        return (q + sig2 * prior_vjp(q, hs)) / alpha

    score = dps_score if guidance == "dps" else pgdm_score
    one = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    T_, bmin, bd = one(T), one(beta_min), one(beta_max - beta_min)
    delta = T / num_steps
    x = x0.to(dtype)
    with _full_f32():
        for j, i in enumerate(steps):
            s = T_ - (one(i) / num_steps) * T_
            beta = bmin + bd * s
            g_s = torch.sqrt(beta)
            int_beta = 0.5 * bd * s * s + bmin * s
            alpha = torch.exp(-0.5 * int_beta)
            sig2 = 1.0 - torch.exp(-int_beta)
            s_prior, hs = prior_fwd(x, s)
            s_lik = score((x + sig2 * s_prior) / alpha, hs, sig2, alpha)
            if guidance_clip is not None:
                norm = torch.sqrt(torch.sum(s_lik * s_lik, dim=-1, keepdim=True))
                s_lik = s_lik * torch.clamp(guidance_clip / (norm + 1e-12), max=1.0)
            mu = (1.0 - 0.5 * lmbd) * g_s * (g_s * (s_prior + s_lik)) + 0.5 * beta * x
            x = x + delta * mu
            if noise_scale != 0.0:
                z = noise[j].to(device=dev, dtype=dtype) if noise is not None else torch.randn(
                    x.shape, generator=generator, device=gen_dev).to(device=dev, dtype=dtype)
                x = x + delta**0.5 * ((1.0 - lmbd) ** 0.5 * g_s) * (noise_scale * z)
    return x


def _pad_to(v: int) -> int:
    for w in WIDTHS:
        if v <= w:
            return w
    raise ValueError(f"hidden widths up to {WIDTHS[-1]} are supported, got {v}")


def _pad2(w: Tensor, rows: int, cols: int) -> Tensor:
    out = w.new_zeros(rows, cols)
    out[: w.shape[0], : w.shape[1]] = w
    return out


def _pad1(v: Tensor, n: int) -> Tensor:
    out = v.new_zeros(n)
    out[: v.shape[0]] = v
    return out


def _device_nets(prior_params, surrogate_params, xdim: int):
    """The kernel's layout: f32, hidden widths zero-padded to one width per
    net (H for the prior, S for the surrogate), and every matrix the
    backward passes read beside its transpose, row-major, so each product
    streams weight rows as 16-byte copies.  The narrow matrices (the first
    layer's transpose, the output layer) have their rows zero-padded to a
    multiple of 4 columns, so a row is a run of float4s.  Returns (prior
    pointer tensors, surrogate pointer tensors, H, S)."""
    f32 = lambda t: t.to(torch.float32).contiguous()
    H = _pad_to(max(w.shape[1] for w, _ in prior_params[:-1]))
    S = _pad_to(max(w.shape[1] for w, _ in surrogate_params[:-1]))
    cols4 = lambda n: -(-n // 4) * 4

    def mlp(params, width, first):
        (w1, b1) = params[0]
        parts = list(first(w1, b1, width))
        for w, bb in params[1:-1]:
            wp = f32(_pad2(w, width, width))
            parts += [wp, f32(_pad1(bb, width)), f32(wp.t())]
        wo, bo = params[-1]
        wop = _pad2(wo, width, wo.shape[1])
        return parts + [f32(_pad2(wop, width, cols4(wo.shape[1]))), f32(bo), f32(wop.t())]

    def prior_first(w1, b1, width):
        w1x = _pad2(w1[:xdim], xdim, width)
        return [f32(w1x), f32(_pad1(w1[xdim], width)), f32(_pad1(b1, width)), f32(_pad2(w1x.t(), width, 4))]

    def surr_first(u1, c1, width):
        u1p = _pad2(u1, xdim, width)
        return [f32(u1p), f32(_pad1(c1, width)), f32(_pad2(u1p.t(), width, 4))]

    return mlp(prior_params, H, prior_first), mlp(surrogate_params, S, surr_first), H, S


_ARGTYPES = (
    [ctypes.c_void_p] * 2
    + [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int]
    + [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 8
    + [ctypes.c_float] * 11
    + [ctypes.c_uint64, ctypes.c_void_p]
)


def _launch(prior_params, surrogate_params, x0, y, a, b, guidance_clip, num_steps, T, beta_min,
            beta_max, lmbd, noise_scale, noise, seed, guidance, start_step, stop_step, stamps):
    n, xdim = x0.shape
    dev = x0.device
    ydim = _check_nets(prior_params, surrogate_params, xdim, guidance)
    steps = _step_range(start_step, stop_step, num_steps)
    if not 1 <= xdim <= MAX_XDIM or not 1 <= ydim <= MAX_YDIM:
        raise ValueError(f"the kernel takes xdim <= {MAX_XDIM} and ydim <= {MAX_YDIM}, got {xdim}, {ydim}")
    if len(prior_params) - 2 > MAX_MID or len(surrogate_params) - 2 > MAX_MID:
        raise ValueError(f"the kernel takes up to {MAX_MID} hidden-to-hidden layers per net")
    for w, bb in (*prior_params, *surrogate_params):
        if w.device != dev or bb.device != dev:
            raise ValueError("both nets must lie on the device of x0")
    if x0.dtype != torch.float32 or not x0.is_contiguous():
        raise ValueError("x0 must be a contiguous float32 tensor")
    if y.numel() != ydim:
        raise ValueError(f"y has {y.numel()} entries, the surrogate gives {ydim}")
    if noise is not None:
        if noise.shape != (len(steps), n, xdim) or noise.dtype != torch.float32:
            raise ValueError(f"noise must be float32 of shape {(len(steps), n, xdim)}")
        if noise.device != dev or not noise.is_contiguous():
            raise ValueError("noise must be contiguous on the device of x0")
    if stamps is not None:
        need = 2 * (1 + len(PHASES) * len(steps))
        if stamps.dtype != torch.int64 or stamps.device != dev or stamps.numel() < need:
            raise ValueError(f"stamps must be an int64 tensor of >= {need} entries on {dev}")
    prior, surr, H, S = _device_nets(prior_params, surrogate_params, xdim)
    y_dev = y.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    # per row (and up to a block of rows past the last), the tanh-derivative
    # factors 1 - h^2 of every prior hidden layer
    scratch = torch.empty((n + ROWS) * (len(prior_params) - 1) * H, dtype=torch.float32, device=dev)
    out = torch.empty_like(x0)
    pp = (ctypes.c_uint64 * len(prior))(*[t.data_ptr() for t in prior])
    sp = (ctypes.c_uint64 * len(surr))(*[t.data_ptr() for t in surr])
    delta = T / num_steps
    lib = build.load("dps_kernel")
    fn = lib.guided_em_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    # the launcher sets attributes and launches on the current device
    with torch.cuda.device(dev):
        err = fn(
            x0.data_ptr(), y_dev.data_ptr(), pp, len(prior_params) - 2, H, sp, len(surrogate_params) - 2, S,
            None if noise is None else noise.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            None if stamps is None else stamps.data_ptr(),
            n, xdim, ydim, num_steps, steps.start, steps.stop, int(guidance == "pgdm"),
            int(guidance_clip is not None),
            T, beta_min, beta_max - beta_min, 1.0 - 0.5 * lmbd, (1.0 - lmbd) ** 0.5, delta, delta**0.5,
            noise_scale, a * a, b * b, 0.0 if guidance_clip is None else float(guidance_clip),
            seed & (2**64 - 1), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, err, "guided_em_launch")
    fused_guided_em_sampler.launches += 1
    return out


def fused_guided_em_sampler(
    prior_params: Sequence[Tuple[Tensor, Tensor]],
    surrogate_params: Sequence[Tuple[Tensor, Tensor]],
    x0: Tensor,
    y: Tensor,
    *,
    a: float,
    b: float,
    guidance_clip: Optional[float] = 100.0,
    num_steps: int = 200,
    T: float = 1.0,
    beta_min: float = 0.1,
    beta_max: float = 20.0,
    lmbd: float = 0.0,
    seed: int = 0,
    noise_scale: float = 1.0,
    noise: Optional[Tensor] = None,
    guidance: str = "dps",
    start_step: int = 0,
    stop_step: Optional[int] = None,
    stamps: Optional[Tensor] = None,
) -> Tensor:
    """Run the analytic-guidance sampler from x0 (N, xdim) for the observed
    y (ydim,).  prior_params: the tanh prior net on [x, t]; surrogate_params:
    the ReLU surrogate xdim -> ydim (at least one hidden layer each).
    guidance: 'dps' or 'pgdm' (xdim must be 3); guidance_clip None means no
    cap.  Runs steps [start_step, stop_step) of the num_steps grid (default:
    all of them) from x0.  Returns (N, xdim) float32.

    On a CUDA tensor this launches B5, with Philox noise keyed by ``seed``
    and the step's index on the grid, or ``noise`` (stop_step - start_step,
    N, xdim) when given.  On a CPU tensor it runs
    :func:`guided_em_reference`, drawing noise from a generator seeded with
    ``seed``.

    stamps: None, or an int64 CUDA tensor of >= 2 x (1 + 7 x (stop_step -
    start_step)) entries: block 0 writes the card's clock (ns) and its SM's
    cycle count, a pair, once before the first step and then at the end of
    each of a step's :data:`PHASES`.  The samples do not change.
    """
    kw = dict(a=a, b=b, guidance_clip=guidance_clip, num_steps=num_steps, T=T, beta_min=beta_min,
              beta_max=beta_max, lmbd=lmbd, noise_scale=noise_scale, noise=noise, guidance=guidance,
              start_step=start_step, stop_step=stop_step)
    if x0.device.type == "cpu":
        if stamps is not None:
            raise ValueError("stamps are taken only by the CUDA kernel")
        gen = torch.Generator().manual_seed(seed) if noise is None else None
        return guided_em_reference(prior_params, surrogate_params, x0, y, generator=gen, **kw)
    if x0.device.type != "cuda":
        raise ValueError(f"no kernel for device {x0.device}")
    return _launch(prior_params, surrogate_params, x0, y, a, b, guidance_clip, num_steps, T, beta_min,
                   beta_max, lmbd, noise_scale, noise, seed, guidance, start_step, stop_step, stamps)


fused_guided_em_sampler.launches = 0
