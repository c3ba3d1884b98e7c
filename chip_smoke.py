#!/usr/bin/env python3
"""Smoke test of dmip_tpu_torch on one NVIDIA GPU.

Builds the port's CUDA kernels from ``dmip_tpu_torch/csrc``, holds each
against its plain PyTorch version at the main paths' shapes, then drives
the serving and the training paths through their entry points at full
width:

  * linear evaluation of ``benchmarks/checkpoints/linear_refined_winner``
    (30k samples x 200 E-M steps x 10 repeats per condition);
  * scatterometry ground truth through the MH kernel (30k chains x 1000
    steps x 10 repeats per condition, all in one launch of 300k chains) and
    evaluation of ``benchmarks/checkpoints/cde_500k`` against it;
  * scatterometry serving of ``benchmarks/checkpoints/cdiffe_scat`` (CDiffE,
    27 -> 512^3 -> 26) through the CDiffE kernel, and of
    ``benchmarks/checkpoints/dps_prior`` under analytic DPS guidance
    (``configs/config_scatterometry_dps.yml``: clip 100, 'dps') through the
    guided kernel, against the same ground truth;
  * DSM training of the 512x3 CDE through the fused training kernel
    (``train_backend: fused_pallas``): the linear config's full 1500 epochs,
    scatterometry cut to 2000 epochs, each followed by evaluation through
    the E-M kernel; then the autograd engine (``train_backend: xla``) for a
    few epochs, on DSM and on the unchanged linear config (PINNLoss); then
    the CDiffE (27 -> 26) for 2 launches of the fused training kernel.

The E-M kernel is held against its plain version at both nets' shapes, the
MH kernel at the 300k chains the ground-truth driver gives it, the training
kernel at both nets' shapes (f32 and bf16, a masked epoch, a poisoned batch
under both guards) and at the CDiffE's, the CDiffE kernel at
``cdiffe_scat``'s and a linear CDiffE's shapes, and the guided kernel at the
``dps_prior`` + surrogate shapes in both guidance modes.  Each kernel's
``ms``, ``plain_ms`` and ``bound_ms`` are per launch, averaged over the main
path's launches of each shape.

Launch counts are zeroed just before each path and read just after; the
plain serving path then reruns the same conditions for comparison.  Prints one
line per phase with its seconds, the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # non-tensor f32 peak
H100_BYTES_PER_S = 3.35e12   # HBM3
N_SAMPLES = 30000
EM_STEPS = 200
MH_STEPS = 1000
LIN_CONDITIONS = 5
SCAT_CONDITIONS = 3
REPEATS = 10
MH_CHAINS = REPEATS * N_SAMPLES   # one ground-truth launch per condition

# tolerances, with their reasons
# B1, same noise: bf16 activations round at slightly different sums (f32
# order), so a few rows drift by a bf16 ulp per step; held on the bulk.
B1_MEAN_ABS_TOL = 2e-3
B1_P999_TOL = 5e-2
# B1/B2 with in-kernel Philox vs torch's generator: 30k independent samples,
# mean standard error ~ 0.002-0.003 per coordinate; 0.02 is > 6 sigma.
MOMENT_TOL = 0.02
# B2, same randomness, one step, uniforms kept >= 1e-3 from the accept
# threshold: identical decisions, states equal to f32 rounding.
B2_STEP_TOL = 1e-5
# B2, same randomness, 1000 steps: an f32 sum-order difference in the energy
# can flip an accept that sits on its threshold, after which a chain
# follows another path.
B2_MISMATCH_SHARE = 0.02
LIN_KL_BOUND = 0.03          # near the ~0.01 finite-sample floor of this net
# kernel vs plain path, same conditions: the KL's spread over repeats is
# ~1e-7 and the bf16 kernel sat 1.6e-4 above the f32 plain path.
LIN_KL_AGREE = 3e-3
SCAT_KL_AGREE = 0.1          # kernel (bf16) vs plain (f32) path, same GT
B3_BATCH = 1000
B3_LR = 1e-4
# B3 vs plain, f32, 10 steps: the same arithmetic in another f32 sum order;
# an Adam step moves a weight by at most ~lr, so 1e-5 is a tenth of a step.
B3_F32_PARAM_TOL = 1e-5
B3_F32_MOMENT_REL = 1e-4
B3_F32_LOSS_REL = 1e-5
# B3 vs plain, bf16, 2 epochs: identical bf16 operands, but an f32 sum-order
# difference can move a tanh output across a bf16 rounding edge, and Adam
# turns a small gradient difference into up to one lr-sized step.
B3_BF16_LOSS_REL = 1e-3
B3_BF16_PARAM_TOL = 2e-3
B3_LIN = (5, 2, 90, 25)       # in, out, batches per epoch, epochs per launch
B3_SCAT = (27, 3, 8, 100)
B3_CDIFFE = (27, 26, 8, 100)
LIN_TRAIN_EPOCHS = 1500       # the config's full schedule: 60 launches of 2250 steps
SCAT_TRAIN_EPOCHS = 2000      # cut from 20000: 20 launches of 800 steps
# the JAX package's DSM net reaches ~0.011 at 1500 epochs; ~0.01 is the
# evaluation's finite-sample floor
TRAIN_LIN_KL_BOUND = 0.03
# B4, same noise and noise off: the same bf16 rounding rule as B1, so B1's
# tolerances; the linear CDiffE net has random weights
B4_MEAN_ABS_TOL = 2e-3
B4_P999_TOL = 5e-2
B4_LIN_NET = (5, 4)           # linear CDiffE: [x, y, t] = 5 -> 512^3 -> xdim + ydim = 4
# CDiffE serving, kernel (bf16) vs plain (f32) KL on the same GT: at least
# SCAT_KL_AGREE, widened to 3x the plain path's own spread between two seeds
SCAT_CDIFFE_SPREAD_FACTOR = 3.0
DPS_REPEATS = 2               # analytic-DPS serving: n_repeats cut from 10
CDIFFE_TRAIN = dict(n_epochs=200, epochs_per_call=100)  # 2 B3 launches of 100 epochs x 8 steps
CDIFFE_TRAIN_REPEATS = 2
# B5 over 200 steps, per condition, as tools/fused_dps_sanity.py judges the
# Pallas kernel: fail if the sliced W2 between kernel and plain samples is
# above 0.02 (the GT-vs-GT floor at 30k samples is ~0.003) and above 2.5x
# the plain-vs-plain W2 under an independent noise stream
B5_W2_ABS = 0.02
B5_W2_RATIO = 2.5
B5_MODES = (("dps", 100.0), ("dps", 10.0), ("pgdm", 100.0))
# B5 step by step: every step of the 200-step grid, kernel and plain from
# the plain trajectory's state with the same noise.  Whole trajectories
# cannot be held row by row: near s = T (alpha ~ 0.007, guidance norms of
# 1e4 capped) one step amplifies a difference in x about tenfold, so f32
# sum-order differences grow to O(1) within ten steps.  One step from the
# same state differs only in f32 sum order, except where a ReLU
# pre-activation sits at 0 and flips its mask in one version only.  Each
# row's error is taken relative to the length of its step.  A probe on an
# H100 read medians of 5e-7 to 1.5e-6, p999 of 1.3e-4 to 1.2e-3 and at most
# 1.6e-4 of the pairs above 1e-2 in the four modes; a wrong term in the
# guidance moves every row by percents.
B5_STEP_P50_TOL = 1e-4
B5_STEP_P999_TOL = 5e-3
B5_STEP_SHARE = 1e-3           # of (step, row) pairs further apart than 1e-2 of the step


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def phase(name: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3), **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def em_work(params, n: int, steps: int):
    """(FLOPs, bytes) the E-M sampler must do: every product of every step,
    x0 read and x written once, the weights read once."""
    xdim = params[-1][0].shape[1]
    macs = sum(w.shape[0] * w.shape[1] for w, _ in params) - (params[0][0].shape[0] - xdim) * params[0][0].shape[1]
    hidden = sum(w.numel() for w, _ in params[1:-1])
    weight_bytes = 2 * hidden + 4 * (params[0][0].numel() + params[-1][0].numel() + sum(b.numel() for _, b in params))
    return 2.0 * n * steps * macs, 2 * n * xdim * 4 + weight_bytes


def mh_work(weights, n: int, steps: int):
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
    wbytes = 4 * sum(w.numel() + b.numel() for w, b in weights)
    return 2.0 * n * (steps + 1) * macs, 2 * n * 3 * 4 + wbytes


def cdiffe_work(params, xdim: int, n: int, steps: int):
    """(FLOPs, bytes) of the CDiffE sampler: per step the first layer over
    [x, y_t], the hidden products and the output's x block; x0 read and x
    written once, the weights read once."""
    width, h1 = params[0][0].shape[0] - 1, params[0][0].shape[1]
    hidden = sum(w.numel() for w, _ in params[1:-1])
    macs = width * h1 + hidden + params[-1][0].shape[0] * xdim
    weight_bytes = 2 * hidden + 4 * (params[0][0].numel() + params[-1][0].numel() + sum(b.numel() for _, b in params))
    return 2.0 * n * steps * macs, 2 * n * xdim * 4 + weight_bytes


def guided_work(prior, surr, n: int, steps: int, guidance: str):
    """(FLOPs, bytes) of the guided sampler per launch.  Per sample-step:
    'dps' a prior forward and one VJP, a surrogate forward and one VJP (the
    target is linear in its three cotangents, so one backward pass per net
    computes it); 'pgdm' a prior forward and one VJP, a surrogate forward
    and three Jacobian tangents (the first ReLU layer's tangent is a mask,
    no product).  x0 read and x written once, both nets read once (f32)."""
    xdim = prior[-1][0].shape[1]
    p_macs = xdim * prior[0][0].shape[1] + sum(w.numel() for w, _ in prior[1:])
    s_macs = sum(w.numel() for w, _ in surr)
    if guidance == "dps":
        macs = 2 * p_macs + 2 * s_macs
    else:
        macs = 2 * p_macs + s_macs + 3 * sum(w.numel() for w, _ in surr[1:])
    nbytes = 2 * n * xdim * 4 + 4 * sum(w.numel() + b.numel() for w, b in (*prior, *surr))
    return 2.0 * n * steps * macs, nbytes


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_b1(torch, params, y, gen):
    """B1 against its plain version on the net ``params`` and condition y,
    at the serving path's 30k samples x 200 steps."""
    from dmip_tpu_torch.ops.em_kernel import em_sampler_reference, fused_em_sampler

    xdim = params[-1][0].shape[1]
    x0 = torch.randn(N_SAMPLES, xdim, generator=gen, device="cuda")
    noise = torch.randn(EM_STEPS, N_SAMPLES, xdim, generator=gen, device="cuda")
    out_k = fused_em_sampler(params, x0, y, EM_STEPS, noise=noise)
    out_p = em_sampler_reference(params, x0, y, EM_STEPS, noise=noise)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "B1 produced non-finite samples")
    err = (out_k - out_p).abs().amax(dim=1)
    res = {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "p999_abs_err": float(torch.quantile(err, 0.999)),
    }
    check(res["mean_abs_err"] <= B1_MEAN_ABS_TOL and res["p999_abs_err"] <= B1_P999_TOL,
          f"B1 vs plain (same noise) out of tolerance: {res}")
    xk = fused_em_sampler(params, x0, y, EM_STEPS, seed=1234)
    xp = em_sampler_reference(params, x0, y, EM_STEPS, generator=gen)
    dm = float((xk.mean(0) - xp.mean(0)).abs().max())
    dc = float((torch.cov(xk.T) - torch.cov(xp.T)).abs().max())
    res.update(philox_mean_diff=dm, philox_cov_diff=dc)
    check(dm <= MOMENT_TOL and dc <= MOMENT_TOL, f"B1 Philox moments off: {res}")
    return res


def check_b2(torch, weights, y, gen, fparams):
    from dmip_tpu_torch.ops.mh_kernel import fused_mh_scatterometry, mh_chains_reference
    from dmip_tpu_torch.problems.scatterometry import get_log_posterior, surrogate_apply

    kw = dict(noise_std=0.5, a=fparams["a"], b=fparams["b"], lambd_bd=fparams["lambd_bd"])
    x0 = torch.rand(MH_CHAINS, 3, generator=gen, device="cuda") * 2 - 1
    # one step, uniforms moved >= 1e-3 away from the plain accept threshold
    z1 = torch.randn(1, MH_CHAINS, 3, generator=gen, device="cuda")
    u1 = torch.rand(1, MH_CHAINS, generator=gen, device="cuda")
    energy = lambda x: get_log_posterior(x, lambda v: surrogate_apply(weights, v), kw["a"], kw["b"],
                                         y.reshape(1, -1), kw["lambd_bd"])
    thr = torch.exp(energy(x0) - energy(x0 + 0.5 * z1[0])).clamp(max=2.0)
    near = (u1[0] - thr).abs() < 1e-3
    u1[0] = torch.where(near, torch.where(thr > 2e-3, thr - 2e-3, thr + 2e-3), u1[0])
    s_k = fused_mh_scatterometry(weights, x0, y, 1, noise=z1, uniforms=u1, **kw)
    s_p = mh_chains_reference(weights, x0, y, 1, noise=z1, uniforms=u1, **kw)
    step_err = float((s_k - s_p).abs().max())
    check(step_err <= B2_STEP_TOL, f"B2 one-step vs plain: max abs err {step_err}")
    # full run, same randomness
    z = torch.randn(MH_STEPS, MH_CHAINS, 3, generator=gen, device="cuda")
    u = torch.rand(MH_STEPS, MH_CHAINS, generator=gen, device="cuda")
    f_k = fused_mh_scatterometry(weights, x0, y, MH_STEPS, noise=z, uniforms=u, **kw)
    f_p = mh_chains_reference(weights, x0, y, MH_STEPS, noise=z, uniforms=u, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(f_k).all()), "B2 produced non-finite states")
    share = float(((f_k - f_p).abs().amax(dim=1) > 1e-4).float().mean())
    del z, u
    check(share <= B2_MISMATCH_SHARE, f"B2 vs plain: {share:.4f} of chains differ")
    g_k = fused_mh_scatterometry(weights, x0, y, MH_STEPS, seed=4321, **kw)
    g_p = mh_chains_reference(weights, x0, y, MH_STEPS, generator=gen, **kw)
    dm = float((g_k.mean(0) - g_p.mean(0)).abs().max())
    ds = float((g_k.std(0) - g_p.std(0)).abs().max())
    res = {"max_abs_err": step_err, "mismatch_share_1000_steps": share,
           "philox_mean_diff": dm, "philox_std_diff": ds}
    check(dm <= MOMENT_TOL and ds <= MOMENT_TOL, f"B2 Philox moments off: {res}")
    return res


def check_b4(torch, params, y, gen, moments=True):
    """B4 against its plain version on the joint net ``params`` and
    condition y at the serving path's 30k samples x 200 steps: the same x0
    and (steps, N, xdim + ydim) noise, and the noise-off trajectory; with
    ``moments``, the Philox stream's moments against torch's."""
    from dmip_tpu_torch.ops.em_kernel import em_cdiffe_reference, fused_em_sampler_cdiffe

    width = params[0][0].shape[0] - 1
    xdim = width - y.numel()
    x0 = torch.randn(N_SAMPLES, xdim, generator=gen, device="cuda")
    noise = torch.randn(EM_STEPS, N_SAMPLES, width, generator=gen, device="cuda")
    res = {}
    for label, kw in (("same_noise", dict(noise=noise)), ("noise_off", dict(noise_scale=0.0))):
        out_k = fused_em_sampler_cdiffe(params, x0, y, EM_STEPS, **kw)
        out_p = em_cdiffe_reference(params, x0, y, EM_STEPS, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"B4 ({label}) produced non-finite samples")
        err = (out_k - out_p).abs().amax(dim=1)
        r = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
             "p999_abs_err": float(torch.quantile(err, 0.999))}
        res.update({f"{label}_{k}": v for k, v in r.items()})
        check(r["mean_abs_err"] <= B4_MEAN_ABS_TOL and r["p999_abs_err"] <= B4_P999_TOL,
              f"B4 vs plain ({label}) out of tolerance: {r}")
    del noise
    res["max_abs_err"] = max(res["same_noise_max_abs_err"], res["noise_off_max_abs_err"])
    if moments:
        xk = fused_em_sampler_cdiffe(params, x0, y, EM_STEPS, seed=1234)
        xp = em_cdiffe_reference(params, x0, y, EM_STEPS, generator=gen)
        dm = float((xk.mean(0) - xp.mean(0)).abs().max())
        dc = float((torch.cov(xk.T) - torch.cov(xp.T)).abs().max())
        res.update(philox_mean_diff=dm, philox_cov_diff=dc)
        check(dm <= MOMENT_TOL and dc <= MOMENT_TOL, f"B4 Philox moments off: {res}")
    return res


def check_b5_steps(torch, prior, weights, y, gen, kw):
    """B5 against its plain version one step at a time over the 200-step
    grid: from the plain trajectory's state, the same noise.  Returns the
    per-(step, row) error quantiles, relative to the row's step length."""
    from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler, guided_em_reference

    x = torch.randn(N_SAMPLES, 3, generator=gen, device="cuda")
    rel, worst = [], 0.0
    for i in range(EM_STEPS):
        run = dict(num_steps=EM_STEPS, start_step=i, stop_step=i + 1,
                   noise=torch.randn(1, N_SAMPLES, 3, generator=gen, device="cuda"), **kw)
        xk = fused_guided_em_sampler(prior, weights, x, y, **run)
        xp = guided_em_reference(prior, weights, x, y, **run)
        check(bool(torch.isfinite(xk).all()), f"B5 step {i} produced non-finite samples ({kw})")
        err = (xk - xp).abs().amax(dim=1)
        worst = max(worst, float(err.max()))
        rel.append(err / (xp - x).abs().amax(dim=1).clamp(min=1e-6))
        x = xp
    rel = torch.cat(rel)
    q = torch.quantile(rel[torch.randperm(rel.numel(), generator=gen, device="cuda")[:10**6]],
                       torch.tensor([0.5, 0.999], device="cuda"))
    res = {"step_rel_p50": float(q[0]), "step_rel_p999": float(q[1]), "step_rel_max": float(rel.max()),
           "step_share_above_1e-2": float((rel > 1e-2).float().mean()), "step_max_abs_err": worst}
    check(res["step_rel_p50"] <= B5_STEP_P50_TOL and res["step_rel_p999"] <= B5_STEP_P999_TOL
          and res["step_share_above_1e-2"] <= B5_STEP_SHARE,
          f"B5 vs plain (step by step, {kw}) out of tolerance: {res}")
    return res


def check_b5(torch, prior, weights, ys, gen):
    """B5 against its plain version at the dps_prior + surrogate shapes, f32,
    for each guidance mode: every step of the 200-step grid from the same
    state and noise, and over the full 200 steps the per-condition
    sliced-W2 criterion."""
    from dmip_tpu_torch.evaluate import sliced_w2
    from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler, guided_em_reference

    res = {}
    dirs = torch.randn(128, 3, generator=gen, device="cuda")
    for guidance, clip in B5_MODES:
        mode = f"{guidance}_clip{clip:g}"
        kw = dict(a=0.2, b=0.01, guidance_clip=clip, guidance=guidance)
        steps = check_b5_steps(torch, prior, weights, ys[0], gen, kw)
        res.update({f"{mode}_{k}": v for k, v in steps.items()})
        w2 = []
        for i in range(SCAT_CONDITIONS):
            x0 = torch.randn(N_SAMPLES, 3, generator=gen, device="cuda")
            xk = fused_guided_em_sampler(prior, weights, x0, ys[i], num_steps=EM_STEPS, seed=100 + i, **kw)
            xp = guided_em_reference(prior, weights, x0, ys[i], num_steps=EM_STEPS, generator=gen, **kw)
            xq = guided_em_reference(prior, weights, x0, ys[i], num_steps=EM_STEPS, generator=gen, **kw)
            check(bool(torch.isfinite(xk).all()), f"B5 {mode} produced non-finite samples")
            kp, pp = float(sliced_w2(xk, xp, dirs=dirs)), float(sliced_w2(xq, xp, dirs=dirs))
            w2.append((kp, pp))
            check(not (kp > B5_W2_ABS and kp > B5_W2_RATIO * pp),
                  f"B5 {mode} condition {i}: sliced W2 kernel-plain {kp} vs plain-plain floor {pp}")
        res[f"{mode}_w2_kernel_plain"] = [a for a, _ in w2]
        res[f"{mode}_w2_plain_plain"] = [b for _, b in w2]
    res["max_abs_err"] = max(v for k, v in res.items() if k.endswith("step_max_abs_err"))
    return res


def b3_inputs(torch, in_dim, out_dim, n_batches, n_epochs, gen, hidden=(512, 512, 512)):
    """A net of random weights, Adam moments as after a few steps, and
    n_epochs x n_batches batches of DSM inputs at B = 1000: h0 = [z_t, y, t]
    with t in the debiased sampler's range, eps ~ N(0, 1), s1 = std/g."""
    from dmip_tpu_torch.nets import mlp_init
    from dmip_tpu_torch.sde import VPSDE

    params = mlp_init(in_dim, out_dim, hidden, generator=torch.Generator().manual_seed(11), device="cuda")
    mu = tuple((1e-3 * torch.randn(w.shape, generator=gen, device="cuda"),
                1e-3 * torch.randn(b.shape, generator=gen, device="cuda")) for w, b in params)
    nu = tuple((m[0] ** 2, m[1] ** 2) for m in mu)
    rows = n_epochs * n_batches * B3_BATCH
    t = 1e-4 + torch.rand(rows, 1, generator=gen, device="cuda") * (1 - 1e-4)
    h0 = torch.cat([torch.randn(rows, in_dim - 1, generator=gen, device="cuda"), t], 1).contiguous()
    eps = torch.randn(rows, out_dim, generator=gen, device="cuda")
    base = VPSDE()
    s1 = (base.std(t) / base.g(t)).expand(rows, out_dim).contiguous()
    return params, mu, nu, h0, eps, s1


def _max_err(a, b):
    return max(float((x - y).abs().max()) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def _rel_err(a, b):
    return max(float((x - y).abs().max() / (y.abs().max() + 1e-30)) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def check_b3(torch, in_dim, out_dim, n_batches, gen, full=True):
    """B3 against its plain version at one net's shapes, from the same
    params, moments and count on the same batches: f32 for 10 steps, and
    with ``full`` bf16 for 2 epochs, the masked epoch and a poisoned batch
    under both guards."""
    from dmip_tpu_torch.ops.dsm_train_kernel import dsm_train_epochs_reference, fused_dsm_train_epochs

    res = {}
    params, mu, nu, h0, eps, s1 = b3_inputs(torch, in_dim, out_dim, n_batches, 2, gen)
    kw = dict(batch_real=B3_BATCH, lr=B3_LR)
    steps = min(10, n_batches)
    rows = steps * B3_BATCH
    one = (h0[:rows], eps[:rows], s1[:rows])
    k = fused_dsm_train_epochs(params, mu, nu, 7, *one, n_epochs=1, n_batches=steps, n_active=1,
                               compute_dtype=torch.float32, **kw)
    r = dsm_train_epochs_reference(params, mu, nu, 7, *one, n_epochs=1, n_batches=steps, n_active=1,
                                   compute_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    res["f32_params_max_abs"] = _max_err(k[0], r[0])
    res["f32_mu_rel"] = _rel_err(k[1], r[1])
    res["f32_nu_rel"] = _rel_err(k[2], r[2])
    res["f32_loss_rel"] = float(((k[4] - r[4]).abs() / r[4].abs()).max())
    res["moved"] = _max_err(k[0], params)
    check(int(k[3]) == int(r[3]) == 7 + steps, f"B3 f32 counts {int(k[3])} vs {int(r[3])}")
    check(res["f32_params_max_abs"] <= B3_F32_PARAM_TOL and res["f32_mu_rel"] <= B3_F32_MOMENT_REL
          and res["f32_nu_rel"] <= B3_F32_MOMENT_REL and res["f32_loss_rel"] <= B3_F32_LOSS_REL,
          f"B3 f32 vs plain out of tolerance: {res}")
    if not full:
        return res
    args = (params, mu, nu, 7, h0, eps, s1)
    k = fused_dsm_train_epochs(*args, n_epochs=2, n_batches=n_batches, n_active=2, **kw)
    r = dsm_train_epochs_reference(*args, n_epochs=2, n_batches=n_batches, n_active=2, **kw)
    torch.cuda.synchronize()
    res["bf16_params_max_abs"] = _max_err(k[0], r[0])
    res["bf16_loss_rel"] = float(((k[4] - r[4]).abs() / r[4].abs()).max())
    check(int(k[3]) == int(r[3]) == 7 + 2 * n_batches, "B3 bf16 counts differ")
    check(res["bf16_loss_rel"] <= B3_BF16_LOSS_REL and res["bf16_params_max_abs"] <= B3_BF16_PARAM_TOL,
          f"B3 bf16 vs plain out of tolerance: {res}")
    # n_active = 1 of 2: the second epoch computes but does not update
    masked = fused_dsm_train_epochs(*args, n_epochs=2, n_batches=n_batches, n_active=1, **kw)
    rows = n_batches * B3_BATCH
    first = fused_dsm_train_epochs(params, mu, nu, 7, h0[:rows], eps[:rows], s1[:rows], n_epochs=1,
                                   n_batches=n_batches, n_active=1, **kw)
    res["masked_vs_one_epoch"] = max(_max_err(masked[j], first[j]) for j in range(3))
    check(res["masked_vs_one_epoch"] == 0.0 and int(masked[3]) == int(first[3]) == 7 + n_batches,
          f"B3 masked epoch moved the state: {res}")
    # a NaN in batch 1 of 3: under both guards the step leaves everything as
    # it was, so the result equals the run on batches 0 and 2 alone
    b = B3_BATCH
    h0p = h0[:3 * b].clone()
    h0p[b + 17, 0] = float("nan")
    clean = [torch.cat([x[:b], x[2 * b:3 * b]]) for x in (h0, eps, s1)]
    skip = fused_dsm_train_epochs(params, mu, nu, 7, *clean, n_epochs=1, n_batches=2, n_active=1, **kw)
    for guard in (True, "loss"):
        out = fused_dsm_train_epochs(params, mu, nu, 7, h0p, eps[:3 * b], s1[:3 * b], n_epochs=1,
                                     n_batches=3, n_active=1, skip_nonfinite=guard, **kw)
        err = max(_max_err(out[j], skip[j]) for j in range(3))
        res[f"poisoned_{guard}"] = err
        check(err == 0.0 and int(out[3]) == 7 + 2, f"B3 guard {guard!r} let the NaN step through: {res}")
    return res


def serve(torch, lin_cfg, scat_cfg, gt_dir) -> dict:
    """The serving path through its entry points, kernel launches counted
    from zero; then the plain path on the same conditions.  Leaves the
    scatterometry GT in ``gt_dir``.  Returns the launch counts."""
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.ops import fused_em_sampler, fused_mh_scatterometry

    lin_ckpt = os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner")
    scat_ckpt = os.path.join(REPO, "benchmarks/checkpoints/cde_500k")
    lin = dict(lin_cfg, n_samples_y=LIN_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=REPEATS)
    sc = dict(scat_cfg, n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=REPEATS)
    fused_em_sampler.launches = 0
    fused_mh_scatterometry.launches = 0
    t0 = time.time()
    lin_k = eval_diffusion.run("linear", lin_ckpt, lin, device="cuda", out_dir=os.path.join(gt_dir, "lin"))
    torch.cuda.synchronize()
    em_linear = fused_em_sampler.launches
    phase("serve_linear", t0, conditions=LIN_CONDITIONS, KL=lin_k[0], NLPD=lin_k[1], score_MSE=lin_k[2])
    t0 = time.time()
    gt.run(sc, gt_dir, device="cuda")
    torch.cuda.synchronize()
    phase("serve_scat_gt", t0, conditions=SCAT_CONDITIONS, chains=MH_CHAINS, steps=MH_STEPS)
    t0 = time.time()
    scat_k = eval_diffusion.run("scatterometry", scat_ckpt, sc, gt_dir=gt_dir, device="cuda",
                                out_dir=os.path.join(gt_dir, "scat"))
    torch.cuda.synchronize()
    launches = {"em": fused_em_sampler.launches, "mh": fused_mh_scatterometry.launches,
                "em_linear": em_linear}
    with open(os.path.join(gt_dir, "scat", "results.csv")) as f:
        rows = [ln.strip().split(",") for ln in f][1:]
    kl_rev = sum(float(r[2]) for r in rows) / len(rows)
    w2 = sum(float(r[6]) for r in rows) / len(rows)
    phase("serve_scat_eval", t0, conditions=SCAT_CONDITIONS, KL=scat_k[0], KL_reverse=kl_rev,
          NLPD=scat_k[1], score_MSE=scat_k[2], W2=w2, launches=launches)
    check(launches["em"] > 0 and launches["mh"] > 0, f"a kernel was not launched: {launches}")
    check(launches["em_linear"] == REPEATS * LIN_CONDITIONS
          and launches["em"] == REPEATS * (LIN_CONDITIONS + SCAT_CONDITIONS)
          and launches["mh"] == SCAT_CONDITIONS, f"unexpected launch counts {launches}")

    t0 = time.time()
    lin_p = eval_diffusion.run("linear", lin_ckpt, lin, device="cuda", method="plain",
                               out_dir=os.path.join(gt_dir, "lin_plain"))
    scat_p = eval_diffusion.run("scatterometry", scat_ckpt, sc, gt_dir=gt_dir, device="cuda",
                                method="plain", out_dir=os.path.join(gt_dir, "scat_plain"))
    phase("serve_plain", t0, linear_KL=lin_p[0], linear_NLPD=lin_p[1], scat_KL=scat_p[0],
          scat_NLPD=scat_p[1])
    check(lin_k[0] < LIN_KL_BOUND, f"linear KL {lin_k[0]} above {LIN_KL_BOUND}")
    check(abs(lin_k[0] - lin_p[0]) <= LIN_KL_AGREE, f"linear KL kernel {lin_k[0]} vs plain {lin_p[0]}")
    finite = all(v == v and abs(v) != float("inf") for v in (*scat_k, kl_rev, w2))
    check(finite, f"non-finite scatterometry metrics {scat_k}")
    check(abs(scat_k[0] - scat_p[0]) <= SCAT_KL_AGREE,
          f"scatterometry KL kernel {scat_k[0]} vs plain {scat_p[0]}")
    return launches


def _results(path):
    """Column means of a results.csv."""
    with open(path) as f:
        rows = [ln.strip().split(",") for ln in f]
    cols = rows[0][1:]
    return {c: sum(float(r[j + 1]) for r in rows[1:]) / (len(rows) - 1) for j, c in enumerate(cols)}


def _finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def serve_cdiffe_dps(torch, gt_dir) -> dict:
    """CDiffE and analytic-DPS serving through the eval driver against the
    serving phase's GT (same RANDOM_STATE, same conditions), launches
    counted from zero around each; then the CDiffE's plain path twice (two
    seeds) for the KL comparison.  Returns the launch counts."""
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.ops import fused_em_sampler_cdiffe, fused_guided_em_sampler
    from dmip_tpu_torch.utils import load_config

    ckpt = lambda name: os.path.join(REPO, "benchmarks/checkpoints", name)
    cd = dict(load_config(os.path.join(REPO, "configs/config_scatterometry_cdiffe.yml")),
              n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=REPEATS)
    fused_em_sampler_cdiffe.launches = 0
    t0 = time.time()
    k = eval_diffusion.run("scatterometry", ckpt("cdiffe_scat"), cd, gt_dir=gt_dir, device="cuda",
                           out_dir=os.path.join(gt_dir, "cdiffe"))
    torch.cuda.synchronize()
    n_b4 = fused_em_sampler_cdiffe.launches
    cols = _results(os.path.join(gt_dir, "cdiffe", "results.csv"))
    phase("serve_scat_cdiffe", t0, conditions=SCAT_CONDITIONS, repeats=REPEATS, KL=k[0], KL_reverse=cols["KL_reverse"],
          NLPD=k[1], score_MSE=k[2], W2=cols["W2"], launches=n_b4)
    check(n_b4 == REPEATS * SCAT_CONDITIONS, f"serve_scat_cdiffe: {n_b4} B4 launches")
    check(_finite([*k, *cols.values()]), f"non-finite CDiffE metrics {cols}")
    t0 = time.time()
    p = [eval_diffusion.run("scatterometry", ckpt("cdiffe_scat"), cd, gt_dir=gt_dir, device="cuda", method="plain",
                            seed=s, out_dir=os.path.join(gt_dir, f"cdiffe_plain{s}")) for s in (0, 1)]
    tol = max(SCAT_KL_AGREE, SCAT_CDIFFE_SPREAD_FACTOR * abs(p[0][0] - p[1][0]))
    phase("serve_scat_cdiffe_plain", t0, KL_seed0=p[0][0], KL_seed1=p[1][0], NLPD_seed0=p[0][1], KL_tolerance=tol)
    check(fused_em_sampler_cdiffe.launches == n_b4, "the plain path launched B4")
    check(abs(k[0] - p[0][0]) <= tol, f"CDiffE KL kernel {k[0]} vs plain {p[0][0]} (tolerance {tol})")

    dps = dict(load_config(os.path.join(REPO, "configs/config_scatterometry_dps.yml")),
               n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=DPS_REPEATS)
    fused_guided_em_sampler.launches = 0
    t0 = time.time()
    d = eval_diffusion.run("scatterometry", ckpt("dps_prior"), dps, gt_dir=gt_dir, device="cuda",
                           out_dir=os.path.join(gt_dir, "dps"))
    torch.cuda.synchronize()
    n_b5 = fused_guided_em_sampler.launches
    cols = _results(os.path.join(gt_dir, "dps_analytic", "results.csv"))
    phase("serve_scat_dps", t0, conditions=SCAT_CONDITIONS, repeats=DPS_REPEATS, guidance="dps",
          guidance_clip=dps["guidance_clip"], KL=d[0], KL_reverse=cols["KL_reverse"], NLPD=d[1], score_MSE=d[2],
          W2=cols["W2"], launches=n_b5)
    check(n_b5 == DPS_REPEATS * SCAT_CONDITIONS, f"serve_scat_dps: {n_b5} B5 launches")
    check(_finite([*d, *cols.values()]), f"non-finite analytic-DPS metrics {cols}")
    return {"em_cdiffe": n_b4, "guided": n_b5}


def train_cdiffe(torch, gt_dir, gen) -> dict:
    """B3 against its plain version at the CDiffE's 27 -> 26 shapes (f32, 8
    steps), then CDiffE DSM training through the driver on the fused engine
    (2 launches), evaluated through B4."""
    from dmip_tpu_torch.mains import main_diffusion_scatterometry as mscat
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler_cdiffe
    from dmip_tpu_torch.utils import load_config

    t0 = time.time()
    b3 = check_b3(torch, B3_CDIFFE[0], B3_CDIFFE[1], B3_CDIFFE[2], gen, full=False)
    cfg = dict(load_config(os.path.join(REPO, "configs/config_scatterometry_cdiffe.yml")), **CDIFFE_TRAIN,
               train_backend="fused_pallas", n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES,
               n_repeats=CDIFFE_TRAIN_REPEATS, train_dir=os.path.join(gt_dir, "train_cdiffe"),
               out_dir=os.path.join(gt_dir, "out_cdiffe"))
    fused_dsm_train_epochs.launches = fused_em_sampler_cdiffe.launches = 0
    _, m = mscat.run(cfg, gt_dir, device="cuda")
    torch.cuda.synchronize()
    n = {"dsm_train": fused_dsm_train_epochs.launches, "em_cdiffe": fused_em_sampler_cdiffe.launches}
    _, losses, _ = train_log(cfg)
    phase("train_cdiffe", t0, b3_vs_plain=b3, epochs=cfg["n_epochs"], launches=n, first_loss=losses[0],
          last_loss=losses[-1], KL=m[0], NLPD=m[1], score_MSE=m[2])
    check(n == {"dsm_train": cfg["n_epochs"] // cfg["epochs_per_call"],
                "em_cdiffe": CDIFFE_TRAIN_REPEATS * SCAT_CONDITIONS}, f"train_cdiffe launches {n}")
    check(_finite(m) and losses[-1] < losses[0], f"CDiffE training: metrics {m}, losses {losses[0]} -> {losses[-1]}")
    return n


def train_log(cfg):
    """(epochs, losses, seconds) of the run's Train/Loss events, in order."""
    with open(os.path.join(cfg["train_dir"], "logs", "events.jsonl")) as f:
        ev = [json.loads(ln) for ln in f]
    ev = [e for e in ev if e["tag"] == "Train/Loss"]
    return [e["step"] for e in ev], [e["value"] for e in ev], [e["t"] for e in ev]


def epochs_per_s(cfg) -> float:
    """Steady-state rate: epochs between the end of the first call to the
    epoch engine and the end of the last, over the time between them."""
    steps, _, ts = train_log(cfg)
    epc = int(cfg["epochs_per_call"])
    ends = [(s, t) for s, t in zip(steps, ts) if s % epc == epc - 1 or s == steps[-1]]
    return (ends[-1][0] - ends[0][0]) / (ends[-1][1] - ends[0][1])


def train(torch, lin_cfg, scat_cfg, gt_dir) -> dict:
    """The training path through the drivers: DSM on the fused kernel for
    both problems (launches counted from zero around each), then the
    autograd engine on the same overrides and on the unchanged linear config.
    Returns the launch counts."""
    from dmip_tpu_torch.mains import main_diffusion_linear as mlin
    from dmip_tpu_torch.mains import main_diffusion_scatterometry as mscat
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler

    def dirs(name):
        return dict(train_dir=os.path.join(gt_dir, "train_" + name), out_dir=os.path.join(gt_dir, "out_" + name))

    fused = dict(loss_fn="DSM", train_backend="fused_pallas")
    lin = dict(lin_cfg, n_epochs=LIN_TRAIN_EPOCHS, n_samples_y=LIN_CONDITIONS, n_samples_x=N_SAMPLES,
               n_repeats=REPEATS, **fused, **dirs("lin"))
    fused_dsm_train_epochs.launches = fused_em_sampler.launches = 0
    t0 = time.time()
    _, lin_m = mlin.run(lin, device="cuda")
    torch.cuda.synchronize()
    n_lin = {"dsm_train": fused_dsm_train_epochs.launches, "em": fused_em_sampler.launches}
    _, losses, _ = train_log(lin)
    phase("train_linear", t0, epochs=LIN_TRAIN_EPOCHS, launches=n_lin, first_loss=losses[0], last_loss=losses[-1],
          epochs_per_s=epochs_per_s(lin), KL=lin_m[0], NLPD=lin_m[1], score_MSE=lin_m[2])
    check(n_lin == {"dsm_train": LIN_TRAIN_EPOCHS // lin["epochs_per_call"], "em": REPEATS * LIN_CONDITIONS},
          f"train_linear launches {n_lin}")
    check(lin_m[0] <= TRAIN_LIN_KL_BOUND, f"trained linear KL {lin_m[0]} above {TRAIN_LIN_KL_BOUND}")
    check(losses[-1] < losses[0], f"linear DSM loss did not fall: {losses[0]} -> {losses[-1]}")

    sc = dict(scat_cfg, n_epochs=SCAT_TRAIN_EPOCHS, n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES,
              n_repeats=REPEATS, **fused, **dirs("scat"))
    fused_dsm_train_epochs.launches = fused_em_sampler.launches = 0
    t0 = time.time()
    _, scat_m = mscat.run(sc, gt_dir, device="cuda")
    torch.cuda.synchronize()
    n_scat = {"dsm_train": fused_dsm_train_epochs.launches, "em": fused_em_sampler.launches}
    _, losses, _ = train_log(sc)
    phase("train_scat", t0, epochs=SCAT_TRAIN_EPOCHS, launches=n_scat, first_loss=losses[0], last_loss=losses[-1],
          epochs_per_s=epochs_per_s(sc), KL=scat_m[0], NLPD=scat_m[1], score_MSE=scat_m[2])
    check(n_scat == {"dsm_train": SCAT_TRAIN_EPOCHS // sc["epochs_per_call"], "em": REPEATS * SCAT_CONDITIONS},
          f"train_scat launches {n_scat}")
    check(all(v == v and abs(v) != float("inf") for v in scat_m), f"non-finite scatterometry metrics {scat_m}")
    check(losses[-1] < losses[0], f"scatterometry DSM loss did not fall: {losses[0]} -> {losses[-1]}")

    # the autograd engine, one epoch per call; evaluation cut to one small condition
    small = dict(train_backend="xla", epochs_per_call=1, n_samples_y=1, n_samples_x=2000, n_repeats=1)
    runs = {
        "linear_dsm": (mlin.run, dict(lin_cfg, loss_fn="DSM", n_epochs=2)),
        "scat_dsm": (lambda c, device: mscat.run(c, gt_dir, device=device), dict(scat_cfg, loss_fn="DSM", n_epochs=2)),
        "linear_config": (mlin.run, dict(lin_cfg, n_epochs=3)),
    }
    t0 = time.time()
    plain = {}
    for name, (fn, cfg) in runs.items():
        cfg = dict(cfg, **small, **dirs("plain_" + name))
        fused_dsm_train_epochs.launches = 0
        _, m = fn(cfg, device="cuda")
        _, losses, _ = train_log(cfg)
        plain[name] = {"losses": losses, "epochs_per_s": epochs_per_s(cfg), "KL": m[0]}
        check(fused_dsm_train_epochs.launches == 0, f"{name}: the autograd engine launched B3")
        check(all(v == v and abs(v) != float("inf") for v in losses) and losses[-1] < losses[0],
              f"{name}: losses not finite and falling: {losses}")
    phase("train_plain", t0, loss_fn_linear_config=lin_cfg["loss_fn"], **plain)
    return {"linear": n_lin["dsm_train"], "scat": n_scat["dsm_train"]}


def b3_work(in_dim, out_dim, hidden, batch: int, n_steps: int):
    """(FLOPs, bytes) of one B3 launch: per step the forward, dW for every
    layer and da below the top layer; params, m and v read and written
    once, h0, eps and s1 read once."""
    dims = [in_dim, *hidden, out_dim]
    macs = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    n_par = macs + sum(dims[1:])
    flops = 2.0 * batch * n_steps * (2 * macs + macs - in_dim * dims[1])
    return flops, 2 * 3 * 4 * n_par + 4 * n_steps * batch * (in_dim + 2 * out_dim)


def run() -> list:
    import torch

    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.nets import mlp_init
    from dmip_tpu_torch.ops import (build, fused_dsm_train_epochs, fused_em_sampler, fused_em_sampler_cdiffe,
                                    fused_guided_em_sampler, fused_mh_scatterometry)
    from dmip_tpu_torch.ops.dps_kernel import guided_em_reference
    from dmip_tpu_torch.ops.dsm_train_kernel import dsm_train_epochs_reference
    from dmip_tpu_torch.ops.em_kernel import em_cdiffe_reference, em_sampler_reference
    from dmip_tpu_torch.ops.mh_kernel import mh_chains_reference
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.problems import scatterometry as scat
    from dmip_tpu_torch.utils import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    reports = build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in reports.items()}
    phase("build", t0, ptxas=ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    scat_cfg = load_config(os.path.join(REPO, "configs/config_scatterometry.yml"))
    lin_cfg = load_config(os.path.join(REPO, "configs/config_linear.yml"))
    forward_model, fparams = scat.load_forward_model(device="cuda")
    weights = forward_model.weights
    ys = gt.test_conditions(scat_cfg, forward_model, fparams, "cuda")[:SCAT_CONDITIONS]
    y0 = ys[0]
    y_lin = eval_diffusion.linear_test_conditions(lin_cfg, LinearForwardProblem(), "cuda")[0]
    nets = {
        "cde_500k": (load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/cde_500k"),
                                          device="cuda"), y0),
        "linear_refined_winner": (load_archived_params(
            os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner"), device="cuda"), y_lin),
    }
    kw = dict(noise_std=0.5, a=fparams["a"], b=fparams["b"], lambd_bd=fparams["lambd_bd"])
    b1 = {}
    for name, (params, y) in nets.items():
        t0 = time.time()
        b1[name] = check_b1(torch, params, y, gen)
        phase("b1_vs_plain", t0, net=name, **b1[name])
    t0 = time.time()
    b2 = check_b2(torch, weights, y0, gen, fparams)
    phase("b2_vs_plain", t0, chains=MH_CHAINS, **b2)
    b3 = {}
    for name, (in_dim, out_dim, nb, _) in (("linear", B3_LIN), ("scat", B3_SCAT)):
        t0 = time.time()
        b3[name] = check_b3(torch, in_dim, out_dim, nb, gen, full=name == "linear")
        phase("b3_vs_plain", t0, net=name, **b3[name])
    cdiffe_nets = {
        "cdiffe_scat": (load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/cdiffe_scat"),
                                             device="cuda"), y0),
        "linear_cdiffe": (mlp_init(*B4_LIN_NET, (512, 512, 512),
                                   generator=torch.Generator().manual_seed(13), device="cuda"), y_lin),
    }
    b4 = {}
    for name, (params, y) in cdiffe_nets.items():
        t0 = time.time()
        # the random linear net's samples are heavy-tailed: same-noise checks only
        b4[name] = check_b4(torch, params, y, gen, moments=name == "cdiffe_scat")
        phase("b4_vs_plain", t0, net=name, **b4[name])
    prior = load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/dps_prior"), device="cuda")["prior"]
    t0 = time.time()
    b5 = check_b5(torch, prior, weights, ys, gen)
    phase("b5_vs_plain", t0, samples=N_SAMPLES, **b5)

    with tempfile.TemporaryDirectory(prefix="dmip_gt_", dir=REPO) as work:
        launches = serve(torch, lin_cfg, scat_cfg, work)
        launches.update(serve_cdiffe_dps(torch, work))
        b3_launches = train(torch, lin_cfg, scat_cfg, work)
        cdiffe_train = train_cdiffe(torch, work, gen)

    # timings at the main path's shapes, after the counts were read; B1's
    # numbers are per launch, weighted by the launches of each net
    t0 = time.time()
    em_n = {"linear_refined_winner": launches["em_linear"], "cde_500k": launches["em"] - launches["em_linear"]}
    em_t, em_flops, em_bytes = {}, 0.0, 0.0
    for name, (params, y) in nets.items():
        x0 = torch.randn(N_SAMPLES, params[-1][0].shape[1], generator=gen, device="cuda")
        em_t[name] = (cuda_ms(lambda: fused_em_sampler(params, x0, y, EM_STEPS, seed=7), 5),
                      cuda_ms(lambda: em_sampler_reference(params, x0, y, EM_STEPS, generator=gen), 2))
        flops, nbytes = em_work(params, N_SAMPLES, EM_STEPS)
        em_flops, em_bytes = em_flops + em_n[name] * flops, em_bytes + em_n[name] * nbytes
    em_ms = sum(em_n[k] * em_t[k][0] for k in nets) / launches["em"]
    em_plain_ms = sum(em_n[k] * em_t[k][1] for k in nets) / launches["em"]
    em_bound, em_by = bound_ms(em_flops, em_bytes, H100_BF16_FLOPS)
    em_bound /= launches["em"]
    c0 = torch.rand(MH_CHAINS, 3, generator=gen, device="cuda") * 2 - 1
    mh_ms = cuda_ms(lambda: fused_mh_scatterometry(weights, c0, y0, MH_STEPS, seed=7, **kw), 3)
    mh_plain_ms = cuda_ms(lambda: mh_chains_reference(weights, c0, y0, MH_STEPS, generator=gen, **kw), 1)
    mh_bound, mh_by = bound_ms(*mh_work(weights, MH_CHAINS, MH_STEPS), H100_F32_FLOPS)
    # B3 per launch at each problem's launch shape, weighted by its launches
    b3_t, b3_flops, b3_bytes = {}, 0.0, 0.0
    for name, (in_dim, out_dim, nb, epochs) in (("linear", B3_LIN), ("scat", B3_SCAT)):
        params, mu, nu, h0, eps, s1 = b3_inputs(torch, in_dim, out_dim, nb, epochs, gen)
        args = (params, mu, nu, 7, h0, eps, s1)
        bkw = dict(n_epochs=epochs, n_batches=nb, batch_real=B3_BATCH, lr=B3_LR, n_active=epochs)
        b3_t[name] = (cuda_ms(lambda: fused_dsm_train_epochs(*args, **bkw), 3),
                      cuda_ms(lambda: dsm_train_epochs_reference(*args, **bkw), 1))
        flops, nbytes = b3_work(in_dim, out_dim, (512, 512, 512), B3_BATCH, epochs * nb)
        b3_flops, b3_bytes = b3_flops + b3_launches[name] * flops, b3_bytes + b3_launches[name] * nbytes
        del params, mu, nu, h0, eps, s1
    n_b3 = sum(b3_launches.values())
    b3_ms = sum(b3_launches[k] * b3_t[k][0] for k in b3_t) / n_b3
    b3_plain_ms = sum(b3_launches[k] * b3_t[k][1] for k in b3_t) / n_b3
    b3_bound, b3_by = bound_ms(b3_flops, b3_bytes, H100_BF16_FLOPS)
    b3_bound /= n_b3
    # B4 at the serving shape (cdiffe_scat, the only shape the main path
    # launches); B5 in both guidance modes at the dps_prior shapes
    cd_params = cdiffe_nets["cdiffe_scat"][0]
    x0 = torch.randn(N_SAMPLES, 3, generator=gen, device="cuda")
    b4_ms = cuda_ms(lambda: fused_em_sampler_cdiffe(cd_params, x0, y0, EM_STEPS, seed=7), 5)
    b4_plain_ms = cuda_ms(lambda: em_cdiffe_reference(cd_params, x0, y0, EM_STEPS, generator=gen), 1)
    b4_bound, b4_by = bound_ms(*cdiffe_work(cd_params, 3, N_SAMPLES, EM_STEPS), H100_BF16_FLOPS)
    b5_t = {}
    for guidance in ("dps", "pgdm"):
        gkw = dict(a=fparams["a"], b=fparams["b"], guidance_clip=100.0, num_steps=EM_STEPS, guidance=guidance)
        b5_t[guidance] = (
            cuda_ms(lambda: fused_guided_em_sampler(prior, weights, x0, y0, seed=7, **gkw), 2),
            cuda_ms(lambda: guided_em_reference(prior, weights, x0, y0, generator=gen, **gkw), 1),
            *bound_ms(*guided_work(prior, weights, N_SAMPLES, EM_STEPS, guidance), H100_F32_FLOPS),
        )
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    phase("timing", t0, em_ms_by_net={k: v[0] for k, v in em_t.items()},
          em_plain_ms_by_net={k: v[1] for k, v in em_t.items()}, em_launches_by_net=em_n,
          mh_chains=MH_CHAINS, mh_ms=mh_ms, mh_plain_ms=mh_plain_ms,
          b3_ms_by_net={k: v[0] for k, v in b3_t.items()}, b3_plain_ms_by_net={k: v[1] for k, v in b3_t.items()},
          b3_launches_by_net=b3_launches, b3_launches_cdiffe_train=cdiffe_train["dsm_train"],
          b4_ms=b4_ms, b4_plain_ms=b4_plain_ms, b4_bound_ms=b4_bound,
          b5_ms_by_guidance={k: v[0] for k, v in b5_t.items()},
          b5_plain_ms_by_guidance={k: v[1] for k, v in b5_t.items()},
          b5_bound_ms_by_guidance={k: v[2] for k, v in b5_t.items()}, sm_clock_power_temp=clocks)

    return [
        {"name": "fused_em_sampler", "route": "cuda", "source": "dmip_tpu_torch/csrc/em_kernel.cu",
         "replaces": "dmip_tpu/ops/em_kernel.py:421", "launches": launches["em"],
         "max_abs_err": max(r["max_abs_err"] for r in b1.values()), "ms": em_ms, "plain_ms": em_plain_ms,
         "bound_ms": em_bound, "bound_by": em_by, "library_ms": None},
        {"name": "fused_mh_scatterometry", "route": "cuda", "source": "dmip_tpu_torch/csrc/mh_kernel.cu",
         "replaces": "dmip_tpu/ops/mh_kernel.py:154", "launches": launches["mh"],
         "max_abs_err": b2["max_abs_err"], "ms": mh_ms, "plain_ms": mh_plain_ms,
         "bound_ms": mh_bound, "bound_by": mh_by, "library_ms": None},
        {"name": "fused_dsm_train_epochs", "route": "cuda", "source": "dmip_tpu_torch/csrc/dsm_train_kernel.cu",
         "replaces": "dmip_tpu/ops/dsm_train_kernel.py:283", "launches": n_b3,
         "max_abs_err": max(r["f32_params_max_abs"] for r in b3.values()), "ms": b3_ms, "plain_ms": b3_plain_ms,
         "bound_ms": b3_bound, "bound_by": b3_by, "library_ms": None},
        {"name": "fused_em_sampler_cdiffe", "route": "cuda", "source": "dmip_tpu_torch/csrc/em_kernel.cu",
         "replaces": "dmip_tpu/ops/em_kernel.py:319", "launches": launches["em_cdiffe"],
         "max_abs_err": max(r["max_abs_err"] for r in b4.values()), "ms": b4_ms, "plain_ms": b4_plain_ms,
         "bound_ms": b4_bound, "bound_by": b4_by, "library_ms": None},
        {"name": "fused_guided_em_sampler", "route": "cuda", "source": "dmip_tpu_torch/csrc/dps_kernel.cu",
         "replaces": "dmip_tpu/ops/dps_kernel.py:380", "launches": launches["guided"],
         "max_abs_err": b5["max_abs_err"], "ms": b5_t["dps"][0], "plain_ms": b5_t["dps"][1],
         "bound_ms": b5_t["dps"][2], "bound_by": b5_t["dps"][3], "library_ms": None},
    ]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "dmip_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    card = card_line()
    print(f"card: {card}", flush=True)
    try:
        kernels = run()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
