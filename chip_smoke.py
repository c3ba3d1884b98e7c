#!/usr/bin/env python3
"""Smoke test of dmip_tpu_torch on one NVIDIA GPU.

Builds the port's CUDA kernels from ``dmip_tpu_torch/csrc``, holds each
against its plain PyTorch version at the serving path's shapes, then drives
the serving path through its entry points at full width:

  * linear evaluation of ``benchmarks/checkpoints/linear_refined_winner``
    (30k samples x 200 E-M steps x 10 repeats per condition);
  * scatterometry ground truth through the MH kernel (30k chains x 1000
    steps x 10 repeats per condition, all in one launch of 300k chains) and
    evaluation of ``benchmarks/checkpoints/cde_500k`` against it.

The E-M kernel is held against its plain version at both nets' shapes and
the MH kernel at the 300k chains the ground-truth driver gives it.  The
E-M kernel's ``ms``, ``plain_ms`` and ``bound_ms`` are per launch, averaged
over the serving path's launches of each shape.

Launch counts are zeroed just before the serving path and read just after;
the plain path then reruns the same conditions for comparison.  Prints one
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


def serve(torch, lin_cfg, scat_cfg) -> dict:
    """The serving path through its entry points, kernel launches counted
    from zero; then the plain path on the same conditions.  Returns the
    launch counts."""
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.ops import fused_em_sampler, fused_mh_scatterometry

    lin_ckpt = os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner")
    scat_ckpt = os.path.join(REPO, "benchmarks/checkpoints/cde_500k")
    with tempfile.TemporaryDirectory(prefix="dmip_gt_", dir=REPO) as gt_dir:
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


def run() -> list:
    import torch

    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.ops import build, fused_em_sampler, fused_mh_scatterometry
    from dmip_tpu_torch.ops.em_kernel import em_sampler_reference
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
    y0 = gt.test_conditions(scat_cfg, forward_model, fparams, "cuda")[0]
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

    launches = serve(torch, lin_cfg, scat_cfg)

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
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    phase("timing", t0, em_ms_by_net={k: v[0] for k, v in em_t.items()},
          em_plain_ms_by_net={k: v[1] for k, v in em_t.items()}, em_launches_by_net=em_n,
          mh_chains=MH_CHAINS, mh_ms=mh_ms, mh_plain_ms=mh_plain_ms, sm_clock_power_temp=clocks)

    return [
        {"name": "fused_em_sampler", "route": "cuda", "source": "dmip_tpu_torch/csrc/em_kernel.cu",
         "replaces": "dmip_tpu/ops/em_kernel.py:421", "launches": launches["em"],
         "max_abs_err": max(r["max_abs_err"] for r in b1.values()), "ms": em_ms, "plain_ms": em_plain_ms,
         "bound_ms": em_bound, "bound_by": em_by, "library_ms": None},
        {"name": "fused_mh_scatterometry", "route": "cuda", "source": "dmip_tpu_torch/csrc/mh_kernel.cu",
         "replaces": "dmip_tpu/ops/mh_kernel.py:154", "launches": launches["mh"],
         "max_abs_err": b2["max_abs_err"], "ms": mh_ms, "plain_ms": mh_plain_ms,
         "bound_ms": mh_bound, "bound_by": mh_by, "library_ms": None},
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
