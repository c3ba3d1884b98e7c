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
  * the f32-weight mode of the E-M and CDiffE kernels (``serve_f32``):
    ``cde_500k`` through ``CDE.sample(compute_dtype=torch.float32)`` on the
    same conditions and ground truth (2 repeats), beside the bf16 kernel and
    the plain f32 path on the same repeats; ``linear_refined_winner`` on 2
    linear conditions x 10 repeats, beside the serving phase's rows of them;
    one ``cdiffe_scat`` condition through ``CDiffE.sample(compute_dtype=
    torch.float32)``;
  * energy-refined serving through the eval driver, on the same conditions
    and ground truth: ``cde_500k`` under ``config_scatterometry_refined.yml``'s
    own chain (annealed MH, 20 steps), ``linear_refined_winner`` under
    ``config_linear_refined.yml``'s (MH, 20 steps) and ``linear_pinn2``
    under MALA (60 steps), each proposal through the E-M kernel; then the
    exponential integrator (32 steps) and Heun (100 steps), plain PyTorch,
    against the E-M rows, with the time per 30k-sample posterior of each
    sampler beside the E-M kernel's; then a ``torch.profiler`` trace of one
    linear serving condition (the card's busy share, the top operations);
  * the evaluation engine: B1, B4 and B5 each with its seed as an int and
    as a tensor on the card, bit for bit (``seed_forms``); then
    ``linear_refined_winner`` on 10 linear conditions with no chunk and in
    one chunk of 10 (ms a condition, the two results.csv byte for byte),
    ``cde_500k`` on 3 conditions in one chunk against ground truth drawn
    there, and one chunk of each queued under the sync debug mode "error"
    and traced: host syncs, the card's busy share, the top operations, and
    the time B1's wrapper packs the weights (``eval_engine``);
  * the baselines: the committed ``baselines_{snf,dsm,inn}`` (SNF and INN,
    4 x 64 couplings; the 27 -> 512^3 -> 3 DSM CDE) served through the
    scatterometry baselines driver (``--eval_only``) on the same conditions
    and ground truth, the DSM row through the E-M kernel and again by its
    plain path, the SNF and INN on the card against the CPU on fixed draws,
    and each model's time per 30k-sample posterior;
  * DSM training of the 512x3 CDE through the fused training kernel
    (``train_backend: fused_pallas``): the linear config's full 1500 epochs,
    scatterometry cut to 2000 epochs, each followed by evaluation through
    the E-M kernel; then the autograd engine (``train_backend: xla``) for a
    few epochs, on DSM and on the unchanged linear config (PINNLoss); then
    the fused engine's host work at the shipped linear and scatterometry
    configs (``train_fused_host``: the host ms to prepare a launch, one
    replay of the captured preparation, beside the same preparation run
    eagerly, bit for bit, and to prepare and queue it; one engine call under
    the sync debug mode "error"; ``train.fit`` over 3 launches traced: host
    syncs a launch, the card's busy share); then
    the CDiffE (27 -> 26) for 2 launches of the fused training kernel.  The
    autograd engine also trains ``config_linear_refined.yml`` for 2 epochs,
    whose driver then scores the refined row.  Last, both baseline drivers
    train SNF, DSM CDE and INN end to end (shipped configs, epochs cut to
    one engine call a model and one epoch) and score them, and the linear
    baselines evaluation is timed per repeat;
  * DPS training: one PosteriorLoss step at full width on the card against
    the CPU on fixed draws (``dps_step_card_vs_cpu``), then the
    scatterometry driver on ``config_scatterometry_dps.yml`` (widths, batch,
    lr, lam and clip as shipped, epochs cut to two engine calls): the
    {'prior', 'likelihood'} checkpoint, the learned row by the plain scan,
    the trained prior re-served under analytic guidance through the guided
    kernel, the learned row's time per posterior, and one more call resumed
    from the checkpoint (``train_dps``);
  * grid search: the trial-stacked ensemble trainer on the first PINNLoss
    group of ``config_gridsearch_linear.yml`` (20 (lam, lam2) trials at
    full width, one epoch), two of its trials against the sequential
    autograd engine (``grid_ensemble_card``); the linear grid driver on
    ``config_gridsearch_linear_small.yml`` (12 trials in 6 ensemble
    groups, each evaluated through the E-M kernel), a rerun that must
    resume without training or evaluating, and the best-model walker
    (``grid_linear``); the scatterometry grid driver on
    ``config_gridsearch_scatterometry_small.yml`` (6 trials) against the
    serving ground truth, and that ground truth's own floor
    (``grid_scat``).  Epochs and evaluation are cut, widths kept;
  * the multi-GPU layer (``dmip_tpu_torch.parallel``): a world of one NCCL
    rank in this process (``dist_world1``: ``config_linear.yml``'s PINN
    net at full width for 10 data-parallel steps, each two CUDA-graph
    replays around the all-reduce, bit for bit against the same engine run
    eagerly and against the meshless engine, ms a step of a first and a
    warm call of each, a traced warm call's host syncs, a call under the
    sync debug mode "error", and the linear evaluation with the mesh
    through B1), then two spawned ranks sharing the card over gloo
    (``dist_two_ranks``: the same three engines on each rank, its captured
    step bit for bit its eager one, against the world of one, the
    evaluation's rows against it bit for bit, the GT driver's ``--devices
    2`` at 300k chains x 1000 steps against a meshless GT in distribution,
    the small linear grid pinned (two calls a trial, one capture a trial)
    against each trial's sequential run bit for bit, the small
    scatterometry grid's group as a sharded vmap ensemble (one capture a
    rank) against ``grid_scat``'s, every trial through B1 split over the
    ranks, and B1's and B2's times with two ranks on the card).

Every config handed to a driver has ``plot_ys: []`` (``card_config``): the
drivers' corner plots need matplotlib, which this script does not require
of the GPU host.

The E-M kernel is held against its plain version at both nets' shapes, the
MH kernel at the 300k chains the ground-truth driver gives it in one
process and at the 150k a rank it gives each of two ranks, the training
kernel at the linear net's and the CDiffE's shapes (f32 and bf16, a masked
epoch, two launches of one epoch against one of two, bit for bit, a poisoned
batch under both guards) and at the scatterometry net's (f32), the CDiffE
kernel at ``cdiffe_scat``'s and a linear CDiffE's shapes, and the guided
kernel at the ``dps_prior`` + surrogate shapes in both guidance modes.  The
E-M and CDiffE kernels' same-noise samples are also held against their
plain version run unrounded in float64 (a float64 witness, as the MH and
guided kernels have).  Both run again in their f32-weight mode at every
shape where they run in bf16, on the same x0 and noise, against the f32
plain version (``EM_F32_*`` tolerances), float64 (within ``EM_F64_RATIO``
of the f32 plain version and ``EM_F32_OVER_BF16_F64`` of the bf16 kernel)
and the Philox moments.  Each kernel's ``ms``, ``plain_ms`` and ``bound_ms``
are per launch, averaged over the main path's launches of each shape; the
timing phase also splits the E-M kernel's step over its phases at both nets
(``b1_phase_us_by_net``; in f32 ``b1_f32_phase_us_by_net`` and
``b4_f32_phase_us``, beside the f32 and split-TF32 bounds), the MH
kernel's (``b2_phase_us``), the training kernel's
(``b3_phase_us_by_net``), the CDiffE kernel's (``b4_phase_us``)
and the guided kernel's, in both guidance modes
(``b5_phase_us_by_guidance``).  The MH kernel's one-step check also holds
the energies it carries against the plain energy in float64.

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
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # non-tensor f32 peak
H100_TF32_FLOPS = 495e12     # dense TF32 tensor-core peak
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
# B2's carried energies after one step against the plain energy in float64
# on the same states: f32 rounding in another sum order leaves the kernel's
# p999 relative error of the size of the f32 plain version's; a wrong term
# or a lost partial sum, or a split product that drops precision, puts it
# far above.  Relative to max(|e|, 1): energies near 0 are held absolutely.
B2_F64_RATIO = 2.0
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
# B1 and B4 against their plain versions run unrounded in float64 on the same
# x0 and noise: the kernel and the bf16 plain version both round every
# activation to bf16, so their distances to float64 are alike; a wrong term
# or a lost partial sum would put the kernel's far above
EM_F64_RATIO = 2.0
# B1 and B4 with f32 weights (compute_dtype=torch.float32) against their f32
# plain versions on the same x0 and noise: f32 in another sum order and
# split-TF32 products only, so 10x tighter than the bf16 mode's tolerances;
# against float64 they are held by EM_F64_RATIO to the f32 plain version
EM_F32_MEAN_ABS_TOL = 2e-4
EM_F32_P999_TOL = 5e-3
# the f32 kernel's p999 distance to float64 at most this share of the bf16
# kernel's on the same inputs: an approximate tanh or a TF32 sum left to the
# tensor core would keep it bf16-class
EM_F32_OVER_BF16_F64 = 0.1
# serve_f32, CDE.sample(compute_dtype=torch.float32) at full width: cde_500k
# on serve()'s conditions at this many repeats, beside the bf16 kernel and
# the plain f32 path on the same repeats; linear_refined_winner on serve()'s
# first conditions at REPEATS, beside serve()'s rows of them
SERVE_F32_SCAT_REPEATS = 2
SERVE_F32_LIN_CONDITIONS = 2
B4_LIN_NET = (5, 4)           # linear CDiffE: [x, y, t] = 5 -> 512^3 -> xdim + ydim = 4
# CDiffE serving, kernel (bf16) vs plain (f32) KL on the same GT: at least
# SCAT_KL_AGREE, widened to 3x the plain path's own spread between two seeds
SCAT_CDIFFE_SPREAD_FACTOR = 3.0
DPS_REPEATS = 2               # analytic-DPS serving: n_repeats cut from 10
# refinement and the other samplers: the chain the linear MALA row runs on
# linear_pinn2 (the JAX package's rescue row), the exponential integrator's
# and Heun's steps, and the expint forms served on the linear problem
REFINE_PINN2 = "mala,60,0.05"
EXPINT_STEPS = 32
HEUN_STEPS = 100
EXPINT_LIN_METHODS = ("expint:sde:1", "expint:ode:2")
SAMPLER_TIMING_REPS = 3
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
# B5 step by step against the plain version run in float64 from the same
# state and noise: f32 rounding leaves the kernel's p999 error of the size
# of the f32 plain version's (a probe on an H100 read 0.3-0.6x); a wrong
# term or a lost partial sum would put it far above
B5_F64_RATIO = 2.0
# the baselines (SNF, DSM CDE, INN) served from the committed
# baselines_{snf,dsm,inn} archives on serve()'s conditions and GT, n_repeats
# cut from 10; beside them BENCHMARKS.md's 100-condition rows of the JAX
# package on the same weights, a reading and not a check (other conditions)
BASELINE_REPEATS = 2
BASELINE_JAX_ROWS = {"SNF": {"KL": 0.581, "NLPD": 0.643, "W2": 0.0965},
                     "diffusion": {"KL": 0.755, "NLPD": 2.18, "W2": 0.0597},
                     "INN": {"KL": 1.018, "NLPD": 6.81, "W2": 0.0865}}
# SNF and INN sample on the card against the chip machine's CPU, same z and
# MH draws: f32 in another sum order, within 1e-4 on unit-scale samples.  An
# SNF row whose MH accept sits on its threshold can take the other branch
# on one device and follow another path: at most 1% of the rows, the rule
# of the refinement chains' card test.  The INN has no such decision.
BASELINE_DEVICE_ROWS = 2000
BASELINE_DEVICE_ATOL = 1e-4
SNF_DEVICE_SPLIT_SHARE = 0.01
BASELINE_TIMING_REPS = 3
# both baseline drivers on the card with their shipped configs and widths,
# epochs cut to one full call of the engine for each model (5 / 25 or 100 /
# 25 epochs a call) and one epoch more, whose rate excludes the first call;
# evaluation cut to these conditions and 1 repeat
TRAIN_BASELINES = {
    "linear": dict(n_epochs_SNF=6, n_epochs_dsm=26, n_epochs_INN=26, n_samples_y=2),
    "scat": dict(n_epochs_SNF=6, n_epochs_dsm=101, n_epochs_INN=26, n_samples_y=1),
}
LINEAR_EVAL_TIMING_REPEATS = 3
# train_dps: config_scatterometry_dps.yml with its widths (prior 4 -> 512^3
# -> 3, likelihood 27 -> 512^3 -> 3), batch 1000, lr 1e-4, lam 1.0 and
# guidance clip 100; n_epochs cut from 10000 to two calls of the autograd
# engine (the rate from the second), the evaluation to serve()'s conditions
# and GT x DPS_REPEATS; then one more call resumed from the checkpoint,
# scored on one condition x one repeat
DPS_TRAIN = dict(n_epochs=20, epochs_per_call=10)
DPS_RESUME = dict(n_samples_y=1, n_repeats=1)
DPS_TIMING_REPS = 2
# dps_step_card_vs_cpu: one PosteriorLoss step of a 1000-row batch on the
# card and on the host's CPU, same weights, x, y, t and eps, f32 on
# both (TF32 off): the same arithmetic in another sum order, ~1e-6 relative
# per product.  The likelihood target amplifies it: v2 = (y - f) / ((a f)^2
# + b^2) with b^2 = 1e-4 divides the rounding of f by up to 1e4, and a
# surrogate ReLU whose pre-activation sits at 0 can flip its mask on one
# device only, changing that row's VJPs.  The rows with the largest targets
# (1e3-1e4, near the box boundary) dominate the mean squared residual, so
# the loss and LikelihoodLoss carry such a row's error; a gradient leaf sums
# all rows and is held to its norm.  A probe on an H100 read at most 2.8e-4
# on the loss terms and 5.5e-5 on a leaf (one target row off by 6.8%, the
# p999 of rows 5.9e-4) with the committed weights, 9e-6 and 5.2e-6 from the
# initial weights.  A wrong term (O(1)) fails these bounds.  TF32 is caught
# by the check of the flags before the step (allow_tf32 off, precision
# 'highest'), not by these bounds: no step was read with TF32 on, and its
# per-leaf errors may average below 5e-4.
DPS_STEP_BATCH = 1000
DPS_STEP_LOSS_REL_TOL = 5e-3
DPS_STEP_GRAD_REL_TOL = 5e-4
# grid_ensemble_card: the first PINNLoss group of config_gridsearch_linear.yml
# (pde_loss FPE, pde_metric L1, ic_metric L1; all 20 (lam, lam2) trials) at
# its shipped widths, batch and data (90 steps an epoch), one engine call of
# GRID_ENSEMBLE_EPOCHS; trials GRID_CHECK_TRIALS held against the sequential
# autograd engine from the same init and seed, f32 on both (TF32 off).
GRID_ENSEMBLE_EPOCHS = 1
GRID_ENSEMBLE_TRIALS = 20
GRID_CHECK_TRIALS = (0, 19)
# The first step's per-trial loss: the same f32 arithmetic as the sequential
# step in another sum order (the stacked products run as one batched
# product), ~1e-7 relative per product, which the PDE term's third
# derivatives of the net amplify; the CPU tests hold the same loss across
# packages to 2e-5 (tests/test_torch_losses.py).  A wrong lam or lam2 moves
# it by percents.
GRID_STEP_LOSS_REL_TOL = 1e-4
# Every parameter leaf after the epoch, against the distance the epoch moved
# it (||p_ens - p_seq|| / ||p_seq - p_init||).  Adam's update m/sqrt(v) does
# not depend on the gradient's scale, so gradients agreeing to the first
# step's relative error (<= GRID_STEP_LOSS_REL_TOL) give updates that agree
# to about that much; only a weight whose gradient sits at the rounding level
# can take an lr-sized step of the other sign in one version, a few in a
# leaf of 2.6e5 weights whose epoch moved it by ~1 in norm.  1e-3 of the
# update leaves room for those and is far below what another trial's lam
# gives (the phase prints that contrast and fails unless the tolerance is
# under a tenth of it).
GRID_LEAF_REL_TOL = 1e-3
# grid_linear: config_gridsearch_linear_small.yml at full width (12 trials in
# 6 ensemble groups of 2); grid_scat: config_gridsearch_scatterometry_small.yml
# (6 trials in one group of 6) on serve()'s GT and conditions.  The cuts:
GRID_LINEAR_CUTS = dict(n_epochs=1, epochs_per_call=1, n_samples_y=2, eval_n_repeats=1)
GRID_SCAT_CUTS = dict(n_epochs=2, epochs_per_call=1, n_samples_y=SCAT_CONDITIONS, eval_n_repeats=2)
# the pinned grid of dist_two_ranks: two calls a trial, which share its engine
DIST_GRID_LINEAR_CUTS = dict(GRID_LINEAR_CUTS, n_epochs=2)
GRID_FLOOR_REPEATS = REPEATS    # gt_floor_scatterometry: 5 GT repeats against the other 5
# The multi-GPU layer (dmip_tpu_torch.parallel).  dist_world1: a world of one
# NCCL rank in this process; dist_two_ranks: two spawned ranks sharing the
# card over gloo.  Training: config_linear.yml's PINN net (512^3, batch 1000)
# for DIST_STEPS steps, the first DIST_STEPS batches of its first epoch,
# through the meshed engine captured and eager and the meshless one, each a
# first call and DIST_TIMING_REPS warm ones.  The captured meshed step must
# be its eager one bit for bit on every rank, and over one NCCL rank the
# meshless one too, with no host sync in a traced warm call.
DIST_STEPS = 10
DIST_LIN_CONDITIONS = (3, 4)     # evaluate_linear's conditions: world of one, two ranks
DIST_REPEATS = 2
DIST_GT_CONDITIONS = 2           # the GT driver's --devices 2, at MH_CHAINS x MH_STEPS
# A world of one rank must give the meshless engine's step bit for bit (the
# mean over one rank is the identity).  Two ranks sum the halves' means in
# another f32 order: the first step's loss within 1e-6 relative, and every
# leaf after DIST_STEPS steps within 1e-4 of its own update (as GRID_LEAF_REL_TOL
# reads it), several times the distance measured between the ensemble and its
# sequential runs.
DIST_LOSS_REL_TOL = 1e-6
DIST_LEAF_REL_TOL = 1e-4
# Each rank's half of a condition's sharded GT (150k chains) against the
# meshless GT's first half: histogram KL at most this times the meshless
# GT's own floor, its first half against its second (the same sizes).
DIST_GT_KL_FACTOR = 1.5
DIST_TIMING_REPS = 3             # warm training calls; B1 launches timed with two ranks
# The captured train step (train.StepGraph; train_captured): config_linear.yml
# as shipped (PINNLoss, 512^3, batch 1000, 90 steps an epoch, 25 epochs a
# call), cut to two engine calls and LIN_CONDITIONS conditions of its
# evaluation.  Captured against eager from the same params and seed: bit for
# bit, or, where cuBLAS picks other algorithms under capture, the two-rank
# limits above.  The re-timed phases compare GRAPH_COMPARE_STEPS steps a
# side (the linear PINN one whole epoch); the traces hold
# GRAPH_PROFILE_STEPS steps.
CAPTURED_EPOCHS = 50
GRAPH_LOSS_REL_TOL, GRAPH_LEAF_REL_TOL = DIST_LOSS_REL_TOL, DIST_LEAF_REL_TOL
GRAPH_COMPARE_STEPS = 10
GRAPH_PROFILE_STEPS = 10
# the CUDA runtime's calls that make the host wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
# The evaluation engine (eval_engine): linear_refined_winner on
# EVAL_LIN_CONDITIONS linear test conditions, by evaluate_linear with no
# chunk and in one chunk of them, each twice from EVAL_SEED (the second call
# timed); cde_500k on SCAT_CONDITIONS conditions in one chunk against GT
# drawn in the phase.  A chunk queued under the sync debug mode "error" must
# not raise; its trace may hold EVAL_SYNCS_MAX host syncs (the chunk's one
# read), and the card must be busy EVAL_BUSY_MIN of a traced linear chunk.
EVAL_LIN_CONDITIONS = 10
EVAL_SEED = 11
EVAL_SYNCS_MAX = 1
EVAL_BUSY_MIN = 0.90
# The fused engine's preparation (train_fused_host): the shipped linear and
# scatterometry configs on train_backend fused_pallas at their widths,
# batch and epochs_per_call (25 / 100).  FUSED_HOST_REPS launches time the
# host's work to prepare a launch and to prepare and queue it, the card
# idle; then train.fit over FUSED_TRACE_LAUNCHES launches, after a warm-up
# launch, is traced: the card must be busy FUSED_BUSY_MIN of the window and
# the host may wait for it FUSED_SYNCS_MAX times a launch (fit's read of
# the losses); one engine call must raise nothing under the sync debug
# mode "error".
FUSED_HOST_REPS = 3
FUSED_TRACE_LAUNCHES = 3
FUSED_BUSY_MIN = 0.90
FUSED_SYNCS_MAX = 1


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def phase(name: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3), **fields}), flush=True)


def ptxas_lines(report: str) -> list:
    """nvcc's ``-Xptxas -v`` report cut to its register and spill lines,
    each named by the (mangled) function it describes, its warnings and
    its notes of a serialized wgmma pipeline."""
    out, fn = [], None
    for ln in report.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
        elif "spill" in ln or "registers" in ln:
            out.append(f"{fn}: {ln.strip()}" if fn else ln.strip())
        elif "warning" in ln.lower() or "Performance Loss" in ln:
            out.append(ln.strip())
    return out


def card_config(name: str) -> dict:
    """A shipped config with ``plot_ys`` set to [] explicitly: a driver
    draws the corner plots of every condition in ``plot_ys`` (some shipped
    configs list them) through matplotlib, which this script does not
    require of the GPU host.  Every config this script hands to a driver
    comes from here."""
    from dmip_tpu_torch.utils import load_config

    return dict(load_config(os.path.join(REPO, "configs", name)), plot_ys=[])


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


def em_work(params, n: int, steps: int, weight_size: int = 2):
    """(FLOPs, bytes) the E-M sampler must do: every product of every step,
    x0 read and x written once, the weights read once (the hidden ones
    ``weight_size`` bytes an entry: 2 in the bf16 mode, 4 in f32)."""
    xdim = params[-1][0].shape[1]
    macs = sum(w.shape[0] * w.shape[1] for w, _ in params) - (params[0][0].shape[0] - xdim) * params[0][0].shape[1]
    hidden = sum(w.numel() for w, _ in params[1:-1])
    weight_bytes = weight_size * hidden + 4 * (params[0][0].numel() + params[-1][0].numel()
                                               + sum(b.numel() for _, b in params))
    return 2.0 * n * steps * macs, 2 * n * xdim * 4 + weight_bytes


def mh_work(weights, n: int, steps: int):
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
    wbytes = 4 * sum(w.numel() + b.numel() for w, b in weights)
    return 2.0 * n * (steps + 1) * macs, 2 * n * 3 * 4 + wbytes


def cdiffe_work(params, xdim: int, n: int, steps: int, weight_size: int = 2):
    """(FLOPs, bytes) of the CDiffE sampler: per step the first layer over
    [x, y_t], the hidden products and the output's x block; x0 read and x
    written once, the weights read once (``weight_size`` as in em_work)."""
    width, h1 = params[0][0].shape[0] - 1, params[0][0].shape[1]
    hidden = sum(w.numel() for w, _ in params[1:-1])
    macs = width * h1 + hidden + params[-1][0].shape[0] * xdim
    weight_bytes = weight_size * hidden + 4 * (params[0][0].numel() + params[-1][0].numel()
                                               + sum(b.numel() for _, b in params))
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


def f64_witness(torch, out_k, out_p, out_d) -> dict:
    """The kernel's and the plain version's samples against the float64
    run on the same inputs: p50, p999 and max of each row's largest error."""
    res = {}
    q = torch.tensor([0.5, 0.999], device=out_d.device, dtype=torch.float64)
    for name, o in (("kernel", out_k), ("plain", out_p)):
        e = (o.double() - out_d).abs().amax(dim=1)
        p50, p999 = torch.quantile(e, q).tolist()
        res.update({f"f64_{name}_p50": p50, f"f64_{name}_p999": p999, f"f64_{name}_max": float(e.max())})
    return res


def em_mode(torch, compute_dtype) -> str:
    return "f32" if compute_dtype == torch.float32 else "bf16"


def em_tols(torch, compute_dtype):
    """The bulk tolerances (mean, p999) of a mode's kernel against its plain
    version on the same noise."""
    if compute_dtype == torch.float32:
        return EM_F32_MEAN_ABS_TOL, EM_F32_P999_TOL
    return B1_MEAN_ABS_TOL, B1_P999_TOL


def check_f64(torch, res, label, compute_dtype, bf16_f64_p999):
    """A kernel's float64 witness: its p999 within EM_F64_RATIO of its
    mode's plain version's; in f32 also within EM_F32_OVER_BF16_F64 of the
    bf16 kernel's on the same inputs."""
    mode = em_mode(torch, compute_dtype)
    check(res["f64_kernel_p999"] <= EM_F64_RATIO * res["f64_plain_p999"],
          f"{label} ({mode}) further from float64 than the {mode} plain version: {res}")
    if bf16_f64_p999 is not None:
        res["f64_bf16_kernel_p999"] = bf16_f64_p999
        check(res["f64_kernel_p999"] <= EM_F32_OVER_BF16_F64 * bf16_f64_p999,
              f"{label} (f32) not {1 / EM_F32_OVER_BF16_F64:g}x nearer float64 than the bf16 kernel: {res}")


def check_b1(torch, params, y, gen, compute_dtype=None, inputs=None, bf16_f64_p999=None):
    """B1 in the mode ``compute_dtype`` (bf16 by default) against its plain
    version in that mode on the net ``params`` and condition y, at the
    serving path's 30k samples x 200 steps, and both against the plain
    version run unrounded in float64; then the Philox stream's moments
    against torch's.  ``inputs``: the (x0, noise) of an earlier check,
    drawn from ``gen`` when None; ``bf16_f64_p999``: the bf16 kernel's
    float64 distance on them, which the f32 kernel must beat tenfold.
    Returns the results and the inputs."""
    from dmip_tpu_torch.ops.em_kernel import em_sampler_reference, fused_em_sampler

    compute_dtype = compute_dtype or torch.bfloat16
    xdim = params[-1][0].shape[1]
    if inputs is None:
        inputs = (torch.randn(N_SAMPLES, xdim, generator=gen, device="cuda"),
                  torch.randn(EM_STEPS, N_SAMPLES, xdim, generator=gen, device="cuda"))
    x0, noise = inputs
    cd = dict(compute_dtype=compute_dtype)
    out_k = fused_em_sampler(params, x0, y, EM_STEPS, noise=noise, **cd)
    out_p = em_sampler_reference(params, x0, y, EM_STEPS, noise=noise, **cd)
    out_d = em_sampler_reference(params, x0, y, EM_STEPS, noise=noise, compute_dtype=torch.float64,
                                 dtype=torch.float64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "B1 produced non-finite samples")
    err = (out_k - out_p).abs().amax(dim=1)
    res = {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "p999_abs_err": float(torch.quantile(err, 0.999)),
        **f64_witness(torch, out_k, out_p, out_d),
    }
    mean_tol, p999_tol = em_tols(torch, compute_dtype)
    check(res["mean_abs_err"] <= mean_tol and res["p999_abs_err"] <= p999_tol,
          f"B1 ({em_mode(torch, compute_dtype)}) vs plain (same noise) out of tolerance: {res}")
    check_f64(torch, res, "B1", compute_dtype, bf16_f64_p999)
    xk = fused_em_sampler(params, x0, y, EM_STEPS, seed=1234, **cd)
    xp = em_sampler_reference(params, x0, y, EM_STEPS, generator=gen, **cd)
    dm = float((xk.mean(0) - xp.mean(0)).abs().max())
    dc = float((torch.cov(xk.T) - torch.cov(xp.T)).abs().max())
    res.update(philox_mean_diff=dm, philox_cov_diff=dc)
    check(dm <= MOMENT_TOL and dc <= MOMENT_TOL, f"B1 Philox moments off: {res}")
    return res, inputs


def check_b2(torch, weights, y, gen, fparams, n=MH_CHAINS):
    """B2 against its plain version on ``n`` chains (the ground-truth
    driver's 300k in one process, and the 150k a rank of its ``--devices
    2`` launches): one step with the same randomness (uniforms kept >= 1e-3
    from the accept threshold), then the energies the kernel carries after
    it against the plain energy in float64 on the same states (the float64
    witness), then 1000 steps with the same randomness, then the Philox
    stream's moments against torch's."""
    from dmip_tpu_torch.ops.mh_kernel import fused_mh_scatterometry, mh_chains_reference, mh_energy

    kw = dict(noise_std=0.5, a=fparams["a"], b=fparams["b"], lambd_bd=fparams["lambd_bd"])
    ekw = dict(a=kw["a"], b=kw["b"], lambd_bd=kw["lambd_bd"])
    x0 = torch.rand(n, 3, generator=gen, device="cuda") * 2 - 1
    # one step, uniforms moved >= 1e-3 away from the plain accept threshold
    z1 = torch.randn(1, n, 3, generator=gen, device="cuda")
    u1 = torch.rand(1, n, generator=gen, device="cuda")
    energy = mh_energy(weights, y, **ekw)
    thr = torch.exp(energy(x0) - energy(x0 + 0.5 * z1[0])).clamp(max=2.0)
    near = (u1[0] - thr).abs() < 1e-3
    u1[0] = torch.where(near, torch.where(thr > 2e-3, thr - 2e-3, thr + 2e-3), u1[0])
    e_k = torch.empty(n, device="cuda")
    s_k = fused_mh_scatterometry(weights, x0, y, 1, noise=z1, uniforms=u1, energy_out=e_k, **kw)
    s_p = mh_chains_reference(weights, x0, y, 1, noise=z1, uniforms=u1, **kw)
    step_err = float((s_k - s_p).abs().max())
    check(step_err <= B2_STEP_TOL, f"B2 one-step vs plain: max abs err {step_err}")
    # the carried energies against float64 on the kernel's states, beside
    # the f32 plain energy and the split-TF32 model's (3 terms)
    e64 = mh_energy([(w.double(), b.double()) for w, b in weights], y, **ekw)(s_k.double())
    scale = e64.abs().clamp(min=1.0)
    res = {"max_abs_err": step_err}
    q = torch.tensor([0.5, 0.999], device="cuda", dtype=torch.float64)
    for name, e in (("kernel", e_k), ("plain", energy(s_k)), ("split3", mh_energy(weights, y, terms=3, **ekw)(s_k))):
        rel = (e.double() - e64).abs() / scale
        p50, p999 = torch.quantile(rel, q).tolist()
        res.update({f"f64_{name}_p50": p50, f"f64_{name}_p999": p999, f"f64_{name}_max": float(rel.max())})
    check(bool(torch.isfinite(e_k).all()), "B2 carried a non-finite energy")
    check(res["f64_kernel_p999"] <= B2_F64_RATIO * res["f64_plain_p999"],
          f"B2 energies further from float64 than the f32 plain version's: {res}")
    # full run, same randomness
    z = torch.randn(MH_STEPS, n, 3, generator=gen, device="cuda")
    u = torch.rand(MH_STEPS, n, generator=gen, device="cuda")
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
    res.update({"mismatch_share_1000_steps": share, "philox_mean_diff": dm, "philox_std_diff": ds})
    check(dm <= MOMENT_TOL and ds <= MOMENT_TOL, f"B2 Philox moments off: {res}")
    return res


def check_b4(torch, params, y, gen, moments=True, compute_dtype=None, inputs=None, bf16_f64_p999=None):
    """B4 in the mode ``compute_dtype`` (bf16 by default) against its plain
    version in that mode on the joint net ``params`` and condition y at
    the serving path's 30k samples x 200 steps: the same x0 and (steps, N,
    xdim + ydim) noise, and the noise-off trajectory; with the same noise
    also both against the plain version run unrounded in float64 (the
    float64 witness); with ``moments``, the Philox stream's moments against
    torch's.  ``inputs`` and ``bf16_f64_p999`` as in check_b1.  Returns the
    results and the inputs."""
    from dmip_tpu_torch.ops.em_kernel import em_cdiffe_reference, fused_em_sampler_cdiffe

    compute_dtype = compute_dtype or torch.bfloat16
    mode = em_mode(torch, compute_dtype)
    width = params[0][0].shape[0] - 1
    xdim = width - y.numel()
    if inputs is None:
        inputs = (torch.randn(N_SAMPLES, xdim, generator=gen, device="cuda"),
                  torch.randn(EM_STEPS, N_SAMPLES, width, generator=gen, device="cuda"))
    x0, noise = inputs
    cd = dict(compute_dtype=compute_dtype)
    mean_tol, p999_tol = (B4_MEAN_ABS_TOL, B4_P999_TOL) if mode == "bf16" else em_tols(torch, compute_dtype)
    res = {}
    for label, kw in (("same_noise", dict(noise=noise)), ("noise_off", dict(noise_scale=0.0))):
        out_k = fused_em_sampler_cdiffe(params, x0, y, EM_STEPS, **kw, **cd)
        out_p = em_cdiffe_reference(params, x0, y, EM_STEPS, **kw, **cd)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"B4 ({mode}, {label}) produced non-finite samples")
        err = (out_k - out_p).abs().amax(dim=1)
        r = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
             "p999_abs_err": float(torch.quantile(err, 0.999))}
        res.update({f"{label}_{k}": v for k, v in r.items()})
        check(r["mean_abs_err"] <= mean_tol and r["p999_abs_err"] <= p999_tol,
              f"B4 ({mode}) vs plain ({label}) out of tolerance: {r}")
        if label == "same_noise":
            out_d = em_cdiffe_reference(params, x0, y, EM_STEPS, compute_dtype=torch.float64, dtype=torch.float64,
                                        **kw)
            res.update(f64_witness(torch, out_k, out_p, out_d))
            check_f64(torch, res, "B4", compute_dtype, bf16_f64_p999)
    res["max_abs_err"] = max(res["same_noise_max_abs_err"], res["noise_off_max_abs_err"])
    if moments:
        xk = fused_em_sampler_cdiffe(params, x0, y, EM_STEPS, seed=1234, **cd)
        xp = em_cdiffe_reference(params, x0, y, EM_STEPS, generator=gen, **cd)
        dm = float((xk.mean(0) - xp.mean(0)).abs().max())
        dc = float((torch.cov(xk.T) - torch.cov(xp.T)).abs().max())
        res.update(philox_mean_diff=dm, philox_cov_diff=dc)
        check(dm <= MOMENT_TOL and dc <= MOMENT_TOL, f"B4 ({mode}) Philox moments off: {res}")
    return res, inputs


def check_b5_steps(torch, prior, weights, y, gen, kw):
    """B5 against its plain version one step at a time over the 200-step
    grid: from the plain trajectory's state, the same noise.  Returns the
    per-(step, row) error quantiles, relative to the row's step length.
    Each step also runs the plain version in float64 from the same state
    and noise, and the kernel's and the plain version's errors against it
    are returned on the same scale (``f64_kernel_*``, ``f64_plain_*``): f32
    rounding in another sum order leaves the two alike, a wrong term in the
    kernel makes its own far larger."""
    from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler, guided_em_reference

    x = torch.randn(N_SAMPLES, 3, generator=gen, device="cuda")
    rel, vs_f64k, vs_f64p, worst = [], [], [], 0.0
    for i in range(EM_STEPS):
        run = dict(num_steps=EM_STEPS, start_step=i, stop_step=i + 1,
                   noise=torch.randn(1, N_SAMPLES, 3, generator=gen, device="cuda"), **kw)
        xk = fused_guided_em_sampler(prior, weights, x, y, **run)
        xp = guided_em_reference(prior, weights, x, y, **run)
        xd = guided_em_reference(prior, weights, x, y, dtype=torch.float64, **run)
        check(bool(torch.isfinite(xk).all()), f"B5 step {i} produced non-finite samples ({kw})")
        err = (xk - xp).abs().amax(dim=1)
        worst = max(worst, float(err.max()))
        rel.append(err / (xp - x).abs().amax(dim=1).clamp(min=1e-6))
        step64 = (xd - x).abs().amax(dim=1).clamp(min=1e-6)
        vs_f64k.append(((xk - xd).abs().amax(dim=1) / step64).float())
        vs_f64p.append(((xp - xd).abs().amax(dim=1) / step64).float())
        x = xp
    pick = torch.randperm(N_SAMPLES * EM_STEPS, generator=gen, device="cuda")[:10**6]
    res = {"step_max_abs_err": worst}
    for name, r in (("step_rel", rel), ("f64_kernel", vs_f64k), ("f64_plain", vs_f64p)):
        r = torch.cat(r)
        q = torch.quantile(r[pick], torch.tensor([0.5, 0.999], device="cuda"))
        res.update({f"{name}_p50": float(q[0]), f"{name}_p999": float(q[1]), f"{name}_max": float(r.max()),
                    f"{name}_share_above_1e-2": float((r > 1e-2).float().mean())})
    res["step_share_above_1e-2"] = res.pop("step_rel_share_above_1e-2")
    check(res["step_rel_p50"] <= B5_STEP_P50_TOL and res["step_rel_p999"] <= B5_STEP_P999_TOL
          and res["step_share_above_1e-2"] <= B5_STEP_SHARE,
          f"B5 vs plain (step by step, {kw}) out of tolerance: {res}")
    check(res["f64_kernel_p999"] <= B5_F64_RATIO * res["f64_plain_p999"],
          f"B5 (step by step, {kw}) further from float64 than the f32 plain version: {res}")
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
    with ``full`` bf16 for 2 epochs, the masked epoch, one launch of 2
    epochs against two launches of 1 (bit for bit) and a poisoned batch
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
    # the second epoch from the first one's state: the same bits as one launch of both
    second = fused_dsm_train_epochs(*first[:4], h0[rows:], eps[rows:], s1[rows:], n_epochs=1, n_batches=n_batches,
                                    n_active=1, **kw)
    flat = lambda r: [t for tree in r[:3] for pair in tree for t in pair]
    res["two_launches_equal_one"] = (all(torch.equal(x, y) for x, y in zip(flat(k), flat(second)))
                                     and int(k[3]) == int(second[3])
                                     and torch.equal(k[4], torch.cat([first[4], second[4]])))
    check(res["two_launches_equal_one"], "B3: two launches of 1 epoch differ from one launch of 2")
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
    scatterometry GT in ``gt_dir``.  Returns the launch counts and the
    kernel path's (KL, NLPD, score-MSE) for each problem."""
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
    return launches, {"linear": lin_k, "scat": scat_k}


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

    ckpt = lambda name: os.path.join(REPO, "benchmarks/checkpoints", name)
    cd = dict(card_config("config_scatterometry_cdiffe.yml"),
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

    dps = dict(card_config("config_scatterometry_dps.yml"),
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


class F32Sampling:
    """A diffusion model whose ``sample`` asks for compute_dtype=torch.float32
    (on the card, the f32-weight kernels); everything else is the model's."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)

    def sample(self, *args, **kw):
        import torch

        return self.model.sample(*args, compute_dtype=torch.float32, **kw)


def serve_f32(torch, lin_cfg, scat_cfg, gt_dir) -> dict:
    """The f32-weight mode served at full width through the evaluation and
    CDE.sample(compute_dtype=torch.float32), f32 launches counted from zero
    around each: ``cde_500k`` on serve()'s SCAT_CONDITIONS conditions x
    SERVE_F32_SCAT_REPEATS repeats against serve()'s GT, beside the bf16
    kernel and the plain f32 path on the same conditions and repeats;
    ``linear_refined_winner`` on serve()'s first SERVE_F32_LIN_CONDITIONS
    conditions x REPEATS, beside serve()'s bf16 and plain rows of them;
    ``cdiffe_scat`` through CDiffE.sample(compute_dtype=torch.float32) on one
    condition x one repeat.  Returns the f32 launches of B1 and B4."""
    from dmip_tpu_torch import data, evaluate
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.ops import fused_em_sampler, fused_em_sampler_cdiffe
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.problems import scatterometry as scat

    ckpt = lambda name: os.path.join(REPO, "benchmarks/checkpoints", name)
    f32_launches = lambda fn: fn.launches_by_dtype["float32"]
    for fn in (fused_em_sampler, fused_em_sampler_cdiffe):
        fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)
    forward_model, fparams = scat.load_forward_model(device="cuda")
    sc = dict(scat_cfg, n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=SERVE_F32_SCAT_REPEATS)
    ys = gt.test_conditions(sc, forward_model, fparams, "cuda")
    score_post = scat.score_posterior(forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"])

    def scat_eval(model, params, conditions, repeats, method="auto"):
        return evaluate.evaluate_scatterometry(
            model, params, forward_model, fparams, score_post, conditions, data.gt_loader(gt_dir),
            torch.Generator(device="cuda").manual_seed(0), n_samples_x=N_SAMPLES, n_repeats=repeats,
            num_steps=EM_STEPS, method=method, verbose=False)

    model, params = eval_diffusion._load_net(sc, fparams, ckpt("cde_500k"), "cuda")
    t0 = time.time()
    k32 = scat_eval(F32Sampling(model), params, ys, SERVE_F32_SCAT_REPEATS)
    torch.cuda.synchronize()
    n_scat = f32_launches(fused_em_sampler)
    t1 = time.time()
    kbf = scat_eval(model, params, ys, SERVE_F32_SCAT_REPEATS)
    kpl = scat_eval(model, params, ys, SERVE_F32_SCAT_REPEATS, method="plain")
    phase("serve_f32_scat", t0, conditions=SCAT_CONDITIONS, repeats=SERVE_F32_SCAT_REPEATS,
          f32_seconds=t1 - t0, KL=k32[0], NLPD=k32[1], score_MSE=k32[2], KL_bf16_kernel=kbf[0], KL_plain_f32=kpl[0],
          launches_f32=n_scat)
    check(n_scat == SCAT_CONDITIONS * SERVE_F32_SCAT_REPEATS, f"serve_f32_scat: {n_scat} f32 B1 launches")
    check(_finite([*k32]), f"non-finite f32 scatterometry metrics {k32}")
    check(abs(k32[0] - kpl[0]) <= SCAT_KL_AGREE, f"scatterometry KL f32 kernel {k32[0]} vs plain {kpl[0]}")

    lin = dict(lin_cfg, n_samples_y=LIN_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=REPEATS)
    prob = LinearForwardProblem()
    y_lin = eval_diffusion.linear_test_conditions(lin, prob, "cuda")[:SERVE_F32_LIN_CONDITIONS]
    lmodel, lparams = eval_diffusion._load_net(lin, {"xdim": prob.xdim, "ydim": prob.ydim},
                                               ckpt("linear_refined_winner"), "cuda")
    t0 = time.time()
    l32 = evaluate.evaluate_linear(F32Sampling(lmodel), lparams, prob, y_lin, torch.Generator(device="cuda").manual_seed(0),
                                   n_samples_x=N_SAMPLES, n_repeats=REPEATS, num_steps=EM_STEPS, verbose=False)
    torch.cuda.synchronize()
    n_lin = f32_launches(fused_em_sampler) - n_scat
    served = lambda sub: sum(_column(os.path.join(gt_dir, sub, "results.csv"), "KL2")[:SERVE_F32_LIN_CONDITIONS]) / \
        SERVE_F32_LIN_CONDITIONS
    lbf, lpl = served("lin"), served("lin_plain")
    phase("serve_f32_linear", t0, conditions=SERVE_F32_LIN_CONDITIONS, repeats=REPEATS, KL=l32[0], NLPD=l32[1],
          score_MSE=l32[2], KL_bf16_kernel=lbf, KL_plain_f32=lpl, launches_f32=n_lin)
    check(n_lin == SERVE_F32_LIN_CONDITIONS * REPEATS, f"serve_f32_linear: {n_lin} f32 B1 launches")
    check(l32[0] < LIN_KL_BOUND, f"linear KL (f32 kernel) {l32[0]} above {LIN_KL_BOUND}")
    check(abs(l32[0] - lpl) <= LIN_KL_AGREE, f"linear KL f32 kernel {l32[0]} vs plain {lpl}")

    cd = dict(card_config("config_scatterometry_cdiffe.yml"), n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES)
    cmodel, cparams = eval_diffusion._load_net(cd, fparams, ckpt("cdiffe_scat"), "cuda")
    t0 = time.time()
    c32 = scat_eval(F32Sampling(cmodel), cparams, ys[:1], 1)
    torch.cuda.synchronize()
    n_b4 = f32_launches(fused_em_sampler_cdiffe)
    phase("serve_f32_cdiffe", t0, conditions=1, repeats=1, KL=c32[0], NLPD=c32[1], score_MSE=c32[2],
          launches_f32=n_b4)
    check(n_b4 == 1 and _finite([*c32]), f"serve_f32_cdiffe: {n_b4} f32 B4 launches, metrics {c32}")
    return {"em": n_scat + n_lin, "em_cdiffe": n_b4, "em_by_net": {"cde_500k": n_scat, "linear_refined_winner": n_lin}}


def _column(path, name):
    """One column of a results.csv, per condition."""
    with open(path) as f:
        rows = [ln.strip().split(",") for ln in f]
    j = rows[0].index(name)
    return [float(r[j]) for r in rows[1:]]


def serve_refined(torch, unrefined, gt_dir) -> dict:
    """The energy-refined rows through the eval driver, on serve()'s
    conditions and GT, B1 launches counted from zero around each:
    ``cde_500k`` under ``config_scatterometry_refined.yml``'s own refine
    dict (annealed MH), held condition by condition against the unrefined
    row of ``serve_scat_eval``, with every step's acceptance rate read from
    the chains; ``linear_refined_winner`` under ``config_linear_refined.yml``
    (MH) against ``serve_linear``; ``linear_pinn2`` raw and under MALA.
    Returns the B1 launches by net shape."""
    from dmip_tpu_torch import mcmc
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.ops import fused_em_sampler

    ckpt = lambda name: os.path.join(REPO, "benchmarks/checkpoints", name)

    def cfg(name, **kw):
        return dict(card_config(name), n_samples_x=N_SAMPLES, n_repeats=REPEATS, **kw)

    sc = cfg("config_scatterometry_refined.yml", n_samples_y=SCAT_CONDITIONS)
    infos, chain = [], mcmc.annealed_mh

    def chain_with_info(*args, **kwargs):
        x, info = chain(*args, **kwargs)
        infos.append(info)
        return x, info

    fused_em_sampler.launches = 0
    mcmc.annealed_mh = chain_with_info
    t0 = time.time()
    try:
        r = eval_diffusion.run("scatterometry", ckpt("cde_500k"), sc, gt_dir=gt_dir, device="cuda",
                               out_dir=os.path.join(gt_dir, "scat"))
        torch.cuda.synchronize()
    finally:
        mcmc.annealed_mh = chain
    n_scat = fused_em_sampler.launches
    kl_ref = _column(os.path.join(gt_dir, "scat_refined", "results.csv"), "KL2")
    kl_raw = _column(os.path.join(gt_dir, "scat", "results.csv"), "KL2")
    acc = torch.stack([i["acc_rate"] for i in infos])
    phase("serve_refined_scat", t0, conditions=SCAT_CONDITIONS, repeats=REPEATS, refine=sc["refine"], KL=r[0],
          NLPD=r[1], score_MSE=r[2], KL_by_condition=kl_ref, unrefined_KL_by_condition=kl_raw,
          unrefined_NLPD=unrefined["scat"][1], acc_rate_by_step=acc.mean(0).tolist(),
          acc_rate_min_max=[float(acc.min()), float(acc.max())], chains=len(infos), launches=n_scat)
    check(n_scat == REPEATS * SCAT_CONDITIONS and len(infos) == n_scat,
          f"serve_refined_scat: {n_scat} B1 launches, {len(infos)} chains")
    check(all(a < b for a, b in zip(kl_ref, kl_raw)), f"refined KL {kl_ref} not below the unrefined {kl_raw}")
    check(r[1] < unrefined["scat"][1], f"refined NLPD {r[1]} not below the unrefined {unrefined['scat'][1]}")

    runs = (("winner_mh", "linear_refined_winner", cfg("config_linear_refined.yml", n_samples_y=LIN_CONDITIONS)),
            ("pinn2_raw", "linear_pinn2", cfg("config_linear_pinn2.yml", n_samples_y=LIN_CONDITIONS, refine=None)),
            ("pinn2_mala", "linear_pinn2", cfg("config_linear_pinn2.yml", n_samples_y=LIN_CONDITIONS,
                                               refine=REFINE_PINN2)))
    lin, n_lin = {}, 0
    t0 = time.time()
    for name, net, c in runs:
        fused_em_sampler.launches = 0
        m = eval_diffusion.run("linear", ckpt(net), c, device="cuda", out_dir=os.path.join(gt_dir, name))
        torch.cuda.synchronize()
        n = fused_em_sampler.launches
        lin[name] = {"refine": c["refine"], "KL": m[0], "NLPD": m[1], "score_MSE": m[2], "launches": n}
        n_lin += n
        check(n == REPEATS * LIN_CONDITIONS, f"{name}: {n} B1 launches")
    phase("serve_refined_linear", t0, conditions=LIN_CONDITIONS, unrefined_NLPD=unrefined["linear"][1], **lin)
    check(lin["winner_mh"]["KL"] <= LIN_KL_BOUND, f"refined linear KL {lin['winner_mh']['KL']} above {LIN_KL_BOUND}")
    check(lin["winner_mh"]["NLPD"] < unrefined["linear"][1],
          f"refined linear NLPD {lin['winner_mh']['NLPD']} not below the unrefined {unrefined['linear'][1]}")
    check(lin["pinn2_mala"]["KL"] <= LIN_KL_BOUND,
          f"MALA-refined linear_pinn2 KL {lin['pinn2_mala']['KL']} above {LIN_KL_BOUND}")
    return {"cde_500k": n_scat, "linear": n_lin}


def serve_samplers(torch, lin_cfg, scat_cfg, unrefined, gt_dir) -> dict:
    """The exponential integrator and Heun through the eval driver on
    serve()'s conditions and GT (plain PyTorch: no kernel launch), held
    against the E-M rows; then the time per 30k-sample posterior of every
    sampler the serving phases ran, beside B1's, by CUDA events, in one
    call.  Returns the times."""
    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.models import CDE
    from dmip_tpu_torch.models.refined import for_problem
    from dmip_tpu_torch.ops import fused_em_sampler
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.problems import scatterometry as scat
    from dmip_tpu_torch.utils import profiling

    ckpt = lambda name: os.path.join(REPO, "benchmarks/checkpoints", name)
    sized = dict(n_samples_x=N_SAMPLES, n_repeats=REPEATS, eval_num_steps=EXPINT_STEPS)
    fused_em_sampler.launches = 0
    t0 = time.time()
    rows = {}
    m = eval_diffusion.run("scatterometry", ckpt("cde_500k"), dict(scat_cfg, n_samples_y=SCAT_CONDITIONS, **sized),
                           gt_dir=gt_dir, device="cuda", method="expint:sde:1",
                           out_dir=os.path.join(gt_dir, "scat_expint"))
    rows["scat_expint:sde:1"] = {"KL": m[0], "NLPD": m[1], "score_MSE": m[2], "em_KL": unrefined["scat"][0]}
    for method in EXPINT_LIN_METHODS:
        m = eval_diffusion.run("linear", ckpt("linear_refined_winner"),
                               dict(lin_cfg, n_samples_y=LIN_CONDITIONS, **sized), device="cuda", method=method,
                               out_dir=os.path.join(gt_dir, "lin_" + method))
        rows[f"linear_{method}"] = {"KL": m[0], "NLPD": m[1], "score_MSE": m[2]}
    m = eval_diffusion.run("linear", ckpt("linear_refined_winner"),
                           dict(lin_cfg, n_samples_y=1, n_samples_x=N_SAMPLES, n_repeats=REPEATS,
                                eval_num_steps=HEUN_STEPS),
                           device="cuda", method="heun", out_dir=os.path.join(gt_dir, "lin_heun"))
    rows["linear_heun"] = {"KL": m[0], "NLPD": m[1], "score_MSE": m[2]}
    torch.cuda.synchronize()
    phase("serve_expint", t0, steps=EXPINT_STEPS, heun_steps=HEUN_STEPS, launches=fused_em_sampler.launches, **rows)
    check(fused_em_sampler.launches == 0, "the exponential integrator or Heun launched B1")
    check(abs(rows["scat_expint:sde:1"]["KL"] - unrefined["scat"][0]) <= SCAT_KL_AGREE,
          f"scatterometry expint KL {rows['scat_expint:sde:1']['KL']} vs E-M {unrefined['scat'][0]}")
    check(all(rows[f"linear_{m}"]["KL"] <= LIN_KL_BOUND for m in EXPINT_LIN_METHODS), f"linear expint KL {rows}")
    check(_finite(rows["linear_heun"].values()), f"non-finite Heun metrics {rows['linear_heun']}")

    # ms per 30k-sample posterior: every sampler of the serving phases, on the
    # first condition of each problem, in one call
    t0 = time.time()
    forward_model, fp = scat.load_forward_model(device="cuda")
    y_scat = gt.test_conditions(scat_cfg, forward_model, fp, "cuda")[0]
    y_lin = eval_diffusion.linear_test_conditions(lin_cfg, LinearForwardProblem(), "cuda")[0]
    scat_model, lin_model = CDE(xdim=3, ydim=23), CDE(xdim=2, ydim=2)
    refine_scat = card_config("config_scatterometry_refined.yml")["refine"]
    refine_lin = card_config("config_linear_refined.yml")["refine"]
    p_scat = load_archived_params(ckpt("cde_500k"), device="cuda")
    p_lin = load_archived_params(ckpt("linear_refined_winner"), device="cuda")
    scat_refined, scat_tag, _ = for_problem("scatterometry", scat_model, refine_scat, forward_model, fp)
    lin_refined, lin_tag, _ = for_problem("linear", lin_model, refine_lin)
    pinn2_refined, pinn2_tag, _ = for_problem("linear", lin_model, REFINE_PINN2)
    cases = {
        "scat_b1_em200": (scat_model, p_scat, y_scat, EM_STEPS, "kernel"),
        f"scat_refined_{scat_tag}": (scat_refined, p_scat, y_scat, EM_STEPS, "kernel"),
        f"scat_expint:sde:1_{EXPINT_STEPS}": (scat_model, p_scat, y_scat, EXPINT_STEPS, "expint:sde:1"),
        "linear_b1_em200": (lin_model, p_lin, y_lin, EM_STEPS, "kernel"),
        f"linear_refined_{lin_tag}": (lin_refined, p_lin, y_lin, EM_STEPS, "kernel"),
        f"linear_refined_{pinn2_tag}": (pinn2_refined, p_lin, y_lin, EM_STEPS, "kernel"),
        **{f"linear_{m}_{EXPINT_STEPS}": (lin_model, p_lin, y_lin, EXPINT_STEPS, m) for m in EXPINT_LIN_METHODS},
        f"linear_heun_{HEUN_STEPS}": (lin_model, p_lin, y_lin, HEUN_STEPS, "heun"),
    }
    gen = torch.Generator(device="cuda").manual_seed(5)
    ms = {}
    with torch.no_grad():
        for name, (model, params, y, steps, method) in cases.items():
            sec, out = profiling.timeit(lambda: model.sample(params, y, N_SAMPLES, steps, generator=gen,
                                                             device="cuda", method=method), reps=SAMPLER_TIMING_REPS)
            check(out.shape == (N_SAMPLES, model.xdim) and bool(torch.isfinite(out).all()), f"{name}: bad samples")
            ms[name] = 1e3 * sec
    phase("sampler_ms", t0, samples=N_SAMPLES, reps=SAMPLER_TIMING_REPS, ms_per_posterior=ms,
          expint_over_b1={"scat": ms[f"scat_expint:sde:1_{EXPINT_STEPS}"] / ms["scat_b1_em200"],
                          "linear": ms[f"linear_expint:sde:1_{EXPINT_STEPS}"] / ms["linear_b1_em200"]})
    return ms


def profile_serve(torch, lin_cfg, gt_dir) -> dict:
    """Under ``torch.profiler``: one linear serving condition (10 repeats of
    30k samples through B1, and their scoring), then one refined linear
    posterior (``config_linear_refined.yml``'s chain after B1's proposal).
    For each, the share of the traced window in which the card ran a kernel
    and the top five operations by device and by host time.  Fails if the
    profiler sees no device activity."""
    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.models import CDE
    from dmip_tpu_torch.models.refined import for_problem
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.utils import profiling

    cfg = dict(lin_cfg, n_samples_y=1, n_samples_x=N_SAMPLES, n_repeats=REPEATS)
    ckpt = os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner")
    refined, _, _ = for_problem("linear", CDE(xdim=2, ydim=2),
                                card_config("config_linear_refined.yml")["refine"])
    params = load_archived_params(ckpt, device="cuda")
    y = eval_diffusion.linear_test_conditions(lin_cfg, LinearForwardProblem(), "cuda")[0]
    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.time()
    res = {}
    with profiling.trace() as prof:
        m = eval_diffusion.run("linear", ckpt, cfg, device="cuda", out_dir=os.path.join(gt_dir, "lin_profiled"))
    traces = {"linear_condition": prof}
    with torch.no_grad(), profiling.trace() as prof:
        refined.sample(params, y, N_SAMPLES, EM_STEPS, generator=gen, device="cuda")
    traces["refined_linear_posterior"] = prof
    for name, prof in traces.items():
        try:
            busy = profiling.busy_share(prof)
        except RuntimeError as e:
            raise CheckFailed(f"profile_serve ({name}): {e}") from e
        res[name] = {"busy": busy, "top_device": profiling.top_ops(prof, "device"),
                     "top_cpu": profiling.top_ops(prof, "cpu")}
        check(0.0 < busy["share"] <= 1.0 and res[name]["top_device"][0]["ms"] > 0.0, f"profile_serve: {res}")
    phase("profile_serve", t0, KL=m[0], **res)
    return res


def seed_forms(torch, nets, cd_params, prior, weights, fparams, y0) -> dict:
    """B1, B4 and B5 at the main path's shapes, each launched with an int
    seed and with the same value as a one-element int64 tensor on the card
    (the form the samplers now hand the kernels): bit for bit, or fail."""
    from dmip_tpu_torch.ops import fused_em_sampler, fused_em_sampler_cdiffe, fused_guided_em_sampler

    seed = 2**61 + 1234567
    gen = torch.Generator(device="cuda").manual_seed(5)
    x0 = torch.randn(N_SAMPLES, 3, generator=gen, device="cuda")
    x0_lin = torch.randn(N_SAMPLES, 2, generator=gen, device="cuda")
    lin_params, y_lin = nets["linear_refined_winner"]
    runs = {
        "b1_cde_500k": lambda s: fused_em_sampler(nets["cde_500k"][0], x0, y0, EM_STEPS, seed=s),
        "b1_linear": lambda s: fused_em_sampler(lin_params, x0_lin, y_lin, EM_STEPS, seed=s),
        "b4": lambda s: fused_em_sampler_cdiffe(cd_params, x0, y0, EM_STEPS, seed=s),
        "b5": lambda s: fused_guided_em_sampler(prior, weights, x0, y0, a=fparams["a"], b=fparams["b"],
                                                num_steps=EM_STEPS, seed=s),
    }
    out = {}
    for name, run in runs.items():
        a, b = run(seed), run(torch.tensor([seed], dtype=torch.int64, device="cuda"))
        out[name] = bool(torch.equal(a, b))
        check(out[name], f"seed_forms: {name} with a tensor seed differs from the int seed")
        check(not torch.equal(a, run(seed + 1)), f"seed_forms: {name} ignores its seed")
    return out


def eval_engine(torch, lin_cfg, scat_cfg, gt_dir, seeds: dict) -> dict:
    """The evaluation engine at full width, launch counts from zero around
    it.  Linear: ``linear_refined_winner`` on EVAL_LIN_CONDITIONS test
    conditions x REPEATS x N_SAMPLES x EM_STEPS through B1, by
    evaluate_linear with chunk=None and with one chunk of all of them, each
    called twice from EVAL_SEED (ms a condition from the second call); the
    two results.csv must be equal byte for byte.  Scatterometry:
    ``cde_500k`` on SCAT_CONDITIONS conditions against GT drawn here (B2),
    chunk=SCAT_CONDITIONS, twice.  Then one chunk of each problem from the
    same seed through make_eval_many_*: queued under the sync debug mode
    "error" (the GT's pinned staging included) and read after it, inside a
    trace (host syncs in the span, the card's busy share, the top eight
    device ops); its rows must be the harness's.  Last, the time B1's
    wrapper takes to pack each net's weights for a launch, by CUDA events
    and as the card's busy time in a trace, beside a launch of B1 in the
    traced chunk.  ``seeds`` (seed_forms) ride
    along in the phase line.  Returns B1's launches a net and B2's."""
    from dmip_tpu_torch import data, evaluate, train
    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains import eval_diffusion
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.ops import em_kernel, fused_em_sampler, fused_mh_scatterometry
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.problems import scatterometry as scat
    from dmip_tpu_torch.utils import profiling

    ckpt = lambda name: os.path.join(REPO, "benchmarks/checkpoints", name)
    common = dict(n_samples_x=N_SAMPLES, n_repeats=REPEATS, num_steps=EM_STEPS, verbose=False)
    gen = lambda: torch.Generator(device="cuda").manual_seed(EVAL_SEED)
    prob = LinearForwardProblem()
    lmodel, _ = train.get_model_from_args(lin_cfg, {"xdim": prob.xdim, "ydim": prob.ydim})
    lparams = load_archived_params(ckpt("linear_refined_winner"), device="cuda")
    ys = eval_diffusion.linear_test_conditions(lin_cfg, prob, "cuda")[:EVAL_LIN_CONDITIONS]
    sc = dict(scat_cfg, n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=REPEATS)
    forward_model, fparams = scat.load_forward_model(device="cuda")
    smodel, _ = train.get_model_from_args(sc, fparams)
    sparams = load_archived_params(ckpt("cde_500k"), device="cuda")
    score = scat.score_posterior(forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"])
    gt_own = os.path.join(gt_dir, "engine_gt")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        m = fn()
        torch.cuda.synchronize()
        return m, time.time() - t

    def rows(path):
        with open(path) as f:
            return [[float(v) for v in ln.strip().split(",")[1:]] for ln in list(f)[1:]]

    fused_em_sampler.launches = fused_mh_scatterometry.launches = 0
    t0 = time.time()
    lin, csv_bytes = {}, {}
    for chunk in (None, EVAL_LIN_CONDITIONS):
        out_dir = os.path.join(gt_dir, f"engine_lin_{chunk}")
        run = lambda: evaluate.evaluate_linear(lmodel, lparams, prob, ys, gen(), out_dir=out_dir, chunk=chunk, **common)
        (m, first_s), (m2, second_s) = timed(run), timed(run)
        with open(os.path.join(out_dir, "results.csv"), "rb") as f:
            csv_bytes[chunk] = f.read()
        lin[f"chunk_{chunk}"] = {"KL": m2[0], "NLPD": m2[1], "score_MSE": m2[2], "first_call_s": first_s,
                                 "ms_per_condition": 1e3 * second_s / len(ys)}
        check(m == m2, f"eval_engine: two linear calls from one seed differ, {m} and {m2}")
    check(csv_bytes[None] == csv_bytes[EVAL_LIN_CONDITIONS], "eval_engine: chunk=None and chunk=10 rows differ")
    check(lin["chunk_None"]["KL"] < LIN_KL_BOUND, f"eval_engine: linear KL {lin['chunk_None']['KL']}")

    t1 = time.time()
    gt.run(sc, gt_own, device="cuda")
    torch.cuda.synchronize()
    gt_s = time.time() - t1
    sys_ = gt.test_conditions(sc, forward_model, fparams, "cuda")[:SCAT_CONDITIONS]
    loader = data.gt_loader(gt_own)
    out_scat = os.path.join(gt_dir, "engine_scat")
    run = lambda: evaluate.evaluate_scatterometry(smodel, sparams, forward_model, fparams, score, sys_, loader, gen(),
                                                  out_dir=out_scat, chunk=SCAT_CONDITIONS, **common)
    (k, first_s), (k2, second_s) = timed(run), timed(run)
    check(k == k2, f"eval_engine: two scatterometry calls from one seed differ, {k} and {k2}")
    check(_finite(k), f"eval_engine: scatterometry metrics {k}")
    scat_res = {"KL": k2[0], "NLPD": k2[1], "score_MSE": k2[2], "first_call_s": first_s,
                "ms_per_condition": 1e3 * second_s / SCAT_CONDITIONS, "gt_seconds": gt_s}

    many_lin = evaluate.make_eval_many_linear(lmodel, prob, N_SAMPLES, REPEATS, EM_STEPS)
    many_scat = evaluate.make_eval_many_scatterometry(smodel, forward_model, fparams, score, N_SAMPLES, EM_STEPS)
    chunks = {
        "linear": (lambda: many_lin(lparams, gen(), ys), rows(os.path.join(gt_dir, "engine_lin_None", "results.csv"))),
        "scat": (lambda: many_scat(sparams, gen(), sys_,
                                   evaluate.stage_ground_truth(loader, range(SCAT_CONDITIONS), REPEATS, "cuda")),
                 rows(os.path.join(out_scat, "results.csv"))),
    }
    traced = {}
    for name, (queue, want) in chunks.items():
        got = []

        def one_chunk():
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = queue()
            except RuntimeError as e:
                raise CheckFailed(f"eval_engine: a host sync inside a {name} chunk: {e}") from e
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got.extend(evaluate.read_stats(out))

        traced[name] = host_trace(torch, one_chunk, 1)
        traced[name]["syncs"] = traced[name].pop("syncs_per_step")
        traced[name]["runtime_calls"] = traced[name].pop("runtime_calls_per_step")
        if name == "linear":
            got = [[r[0], *r[2:]] for r in got]  # results.csv has no reverse KL for linear
        check(got == want, f"eval_engine: the traced {name} chunk's rows differ from the harness's")
        check(traced[name]["syncs"] <= EVAL_SYNCS_MAX, f"eval_engine: {traced[name]['syncs']} host syncs in a "
              f"traced {name} chunk")
    n_b1, n_b2 = fused_em_sampler.launches, fused_mh_scatterometry.launches
    n_lin = 5 * REPEATS * EVAL_LIN_CONDITIONS
    # B1's wrapper re-packs the weights at every launch: the time it takes
    # by CUDA events (bound by the host's launches) and the card's busy time
    # in it, beside a launch of B1
    b1_ms = next(op["ms"] / op["calls"] for op in traced["linear"]["top_ops"] if "em_sampler_kernel" in op["name"])
    pack, reps = {}, 20
    for name, params, y in (("linear_refined_winner", lparams, ys[0]), ("cde_500k", sparams, sys_[0])):
        pack_net = lambda: em_kernel._device_net(params, params[-1][0].shape[1], y)
        sec, _ = profiling.timeit(pack_net, reps=reps)
        with profiling.trace() as prof:
            for _ in range(reps):
                pack_net()
        card = profiling.busy_share(prof)
        pack[name] = {"events_us": 1e6 * sec, "card_us": card["busy_us"] / reps, "kernels": card["kernels"] / reps,
                      "card_share_of_b1_launch": card["busy_us"] / reps / 1e3 / b1_ms}
    check(n_b1 == n_lin + 3 * REPEATS * SCAT_CONDITIONS and n_b2 == SCAT_CONDITIONS,
          f"eval_engine: B1 {n_b1}, B2 {n_b2} launches")
    phase("eval_engine", t0, linear_conditions=EVAL_LIN_CONDITIONS, scat_conditions=SCAT_CONDITIONS, repeats=REPEATS,
          samples=N_SAMPLES, linear=lin, scat=scat_res, rows_equal_chunk_none_and_10=True, traced_chunk=traced,
          seed_forms_bit_for_bit=seeds, b1_launches=n_b1, b2_launches=n_b2, b1_weight_packing=pack)
    check(traced["linear"]["card"]["share"] >= EVAL_BUSY_MIN,
          f"eval_engine: the card busy {traced['linear']['card']['share']:.3f} of a traced linear chunk")
    return {"linear_refined_winner": n_lin, "cde_500k": n_b1 - n_lin, "mh": n_b2}


def train_cdiffe(torch, gt_dir, gen) -> dict:
    """B3 against its plain version at the CDiffE's 27 -> 26 shapes (all of
    check_b3's cases), then CDiffE DSM training through the driver on the
    fused engine (2 launches), evaluated through B4."""
    from dmip_tpu_torch.mains import main_diffusion_scatterometry as mscat
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler_cdiffe

    t0 = time.time()
    b3 = check_b3(torch, B3_CDIFFE[0], B3_CDIFFE[1], B3_CDIFFE[2], gen)
    cfg = dict(card_config("config_scatterometry_cdiffe.yml"), **CDIFFE_TRAIN,
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


def train_log(cfg, tag: str = "Train/Loss"):
    """(epochs, values, seconds) of the run's ``tag`` events, in order."""
    with open(os.path.join(cfg["train_dir"], "logs", "events.jsonl")) as f:
        ev = [json.loads(ln) for ln in f]
    ev = [e for e in ev if e["tag"] == tag]
    return [e["step"] for e in ev], [e["value"] for e in ev], [e["t"] for e in ev]


class FitClock:
    """While active, ``train.fit`` records a CUDA timing event after each
    call to its epoch engine, queued behind the call's work (no wait).
    ``rate(i)`` is the i-th fit's steady rate: the epochs after its first
    call over the card's time from the end of its first call to the end of
    its last.  The log's times cannot give it: under fit's one-call-late
    read an epoch is logged when the host gets to it, up to a call after
    the card finished it when an engine queues more work than the launch
    queue holds."""

    def __init__(self, torch):
        self.torch, self.fits = torch, []

    def __enter__(self):
        from dmip_tpu_torch import train

        fit = train.fit

        def clocked_fit(epoch_fn, *args, **kwargs):
            marks = []
            self.fits.append(marks)

            def epochs(params, opt_state, seed, epoch0, n_active):
                out = epoch_fn(params, opt_state, seed, epoch0, n_active)
                end = self.torch.cuda.Event(enable_timing=True)
                end.record()
                marks.append((n_active, end))
                return out

            return fit(epochs, *args, **kwargs)

        self._train, self._fit, train.fit = train, fit, clocked_fit
        return self

    def __exit__(self, *exc) -> None:
        self._train.fit = self._fit

    def rate(self, i: int = 0) -> float:
        marks = self.fits[i]
        self.torch.cuda.synchronize()
        return sum(n for n, _ in marks[1:]) / (marks[0][1].elapsed_time(marks[-1][1]) / 1e3)


def train(torch, lin_cfg, scat_cfg, gt_dir) -> dict:
    """The training path through the drivers: DSM on the fused kernel for
    both problems (launches counted from zero around each), then the
    autograd engine on the same overrides and on the unchanged linear
    configs, plain and refined (whose refined row must be finite).  Returns
    the launch counts."""
    from dmip_tpu_torch.mains import main_diffusion_linear as mlin
    from dmip_tpu_torch.mains import main_diffusion_scatterometry as mscat
    from dmip_tpu_torch.models.refined import for_problem
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler

    lin_refined_cfg = card_config("config_linear_refined.yml")

    def dirs(name):
        return dict(train_dir=os.path.join(gt_dir, "train_" + name), out_dir=os.path.join(gt_dir, "out_" + name))

    fused = dict(loss_fn="DSM", train_backend="fused_pallas")
    lin = dict(lin_cfg, n_epochs=LIN_TRAIN_EPOCHS, n_samples_y=LIN_CONDITIONS, n_samples_x=N_SAMPLES,
               n_repeats=REPEATS, **fused, **dirs("lin"))
    fused_dsm_train_epochs.launches = fused_em_sampler.launches = 0
    t0 = time.time()
    with FitClock(torch) as clock:
        _, lin_m = mlin.run(lin, device="cuda")
    torch.cuda.synchronize()
    n_lin = {"dsm_train": fused_dsm_train_epochs.launches, "em": fused_em_sampler.launches}
    _, losses, _ = train_log(lin)
    phase("train_linear", t0, epochs=LIN_TRAIN_EPOCHS, launches=n_lin, first_loss=losses[0], last_loss=losses[-1],
          epochs_per_s=clock.rate(), KL=lin_m[0], NLPD=lin_m[1], score_MSE=lin_m[2])
    check(n_lin == {"dsm_train": LIN_TRAIN_EPOCHS // lin["epochs_per_call"], "em": REPEATS * LIN_CONDITIONS},
          f"train_linear launches {n_lin}")
    check(lin_m[0] <= TRAIN_LIN_KL_BOUND, f"trained linear KL {lin_m[0]} above {TRAIN_LIN_KL_BOUND}")
    check(losses[-1] < losses[0], f"linear DSM loss did not fall: {losses[0]} -> {losses[-1]}")

    sc = dict(scat_cfg, n_epochs=SCAT_TRAIN_EPOCHS, n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES,
              n_repeats=REPEATS, **fused, **dirs("scat"))
    fused_dsm_train_epochs.launches = fused_em_sampler.launches = 0
    t0 = time.time()
    with FitClock(torch) as clock:
        _, scat_m = mscat.run(sc, gt_dir, device="cuda")
    torch.cuda.synchronize()
    n_scat = {"dsm_train": fused_dsm_train_epochs.launches, "em": fused_em_sampler.launches}
    _, losses, _ = train_log(sc)
    phase("train_scat", t0, epochs=SCAT_TRAIN_EPOCHS, launches=n_scat, first_loss=losses[0], last_loss=losses[-1],
          epochs_per_s=clock.rate(), KL=scat_m[0], NLPD=scat_m[1], score_MSE=scat_m[2])
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
        "linear_refined_config": (mlin.run, dict(lin_refined_cfg, n_epochs=2)),
    }
    t0 = time.time()
    plain = {}
    for name, (fn, cfg) in runs.items():
        cfg = dict(cfg, **small, **dirs("plain_" + name))
        fused_dsm_train_epochs.launches = 0
        with FitClock(torch) as clock:
            _, m = fn(cfg, device="cuda")
        _, losses, _ = train_log(cfg)
        plain[name] = {"losses": losses, "epochs_per_s": clock.rate(), "KL": m[0]}
        check(fused_dsm_train_epochs.launches == 0, f"{name}: the autograd engine launched B3")
        check(all(v == v and abs(v) != float("inf") for v in losses) and losses[-1] < losses[0],
              f"{name}: losses not finite and falling: {losses}")
        if cfg.get("refine"):
            _, tag, suffix = for_problem("linear", None, cfg["refine"])
            plain[name]["refined"] = {tag: _results(os.path.join(cfg["out_dir"] + suffix, "results.csv"))}
            check(_finite(plain[name]["refined"][tag].values()), f"{name}: refined row {plain[name]['refined']}")
    phase("train_plain", t0, loss_fn_linear_config=lin_cfg["loss_fn"], **plain)
    return {"linear": n_lin["dsm_train"], "scat": n_scat["dsm_train"]}


def fused_engines(torch, lin_cfg, scat_cfg) -> dict:
    """The fused DSM engine of each shipped config as its driver builds it
    (data, init and seeds), on the card: {name: (config, model, batch_fn,
    epoch_fn, optimizer, initial params, train seed)}."""
    from dmip_tpu_torch import data, train
    from dmip_tpu_torch.mains.eval_diffusion import linear_split
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.problems import scatterometry as scat

    fused = dict(loss_fn="DSM", train_backend="fused_pallas")
    built = {}
    prob = LinearForwardProblem()
    cfg = dict(lin_cfg, **fused)
    seed = int(cfg["random_state"])
    x_train, _, y_train, _ = linear_split(cfg, prob, "cuda")
    model, loss_cfg = train.get_model_from_args(cfg, {"xdim": prob.xdim, "ydim": prob.ydim})
    lin_batch = int(cfg["batch_size"])
    batch_fn = lambda g: data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, lin_batch)
    built["linear"] = (cfg, model, loss_cfg, batch_fn, seed + 1, seed + 2)
    cfg = dict(scat_cfg, **fused)
    seed = int(cfg["RANDOM_STATE"])
    forward_model, fp = scat.load_forward_model(device="cuda")
    model, loss_cfg = train.get_model_from_args(cfg, fp)
    scat_batch = int(cfg["batch_size"])
    scat_batches = lambda g: data.scatterometry_epoch_batches(g, forward_model, fp["a"], fp["b"], fp["lambd_bd"],
                                                              scat_batch)
    built["scat"] = (cfg, model, loss_cfg, scat_batches, seed + 2, seed + 3)
    engines = {}
    for name, (cfg, model, loss_cfg, batch_fn, init_seed, seed) in built.items():
        opt = train.build_optimizer(float(cfg["lr"]))
        fn = train.select_epoch_fn(cfg, model, model.make_loss_fn(loss_cfg), opt, batch_fn,
                                   int(cfg["epochs_per_call"]))
        p0 = model.init(torch.Generator().manual_seed(init_seed), device="cuda")
        engines[name] = (cfg, model, batch_fn, fn, opt, p0, seed)
    return engines


def train_fused_host(torch, lin_cfg, scat_cfg) -> dict:
    """The fused engine's host work, for the linear and the scatterometry
    config at their shipped widths and epochs_per_call.  One warm-up launch
    (the engine captures its preparation there); then, the card idle, the
    host ms to prepare a launch's inputs (``epochs.prepare``, one replay)
    and to prepare and queue the launch (the engine's call), FUSED_HOST_REPS
    times each, beside the card's ms of the call by CUDA events and the
    host ms of the same preparation run eagerly (``capture=False``), which
    must give the replay's inputs bit for bit; one call under the sync
    debug mode "error"; then ``train.fit`` over FUSED_TRACE_LAUNCHES
    launches, timed, then traced (host syncs and runtime calls a launch,
    the card's busy share, the top device ops).  B3's launches counted
    from zero around each config's runs.  Returns them by config."""
    from dmip_tpu_torch import train
    from dmip_tpu_torch.ops import fused_dsm_train_epochs
    from dmip_tpu_torch.ops.dsm_train_kernel import make_fused_dsm_epoch_fn

    t0 = time.time()
    res, launches = {}, {}
    cuda = torch.device("cuda")
    for name, (cfg, model, batch_fn, fn, opt, p0, seed) in fused_engines(torch, lin_cfg, scat_cfg).items():
        epc = int(cfg["epochs_per_call"])
        eager = make_fused_dsm_epoch_fn(model, float(cfg["lr"]), batch_fn, epc, capture=False)
        s0 = opt.init(p0)
        fused_dsm_train_epochs.launches = 0
        fn(p0, s0, seed, 0)
        torch.cuda.synchronize()
        prep_ms, eager_ms, queue_ms, card_ms, same = [], [], [], [], []
        for r in range(FUSED_HOST_REPS):
            t = time.perf_counter()
            replayed = fn.prepare(seed, r * epc, cuda)
            prep_ms.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref = eager.prepare(seed, r * epc, cuda)
            eager_ms.append(1e3 * (time.perf_counter() - t))
            same.append(all(torch.equal(a, b) for a, b in zip(replayed, ref)))
            nb = replayed[0].shape[1]
            del replayed, ref
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t = time.perf_counter()
            fn(p0, s0, seed, r * epc)
            queue_ms.append(1e3 * (time.perf_counter() - t))
            end.record()
            torch.cuda.synchronize()
            card_ms.append(start.elapsed_time(end))
        check(all(same), f"train_fused_host: the replayed {name} preparation is not the eager one: {same}")
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(p0, s0, seed, 0)
        except RuntimeError as e:
            raise CheckFailed(f"train_fused_host: a host sync inside a {name} engine call: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(_finite(out[2].tolist()), f"train_fused_host: {name} losses {out[2].tolist()}")
        n = FUSED_TRACE_LAUNCHES * epc
        fit = lambda: train.fit(fn, p0, opt, seed, n, epochs_per_call=epc, log_every=0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit()
        fit_s = time.perf_counter() - t
        traced = host_trace(torch, fit, FUSED_TRACE_LAUNCHES)
        traced["syncs_per_launch"] = traced.pop("syncs_per_step")
        traced["runtime_calls_per_launch"] = traced.pop("runtime_calls_per_step")
        launches[name] = fused_dsm_train_epochs.launches
        res[name] = {"epochs_per_call": epc, "batches_per_epoch": nb,
                     "prepare_replay_host_ms": prep_ms, "prepare_eager_host_ms": eager_ms,
                     "replay_bit_for_bit_eager": all(same), "prepare_and_queue_host_ms": queue_ms,
                     "call_card_ms": card_ms, "captures": fn.graph.captures, "fit_seconds": fit_s,
                     "fit_launches": FUSED_TRACE_LAUNCHES, "traced_fit": traced}
        check(launches[name] == 2 + FUSED_HOST_REPS + 2 * FUSED_TRACE_LAUNCHES,
              f"train_fused_host: {name} B3 launches {launches[name]}")
        check(fn.graph.captures == 1, f"train_fused_host: the {name} engine captured {fn.graph.captures} times")
    phase("train_fused_host", t0, **res, launches=launches)
    for name, r in res.items():
        tr = r["traced_fit"]
        check(tr["syncs_per_launch"] <= FUSED_SYNCS_MAX,
              f"train_fused_host: {tr['syncs_per_launch']} host syncs a {name} launch in a traced fit")
        check(tr["card"]["share"] >= FUSED_BUSY_MIN,
              f"train_fused_host: the card busy {tr['card']['share']:.3f} of a traced {name} fit")
    return launches


def first_batches(batch_fn, n: int):
    """``batch_fn`` cut to the first n batches of its epoch."""
    def cut(g):
        xb, yb = batch_fn(g)
        return xb[:n], yb[:n]
    return cut


def graph_parity(torch, eager, graph, p0) -> dict:
    """A captured call's (params, state, losses) against the eager call's
    from the same start: bit for bit, else the losses' largest relative
    error and the leaves' against their update (``_leaf_rel``)."""
    from dmip_tpu_torch import pytree

    (pe, se, le), (pg, sg, lg) = eager, graph
    same = torch.equal(le, lg) and all(torch.equal(a, b) for a, b in zip(pytree.leaves((pe, se)),
                                                                         pytree.leaves((pg, sg))))
    return {"bit_for_bit": same, "loss_rel_err": float(((lg - le).abs() / le.abs()).max()),
            "leaf_rel_err_max": _leaf_rel(pg, pe, p0)}


def check_parity(res: dict, what: str) -> None:
    check(res["bit_for_bit"] or (res["loss_rel_err"] <= GRAPH_LOSS_REL_TOL
                                 and res["leaf_rel_err_max"] <= GRAPH_LEAF_REL_TOL),
          f"{what}: the captured step against the eager one: {res}")


def engine_ms(torch, make, p0, s0, n_steps: int, what: str) -> dict:
    """ms a step of one call of n_steps steps through ``make(capture)``'s
    run(params, state) -> (params, state, losses), eager and captured, each
    timed on its second call from p0 and s0 (the first, which captures,
    timed apart); the first calls' parity, checked."""
    out, res = {}, {}
    for capture, name in ((False, "eager"), (True, "captured")):
        run = make(capture)
        torch.cuda.synchronize()
        t = time.time()
        res[capture] = run(p0, s0)
        torch.cuda.synchronize()
        t1 = time.time()
        run(p0, s0)
        torch.cuda.synchronize()
        out.update({f"{name}_ms": 1e3 * (time.time() - t1) / n_steps, f"first_{name}_call_s": t1 - t})
    out["speedup"] = out["eager_ms"] / out["captured_ms"]
    out["parity"] = graph_parity(torch, res[False], res[True], p0)
    check_parity(out["parity"], what)
    return out


def host_trace(torch, run, n_steps: int) -> dict:
    """``run()`` (n_steps steps) traced inside one span: the CUDA runtime
    calls the host made in the span, a step (launches, graph launches,
    syncs), the card's busy share of the trace and its top operations."""
    from collections import Counter

    from dmip_tpu_torch.utils import profiling

    with profiling.trace() as prof:
        with torch.profiler.record_function("traced_span"):
            run()
    events = prof.events()
    span = next(e for e in events if e.name == "traced_span").time_range
    calls = Counter(e.name for e in events if e.name.startswith("cuda")
                    and span.start <= e.time_range.start <= span.end)
    return {"syncs_per_step": sum(calls[n] for n in SYNC_CALLS) / n_steps,
            "runtime_calls_per_step": {k: v / n_steps for k, v in calls.most_common()},
            "card": profiling.busy_share(prof), "top_ops": profiling.top_ops(prof, "device", 8)}


def replay_trace(torch, graph) -> dict:
    """One replay of a captured step alone: its nodes (the card's kernels
    and copies in the trace), the card's busy time, the ops that hold it,
    and the replay's ms by CUDA events (20 replays)."""
    from dmip_tpu_torch.utils import profiling

    sec, _ = profiling.timeit(graph.replay, reps=20)
    out = {"replay_ms": 1e3 * sec}
    with profiling.trace() as prof:
        graph.replay()
    try:
        card = profiling.busy_share(prof)
    except RuntimeError as e:  # the profiler saw no device activity: the CUDA events stand alone
        return dict(out, nodes="not traced", note=str(e))
    return dict(out, nodes=card["kernels"], busy_us=card["busy_us"], top_ops=profiling.top_ops(prof, "device", 8))


def train_captured(torch, lin_cfg, gt_dir) -> int:
    """The captured train step on ``config_linear.yml`` at full width: the
    driver for CAPTURED_EPOCHS epochs (two engine calls), its evaluation
    through B1 on LIN_CONDITIONS conditions, launches counted from zero
    around the run; epochs/s of the second call by the card's clock
    (``FitClock``).  Then one
    epoch from the driver's init and seeds, eager against captured (ms a
    step, parity); a trace of GRAPH_PROFILE_STEPS replayed steps and of as
    many eager ones (syncs and runtime calls a step) and of one replay
    alone (nodes, the ops inside).  Returns B1's launches."""
    from dmip_tpu_torch import data, train
    from dmip_tpu_torch.mains import main_diffusion_linear as mlin
    from dmip_tpu_torch.mains.eval_diffusion import linear_split
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler
    from dmip_tpu_torch.problems import LinearForwardProblem

    shipped = {k: lin_cfg.get(k) for k in ("loss_fn", "hidden_layers", "batch_size", "epochs_per_call",
                                           "train_backend", "dataset_size", "train_size")}
    check(shipped == {"loss_fn": "PINNLoss", "hidden_layers": [512] * 3, "batch_size": 1000, "epochs_per_call": 25,
                      "train_backend": None, "dataset_size": 100000, "train_size": 0.9},
          f"train_captured: config_linear.yml changed: {shipped}")
    cfg = dict(lin_cfg, n_epochs=CAPTURED_EPOCHS, n_samples_y=LIN_CONDITIONS, n_samples_x=N_SAMPLES,
               n_repeats=REPEATS, train_dir=os.path.join(gt_dir, "train_captured"),
               out_dir=os.path.join(gt_dir, "out_captured"))
    fused_em_sampler.launches = fused_dsm_train_epochs.launches = 0
    t0 = time.time()
    with FitClock(torch) as clock:
        _, m = mlin.run(cfg, device="cuda")
    torch.cuda.synchronize()
    n_b1, n_b3 = fused_em_sampler.launches, fused_dsm_train_epochs.launches
    run_s = time.time() - t0
    steps, losses, _ = train_log(cfg)
    rate = clock.rate()
    check(n_b1 == REPEATS * LIN_CONDITIONS and n_b3 == 0, f"train_captured: B1 {n_b1}, B3 {n_b3} launches")
    check(_finite([*m, *losses]) and len(losses) == CAPTURED_EPOCHS, f"train_captured: losses {losses}, metrics {m}")

    # one epoch from the driver's init and seeds, eager against captured
    t1 = time.time()
    prob = LinearForwardProblem()
    seed = int(cfg["random_state"])
    x_train, _, y_train, _ = linear_split(cfg, prob, "cuda")
    model, loss_cfg = train.get_model_from_args(cfg, {"xdim": prob.xdim, "ydim": prob.ydim})
    loss_fn = model.make_loss_fn(loss_cfg, initial_condition=prob.score_posterior)
    opt = train.build_optimizer(float(cfg["lr"]), cfg.get("grad_clip"))
    batch_fn = lambda g: data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(cfg["batch_size"]))
    p0 = model.init(torch.Generator().manual_seed(seed + 1), device="cuda")
    n_steps = x_train.shape[0] // int(cfg["batch_size"])
    engines = {}

    def make(capture):
        engines[capture] = train.make_epoch_fn(loss_fn, opt, batch_fn, capture=capture)
        return lambda p, s: engines[capture](p, s, seed + 2, 0)[:3]

    epoch = engine_ms(torch, make, p0, opt.init(p0), n_steps, "train_captured")
    short = {c: train.make_epoch_fn(loss_fn, opt, first_batches(batch_fn, GRAPH_PROFILE_STEPS), capture=c)
             for c in (False, True)}
    for fn in short.values():
        fn(p0, opt.init(p0), seed + 2, 0)  # the captured engine captures here
    traces = {("captured" if c else "eager"): host_trace(torch, lambda: fn(p0, opt.init(p0), seed + 2, 1),
                                                         GRAPH_PROFILE_STEPS) for c, fn in short.items()}
    replay = replay_trace(torch, short[True].graph.cuda_graphs[0])
    phase("train_captured", t0, epochs=CAPTURED_EPOCHS, epochs_per_call=cfg["epochs_per_call"],
          steps_per_epoch=n_steps, run_seconds=run_s, epochs_per_s_second_call=rate,
          ms_per_step_second_call=1e3 / (rate * n_steps), first_last_loss=[losses[0], losses[-1]],
          KL=m[0], NLPD=m[1], score_MSE=m[2], b1_launches=n_b1, b3_launches=n_b3,
          one_epoch=epoch, captures=engines[True].graph.captures, trace=traces, replay=replay,
          tolerance={"loss": GRAPH_LOSS_REL_TOL, "leaf": GRAPH_LEAF_REL_TOL}, compare_seconds=time.time() - t1)
    check(traces["captured"]["syncs_per_step"] == 0, f"train_captured: host syncs in a replayed step: {traces}")
    check(engines[True].graph.captures == 1, "train_captured: the engine captured more than once")
    return n_b1


def compare_engines(torch, loss_fn, opt, batch_fn, p0, seed: int, what: str) -> dict:
    """engine_ms for make_epoch_fn on the first GRAPH_COMPARE_STEPS batches."""
    from dmip_tpu_torch import train

    cut = first_batches(batch_fn, GRAPH_COMPARE_STEPS)
    n_steps = cut(train.epoch_generator(seed, 0, "cuda"))[0].shape[0]

    def make(capture):
        fn = train.make_epoch_fn(loss_fn, opt, cut, capture=capture)
        return lambda p, s: fn(p, s, seed, 0)[:3]

    return engine_ms(torch, make, p0, opt.init(p0), n_steps, what)


def stage_baselines(train_dir: str) -> None:
    """The committed baselines_{snf,dsm,inn} archives under ``train_dir``
    with the baseline drivers' names."""
    for name, archive in (("snf", "baselines_snf"), ("diffusion", "baselines_dsm"), ("INN", "baselines_inn")):
        shutil.copytree(os.path.join(REPO, "benchmarks/checkpoints", archive), os.path.join(train_dir, name))


def serve_baselines_scat(torch, gt_dir) -> int:
    """The committed SNF, DSM CDE and INN served at full width through the
    scatterometry baselines driver (``--eval_only``) on serve()'s
    conditions and GT, B1 launches counted from zero around it; then the DSM
    row again by the plain f32 E-M path, the SNF and INN on the card against
    the chip machine's CPU on fixed draws, and each model's time per 30k-
    sample posterior.  Returns the B1 launches."""
    from dmip_tpu_torch import checkpoints, flows
    from dmip_tpu_torch.mains import main_baselines_scatterometry as mbs
    from dmip_tpu_torch.mains.generate_scatterometry_ground_truth import test_conditions
    from dmip_tpu_torch.mains.main_baselines_linear import build_models
    from dmip_tpu_torch.ops import fused_em_sampler
    from dmip_tpu_torch.problems import scatterometry as scat

    cfg = dict(card_config("config_baselines_scatterometry.yml"),
               n_samples_y=SCAT_CONDITIONS, n_samples_x=N_SAMPLES, n_repeats=BASELINE_REPEATS,
               train_dir=os.path.join(gt_dir, "baselines_train"), out_dir=os.path.join(gt_dir, "baselines"))
    stage_baselines(cfg["train_dir"])
    fused_em_sampler.launches = 0
    t0 = time.time()
    m = mbs.run(cfg, gt_dir, eval_only=True, device="cuda")
    torch.cuda.synchronize()
    n_b1 = fused_em_sampler.launches
    csv = os.path.join(cfg["out_dir"], "results.csv")
    nll_mcmc = _column(csv, "NLL_mcmc")
    rows = {}
    for model, nll in (("SNF", "NLL_snf"), ("diffusion", "NLL_diffusion"), ("INN", "NLL_inn")):
        nlpd = sum(abs(a - b) for a, b in zip(_column(csv, nll), nll_mcmc)) / len(nll_mcmc)
        rows[model] = {"KL": m[f"KL_{model}"], "KL_reverse": m[f"KL_{model}_reverse"], "NLPD": nlpd,
                       "W2": m[f"W2_{model}"], "jax_100_conditions": BASELINE_JAX_ROWS[model]}
    t1 = time.time()
    plain = mbs.run(dict(cfg, eval_method="plain", out_dir=os.path.join(gt_dir, "baselines_plain")), gt_dir,
                    eval_only=True, device="cuda")
    torch.cuda.synchronize()
    plain_s = time.time() - t1
    check(fused_em_sampler.launches == n_b1, "the plain baselines path launched B1")

    # the flows on the card and on this machine's CPU, same z and MH draws
    forward_model, fp = scat.load_forward_model(device="cuda")
    y = test_conditions(cfg, forward_model, fp, "cuda")[0]
    gen = torch.Generator().manual_seed(11)
    n = BASELINE_DEVICE_ROWS
    z = torch.randn(n, 3, generator=gen)
    steps = int(cfg["metr_steps_per_block"])
    out, models = {}, {}
    for dev in ("cuda", "cpu"):
        f, _ = scat.load_forward_model(device=dev)
        energy = lambda x, ys, f=f: scat.get_log_posterior(x, f, fp["a"], fp["b"], ys, fp["lambd_bd"])
        snf, diffusion, inn = build_models(cfg, energy, 3, 23)
        params = [checkpoints.load_archived_params(os.path.join(cfg["train_dir"], name), device=dev)
                  for name in ("snf", "diffusion", "INN")]
        models[dev] = (snf, diffusion[0], inn, params)
        draws = [None if isinstance(layer, flows.DeterministicLayer) else
                 {"noise": torch.randn(steps, n, 3, generator=torch.Generator().manual_seed(100 + i)).to(dev),
                  "uniforms": torch.rand(steps, n, generator=torch.Generator().manual_seed(200 + i)).to(dev)}
                 for i, layer in enumerate(snf.layers)]
        with torch.no_grad():
            out[dev] = (snf.sample(params[0], y.to(dev), n, z=z.to(dev), draws=draws),
                        inn.sample(params[2], y.to(dev), n, z=z.to(dev)))
    snf_err = (out["cuda"][0].cpu() - out["cpu"][0]).abs().amax(dim=1)
    inn_err = (out["cuda"][1].cpu() - out["cpu"][1]).abs().amax(dim=1)
    split = float((snf_err > BASELINE_DEVICE_ATOL).float().mean())
    agreeing = torch.where(snf_err <= BASELINE_DEVICE_ATOL, snf_err, torch.zeros_like(snf_err))
    device_check = {"rows": n, "snf_max_abs_err_agreeing_rows": float(agreeing.max()), "snf_split_share": split,
                    "inn_max_abs_err": float(inn_err.max())}

    # ms per 30k-sample posterior of each model, one condition, CUDA events
    snf, diffusion, inn, params = models["cuda"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.no_grad():
        ms = {"SNF": cuda_ms(lambda: snf.sample(params[0], y, N_SAMPLES, gen), BASELINE_TIMING_REPS),
              "INN": cuda_ms(lambda: inn.sample(params[2], y, N_SAMPLES, gen), BASELINE_TIMING_REPS),
              "diffusion_b1_em200": cuda_ms(lambda: diffusion.sample(params[1], y, N_SAMPLES, EM_STEPS, generator=gen,
                                                                     device="cuda"), BASELINE_TIMING_REPS)}
    phase("serve_baselines_scat", t0, conditions=SCAT_CONDITIONS, repeats=BASELINE_REPEATS, samples=N_SAMPLES,
          launches=n_b1, **rows, diffusion_plain_KL=plain["KL_diffusion"], plain_seconds=plain_s,
          device_consistency=device_check, ms_per_posterior=ms)
    check(_finite([v for r in rows.values() for k, v in r.items() if k != "jax_100_conditions"])
          and _finite(plain.values()), f"non-finite baseline metrics {rows}")
    check(n_b1 == BASELINE_REPEATS * SCAT_CONDITIONS, f"serve_baselines_scat: {n_b1} B1 launches")
    check(abs(rows["diffusion"]["KL"] - plain["KL_diffusion"]) <= SCAT_KL_AGREE,
          f"baseline DSM KL kernel {rows['diffusion']['KL']} vs plain {plain['KL_diffusion']}")
    check(split <= SNF_DEVICE_SPLIT_SHARE and device_check["snf_max_abs_err_agreeing_rows"] <= BASELINE_DEVICE_ATOL,
          f"SNF card vs CPU: {device_check}")
    check(device_check["inn_max_abs_err"] <= BASELINE_DEVICE_ATOL, f"INN card vs CPU: {device_check}")
    return n_b1


def baseline_rates(cfg, clock: FitClock) -> dict:
    """Per model (the driver trains SNF, diffusion, INN in turn, each
    logging epochs from 0, each through one fit): its losses and its
    steady epochs/s by the card's clock."""
    steps, losses, _ = train_log(cfg)
    starts = [i for i, s in enumerate(steps) if s == 0] + [len(steps)]
    out = {}
    for j, name in enumerate(("SNF", "diffusion", "INN")):
        seg = slice(starts[j], starts[j + 1])
        out[name] = {"losses_first_last": [losses[seg][0], losses[seg][-1]], "all_finite": _finite(losses[seg]),
                     "epochs": len(steps[seg]), "epochs_per_s": clock.rate(j)}
    return out


def train_baselines(torch, gt_dir) -> None:
    """Both baseline drivers end to end on the card with their shipped
    configs (widths kept, epochs and evaluation cut): SNF, DSM CDE and INN
    through the autograd engine (no B3 launch), the evaluation's DSM rows
    through B1 (scatterometry on serve()'s GT).  Each model's epochs/s by
    the card's clock (``FitClock``), first call excluded; every loss
    finite; the checkpoints reload.
    Then the linear evaluation's ms per repeat."""
    from dmip_tpu_torch import data, flows, pytree, train
    from dmip_tpu_torch.mains import main_baselines_linear as mbl
    from dmip_tpu_torch.mains import main_baselines_scatterometry as mbs
    from dmip_tpu_torch.mains.eval_diffusion import linear_split, linear_test_conditions
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.utils import profiling

    runs = {"linear": ("config_baselines_linear.yml", lambda c: mbl.run(c, device="cuda"), (2, 2)),
            "scat": ("config_baselines_scatterometry.yml", lambda c: mbs.run(c, gt_dir, device="cuda"), (3, 23))}
    launches, res = {}, {}
    for problem, (cfg_name, fn, (xdim, ydim)) in runs.items():
        cfg = dict(card_config(cfg_name), **TRAIN_BASELINES[problem],
                   n_samples_x=N_SAMPLES, n_repeats=1, train_dir=os.path.join(gt_dir, "train_baselines_" + problem),
                   out_dir=os.path.join(gt_dir, "out_baselines_" + problem))
        fused_em_sampler.launches = fused_dsm_train_epochs.launches = 0
        t0 = time.time()
        with FitClock(torch) as clock:
            m = fn(cfg)
        torch.cuda.synchronize()
        launches[problem] = fused_em_sampler.launches
        rates = baseline_rates(cfg, clock)
        models = mbl.build_models(cfg, None, xdim, ydim)
        like = mbl.init_params(models, 0, "cuda")
        reloaded = mbl.load_params(cfg["train_dir"], like, "cuda")  # raises on another structure
        reload_ok = all(bool(torch.isfinite(t).all()) for t in pytree.leaves(reloaded))
        res[problem] = (cfg, reloaded)
        phase("train_baselines", t0, problem=problem, launches=launches[problem], models=rates, metrics=m)
        check(fused_dsm_train_epochs.launches == 0, f"train_baselines {problem}: the autograd engine launched B3")
        check(launches[problem] == cfg["n_samples_y"], f"train_baselines {problem}: {launches[problem]} B1 launches")
        check(all(r["all_finite"] for r in rates.values()) and _finite(m.values()),
              f"train_baselines {problem}: losses {rates}, metrics {m}")
        check(reload_ok, f"train_baselines {problem}: a checkpoint did not reload")

    # the linear driver's three models on its data and init, eager against captured
    t0 = time.time()
    cfg = res["linear"][0]
    prob = LinearForwardProblem()
    x_train, _, y_train, _ = linear_split(cfg, prob, "cuda")
    batch_fn = lambda g: data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(cfg["batch_size"]))
    models = mbl.build_models(cfg, lambda x, ys: prob.log_posterior(x, ys)[:, 0], 2, 2)
    snf, (diffusion, loss_cfg), inn = models
    seed = int(cfg.get("random_state", 7))
    inits = mbl.init_params(models, seed + 1, "cuda")
    losses = (flows.snf_loss_fn(snf), diffusion.make_loss_fn(loss_cfg), flows.inn_loss_fn(inn))
    lrs = (float(cfg["lr"]), float(cfg["lr"]), float(cfg["lr_INN"]))
    engines = {name: compare_engines(torch, loss_fn, train.build_optimizer(lr), batch_fn, p0, seed + 2,
                                     f"train_baselines_engines ({name})")
               for name, loss_fn, lr, p0 in zip(("SNF", "diffusion", "INN"), losses, lrs, inits)}
    phase("train_baselines_engines", t0, problem="linear", steps=GRAPH_COMPARE_STEPS, **engines)

    # the linear baselines evaluation's ms per repeat (one condition), after a warm-up call
    t0 = time.time()
    cfg, params = res["linear"]
    cfg = dict(cfg, n_repeats=LINEAR_EVAL_TIMING_REPEATS, out_dir=os.path.join(gt_dir, "out_baselines_linear_timed"))
    prob = LinearForwardProblem()
    models = mbl.build_models(cfg, lambda x, ys: prob.log_posterior(x, ys)[:, 0], 2, 2)
    ys = linear_test_conditions(cfg, prob, "cuda")[:1]
    gen = torch.Generator(device="cuda").manual_seed(13)
    sec, _ = profiling.timeit(lambda: mbl.evaluate_all(cfg, prob, models, params, ys, gen, cfg["out_dir"]), reps=2)
    phase("linear_baselines_eval_ms", t0, repeats=LINEAR_EVAL_TIMING_REPEATS,
          ms_per_repeat=1e3 * sec / LINEAR_EVAL_TIMING_REPEATS)


def dps_step_card_vs_cpu(torch) -> dict:
    """One PosteriorLoss step at full width (prior 4 -> 512^3 -> 3,
    likelihood 27 -> 512^3 -> 3, the 3 -> 256^3 -> 23 surrogate) on a batch
    of DPS_STEP_BATCH scatterometry rows, on the card and on the CPU from
    the same weights, x, y, t and eps (drawn on the CPU from a seeded
    generator): the loss, its two info values and every gradient leaf of
    both nets, each leaf's error against that leaf's norm; the likelihood
    target itself row by row against the row's norm, as a reading.  Twice:
    the committed dps_prior weights (trained: the regime of most of a run)
    and the seeded initial weights a run starts from.  Fails if TF32 is on
    for f32 products or an error is above its bound (DPS_STEP_*_REL_TOL)."""
    from dmip_tpu_torch import data, pytree, train
    from dmip_tpu_torch import losses as L
    from dmip_tpu_torch import nets as N
    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.problems import scatterometry as scat
    from dmip_tpu_torch.sde import sample_t

    t0 = time.time()
    tf32 = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    check(not tf32["allow_tf32"] and tf32["float32_matmul_precision"] == "highest", f"TF32 on for f32 products: {tf32}")
    cfg = card_config("config_scatterometry_dps.yml")
    gen = torch.Generator().manual_seed(21)
    cpu_model, fp = scat.load_forward_model(device="cpu")
    xs, ys = data.generate_dataset_scatterometry(cpu_model, fp["a"], fp["b"], size=DPS_STEP_BATCH, generator=gen)
    model, loss_cfg = train.get_model_from_args(cfg, fp)
    t = sample_t(model.sde, DPS_STEP_BATCH, gen)
    eps = torch.randn(xs.shape, generator=gen)
    weights = {"dps_prior": load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/dps_prior")),
               "init": model.init(torch.Generator().manual_seed(int(cfg["RANDOM_STATE"]) + 2))}
    base = model.sde.base
    out = {}
    for name, params in weights.items():
        res = {}
        for dev in ("cpu", "cuda"):
            forward_model, _ = scat.load_forward_model(device=dev)
            loss = model.make_loss_fn(loss_cfg, forward_model=forward_model, forward_params=fp)
            leaves = [a.to(dev).requires_grad_(True) for a in pytree.leaves(params)]
            tree = pytree.unflatten(params, leaves)
            x, y, tt, e = (a.to(dev) for a in (xs, ys, t, eps))
            val, info = loss(tree, None, x, y, t=tt, eps=e)
            grads = torch.autograd.grad(val, leaves)
            with torch.no_grad():
                target = L.likelihood_score_target(N.prior_mlp_apply, tree["prior"], base, forward_model,
                                                   base.diffuse(tt, x, e), y, tt, a=fp["a"], b=fp["b"])
            res[dev] = ([float(val.detach()), float(info["PriorLoss"].detach()), float(info["LikelihoodLoss"].detach())],
                        [g.detach().cpu() for g in grads], target.cpu())
        scalars = [abs(a - b) / abs(b) for a, b in zip(res["cuda"][0], res["cpu"][0])]
        leaf = [float((g - h).norm() / h.norm()) for g, h in zip(res["cuda"][1], res["cpu"][1])]
        tc, tr = res["cuda"][2], res["cpu"][2]
        row = ((tc - tr).norm(dim=1) / tr.norm(dim=1).clamp(min=1e-30)).double()
        out[name] = {"loss_cpu": res["cpu"][0][0], "info_cpu": res["cpu"][0][1:], "loss_info_rel_err": scalars,
                     "grad_leaf_rel_err_max": max(leaf), "grad_leaf_rel_err": leaf,
                     "target_abs_max": float(tr.abs().max()), "target_row_rel_err_max": float(row.max()),
                     "target_row_rel_err_p999": float(row.quantile(0.999))}
    phase("dps_step_card_vs_cpu", t0, batch=DPS_STEP_BATCH, tf32=tf32,
          tolerance={"loss_info": DPS_STEP_LOSS_REL_TOL, "grad_leaf": DPS_STEP_GRAD_REL_TOL}, **out)
    for name, r in out.items():
        check(max(r["loss_info_rel_err"]) <= DPS_STEP_LOSS_REL_TOL
              and r["grad_leaf_rel_err_max"] <= DPS_STEP_GRAD_REL_TOL, f"dps_step_card_vs_cpu ({name}): {r}")
    return out


def train_dps(torch, gt_dir) -> int:
    """``main_diffusion_scatterometry`` on ``config_scatterometry_dps.yml``
    (widths, batch, lr, lam and clip as shipped; epochs and evaluation cut,
    see DPS_TRAIN) against serve()'s GT: PosteriorLoss training on the
    autograd engine, the {'prior', 'likelihood'} checkpoint, the learned row
    by the plain scan and the analytic row through B5, launches counted from
    zero around the run; the learned row's ms per 30k-sample posterior;
    then one more call resumed from the checkpoint.  Returns B5's launches."""
    from dmip_tpu_torch import data, train
    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains import main_diffusion_scatterometry as mscat
    from dmip_tpu_torch.mains.generate_scatterometry_ground_truth import test_conditions
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler, fused_guided_em_sampler
    from dmip_tpu_torch.problems import scatterometry as scat

    cfg = dict(card_config("config_scatterometry_dps.yml"), **DPS_TRAIN, n_samples_y=SCAT_CONDITIONS,
               n_samples_x=N_SAMPLES, n_repeats=DPS_REPEATS, train_dir=os.path.join(gt_dir, "train_dps"),
               out_dir=os.path.join(gt_dir, "out_dps"))
    shipped = {k: cfg[k] for k in ("hidden_layers", "batch_size", "lr", "lam", "guidance_clip", "model")}
    check(shipped == {"hidden_layers": [512, 512, 512], "batch_size": 1000, "lr": 1e-4, "lam": 1.0,
                      "guidance_clip": 100.0, "model": "Posterior"}, f"train_dps: the shipped config changed: {shipped}")
    fused_guided_em_sampler.launches = fused_em_sampler.launches = fused_dsm_train_epochs.launches = 0
    t0 = time.time()
    with FitClock(torch) as clock:
        params, learned = mscat.run(cfg, gt_dir, device="cuda")
    torch.cuda.synchronize()
    n_b5 = fused_guided_em_sampler.launches
    other = fused_em_sampler.launches + fused_dsm_train_epochs.launches
    logs = {k: train_log(cfg, "Train/" + k)[1] for k in ("Loss", "PriorLoss", "LikelihoodLoss")}
    steps, _, _ = train_log(cfg)
    rate = clock.rate()
    ckpt = os.path.join(cfg["train_dir"], "checkpoint")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(ckpt, "params.treedef.json")) as f:
        treedef = json.load(f)
    csv = os.path.join(cfg["out_dir"] + "_analytic", "results.csv")
    nll_mcmc = _column(csv, "NLL_mcmc")
    cols = _results(csv)
    analytic = {"KL": cols["KL2"], "KL_reverse": cols["KL_reverse"],
                "NLPD": sum(abs(a - b) for a, b in zip(_column(csv, "NLL_diffusion"), nll_mcmc)) / len(nll_mcmc),
                "score_MSE": cols["MSE"], "W2": cols["W2"]}

    # the learned row's time per 30k-sample posterior (plain f32 scan, two nets)
    model, model_cfg = train.get_model_from_args(cfg, {"xdim": 3, "ydim": 23})
    forward_model, fp = scat.load_forward_model(device="cuda")
    y = test_conditions(cfg, forward_model, fp, "cuda")[0]
    gen = torch.Generator(device="cuda").manual_seed(14)
    with torch.no_grad():
        learned_ms = cuda_ms(lambda: model.sample(params, y, N_SAMPLES, EM_STEPS, generator=gen, device="cuda"),
                             DPS_TIMING_REPS)
    # one epoch of the driver's loss, data and init, eager against captured
    loss_fn = model.make_loss_fn(model_cfg, forward_model=forward_model, forward_params=fp)
    batch_fn = lambda g: data.scatterometry_epoch_batches(g, forward_model, fp["a"], fp["b"], fp["lambd_bd"],
                                                          int(cfg["batch_size"]))
    p0 = model.init(torch.Generator().manual_seed(int(cfg["RANDOM_STATE"]) + 2), device="cuda")
    engine = compare_engines(torch, loss_fn, train.build_optimizer(float(cfg["lr"]), cfg.get("grad_clip")), batch_fn,
                             p0, int(cfg["RANDOM_STATE"]) + 3, "train_dps")
    phase("train_dps", t0, epochs=cfg["n_epochs"], epochs_per_call=cfg["epochs_per_call"],
          first_last={k: [v[0], v[-1]] for k, v in logs.items()}, epochs_per_s=rate, engine=engine,
          ms_per_step=1e3 / (rate * 8), learned={"KL": learned[0], "NLPD": learned[1], "score_MSE": learned[2]},
          analytic=analytic, b5_launches=n_b5, other_kernel_launches=other, learned_ms_per_posterior=learned_ms,
          manifest_step=manifest["step"], treedef=treedef)
    check(_finite([*learned, *analytic.values(), rate, learned_ms] + [v for vs in logs.values() for v in vs]),
          f"train_dps: non-finite losses or metrics: {logs}, {learned}, {analytic}")
    check(logs["PriorLoss"][-1] < logs["PriorLoss"][0], f"train_dps: PriorLoss did not fall: {logs['PriorLoss']}")
    check(treedef.startswith("PyTreeDef({'likelihood': ((*, *), (*, *), (*, *), (*, *)), 'prior': ((*, *),")
          and manifest["step"] == cfg["n_epochs"] and manifest.get("has_opt_state"),
          f"train_dps: checkpoint {manifest}, {treedef}")
    check(n_b5 == SCAT_CONDITIONS * DPS_REPEATS and other == 0,
          f"train_dps: {n_b5} B5 launches, {other} launches of the other kernels")

    # the JAX driver's resume_training path: one more call from the checkpoint
    t0 = time.time()
    resumed = dict(cfg, **DPS_RESUME, resume_training=True, n_epochs=cfg["n_epochs"] + cfg["epochs_per_call"])
    fused_guided_em_sampler.launches = 0
    _, m = mscat.run(resumed, gt_dir, device="cuda")
    torch.cuda.synchronize()
    n_resumed = fused_guided_em_sampler.launches
    with open(os.path.join(ckpt, "manifest.json")) as f:
        step = json.load(f)["step"]
    steps, losses, _ = train_log(resumed)
    back = load_archived_params(ckpt, device="cuda")
    phase("train_dps_resume", t0, from_epoch=cfg["n_epochs"], to_epoch=step, logged_epochs=[steps[0], steps[-1]],
          last_losses=losses[-2:], KL=m[0], b5_launches=n_resumed)
    check(step == resumed["n_epochs"] and steps == list(range(resumed["n_epochs"])) and _finite([*losses, *m])
          and n_resumed == DPS_RESUME["n_samples_y"] * DPS_RESUME["n_repeats"]
          and sorted(back) == ["likelihood", "prior"], f"train_dps resume: step {step}, epochs {steps}, {m}")
    return n_b5 + n_resumed


def _grid_trials(cfg):
    """The grid's trials after the skip rules, grouped by ensemble
    signature in grid_search's order: [[(trial_cfg, full_cfg), ...], ...]."""
    from dmip_tpu_torch import gridsearch
    from dmip_tpu_torch.utils import product_dict

    visited, groups = [], {}
    for trial_cfg in product_dict(**cfg["params"]):
        full = {**cfg, **trial_cfg}
        if not gridsearch.should_skip(full, visited):
            groups.setdefault(gridsearch.ensemble_signature(trial_cfg), []).append((trial_cfg, full))
    return list(groups.values())


def grid_ensemble_card(torch) -> dict:
    """The trial-stacked ensemble engine on the first PINNLoss group of
    ``config_gridsearch_linear.yml`` (20 trials, shipped widths, batch and
    data), one engine call of GRID_ENSEMBLE_EPOCHS epochs: ms a step and
    epochs/s x trials; the first step's per-trial loss and every parameter
    leaf after the epoch of trials GRID_CHECK_TRIALS against the sequential
    autograd engine from the same init and seed, whose ms a step is printed
    beside.  TF32 must be off."""
    import dataclasses

    from dmip_tpu_torch import data, ensemble, pytree, train
    from dmip_tpu_torch.mains.eval_diffusion import linear_split
    from dmip_tpu_torch.problems import LinearForwardProblem

    t0 = time.time()
    check(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
          "grid_ensemble_card: TF32 on for f32 products")
    cfg = card_config("config_gridsearch_linear.yml")
    group = next(g for g in _grid_trials(cfg) if g[0][0]["loss_fn"] == "PINNLoss")
    full = group[0][1]
    shipped = {k: full[k] for k in ("hidden_layers", "batch_size", "dataset_size", "train_size", "lr",
                                    "pde_loss", "pde_metric", "ic_metric")}
    check(len(group) == GRID_ENSEMBLE_TRIALS and shipped == {
        "hidden_layers": [512, 512, 512], "batch_size": 1000, "dataset_size": 100000, "train_size": 0.9,
        "lr": 1e-4, "pde_loss": "FPE", "pde_metric": "L1", "ic_metric": "L1"},
        f"grid_ensemble_card: the shipped grid changed: {len(group)} trials, {shipped}")
    prob = LinearForwardProblem()
    seed = int(cfg["random_state"])
    x_train, _, y_train, _ = linear_split(cfg, prob, "cuda")

    def batch_fn(g):
        return data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(cfg["batch_size"]))

    model, loss_cfg = train.get_model_from_args(full, {"xdim": prob.xdim, "ydim": prob.ydim})
    lams = [float(fc["lam"]) for _, fc in group]
    lam2s = [float(fc["lam2"]) for _, fc in group]
    lams_t, lam2s_t = (torch.tensor(v, device="cuda") for v in (lams, lam2s))
    k = len(lams)
    opt = train.build_optimizer(float(cfg["lr"]), cfg.get("grad_clip"))
    kw = {"initial_condition": prob.score_posterior}
    init = lambda: model.init(torch.Generator().manual_seed(seed + 1), device="cuda")
    ens0 = ensemble.init_ensemble(model, torch.Generator().manual_seed(seed + 1), k, device="cuda")
    n_steps = int(cfg["dataset_size"] * cfg["train_size"]) // int(cfg["batch_size"]) * GRID_ENSEMBLE_EPOCHS

    # the first step's per-trial loss, the draws of epoch 0's first batch
    gen = train.epoch_generator(seed + 2, 0, "cuda")
    xb, yb = batch_fn(gen)
    t, eps, v = model.loss_draws(loss_cfg, gen, xb[0], yb[0])
    step = ensemble.make_ensemble_step(model, loss_cfg, opt, kw)
    _, _, first, _ = step(ens0, ensemble.init_opt_state(opt, ens0), lams_t, lam2s_t, xb[0], yb[0], t, eps, v)
    first = first.tolist()

    efn = ensemble.make_ensemble_epoch_fn(model, loss_cfg, opt, batch_fn, GRID_ENSEMBLE_EPOCHS, kw)
    torch.cuda.synchronize()
    t1 = time.time()
    ens, hist = ensemble.ensemble_fit(efn, ens0, opt, seed + 2, GRID_ENSEMBLE_EPOCHS, lams_t, lam2s_t,
                                      epochs_per_call=GRID_ENSEMBLE_EPOCHS, log_every=0)
    torch.cuda.synchronize()
    ens_s = time.time() - t1
    p0 = init()
    res, seq_s = {}, 0.0
    for i in GRID_CHECK_TRIALS:
        loss_fn = model.make_loss_fn(dataclasses.replace(loss_cfg, lam=lams[i], lam2=lam2s[i]), **kw)
        seq_first = float(loss_fn(p0, None, xb[0], yb[0], t=t, eps=eps, v=v)[0])
        fn = train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=GRID_ENSEMBLE_EPOCHS)
        torch.cuda.synchronize()
        t1 = time.time()
        p_seq, _, _ = train.fit(fn, init(), opt, seed + 2, GRID_ENSEMBLE_EPOCHS,
                                epochs_per_call=GRID_ENSEMBLE_EPOCHS, log_every=0)
        torch.cuda.synchronize()
        seq_s += time.time() - t1
        p_ens = ensemble.trial_params(ens, i)
        leaf = [float((a - b).norm() / (b - c).norm())
                for a, b, c in zip(pytree.leaves(p_ens), pytree.leaves(p_seq), pytree.leaves(p0))]
        res[i] = {"lam": lams[i], "lam2": lam2s[i], "first_loss": seq_first,
                  "first_loss_rel_err": abs(first[i] - seq_first) / abs(seq_first),
                  "leaf_rel_err_max": max(leaf), "leaf_rel_err": leaf, "epoch_loss": float(hist[-1][i]),
                  "p_seq": p_seq}
    cut = first_batches(batch_fn, GRAPH_COMPARE_STEPS)

    def make_ens(capture):
        efn_c = ensemble.make_ensemble_epoch_fn(model, loss_cfg, opt, cut, 1, kw, capture=capture)
        return lambda p, s: efn_c(p, s, seed + 2, 0, lams_t, lam2s_t)[:3]

    engines = {"ensemble": engine_ms(torch, make_ens, ens0, ensemble.init_opt_state(opt, ens0), GRAPH_COMPARE_STEPS,
                                     "grid_ensemble_card (ensemble)"),
               "sequential_trial_0": compare_engines(
                   torch, model.make_loss_fn(dataclasses.replace(loss_cfg, lam=lams[0], lam2=lam2s[0]), **kw), opt,
                   batch_fn, p0, seed + 2, "grid_ensemble_card (sequential)")}
    a, b = GRID_CHECK_TRIALS
    contrast = min(float((x - y).norm() / (y - c).norm()) for x, y, c in
                   zip(pytree.leaves(res[a].pop("p_seq")), pytree.leaves(res[b].pop("p_seq")), pytree.leaves(p0)))
    ens_ms, seq_ms = 1e3 * ens_s / n_steps, 1e3 * seq_s / (n_steps * len(GRID_CHECK_TRIALS))
    phase("grid_ensemble_card", t0, trials=k, steps=n_steps, loss=loss_cfg.name, pde_loss=loss_cfg.pde_loss,
          ms_per_step=ens_ms, epochs_per_s=GRID_ENSEMBLE_EPOCHS / ens_s,
          trial_epochs_per_s=k * GRID_ENSEMBLE_EPOCHS / ens_s, sequential_ms_per_step=seq_ms,
          step_ratio=ens_ms / seq_ms, per_trial_speedup=k * seq_ms / ens_ms,
          tolerance={"first_loss": GRID_STEP_LOSS_REL_TOL, "leaf": GRID_LEAF_REL_TOL},
          other_trial_leaf_contrast_min=contrast, trials_checked=res, engines=engines)
    check(_finite(hist.ravel().tolist() + first), f"grid_ensemble_card: non-finite losses {hist}")
    check(GRID_LEAF_REL_TOL < contrast / 10, f"grid_ensemble_card: trials {a} and {b} barely differ ({contrast})")
    for i, r in res.items():
        check(r["first_loss_rel_err"] <= GRID_STEP_LOSS_REL_TOL and r["leaf_rel_err_max"] <= GRID_LEAF_REL_TOL,
              f"grid_ensemble_card: trial {i} against the sequential engine: {r}")
    return {"ms_per_step": ens_ms, "sequential_ms_per_step": seq_ms}


def _tree_stamps(root: str, name: str) -> dict:
    """{path: (mtime_ns, bytes)} of every file called ``name`` under root."""
    out = {}
    for d, _, files in os.walk(root):
        if name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[path] = (os.stat(path).st_mtime_ns, f.read())
    return out


def grid_linear(torch, work) -> int:
    """The linear grid driver on ``config_gridsearch_linear_small.yml`` at
    full width (12 trials, 6 ensemble groups of 2; GRID_LINEAR_CUTS), each
    trial evaluated through B1; then the driver again with skip_existing,
    which must train and evaluate nothing and leave every results.csv and
    checkpoint as it was; then the walker, whose best KL must be the
    summary's least.  Returns B1's launches."""
    from dmip_tpu_torch import gridsearch
    from dmip_tpu_torch.mains import get_best_model, run_grid_search_linear
    from dmip_tpu_torch.ops import fused_dsm_train_epochs, fused_em_sampler

    cfg = dict(card_config("config_gridsearch_linear_small.yml"), **GRID_LINEAR_CUTS,
               src_dir=os.path.join(work, "grid_linear"))
    groups = _grid_trials(cfg)
    n_trials = sum(len(g) for g in groups)
    check(n_trials == 12 and sorted(len(g) for g in groups) == [2] * 6 and cfg["hidden_layers"] == [512] * 3
          and cfg["n_samples_x"] == N_SAMPLES, f"grid_linear: the shipped grid changed: {[len(g) for g in groups]}")
    fused_em_sampler.launches = fused_dsm_train_epochs.launches = 0
    t0 = time.time()
    out = run_grid_search_linear.run(cfg, device="cuda")
    torch.cuda.synchronize()
    n_b1 = fused_em_sampler.launches
    with open(os.path.join(cfg["src_dir"], "grid_summary.csv")) as f:
        summary = [ln.strip().split(",") for ln in f]
    kl_col = summary[0].index("kl")
    kls = [float(r[kl_col]) for r in summary[1:]]
    results = _tree_stamps(cfg["src_dir"], "results.csv")
    ckpts = _tree_stamps(cfg["src_dir"], "manifest.json")
    phase("grid_linear", t0, trials=n_trials, groups=[len(g) for g in groups], b1_launches=n_b1,
          results=[{k: r[k] for k in ("loss_fn", "pde_loss", "pde_metric", "lam", "kl", "nlpd", "fisher")}
                   for r in out["results"]], best_kl=out["best_kl"])
    check(n_b1 == n_trials * cfg["n_samples_y"] * cfg["eval_n_repeats"] and fused_dsm_train_epochs.launches == 0,
          f"grid_linear: {n_b1} B1 launches, {fused_dsm_train_epochs.launches} B3")
    check(len(summary) == n_trials + 1 and len(results) == n_trials and len(ckpts) == n_trials,
          f"grid_linear: {len(summary) - 1} summary rows, {len(results)} results, {len(ckpts)} checkpoints")
    check(_finite([v for r in out["results"] for v in (r["kl"], r["nlpd"], r["fisher"])]),
          f"grid_linear: non-finite metrics {out['results']}")

    t0 = time.time()
    fused_em_sampler.launches = 0
    again = run_grid_search_linear.run(dict(cfg, skip_existing=True), device="cuda")
    torch.cuda.synchronize()
    best = get_best_model.main(["--src_dir", cfg["src_dir"]])
    best_kl, entry = best["kl"]
    best_trial = gridsearch._read_results_csv(os.path.join(entry["path"], "results.csv"))["KL2"].mean()
    phase("grid_linear_resume", t0, b1_launches=fused_em_sampler.launches, best_kl=best_kl,
          best_trial={k: v for k, v in entry.items() if k != "path"}, summary_min_kl=min(kls))
    check(fused_em_sampler.launches == 0 and _tree_stamps(cfg["src_dir"], "results.csv") == results
          and _tree_stamps(cfg["src_dir"], "manifest.json") == ckpts
          and [r["kl"] for r in again["results"]] == [r["kl"] for r in out["results"]],
          "grid_linear: the skip_existing rerun trained or evaluated again")
    check(best_kl == min(kls) == float(best_trial), f"grid_linear: walker's best {best_kl} vs summary {min(kls)}")
    return n_b1


def grid_scat(torch, gt_dir) -> int:
    """The scatterometry grid driver on
    ``config_gridsearch_scatterometry_small.yml`` at full width (6 trials in
    one ensemble group; GRID_SCAT_CUTS) against serve()'s GT and
    conditions, each trial evaluated through B1; then the GT-against-GT
    floor of the same GT.  Returns B1's launches."""
    from dmip_tpu_torch import data, evaluate
    from dmip_tpu_torch.mains import run_grid_search_scatterometry
    from dmip_tpu_torch.ops import fused_em_sampler

    cfg = dict(card_config("config_gridsearch_scatterometry_small.yml"), **GRID_SCAT_CUTS,
               src_dir=os.path.join(gt_dir, "grid_scat"))
    groups = _grid_trials(cfg)
    check([len(g) for g in groups] == [6] and cfg["hidden_layers"] == [512] * 3 and cfg["RANDOM_STATE"] == 13
          and cfg["n_samples_x"] == N_SAMPLES, f"grid_scat: the shipped grid changed: {[len(g) for g in groups]}")
    fused_em_sampler.launches = 0
    t0 = time.time()
    out = run_grid_search_scatterometry.run(cfg, gt_dir, device="cuda")
    torch.cuda.synchronize()
    n_b1 = fused_em_sampler.launches
    t1 = time.time()
    floor = evaluate.gt_floor_scatterometry(data.cached_gt_loader(gt_dir, device="cuda"), SCAT_CONDITIONS,
                                            n_repeats=GRID_FLOOR_REPEATS)
    floor = {k: v.tolist() for k, v in floor.items()}
    phase("grid_scat", t0, trials=len(groups[0]), b1_launches=n_b1,
          results=[{k: r[k] for k in ("lam", "lam2", "kl", "nlpd", "fisher")} for r in out["results"]],
          gt_floor=floor, gt_floor_seconds=time.time() - t1)
    check(n_b1 == len(groups[0]) * SCAT_CONDITIONS * cfg["eval_n_repeats"], f"grid_scat: {n_b1} B1 launches")
    check(_finite([v for r in out["results"] for v in (r["kl"], r["nlpd"], r["fisher"])]
                  + [v for vs in floor.values() for v in vs]), f"grid_scat: non-finite numbers {out}, {floor}")
    return n_b1


def dist_train(torch, cfg, mesh, capture: bool = True, steps=DIST_STEPS) -> dict:
    """``steps`` steps of ``cfg``'s net through the autograd engine (``mesh``:
    a Mesh or None; ``capture`` as the engine's), on the first ``steps``
    batches of epoch 0 from the driver's seeds, called from the same init:
    the first call (which captures) and DIST_TIMING_REPS warm ones, each
    timed.  Returns the loss of step 1 alone (an engine of one step), the
    first call's (params, state, losses), the init, ms a step of the first
    call and of the warm ones (and their median), whether every warm call
    repeated the first bit for bit, the engine's
    StepGraph, ``call``, one more warm call (to trace), and the length of
    the meshed step's all-reduced buffer (gradient, loss, info)."""
    from dmip_tpu_torch import data, pytree, train
    from dmip_tpu_torch.mains.eval_diffusion import linear_split
    from dmip_tpu_torch.problems import LinearForwardProblem

    prob = LinearForwardProblem()
    seed = int(cfg["random_state"])
    x_train, _, y_train, _ = linear_split(cfg, prob, "cuda")
    model, loss_cfg = train.get_model_from_args(cfg, {"xdim": prob.xdim, "ydim": prob.ydim})
    loss_fn = model.make_loss_fn(loss_cfg, initial_condition=prob.score_posterior)
    opt = train.build_optimizer(float(cfg["lr"]), cfg.get("grad_clip"))
    batch_fn = lambda g: data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(cfg["batch_size"]))
    p0 = model.init(torch.Generator().manual_seed(seed + 1), device="cuda")
    s0 = opt.init(p0)

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(p0, s0, seed + 2, 0)
        torch.cuda.synchronize()
        return out, 1e3 * (time.time() - t0) / n

    first = float(timed(train.make_epoch_fn(loss_fn, opt, first_batches(batch_fn, 1), mesh=mesh,
                                            capture=capture), 1)[0][2][0])
    fn = train.make_epoch_fn(loss_fn, opt, first_batches(batch_fn, steps), mesh=mesh, capture=capture)
    (*run, infos), ms_first = timed(fn, steps)
    warm = [timed(fn, steps) for _ in range(DIST_TIMING_REPS)]
    same = all(torch.equal(a, b) for again, _ in warm for a, b in zip(pytree.leaves(run), pytree.leaves(again[:3])))
    return {"first": first, "run": run, "params": run[0], "p0": p0, "ms_first": ms_first,
            "ms_warm": sorted(ms for _, ms in warm)[len(warm) // 2], "ms_warm_all": [ms for _, ms in warm],
            "warm_repeats_first": same, "graph": fn.graph, "call": lambda: fn(p0, s0, seed + 2, 0),
            "flat_numel": sum(t.numel() for t in pytree.leaves(p0)) + 1 + len(infos)}


def dist_variants(torch, cfg, mesh) -> dict:
    """dist_train's three engines: the data-parallel one over ``mesh``
    captured ('meshed') and eager ('meshed_eager'), and the meshless one
    captured ('meshless')."""
    return {name: dist_train(torch, cfg, m, capture=c)
            for name, m, c in (("meshed", mesh, True), ("meshed_eager", mesh, False), ("meshless", None, True))}


def allreduce_ms(torch, mesh, n: int, reps: int = 20) -> float:
    """ms a call of the in-place all-reduce of an n-float buffer on the
    card, as the meshed step calls it between its replays: ``reps`` calls
    after 3 untimed ones, ended by a synchronize, by the host's clock."""
    buf = torch.zeros(n, device=mesh.device)
    for _ in range(3):
        mesh.all_reduce_(buf)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        mesh.all_reduce_(buf)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / reps


def variant_fields(v: dict) -> dict:
    """What a phase prints of dist_variants: ms a step (first call, the
    warm calls and their median), captures and graphs of each engine, and the pairs bit for bit
    (params, state, losses)."""
    from dmip_tpu_torch import pytree

    same = lambda a, b: all(x.equal(y) for x, y in zip(pytree.leaves(v[a]["run"]), pytree.leaves(v[b]["run"])))
    return {"ms_per_step": {k: {"first_call": r["ms_first"], "warm": r["ms_warm"], "warm_calls": r["ms_warm_all"]}
                            for k, r in v.items()},
            "captures": {k: r["graph"].captures for k, r in v.items()},
            "graphs": {k: len(r["graph"].cuda_graphs) for k, r in v.items()},
            "warm_repeats_first": {k: r["warm_repeats_first"] for k, r in v.items()},
            "bit_for_bit": {"meshed_vs_meshed_eager": same("meshed", "meshed_eager"),
                            "meshed_vs_meshless": same("meshed", "meshless")}}


def dist_eval(torch, mesh, n_conditions: int, out_dir: str):
    """evaluate_linear of ``linear_refined_winner`` on the first
    ``n_conditions`` linear test conditions, DIST_REPEATS repeats of
    N_SAMPLES, through B1, over ``mesh``; returns results.csv's rows."""
    from dmip_tpu_torch import evaluate
    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains.eval_diffusion import linear_test_conditions
    from dmip_tpu_torch.models import CDE
    from dmip_tpu_torch.problems import LinearForwardProblem

    prob = LinearForwardProblem()
    params = load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner"), device="cuda")
    ys = linear_test_conditions(card_config("config_linear.yml"), prob, "cuda")[:n_conditions]
    evaluate.evaluate_linear(CDE(2, 2), params, prob, ys, torch.Generator(device="cuda").manual_seed(0),
                             out_dir=out_dir, n_samples_x=N_SAMPLES, n_repeats=DIST_REPEATS, num_steps=EM_STEPS,
                             verbose=False, mesh=mesh)
    with open(os.path.join(out_dir, "results.csv")) as f:
        return [ln.strip().split(",") for ln in f][1:]


def _leaf_rel(p, ref, p0) -> float:
    """max over leaves of ||p - ref|| / ||ref - p0||."""
    from dmip_tpu_torch import pytree

    return max(float((a - b).norm() / (b - c).norm())
               for a, b, c in zip(pytree.leaves(p), pytree.leaves(ref), pytree.leaves(p0)))


def dist_world1(torch, work) -> dict:
    """A world of one rank over NCCL on a free local port, in this process:
    config_linear.yml's PINN net at full width for DIST_STEPS steps through
    the data-parallel engine captured (two graphs around the all-reduce)
    and eager, and the meshless engine captured, each a first call and a
    warm one; the captured meshed run held bit for bit against the other
    two; a warm meshed call traced (host syncs a step) and one run under
    the sync debug mode "error"; then evaluate_linear with the mesh on
    DIST_LIN_CONDITIONS[0] conditions x DIST_REPEATS repeats through B1.
    Returns what dist_two_ranks holds against: the first step's loss, the
    params, the init, the rows, and the meshless warm ms a step."""
    from dmip_tpu_torch.ops import fused_em_sampler
    from dmip_tpu_torch.parallel import get_mesh, init_multihost, local_address

    t0 = time.time()
    check(init_multihost(local_address(), 1, 0), "dist_world1: no process group")
    mesh = get_mesh()
    check((mesh.size, mesh.backend, str(mesh.device)) == (1, "nccl", "cuda:0"), f"dist_world1: mesh {mesh}")
    cfg = card_config("config_linear.yml")
    check(cfg["loss_fn"] == "PINNLoss" and cfg["hidden_layers"] == [512] * 3 and cfg["batch_size"] == 1000,
          f"dist_world1: config_linear.yml changed: {cfg['loss_fn']} {cfg['hidden_layers']} {cfg['batch_size']}")
    v = dist_variants(torch, cfg, mesh)
    fields = variant_fields(v)
    meshed = v["meshed"]
    fields["allreduce_ms"] = allreduce_ms(torch, mesh, meshed["flat_numel"])
    fields["allreduce_floats"] = meshed["flat_numel"]
    traced = host_trace(torch, meshed["call"], DIST_STEPS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        meshed["call"]()
    except RuntimeError as e:
        raise CheckFailed(f"dist_world1: a host sync inside a meshed engine call: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fields["meshed_captures_after_trace"] = meshed["graph"].captures
    t_train = time.time() - t0
    t1 = time.time()
    fused_em_sampler.launches = 0
    rows = dist_eval(torch, mesh, DIST_LIN_CONDITIONS[0], os.path.join(work, "dist_world1_lin"))
    torch.cuda.synchronize()
    n_b1 = fused_em_sampler.launches
    torch.distributed.destroy_process_group()
    phase("dist_world1", t0, backend=mesh.backend, steps=DIST_STEPS, first_loss=meshed["first"], **fields,
          trace=traced, train_seconds=t_train, eval_seconds=time.time() - t1, b1_launches=n_b1, rows=rows)
    bits = fields["bit_for_bit"]
    check(bits["meshed_vs_meshed_eager"], "dist_world1: the captured meshed step differs from the eager one")
    check(bits["meshed_vs_meshless"], "dist_world1: the mesh of one differs from the meshless engine")
    check(all(fields["warm_repeats_first"].values()), f"dist_world1: a warm call differs: {fields}")
    check(fields["captures"] == {"meshed": 1, "meshed_eager": 0, "meshless": 1}
          and fields["meshed_captures_after_trace"] == 1 and fields["graphs"] == {"meshed": 2, "meshed_eager": 0, "meshless": 1},
          f"dist_world1: captures {fields['captures']}, graphs {fields['graphs']}")
    check(traced["syncs_per_step"] == 0, f"dist_world1: host syncs in a traced meshed step: {traced}")
    check(n_b1 == DIST_LIN_CONDITIONS[0] * DIST_REPEATS, f"dist_world1: {n_b1} B1 launches")
    return {"first": meshed["first"], "params": meshed["params"], "p0": meshed["p0"], "rows": rows, "b1": n_b1,
            "meshless_warm_ms": v["meshless"]["ms_warm"]}


class CaptureCount:
    """While active, counts the captures of every ``train.StepGraph`` in
    this process (``n``; patches its capture, as FitClock patches
    ``train.fit``): the grid drivers build their engines out of reach."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        from dmip_tpu_torch import train

        capture = train.StepGraph._capture

        def counted(graph, *args):
            self.n += 1
            return capture(graph, *args)

        self._train, self._capture, train.StepGraph._capture = train, capture, counted
        return self

    def __exit__(self, *exc) -> None:
        self._train.StepGraph._capture = self._capture


def _two_rank_child(rank: int, address: str, work: str) -> None:
    """One of dist_two_ranks' two ranks (spawned): every sub-phase on the
    shared card, its seconds and launch counts saved for the parent."""
    import torch

    from dmip_tpu_torch import pytree
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.mains import run_grid_search_linear, run_grid_search_scatterometry
    from dmip_tpu_torch.ops import fused_em_sampler, fused_mh_scatterometry
    from dmip_tpu_torch.ops.mh_kernel import XDIM
    from dmip_tpu_torch.parallel import get_mesh, init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_multihost(address, 2, rank)
    mesh = get_mesh()
    out = {"backend": mesh.backend, "device": str(mesh.device), "seconds": {}, "b1": {}, "b2": {}, "captures": {}}

    def sub(name, fn):
        fused_em_sampler.launches = fused_mh_scatterometry.launches = 0
        mesh.barrier()
        t0 = time.time()
        with CaptureCount() as captures:
            res = fn()
        torch.cuda.synchronize()
        mesh.barrier()
        out["seconds"][name] = time.time() - t0
        out["b1"][name], out["b2"][name] = fused_em_sampler.launches, fused_mh_scatterometry.launches
        out["captures"][name] = captures.n
        return res

    v = sub("train", lambda: dist_variants(torch, card_config("config_linear.yml"), mesh))
    out["train"] = {"first": v["meshed"]["first"], "params": [t.cpu() for t in pytree.leaves(v["meshed"]["params"])],
                    **variant_fields(v), "allreduce_ms": allreduce_ms(torch, mesh, v["meshed"]["flat_numel"]),
                    "trace": host_trace(torch, v["meshed"]["call"], DIST_STEPS)}
    del v  # the engines' graphs and their pools
    sub("eval", lambda: dist_eval(torch, mesh, DIST_LIN_CONDITIONS[1], os.path.join(work, "dist_two_lin")))
    gt_cfg = dict(card_config("config_scatterometry.yml"), n_samples_y=DIST_GT_CONDITIONS, n_samples_x=N_SAMPLES,
                  n_repeats=REPEATS)
    sub("gt", lambda: gt.run(gt_cfg, os.path.join(work, "dist_two_gt"), device="cuda", devices=2))
    lin = dict(card_config("config_gridsearch_linear_small.yml"), **DIST_GRID_LINEAR_CUTS, ensemble_backend="pinned",
               src_dir=os.path.join(work, "dist_grid_pinned"))
    out["grid_pinned"] = sub("grid_pinned", lambda: run_grid_search_linear.run(lin, device="cuda"))["results"]
    sc = dict(card_config("config_gridsearch_scatterometry_small.yml"), **GRID_SCAT_CUTS, ensemble_backend="vmap",
              src_dir=os.path.join(work, "dist_grid_vmap"))
    out["grid_vmap"] = sub("grid_vmap", lambda: run_grid_search_scatterometry.run(sc, work, device="cuda"))["results"]

    # B1 and B2 timed on both ranks at once, each rank's launches on the
    # shared card: B1 at the linear net's serving shape, B2 at a rank's half
    # of a GT condition's chains
    from dmip_tpu_torch.checkpoints import load_archived_params
    from dmip_tpu_torch.mains.eval_diffusion import linear_test_conditions
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.problems import scatterometry as scat

    gen = torch.Generator(device="cuda").manual_seed(rank)
    lin_params = load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner"),
                                      device="cuda")
    y_lin = linear_test_conditions(card_config("config_linear.yml"), LinearForwardProblem(), "cuda")[0]
    x0 = torch.randn(N_SAMPLES, 2, generator=gen, device="cuda")
    forward_model, fparams = scat.load_forward_model(device="cuda")
    y_scat = gt.test_conditions(gt_cfg, forward_model, fparams, "cuda")[0]
    c0 = torch.rand(MH_CHAINS // 2, XDIM, generator=gen, device="cuda") * 2 - 1
    kw = dict(noise_std=float(gt_cfg["NOISE_STD_MCMC"]), a=fparams["a"], b=fparams["b"], lambd_bd=fparams["lambd_bd"])
    mesh.barrier()
    out["b1_ms"] = cuda_ms(lambda: fused_em_sampler(lin_params, x0, y_lin, EM_STEPS, seed=7), DIST_TIMING_REPS)
    mesh.barrier()
    out["b2_ms"] = cuda_ms(lambda: fused_mh_scatterometry(forward_model.weights, c0, y_scat, MH_STEPS, seed=7, **kw), 1)
    torch.save(out, os.path.join(work, f"dist_two_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _sequential_trials(torch, cfg) -> dict:
    """Every trial of a linear grid config trained one by one as the grid
    driver's sequential ``train_fn`` trains it: {trial dir: params}."""
    from dmip_tpu_torch import data, gridsearch, train
    from dmip_tpu_torch.mains.eval_diffusion import linear_split
    from dmip_tpu_torch.problems import LinearForwardProblem

    prob = LinearForwardProblem()
    seed, epc = int(cfg["random_state"]), int(cfg["epochs_per_call"])
    x_train, _, y_train, _ = linear_split(cfg, prob, "cuda")

    def batch_fn(g):
        return data.linear_epoch_batches(g, x_train, y_train, prob.noise_std, int(cfg["batch_size"]))

    out = {}
    for group in _grid_trials(cfg):
        for _, full in group:
            model, loss_cfg = train.get_model_from_args(full, {"xdim": prob.xdim, "ydim": prob.ydim})
            opt = train.build_optimizer(float(cfg["lr"]), cfg.get("grad_clip"))
            fn = train.make_epoch_fn(model.make_loss_fn(loss_cfg, initial_condition=prob.score_posterior), opt,
                                     batch_fn, epochs_per_call=epc)
            p, _, _ = train.fit(fn, model.init(torch.Generator().manual_seed(seed + 1), device="cuda"), opt,
                                seed + 2, num_epochs=int(cfg["n_epochs"]), epochs_per_call=epc, log_every=0)
            out[gridsearch.trial_dir(cfg["src_dir"], full, loss_cfg.name)] = (model, p)
    return out


def dist_two_ranks(torch, work, world1) -> dict:
    """Two spawned ranks sharing the card over gloo (``_two_rank_child``),
    each sub-phase's launches and StepGraph captures counted from zero on
    each rank: (a) the DIST_STEPS data-parallel steps (dist_variants: each
    rank's captured step bit for bit its eager one, ms a step of a first
    and a warm call beside the meshless engine's on the shared card), held
    against dist_world1 (the first step's loss, every leaf against its
    update, the ranks bit for bit); (b)
    evaluate_linear on DIST_LIN_CONDITIONS[1] conditions, whose rows must
    equal dist_world1's bit for bit; (c) the GT driver with --devices 2 on
    DIST_GT_CONDITIONS conditions at MH_CHAINS x MH_STEPS, against a
    meshless GT of the same conditions (run here) in distribution; (d)
    config_gridsearch_linear_small.yml through the grid driver, pinned, for
    two epochs of one call each, one capture a trial on each rank, each
    trial against its sequential run (here) bit for bit, and
    config_gridsearch_scatterometry_small.yml's group, vmap sharded, one
    capture a rank, each trial against grid_scat's meshless ensemble by
    DIST_LEAF_REL_TOL.  Every
    trial is evaluated through B1, split over the ranks.  Returns the B1
    launches by net shape and B2's, summed over the ranks, and the ranks'
    B1 and B2 times on the shared card."""
    import numpy as np
    import torch.multiprocessing as mp

    from dmip_tpu_torch import data, evaluate, gridsearch, pytree, train
    from dmip_tpu_torch.checkpoints import load_checkpoint
    from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
    from dmip_tpu_torch.parallel import local_address
    from dmip_tpu_torch.problems import scatterometry as scat

    t0 = time.time()
    mp.spawn(_two_rank_child, args=(local_address(), work), nprocs=2, join=True)
    spawn_s = time.time() - t0
    ranks = [torch.load(os.path.join(work, f"dist_two_rank{r}.pt"), weights_only=False) for r in range(2)]
    t1 = time.time()

    # (a) training against the world of one
    tr = [r["train"] for r in ranks]
    loss_rel = abs(tr[0]["first"] - world1["first"]) / abs(world1["first"])
    cpu = lambda tree: [t.cpu() for t in pytree.leaves(tree)]
    leaf = _leaf_rel(tr[0]["params"], cpu(world1["params"]), cpu(world1["p0"]))
    ranks_equal = all(torch.equal(a, b) for a, b in zip(tr[0]["params"], tr[1]["params"]))

    # (b) the rows of the conditions both runs evaluate
    with open(os.path.join(work, "dist_two_lin", "results.csv")) as f:
        rows = [ln.strip().split(",") for ln in f][1:]
    n1 = DIST_LIN_CONDITIONS[0]
    rows_equal = rows[:n1] == world1["rows"]

    # (c) the sharded GT against a meshless GT of the same conditions
    gt_cfg = dict(card_config("config_scatterometry.yml"), n_samples_y=DIST_GT_CONDITIONS, n_samples_x=N_SAMPLES,
                  n_repeats=REPEATS)
    ref_dir, sh_dir = os.path.join(work, "dist_ref_gt"), os.path.join(work, "dist_two_gt")
    gt.run(gt_cfg, ref_dir, device="cuda")
    ref, sh = data.gt_loader(ref_dir), data.gt_loader(sh_dir)
    half = REPEATS // 2
    shapes = [sh(i, j).shape for i in range(DIST_GT_CONDITIONS) for j in range(REPEATS)]
    gt_ok = (set(shapes) == {(N_SAMPLES, 3)} and len(shapes) == DIST_GT_CONDITIONS * REPEATS
             and all(np.isfinite(sh(i, j)).all() for i in range(DIST_GT_CONDITIONS) for j in range(REPEATS)))
    # each rank's first chains start where the meshless run's do, on another seed
    differ = all(not np.array_equal(sh(i, 0), sh(i, half)) and not np.array_equal(sh(i, 0), ref(i, 0))
                 and not np.array_equal(sh(i, half), ref(i, half)) for i in range(DIST_GT_CONDITIONS))
    floor = evaluate.gt_floor_scatterometry(ref, DIST_GT_CONDITIONS, REPEATS, device="cuda")["kl"].tolist()
    gt_kl = [evaluate.gt_floor_scatterometry(lambda i, j, r=r: ref(i, j) if j < half else sh(i, j - half + r * half),
                                             DIST_GT_CONDITIONS, REPEATS, device="cuda")["kl"].tolist()
             for r in range(2)]

    # (d) the pinned trials against their sequential runs, the sharded vmap
    # trials against grid_scat's meshless ensemble
    lin = dict(card_config("config_gridsearch_linear_small.yml"), **DIST_GRID_LINEAR_CUTS,
               src_dir=os.path.join(work, "dist_grid_pinned"))
    pinned_equal = []
    for tdir, (model, p) in _sequential_trials(torch, lin).items():
        back = load_checkpoint(os.path.join(tdir, "checkpoint"), p, device="cuda")["params"]
        pinned_equal.append(all(torch.equal(a, b) for a, b in zip(pytree.leaves(back), pytree.leaves(p))))
    sc = dict(card_config("config_gridsearch_scatterometry_small.yml"), **GRID_SCAT_CUTS,
              src_dir=os.path.join(work, "dist_grid_vmap"))
    forward_model, fparams = scat.load_forward_model(device="cuda")
    vmap_leaf = []
    for _, full in _grid_trials(sc)[0]:
        model, loss_cfg = train.get_model_from_args(full, fparams)
        p0 = model.init(torch.Generator().manual_seed(int(sc["RANDOM_STATE"]) + 2), device="cuda")
        tdir = gridsearch.trial_dir(sc["src_dir"], full, loss_cfg.name)
        mine = load_checkpoint(os.path.join(tdir, "checkpoint"), p0, device="cuda")["params"]
        ref_dir = os.path.join(work, "grid_scat", os.path.relpath(tdir, sc["src_dir"]), "checkpoint")
        vmap_leaf.append(_leaf_rel(mine, load_checkpoint(ref_dir, p0, device="cuda")["params"], p0))

    # the grids' captures on each rank: one a trial in every pinned wave, one
    # a group for the sharded vmap ensemble
    want_captures = {"grid_pinned": sum(-(-len(g) // 2) for g in _grid_trials(lin)),
                     "grid_vmap": len(_grid_trials(sc))}
    per_rank = [{k: r[k] for k in ("backend", "device", "seconds", "b1", "b2", "captures", "b1_ms", "b2_ms")}
                for r in ranks]
    train_fields = ("ms_per_step", "captures", "graphs", "warm_repeats_first", "bit_for_bit", "allreduce_ms", "trace")
    phase("dist_two_ranks", t0, spawn_and_run_seconds=spawn_s, check_seconds=time.time() - t1, ranks=per_rank,
          first_loss=tr[0]["first"], first_loss_rel_err=loss_rel, leaf_rel_err_max=leaf, ranks_bit_for_bit=ranks_equal,
          train_by_rank=[{k: t[k] for k in train_fields} for t in tr],
          meshless_one_rank_warm_ms_per_step=world1["meshless_warm_ms"], grid_captures_expected=want_captures,
          eval_rows_equal=rows_equal, gt_floor_kl=floor,
          gt_kl_by_rank=gt_kl, gt_chains_differ=differ, pinned_trials_bit_for_bit=sum(pinned_equal),
          pinned_trials=len(pinned_equal), vmap_leaf_rel_err=vmap_leaf,
          tolerance={"first_loss": DIST_LOSS_REL_TOL, "leaf": DIST_LEAF_REL_TOL, "gt_kl_factor": DIST_GT_KL_FACTOR})
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks), f"dist_two_ranks: {per_rank}")
    check(loss_rel <= DIST_LOSS_REL_TOL and leaf <= DIST_LEAF_REL_TOL and ranks_equal,
          f"dist_two_ranks: training against the world of one: loss {loss_rel}, leaf {leaf}, ranks {ranks_equal}")
    for r, t in enumerate(tr):
        check(t["bit_for_bit"]["meshed_vs_meshed_eager"] and all(t["warm_repeats_first"].values()),
              f"dist_two_ranks: rank {r}'s captured meshed step against its eager one: {t['bit_for_bit']}, "
              f"warm calls {t['warm_repeats_first']}")
        check(t["captures"] == {"meshed": 1, "meshed_eager": 0, "meshless": 1}
              and t["graphs"] == {"meshed": 2, "meshed_eager": 0, "meshless": 1},
              f"dist_two_ranks: rank {r}'s captures {t['captures']}, graphs {t['graphs']}")
    for name, want in want_captures.items():
        check([r["captures"][name] for r in ranks] == [want] * 2, f"dist_two_ranks: captures in {name} {per_rank}")
    check(rows_equal, f"dist_two_ranks: evaluation rows {rows[:n1]} against {world1['rows']}")
    check(gt_ok and differ, f"dist_two_ranks: sharded GT shapes {set(shapes)}, chains differ {differ}")
    check(all(k <= DIST_GT_KL_FACTOR * f for kls in gt_kl for k, f in zip(kls, floor)),
          f"dist_two_ranks: sharded GT KL {gt_kl} against the floor {floor}")
    check(all(pinned_equal) and len(pinned_equal) == 12, f"dist_two_ranks: pinned trials {pinned_equal}")
    check(len(vmap_leaf) == 6 and max(vmap_leaf) <= DIST_LEAF_REL_TOL, f"dist_two_ranks: vmap trials {vmap_leaf}")
    expect = {"eval": [4, 4], "grid_pinned": [12, 12], "grid_vmap": [24, 12]}
    for name, want in expect.items():
        check([r["b1"][name] for r in ranks] == want, f"dist_two_ranks: B1 launches in {name} {per_rank}")
    check([r["b2"]["gt"] for r in ranks] == [DIST_GT_CONDITIONS] * 2, f"dist_two_ranks: B2 launches {per_rank}")
    return {"linear": sum(r["b1"]["eval"] + r["b1"]["grid_pinned"] for r in ranks),
            "cde_500k": sum(r["b1"]["grid_vmap"] for r in ranks), "mh": sum(r["b2"]["gt"] for r in ranks),
            "b1_ms": [r["b1_ms"] for r in ranks], "b2_ms": [r["b2_ms"] for r in ranks]}


def b3_work(in_dim, out_dim, hidden, batch: int, n_steps: int):
    """(FLOPs, bytes) of one B3 launch: per step the forward, dW for every
    layer and da below the top layer; params, m and v read and written
    once, h0, eps and s1 read once."""
    dims = [in_dim, *hidden, out_dim]
    macs = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    n_par = macs + sum(dims[1:])
    flops = 2.0 * batch * n_steps * (2 * macs + macs - in_dim * dims[1])
    return flops, 2 * 3 * 4 * n_par + 4 * n_steps * batch * (in_dim + 2 * out_dim)


def b3_phase_split(torch, gen) -> dict:
    """B3's time per step split over its phases, at each problem's launch
    shape: one warm-up launch, then one launch whose block 0 reads the
    card's clock at the end of its own work in every phase and when the
    phase's grid sync returns.  Mean microseconds per step and phase (steps
    after the first): the phase (``us``) and block 0's share of it before
    the sync (``busy_us``); and the mean step."""
    from dmip_tpu_torch.ops.dsm_train_kernel import fused_dsm_train_epochs, phase_names

    out = {}
    for name, (in_dim, out_dim, nb, epochs) in (("linear", B3_LIN), ("scat", B3_SCAT)):
        params, mu, nu, h0, eps, s1 = b3_inputs(torch, in_dim, out_dim, nb, epochs, gen)
        names = phase_names(len(params), out_dim)
        steps = epochs * nb
        stamps = torch.zeros(1 + 2 * steps * len(names), dtype=torch.int64, device="cuda")
        bkw = dict(n_epochs=epochs, n_batches=nb, batch_real=B3_BATCH, lr=B3_LR, n_active=epochs)
        fused_dsm_train_epochs(params, mu, nu, 7, h0, eps, s1, **bkw)
        fused_dsm_train_epochs(params, mu, nu, 7, h0, eps, s1, stamps=stamps, **bkw)
        torch.cuda.synchronize()
        st = stamps[1:].reshape(steps, len(names), 2).double()
        ends = st[:, :, 1]
        starts = torch.cat([torch.cat([stamps[:1].double(), ends[:-1, -1]])[:, None], ends[:, :-1]], 1)
        us, busy = ((ends - starts) / 1e3)[1:], ((st[:, :, 0] - starts) / 1e3)[1:]
        out[name] = {"step_us": float(us.sum(1).mean()),
                     **{n: {"us": float(u), "busy_us": float(b)} for n, u, b in zip(names, us.mean(0), busy.mean(0))}}
        del params, mu, nu, h0, eps, s1
    return out


def stamp_split(torch, stamps, steps: int, names) -> dict:
    """Mean microseconds per step and phase from a kernel's (ns, cycles)
    stamp pairs (one before the first step, then one at the end of each
    phase), the mean step, and block 0's SM clock over the launch."""
    st, cyc = stamps[0::2].double(), stamps[1::2].double()
    ends = st[1:1 + steps * len(names)].reshape(steps, len(names))
    bounds = torch.cat([torch.cat([st[:1], ends[:-1, -1]])[:, None], ends], 1)
    us = (bounds[:, 1:] - bounds[:, :-1]) / 1e3
    last = steps * len(names)
    return {"step_us": float(us.sum(1).mean()), **{n: float(u) for n, u in zip(names, us.mean(0))},
            "sm_mhz": float((cyc[last] - cyc[0]) / (st[last] - st[0]) * 1e3)}


def b2_phase_split(torch, weights, y, x0, kw) -> dict:
    """B2's time per step split over its phases at the main path's shape:
    one launch whose block 0 reads the card's clock at the end of each
    phase, after one without, which it must match bit for bit."""
    from dmip_tpu_torch.ops.mh_kernel import PHASES, fused_mh_scatterometry

    stamps = torch.zeros(2 * (1 + len(PHASES) * MH_STEPS), dtype=torch.int64, device="cuda")
    plain = fused_mh_scatterometry(weights, x0, y, MH_STEPS, seed=7, **kw)
    stamped = fused_mh_scatterometry(weights, x0, y, MH_STEPS, seed=7, stamps=stamps, **kw)
    torch.cuda.synchronize()
    check(torch.equal(plain, stamped), "B2 with stamps differs from the run without")
    return stamp_split(torch, stamps, MH_STEPS, PHASES)


def em_phase_split(torch, fn, names, params, y, x0, label: str, f32: bool = False) -> dict:
    """An E-M sampler's time per step split over its phases at the main
    path's shape: one launch whose block 0 reads the card's clock at the
    end of each phase, after one without, which it must match bit for bit.
    In the f32 template (``f32``) the stamps also carry the cycles each of
    block 0's four warpgroups waited for weight tiles: ``ring_wait_us``,
    each phase's mean wait per step for each warpgroup at the launch's SM
    clock."""
    from dmip_tpu_torch.ops.em_kernel import stamp_entries

    pairs = 2 * (1 + len(names) * EM_STEPS)
    stamps = torch.zeros(stamp_entries(len(names), EM_STEPS, torch.float32 if f32 else torch.bfloat16),
                         dtype=torch.int64, device="cuda")
    plain = fn(params, x0, y, EM_STEPS, seed=7)
    stamped = fn(params, x0, y, EM_STEPS, seed=7, stamps=stamps)
    torch.cuda.synchronize()
    check(torch.equal(plain, stamped), f"{label} with stamps differs from the run without")
    split = stamp_split(torch, stamps[:pairs], EM_STEPS, names)
    if f32:
        cycles = stamps[pairs:].view(EM_STEPS, len(names), 4).double().mean(0)
        split["ring_wait_us"] = {n: [float(c) / split["sm_mhz"] for c in wg] for n, wg in zip(names, cycles)}
    return split


def b5_phase_split(torch, prior, weights, y, x0, fparams) -> dict:
    """B5's time per step split over its phases, in both guidance modes at
    the main path's shape: one launch whose block 0 reads the card's clock
    at the end of each phase, after one without, which it must match bit
    for bit.  Mean microseconds per step and phase over the 200 steps, the
    mean step, and block 0's SM clock over the launch (its cycle count over
    the card's clock)."""
    from dmip_tpu_torch.ops.dps_kernel import PHASES, fused_guided_em_sampler

    out = {}
    for guidance in ("dps", "pgdm"):
        gkw = dict(a=fparams["a"], b=fparams["b"], guidance_clip=100.0, num_steps=EM_STEPS, guidance=guidance, seed=7)
        stamps = torch.zeros(2 * (1 + len(PHASES) * EM_STEPS), dtype=torch.int64, device="cuda")
        plain = fused_guided_em_sampler(prior, weights, x0, y, **gkw)
        stamped = fused_guided_em_sampler(prior, weights, x0, y, stamps=stamps, **gkw)
        torch.cuda.synchronize()
        check(torch.equal(plain, stamped), f"B5 ({guidance}) with stamps differs from the run without")
        out[guidance] = stamp_split(torch, stamps, EM_STEPS, PHASES)
    return out


def f32_ring_bytes(params, k0: int) -> int:
    """The f32 template's weight bytes a block-step, all from L2: every
    ring tile of layer 0 (k0 input rows padded to one k-step, 8, or past 8
    to tiles of two, 16) and of the hidden layers (widths padded to 128),
    hi and lo, f32."""
    widths = [-(-w.shape[1] // 128) * 128 for w, _ in params[:-1]]
    k0 = 8 if k0 <= 8 else -(-k0 // 16) * 16
    entries = k0 * widths[0] + sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return 8 * entries


def em_f32_timing(torch, nets, cd_params, y0, f32_launches, gen) -> dict:
    """The f32 mode's times at the main path's shapes: B1 at both nets
    (per launch, and weighted by serve_f32's launches of each) and B4 at
    ``cdiffe_scat`` (its one shape there), each beside its f32 plain
    version, its bounds (the f32 peak, and three TF32 products a MAC: the
    least the card could take at f32 accuracy) and the share of the latter
    it reaches, its phase split with the ring's waits, and the weight bytes
    a block-step moves from L2 (with the rate that is over the step)."""
    from dmip_tpu_torch.ops.em_kernel import em_cdiffe_reference, em_sampler_reference
    from dmip_tpu_torch.ops.em_kernel import fused_em_sampler, fused_em_sampler_cdiffe
    from dmip_tpu_torch.ops.em_kernel import phase_names as em_phase_names

    f32 = dict(compute_dtype=torch.float32)
    b1_f32 = lambda *a, **kw: fused_em_sampler(*a, **kw, **f32)
    b4_f32 = lambda *a, **kw: fused_em_sampler_cdiffe(*a, **kw, **f32)
    t, flops, nbytes, split = {}, 0.0, 0.0, {}
    by_net = f32_launches["em_by_net"]
    for name, (params, y) in nets.items():
        x0 = torch.randn(N_SAMPLES, params[-1][0].shape[1], generator=gen, device="cuda")
        t[name] = (cuda_ms(lambda: b1_f32(params, x0, y, EM_STEPS, seed=7), 3),
                   cuda_ms(lambda: em_sampler_reference(params, x0, y, EM_STEPS, generator=gen, **f32), 2))
        f, b = em_work(params, N_SAMPLES, EM_STEPS, weight_size=4)
        flops, nbytes = flops + by_net[name] * f, nbytes + by_net[name] * b
        split[name] = em_phase_split(torch, b1_f32, em_phase_names(len(params) - 2), params, y, x0,
                                     f"B1 f32 ({name})", f32=True)
        split[name]["ring_bytes_per_block_step"] = f32_ring_bytes(params, params[-1][0].shape[1])
        split[name]["ring_gb_per_s_per_sm"] = split[name]["ring_bytes_per_block_step"] / split[name]["step_us"] / 1e3
    n = f32_launches["em"]
    b1_bound, b1_by = bound_ms(flops, nbytes, H100_TF32_FLOPS / 3)
    x0 = torch.randn(N_SAMPLES, 3, generator=gen, device="cuda")
    cd_work = cdiffe_work(cd_params, 3, N_SAMPLES, EM_STEPS, weight_size=4)
    b4_bound, b4_by = bound_ms(*cd_work, H100_TF32_FLOPS / 3)
    b4_ms = cuda_ms(lambda: b4_f32(cd_params, x0, y0, EM_STEPS, seed=7), 3)
    b4_split = em_phase_split(torch, b4_f32, em_phase_names(len(cd_params) - 2, cdiffe=True), cd_params, y0, x0,
                              "B4 f32", f32=True)
    b4_split["ring_bytes_per_block_step"] = f32_ring_bytes(cd_params, cd_params[0][0].shape[0] - 1)
    b4_split["ring_gb_per_s_per_sm"] = b4_split["ring_bytes_per_block_step"] / b4_split["step_us"] / 1e3
    b1_ms = sum(by_net[k] * t[k][0] for k in t) / n
    return {
        "b1_f32_ms_by_net": {k: v[0] for k, v in t.items()},
        "b1_f32_plain_ms_by_net": {k: v[1] for k, v in t.items()},
        "b1_f32_launches_by_net": by_net,
        "b1_f32_ms": b1_ms,
        "b1_f32_plain_ms": sum(by_net[k] * t[k][1] for k in t) / n,
        "b1_f32_bound_ms": bound_ms(flops, nbytes, H100_F32_FLOPS)[0] / n,
        "b1_f32_split_tf32_bound_ms": b1_bound / n, "b1_f32_bound_by": b1_by,
        "b1_f32_share_of_split_tf32_bound": b1_bound / n / b1_ms,
        "b1_f32_phase_us_by_net": split,
        "b4_f32_ms": b4_ms,
        "b4_f32_plain_ms": cuda_ms(lambda: em_cdiffe_reference(cd_params, x0, y0, EM_STEPS, generator=gen, **f32), 1),
        "b4_f32_bound_ms": bound_ms(*cd_work, H100_F32_FLOPS)[0],
        "b4_f32_split_tf32_bound_ms": b4_bound, "b4_f32_bound_by": b4_by,
        "b4_f32_share_of_split_tf32_bound": b4_bound / b4_ms,
        "b4_f32_phase_us": b4_split,
    }


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
    from dmip_tpu_torch.ops.em_kernel import phase_names as em_phase_names
    from dmip_tpu_torch.ops.mh_kernel import mh_chains_reference
    from dmip_tpu_torch.problems import LinearForwardProblem
    from dmip_tpu_torch.problems import scatterometry as scat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    reports = build.build_all()
    phase("build", t0, ptxas={k: ptxas_lines(v) for k, v in reports.items()})

    gen = torch.Generator(device="cuda").manual_seed(0)
    scat_cfg = card_config("config_scatterometry.yml")
    lin_cfg = card_config("config_linear.yml")
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
    # each net's f32 check on the bf16 check's x0 and noise, drawing its
    # moments on a generator of its own, so the later checks draw what they
    # drew before
    gen_f32 = torch.Generator(device="cuda").manual_seed(3)
    b1, b1_f32 = {}, {}
    for name, (params, y) in nets.items():
        t0 = time.time()
        b1[name], inputs = check_b1(torch, params, y, gen)
        phase("b1_vs_plain", t0, net=name, **b1[name])
        t0 = time.time()
        b1_f32[name], _ = check_b1(torch, params, y, gen_f32, torch.float32, inputs, b1[name]["f64_kernel_p999"])
        phase("b1_f32_vs_plain", t0, net=name, **b1_f32[name])
        del inputs
    b2 = {}
    # one process's GT launch, then a rank's of two (on a generator of its
    # own, so the later checks draw what they drew before)
    for n, g in ((MH_CHAINS, gen), (MH_CHAINS // 2, torch.Generator(device="cuda").manual_seed(2))):
        t0 = time.time()
        b2[n] = check_b2(torch, weights, y0, g, fparams, n)
        phase("b2_vs_plain", t0, chains=n, **b2[n])
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
    b4, b4_f32 = {}, {}
    for name, (params, y) in cdiffe_nets.items():
        # the random linear net's samples are heavy-tailed: same-noise checks only
        moments = name == "cdiffe_scat"
        t0 = time.time()
        b4[name], inputs = check_b4(torch, params, y, gen, moments=moments)
        phase("b4_vs_plain", t0, net=name, **b4[name])
        t0 = time.time()
        b4_f32[name], _ = check_b4(torch, params, y, gen_f32, moments, torch.float32, inputs,
                                   b4[name]["f64_kernel_p999"])
        phase("b4_f32_vs_plain", t0, net=name, **b4_f32[name])
        del inputs
    prior = load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/dps_prior"), device="cuda")["prior"]
    t0 = time.time()
    b5 = check_b5(torch, prior, weights, ys, gen)
    phase("b5_vs_plain", t0, samples=N_SAMPLES, **b5)

    with tempfile.TemporaryDirectory(prefix="dmip_gt_", dir=REPO) as work:
        launches, served = serve(torch, lin_cfg, scat_cfg, work)
        refined_launches = serve_refined(torch, served, work)
        serve_samplers(torch, lin_cfg, scat_cfg, served, work)
        profile_serve(torch, lin_cfg, work)
        t0 = time.time()
        seeds = seed_forms(torch, nets, cdiffe_nets["cdiffe_scat"][0], prior, weights, fparams, y0)
        phase("seed_forms", t0, bit_for_bit=seeds)
        engine = eval_engine(torch, lin_cfg, scat_cfg, work, seeds)
        launches.update(serve_cdiffe_dps(torch, work))
        f32_launches = serve_f32(torch, lin_cfg, scat_cfg, work)
        baseline_launches = serve_baselines_scat(torch, work)
        b3_launches = train(torch, lin_cfg, scat_cfg, work)
        for name, n in train_fused_host(torch, lin_cfg, scat_cfg).items():
            b3_launches[name] += n
        captured_b1 = train_captured(torch, lin_cfg, work)
        cdiffe_train = train_cdiffe(torch, work, gen)
        train_baselines(torch, work)
        dps_step_card_vs_cpu(torch)
        launches["guided"] += train_dps(torch, work)
        grid_ensemble_card(torch)
        grid_launches = {"linear": grid_linear(torch, work), "cde_500k": grid_scat(torch, work)}
        world1 = dist_world1(torch, work)
        dist = dist_two_ranks(torch, work, world1)

    # timings at the main path's shapes, after the counts were read; B1's
    # numbers are per launch, weighted by the launches of each net
    t0 = time.time()
    # the refined rows' proposals too (linear_pinn2 has the linear net's
    # shape), the served baselines' DSM rows (baselines_dsm has cde_500k's)
    # and the grid trials' evaluations (the linear grid's nets have the linear
    # net's shape, the scatterometry grid's cde_500k's)
    # and the multi-GPU phases' (the linear evaluations and pinned grid at the
    # linear net's shape, the sharded scatterometry grid at cde_500k's)
    # and train_captured's evaluation of its PINN net (the linear net's shape)
    dist_linear = world1["b1"] + dist["linear"]
    em_n = {"linear_refined_winner": launches["em_linear"] + refined_launches["linear"] + grid_launches["linear"]
            + dist_linear + captured_b1 + engine["linear_refined_winner"],
            "cde_500k": launches["em"] - launches["em_linear"] + refined_launches["cde_500k"] + baseline_launches
            + grid_launches["cde_500k"] + dist["cde_500k"] + engine["cde_500k"]}
    launches["em"] += (sum(refined_launches.values()) + baseline_launches + sum(grid_launches.values())
                       + dist_linear + dist["cde_500k"] + captured_b1 + engine["linear_refined_winner"]
                       + engine["cde_500k"])
    launches["mh"] += dist["mh"] + engine["mh"]
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
    b1_split = {}
    for name, (params, y) in nets.items():
        x0 = torch.randn(N_SAMPLES, params[-1][0].shape[1], generator=gen, device="cuda")
        b1_split[name] = em_phase_split(torch, fused_em_sampler, em_phase_names(len(params) - 2),
                                        params, y, x0, f"B1 ({name})")
    c0 = torch.rand(MH_CHAINS, 3, generator=gen, device="cuda") * 2 - 1
    mh_ms = cuda_ms(lambda: fused_mh_scatterometry(weights, c0, y0, MH_STEPS, seed=7, **kw), 3)
    mh_plain_ms = cuda_ms(lambda: mh_chains_reference(weights, c0, y0, MH_STEPS, generator=gen, **kw), 1)
    mh_bound, mh_by = bound_ms(*mh_work(weights, MH_CHAINS, MH_STEPS), H100_F32_FLOPS)
    # beside the f32 bound: B2's split-TF32 form, 3 TF32 products of every MAC
    mh_tf32_bound, _ = bound_ms(*mh_work(weights, MH_CHAINS, MH_STEPS), H100_TF32_FLOPS / 3)
    b2_split = b2_phase_split(torch, weights, y0, c0, kw)
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
    b3_split = b3_phase_split(torch, gen)
    # B4 at the serving shape (cdiffe_scat, the only shape the main path
    # launches); B5 in both guidance modes at the dps_prior shapes
    cd_params = cdiffe_nets["cdiffe_scat"][0]
    x0 = torch.randn(N_SAMPLES, 3, generator=gen, device="cuda")
    b4_ms = cuda_ms(lambda: fused_em_sampler_cdiffe(cd_params, x0, y0, EM_STEPS, seed=7), 5)
    b4_plain_ms = cuda_ms(lambda: em_cdiffe_reference(cd_params, x0, y0, EM_STEPS, generator=gen), 1)
    b4_bound, b4_by = bound_ms(*cdiffe_work(cd_params, 3, N_SAMPLES, EM_STEPS), H100_BF16_FLOPS)
    b4_split = em_phase_split(torch, fused_em_sampler_cdiffe, em_phase_names(len(cd_params) - 2, cdiffe=True),
                              cd_params, y0, x0, "B4")
    f32_t = em_f32_timing(torch, nets, cd_params, y0, f32_launches, gen)
    b5_t = {}
    for guidance in ("dps", "pgdm"):
        gkw = dict(a=fparams["a"], b=fparams["b"], guidance_clip=100.0, num_steps=EM_STEPS, guidance=guidance)
        b5_t[guidance] = (
            cuda_ms(lambda: fused_guided_em_sampler(prior, weights, x0, y0, seed=7, **gkw), 2),
            cuda_ms(lambda: guided_em_reference(prior, weights, x0, y0, generator=gen, **gkw), 1),
            *bound_ms(*guided_work(prior, weights, N_SAMPLES, EM_STEPS, guidance), H100_F32_FLOPS),
        )
    b5_split = b5_phase_split(torch, prior, weights, y0, x0, fparams)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    phase("timing", t0, em_ms_by_net={k: v[0] for k, v in em_t.items()},
          em_plain_ms_by_net={k: v[1] for k, v in em_t.items()}, em_launches_by_net=em_n,
          b1_phase_us_by_net=b1_split,
          mh_chains=MH_CHAINS, mh_ms=mh_ms, mh_plain_ms=mh_plain_ms, mh_bound_ms=mh_bound,
          mh_split_tf32_bound_ms=mh_tf32_bound, b2_phase_us=b2_split,
          b3_ms_by_net={k: v[0] for k, v in b3_t.items()}, b3_plain_ms_by_net={k: v[1] for k, v in b3_t.items()},
          b3_launches_by_net=b3_launches, b3_launches_cdiffe_train=cdiffe_train["dsm_train"],
          b3_phase_us_by_net=b3_split,
          b4_ms=b4_ms, b4_plain_ms=b4_plain_ms, b4_bound_ms=b4_bound, b4_phase_us=b4_split,
          b5_ms_by_guidance={k: v[0] for k, v in b5_t.items()},
          b5_plain_ms_by_guidance={k: v[1] for k, v in b5_t.items()},
          b5_bound_ms_by_guidance={k: v[2] for k, v in b5_t.items()}, b5_phase_us_by_guidance=b5_split,
          **f32_t,
          b1_ms_two_ranks_sharing=dist["b1_ms"], mh_ms_two_ranks_sharing_half_chains=dist["b2_ms"],
          sm_clock_power_temp=clocks)

    return [
        {"name": "fused_em_sampler", "route": "cuda", "source": "dmip_tpu_torch/csrc/em_kernel.cu",
         "replaces": "dmip_tpu/ops/em_kernel.py:421", "launches": launches["em"],
         "max_abs_err": max(r["max_abs_err"] for r in b1.values()), "ms": em_ms, "plain_ms": em_plain_ms,
         "bound_ms": em_bound, "bound_by": em_by, "library_ms": None},
        {"name": "fused_mh_scatterometry", "route": "cuda", "source": "dmip_tpu_torch/csrc/mh_kernel.cu",
         "replaces": "dmip_tpu/ops/mh_kernel.py:154", "launches": launches["mh"],
         "max_abs_err": max(r["max_abs_err"] for r in b2.values()), "ms": mh_ms, "plain_ms": mh_plain_ms,
         "bound_ms": mh_bound, "bound_by": mh_by, "library_ms": None},
        {"name": "fused_dsm_train_epochs", "route": "cuda", "source": "dmip_tpu_torch/csrc/dsm_train_kernel.cu",
         "replaces": "dmip_tpu/ops/dsm_train_kernel.py:283", "launches": n_b3,
         "max_abs_err": max(r["f32_params_max_abs"] for r in b3.values()), "ms": b3_ms, "plain_ms": b3_plain_ms,
         "bound_ms": b3_bound, "bound_by": b3_by, "library_ms": None},
        {"name": "fused_em_sampler_cdiffe", "route": "cuda", "source": "dmip_tpu_torch/csrc/em_kernel.cu",
         "replaces": "dmip_tpu/ops/em_kernel.py:319", "launches": launches["em_cdiffe"],
         "max_abs_err": max(r["max_abs_err"] for r in b4.values()), "ms": b4_ms, "plain_ms": b4_plain_ms,
         "bound_ms": b4_bound, "bound_by": b4_by, "library_ms": None},
        {"name": "fused_em_sampler[f32]", "route": "cuda", "source": "dmip_tpu_torch/csrc/em_kernel.cu",
         "replaces": "dmip_tpu/ops/em_kernel.py:421", "launches": f32_launches["em"],
         "max_abs_err": max(r["max_abs_err"] for r in b1_f32.values()), "ms": f32_t["b1_f32_ms"],
         "plain_ms": f32_t["b1_f32_plain_ms"], "bound_ms": f32_t["b1_f32_split_tf32_bound_ms"],
         "bound_by": f32_t["b1_f32_bound_by"], "library_ms": None},
        {"name": "fused_em_sampler_cdiffe[f32]", "route": "cuda", "source": "dmip_tpu_torch/csrc/em_kernel.cu",
         "replaces": "dmip_tpu/ops/em_kernel.py:319", "launches": f32_launches["em_cdiffe"],
         "max_abs_err": max(r["max_abs_err"] for r in b4_f32.values()), "ms": f32_t["b4_f32_ms"],
         "plain_ms": f32_t["b4_f32_plain_ms"], "bound_ms": f32_t["b4_f32_split_tf32_bound_ms"],
         "bound_by": f32_t["b4_f32_bound_by"], "library_ms": None},
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
