"""The CUDA kernels on a card, each against its plain PyTorch version.

Imports neither JAX nor dmip_tpu, so it runs on a GPU host that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
On a host without a card every test skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from dmip_tpu_torch.nets import mlp_init
from dmip_tpu_torch.ops.dsm_train_kernel import dsm_train_epochs_reference, fused_dsm_train_epochs
from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler, guided_em_reference
from dmip_tpu_torch.ops.em_kernel import (em_cdiffe_reference, em_sampler_reference, fused_em_sampler,
                                          fused_em_sampler_cdiffe)
from dmip_tpu_torch.ops.mh_kernel import fused_mh_scatterometry, mh_chains_reference
from dmip_tpu_torch.problems import scatterometry as scat

pytestmark = pytest.mark.cuda

KW = dict(noise_std=0.5, a=0.2, b=0.01, lambd_bd=1000.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_em_kernel_matches_plain(cuda):
    """bf16 kernel vs its plain version, same x0 and noise; hidden widths
    not multiples of 32 and a ragged last block.  Mean abs error 2e-3 and
    99.9th percentile 5e-2, as chip_smoke.py holds the full-width net."""
    tp = mlp_init(27, 3, (96, 80, 64), generator=torch.Generator().manual_seed(5), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x0 = torch.randn(1000, 3, generator=gen, device=cuda)
    y = torch.randn(23, generator=gen, device=cuda)
    noise = torch.randn(50, 1000, 3, generator=gen, device=cuda)
    before = fused_em_sampler.launches
    out = fused_em_sampler(tp, x0, y, 50, noise=noise)
    ref = em_sampler_reference(tp, x0, y, 50, noise=noise)
    torch.cuda.synchronize()
    assert fused_em_sampler.launches == before + 1
    err = (out - ref).abs().amax(dim=1)
    assert float(err.mean()) < 2e-3 and float(torch.quantile(err, 0.999)) < 5e-2


def test_em_kernel_deterministic_and_rejects_what_it_does_not_take(cuda):
    """noise_scale=0 gives the plain trajectory (rel 1e-2: bf16 rounding
    edges only); same seed, same samples; f32 weights and wrong shapes raise."""
    tp = mlp_init(5, 2, (64, 64), generator=torch.Generator().manual_seed(1), device=cuda)
    x0 = torch.randn(300, 2, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    y = torch.tensor([0.8, -0.3], device=cuda)
    out = fused_em_sampler(tp, x0, y, 40, noise_scale=0.0)
    ref = em_sampler_reference(tp, x0, y, 40, noise_scale=0.0)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-2
    torch.testing.assert_close(fused_em_sampler(tp, x0, y, 40, seed=3), fused_em_sampler(tp, x0, y, 40, seed=3),
                               rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        fused_em_sampler(tp, x0, y, 5, compute_dtype=torch.float32)
    with pytest.raises(ValueError):
        fused_em_sampler(tp, x0, y, 5, noise=torch.zeros(4, 300, 2, device=cuda))
    with pytest.raises(ValueError):
        fused_em_sampler(tp, x0, None, 5)


def test_mh_kernel_matches_plain(cuda):
    """Same randomness, 4096 chains x 200 steps: at most 1% of chains end
    elsewhere (an f32 sum-order flip of an accept on its threshold); the
    rest agree exactly.  Bad shapes raise."""
    weights = scat.load_surrogate_weights(device=cuda)
    fwd = lambda x: scat.surrogate_apply(weights, x)
    y = scat.noisy_forward(fwd, torch.tensor([[0.3, -0.5, 0.1]], device=cuda), 0.2, 0.01,
                           torch.Generator(device=cuda).manual_seed(0))[0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, steps = 4096, 200
    x0 = torch.rand(n, 3, generator=gen, device=cuda) * 2 - 1
    z = torch.randn(steps, n, 3, generator=gen, device=cuda)
    u = torch.rand(steps, n, generator=gen, device=cuda)
    before = fused_mh_scatterometry.launches
    out = fused_mh_scatterometry(weights, x0, y, steps, noise=z, uniforms=u, **KW)
    ref = mh_chains_reference(weights, x0, y, steps, noise=z, uniforms=u, **KW)
    torch.cuda.synchronize()
    assert fused_mh_scatterometry.launches == before + 1
    assert float(((out - ref).abs().amax(1) > 1e-4).float().mean()) <= 0.01
    with pytest.raises(ValueError):
        fused_mh_scatterometry(weights, x0[:, :2].contiguous(), y, 5, **KW)
    with pytest.raises(ValueError):
        fused_mh_scatterometry(weights, x0, y, 5, noise=z[:5], **KW)
    assert np.isfinite(out.cpu().numpy()).all()


@pytest.mark.parametrize("dtype,param_tol,moment_rel,loss_rel", [
    # f32: the same arithmetic in another f32 sum order
    (torch.float32, 1e-5, 1e-4, 1e-5),
    # bf16: identical bf16 operands; a sum-order difference can move a tanh
    # output across a bf16 rounding edge, which Adam turns into at most an
    # lr-sized step
    (torch.bfloat16, 2e-3, 1e-2, 1e-3),
])
def test_dsm_train_kernel_matches_plain(cuda, dtype, param_tol, moment_rel, loss_rel):
    """2 epochs x 3 batches of 200 rows (not a multiple of the 64-row tile)
    on a 7 -> 96 -> 80 -> 3 net, the second epoch masked; params, moments,
    count and the active epoch's loss against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = mlp_init(7, 3, (96, 80), generator=torch.Generator().manual_seed(3), device=cuda)
    mu = tuple((1e-3 * torch.randn(w.shape, generator=gen, device=cuda),
                1e-3 * torch.randn(b.shape, generator=gen, device=cuda)) for w, b in params)
    nu = tuple((m ** 2, n ** 2) for m, n in mu)
    rows = 2 * 3 * 200
    h0 = torch.randn(rows, 7, generator=gen, device=cuda)
    eps = torch.randn(rows, 3, generator=gen, device=cuda)
    s1 = torch.rand(rows, 3, generator=gen, device=cuda)
    kw = dict(n_epochs=2, n_batches=3, batch_real=200, lr=1e-3, n_active=1, compute_dtype=dtype)
    before = fused_dsm_train_epochs.launches
    out = fused_dsm_train_epochs(params, mu, nu, 4, h0, eps, s1, **kw)
    ref = dsm_train_epochs_reference(params, mu, nu, 4, h0, eps, s1, **kw)
    torch.cuda.synchronize()
    assert fused_dsm_train_epochs.launches == before + 1
    assert int(out[3]) == int(ref[3]) == 7
    pairs = lambda j: [(x, y) for a, b in zip(out[j], ref[j]) for x, y in zip(a, b)]
    assert max(float((x - y).abs().max()) for x, y in pairs(0)) <= param_tol
    for j in (1, 2):
        assert max(float((x - y).abs().max() / y.abs().max()) for x, y in pairs(j)) <= moment_rel
    assert float((out[4][0] - ref[4][0]).abs() / ref[4][0].abs()) <= loss_rel
    with pytest.raises(ValueError):
        fused_dsm_train_epochs(params, mu, nu, 4, h0[:-1], eps, s1, **kw)
    with pytest.raises(ValueError):
        fused_dsm_train_epochs(params, mu, nu, 4, h0.double(), eps, s1, **kw)


def test_em_cdiffe_kernel_matches_plain(cuda):
    """B4 (bf16) vs its plain version on a joint 27 -> 96 -> 80 -> 64 -> 26
    net (widths not multiples of 32), 1000 rows (a ragged last block): the
    same x0 and (steps, N, 26) noise, and the noise-off trajectory.  Mean abs
    error 2e-3 and 99.9th percentile 5e-2, B1's tolerances (the same bf16
    rounding rule).  f32 weights and bad shapes raise."""
    tp = mlp_init(27, 26, (96, 80, 64), generator=torch.Generator().manual_seed(5), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x0 = torch.randn(1000, 3, generator=gen, device=cuda)
    y = 0.3 * torch.randn(23, generator=gen, device=cuda)
    noise = torch.randn(50, 1000, 26, generator=gen, device=cuda)
    before = fused_em_sampler_cdiffe.launches
    for kw in (dict(noise=noise), dict(noise_scale=0.0)):
        out = fused_em_sampler_cdiffe(tp, x0, y, 50, **kw)
        ref = em_cdiffe_reference(tp, x0, y, 50, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().amax(dim=1)
        assert float(err.mean()) < 2e-3 and float(torch.quantile(err, 0.999)) < 5e-2
    assert fused_em_sampler_cdiffe.launches == before + 2
    with pytest.raises(NotImplementedError):
        fused_em_sampler_cdiffe(tp, x0, y, 5, compute_dtype=torch.float32)
    with pytest.raises(ValueError):
        fused_em_sampler_cdiffe(tp, x0, y, 5, noise=noise[:5, :, :3].contiguous())
    with pytest.raises(ValueError):
        wide = mlp_init(40, 39, (64,), generator=torch.Generator().manual_seed(1), device=cuda)
        fused_em_sampler_cdiffe(wide, x0, torch.zeros(36, device=cuda), 5)


@pytest.mark.parametrize("guidance,clip", [("dps", 10.0), ("dps", None), ("pgdm", 100.0)])
def test_guided_kernel_matches_plain(cuda, guidance, clip):
    """B5 (f32) vs its plain version: a random 4 -> 96 -> 80 -> 3 prior
    (padded to 128 wide) and the scatterometry surrogate, 2000 rows (ragged),
    the last 20 steps of a 200-step grid (T = 0.1), same x0 and noise.  The
    versions differ in f32 sum order, and where a ReLU pre-activation sits at
    0 one may flip its mask: at most 0.5% of rows further apart than 1e-3,
    the median row within 1e-5.  Bad nets and shapes raise."""
    prior = mlp_init(4, 3, (96, 80), generator=torch.Generator().manual_seed(2), device=cuda)
    weights = scat.load_surrogate_weights(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    y = scat.noisy_forward(lambda x: scat.surrogate_apply(weights, x), torch.tensor([[0.3, -0.5, 0.1]], device=cuda),
                           0.2, 0.01, gen)[0]
    x0 = torch.rand(2000, 3, generator=gen, device=cuda) * 2 - 1
    noise = torch.randn(20, 2000, 3, generator=gen, device=cuda)
    kw = dict(a=0.2, b=0.01, guidance_clip=clip, num_steps=20, T=0.1, noise=noise, guidance=guidance)
    before = fused_guided_em_sampler.launches
    out = fused_guided_em_sampler(prior, weights, x0, y, **kw)
    ref = guided_em_reference(prior, weights, x0, y, **kw)
    torch.cuda.synchronize()
    assert fused_guided_em_sampler.launches == before + 1
    assert bool(torch.isfinite(out).all())
    err = (out - ref).abs().amax(dim=1)
    assert float(err.median()) < 1e-5 and float((err > 1e-3).float().mean()) <= 5e-3
    with pytest.raises(ValueError):
        fused_guided_em_sampler(prior, weights, x0, y, a=0.2, b=0.01, noise=noise, guidance=guidance)
    with pytest.raises(ValueError):
        wide = mlp_init(4, 3, (600,), generator=torch.Generator().manual_seed(3), device=cuda)
        fused_guided_em_sampler(wide, weights, x0, y, a=0.2, b=0.01, num_steps=2, guidance=guidance)


def test_guided_kernel_step_window(cuda):
    """B5 run in windows of the grid: steps [0, 7) then [7, 12) equal [0, 12)
    bit for bit (Philox keyed by the step's index on the grid), one step at
    s = T agrees with the plain version, and a bad window raises."""
    prior = mlp_init(4, 3, (64, 64), generator=torch.Generator().manual_seed(2), device=cuda)
    weights = scat.load_surrogate_weights(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x0 = torch.randn(300, 3, generator=gen, device=cuda)
    y = scat.surrogate_apply(weights, torch.tensor([[0.3, -0.5, 0.1]], device=cuda))[0]
    kw = dict(a=0.2, b=0.01, guidance_clip=10.0, num_steps=200, seed=9)
    whole = fused_guided_em_sampler(prior, weights, x0, y, stop_step=12, **kw)
    part = fused_guided_em_sampler(prior, weights, x0, y, stop_step=7, **kw)
    part = fused_guided_em_sampler(prior, weights, part, y, start_step=7, stop_step=12, **kw)
    assert torch.equal(whole, part)
    noise = torch.randn(1, 300, 3, generator=gen, device=cuda)
    one = dict(kw, stop_step=1, noise=noise)
    out = fused_guided_em_sampler(prior, weights, x0, y, **one)
    ref = guided_em_reference(prior, weights, x0, y, **{k: v for k, v in one.items() if k != "seed"})
    rel = (out - ref).abs().amax(dim=1) / (ref - x0).abs().amax(dim=1)
    assert float(rel.median()) < 1e-5
    with pytest.raises(ValueError, match="start_step"):
        fused_guided_em_sampler(prior, weights, x0, y, start_step=5, stop_step=5, **kw)
