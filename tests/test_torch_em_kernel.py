"""Fused E-M sampler (kernel B1): the port's plain version against the JAX
Pallas kernel (interpret mode) and the JAX XLA sampler, and the kernel's
weight layout.  The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmip_tpu.nets import mlp_init, score_mlp_apply
from dmip_tpu.ops.em_kernel import fused_em_sampler as jax_fused_em_sampler
from dmip_tpu.samplers import euler_maruyama as jax_euler_maruyama
from dmip_tpu.sde import ReverseSDE as JReverseSDE
from dmip_tpu_torch import nets, samplers, sde
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.models import CDE
from dmip_tpu_torch.ops import em_kernel
from dmip_tpu_torch.ops.em_kernel import em_sampler_reference, fused_em_sampler


def _net(hidden=(64, 64), xdim=2, ydim=2, seed=0):
    jp = mlp_init(jax.random.PRNGKey(seed), xdim + ydim + 1, xdim, hidden)
    return jp, params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("dtype,lmbd,tol", [
    # f32: same arithmetic, f32 sum order only
    (jnp.float32, 0.0, 1e-4),
    (jnp.float32, 0.5, 1e-4),
    # bf16: both round activations to bf16; an f32 sum-order difference can
    # put a value on the other side of a bf16 rounding edge (measured 5e-6)
    (jnp.bfloat16, 0.0, 1e-3),
])
def test_plain_matches_pallas_kernel_interpret(dtype, lmbd, tol):
    jp, tp = _net()
    y = np.array([0.8, -0.3], np.float32)
    x0 = np.random.default_rng(0).normal(size=(512, 2)).astype(np.float32)
    ref = np.asarray(jax_fused_em_sampler(
        jp, jnp.asarray(x0), jnp.asarray(y), num_steps=40, lmbd=lmbd, seed=7, block_rows=256,
        compute_dtype=dtype, noise_scale=0.0, interpret=pltpu.InterpretParams()))
    out = em_sampler_reference(
        tp, torch.from_numpy(x0), torch.from_numpy(y), 40, lmbd=lmbd, noise_scale=0.0,
        compute_dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    assert _rel(out.numpy(), ref) < tol


@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
def test_plain_matches_xla_euler_maruyama_same_noise(noise_scale):
    """The JAX sampler's own x0 and per-step normals, reconstructed from its
    key schedule, fed to the port: f32 trajectories agree to rel 1e-4."""
    jp, tp = _net(seed=1)
    y = np.array([0.1, 0.5], np.float32)
    key = jax.random.PRNGKey(3)
    n, steps = 256, 30
    ref = np.asarray(jax_euler_maruyama(
        JReverseSDE(), lambda z, c, s: score_mlp_apply(jp, z, c, s), key, jnp.asarray(y),
        n, 2, steps, noise_scale=noise_scale))
    k0, kscan = jax.random.split(key)
    x0 = np.array(jax.random.normal(k0, (n, 2)))
    noise = np.stack([np.array(jax.random.normal(k, (n, 2))) for k in jax.random.split(kscan, steps)])
    out = samplers.euler_maruyama(
        sde.ReverseSDE(), lambda z, c, s: nets.score_mlp_apply(tp, z, c, s), torch.from_numpy(y),
        n, 2, steps, noise_scale=noise_scale, x0=torch.from_numpy(x0), noise=torch.from_numpy(noise))
    assert _rel(out.numpy(), ref) < 1e-4
    split = em_sampler_reference(tp, torch.from_numpy(x0), torch.from_numpy(y), steps,
                                 compute_dtype=torch.float32, noise_scale=noise_scale,
                                 noise=torch.from_numpy(noise))
    assert _rel(split.numpy(), ref) < 1e-4


def test_cpu_wrapper_runs_plain_version_seeded():
    _, tp = _net(seed=2)
    x0 = torch.randn(128, 2, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0.2, 0.1])
    before = fused_em_sampler.launches
    out = fused_em_sampler(tp, x0, y, 10, seed=5)
    ref = em_sampler_reference(tp, x0, y, 10, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert fused_em_sampler.launches == before


def test_pack_mma_b_fragment_order():
    """Element [nt, kp, lane, j, r, e] is W[(2kp+j)16 + 2(lane%4) + 8r + e,
    8nt + lane//4], the m16n8k16 B-fragment layout."""
    w = torch.randn(64, 40).to(torch.bfloat16).float()
    p = em_kernel.pack_mma_b(w).float()
    assert p.shape == (5, 2, 32, 2, 2, 2)
    for nt, kp, lane, j, r, e in [(0, 0, 0, 0, 0, 0), (4, 1, 31, 1, 1, 1), (2, 1, 13, 0, 1, 0)]:
        k = (2 * kp + j) * 16 + 2 * (lane % 4) + 8 * r + e
        assert p[nt, kp, lane, j, r, e] == w[k, 8 * nt + lane // 4]
    assert sorted(p.flatten().tolist()) == sorted(w.flatten().tolist())


def test_device_net_layout_computes_the_same_sampler():
    """Unpacking the kernel's padded net (widths 40 -> 64) and running the
    plain version on it gives the original net's trajectory exactly."""
    _, tp = _net(hidden=(40, 40), xdim=3, ydim=5, seed=4)
    dn = em_kernel._device_net(tp, 3)
    assert dn["widths"] == [64, 64] and dn["ydim"] == 5

    def unpack(p, k, n):
        w = torch.zeros(k, n)
        nt, kp, lane, j, r, e = torch.meshgrid(*[torch.arange(s) for s in p.shape], indexing="ij")
        w[(2 * kp + j) * 16 + 2 * (lane % 4) + 8 * r + e, 8 * nt + lane // 4] = p.float()
        return w

    w1 = torch.cat([dn["w1x"], dn["w1y"], dn["w1t"][None]], 0)
    padded = ((w1, dn["b1"]), (unpack(dn["wh"][0], 64, 64), dn["bh"][0]), (dn["wout"].t(), dn["bout"]))
    x0 = torch.randn(64, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randn(5, generator=torch.Generator().manual_seed(2))
    a = em_sampler_reference(tp, x0, y, 8, noise_scale=0.0)
    b = em_sampler_reference(padded, x0, y, 8, noise_scale=0.0)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_model_sample_on_cpu_takes_plain_sampler():
    model = CDE(xdim=2, ydim=2, hidden_layers=(32,))
    params = model.init(torch.Generator().manual_seed(0))
    y = torch.tensor([0.3, -0.2])
    a = model.sample(params, y, 64, 5, generator=torch.Generator().manual_seed(1))
    b = samplers.euler_maruyama(model.sde, lambda z, c, s: model.apply_a(params, z, c, s), y, 64, 2, 5,
                                generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.sample(params, y, 64, 5, method="heun")
