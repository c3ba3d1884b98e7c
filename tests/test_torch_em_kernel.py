"""Fused E-M sampler (kernel B1): the port's plain version against the JAX
Pallas kernel (interpret mode) and the JAX XLA sampler, and the kernel's
weight layout.  The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py."""

import random

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
from dmip_tpu_torch.ops.em_kernel import em_sampler_reference, fused_em_sampler, fused_em_sampler_cdiffe
from dmip_tpu_torch.ops.mh_kernel import pack_tf32_b, tf32_rna


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
    for dtype in (torch.bfloat16, torch.float32):
        stamps = torch.zeros(em_kernel.stamp_entries(4, 10, dtype), dtype=torch.int64)
        with pytest.raises(ValueError, match="stamps"):
            fused_em_sampler(tp, x0, y, 10, stamps=stamps, compute_dtype=dtype)
    # the stamps carry the ring's waits after the pairs: four a phase in f32;
    # two in bf16, whose records are two (block 0's and the last block's)
    assert em_kernel.stamp_entries(4, 10) == 2 * (2 * (1 + 4 * 10) + 2 * 4 * 10)
    assert em_kernel.stamp_entries(4, 10, torch.float32) == 2 * (1 + 4 * 10) + 4 * 4 * 10


@pytest.mark.parametrize("n,blocks", [(1, 2), (40, 2), (64, 2), (65, 2), (128, 2), (129, 4), (777, 14),
                                      (30000, 470)])
def test_bf16_launch_rounds_its_blocks_up_to_whole_clusters(n, blocks):
    """The bf16 template runs a block per 64 rows, rounded up to whole
    clusters of two (30000 rows: 469 blocks and one on zeros); the f32
    template runs alone, a block per 64 rows."""
    assert em_kernel.CLUSTER == 2 and em_kernel.cluster_size(torch.bfloat16) == 2
    assert em_kernel.launch_blocks(n) == blocks
    assert em_kernel.launch_blocks(n, torch.float32) == -(-n // 64)


@pytest.mark.parametrize("xdim,ydim,hidden,by_hand", [
    # the linear net, 5 -> 512^3 -> 2: W1's two 16 KB tiles (32 x 512 bf16), two 512 x 512 bf16 layers
    (2, 2, (512, 512, 512), 2 * 16384 + 2 * 512 * 512 * 2),
    # the scatterometry net, 27 -> 512^3 -> 3: B1 takes only x into W1, padded to the same 32 rows
    (3, 23, (512, 512, 512), 2 * 16384 + 2 * 512 * 512 * 2),
    # widths padded to 128: W1 32 x 128, two 128 x 128 layers
    (3, 23, (96, 80, 64), 2 * (32 * 128 + 2 * 128 * 128)),
])
def test_ring_bytes_per_block_step_by_hand(xdim, ydim, hidden, by_hand):
    """The weight bytes a block of the bf16 template reads from L2 a step,
    from the widths: 1,081,344 for a block alone at 512^3 and half of it,
    540,672, for each block of a cluster of two."""
    tp = nets.mlp_init(xdim + ydim + 1, xdim, hidden, generator=torch.Generator().manual_seed(0))
    widths = [w.shape[1] for w, _ in tp[:-1]]
    assert em_kernel.ring_bytes_per_block_step(widths, cluster=1) == by_hand
    assert em_kernel.ring_bytes_per_block_step(widths) == by_hand // 2
    if hidden[0] == 512:
        assert by_hand == 1_081_344 and by_hand // 2 == 540_672


def test_cpu_wrappers_count_no_cluster_launch():
    """Both wrappers count launches by cluster size (the bf16 template's 2,
    the f32 one's 1); the plain version on the CPU counts none."""
    _, tp = _net(seed=2)
    x0 = torch.randn(64, 2, generator=torch.Generator().manual_seed(0))
    for fn in (fused_em_sampler, fused_em_sampler_cdiffe):
        assert set(fn.launches_by_cluster) == {1, 2}
    before = dict(fused_em_sampler.launches_by_cluster)
    for dtype in (torch.bfloat16, torch.float32):
        fused_em_sampler(tp, x0, torch.tensor([0.2, 0.1]), 4, seed=5, compute_dtype=dtype)
    assert fused_em_sampler.launches_by_cluster == before


@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
def test_float64_witness_agrees_with_f32_plain_version(noise_scale):
    """The plain version run unrounded in float64 (the witness chip_smoke.py
    holds B1 against) agrees with the unrounded f32 run to rel 1e-4 (f32
    rounding over 40 steps, as the f32 tests above), lies within the bf16
    run's reach (rel 5e-2), and the default is still the f32 sampler with
    bf16 rounding."""
    _, tp = _net(hidden=(64, 64), xdim=2, ydim=2, seed=6)
    y = torch.tensor([0.4, -0.2])
    x0 = torch.randn(256, 2, generator=torch.Generator().manual_seed(1))
    noise = torch.randn(40, 256, 2, generator=torch.Generator().manual_seed(2))
    kw = dict(noise_scale=noise_scale, noise=noise)
    f64 = em_sampler_reference(tp, x0, y, 40, compute_dtype=torch.float64, dtype=torch.float64, **kw)
    f32 = em_sampler_reference(tp, x0, y, 40, compute_dtype=torch.float32, **kw)
    bf16 = em_sampler_reference(tp, x0, y, 40, **kw)
    assert f64.dtype == torch.float64 and f32.dtype == bf16.dtype == torch.float32
    assert _rel(f32.double().numpy(), f64.numpy()) < 1e-4
    assert _rel(bf16.double().numpy(), f64.numpy()) < 5e-2
    explicit = em_sampler_reference(tp, x0, y, 40, compute_dtype=torch.bfloat16, dtype=torch.float32, **kw)
    torch.testing.assert_close(bf16, explicit, rtol=0, atol=0)


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


def _unpack_wgmma_tiles(p):
    """The inverse of pack_wgmma_tiles, from its documented element map."""
    kcs, parts, cols, _ = p.shape
    w = torch.zeros(64 * kcs, parts * cols)
    kc, h, r, k = torch.meshgrid(*[torch.arange(s) for s in p.shape], indexing="ij")
    w[64 * kc + 8 * ((k // 8) ^ (r % 8)) + k % 8, h * cols + r] = p.float()
    return w


def test_pack_wgmma_tiles_layout():
    """Element [kc, h, r, 8q + e] is W[64kc + 8(q ^ (r%8)) + e, h N/2 + r]:
    each [kc, h] is one ring tile's shared-memory image, N/2 K-major rows
    of 128 bytes with the 128-byte swizzle.  Bad shapes raise."""
    w = torch.randn(128, 256).to(torch.bfloat16).float()
    p = em_kernel.pack_wgmma_tiles(w)
    assert p.shape == (2, 2, 128, 64) and p.dtype == torch.bfloat16
    for kc, h, r, q, e in [(0, 0, 0, 0, 0), (1, 1, 127, 7, 7), (0, 1, 13, 2, 5), (1, 0, 70, 6, 1)]:
        assert p[kc, h, r, 8 * q + e] == w[64 * kc + 8 * (q ^ (r % 8)) + e, 128 * h + r]
    torch.testing.assert_close(_unpack_wgmma_tiles(p), w, rtol=0, atol=0)
    one = em_kernel.pack_wgmma_tiles(w[:, :8], parts=1)
    assert one.shape == (2, 1, 8, 64)
    torch.testing.assert_close(_unpack_wgmma_tiles(one), w[:, :8], rtol=0, atol=0)
    with pytest.raises(ValueError):
        em_kernel.pack_wgmma_tiles(torch.zeros(96, 128))
    with pytest.raises(ValueError):
        em_kernel.pack_wgmma_tiles(torch.zeros(64, 120))


def _unpack_mma_b(p):
    """The inverse of pack_mma_b, from its documented element map."""
    w = torch.zeros(32 * p.shape[1], 8 * p.shape[0])
    nt, kp, lane, j, r, e = torch.meshgrid(*[torch.arange(s) for s in p.shape], indexing="ij")
    w[(2 * kp + j) * 16 + 2 * (lane % 4) + 8 * r + e, 8 * nt + lane // 4] = p.float()
    return w


def test_device_net_layout_computes_the_same_sampler():
    """Unpacking the kernel's padded net (widths 40 -> 128; W1x's 3 rows
    padded to 32, the condition folded into c1) and running the plain
    version on it gives the original net's trajectory exactly."""
    _, tp = _net(hidden=(40, 40), xdim=3, ydim=5, seed=4)
    y = torch.randn(5, generator=torch.Generator().manual_seed(2))
    dn = em_kernel._device_net(tp, 3, y)
    assert dn["widths"] == [128, 128] and dn["ydim"] == 5
    assert dn["w1"].shape == (16, 1, 32, 2, 2, 2) and dn["wout"].shape == (2, 1, 8, 64)

    w1x = _unpack_mma_b(dn["w1"])
    assert not w1x[3:].any()
    w1 = torch.cat([w1x[:3], dn["w1t"][None]], 0)
    wout = _unpack_wgmma_tiles(dn["wout"])
    assert not wout[:, 3:].any()
    padded = ((w1, dn["c1"]), (_unpack_wgmma_tiles(dn["wh"][0]), dn["bh"][0]), (wout[:, :3], dn["bout"]))
    x0 = torch.randn(64, 3, generator=torch.Generator().manual_seed(1))
    a = em_sampler_reference(tp, x0, y, 8, noise_scale=0.0)
    b = em_sampler_reference(padded, x0, None, 8, noise_scale=0.0)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_model_sample_on_cpu_takes_plain_sampler():
    model = CDE(xdim=2, ydim=2, hidden_layers=(32,))
    params = model.init(torch.Generator().manual_seed(0))
    y = torch.tensor([0.3, -0.2])
    a = model.sample(params, y, 64, 5, generator=torch.Generator().manual_seed(1))
    b = samplers.euler_maruyama(model.sde, lambda z, c, s: model.apply_a(params, z, c, s), y, 64, 2, 5,
                                generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    h = model.sample(params, y, 64, 5, method="heun", generator=torch.Generator().manual_seed(1))
    hp = samplers.heun_ode(model.sde, lambda z, c, s: model.apply_a(params, z, c, s), y, 64, 2, 5,
                           generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(h, hp, rtol=0, atol=0)


def test_plain_f32_matches_pallas_kernel_interpret_at_served_width():
    """The served 512^3 width (the linear nets' 5 -> 512^3 -> 2, random
    weights) in f32, noise off, 128 rows in one block, 10 steps: the plain
    version the f32 kernel is held to on the card against JAX's
    interpreted f32 kernel, to f32 sum order (rel 1e-4)."""
    jp, tp = _net(hidden=(512, 512, 512), seed=8)
    y = np.array([0.4, -0.6], np.float32)
    x0 = np.random.default_rng(4).normal(size=(128, 2)).astype(np.float32)
    ref = np.asarray(jax_fused_em_sampler(
        jp, jnp.asarray(x0), jnp.asarray(y), num_steps=10, seed=7, block_rows=128, compute_dtype=jnp.float32,
        noise_scale=0.0, interpret=pltpu.InterpretParams()))
    out = em_sampler_reference(tp, torch.from_numpy(x0), torch.from_numpy(y), 10, noise_scale=0.0,
                               compute_dtype=torch.float32)
    assert _rel(out.numpy(), ref) < 1e-4


def _unpack_tf32_b(p):
    """The inverse of pack_tf32_b, from its documented element map."""
    w = torch.zeros(8 * p.shape[1], 16 * p.shape[0])
    np_, ks, lane, nh, kh = torch.meshgrid(*[torch.arange(s) for s in p.shape], indexing="ij")
    w[8 * ks + 4 * kh + lane % 4, 16 * np_ + 8 * nh + lane // 4] = p
    return w


@pytest.mark.parametrize("k,n", [(96, 96), (256, 256), (384, 384), (512, 512), (96, 512), (512, 200), (26, 512)])
def test_pack_tf32_b_unpacks_to_the_zero_padded_weight(k, n):
    """B2's split-TF32 B-fragment order, at widths beyond B2's own: weights
    zero-padded to multiples of 128 (K to one of 8 under 32), packed and
    unpacked from the documented element map, come back exactly, for square
    widths 96 -> 128, 256, 384, 512 and for K != N."""
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(k + n))
    rows = -(-k // 8) * 8 if k < 32 else em_kernel._ceil128(k)
    padded = em_kernel._pad2(w, rows, em_kernel._ceil128(n))
    p = pack_tf32_b(padded)
    assert p.dtype == torch.float32 and p.shape == (padded.shape[1] // 16, padded.shape[0] // 8, 32, 2, 2)
    torch.testing.assert_close(_unpack_tf32_b(p), padded, rtol=0, atol=0)


def _unpack_tf32_tiles(p):
    """The inverse of pack_tf32_tiles, from its documented element map:
    the (hi, lo) planes, each (K, N)."""
    kps, _, S, cols, _ = p.shape
    planes = torch.zeros(2, 8 * S * kps, 4 * cols)
    kp, h, s, n, q, e = torch.meshgrid(*[torch.arange(m) for m in (kps, 4, S, cols, 4, 4)], indexing="ij")
    lp = q ^ ((n // 2) % 4)
    planes[lp // 2, 8 * (S * kp + s) + 2 * e + lp % 2, h * cols + n] = p.reshape(kps, 4, S, cols, 4, 4)
    return planes[0], planes[1]


@pytest.mark.parametrize("k,n", [(128, 128), (256, 256), (384, 384), (512, 512), (96, 200), (3, 512), (16, 128),
                                 (26, 512), (32, 384)])
def test_pack_tf32_tiles_splits_and_unpacks_to_the_zero_padded_weight(k, n):
    """The f32 kernel's ring tiles: a weight zero-padded as the wrapper pads
    it (widths to multiples of 128; the first layer's K, 3 ([x]) to one
    k-step, 8, 16, or 26 ([x, y] of the scatterometry CDiffE) to 32: tiles
    of one k-step at K = 8, of two past it), packed, and unpacked from the
    documented swizzled element map: the hi plane is tf32_rna of the weight
    bit for bit, hi + lo is the weight exactly, and lo is what hi leaves,
    below TF32's half unit."""
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(k + n)) * 3
    rows = 8 if k <= 8 else -(-k // 16) * 16 if k < 32 else em_kernel._ceil128(k)
    padded = em_kernel._pad2(w, rows, em_kernel._ceil128(n))
    p = em_kernel.pack_tf32_tiles(padded)
    S = 1 if rows == 8 else 2
    assert p.dtype == torch.float32 and p.shape == (rows // (8 * S), 4, S, padded.shape[1] // 4, 16)
    hi, lo = _unpack_tf32_tiles(p)
    assert torch.equal(hi.view(torch.int32), tf32_rna(padded).view(torch.int32))
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    torch.testing.assert_close(hi + lo, padded, rtol=0, atol=0)
    assert bool((lo.abs() <= hi.abs() * 2.0**-11).all())


def test_pack_tf32_tiles_element_map_and_bad_shapes():
    """Spot entries of the documented map: [kp, h, s, n, 4 q + e] is
    plane(p // 2)[8 (S kp + s) + 2 e + p % 2, h N/4 + n], p = q ^ ((n // 2)
    % 4), with S = 2 k-steps a tile, or 1 at K = 8; every ring tile, a
    tile's quarter of the columns, is consecutive memory, 16 KB at 512 wide
    (8 KB at K = 8).  A K neither 8 nor a multiple of 16, N off 128 or a
    bf16 weight raises."""
    for K, spots in ((32, [(0, 0, 0, 0, 0, 0), (1, 3, 1, 127, 3, 3), (0, 1, 1, 6, 1, 2), (1, 2, 0, 77, 2, 1)]),
                     (8, [(0, 0, 0, 0, 0, 0), (0, 3, 0, 127, 3, 3), (0, 1, 0, 6, 1, 2), (0, 2, 0, 77, 2, 1)])):
        w = torch.randn(K, 512, generator=torch.Generator().manual_seed(K))
        p = em_kernel.pack_tf32_tiles(w)
        S = min(2, K // 8)
        hi = tf32_rna(w)
        planes = (hi, w - hi)
        for kp, h, s, n, q, e in spots:
            lp = q ^ ((n // 2) % 4)
            assert p[kp, h, s, n, 4 * q + e] == planes[lp // 2][8 * (S * kp + s) + 2 * e + lp % 2, 128 * h + n]
        assert p[-1, 2].numel() * 4 == 8192 * S and p[-1, 2].is_contiguous()
    for bad in (torch.zeros(24, 128), torch.zeros(4, 128), torch.zeros(16, 192),
                torch.zeros(16, 128, dtype=torch.bfloat16)):
        with pytest.raises(ValueError):
            em_kernel.pack_tf32_tiles(bad)


def test_f32_device_net_layout_computes_the_same_sampler():
    """The f32 kernel's padded net (widths 40 -> 128 and 200 -> 256; W1x's
    3 rows padded to one k-step, 8, with the condition folded into c1, and
    the hidden weight, split into TF32 hi and lo as ring tiles; the
    output's x block (hl, 4)), unpacked (hi + lo), runs the f32 plain
    version to the original net's trajectory."""
    _, tp = _net(hidden=(40, 200), xdim=3, ydim=5, seed=4)
    y = torch.randn(5, generator=torch.Generator().manual_seed(2))
    dn = em_kernel._device_net(tp, 3, y, f32_mode=True)
    assert dn["widths"] == [128, 256] and dn["ydim"] == 5
    assert dn["w1"].shape == (1, 4, 1, 32, 16) and dn["wh"][0].shape == (8, 4, 2, 64, 16)
    assert dn["wout"].shape == (256, 4)
    assert all(t.dtype == torch.float32 for t in (dn["w1"], dn["wh"][0], dn["wout"]))
    w1x = sum(_unpack_tf32_tiles(dn["w1"]))
    assert not w1x[3:].any() and not dn["wout"][:, 3:].any()
    w1 = torch.cat([w1x[:3], dn["w1t"][None]], 0)
    padded = ((w1, dn["c1"]), (sum(_unpack_tf32_tiles(dn["wh"][0])), dn["bh"][0]), (dn["wout"][:, :3], dn["bout"]))
    x0 = torch.randn(64, 3, generator=torch.Generator().manual_seed(1))
    a = em_sampler_reference(tp, x0, y, 8, noise_scale=0.0, compute_dtype=torch.float32)
    b = em_sampler_reference(padded, x0, None, 8, noise_scale=0.0, compute_dtype=torch.float32)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _assert_same_net(a, b):
    """Two of B1's layouts hold the same tensors bit for bit (dtype, shape
    and value) and the same widths."""
    assert a.keys() - {"hidden_args"} == b.keys() - {"hidden_args"}
    for k in a.keys() - {"hidden_args"}:
        x, y = (a[k], b[k]) if isinstance(a[k], list) else ([a[k]], [b[k]])
        for s, t in zip(x, y, strict=True):
            if isinstance(s, torch.Tensor):
                assert s.dtype == t.dtype and torch.equal(s, t), k
            else:
                assert s == t, k


@pytest.mark.parametrize("f32_mode", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("hidden", [(40, 200), (512, 512, 512)])
def test_kept_layout_is_the_device_net_bit_for_bit(f32_mode, hidden):
    """The layout B1 launches from (:func:`_b1_net`: the packed layers from
    the cache and c1 computed anew) equals :func:`_device_net`'s, packed
    and kept (a miss) and found again (a hit), in both modes and at a
    padded and the served width."""
    _, tp = _net(hidden=hidden, xdim=3, ydim=5, seed=6)
    y = torch.randn(5, generator=torch.Generator().manual_seed(3))
    ref = em_kernel._device_net(tp, 3, y, f32_mode)
    for _ in range(2):
        _assert_same_net(em_kernel._b1_net(tp, 3, y, f32_mode), ref)
    net, hit = em_kernel.NetCache().get(tp, 3, f32_mode)
    assert not hit
    _assert_same_net({**net, "c1": ref["c1"]}, ref)


def test_a_hit_reuses_the_packed_tensors_and_computes_c1_anew():
    """A second lookup of the same params returns the very tensors the
    first packed; c1 follows y, equal to a fresh pack's for the new y."""
    _, tp = _net(hidden=(64, 64), xdim=3, ydim=5, seed=7)
    cache = em_kernel.NetCache()
    (first, hit0), (second, hit1) = cache.get(tp, 3), cache.get(tp, 3)
    assert (hit0, hit1) == (False, True)
    assert all(first[k] is second[k] for k in first)
    ys = torch.randn(2, 5, generator=torch.Generator().manual_seed(4))
    c1 = [em_kernel._b1_net(tp, 3, y)["c1"] for y in ys]
    for y, c in zip(ys, c1):
        assert torch.equal(c, em_kernel._device_net(tp, 3, y)["c1"])
    assert not torch.equal(c1[0], c1[1])


def _in_place_add(tp):
    with torch.no_grad():
        tp[1][0].add_(1e-3)
    return tp


def _adam_step(tp, in_place):
    from dmip_tpu_torch import pytree, train

    opt = train.build_optimizer(1e-3)
    grads = pytree.map(lambda t: torch.full_like(t, 0.5), tp)
    updates, _ = opt.update(grads, opt.init(tp))
    if not in_place:
        return train.apply_updates(tp, updates)
    with torch.no_grad():
        for p, u in zip(pytree.leaves(tp), pytree.leaves(updates)):
            p.add_(u)
    return tp


@pytest.mark.parametrize("change", [_in_place_add, lambda tp: _adam_step(tp, True), lambda tp: _adam_step(tp, False)],
                         ids=["add_under_no_grad", "adam_step_in_place", "adam_step"])
def test_changed_params_miss_and_pack_the_changed_net(change):
    """An in-place write (``add_`` under ``no_grad``, one Adam step added
    in place) bumps a leaf's version, and an Adam step's new tree holds new
    tensors: either misses, and the net packed then is the changed one."""
    _, tp = _net(hidden=(64, 64), xdim=3, ydim=5, seed=8)
    cache = em_kernel.NetCache()
    stale, _ = cache.get(tp, 3)
    tp = change(tp)
    net, hit = cache.get(tp, 3)
    assert not hit
    fresh = em_kernel._packed_net(tp, 3)
    _assert_same_net(net, fresh)
    assert not all(torch.equal(a, b) for a, b in zip(net["wh"] + [net["w1"]], stale["wh"] + [stale["w1"]]))


def test_equal_clones_miss_dead_leaves_drop_and_inference_tensors_are_packed_each_call():
    """A tree of equal clones misses; once it is freed its entry goes at
    the next lookup (no packed tensor views a leaf, so the cache holds no
    leaf alive); the mode and xdim key
    entries of their own; inference tensors, which track no version, are
    packed at every call and kept nowhere."""
    _, tp = _net(hidden=(64, 64), xdim=3, ydim=5, seed=9)
    cache = em_kernel.NetCache()
    net, hit = cache.get(tp, 3)
    leaf_memory = {t.untyped_storage().data_ptr() for pair in tp for t in pair}
    packed = [t for v in net.values() for t in (v if isinstance(v, list) else [v]) if isinstance(t, torch.Tensor)]
    assert not hit and not any(t.untyped_storage().data_ptr() in leaf_memory for t in packed)
    clones = tuple((w.clone(), b.clone()) for w, b in tp)
    assert not cache.get(clones, 3)[1] and len(cache) == 2
    assert not cache.get(tp, 3, f32_mode=True)[1] and not cache.get(tp, 2)[1] and len(cache) == 4
    del clones
    assert cache.get(tp, 3)[1] and len(cache) == 3
    with torch.inference_mode():
        frozen = tuple((w.clone(), b.clone()) for w, b in tp)
    assert not cache.get(frozen, 3)[1] and not cache.get(frozen, 3)[1] and len(cache) == 3


def test_the_least_recently_used_net_goes_first():
    """At the bound the least recently used entry is dropped: with room for
    two, a, b, a, c leaves a and c, so b misses again and a hits."""
    trees = {k: _net(hidden=(64, 64), seed=s)[1] for k, s in zip("abc", (10, 11, 12))}
    cache = em_kernel.NetCache(size=2)
    assert [cache.get(trees[k], 2)[1] for k in "abac"] == [False, False, True, False]
    assert len(cache) == 2
    assert cache.get(trees["a"], 2)[1] and not cache.get(trees["b"], 2)[1]
    assert cache.get(trees["a"], 2)[1] and not cache.get(trees["c"], 2)[1]


def test_pack_counters_move_and_are_listed():
    """``fused_em_sampler.packs`` counts the layouts packed and
    ``.pack_hits`` those found kept; ``profiling.counters()`` lists both,
    and no such counter for B4, which packs at every launch."""
    from dmip_tpu_torch.utils import profiling

    _, tp = _net(hidden=(64, 64), xdim=2, ydim=2, seed=13)
    before = fused_em_sampler.packs, fused_em_sampler.pack_hits
    for y in torch.randn(3, 2, generator=torch.Generator().manual_seed(5)):
        em_kernel._b1_net(tp, 2, y)
    assert (fused_em_sampler.packs, fused_em_sampler.pack_hits) == (before[0] + 1, before[1] + 2)
    c = profiling.counters()
    assert (c["fused_em_sampler.packs"], c["fused_em_sampler.pack_hits"]) == (before[0] + 1, before[1] + 2)
    assert "fused_em_sampler_cdiffe.packs" not in c


def test_model_sample_f32_kernel_method_on_cpu_is_the_f32_plain_version():
    """CDE.sample(method='kernel', compute_dtype=torch.float32) on the CPU
    is the f32 plain version on the sampler's own draws (x0, then the
    kernel's seed, from the generator) bit for bit, and launches nothing;
    the default mode is bf16."""
    model = CDE(xdim=2, ydim=2, hidden_layers=(32, 32))
    params = model.init(torch.Generator().manual_seed(0))
    y = torch.tensor([0.3, -0.2])
    before = fused_em_sampler.launches, dict(fused_em_sampler.launches_by_dtype)
    out = model.sample(params, y, 64, 6, generator=torch.Generator().manual_seed(1), method="kernel",
                       compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn(64, 2, generator=g)
    seed = int(torch.randint(0, 2**62, (1,), generator=g))
    base = model.sde.base
    kw = dict(T=model.sde.T, beta_min=base.beta_min, beta_max=base.beta_max)
    ref = em_sampler_reference(params, x0, y, 6, compute_dtype=torch.float32,
                               generator=torch.Generator().manual_seed(seed), **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (fused_em_sampler.launches, fused_em_sampler.launches_by_dtype) == before
    bf16 = model.sample(params, y, 64, 6, generator=torch.Generator().manual_seed(1), method="kernel")
    ref_bf16 = em_sampler_reference(params, x0, y, 6, generator=torch.Generator().manual_seed(seed), **kw)
    torch.testing.assert_close(bf16, ref_bf16, rtol=0, atol=0)
    assert not torch.equal(bf16, out)


@pytest.mark.parametrize("bad", [torch.float16, torch.float64, "auto"])
def test_wrappers_take_bf16_or_f32_only(bad):
    """Both wrappers take the kernels' two modes and raise a ValueError
    that names them for any other compute_dtype, on the CPU as on a card;
    f32 and bf16 run the plain version here."""
    _, tp = _net(seed=3)
    _, cd = _net(xdim=2, ydim=2, seed=3)
    cd = [*cd[:-1], (torch.randn(64, 4), torch.zeros(4))]
    x0 = torch.randn(16, 2, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0.2, 0.1])
    for fn, net in ((fused_em_sampler, tp), (fused_em_sampler_cdiffe, cd)):
        with pytest.raises(ValueError, match="torch.bfloat16 or torch.float32"):
            fn(net, x0, y, 3, compute_dtype=bad)
        for ok in (torch.bfloat16, torch.float32):
            assert bool(torch.isfinite(fn(net, x0, y, 3, compute_dtype=ok)).all())


def _ring_schedule(per_warpgroup: bool, seed: int, tiles: int = 400, wgs: int = 4, stages: int = 5) -> str:
    """A model of the f32 kernel's weight ring (csrc/em_kernel.cu, RingF)
    under one random interleaving: tile g sits in slot g % stages and is
    taken by warpgroup g % wgs, which then loads tile g + stages into that
    slot; a copy lands some time after it is issued and completes a phase
    of its mbarrier, which try_wait.parity passes once the phase of the
    parity asked for is done (the barrier's count of completed phases has
    the other parity).  With ``per_warpgroup``, the kernel's scheme: tile g
    on barrier (g % wgs, g % stages), parity (g // (wgs stages)) % 2;
    else one barrier a slot, parity (g // stages) % 2.  Warpgroups run at
    random speeds.  Returns "ok", "deadlock" or what went wrong."""
    rng = random.Random(seed)
    if per_warpgroup:
        bar, parity = (lambda g: (g % wgs) * stages + g % stages), (lambda g: (g // (wgs * stages)) % 2)
    else:
        bar, parity = (lambda g: g % stages), (lambda g: (g // stages) % 2)
    done = [0] * (wgs * stages)  # each barrier's completed phases
    slot, in_flight, nxt = [None] * stages, [], list(range(wgs))
    speed = [rng.choice((1, 1, 3, 10)) for _ in range(wgs)]

    def issue(g):
        if g < tiles:
            if any(bar(f) == bar(g) for f in in_flight):
                raise AssertionError(f"two copies in flight on the barrier of tile {g}")
            slot[g % stages] = "in flight"
            in_flight.append(g)

    for g in range(stages):
        issue(g)
    while any(n < tiles for n in nxt):
        ready = [h for h in range(wgs) if nxt[h] < tiles and done[bar(nxt[h])] % 2 != parity(nxt[h])]
        acts = [("take", h) for h in ready for _ in range(speed[h])] + [("land", i) for i in range(len(in_flight))]
        if not acts:
            return "deadlock"
        kind, i = rng.choice(acts)
        if kind == "land":
            g = in_flight.pop(i)
            slot[g % stages] = g
            done[bar(g)] += 1
            continue
        g = nxt[i]
        if slot[g % stages] != g:
            return f"warpgroup {i} took tile {g} from a slot holding {slot[g % stages]}"
        nxt[i] += wgs
        issue(g + stages)
    return "ok"


def test_f32_ring_schedule_never_hands_a_stale_tile():
    """The f32 kernel's ring protocol, modelled: under 60 random
    interleavings, with warpgroups up to 10x apart in speed, every
    warpgroup takes each of its tiles only once that tile has landed, no
    barrier has two copies in flight, and nothing deadlocks.  The control:
    one barrier a slot, waited for by parity, hands a warpgroup that runs
    ahead the slot's earlier tile (or one still in flight) in the same
    interleavings."""
    assert [_ring_schedule(True, s) for s in range(60)] == ["ok"] * 60
    assert all(_ring_schedule(False, s).startswith("warpgroup") for s in range(60))
