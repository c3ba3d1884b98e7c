"""The CUDA kernels on a card, each against its plain PyTorch version.

Imports neither JAX nor dmip_tpu, so it runs on a GPU host that has only
PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
On a host without a card every test skips (the kernels have no CPU mode).
"""

import os

import numpy as np
import pytest
import torch

from dmip_tpu_torch import mcmc, samplers
from dmip_tpu_torch.checkpoints import load_archived_params
from dmip_tpu_torch.models import CDE
from dmip_tpu_torch.models.refined import from_config
from dmip_tpu_torch.nets import mlp_init, score_mlp_apply
from dmip_tpu_torch.ops.dsm_train_kernel import dsm_train_epochs_reference, fused_dsm_train_epochs
from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler, guided_em_reference
from dmip_tpu_torch.ops import build
from dmip_tpu_torch.ops.em_kernel import (em_cdiffe_reference, em_sampler_reference, fused_em_sampler,
                                          fused_em_sampler_cdiffe, max_active_clusters, stamp_entries)
from dmip_tpu_torch.ops.em_kernel import CDIFFE_PHASES as EM_CDIFFE_PHASES
from dmip_tpu_torch.ops.em_kernel import PHASES as EM_PHASES
from dmip_tpu_torch.ops.mh_kernel import PHASES as MH_PHASES
from dmip_tpu_torch.ops.mh_kernel import fused_mh_scatterometry, mh_chains_reference, mh_energy
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat
from dmip_tpu_torch.sde import ReverseSDE
from dmip_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    edges only); same seed, same samples.  The f32 mode against the f32
    plain version, with noise given and with noise off, each row's error
    relative to 1 + its largest coordinate at 10x B1's bulk tolerances
    (mean 2e-4, 99.9th percentile 5e-3: f32 sum order and split-TF32
    products only), counted as an f32 launch; same seed, same samples.
    A third compute dtype and wrong shapes raise."""
    tp = mlp_init(5, 2, (64, 64), generator=torch.Generator().manual_seed(1), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x0 = torch.randn(300, 2, generator=gen, device=cuda)
    y = torch.tensor([0.8, -0.3], device=cuda)
    out = fused_em_sampler(tp, x0, y, 40, noise_scale=0.0)
    ref = em_sampler_reference(tp, x0, y, 40, noise_scale=0.0)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-2
    torch.testing.assert_close(fused_em_sampler(tp, x0, y, 40, seed=3), fused_em_sampler(tp, x0, y, 40, seed=3),
                               rtol=0, atol=0)
    f32 = dict(compute_dtype=torch.float32)
    noise = torch.randn(40, 300, 2, generator=gen, device=cuda)
    before = fused_em_sampler.launches_by_dtype["float32"]
    for kw in (dict(noise=noise), dict(noise_scale=0.0)):
        out = fused_em_sampler(tp, x0, y, 40, **kw, **f32)
        ref = em_sampler_reference(tp, x0, y, 40, **kw, **f32)
        torch.cuda.synchronize()
        err = (out - ref).abs().amax(dim=1) / (1 + ref.abs().amax(dim=1))
        assert float(err.mean()) < 2e-4 and float(torch.quantile(err, 0.999)) < 5e-3
    assert fused_em_sampler.launches_by_dtype["float32"] == before + 2
    torch.testing.assert_close(fused_em_sampler(tp, x0, y, 40, seed=3, **f32),
                               fused_em_sampler(tp, x0, y, 40, seed=3, **f32), rtol=0, atol=0)
    with pytest.raises(ValueError, match="torch.bfloat16 or torch.float32"):
        fused_em_sampler(tp, x0, y, 5, compute_dtype=torch.float16)
    with pytest.raises(ValueError):
        fused_em_sampler(tp, x0, y, 5, noise=torch.zeros(4, 300, 2, device=cuda))
    with pytest.raises(ValueError):
        fused_em_sampler(tp, x0, None, 5)


# (hidden widths, xdim, ydim, rows): every wgmma width the layout has (a
# warpgroup's 64, 128, 192 and 256 columns), widths padded from 96 and 80,
# one hidden layer (no hidden product), xdim 1 and 4, B1 with ydim 0, B4 at
# its widest [x, y] (32), fewer rows than a block and a ragged last block
EM_SHAPES = {
    "padded_1x_ydim0_small": ((96, 80, 64), 1, 0, 40),
    "one_layer_4x_ragged": ((96,), 4, 5, 777),
    "all_widths_3x": ((128, 256, 384, 512), 3, 23, 1000),
    "served_512_2x": ((512, 512, 512), 2, 2, 300),
}


# each mode's bulk tolerances on a row's error relative to 1 + its largest
# coordinate: bf16 B1's (mean 2e-3, 99.9th percentile 5e-2), and 10x tighter
# for f32 (f32 sum order and split-TF32 products only)
EM_TOLS = {torch.bfloat16: (2e-3, 5e-2), torch.float32: (2e-4, 5e-3)}


@pytest.mark.parametrize("compute_dtype", list(EM_TOLS), ids=["bf16", "f32"])
@pytest.mark.parametrize("cdiffe", [False, True])
@pytest.mark.parametrize("shape", list(EM_SHAPES))
def test_em_kernels_widths_and_shapes(cuda, cdiffe, shape, compute_dtype):
    """B1 and B4 in both modes against their plain versions in the same
    mode, same x0 and noise, 30 steps, over the layout's shapes; each row's
    error relative to 1 + its largest coordinate (random nets move the
    state further than trained ones), held at the mode's bulk tolerances
    (``EM_TOLS``).  The same seed gives the same samples."""
    hidden, xdim, ydim, n = EM_SHAPES[shape]
    if cdiffe and ydim == 0:
        ydim = 2  # B4 needs a condition
    if cdiffe and xdim + ydim > 32:
        ydim = 32 - xdim
    fn, ref_fn = (fused_em_sampler_cdiffe, em_cdiffe_reference) if cdiffe else (fused_em_sampler,
                                                                                  em_sampler_reference)
    out_dim = xdim + ydim if cdiffe else xdim
    tp = mlp_init(xdim + ydim + 1, out_dim, hidden, generator=torch.Generator().manual_seed(7), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x0 = torch.randn(n, xdim, generator=gen, device=cuda)
    y = 0.3 * torch.randn(ydim, generator=gen, device=cuda) if ydim else None
    noise = torch.randn(30, n, out_dim if cdiffe else xdim, generator=gen, device=cuda)
    out = fn(tp, x0, y, 30, noise=noise, compute_dtype=compute_dtype)
    ref = ref_fn(tp, x0, y, 30, noise=noise, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    err = (out - ref).abs().amax(dim=1) / (1 + ref.abs().amax(dim=1))
    mean_tol, p999_tol = EM_TOLS[compute_dtype]
    assert float(err.mean()) < mean_tol and float(torch.quantile(err, 0.999)) < p999_tol
    torch.testing.assert_close(fn(tp, x0, y, 30, seed=9, compute_dtype=compute_dtype),
                               fn(tp, x0, y, 30, seed=9, compute_dtype=compute_dtype), rtol=0, atol=0)


def test_em_kernels_refuse_widths_past_512(cuda):
    """Widths past 512 (after padding to 128) do not fit the layout: raise."""
    tp = mlp_init(5, 2, (640, 512), generator=torch.Generator().manual_seed(1), device=cuda)
    x0 = torch.zeros(10, 2, device=cuda)
    with pytest.raises(ValueError, match="512"):
        fused_em_sampler(tp, x0, torch.zeros(2, device=cuda), 5)


@pytest.mark.parametrize("cdiffe", [False, True])
@pytest.mark.parametrize("width", [128, 512])
def test_em_f32_ring_under_skew(cuda, monkeypatch, width, cdiffe):
    """The f32 template's weight ring does not depend on its warpgroups
    keeping pace: built with EMF_SKEW_NS, one warpgroup at a time stalls
    2 us before each refill it issues while the others run ahead.  At 128
    (a warpgroup's tile a few hundred ns of products) and 512 wide, B1 and
    B4 give the samples of the plain build bit for bit, within the f32
    tolerances of the plain version, and wait for tiles longer than it."""
    base = fused_em_sampler_cdiffe if cdiffe else fused_em_sampler
    fn = lambda *a, **kw: base(*a, compute_dtype=torch.float32, **kw)
    xdim, ydim, n, steps = 3, 23, 1000, 20
    out_dim = xdim + ydim if cdiffe else xdim
    tp = mlp_init(xdim + ydim + 1, out_dim, (width,) * 3, generator=torch.Generator().manual_seed(5), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x0 = torch.randn(n, xdim, generator=gen, device=cuda)
    y = 0.3 * torch.randn(ydim, generator=gen, device=cuda)
    noise = torch.randn(steps, n, out_dim, generator=gen, device=cuda)
    names = EM_CDIFFE_PHASES if cdiffe else EM_PHASES
    pairs = 2 * (1 + len(names) * steps)
    runs = {}
    for skew in (False, True):
        if skew:
            load = build.load
            monkeypatch.setattr(build, "load", lambda name: load(name, defines=("EMF_SKEW_NS=2000",)))
        stamps = torch.zeros(stamp_entries(len(names), steps, torch.float32), dtype=torch.int64, device=cuda)
        runs[skew] = fn(tp, x0, y, steps, noise=noise, stamps=stamps), int(stamps[pairs:].sum())
    torch.cuda.synchronize()
    (plain, plain_wait), (skewed, skewed_wait) = runs[False], runs[True]
    assert torch.equal(plain, skewed)
    assert skewed_wait > plain_wait
    ref = (em_cdiffe_reference if cdiffe else em_sampler_reference)(tp, x0, y, steps, noise=noise,
                                                                     compute_dtype=torch.float32)
    err = (skewed - ref).abs().amax(dim=1) / (1 + ref.abs().amax(dim=1))
    mean_tol, p999_tol = EM_TOLS[torch.float32]
    assert float(err.mean()) < mean_tol and float(torch.quantile(err, 0.999)) < p999_tol


@pytest.mark.parametrize("compute_dtype", list(EM_TOLS), ids=["bf16", "f32"])
@pytest.mark.parametrize("cdiffe", [False, True])
def test_em_kernel_stamps(cuda, cdiffe, compute_dtype):
    """B1 and B4 in both modes with stamps: block 0's clock readings rise
    through the launch, every phase of every step, and the samples are bit
    for bit those of the run without stamps.  In f32 the stamps then hold
    the ring's waits, each warpgroup's in each phase within the phase's
    cycles and none in the phases that take no weight tile.  A stamps
    tensor too short raises."""
    base = fused_em_sampler_cdiffe if cdiffe else fused_em_sampler
    fn = lambda *a, **kw: base(*a, compute_dtype=compute_dtype, **kw)
    tp = mlp_init(27, 26 if cdiffe else 3, (512, 512, 512), generator=torch.Generator().manual_seed(3),
                  device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x0 = torch.randn(700, 3, generator=gen, device=cuda)
    y = 0.3 * torch.randn(23, generator=gen, device=cuda)
    steps, names = 12, EM_CDIFFE_PHASES if cdiffe else EM_PHASES
    pairs = 2 * (1 + len(names) * steps)
    stamps = torch.full((stamp_entries(len(names), steps, compute_dtype),), -1, dtype=torch.int64, device=cuda)
    plain = fn(tp, x0, y, steps, seed=11)
    stamped = fn(tp, x0, y, steps, seed=11, stamps=stamps)
    torch.cuda.synchronize()
    assert torch.equal(plain, stamped)
    for clock in (stamps[0:pairs:2], stamps[1:pairs:2]):
        assert bool((clock > 0).all()) and bool((clock[1:] >= clock[:-1]).all())
        ends = clock[1:].reshape(steps, len(names))[:, -1]
        assert bool((ends > torch.cat([clock[:1], ends[:-1]])).all())
    if compute_dtype == torch.float32:
        cyc = stamps[1:pairs:2]
        spans = (cyc[1:] - cyc[:-1]).reshape(steps, len(names), 1)
        w = stamps[pairs:].reshape(steps, len(names), 4)
        assert bool((w >= 0).all()) and bool((w <= spans).all())
        idle = [i for i, n in enumerate(names) if n in ("noise", "output", "update")]
        assert not w[:, idle].any()
    with pytest.raises(ValueError, match="stamps"):
        fn(tp, x0, y, steps, seed=11, stamps=stamps[:-1])


def _served_shape(cuda, cdiffe, n, seed=3):
    """A net of the served shape (27 -> 512^3 -> 3, or 26 for B4), n rows
    of x0 and a condition."""
    tp = mlp_init(27, 26 if cdiffe else 3, (512, 512, 512), generator=torch.Generator().manual_seed(seed),
                  device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tp, torch.randn(n, 3, generator=gen, device=cuda), 0.3 * torch.randn(23, generator=gen, device=cuda)


@pytest.mark.parametrize("cdiffe", [False, True], ids=["b1", "b4"])
def test_em_rows_do_not_depend_on_the_grid(cuda, cdiffe):
    """B1 and B4 in bf16 on the first n rows of one x0 give the first n rows
    of the 30000-row run bit for bit: one block padded to a cluster (40,
    64), two blocks (65, 128), an odd block count (777: 13 blocks, 14
    launched) and the full 470-block launch."""
    fn = fused_em_sampler_cdiffe if cdiffe else fused_em_sampler
    tp, x0, y = _served_shape(cuda, cdiffe, 30000)
    full = fn(tp, x0, y, 20, seed=9)
    for n in (40, 64, 65, 128, 777):
        part = fn(tp, x0[:n].contiguous(), y, 20, seed=9)
        torch.cuda.synchronize()
        assert torch.equal(part, full[:n]), n
    assert bool(torch.isfinite(full).all())


@pytest.mark.parametrize("cdiffe", [False, True], ids=["b1", "b4"])
def test_em_bf16_stamps_record_ring_waits_of_two_blocks(cuda, cdiffe):
    """The bf16 stamps hold two records, block 0's and the launch's last
    block's: each one's clocks rise through the launch, and each consumer
    warpgroup's ring waits lie within its phase's cycles, some in every
    step's products and none in the phases that take no weight tile.  The
    stamped launch gives the unstamped one's samples bit for bit."""
    fn = fused_em_sampler_cdiffe if cdiffe else fused_em_sampler
    tp, x0, y = _served_shape(cuda, cdiffe, 3000, seed=4)
    steps, names = 12, EM_CDIFFE_PHASES if cdiffe else EM_PHASES
    pairs, waits = 2 * (1 + len(names) * steps), 2 * len(names) * steps
    stamps = torch.full((stamp_entries(len(names), steps),), -1, dtype=torch.int64, device=cuda)
    assert stamps.numel() == 2 * (pairs + waits)
    plain = fn(tp, x0, y, steps, seed=11)
    stamped = fn(tp, x0, y, steps, seed=11, stamps=stamps)
    torch.cuda.synchronize()
    assert torch.equal(plain, stamped)
    records = stamps.view(2, pairs + waits)
    assert not torch.equal(records[0, :pairs], records[1, :pairs])
    for rec in records:
        clock, cyc = rec[0:pairs:2], rec[1:pairs:2]
        assert bool((clock > 0).all()) and bool((clock[1:] >= clock[:-1]).all())
        spans = (cyc[1:] - cyc[:-1]).reshape(steps, len(names), 1)
        w = rec[pairs:].reshape(steps, len(names), 2)
        assert bool((w >= 0).all()) and bool((w <= spans).all())
        idle = [i for i, n in enumerate(names) if n in ("noise", "output", "update")]
        assert not w[:, idle].any()
        assert bool((w.sum((1, 2)) > 0).all())


def test_bf16_launches_count_clusters_of_two(cuda):
    """Every bf16 launch of B1 and B4 counts under cluster size 2, every f32
    launch under 1; at the served widths the card holds at least 59
    clusters at once, so 470 blocks still take four waves."""
    for cdiffe, fn in ((False, fused_em_sampler), (True, fused_em_sampler_cdiffe)):
        tp, x0, y = _served_shape(cuda, cdiffe, 700)
        before = dict(fn.launches_by_cluster)
        fn(tp, x0, y, 4, seed=1)
        fn(tp, x0, y, 4, seed=2)
        fn(tp, x0, y, 4, seed=1, compute_dtype=torch.float32)
        torch.cuda.synchronize()
        assert fn.launches_by_cluster == {1: before[1] + 1, 2: before[2] + 2}
        assert max_active_clusters([512, 512, 512], cdiffe=cdiffe) >= 59


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_b1_launches_from_kept_layers_as_from_a_fresh_pack(cuda, recorder, dtype):
    """B1 keeps a net's packed layers while its params are unchanged: the
    launches that find them (for the same y and for another) give the
    samples of a fresh pack (a tree of clones) by SHA-256; after an
    in-place change to one hidden weight the next launch packs anew and
    gives the changed net's samples, not the kept ones; ``b1.pack`` spans
    every launch."""
    import hashlib

    tp, x0, y = _served_shape(cuda, False, 2000)
    clone = lambda t: tuple((w.clone(), b.clone()) for w, b in t)
    run = lambda p, c: fused_em_sampler(p, x0, c, 50, seed=9, compute_dtype=dtype)
    digest = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    packs, hits, launches = fused_em_sampler.packs, fused_em_sampler.pack_hits, fused_em_sampler.launches
    first = run(tp, y)
    kept, kept_y2 = run(tp, y), run(tp, y.flip(0))
    assert (fused_em_sampler.packs, fused_em_sampler.pack_hits) == (packs + 1, hits + 2)
    assert digest(kept) == digest(first) == digest(run(clone(tp), y))
    assert digest(kept_y2) == digest(run(clone(tp), y.flip(0))) != digest(kept)
    with torch.no_grad():
        tp[1][0].mul_(1.01)
    changed = run(tp, y)
    assert digest(changed) == digest(run(clone(tp), y)) != digest(kept)
    assert (fused_em_sampler.packs, fused_em_sampler.pack_hits) == (packs + 5, hits + 2)
    torch.cuda.synchronize()
    spans = recorder.records()["spans"]
    assert spans["b1.pack"]["count"] == spans["b1.launch"]["count"] == fused_em_sampler.launches - launches == 7


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


def _mh_case(cuda, n, ydim, steps, seed=0):
    """The committed surrogate (its output layer redrawn when ydim is not
    23), an observation, uniform starts and the randomness of ``steps``
    steps; step 0's uniforms kept >= 1e-3 from the plain accept threshold,
    so an f32 sum-order difference cannot flip its decisions."""
    weights = scat.load_surrogate_weights(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if ydim != 23:
        w3 = torch.randn(256, ydim, generator=gen, device=cuda) / 16
        weights = [*weights[:3], (w3, 0.1 * torch.randn(ydim, generator=gen, device=cuda))]
    fwd = lambda x: scat.surrogate_apply(weights, x)
    y = scat.noisy_forward(fwd, torch.tensor([[0.3, -0.5, 0.1]], device=cuda), 0.2, 0.01, gen)[0]
    x0 = torch.rand(n, 3, generator=gen, device=cuda) * 2 - 1
    z = torch.randn(steps, n, 3, generator=gen, device=cuda)
    u = torch.rand(steps, n, generator=gen, device=cuda)
    if steps:
        energy = mh_energy(weights, y, KW["a"], KW["b"], KW["lambd_bd"])
        thr = torch.exp(energy(x0) - energy(x0 + KW["noise_std"] * z[0])).clamp(max=2.0)
        near = (u[0] - thr).abs() < 1e-3
        u[0] = torch.where(near, torch.where(thr > 2e-3, thr - 2e-3, thr + 2e-3), u[0])
    return weights, y, x0, z, u


@pytest.mark.parametrize("n,ydim,steps", [
    (37, 23, 12),      # fewer chains than one block
    (1000, 23, 12),    # a ragged last block
    (4096, 23, 1),
    (700, 1, 12),
    (700, 32, 12),
    (300, 23, 0),
])
def test_mh_kernel_shapes_and_energies(cuda, n, ydim, steps):
    """B2 against its plain version with the same randomness: one step
    agrees to 1e-5 on every chain; over 12 steps at most 1% of chains (or
    one) end elsewhere, as an accept on its threshold can flip.  The
    carried energies (``energy_out``) agree with the plain energy of the
    returned states to 1e-4 of max(|e|, 1); with no steps the states are
    x0 exactly."""
    weights, y, x0, z, u = _mh_case(cuda, n, ydim, steps)
    e_k = torch.empty(n, device=cuda)
    out = fused_mh_scatterometry(weights, x0, y, steps, noise=z, uniforms=u, energy_out=e_k, **KW)
    ref = mh_chains_reference(weights, x0, y, steps, noise=z, uniforms=u, **KW)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(e_k).all())
    if steps == 0:
        assert torch.equal(out, x0)
    if steps >= 1:
        one = fused_mh_scatterometry(weights, x0, y, 1, noise=z[:1], uniforms=u[:1], **KW)
        one_ref = mh_chains_reference(weights, x0, y, 1, noise=z[:1], uniforms=u[:1], **KW)
        assert float((one - one_ref).abs().max()) <= 1e-5
    assert int(((out - ref).abs().amax(1) > 1e-4).sum()) <= max(1, n // 100)
    e_p = mh_energy(weights, y, KW["a"], KW["b"], KW["lambd_bd"])(out)
    assert float(((e_k - e_p).abs() / e_p.abs().clamp(min=1.0)).max()) <= 1e-4


def test_mh_kernel_stamps_and_energy_out_leave_states_alone(cuda):
    """With ``stamps`` and ``energy_out`` the states are bit for bit those
    of the run without; block 0's clock readings never fall and rise from
    step to step (the card's clock and the SM's cycle count alike).  Too
    short a stamps tensor, or a wrong energy_out, raises."""
    weights, y, x0, _, _ = _mh_case(cuda, 777, 23, 0)
    steps = 9
    stamps = torch.zeros(2 * (1 + len(MH_PHASES) * steps), dtype=torch.int64, device=cuda)
    e_k = torch.empty(777, device=cuda)
    plain = fused_mh_scatterometry(weights, x0, y, steps, seed=5, **KW)
    stamped = fused_mh_scatterometry(weights, x0, y, steps, seed=5, stamps=stamps, energy_out=e_k, **KW)
    torch.cuda.synchronize()
    assert torch.equal(plain, stamped)
    for clock in (stamps[0::2], stamps[1::2]):
        assert bool((clock > 0).all()) and bool((clock[1:] >= clock[:-1]).all())
        ends = clock[1:].reshape(steps, len(MH_PHASES))[:, -1]
        assert bool((ends > torch.cat([clock[:1], ends[:-1]])).all())
    with pytest.raises(ValueError, match="stamps"):
        fused_mh_scatterometry(weights, x0, y, steps, stamps=stamps[:-1], **KW)
    with pytest.raises(ValueError, match="energy_out"):
        fused_mh_scatterometry(weights, x0, y, steps, energy_out=e_k[:-1], **KW)


# B3's nets: (in, hidden, out, batch): the linear and the CDiffE nets at
# full width, a narrow odd net whose widths and batch are not multiples of
# the kernel's 64-wide tiles, two layers (whose output phase also forms
# dW_0), and the two shapes whose output layer takes a phase of its own: an
# output wider than one tile, and a single layer
B3_NETS = {
    "linear": (5, (512, 512, 512), 2, 1000),
    "cdiffe": (27, (512, 512, 512), 26, 1000),
    "narrow": (7, (40, 72), 3, 100),
    "two_layer": (7, (40,), 3, 100),
    "wide_out": (7, (40,), 80, 100),
    "one_layer": (7, (), 3, 100),
}


def _b3_inputs(cuda, net, rows_per_batch=None, n_steps=6, seed=0):
    in_dim, hidden, out, batch = B3_NETS[net]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = mlp_init(in_dim, out, hidden, generator=torch.Generator().manual_seed(3), device=cuda)
    mu = tuple((1e-3 * torch.randn(w.shape, generator=gen, device=cuda),
                1e-3 * torch.randn(b.shape, generator=gen, device=cuda)) for w, b in params)
    nu = tuple((m ** 2, n ** 2) for m, n in mu)
    rows = n_steps * batch
    h0 = torch.randn(rows, in_dim, generator=gen, device=cuda)
    eps = torch.randn(rows, out, generator=gen, device=cuda)
    s1 = torch.rand(rows, out, generator=gen, device=cuda)
    return params, mu, nu, h0, eps, s1, batch


@pytest.mark.parametrize("guard", [True, "loss", False])
@pytest.mark.parametrize("dtype,param_tol,moment_rel,loss_rel", [
    # f32: the same arithmetic in another f32 sum order
    (torch.float32, 1e-5, 1e-4, 1e-5),
    # bf16: identical bf16 operands; a sum-order difference can move a tanh
    # output across a bf16 rounding edge, which Adam turns into at most an
    # lr-sized step
    (torch.bfloat16, 2e-3, 1e-2, 1e-3),
])
@pytest.mark.parametrize("net", list(B3_NETS))
def test_dsm_train_kernel_matches_plain(cuda, net, dtype, param_tol, moment_rel, loss_rel, guard):
    """2 epochs x 3 batches, the second epoch masked; under both guards a NaN
    in one row of batch 1 (the step is skipped); params, moments, count and
    the active epoch's loss against the plain version."""
    params, mu, nu, h0, eps, s1, batch = _b3_inputs(cuda, net)
    if guard:
        h0[batch + 17, 0] = float("nan")
    kw = dict(n_epochs=2, n_batches=3, batch_real=batch, lr=1e-3, n_active=1, compute_dtype=dtype,
              skip_nonfinite=guard)
    before = fused_dsm_train_epochs.launches
    out = fused_dsm_train_epochs(params, mu, nu, 4, h0, eps, s1, **kw)
    ref = dsm_train_epochs_reference(params, mu, nu, 4, h0, eps, s1, **kw)
    torch.cuda.synchronize()
    assert fused_dsm_train_epochs.launches == before + 1
    assert int(out[3]) == int(ref[3]) == (6 if guard else 7)
    pairs = lambda j: [(x, y) for a, b in zip(out[j], ref[j]) for x, y in zip(a, b)]
    assert all(x.shape == y.shape for x, y in pairs(0))
    assert max(float((x - y).abs().max()) for x, y in pairs(0)) <= param_tol
    for j in (1, 2):
        assert max(float((x - y).abs().max() / y.abs().max()) for x, y in pairs(j)) <= moment_rel
    if guard:
        assert bool(torch.isnan(out[4][0])) and bool(torch.isnan(ref[4][0]))
    else:
        assert float((out[4][0] - ref[4][0]).abs() / ref[4][0].abs()) <= loss_rel
    with pytest.raises(ValueError):
        fused_dsm_train_epochs(params, mu, nu, 4, h0[:-1], eps, s1, **kw)
    with pytest.raises(ValueError):
        fused_dsm_train_epochs(params, mu, nu, 4, h0.double(), eps, s1, **kw)


@pytest.mark.parametrize("net", ["linear", "narrow"])
def test_dsm_train_kernel_is_deterministic_and_chunks_exactly(cuda, net):
    """bf16: two launches on the same input give identical bits, and one
    launch of 4 epochs equals two launches of 2 epochs bit for bit (params,
    moments, count, losses)."""
    params, mu, nu, h0, eps, s1, batch = _b3_inputs(cuda, net, n_steps=8)
    kw = dict(n_batches=2, batch_real=batch, lr=1e-3)
    one = fused_dsm_train_epochs(params, mu, nu, 4, h0, eps, s1, n_epochs=4, n_active=4, **kw)
    again = fused_dsm_train_epochs(params, mu, nu, 4, h0, eps, s1, n_epochs=4, n_active=4, **kw)
    half = 4 * batch
    first = fused_dsm_train_epochs(params, mu, nu, 4, h0[:half], eps[:half], s1[:half], n_epochs=2,
                                   n_active=2, **kw)
    second = fused_dsm_train_epochs(*first[:4], h0[half:], eps[half:], s1[half:], n_epochs=2, n_active=2, **kw)
    flat = lambda r: [t for tree in r[:3] for pair in tree for t in pair] + [r[3], r[4]]
    for x, y in zip(flat(one), flat(again)):
        assert torch.equal(x, y)
    chunked = flat(second)[:-1] + [torch.cat([first[4], second[4]])]
    for x, y in zip(flat(one), chunked):
        assert torch.equal(x, y)
    assert int(one[3]) == 12


def test_em_cdiffe_kernel_matches_plain(cuda):
    """B4 vs its plain version on a joint 27 -> 96 -> 80 -> 64 -> 26 net
    (widths not multiples of 32), 1000 rows (a ragged last block): the same
    x0 and (steps, N, 26) noise, and the noise-off trajectory.  bf16: mean
    abs error 2e-3 and 99.9th percentile 5e-2, B1's tolerances (the same
    bf16 rounding rule); f32 against the f32 plain version at 10x tighter
    (2e-4, 5e-3), counted as f32 launches; the same seed gives the same f32
    samples.  A third compute dtype and bad shapes raise."""
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
    f32 = dict(compute_dtype=torch.float32)
    before = fused_em_sampler_cdiffe.launches_by_dtype["float32"]
    for kw in (dict(noise=noise), dict(noise_scale=0.0)):
        out = fused_em_sampler_cdiffe(tp, x0, y, 50, **kw, **f32)
        ref = em_cdiffe_reference(tp, x0, y, 50, **kw, **f32)
        torch.cuda.synchronize()
        err = (out - ref).abs().amax(dim=1)
        assert float(err.mean()) < 2e-4 and float(torch.quantile(err, 0.999)) < 5e-3
    assert fused_em_sampler_cdiffe.launches_by_dtype["float32"] == before + 2
    torch.testing.assert_close(fused_em_sampler_cdiffe(tp, x0, y, 50, seed=3, **f32),
                               fused_em_sampler_cdiffe(tp, x0, y, 50, seed=3, **f32), rtol=0, atol=0)
    with pytest.raises(ValueError, match="torch.bfloat16 or torch.float32"):
        fused_em_sampler_cdiffe(tp, x0, y, 5, compute_dtype=torch.float16)
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


def _guided_case(cuda, prior_width, surr_width, surr_depth, ydim, n, seed):
    """A random prior (4 -> prior_width^2 -> 3) and a random ReLU surrogate
    (3 -> surr_width^surr_depth -> ydim), y the surrogate's output at a
    point plus noise, and x0 ~ N(0, 1) of n rows."""
    prior = mlp_init(4, 3, (prior_width,) * 2, generator=torch.Generator().manual_seed(seed), device=cuda)
    surr = mlp_init(3, ydim, (surr_width,) * surr_depth, generator=torch.Generator().manual_seed(seed + 1),
                    device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed + 2)
    y = scat.surrogate_apply(surr, torch.tensor([[0.3, -0.5, 0.1]], device=cuda))[0]
    y = y + 0.01 * torch.randn(ydim, generator=gen, device=cuda)
    return prior, surr, y, torch.randn(n, 3, generator=gen, device=cuda), gen


@pytest.mark.parametrize("prior_width,surr_width,surr_depth,ydim,n,guidance,clip", [
    (64, 64, 2, 23, 37, "dps", 10.0),          # fewer rows than one 64-row block (a 64-wide net: no 48-row blocks)
    (128, 128, 3, 32, 1000, "pgdm", None),     # 48-row blocks, the last ragged; ydim = 32
    (256, 512, 4, 32, 130, "dps", None),       # the widest surrogate: a two-stage weight ring
    (512, 256, 3, 23, 2000, "pgdm", 100.0),    # the served widths
    (512, 128, 2, 32, 64, "dps", 100.0),       # 64 rows as 48 + 16
    (64, 512, 2, 23, 300, "pgdm", 10.0),
    (256, 64, 3, 32, 513, "dps", 1.0),
    (512, 256, 3, 23, 8448, "dps", 100.0),     # 132 whole 64-row blocks on an H100
    (512, 256, 3, 23, 9000, "pgdm", None),     # 132 blocks of 64 rows, then 12 of 48
])
def test_guided_kernel_widths_and_shapes(cuda, prior_width, surr_width, surr_depth, ydim, n, guidance, clip):
    """B5 against its plain version on random nets of every supported width
    (64/128/256/512, both nets), ydim up to 32, row counts that give 64-row
    blocks, 48-row blocks and both, ragged or not, both guidance modes with
    and without the clip: two steps of the 200-step grid from the same state
    and noise.  As chip_smoke.py's step-by-step check: each row's error
    relative to the length of its move, median <= 1e-4, and at most
    max(0.1%, one row) of the rows above 1e-2 (a ReLU pre-activation at 0
    can flip its mask in one version only)."""
    prior, surr, y, x0, gen = _guided_case(cuda, prior_width, surr_width, surr_depth, ydim, n, 3)
    noise = torch.randn(2, n, 3, generator=gen, device=cuda)
    kw = dict(a=0.2, b=0.01, guidance_clip=clip, num_steps=200, start_step=150, stop_step=152, noise=noise,
              guidance=guidance)
    before = fused_guided_em_sampler.launches
    out = fused_guided_em_sampler(prior, surr, x0, y, **kw)
    ref = guided_em_reference(prior, surr, x0, y, **kw)
    torch.cuda.synchronize()
    assert fused_guided_em_sampler.launches == before + 1
    assert bool(torch.isfinite(out).all())
    rel = (out - ref).abs().amax(dim=1) / (ref - x0).abs().amax(dim=1).clamp(min=1e-6)
    assert float(rel.median()) <= 1e-4
    assert int((rel > 1e-2).sum()) <= max(1, int(1e-3 * n))


@pytest.mark.parametrize("guidance", ["dps", "pgdm"])
def test_guided_kernel_stamps(cuda, guidance):
    """With stamps, block 0's clock readings rise monotonically through the
    launch (every phase of every step, the card's clock and the SM's cycle
    count alike), and the samples are bit for bit those of the run without
    stamps.  A stamps tensor too short raises."""
    prior, surr, y, x0, _ = _guided_case(cuda, 512, 256, 3, 23, 700, 5)
    kw = dict(a=0.2, b=0.01, guidance_clip=100.0, num_steps=200, start_step=40, stop_step=52, seed=11,
              guidance=guidance)
    stamps = torch.zeros(2 * (1 + 7 * 12), dtype=torch.int64, device=cuda)
    plain = fused_guided_em_sampler(prior, surr, x0, y, **kw)
    stamped = fused_guided_em_sampler(prior, surr, x0, y, stamps=stamps, **kw)
    torch.cuda.synchronize()
    assert torch.equal(plain, stamped)
    for clock in (stamps[0::2], stamps[1::2]):
        assert bool((clock > 0).all()) and bool((clock[1:] >= clock[:-1]).all())
        steps = clock[1:].reshape(12, 7)
        assert bool((steps[:, -1] > torch.cat([clock[:1], steps[:-1, -1]])).all())
    with pytest.raises(ValueError, match="stamps"):
        fused_guided_em_sampler(prior, surr, x0, y, stamps=stamps[:-1], **kw)


def test_refinement_chain_on_the_card_matches_the_cpu(cuda):
    """The annealed MH chain (lambda 0.5 -> 1) on the scatterometry energy,
    2000 chains x 20 steps, on the card and on the CPU with the same
    injected draws: the energies differ in f32 sum order only, so at most
    1% of the chains take another accept decision and the others end
    within 1e-4."""
    fwd_h, fp = scat.load_forward_model()
    fwd_c, _ = scat.load_forward_model(device=cuda)
    gen = torch.Generator().manual_seed(0)
    n, steps = 2000, 20
    y = scat.noisy_forward(fwd_h, torch.tensor([[0.3, -0.5, 0.1]]), fp["a"], fp["b"], gen)[0]
    x0 = torch.tensor([0.3, -0.5, 0.1]) + 0.1 * torch.randn(n, 3, generator=gen)
    noise, unif = torch.randn(steps, n, 3, generator=gen), torch.rand(steps, n, generator=gen)

    def energy(f, dev):
        ys = y.to(dev).expand(n, -1)
        return lambda x: scat.get_log_posterior(x, f, fp["a"], fp["b"], ys, fp["lambd_bd"])

    kw = dict(noise_std=0.2, lambda0=0.5)
    xc, ic = mcmc.annealed_mh(x0.to(cuda), energy(fwd_c, cuda), steps, noise=noise.to(cuda),
                              uniforms=unif.to(cuda), **kw)
    xh, ih = mcmc.annealed_mh(x0, energy(fwd_h, "cpu"), steps, noise=noise, uniforms=unif, **kw)
    assert xc.device.type == "cuda" and ic["acc_rate"].device.type == "cuda"
    err = (xc.cpu() - xh).abs().amax(dim=1)
    assert float((err > 1e-4).float().mean()) <= 0.01
    assert float((ic["acc_rate"].cpu() - ih["acc_rate"]).abs().max()) <= 0.01


@pytest.mark.parametrize("ode", [False, True])
def test_expint_on_the_card_matches_the_cpu(cuda, ode):
    """The exponential integrator (order 2, 32 steps) of the committed
    linear net on the card and on the CPU from the same x0 and noise: f32
    products in another sum order, within 1e-4 on unit-scale samples."""
    path = os.path.join(REPO, "benchmarks/checkpoints/linear_refined_winner")
    gen = torch.Generator().manual_seed(1)
    x0, noise = torch.randn(4000, 2, generator=gen), torch.randn(33, 4000, 2, generator=gen)
    y = torch.tensor([0.4, -0.7])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tp = load_archived_params(path, device=dev)
        out[dev.type] = samplers.exponential_integrator(
            ReverseSDE(), lambda z, c, s: score_mlp_apply(tp, z, c, s), y.to(dev), 4000, 2, 32, ode=ode,
            order=2, x0=x0.to(dev), noise=noise.to(dev))
    assert out["cuda"].device.type == "cuda"
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("spec", ["mh,5,0.2,anneal=0.5,acc=0.4", "mala,3,0.01", "ula,2,0.01,0.5,0.01"])
def test_refined_sample_stays_on_the_card(cuda, spec):
    """A refined sample through B1: the proposal is one launch, every energy
    call sees card tensors, the draws come from the card's generator (the
    host's RNG state does not move) and the samples are on the card."""
    prob = LinearForwardProblem()
    model = CDE(xdim=2, ydim=2, hidden_layers=(128, 128))
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    seen = []

    def energy(x, ys):
        seen.append((x.device.type, ys.device.type))
        return prob.log_posterior(x, ys)[:, 0]

    refined, _ = from_config(model, energy, spec)
    host_rng = torch.get_rng_state()
    before = fused_em_sampler.launches
    x = refined.sample(params, torch.tensor([0.4, -0.7], device=cuda), 1000, 20,
                       generator=torch.Generator(device=cuda).manual_seed(2))
    torch.cuda.synchronize()
    assert x.device.type == "cuda" and x.shape == (1000, 2) and bool(torch.isfinite(x).all())
    assert fused_em_sampler.launches == before + 1
    assert seen and set(seen) == {("cuda", "cuda")}
    assert torch.equal(torch.get_rng_state(), host_rng)


def test_elbo_tools_draw_on_the_card_without_a_generator(cuda):
    """With no generator, the ELBO tools' times, normals and probes are
    drawn on x's device: the host's RNG state does not move."""
    from dmip_tpu_torch import sde

    tp = mlp_init(5, 2, (16, 16), generator=torch.Generator().manual_seed(0), device=cuda)
    x, cond = torch.randn(32, 2, device=cuda), torch.randn(32, 2, device=cuda)
    host_rng = torch.get_rng_state()
    outs = [sde.reverse_sde_dsm(ReverseSDE(debias=False), score_mlp_apply, tp, x, cond),
            sde.reverse_sde_dsm(ReverseSDE(), score_mlp_apply, tp, x, cond),
            sde.elbo_random_t_slice(ReverseSDE(), score_mlp_apply, tp, x, cond),
            sde.sample_v((32, 2), "gaussian", device=cuda)]
    assert torch.equal(torch.get_rng_state(), host_rng)
    assert all(o.device.type == "cuda" and bool(torch.isfinite(o).all()) for o in outs)


def test_profiler_sees_the_card(cuda, tmp_path):
    """torch.profiler on the card: a traced B1 launch shows device time, a
    busy share in (0, 1] and the top operations by device time."""
    tp = mlp_init(27, 3, (512, 512, 512), generator=torch.Generator().manual_seed(5), device=cuda)
    x0 = torch.randn(30000, 3, device=cuda)
    y = torch.randn(23, device=cuda)
    fused_em_sampler(tp, x0, y, 20, seed=1)
    with profiling.trace(str(tmp_path)) as prof:
        fused_em_sampler(tp, x0, y, 20, seed=1)
    share = profiling.busy_share(prof)
    assert 0.0 < share["share"] <= 1.0 and share["kernels"] >= 1
    top = profiling.top_ops(prof, "device")
    assert top and top[0]["ms"] > 0.0
    assert (tmp_path / "trace.json").exists()
    sec, out = profiling.timeit(fused_em_sampler, tp, x0, y, 20, seed=1)
    assert sec > 0.0 and out.shape == (30000, 3)


def _baseline_energy(dev):
    f, fp = scat.load_forward_model(device=dev)
    return lambda x, ys: scat.get_log_posterior(x, f, fp["a"], fp["b"], ys, fp["lambd_bd"])


def test_flows_on_the_card_match_the_cpu(cuda):
    """The committed SNF and INN (``baselines_{snf,inn}``) sample on the card
    and on the CPU from the same z and MH draws: f32 in another sum order,
    within 1e-4 (the SNF on all but at most 1% of the rows, whose MH accept
    sits on its threshold, the refinement chains' rule).  Then a MALA SNF's
    loss gradient, which runs through the Langevin steps' kept graph, on
    the card against the CPU's."""
    from dmip_tpu_torch import flows, pytree

    n, gen = 2000, torch.Generator().manual_seed(3)
    z = torch.randn(n, 3, generator=gen)
    noise, unif = torch.randn(10, n, 3, generator=gen), torch.rand(10, n, generator=gen)
    y = scat.load_forward_model()[0](torch.tensor([[0.2, -0.4, 0.6]]))[0]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        snf = flows.create_snf(4, 64, _baseline_energy(dev), metr_steps_per_block=10, dimension=3,
                               dimension_condition=23, noise_std=0.4)
        inn = flows.create_inn(4, 64, 3, 23)
        sp = load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/baselines_snf"), device=dev)
        ip = load_archived_params(os.path.join(REPO, "benchmarks/checkpoints/baselines_inn"), device=dev)
        draws = [None if isinstance(layer, flows.DeterministicLayer) else {"noise": noise.to(dev), "uniforms": unif.to(dev)}
                 for layer in snf.layers]
        with torch.no_grad():
            out[dev.type] = (snf.sample(sp, y.to(dev), n, z=z.to(dev), draws=draws),
                             inn.sample(ip, y.to(dev), n, z=z.to(dev)))
    assert out["cuda"][0].device.type == "cuda"
    snf_err = (out["cuda"][0].cpu() - out["cpu"][0]).abs().amax(dim=1)
    assert float((snf_err > 1e-4).float().mean()) <= 0.01
    torch.testing.assert_close(out["cuda"][1].cpu(), out["cpu"][1], rtol=0, atol=1e-4)

    prob = LinearForwardProblem()
    snf = flows.create_snf(2, 32, lambda x, ys: prob.log_posterior(x, ys)[:, 0], metr_steps_per_block=2,
                           dimension=2, dimension_condition=2, langevin_prop=True, lang_steps_prop=2)
    p0 = snf.init(torch.Generator().manual_seed(4))
    x, ys = 0.5 * torch.randn(500, 2, generator=gen), torch.randn(500, 2, generator=gen)
    eta, unif = torch.randn(2, 2, 500, 2, generator=gen), torch.rand(2, 500, generator=gen)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_(True) for t in pytree.leaves(p0)]
        draws = [None if isinstance(layer, flows.DeterministicLayer) else {"noise": eta.to(dev), "uniforms": unif.to(dev)}
                 for layer in snf.layers]
        loss = flows.snf_ml_loss(snf, pytree.unflatten(p0, leaves), x.to(dev), ys.to(dev), draws=draws)
        grads[dev.type] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_baselines_dsm_row_reaches_b1(cuda, tmp_path):
    """The scatterometry baselines driver re-scores the committed archives
    (``--eval_only``) on the card: the DSM row samples through B1, one
    launch a repeat, and every metric is finite."""
    import shutil

    from dmip_tpu_torch.mains import main_baselines_scatterometry as mbs
    from dmip_tpu_torch.utils import load_config

    gt_dir = tmp_path / "gt" / "0"
    os.makedirs(gt_dir)
    rng = np.random.default_rng(0)
    for j in range(2):
        np.save(gt_dir / f"{j}.npy", rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32))
    # plot_ys: [] -- the config lists condition 0, whose figures need
    # matplotlib, which a GPU host need not have (tests/test_torch_plotting.py
    # holds the figures)
    cfg = dict(load_config(os.path.join(REPO, "configs/config_baselines_scatterometry.yml")), n_samples_y=1,
               n_samples_x=2000, n_repeats=2, train_dir=str(tmp_path / "train"), out_dir=str(tmp_path / "out"),
               plot_ys=[])
    for name, archive in (("snf", "baselines_snf"), ("diffusion", "baselines_dsm"), ("INN", "baselines_inn")):
        shutil.copytree(os.path.join(REPO, "benchmarks/checkpoints", archive), os.path.join(cfg["train_dir"], name))
    before = fused_em_sampler.launches
    mean = mbs.run(cfg, str(tmp_path / "gt"), eval_only=True, device="cuda")
    torch.cuda.synchronize()
    assert fused_em_sampler.launches == before + 2
    assert all(np.isfinite(v) for v in mean.values()), mean


def test_ensemble_matches_sequential_at_full_width(cuda):
    """K = 2 trials of the linear PINNLoss (FPE, L1) at 512^3 and batch
    1000, one epoch of 3 steps, f32 (TF32 off), each against the sequential
    autograd engine with its lam / lam2 from the same init and seed.  The
    first step's loss: the same arithmetic in another sum order, within
    1e-4 (chip_smoke.py's GRID_STEP_LOSS_REL_TOL).  Every leaf against the
    distance the 3 steps moved it: Adam's update is scale-free, so only a
    weight whose gradient sits at the rounding level can take an lr step of
    the other sign, ~2e-3 of a 512 x 512 leaf's 3-step update; 1e-2 leaves
    room for a few and is far below what the other trial's lam gives."""
    import dataclasses

    from dmip_tpu_torch import data, ensemble, pytree, train

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        prob = LinearForwardProblem()
        xs, ys = data.generate_dataset_linear(2, prob.forward, 3000, torch.Generator().manual_seed(0), cuda)
        batch_fn = lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 1000)
        model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "PINNLoss", "pde_loss": "FPE",
                                                "pde_metric": "L1", "ic_metric": "L1"}, {"xdim": 2, "ydim": 2})
        kw = {"initial_condition": prob.score_posterior}
        opt = train.build_optimizer(1e-4)
        lams, lam2s = [1.0, 1e-4], [1.0, 1e-4]
        ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(8), 2, device=cuda)
        gen = train.epoch_generator(9, 0, cuda)
        xb, yb = batch_fn(gen)
        t, eps, v = model.loss_draws(cfg, gen, xb[0], yb[0])
        step = ensemble.make_ensemble_step(model, cfg, opt, kw)
        _, _, first, _ = step(ens, ensemble.init_opt_state(opt, ens), torch.tensor(lams, device=cuda),
                              torch.tensor(lam2s, device=cuda), xb[0], yb[0], t, eps, v)
        efn = ensemble.make_ensemble_epoch_fn(model, cfg, opt, batch_fn, 1, kw)
        ens, hist = ensemble.ensemble_fit(efn, ens, opt, 9, 1, torch.tensor(lams, device=cuda),
                                          torch.tensor(lam2s, device=cuda), log_every=0)
        p0 = model.init(torch.Generator().manual_seed(8), device=cuda)
        seq = []
        for i in range(2):
            loss_fn = model.make_loss_fn(dataclasses.replace(cfg, lam=lams[i], lam2=lam2s[i]), **kw)
            ref = float(loss_fn(p0, None, xb[0], yb[0], t=t, eps=eps, v=v)[0])
            assert abs(float(first[i]) - ref) <= 1e-4 * abs(ref)
            fn = train.make_epoch_fn(loss_fn, opt, batch_fn)
            seq.append(train.fit(fn, p0, opt, 9, 1, log_every=0)[0])
            for a, b, c in zip(pytree.leaves(ensemble.trial_params(ens, i)), pytree.leaves(seq[i]),
                               pytree.leaves(p0)):
                assert float((a - b).norm() / (b - c).norm()) <= 1e-2
        contrast = min(float((a - b).norm() / (b - c).norm())
                       for a, b, c in zip(pytree.leaves(seq[0]), pytree.leaves(seq[1]), pytree.leaves(p0)))
        assert contrast > 0.1 and np.isfinite(hist).all()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_grid_evaluation_reaches_b1(cuda, tmp_path):
    """The linear grid driver on the card: one ensemble group of 2 trials,
    each evaluated through B1 (one launch a repeat), finite metrics."""
    from dmip_tpu_torch.mains import run_grid_search_linear
    from dmip_tpu_torch.utils import load_config

    cfg = dict(load_config(os.path.join(REPO, "configs/config_gridsearch_linear_small.yml")), hidden_layers=[128, 128],
               dataset_size=3000, n_epochs=1, epochs_per_call=1, n_samples_y=1, n_samples_x=2000, eval_n_repeats=1,
               src_dir=str(tmp_path / "grid"))
    cfg["params"] = dict(cfg["params"], loss_fn=["PINNLoss"], pde_loss=["FPE"], pde_metric=["L1"])
    before = fused_em_sampler.launches
    out = run_grid_search_linear.run(cfg, device="cuda")
    torch.cuda.synchronize()
    assert fused_em_sampler.launches == before + 2
    assert len(out["results"]) == 2 and all(np.isfinite([r["kl"], r["nlpd"], r["fisher"]]).all()
                                            for r in out["results"])


def test_b1_launches_on_its_tensors_device(cuda):
    """B1 launches on its tensors' device whatever the current device is,
    and leaves the current device as it was: each card in turn holds the
    tensors while the current device is set (torch.cuda.set_device) to
    another card, or to the same one on a host with one card, where the
    fault this guards against cannot show."""
    n = torch.cuda.device_count()
    prev = torch.cuda.current_device()
    try:
        for d in range(n):
            dev = torch.device("cuda", d)
            tp = mlp_init(5, 2, (64, 64), generator=torch.Generator().manual_seed(1), device=dev)
            x0 = torch.randn(300, 2, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
            y = torch.tensor([0.8, -0.3], device=dev)
            torch.cuda.set_device((d + 1) % n)
            out = fused_em_sampler(tp, x0, y, 20, noise_scale=0.0)
            assert torch.cuda.current_device() == (d + 1) % n and out.device == dev
            ref = em_sampler_reference(tp, x0, y, 20, noise_scale=0.0)
            torch.cuda.synchronize(dev)
            assert float((out - ref).abs().max() / ref.abs().max()) < 1e-2
    finally:
        torch.cuda.set_device(prev)


def _world_of_one_train(mesh):
    """Five PINNLoss steps of a 64-wide net on the card, over ``mesh``."""
    from dmip_tpu_torch import data, train

    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, 500, torch.Generator().manual_seed(0), "cuda")
    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [64, 64]},
                                           {"xdim": 2, "ydim": 2})
    opt = train.build_optimizer(1e-3)
    fn = train.make_epoch_fn(model.make_loss_fn(cfg, initial_condition=prob.score_posterior), opt,
                             lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 100), mesh=mesh)
    p = model.init(torch.Generator().manual_seed(1), device="cuda")
    p, st, losses, infos = fn(p, opt.init(p), 3, 0)
    return p, st, losses, infos


def test_world_of_one_nccl_rank_is_the_meshless_run(cuda):
    """A world of one NCCL rank: the collectives give their input back bit
    for bit, the data-parallel engine equals the meshless one bit for bit
    (params, Adam state, losses), and evaluate_linear with the mesh equals
    itself run again (each condition's own generator)."""
    from dmip_tpu_torch import evaluate, pytree
    from dmip_tpu_torch.parallel import get_mesh, init_multihost, local_address

    assert init_multihost(local_address(), 1, 0)
    try:
        mesh = get_mesh()
        assert (mesh.size, mesh.backend, mesh.device) == (1, "nccl", torch.device("cuda", 0))
        t = torch.randn(1000, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
        assert torch.equal(mesh.all_reduce(t, mean=True), t) and torch.equal(mesh.all_gather(t), t)
        assert torch.equal(mesh.broadcast(t), t) and mesh.all_gather_objects({"a": 1.5}) == [{"a": 1.5}]
        got, ref = _world_of_one_train(mesh), _world_of_one_train(None)
        for a, b in zip(pytree.leaves(got), pytree.leaves(ref)):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        prob = LinearForwardProblem()
        model = CDE(2, 2, (64, 64))
        params = model.init(torch.Generator().manual_seed(2), device="cuda")
        ys = prob.forward(torch.randn(3, 2, generator=torch.Generator().manual_seed(3)).to(cuda))
        runs = [evaluate.evaluate_linear(model, params, prob, ys, torch.Generator(device=cuda).manual_seed(4),
                                         n_samples_x=2000, n_repeats=2, num_steps=20, verbose=False, mesh=mesh)
                for _ in range(2)]
        assert runs[0] == runs[1] and np.isfinite(runs[0]).all()
    finally:
        torch.distributed.destroy_process_group()


def _gloo_ranks_on_one_card(rank, address, out_dir):
    from dmip_tpu_torch.parallel import get_mesh, init_multihost

    init_multihost(address, 2, rank)
    mesh = get_mesh()
    t = torch.full((3,), float(rank + 1), device=mesh.device)
    out = {"backend": mesh.backend, "device": str(mesh.device), "sum": mesh.all_reduce(t).tolist(),
           "mean": mesh.all_reduce(t, mean=True).tolist(), "gather": mesh.all_gather(t[:2]).tolist(),
           "broadcast": mesh.broadcast(t).tolist(), "objects": mesh.all_gather_objects(rank)}
    mesh.barrier()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two ranks on a host with fewer cards than ranks: gloo on the shared
    card, every collective of the mesh on CUDA tensors."""
    import torch.multiprocessing as mp

    from dmip_tpu_torch.parallel import local_address

    if torch.cuda.device_count() > 1:
        pytest.skip("two ranks get a card each here (NCCL)")
    mp.spawn(_gloo_ranks_on_one_card, args=(local_address(), str(tmp_path)), nprocs=2, join=True)
    for r in range(2):
        out = torch.load(tmp_path / f"rank{r}.pt")
        assert (out["backend"], out["device"]) == ("gloo", "cuda:0")
        assert out["sum"] == [3.0] * 3 and out["mean"] == [1.5] * 3 and out["gather"] == [1.0, 1.0, 2.0, 2.0]
        assert out["broadcast"] == [1.0] * 3 and out["objects"] == [0, 1]


# --- the captured train step (CUDA graphs) ----------------------------------

# the captured step against the eager one: bit for bit unless cuBLAS picks
# other algorithms under capture, and then the mesh parity's limits
GRAPH_LOSS_REL, GRAPH_LEAF_REL = 1e-6, 1e-4


def _graph_parity(eager, graph, p0) -> str:
    """'bit for bit' when the captured run (params, state, losses) equals
    the eager one exactly; else, having held every epoch's loss within
    GRAPH_LOSS_REL and every parameter leaf within GRAPH_LEAF_REL of its
    update, 'within tolerance'."""
    from dmip_tpu_torch import pytree

    (pe, se, le), (pg, sg, lg) = eager, graph
    if torch.equal(le, lg) and all(torch.equal(a, b) for a, b in zip(pytree.leaves((pe, se)),
                                                                      pytree.leaves((pg, sg)))):
        return "bit for bit"
    assert float(((lg - le).abs() / le.abs()).max()) <= GRAPH_LOSS_REL
    for a, b, c in zip(pytree.leaves(pg), pytree.leaves(pe), pytree.leaves(p0)):
        assert float((a - b).norm() / (b - c).norm()) <= GRAPH_LEAF_REL
    assert torch.equal(sg.count, se.count)
    return "within tolerance"


def _graph_case(name, dev):
    """(loss, params, batch_fn) at 64^3 for the captured-step tests: the
    linear PINNLoss, the linear DSM (drawing an epoch at once), the DPS
    PosteriorLoss through the shipped surrogate, a linear SNF with
    Metropolis layers."""
    from dmip_tpu_torch import data, flows, train

    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, 500, torch.Generator().manual_seed(0), dev)
    batch_fn = lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 100)
    if name == "pinn":
        model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "PINNLoss", "lam": 0.001, "lam2": 0.1,
                                                "ic_metric": "L2", "hidden_layers": [64] * 3}, {"xdim": 2, "ydim": 2})
        return model.make_loss_fn(cfg, initial_condition=prob.score_posterior), \
            model.init(torch.Generator().manual_seed(1), device=dev), batch_fn
    if name == "dsm":
        model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "DSM", "hidden_layers": [64] * 3},
                                               {"xdim": 2, "ydim": 2})
        return model.make_loss_fn(cfg), model.init(torch.Generator().manual_seed(1), device=dev), batch_fn
    if name == "snf":
        snf = flows.create_snf(2, 64, lambda x, c: prob.log_posterior(x, c)[:, 0], metr_steps_per_block=3,
                               dimension=2, dimension_condition=2)
        return flows.snf_loss_fn(snf), snf.init(torch.Generator().manual_seed(1), dev), batch_fn
    forward, fp = scat.load_forward_model(device=dev)
    gen = torch.Generator().manual_seed(0)
    xs = (torch.rand(500, 3, generator=gen) * 2 - 1).to(dev)
    ys = forward(xs) + 0.01 * torch.randn(500, 23, generator=gen).to(dev)
    model, cfg = train.get_model_from_args({"model": "Posterior", "lam": 1.0, "hidden_layers": [64] * 3},
                                           {"xdim": 3, "ydim": 23})
    return model.make_loss_fn(cfg, forward_model=forward, forward_params=fp), \
        model.init(torch.Generator().manual_seed(1), device=dev), \
        lambda g: data.linear_epoch_batches(g, xs, ys, 0.0, 100)


@pytest.mark.parametrize("name", ["pinn", "posterior", "snf"])
def test_captured_step_matches_the_eager_step(cuda, name):
    """Two epochs of 5 steps through the default engine on the card (one
    CUDA-graph replay a step, captured once) against capture=False from
    the same params and seed; prints which limit held."""
    from dmip_tpu_torch import train

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss_fn, p0, batch_fn = _graph_case(name, cuda)
        opt = train.build_optimizer(1e-3, grad_clip=1.0)
        runs = {}
        for capture in (False, True):
            fn = train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=2, capture=capture)
            p, st, losses, _ = fn(p0, opt.init(p0), 3, 0)
            runs[capture] = (p, st, losses)
        assert fn.graph.captures == 1 and int(runs[True][1].count) == 10
        assert bool(torch.isfinite(runs[True][2]).all())
        print(f"{name}: captured against eager {_graph_parity(runs[False], runs[True], p0)}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_captured_ensemble_matches_the_eager_ensemble(cuda):
    """A K = 4 PINNLoss ensemble at 64^3, two epochs of 5 steps, captured
    against capture=False; prints which limit held."""
    from dmip_tpu_torch import ensemble, train

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        prob = LinearForwardProblem()
        _, _, batch_fn = _graph_case("pinn", cuda)
        model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [64] * 3},
                                               {"xdim": 2, "ydim": 2})
        opt = train.build_optimizer(1e-3)
        lams, lam2s, _ = ensemble.pad_trials([1.0, 0.1, 0.01, 0.001], [1.0, 0.1, 1.0, 0.1], 1, device=cuda)
        ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(1), 4, device=cuda)
        runs = {}
        for capture in (False, True):
            efn = ensemble.make_ensemble_epoch_fn(model, cfg, opt, batch_fn, 2, {"initial_condition":
                                                                                  prob.score_posterior},
                                                  capture=capture)
            p, st, losses, _ = efn(ens, ensemble.init_opt_state(opt, ens), 3, 0, lams, lam2s)
            runs[capture] = (p, st, losses)
        assert efn.graph.captures == 1 and losses.shape == (2, 4) and bool(torch.isfinite(losses).all())
        print(f"ensemble: captured against eager {_graph_parity(runs[False], runs[True], ens)}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_captured_step_recaptures_on_a_shape_change(cuda):
    """A call at batch 100, then two at batch 50: the second call captures
    anew and equals the eager engine at 50 within the limits above, the
    third replays the same graph; the trees returned are the caller's own
    (no aliasing of the graph's buffers)."""
    from dmip_tpu_torch import data, pytree, train

    loss_fn, p0, _ = _graph_case("pinn", cuda)
    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, 500, torch.Generator().manual_seed(0), cuda)
    size = {"batch": 100}
    batch_fn = lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, size["batch"])
    opt = train.build_optimizer(1e-3)
    fn = train.make_epoch_fn(loss_fn, opt, batch_fn)
    first = fn(p0, opt.init(p0), 3, 0)
    size["batch"] = 50
    second = fn(p0, opt.init(p0), 3, 0)
    assert fn.graph.captures == 2
    eager = train.make_epoch_fn(loss_fn, opt, batch_fn, capture=False)(p0, opt.init(p0), 3, 0)
    _graph_parity(eager[:3], second[:3], p0)
    kept = [t.clone() for t in pytree.leaves(second[:2])]
    third = fn(p0, opt.init(p0), 3, 1)
    assert fn.graph.captures == 2 and int(third[1].count) == 10
    assert all(torch.equal(a, b) for a, b in zip(kept, pytree.leaves(second[:2])))
    assert not torch.equal(first[2], second[2])


# --- the captured step over a mesh -------------------------------------------


@pytest.fixture
def nccl_rank(cuda):
    """A world of one NCCL rank in this process, torn down after the test."""
    from dmip_tpu_torch.parallel import get_mesh, init_multihost, local_address

    assert init_multihost(local_address(), 1, 0)
    try:
        yield get_mesh()
    finally:
        torch.distributed.destroy_process_group()


def _engine_variants(name, dev, mesh):
    """The engine on ``_graph_case(name)`` for two epochs of 5 steps, from
    the same params and seed: {'meshed', 'meshed_eager', 'meshless'} ->
    ((params, state, losses), captures), the first two over ``mesh``,
    captured and with capture=False, the third captured with no mesh."""
    from dmip_tpu_torch import train

    loss_fn, p0, batch_fn = _graph_case(name, dev)
    opt = train.build_optimizer(1e-3, grad_clip=1.0)
    out = {}
    for key, m, capture in (("meshed", mesh, True), ("meshed_eager", mesh, False), ("meshless", None, True)):
        fn = train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=2, mesh=m, capture=capture)
        out[key] = (fn(p0, opt.init(p0), 3, 0)[:3], fn.graph.captures)
    return out


@pytest.mark.parametrize("name", ["pinn", "dsm", "posterior", "snf"])
def test_one_nccl_rank_captures_the_meshed_step(cuda, nccl_rank, name):
    """Over one NCCL rank the data-parallel engine captures its step (two
    graphs around the all-reduce, once) and gives, bit for bit, both its
    eager run and the meshless captured engine's."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = _engine_variants(name, cuda, nccl_rank)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert {k: c for k, (_, c) in runs.items()} == {"meshed": 1, "meshed_eager": 0, "meshless": 1}
    assert bool(torch.isfinite(runs["meshed"][0][2]).all())
    assert _equal_trees(runs["meshed"][0], runs["meshed_eager"][0])
    assert _equal_trees(runs["meshed"][0], runs["meshless"][0])


def test_meshed_engine_call_waits_for_nothing(cuda, nccl_rank):
    """A second call of the captured data-parallel engine over one NCCL rank
    raises nothing under the sync debug mode "error" (the all-reduce queued
    between the replays), replays the first call's graphs and repeats its
    numbers."""
    from dmip_tpu_torch import train

    loss_fn, p0, batch_fn = _graph_case("pinn", cuda)
    opt = train.build_optimizer(1e-3)
    fn = train.make_epoch_fn(loss_fn, opt, batch_fn, mesh=nccl_rank)
    s0 = opt.init(p0)
    first = fn(p0, s0, 3, 0)
    assert len(fn.graph.cuda_graphs) == 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = fn(p0, s0, 3, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fn.graph.captures == 1 and _equal_trees(first[:3], second[:3])


def _capturing_ranks(rank, address, out_dir):
    """One of two ranks on the host's cards: the data-parallel engine and
    the sharded ``vmap`` ensemble (K = 4, two trials a rank), each captured
    and with capture=False, saved with their capture counts."""
    from dmip_tpu_torch import ensemble, pytree, train
    from dmip_tpu_torch.parallel import get_mesh, init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    init_multihost(address, 2, rank)
    mesh = get_mesh()
    cpu = lambda tree: [t.cpu() for t in pytree.leaves(tree)]
    out = {"backend": mesh.backend, "step": {}, "vmap": {}}
    loss_fn, p0, batch_fn = _graph_case("pinn", mesh.device)
    opt = train.build_optimizer(1e-3, grad_clip=1.0)
    for capture in (True, False):
        fn = train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=2, mesh=mesh, capture=capture)
        out["step"][capture] = (cpu(fn(p0, opt.init(p0), 3, 0)[:3]), fn.graph.captures)
    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [64] * 3},
                                           {"xdim": 2, "ydim": 2})
    lams, lam2s, _ = ensemble.pad_trials([1.0, 0.1, 0.01, 0.001], [1.0, 0.1, 1.0, 0.1], 2, device=mesh.device)
    ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(1), 4, device=mesh.device)
    kw = {"initial_condition": LinearForwardProblem().score_posterior}
    for capture in (True, False):
        efn = ensemble.make_ensemble_epoch_fn(model, cfg, opt, batch_fn, 2, kw, mesh=mesh, capture=capture)
        out["vmap"][capture] = (cpu(efn(ens, ensemble.init_opt_state(opt, ens), 3, 0, lams, lam2s)[:3]),
                                efn.graph.captures)
    mesh.barrier()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_capturing_ranks(tmp_path_factory):
    """_capturing_ranks on two spawned ranks (gloo when they share a card)."""
    import torch.multiprocessing as mp

    from dmip_tpu_torch.parallel import local_address

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step has no CPU mode")
    root = tmp_path_factory.mktemp("capturing_ranks")
    mp.spawn(_capturing_ranks, args=(local_address(), str(root)), nprocs=2, join=True)
    return [torch.load(root / f"rank{r}.pt") for r in range(2)]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("engine", ["step", "vmap"])
def test_two_ranks_capture_what_they_ran_eagerly(two_capturing_ranks, engine):
    """On each of two ranks the data-parallel engine (two graphs around the
    all-reduce) and the sharded vmap ensemble (one graph, no collective
    inside) capture once and give their eager run bit for bit; the ranks
    agree bit for bit."""
    ranks = two_capturing_ranks
    if torch.cuda.device_count() == 1:
        assert all(r["backend"] == "gloo" for r in ranks)
    for r in ranks:
        (captured, n_captured), (eager, n_eager) = r[engine][True], r[engine][False]
        assert (n_captured, n_eager) == (1, 0) and _same(captured, eager)
        assert all(bool(torch.isfinite(t).all()) for t in captured)
    assert _same(ranks[0][engine][True][0], ranks[1][engine][True][0])


def test_fused_engine_replays_its_preparation(cuda):
    """The fused DSM engine's preparation captured as a CUDA graph (the
    default on the card) against capture=False on linear data, 6 batches
    of 100 and 3 epochs a call: the same (h0, eps, s1) bit for bit at two
    calls (the epochs' generators re-seeded between replays), one capture,
    the same params, state and losses from a call; a call raises nothing
    under the sync debug mode "error"."""
    from dmip_tpu_torch import data, pytree, train
    from dmip_tpu_torch.ops.dsm_train_kernel import make_fused_dsm_epoch_fn

    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, 600, torch.Generator().manual_seed(0), cuda)
    batch_fn = lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 100)
    model, _ = train.get_model_from_args({"model": "CDE", "loss_fn": "DSM", "hidden_layers": [64, 64]},
                                         {"xdim": 2, "ydim": 2})
    p0 = model.init(torch.Generator().manual_seed(1), device=cuda)
    opt = train.build_optimizer(1e-3)
    fns = {c: make_fused_dsm_epoch_fn(model, 1e-3, batch_fn, 3, capture=c) for c in (True, False)}
    for epoch0 in (0, 3):
        got = [t.clone() for t in fns[True].prepare(5, epoch0, cuda)]
        want = fns[False].prepare(5, epoch0, cuda)
        assert got[0].shape == (3, 6, 100, 5) and all(torch.equal(a, b) for a, b in zip(got, want))
    runs = {c: fn(p0, opt.init(p0), 5, 3) for c, fn in fns.items()}
    assert _equal_trees(runs[True][:3], runs[False][:3]) and fns[True].graph.captures == 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fns[True](p0, opt.init(p0), 5, 6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out[2]).all()) and fns[True].graph.captures == 1
    assert not torch.equal(out[2], runs[True][2])
    assert all(t.device.type == "cuda" for t in pytree.leaves(out[:2]))


def test_fit_waits_for_each_call_on_its_own_event(cuda):
    """fit reads a card engine's call one call late through an event
    recorded after its pinned copy: a traced fit of 3 calls of a stub
    engine waits 3 times on an event and never on the stream, and logs
    the stub's values."""
    from dmip_tpu_torch import train

    def epochs(params, opt_state, seed, epoch0, n_active):
        torch.cuda._sleep(1_000_000)  # the card busy ~0.5 ms, as a launch would keep it
        losses = torch.arange(epoch0, epoch0 + 2, dtype=torch.float32, device=cuda) + seed
        return params, opt_state, losses, {"A": -losses}

    class Log:
        values = []

        def scalar(self, tag, value, step):
            self.values.append((tag, value, step))

    train.fit(epochs, 0, None, 1, 6, epochs_per_call=2, log_every=0, opt_state=0)  # pinned blocks made
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("fit_span"):
            train.fit(epochs, 0, None, 1, 6, epochs_per_call=2, log_every=0, logger=Log(), opt_state=0)
    events = prof.events()
    span = next(e for e in events if e.name == "fit_span").time_range
    names = [e.name for e in events if e.name.startswith("cuda") and span.start <= e.time_range.start <= span.end]
    assert names.count("cudaEventSynchronize") == 3
    assert names.count("cudaStreamSynchronize") == 0 and names.count("cudaDeviceSynchronize") == 0
    assert Log.values == [(tag, float(e + 1) * (1 if tag == "Train/Loss" else -1), e)
                          for e in range(6) for tag in ("Train/Loss", "Train/A")]


def _equal_trees(a, b) -> bool:
    from dmip_tpu_torch import pytree

    la, lb = pytree.leaves(a), pytree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _seeded_b1(cuda, compute_dtype):
    tp = mlp_init(27, 3, (160, 128), generator=torch.Generator().manual_seed(3), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x0, y = torch.randn(700, 3, generator=gen, device=cuda), torch.randn(23, generator=gen, device=cuda)
    return lambda s: fused_em_sampler(tp, x0, y, 30, seed=s, compute_dtype=compute_dtype)


def _seeded_b4(cuda, compute_dtype):
    tp = mlp_init(27, 26, (128, 128), generator=torch.Generator().manual_seed(3), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x0, y = torch.randn(700, 3, generator=gen, device=cuda), 0.3 * torch.randn(23, generator=gen, device=cuda)
    return lambda s: fused_em_sampler_cdiffe(tp, x0, y, 30, seed=s, compute_dtype=compute_dtype)


def _seeded_b5(cuda, _):
    prior = mlp_init(4, 3, (128, 128), generator=torch.Generator().manual_seed(3), device=cuda)
    surr = mlp_init(3, 23, (64, 64), generator=torch.Generator().manual_seed(5), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x0, y = torch.randn(700, 3, generator=gen, device=cuda), torch.randn(23, generator=gen, device=cuda)
    return lambda s: fused_guided_em_sampler(prior, surr, x0, y, a=0.2, b=0.01, num_steps=30, seed=s)


@pytest.mark.parametrize("make,compute_dtype", [(_seeded_b1, torch.bfloat16), (_seeded_b1, torch.float32),
                                                (_seeded_b4, torch.bfloat16), (_seeded_b4, torch.float32),
                                                (_seeded_b5, None)],
                         ids=["B1", "B1_f32", "B4", "B4_f32", "B5"])
def test_a_seed_on_the_card_is_its_int(cuda, make, compute_dtype):
    """Each kernel reads a one-element int64 seed tensor on the card in
    place of the int it holds: the same samples bit for bit, another seed
    other samples; a seed tensor on the CPU or of int32 is refused."""
    run = make(cuda, compute_dtype)
    seed = 2**62 - 12345
    a = run(seed)
    assert torch.equal(a, run(torch.tensor([seed], device=cuda)))
    assert not torch.equal(a, run(torch.tensor([seed + 1], device=cuda)))
    for bad in (torch.tensor([seed]), torch.tensor([7], dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError, match="a tensor seed is one int64"):
            run(bad)


def _engine_linear(cuda):
    from dmip_tpu_torch import train

    prob = LinearForwardProblem()
    model, _ = train.get_model_from_args({"model": "CDE", "loss_fn": "DSM", "hidden_layers": [64, 64]},
                                         {"xdim": 2, "ydim": 2})
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    ys = prob.forward(torch.randn(3, 2, generator=torch.Generator().manual_seed(1)).to(cuda))
    return model, params, prob, ys


def test_a_chunk_queues_without_a_host_sync(cuda):
    """A linear chunk of 3 conditions and a scatterometry chunk of 2 (its
    GT staged in pinned memory inside the chunk), after a warm-up, queued
    under the sync debug mode "error": nothing raises; then the one read
    gives finite rows, equal to the warm-up's from the same seed."""
    from dmip_tpu_torch import evaluate

    model, params, prob, ys = _engine_linear(cuda)
    lin = evaluate.make_eval_many_linear(model, prob, 2000, 2, 20, nbins=30)
    smodel = CDE(3, 23, (64, 64))
    sparams = smodel.init(torch.Generator().manual_seed(2), device=cuda)
    fwd, fp = scat.load_forward_model(device=cuda)
    score = scat.score_posterior(fwd, fp["a"], fp["b"], fp["lambd_bd"])
    sys_ = fwd(torch.rand(2, 3, generator=torch.Generator().manual_seed(3)).to(cuda) - 0.5)
    gt = np.random.default_rng(0).uniform(-1, 1, size=(2, 2, 2500, 3)).astype(np.float32)
    sc = evaluate.make_eval_many_scatterometry(smodel, fwd, fp, score, 2000, 20, nbins=30)
    chunks = [lambda: lin(params, torch.Generator(device=cuda).manual_seed(5), ys),
              lambda: sc(sparams, torch.Generator(device=cuda).manual_seed(5), sys_,
                         evaluate.stage_ground_truth(lambda i, j: gt[i, j], range(2), 2, cuda))]
    for queue in chunks:
        want = evaluate.read_stats(queue())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = queue()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = evaluate.read_stats(out)
        assert got == want and np.all(np.isfinite(got))


def test_evaluate_linear_chunks_on_the_card_are_the_per_repeat_loop(cuda, tmp_path):
    """evaluate_linear(chunk=2) on 3 conditions through B1: results.csv's
    rows bit for bit the per-repeat loop's (the harness's body before the
    engine: a host read a condition, the mask-and-bincount histogram) from
    the same generator."""
    from dmip_tpu_torch import evaluate

    model, params, prob, ys = _engine_linear(cuda)
    n, repeats, steps, nbins, (lo, hi) = 2000, 2, 20, 30, (-3.5, 3.5)
    evaluate.evaluate_linear(model, params, prob, ys, torch.Generator(device=cuda).manual_seed(6),
                             out_dir=str(tmp_path), n_samples_x=n, n_repeats=repeats, num_steps=steps, nbins=nbins,
                             verbose=False, chunk=2)

    def hist(x):
        idx = torch.floor((x - lo) / ((hi - lo) / nbins)).to(torch.int64).clamp_(0, nbins - 1)
        in_range = torch.all((x >= lo) & (x <= hi), dim=-1)
        return torch.bincount((idx[:, 0] * nbins + idx[:, 1])[in_range], minlength=nbins**2)

    generator, want = torch.Generator(device=cuda).manual_seed(6), []
    for i in range(3):
        y = ys[i]
        hist_t = hist_p = 0
        stats = []
        for _ in range(repeats):
            x_pred = model.sample(params, y, n, steps, generator=generator, device=cuda)
            x_true = prob.sample_posterior(y, n, generator)
            w2 = evaluate.sliced_w2(x_pred, x_true, generator=generator)
            ys_tiled = y.expand(n, 2)
            mse = evaluate._score_mse(model, params, x_true, ys_tiled, prob.score_posterior(x_true, ys_tiled))
            hist_t, hist_p = hist_t + hist(x_true), hist_p + hist(x_pred)
            nll_t = -torch.mean(prob.posterior_log_prob(x_true, y))
            nll_p = -torch.mean(prob.posterior_log_prob(x_pred, y))
            stats.append(torch.stack([nll_t, nll_p, mse, w2]))
        kl, _ = evaluate.kl_pair(hist_t, hist_p)
        want.append([float(kl), *torch.stack(stats).mean(0).tolist()])
    with open(tmp_path / "results.csv") as f:
        got = [[float(v) for v in ln.strip().split(",")[1:]] for ln in list(f)[1:]]
    assert got == want


# --- the recorder on the card ---------------------------------------------------


@pytest.fixture
def recorder():
    """The recorder on and empty for one test; off and empty after it."""
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def _pinn_engine(cuda, epochs_per_call=2):
    from dmip_tpu_torch import train

    loss_fn, p0, batch_fn = _graph_case("pinn", cuda)
    opt = train.build_optimizer(1e-3)
    return train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=epochs_per_call), p0, opt


def test_recorder_times_each_replay_on_the_card(cuda, recorder):
    """One captured call of 2 epochs of 5 steps with the recorder on: a
    device span ``train.replay`` (and ``train.inputs``, ``train.draws``) a
    step, ``train.batches`` an epoch, ``train.call`` around them all on the
    card's timeline, each resolved to a positive card time; the capture
    counted the graph's kernels."""
    fn, p0, opt = _pinn_engine(cuda)
    fn(p0, opt.init(p0), 3, 0)
    torch.cuda.synchronize()
    rec = recorder.records()
    counts = {k: v["count"] for k, v in rec["device"].items()}
    assert counts == {"train.call": 1, "train.batches": 2, "train.draws": 10, "train.inputs": 10,
                      "train.replay": 10}
    assert rec["spans"]["train.capture"]["count"] == 1 and rec["pending"] == rec["dropped"] == 0
    (call,) = [r for r in rec["device_rows"] if r["name"] == "train.call"]
    for r in rec["device_rows"]:
        assert 0 <= r["end_ms"] - r["start_ms"] and call["start_ms"] <= r["start_ms"] <= r["end_ms"] <= call["end_ms"]
    assert all(r["end_ms"] > r["start_ms"] for r in rec["device_rows"] if r["name"] == "train.replay")
    assert recorder.counters()["graph_kernels"] > 0


# one replay of a captured 64-wide PINN step traced in a fresh process
_ONE_REPLAY = """
import collections, json, torch
from test_torch_cuda import _pinn_engine
from dmip_tpu_torch.utils import profiling

profiling.enable()
fn, p0, opt = _pinn_engine(torch.device("cuda"))
fn(p0, opt.init(p0), 3, 0, 1)
(graph,) = fn.graph.cuda_graphs
torch.cuda.synchronize()
with profiling.trace() as prof:
    graph.replay()
names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                            if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation())
print(json.dumps({"graph_kernels": profiling.counters()["graph_kernels"], "names": names}))
"""


def test_graph_kernels_is_cuptis_kernel_count_of_a_replay(cuda):
    """The kernel nodes counted at capture equal the kernels CUPTI records
    in one replay of the captured step, copies and sets left out: those
    CUPTI names ``Memcpy``/``Memset`` and ``memcpy32_post``, the CUDA
    kernel behind a graph's memcpy node.  In a fresh process: in one that
    had run the other card tests, CUPTI showed the same graph's 53 memcpy
    nodes as copies and 845 of its 848 kernels (H100, torch 2.11)."""
    import json
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    run = subprocess.run([sys.executable, "-c", _ONE_REPLAY], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600, check=True)
    got = json.loads(run.stdout.strip().splitlines()[-1])
    copies = {n: c for n, c in got["names"].items() if n.startswith(("Memcpy", "Memset", "memcpy32_post"))}
    kernels = sum(got["names"].values()) - sum(copies.values())
    print(f"graph_kernels {got['graph_kernels']}, CUPTI {kernels} kernels and {copies}")
    assert got["graph_kernels"] == kernels > 0


def test_recorder_on_waits_for_nothing_in_a_step_a_chunk_or_a_request(cuda, recorder):
    """With the recorder on, a warm captured call, a chunk of the evaluation
    engine and a posterior request through B1 raise nothing under the sync
    debug mode "error": events are recorded and queried, never waited for."""
    from dmip_tpu_torch import evaluate

    fn, p0, opt = _pinn_engine(cuda)
    s0 = opt.init(p0)
    model, params, prob, ys = _engine_linear(cuda)
    chunk = evaluate.make_eval_many_linear(model, prob, 2000, 2, 20, nbins=30)
    work = [lambda: fn(p0, s0, 3, 0),
            lambda: chunk(params, torch.Generator(device=cuda).manual_seed(5), ys),
            lambda: model.sample(params, ys[0], 2000, 20, generator=torch.Generator(device=cuda).manual_seed(6))]
    for run in work:
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rec = recorder.records()
    assert rec["spans"]["sample"]["count"] == 2 + 2 * 2 * 3  # the requests, and a sample a repeat in the chunks
    assert rec["spans"]["b1.pack"]["count"] == rec["spans"]["b1.launch"]["count"] == rec["spans"]["sample"]["count"]
    assert rec["device"]["train.replay"]["count"] == 20 and rec["pending"] == 0


def test_recorder_spans_a_guided_request(cuda, recorder):
    """One analytic-guidance request through B5: off, the recorder records
    nothing; on, ``sample``, ``sample.draws``, ``b5.pack`` and ``b5.launch``
    once each, and B5's launch count rises by one."""
    from dmip_tpu_torch.mains.eval_diffusion import analytic_row
    from dmip_tpu_torch.models import PosteriorDiffusionEstimator

    base = PosteriorDiffusionEstimator(xdim=3, ydim=23, hidden_layers=(64, 64))
    forward_model, fparams = scat.load_forward_model(device=cuda)
    guided, _ = analytic_row(base, forward_model, fparams, {"guidance_clip": 100.0})
    params = base.init(torch.Generator(device=cuda).manual_seed(3), device=cuda)
    y = forward_model(torch.tensor([[0.3, -0.5, 0.1]], device=cuda))[0]
    request = lambda: guided.sample(params, y, 500, 20, generator=torch.Generator(device=cuda).manual_seed(4))
    recorder.disable()
    request()
    assert recorder.records()["rows"] == []
    recorder.enable()
    before = fused_guided_em_sampler.launches
    request()
    torch.cuda.synchronize()
    rec = recorder.records()
    assert {n: v["count"] for n, v in rec["spans"].items()} == {"sample": 1, "sample.draws": 1, "b5.pack": 1,
                                                               "b5.launch": 1}
    assert rec["counters"]["fused_guided_em_sampler.launches"] == before + 1


def test_a_device_span_inside_a_capture_raises(cuda, recorder):
    """A timing event cannot be captured: the span says so before CUDA does."""
    x = torch.ones(4, device=cuda)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="inside a CUDA-graph capture"):
            with torch.cuda.graph(graph):
                with profiling.device_span("inside", cuda):
                    x.add_(1)
