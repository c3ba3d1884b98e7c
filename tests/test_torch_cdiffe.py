"""The CDiffE slice: the port's ``euler_maruyama_cdiffe``, the fused CDiffE
sampler's plain version (kernel B4) and the ``CDiffE`` model against
dmip_tpu on the same inputs, and CDiffE training through the fused DSM
engine.  The CUDA kernel itself is held against its plain version in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmip_tpu import train as jtrain
from dmip_tpu.nets import mlp_init, score_mlp_apply
from dmip_tpu.ops.em_kernel import fused_em_sampler_cdiffe as jax_fused_cdiffe
from dmip_tpu.samplers import euler_maruyama_cdiffe as jax_em_cdiffe
from dmip_tpu.sde import ReverseSDE as JReverseSDE
from dmip_tpu.sde import sample_t as jax_sample_t
from dmip_tpu_torch import data, nets, samplers, sde, train
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.models import CDiffE, PosteriorDiffusionEstimator
from dmip_tpu_torch.ops.dsm_train_kernel import make_fused_dsm_epoch_fn
from dmip_tpu_torch.ops.em_kernel import em_cdiffe_reference, fused_em_sampler_cdiffe
from dmip_tpu_torch.problems import LinearForwardProblem


def _net(hidden=(64, 64), xdim=2, ydim=2, seed=0):
    """A joint CDiffE net [x, y, t] -> xdim + ydim, in both packages."""
    jp = mlp_init(jax.random.PRNGKey(seed), xdim + ydim + 1, xdim + ydim, hidden)
    return jp, params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("dtype,tol", [
    # f32: the same arithmetic; the kernel's first-layer bias is s w1t + b1
    # taken together, the TPU kernel adds them one by one, so f32 rounding
    (jnp.float32, 1e-4),
    # bf16: both round [x, y_t] and every activation to bf16; an f32 sum
    # order difference can put a value on the other side of a rounding edge
    (jnp.bfloat16, 1e-3),
])
def test_plain_matches_pallas_kernel_interpret(dtype, tol):
    """Noise off (the Pallas interpreter's PRNG returns zero bits, so its
    noise would be a constant), 512 rows in blocks of 256, 40 steps."""
    jp, tp = _net()
    y = np.array([0.8, -0.3], np.float32)
    x0 = np.random.default_rng(0).normal(size=(512, 2)).astype(np.float32)
    ref = np.asarray(jax_fused_cdiffe(
        jp, jnp.asarray(x0), jnp.asarray(y), 2, num_steps=40, seed=7, block_rows=256,
        compute_dtype=dtype, noise_scale=0.0, interpret=pltpu.InterpretParams()))
    out = em_cdiffe_reference(
        tp, torch.from_numpy(x0), torch.from_numpy(y), 40, noise_scale=0.0,
        compute_dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    assert _rel(out.numpy(), ref) < tol


def test_plain_with_injected_noise_matches_euler_maruyama_cdiffe():
    """One (steps, N, xdim + ydim) block per step, as the kernel draws it,
    fed to the kernel's plain version (f32) and to the CDiffE sampler as
    both its integrator and its y draws: the same trajectory to f32
    rounding (rel 1e-5; the plain version splits the first layer)."""
    _, tp = _net(xdim=3, ydim=4, seed=1)
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=4).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(25, 128, 7)).astype(np.float32))
    out = em_cdiffe_reference(tp, x0, y, 25, lmbd=0.3, compute_dtype=torch.float32, noise=noise)
    ref = samplers.euler_maruyama_cdiffe(
        sde.ReverseSDE(), lambda z, c, s: nets.score_mlp_apply(tp, z, c, s), y, 128, 3, 25, lmbd=0.3,
        x0=x0, noise=noise, y_eps=noise)
    assert _rel(out.numpy(), ref.numpy()) < 1e-5
    before = fused_em_sampler_cdiffe.launches
    torch.testing.assert_close(fused_em_sampler_cdiffe(tp, x0, y, 25, lmbd=0.3, compute_dtype=torch.float32,
                                                       noise=noise), out, rtol=0, atol=0)
    assert fused_em_sampler_cdiffe.launches == before


@pytest.mark.parametrize("y_noise,noise_scale", [("fresh", 0.0), ("fresh", 1.0), ("shared", 1.0), ("mean", 1.0)])
def test_euler_maruyama_cdiffe_matches_jax(y_noise, noise_scale):
    """The JAX sampler's x0, y draws and integrator draws, rebuilt from its
    key schedule and fed to the port: f32 trajectories agree to rel 1e-4."""
    jp, tp = _net(seed=2)
    y = np.array([0.1, 0.5], np.float32)
    key = jax.random.PRNGKey(3)
    n, steps, width = 256, 30, 4
    ref = np.asarray(jax_em_cdiffe(
        JReverseSDE(), lambda z, c, s: score_mlp_apply(jp, z, c, s), key, jnp.asarray(y), n, 2, steps,
        noise_scale=noise_scale, y_noise=y_noise))
    k0, kdiff, kscan = jax.random.split(key, 3)
    x0 = np.array(jax.random.normal(k0, (n, 2)))
    draws = lambda k: np.stack([np.array(jax.random.normal(kk, (n, width))) for kk in jax.random.split(k, steps)])
    y_eps = np.array(jax.random.normal(kdiff, (n, width))) if y_noise == "shared" else draws(kdiff)
    out = samplers.euler_maruyama_cdiffe(
        sde.ReverseSDE(), lambda z, c, s: nets.score_mlp_apply(tp, z, c, s), torch.from_numpy(y), n, 2, steps,
        noise_scale=noise_scale, y_noise=y_noise, x0=torch.from_numpy(x0), noise=torch.from_numpy(draws(kscan)),
        y_eps=torch.from_numpy(y_eps))
    assert _rel(out.numpy(), ref) < 1e-4


@pytest.mark.parametrize("loss_fn", ["DSM", "PINNLoss"])
def test_cdiffe_loss_matches_jax(loss_fn):
    """The CDiffE loss on the same params, x, y, t and eps (the JAX loss's
    draws rebuilt from its key): value and parameter gradients to f32
    rounding (rel 2e-5, as the CDE losses are held)."""
    config = {"model": "CDiffE", "loss_fn": loss_fn, "hidden_layers": [32, 32], "lam": 0.3, "lam2": 0.7}
    dims = {"xdim": 2, "ydim": 2}
    ic = LinearForwardProblem().score_posterior
    jmodel, jcfg = jtrain.get_model_from_args(config, dims)
    from dmip_tpu.problems import LinearForwardProblem as JLinear

    jloss = jmodel.make_loss_fn(jcfg, initial_condition=JLinear().score_posterior)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, 2)).astype(np.float32)
    y = rng.normal(size=(16, 2)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jp = jmodel.init(jax.random.PRNGKey(3))
    # one jit compiles faster than eager op-by-op dispatch
    (jval, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp, key, jnp.asarray(x), jnp.asarray(y))
    kt, keps, _ = jax.random.split(key, 3)
    t = np.array(jax_sample_t(jmodel.sde, kt, 16))
    eps = np.array(jax.random.normal(keps, (16, 4)))

    model, cfg = train.get_model_from_args(config, dims)
    assert isinstance(model, CDiffE) and model.net_in == 5 and model.net_out == 4
    params = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])
    leaves = [p.requires_grad_(True) for pair in params for p in pair]
    val, _ = model.make_loss_fn(cfg, initial_condition=ic)(
        params, None, torch.from_numpy(x), torch.from_numpy(y), t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    grads = torch.autograd.grad(val, leaves)
    assert _rel(np.array(val.item()), np.array(float(jval))) < 2e-5
    for g, h in zip(grads, [g for pair in jgrads for g in pair]):
        assert _rel(g.numpy(), np.asarray(h)) < 2e-5


def test_get_model_from_args_builds_cdiffe_and_posterior():
    dims = {"xdim": 3, "ydim": 23}
    model, cfg = train.get_model_from_args({"model": "CDiffE", "loss_fn": "DSM"}, dims)
    assert isinstance(model, CDiffE) and (model.net_in, model.net_out) == (27, 26) and cfg.name == "DSM"
    post, cfg = train.get_model_from_args({"model": "Posterior", "lam": 1.0}, dims)
    assert isinstance(post, PosteriorDiffusionEstimator) and cfg.name == "PosteriorLoss" and cfg.lam == 1.0
    params = post.init(torch.Generator().manual_seed(0))
    assert params["prior"][0][0].shape == (4, 512) and params["likelihood"][0][0].shape == (27, 512)
    with pytest.raises(ValueError, match="PosteriorLoss"):
        train.get_model_from_args({"model": "Posterior", "loss_fn": "DSM"}, dims)
    with pytest.raises(NotImplementedError, match="item 11"):
        post.make_loss_fn(cfg)
    with pytest.raises(ValueError, match="model"):
        train.get_model_from_args({"model": "CDiffE2", "loss_fn": "DSM"}, dims)


def test_cdiffe_sample_on_cpu_takes_plain_sampler():
    model = CDiffE(xdim=2, ydim=2, hidden_layers=(32,))
    params = model.init(torch.Generator().manual_seed(0))
    y = torch.tensor([0.3, -0.2])
    a = model.sample(params, y, 64, 5, generator=torch.Generator().manual_seed(1))
    b = samplers.euler_maruyama_cdiffe(model.sde, lambda z, c, s: model.apply_a(params, z, c, s), y, 64, 2, 5,
                                       generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = fused_em_sampler_cdiffe.launches
    k = model.sample(params, y, 64, 5, generator=torch.Generator().manual_seed(1), method="kernel")
    assert k.shape == (64, 2) and torch.isfinite(k).all() and fused_em_sampler_cdiffe.launches == before
    with pytest.raises(ValueError, match="unsupported"):
        model.sample(params, y, 64, 5, method="heun")


def test_fused_engine_trains_cdiffe_like_the_autograd_engine():
    """select_epoch_fn(model: CDiffE, train_backend: fused_pallas) runs B3's
    plain version on the CPU on the joint state [x, y] -> 26-wide targets;
    one epoch of 3 steps from the same seed gives the autograd engine's
    loss (bf16 products: rel 1e-2) and, with f32 products, its params
    (1e-5, an Adam step moves a weight by ~lr = 1e-3) and loss (1e-5)."""
    prob = LinearForwardProblem()
    gen = torch.Generator().manual_seed(0)
    xs, ys = data.generate_dataset_linear(2, prob.forward, 48, gen)
    config = {"model": "CDiffE", "loss_fn": "DSM", "hidden_layers": [32, 32], "train_backend": "fused_pallas",
              "lr": 1e-3}
    model, cfg = train.get_model_from_args(config, {"xdim": 2, "ydim": 2})
    batch_fn = lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 16)
    opt = train.build_optimizer(1e-3)
    params = model.init(torch.Generator().manual_seed(1))
    ref_fn = train.make_epoch_fn(model.make_loss_fn(cfg), opt, batch_fn, epochs_per_call=1)
    p1, o1, l1, _ = ref_fn(params, opt.init(params), 9, 4, 1)
    fused_fn = train.select_epoch_fn(config, model, model.make_loss_fn(cfg), opt, batch_fn, 1)
    p2, o2, l2, _ = fused_fn(params, opt.init(params), 9, 4, 1)
    assert int(o1.count) == int(o2.count) == 3
    assert abs(l2.item() - l1.item()) / l1.item() < 1e-2
    f32_fn = make_fused_dsm_epoch_fn(model, 1e-3, batch_fn, epochs_per_call=1, compute_dtype=torch.float32)
    p3, _, l3, _ = f32_fn(params, opt.init(params), 9, 4, 1)
    assert max(float((x - y).abs().max()) for a, b in zip(p1, p3) for x, y in zip(a, b)) < 1e-5
    assert abs(l3.item() - l1.item()) / l1.item() < 1e-5
