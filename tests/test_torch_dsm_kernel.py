"""Fused DSM training epochs (kernel B3): the port's plain version against
the JAX Pallas kernel in interpret mode, and the port's fused epoch engine
against its autograd engine.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmip_tpu.nets import mlp_init
from dmip_tpu.ops.dsm_train_kernel import fused_dsm_train_epochs as jax_fused
from dmip_tpu_torch import data, train
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.ops.dsm_train_kernel import (
    dsm_train_epochs_reference,
    fused_dsm_train_epochs,
    make_fused_dsm_epoch_fn,
    pad_tree,
    padded_widths,
    unpad_tree,
)
from dmip_tpu_torch.problems import LinearForwardProblem

E, NB, IN, OUT, HID = 2, 3, 5, 2, (32, 32)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    jp = mlp_init(jax.random.PRNGKey(seed), IN, OUT, HID)
    p = [(np.asarray(w), np.asarray(b)) for w, b in jp]
    mu = [(1e-3 * rng.normal(size=w.shape).astype(np.float32), 1e-3 * rng.normal(size=b.shape).astype(np.float32))
          for w, b in p]
    nu = [(m * m, n * n) for m, n in mu]
    return rng, p, mu, nu


def _batches(rng, b_real, b_pad, nan_row):
    """(h0, eps, s1) of E x NB batches of b_pad rows, rows >= b_real padding
    (zero, s1 = 0) as the JAX wrapper pads them."""
    shape = (E * NB, b_pad)
    h0 = np.zeros(shape + (IN,), np.float32)
    eps = np.zeros(shape + (OUT,), np.float32)
    s1 = np.zeros(shape + (OUT,), np.float32)
    h0[:, :b_real] = rng.normal(size=(E * NB, b_real, IN))
    eps[:, :b_real] = rng.normal(size=(E * NB, b_real, OUT))
    s1[:, :b_real] = rng.uniform(0.1, 1.0, size=(E * NB, b_real, OUT))
    if nan_row:
        h0[1, 3, 1] = np.nan  # epoch 0, batch 1
    return [a.reshape(-1, a.shape[-1]) for a in (h0, eps, s1)]


def _jax(p, mu, nu, count, arrays, b_real, n_active, dtype, guard):
    tree = lambda t: tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in t)
    out = jax_fused(tree(p), tree(mu), tree(nu), jnp.int32(count), *map(jnp.asarray, arrays),
                    n_epochs=E, n_batches=NB, batch_real=b_real, lr=1e-3, n_active=jnp.int32(n_active),
                    compute_dtype=dtype, skip_nonfinite=guard, interpret=pltpu.InterpretParams())
    as_np = lambda t: [(np.asarray(w), np.asarray(b)) for w, b in t]
    return as_np(out[0]), as_np(out[1]), as_np(out[2]), int(out[3]), np.asarray(out[4])


def _max_rel(a, b):
    return max(float(np.abs(x.numpy() - y).max() / np.abs(y).max()) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


@pytest.mark.parametrize("dtype,guard,n_active,b_real,tol", [
    # f32: the same arithmetic; f32 sum order only
    (jnp.float32, True, 1, 16, 1e-5),
    (jnp.float32, False, 2, 13, 1e-5),
    # bf16: both round every product's operands to bf16 at the same places;
    # a sum-order difference can cross a bf16 rounding edge
    (jnp.bfloat16, "loss", 2, 16, 1e-3),
    (jnp.bfloat16, True, 2, 13, 1e-3),
])
def test_plain_matches_pallas_kernel_interpret(dtype, guard, n_active, b_real, tol):
    """n_active < n_epochs, a NaN row under both guards (not under 'off',
    which would poison the state), and batches of 13 real rows: the JAX
    kernel gets them padded to 16, the port gets them padded and unpadded,
    and the three agree."""
    rng, p, mu, nu = _state()
    nan_row = guard is not False
    arrays = _batches(rng, b_real, 16, nan_row)
    jp, jm, jv, jcount, jloss = _jax(p, mu, nu, 5, arrays, b_real, n_active, dtype, guard)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    args = (params_from_numpy(p), params_from_numpy(mu), params_from_numpy(nu), 5)
    kw = dict(n_epochs=E, n_batches=NB, batch_real=b_real, lr=1e-3, n_active=n_active, compute_dtype=tdt,
              skip_nonfinite=guard)
    out = dsm_train_epochs_reference(*args, *map(torch.from_numpy, arrays), **kw)
    assert int(out[3]) == jcount == 5 + n_active * NB - (1 if nan_row else 0)
    assert _max_rel(out[0], jp) < tol and _max_rel(out[1], jm) < tol and _max_rel(out[2], jv) < tol
    active = slice(0, n_active)
    np.testing.assert_allclose(out[4].numpy()[active], jloss[active], rtol=tol)
    if b_real < 16:
        unpadded = [torch.from_numpy(a.reshape(E * NB, 16, -1)[:, :b_real].reshape(-1, a.shape[-1]).copy())
                    for a in arrays]
        direct = dsm_train_epochs_reference(*args, *unpadded, **kw)
        for a, b in zip(direct[:3], out[:3]):
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(direct[4], out[4], rtol=1e-6, atol=0, equal_nan=True)


PAD_DIMS = [7, 40, 72, 3]  # widths that are not multiples of the kernel's 64-wide tiles


def _torch_state(dims, seed):
    g = torch.Generator().manual_seed(seed)
    p = tuple((0.3 * torch.randn(a, b, generator=g), 0.1 * torch.randn(b, generator=g))
              for a, b in zip(dims[:-1], dims[1:]))
    mu = tuple((1e-3 * torch.randn(w.shape, generator=g), 1e-3 * torch.randn(b.shape, generator=g)) for w, b in p)
    nu = tuple((m * m, n * n) for m, n in mu)
    return p, mu, nu


def test_padded_widths_and_round_trip():
    assert padded_widths(PAD_DIMS) == [7, 64, 128, 64]
    assert padded_widths([27, 512, 512, 512, 26]) == [27, 512, 512, 512, 64]
    p, _, _ = _torch_state(PAD_DIMS, 0)
    padded = pad_tree(p, padded_widths(PAD_DIMS))
    assert [tuple(w.shape) for w, _ in padded] == [(7, 64), (64, 128), (128, 64)]
    for (w, b), (wp, bp) in zip(p, unpad_tree(padded, PAD_DIMS)):
        assert torch.equal(w, wp) and torch.equal(b, bp)


@pytest.mark.parametrize("dtype,guard,n_active,nan_row", [
    (torch.float32, True, 2, False),
    (torch.float32, "loss", 2, True),
    (torch.float32, False, 1, False),
    (torch.bfloat16, True, 2, True),
])
def test_zero_padded_widths_give_the_unpadded_result(dtype, guard, n_active, nan_row):
    """The premise of the kernel's padding: the plain version on state
    zero-padded to whole 64-wide tiles (eps and s1 with zero columns) gives
    the unpadded result to 1e-6, and every padded entry of params and
    moments is still exactly 0 after 6 steps (under both guards the NaN
    step is skipped)."""
    p, mu, nu = _torch_state(PAD_DIMS, 1)
    wd = padded_widths(PAD_DIMS)
    g = torch.Generator().manual_seed(2)
    rows, out = 2 * 3 * 13, PAD_DIMS[-1]
    h0 = torch.randn(rows, PAD_DIMS[0], generator=g)
    if nan_row:
        h0[13 + 5, 2] = float("nan")  # epoch 0, batch 1
    eps = torch.randn(rows, out, generator=g)
    s1 = torch.rand(rows, out, generator=g)
    kw = dict(n_epochs=2, n_batches=3, batch_real=13, lr=1e-3, n_active=n_active, compute_dtype=dtype,
              skip_nonfinite=guard)
    ref = dsm_train_epochs_reference(p, mu, nu, 3, h0, eps, s1, **kw)
    zpad = lambda t: torch.nn.functional.pad(t, (0, wd[-1] - out))
    padded = dsm_train_epochs_reference(pad_tree(p, wd), pad_tree(mu, wd), pad_tree(nu, wd), 3, h0, zpad(eps),
                                        zpad(s1), **kw)
    assert int(padded[3]) == int(ref[3]) == 3 + 3 * n_active - nan_row
    for j in range(3):
        for (w, b), (wp, bp) in zip(ref[j], unpad_tree(padded[j], PAD_DIMS)):
            torch.testing.assert_close(wp, w, rtol=0, atol=1e-6)
            torch.testing.assert_close(bp, b, rtol=0, atol=1e-6)
        for full, zeroed in zip(padded[j], pad_tree(unpad_tree(padded[j], PAD_DIMS), wd)):
            assert torch.equal(full[0], zeroed[0]) and torch.equal(full[1], zeroed[1])
    torch.testing.assert_close(padded[4], ref[4], rtol=1e-6, atol=0, equal_nan=True)


def test_cpu_wrapper_runs_plain_version_and_checks_arguments():
    rng, p, mu, nu = _state(1)
    arrays = [torch.from_numpy(a) for a in _batches(rng, 16, 16, False)]
    args = (params_from_numpy(p), params_from_numpy(mu), params_from_numpy(nu), 0)
    kw = dict(n_epochs=E, n_batches=NB, batch_real=16, lr=1e-3, n_active=E)
    before = fused_dsm_train_epochs.launches
    out = fused_dsm_train_epochs(*args, *arrays, **kw)
    ref = dsm_train_epochs_reference(*args, *arrays, **kw)
    assert fused_dsm_train_epochs.launches == before
    for a, b in zip(out[:3], ref[:3]):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="batches"):
        fused_dsm_train_epochs(*args, arrays[0][:-1], arrays[1][:-1], arrays[2][:-1], **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_dsm_train_epochs(*args, *arrays, compute_dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="skip_nonfinite"):
        fused_dsm_train_epochs(*args, *arrays, skip_nonfinite="grads", **kw)
    with pytest.raises(ValueError, match="stamps"):
        fused_dsm_train_epochs(*args, *arrays, stamps=torch.zeros(100, dtype=torch.int64), **kw)


def test_fused_engine_matches_autograd_engine_f32():
    """Same model, batches, t and eps (the fused engine replays the autograd
    engine's draws): after 2 epochs of 3 steps the params agree to f32
    reassociation (1e-5; Adam moves a weight by ~lr = 1e-3 per step), the
    counts exactly, and so does a masked last epoch."""
    prob = LinearForwardProblem()
    gen = torch.Generator().manual_seed(0)
    xs, ys = data.generate_dataset_linear(2, prob.forward, 48, gen)
    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "DSM", "hidden_layers": [32, 32]},
                                           {"xdim": 2, "ydim": 2})
    batch_fn = lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 16)
    opt = train.build_optimizer(1e-3)
    params = model.init(torch.Generator().manual_seed(1))
    ref_fn = train.make_epoch_fn(model.make_loss_fn(cfg), opt, batch_fn, epochs_per_call=2)
    fused_fn = make_fused_dsm_epoch_fn(model, 1e-3, batch_fn, epochs_per_call=2, compute_dtype=torch.float32)
    for n_active in (2, 1):
        p1, o1, l1, _ = ref_fn(params, opt.init(params), 9, 4, n_active)
        p2, o2, l2, _ = fused_fn(params, opt.init(params), 9, 4, n_active)
        assert int(o1.count) == int(o2.count) == 3 * n_active
        err = max(float((x - y).abs().max()) for a, b in zip(p1, p2) for x, y in zip(a, b))
        assert err < 1e-5
        np.testing.assert_allclose(l1[:n_active].numpy(), l2[:n_active].numpy(), rtol=1e-5)
