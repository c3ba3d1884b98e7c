"""dmip_tpu_torch problems and data, held against dmip_tpu on shared points
(CPU, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dmip_tpu.problems import LinearForwardProblem as JLinear
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu_torch import data
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat


def _points(seed, n, d, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


def test_linear_forward_log_prob_and_score_match_jax():
    """rtol 1e-5: the same closed forms in f32 (2x2 inverse and Cholesky
    in place of JAX's logpdf factorization)."""
    jp, tp = JLinear(), LinearForwardProblem()
    x, y = _points(0, 256, 2), _points(1, 1, 2)[0]
    ys = np.broadcast_to(y, (256, 2)).copy()
    tx, ty, tys = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(ys)
    np.testing.assert_allclose(tp.forward(tx).numpy(), np.asarray(jp.forward(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(tp.posterior_log_prob(tx, ty).numpy(),
                               np.asarray(jp.posterior_log_prob(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.score_posterior(tx, tys).numpy(),
                               np.asarray(jp.score_posterior(jnp.asarray(x), jnp.asarray(ys))),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tp.posterior_moments(ty), jp.posterior_moments(jnp.asarray(y))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert tp.noise_std == jp.noise_std


def test_linear_sample_posterior_moments():
    """200k draws: mean within 0.01 and covariance within 0.01 of the
    analytic moments (standard errors ~0.002)."""
    tp = LinearForwardProblem()
    y = torch.tensor([0.7, -0.4])
    gen = torch.Generator().manual_seed(0)
    xs = tp.sample_posterior(y, 200_000, gen)
    mean, cov = JLinear().posterior_moments(jnp.asarray(y.numpy()))
    np.testing.assert_allclose(xs.mean(0).numpy(), np.asarray(mean), atol=0.01)
    np.testing.assert_allclose(torch.cov(xs.T).numpy(), np.asarray(cov), atol=0.01)


def test_scatterometry_energy_and_score_match_jax():
    """Energy and score through the committed surrogate on shared points.
    rtol 2e-5 on the energy: f32 sums of 23 terms scaled by 1/((a f)^2+b^2);
    the score adds the backward pass, held at rtol 2e-4 / atol 1e-2."""
    jfwd, jfp = jscat.load_forward_model()
    tfwd, tfp = scat.load_forward_model()
    assert jfp == tfp
    x = np.random.default_rng(2).uniform(-1.1, 1.1, size=(128, 3)).astype(np.float32)
    y = np.asarray(jscat.noisy_forward(jax.random.PRNGKey(0), jfwd, jnp.asarray(x[:1]), 0.2, 0.01))[0]
    ys = np.broadcast_to(y, (128, 23)).copy()
    np.testing.assert_allclose(tfwd(torch.from_numpy(x)).numpy(), np.asarray(jfwd(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    args = (tfp["a"], tfp["b"])
    e_t = scat.get_log_posterior(torch.from_numpy(x), tfwd, *args, torch.from_numpy(ys), tfp["lambd_bd"])
    e_j = jscat.get_log_posterior(jnp.asarray(x), jfwd, *args, jnp.asarray(ys), jfp["lambd_bd"])
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2e-5, atol=1e-3)
    s_t = scat.score_posterior(tfwd, *args, tfp["lambd_bd"])(torch.from_numpy(x), torch.from_numpy(ys))
    s_j = jscat.score_posterior(jfwd, *args, jfp["lambd_bd"])(jnp.asarray(x), jnp.asarray(ys))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-4, atol=1e-2)


def test_noisy_forward_and_dataset_shapes():
    fwd, fp = scat.load_forward_model()
    gen = torch.Generator().manual_seed(0)
    x, y = data.generate_dataset_scatterometry(fwd, fp["a"], fp["b"], size=4000, generator=gen)
    assert x.shape == (4000, 3) and y.shape == (4000, 23)
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    # residual / sqrt((a f)^2 + b^2) is standard normal
    f = fwd(x)
    z = (y - f) / torch.sqrt((fp["a"] * f) ** 2 + fp["b"] ** 2)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01


def test_linear_dataset_split_and_gt_loaders(tmp_path):
    tp = LinearForwardProblem()
    gen = torch.Generator().manual_seed(7)
    xs, ys = data.generate_dataset_linear(2, tp.forward, 1000, gen)
    x_tr, x_te, y_tr, y_te = data.train_test_split(xs, ys, 0.9, gen)
    assert (x_tr.shape[0], x_te.shape[0]) == (900, 100)
    torch.testing.assert_close(tp.forward(x_te), y_te)
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    (tmp_path / "1").mkdir()
    np.save(tmp_path / "1" / "2.npy", arr)
    np.testing.assert_array_equal(data.gt_loader(str(tmp_path))(1, 2), arr)
    cached = data.cached_gt_loader(str(tmp_path))
    assert cached(1, 2) is cached(1, 2)
    np.testing.assert_array_equal(cached(1, 2).numpy(), arr)
