"""The plain reference against the program's plain paths at small sizes,
and its independence from the program."""

import subprocess
import sys

import pytest
import torch

from portbench import common
from portbench.reference import linear as rl, mlp, philox, scatterometry as rs, training as rt
from portbench.reference.precision import CONTROL, REFERENCE


@pytest.mark.parametrize("ctr,key,out", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, out):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = philox.philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
    assert tuple(int(w) for w in got) == out


def test_sampler_normals_layout():
    """Normal d of row r at step i from counter (r, i, d // 2, 0): words 0, 1
    for even d, 2, 3 for odd d."""
    seed = 0x1234_5678_9ABC_DEF0
    z = philox.sampler_normals(seed, 5, 3, 7, 9, "cpu")
    w = philox.philox4x32_10(*[torch.tensor([v], dtype=torch.int64) for v in (4, 8, 1, 0)],
                             seed & 0xFFFFFFFF, seed >> 32)
    assert z.shape == (2, 5, 3)
    assert torch.equal(z[1, 4, 2], philox._normal(w[0], w[1])[0])
    assert torch.isfinite(z).all() and abs(float(z.mean())) < 1.5


def test_sampler_against_the_programs_plain_sampler():
    from dmip_tpu_torch.ops.em_kernel import em_sampler_reference

    g = torch.Generator().manual_seed(3)
    params = common.mlp_weights(g, [7, 64, 64, 64, 3])
    x0, y = torch.randn(256, 3, generator=g), torch.randn(3, generator=g)
    noise = torch.randn(30, 256, 3, generator=g)
    prog = em_sampler_reference(params, x0, y, 30, compute_dtype=torch.float32, noise=noise)
    ref = mlp.sample(params, x0, y, 30, 0, REFERENCE, noise_fn=lambda a, b: noise[a:b])
    assert torch.allclose(prog, ref, rtol=1e-4, atol=1e-4)
    bf16 = em_sampler_reference(params, x0, y, 30, compute_dtype=torch.bfloat16, noise=noise)
    ctrl = mlp.sample(params, x0, y, 30, 0, CONTROL, noise_fn=lambda a, b: noise[a:b])
    gap = lambda a: float((a - ref).pow(2).mean().sqrt())
    assert gap(ctrl) > 4 * gap(bf16) > 0  # fp8 products lie well outside bf16's rounding


def test_linear_statistics_against_the_program():
    from dmip_tpu_torch import evaluate
    from dmip_tpu_torch.problems.linear import LinearForwardProblem

    g = torch.Generator().manual_seed(4)
    x, z = 1.5 * torch.randn(4000, 2, generator=g), torch.randn(4000, 2, generator=g)
    x[0] = 3.5  # on the upper edge
    y = torch.tensor([0.4, -0.2])
    assert torch.equal(rl.histogram(x, 75, -3.5, 3.5), evaluate.histogramdd_flat(x, 75, -3.5, 3.5))
    ht, hm = rl.histogram(z, 75, -3.5, 3.5), rl.histogram(x, 75, -3.5, 3.5)
    kl = evaluate.kl_pair(ht, hm)
    assert rl.kl_pair(ht, hm) == pytest.approx((float(kl[0]), float(kl[1])), rel=1e-5)
    dirs = torch.randn(128, 2, generator=g)
    assert rl.sliced_w2(x, z, dirs) == pytest.approx(float(evaluate.sliced_w2(x, z, dirs=dirs)), rel=1e-5)
    prob = LinearForwardProblem()
    assert torch.allclose(rl.log_prob(x, y), prob.posterior_log_prob(x, y), rtol=1e-5, atol=1e-5)
    assert torch.allclose(rl.score_true(x, y.expand(4000, 2)), prob.score_posterior(x, y.expand(4000, 2)), atol=1e-5)
    assert torch.allclose(rl.posterior_mean(y), prob.posterior_moments(y)[0], atol=1e-6)


def test_surrogate_and_energy_against_the_program():
    from dmip_tpu_torch.problems import scatterometry as scat

    fwd, fp = scat.load_forward_model()
    w = rs.surrogate(common.ROOT, torch.device("cpu"))
    x = 0.9 * (2 * torch.rand(64, 3, generator=torch.Generator().manual_seed(5)) - 1)
    assert torch.allclose(rs.forward(w, x), fwd(x), atol=1e-5)
    y = fwd(x)
    score = scat.score_posterior(fwd, fp["a"], fp["b"], fp["lambd_bd"])
    assert torch.allclose(rs.score_true(w, x, y), score(x, y), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_pinn_loss_and_gradient_against_the_program(problem):
    from dmip_tpu_torch.models.diffusion import CDE, LossConfig
    from dmip_tpu_torch.problems import scatterometry as scat
    from dmip_tpu_torch.problems.linear import LinearForwardProblem

    g = torch.Generator().manual_seed(6)
    if problem == "linear":
        xdim, ydim, ic_ref, ic_prog, lam, lam2 = 2, 2, rl.score_true, LinearForwardProblem().score_posterior, 1e-3, 0.1
    else:
        fwd, fp = scat.load_forward_model()
        w = rs.surrogate(common.ROOT, torch.device("cpu"))
        xdim, ydim, lam, lam2 = 3, 23, 1e-2, 1e-3
        ic_ref = lambda a, b: rs.score_true(w, a, b)
        ic_prog = scat.score_posterior(fwd, fp["a"], fp["b"], fp["lambd_bd"])
    params = common.mlp_weights(g, [xdim + ydim + 1, 48, 48, 48, xdim])
    x, y = torch.rand(64, xdim, generator=g) * 2 - 1, torch.randn(64, ydim, generator=g)
    t, eps = rt.batch_draws(g, 64, xdim)
    loss_fn = CDE(xdim, ydim, (48, 48, 48)).make_loss_fn(LossConfig("PINNLoss", lam, lam2, "FPE", "L1", "L2"),
                                                          initial_condition=ic_prog)
    leaves = [p.clone().requires_grad_(True) for wb in params for p in wb]
    tree = tuple(zip(leaves[0::2], leaves[1::2]))
    lp, ip = loss_fn(tree, None, x, y, t=t, eps=eps)
    lr, ir = rt.pinn_loss(tree, x, y, t, eps, ic_ref, lam, lam2)
    assert float(lp) == pytest.approx(float(lr), rel=1e-5)
    for k in ir:
        assert float(ip[k]) == pytest.approx(float(ir[k]), rel=1e-4)
    for a, b in zip(torch.autograd.grad(lp, leaves), torch.autograd.grad(lr, leaves)):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-6)


def test_draws_follow_the_programs_order():
    """The t sampler and the epoch generator's seed, as the engine draws them."""
    from dmip_tpu_torch import train
    from dmip_tpu_torch.models.diffusion import CDE, LossConfig

    assert rt.epoch_seed(2**31 + 5, 3, "cpu") == train.epoch_seed(2**31 + 5, 3, "cpu")
    assert rt.epoch_seed(2**31 + 5, 3, "cuda") == train.epoch_seed(2**31 + 5, 3, "cuda")
    model = CDE(3, 23, (8, 8, 8))
    x, y = torch.zeros(50, 3), torch.zeros(50, 23)
    t, eps, _ = model.loss_draws(LossConfig("PINNLoss"), torch.Generator().manual_seed(7), x, y)
    t_ref, eps_ref = rt.batch_draws(torch.Generator().manual_seed(7), 50, 3)
    assert torch.equal(t, t_ref) and torch.equal(eps, eps_ref)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.linear, portbench.reference.mlp, portbench.reference.philox,"
            " portbench.reference.scatterometry, portbench.reference.training, portbench.reference.precision;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('dmip_tpu_torch', 'dmip_tpu', 'jax', 'jaxlib')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
