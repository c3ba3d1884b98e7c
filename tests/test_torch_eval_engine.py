"""The evaluation engine (``make_eval_y_*``, ``make_eval_many_*``) on the
CPU: the scatterometry repeat against the JAX package's on the same ground
truth, a chunk against its conditions one by one, both harnesses against a
per-repeat loop (the loop the harnesses ran before the engine) bit for bit,
the histogram's edges, and the samplers' seed as a tensor.  The engine on
the card (no host sync inside a chunk) is in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmip_tpu import evaluate as jeval
from dmip_tpu import train as jtrain
from dmip_tpu.problems import scatterometry as jscat
from dmip_tpu_torch import evaluate, train
from dmip_tpu_torch.checkpoints import params_from_numpy
from dmip_tpu_torch.models import CDE
from dmip_tpu_torch.models.diffusion import _kernel_draws
from dmip_tpu_torch.nets import mlp_init
from dmip_tpu_torch.ops import build
from dmip_tpu_torch.ops.dps_kernel import fused_guided_em_sampler
from dmip_tpu_torch.ops.em_kernel import fused_em_sampler, fused_em_sampler_cdiffe
from dmip_tpu_torch.parallel import mesh as pmesh
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat

N_X, REPEATS, STEPS, NBINS = 512, 2, 10, 20
SMALL = dict(n_samples_x=N_X, n_repeats=REPEATS, num_steps=STEPS, nbins=NBINS)
FP = {"a": 0.2, "b": 0.01, "lambd_bd": 1000.0}


def _bincount_hist(x, nbins, lo, hi):
    """The histogram the harnesses used before the engine: a boolean mask
    and ``bincount``."""
    d = x.shape[-1]
    idx = torch.floor((x - lo) / ((hi - lo) / nbins)).to(torch.int64).clamp_(0, nbins - 1)
    in_range = torch.all((x >= lo) & (x <= hi), dim=-1)
    flat = torch.zeros(x.shape[0], dtype=torch.int64)
    for i in range(d):
        flat = flat * nbins + idx[..., i]
    return torch.bincount(flat[in_range], minlength=nbins**d)


def _generators(n, generator, mesh):
    """Condition i's generator as the harnesses walk: the caller's one
    stream, or with a mesh one seeded by fold_in(seed, i)."""
    if mesh is None:
        return [generator] * n
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return [torch.Generator().manual_seed(pmesh.fold_in(seed, i)) for i in range(n)]


def _linear_reference(model, params, prob, ys, gens, xlim=(-3.5, 3.5)):
    """results.csv's columns by the per-repeat loop."""
    lo, hi = xlim
    cols = {"KL2": [], "NLL_true": [], "NLL_diffusion": [], "MSE": [], "W2": []}
    for i in range(ys.shape[0]):
        y, generator = ys[i], gens[i]
        hist_t = hist_p = 0
        stats = []
        for _ in range(REPEATS):
            x_pred = model.sample(params, y, N_X, STEPS, generator=generator, device=ys.device)
            x_true = prob.sample_posterior(y, N_X, generator)
            w2 = evaluate.sliced_w2(x_pred, x_true, generator=generator)
            ys_tiled = y.expand(N_X, y.shape[-1])
            mse = evaluate._score_mse(model, params, x_true, ys_tiled, prob.score_posterior(x_true, ys_tiled))
            hist_t = hist_t + _bincount_hist(x_true, NBINS, lo, hi)
            hist_p = hist_p + _bincount_hist(x_pred, NBINS, lo, hi)
            nll_t = -torch.mean(prob.posterior_log_prob(x_true, y))
            nll_p = -torch.mean(prob.posterior_log_prob(x_pred, y))
            stats.append(torch.stack([nll_t, nll_p, mse, w2]))
        kl, _ = evaluate.kl_pair(hist_t, hist_p)
        nll_t, nll_p, mse, w2 = torch.stack(stats).mean(0).tolist()
        for k, v in zip(cols, (float(kl), nll_t, nll_p, mse, w2)):
            cols[k].append(v)
    return cols


def _scat_reference(model, params, fwd, score, ys, gt_loader, gens, xlim=(-1.2, 1.2)):
    lo, hi = xlim
    cols = {"KL2": [], "KL_reverse": [], "NLL_mcmc": [], "NLL_diffusion": [], "MSE": [], "W2": []}
    for i in range(ys.shape[0]):
        y, generator = ys[i], gens[i]

        def energy(x):
            return scat.get_log_posterior(x, fwd, FP["a"], FP["b"], y.expand(x.shape[0], -1), FP["lambd_bd"])

        hist_t = hist_p = 0
        stats = []
        for j in range(REPEATS):
            x_true = torch.as_tensor(gt_loader(i, j), dtype=torch.float32)
            x_pred = model.sample(params, y, N_X, STEPS, generator=generator, device=ys.device)
            n_w2 = min(N_X, x_true.shape[0])
            w2 = evaluate.sliced_w2(x_pred[:n_w2], x_true[:n_w2], generator=generator)
            ys_true = y.expand(x_true.shape[0], -1)
            mse = evaluate._score_mse(model, params, x_true, ys_true, score(x_true, ys_true))
            hist_t = hist_t + _bincount_hist(x_true, NBINS, lo, hi)
            hist_p = hist_p + _bincount_hist(x_pred, NBINS, lo, hi)
            stats.append(torch.stack([torch.mean(energy(x_true)), torch.mean(energy(x_pred)), mse, w2]))
        kl, kl_rev = evaluate.kl_pair(hist_t, hist_p)
        nll_t, nll_p, mse, w2 = torch.stack(stats).mean(0).tolist()
        for k, v in zip(cols, (float(kl), float(kl_rev), nll_t, nll_p, mse, w2)):
            cols[k].append(v)
    return cols


def _linear_case():
    prob = LinearForwardProblem()
    model = CDE(2, 2, (16, 16))
    params = model.init(torch.Generator().manual_seed(0))
    ys = prob.forward(torch.randn(3, 2, generator=torch.Generator().manual_seed(1)))
    return model, params, prob, ys


def _scat_case():
    model = CDE(3, 4, (16, 16))
    params = model.init(torch.Generator().manual_seed(0))
    w = 0.3 * torch.randn(3, 4, generator=torch.Generator().manual_seed(3))
    fwd = lambda x: torch.tanh(x @ w)
    score = scat.score_posterior(fwd, FP["a"], FP["b"], FP["lambd_bd"])
    ys = fwd(torch.rand(3, 3, generator=torch.Generator().manual_seed(1)) * 1.6 - 0.8)
    # 600 GT samples a repeat against 512 drawn: W2 cuts both to 512
    gt = np.random.default_rng(0).uniform(-1.1, 1.1, size=(3, REPEATS, 600, 3)).astype(np.float32)
    return model, params, fwd, score, ys, lambda i, j: gt[i, j]


def _csv(out_dir):
    return (out_dir / "results.csv").read_bytes()


@pytest.fixture
def mesh_of_one():
    """A world of one gloo rank in this process, torn down after the test."""
    assert pmesh.init_multihost(pmesh.local_address(), 1, 0, device="cpu")
    try:
        yield pmesh.get_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(params=["no_chunk", "chunk_2", "mesh_of_one"])
def walk(request):
    """(chunk, mesh) of each way the harnesses walk the conditions."""
    if request.param == "mesh_of_one":
        yield None, request.getfixturevalue("mesh_of_one")
    else:
        yield (None if request.param == "no_chunk" else 2), None


def test_evaluate_linear_is_the_per_repeat_loop(walk, tmp_path):
    """results.csv and the metrics of evaluate_linear, bit for bit those of
    the per-repeat loop on the same generators: with no chunk, chunks of 2
    (3 conditions: 2 + 1) and a mesh of one rank."""
    chunk, mesh = walk
    model, params, prob, ys = _linear_case()
    m = evaluate.evaluate_linear(model, params, prob, ys, torch.Generator().manual_seed(2), out_dir=str(tmp_path / "e"),
                                 verbose=False, chunk=chunk, mesh=mesh, **SMALL)
    cols = _linear_reference(model, params, prob, ys, _generators(3, torch.Generator().manual_seed(2), mesh))
    evaluate._write_results_csv(str(tmp_path / "ref" / "results.csv"), cols)
    assert _csv(tmp_path / "e") == _csv(tmp_path / "ref")
    nlpd = np.abs(np.asarray(cols["NLL_true"]) - np.asarray(cols["NLL_diffusion"]))
    assert m == (float(np.mean(cols["KL2"])), float(nlpd.mean()), float(np.mean(cols["MSE"])))


def test_evaluate_scatterometry_is_the_per_repeat_loop(walk, tmp_path):
    """As the linear case, against ground truth of 600 samples a repeat."""
    chunk, mesh = walk
    model, params, fwd, score, ys, gt_loader = _scat_case()
    m = evaluate.evaluate_scatterometry(model, params, fwd, FP, score, ys, gt_loader, torch.Generator().manual_seed(2),
                                        out_dir=str(tmp_path / "e"), verbose=False, chunk=chunk, mesh=mesh, **SMALL)
    cols = _scat_reference(model, params, fwd, score, ys, gt_loader,
                           _generators(3, torch.Generator().manual_seed(2), mesh))
    evaluate._write_results_csv(str(tmp_path / "ref" / "results.csv"), cols)
    assert _csv(tmp_path / "e") == _csv(tmp_path / "ref")
    nlpd = np.abs(np.asarray(cols["NLL_diffusion"]) - np.asarray(cols["NLL_mcmc"]))
    assert m == (float(np.mean(cols["KL2"])), float(nlpd.mean()), float(np.mean(cols["MSE"])))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("problem", ["linear", "scatterometry"])
def test_eval_many_is_eval_y_per_condition(problem):
    """A chunk of 3 conditions, each on a generator of its own and all on
    one shared generator, bit for bit eval_y run condition by condition on
    the same generators; the kept positions' last samples too."""
    if problem == "linear":
        model, params, prob, ys = _linear_case()
        eval_y = evaluate.make_eval_y_linear(model, prob, N_X, REPEATS, STEPS, NBINS)
        eval_many = evaluate.make_eval_many_linear(model, prob, N_X, REPEATS, STEPS, NBINS)
        many = lambda gens: eval_many(params, gens, ys, keep=[1])
        one = lambda g, i: eval_y(params, g, ys[i])
    else:
        model, params, fwd, score, ys, gt_loader = _scat_case()
        eval_y = evaluate.make_eval_y_scatterometry(model, fwd, FP, score, N_X, STEPS, NBINS).eval_y
        eval_many = evaluate.make_eval_many_scatterometry(model, fwd, FP, score, N_X, STEPS, NBINS)
        x_trues = evaluate.stage_ground_truth(gt_loader, range(3), REPEATS, "cpu")
        many = lambda gens: eval_many(params, gens, ys, x_trues, keep=[1])
        one = lambda g, i: eval_y(params, g, ys[i], x_trues[i])
    seeded = lambda: [torch.Generator().manual_seed(10 + i) for i in range(3)]
    for gens, ref_gens in ((seeded(), seeded()), (torch.Generator().manual_seed(20),
                                                  [torch.Generator().manual_seed(20)] * 3)):
        out = many(gens)
        ref = [one(ref_gens[i], i) for i in range(3)]
        _equal({k: out[k] for k in evaluate.STATS}, {k: torch.stack([r[k] for r in ref]) for k in evaluate.STATS})
        assert list(out["samples"]) == [1]
        _equal(out["samples"][1], {k: ref[1][k] for k in ("x_pred_last", "x_true_last")})


def test_eval_many_over_a_mesh(mesh_of_one):
    """With a mesh of one the chunk's statistics are the meshless ones bit
    for bit; a chunk that does not split over the ranks is refused."""
    model, params, prob, ys = _linear_case()
    make = lambda mesh: evaluate.make_eval_many_linear(model, prob, N_X, REPEATS, STEPS, NBINS, mesh=mesh)
    gens = lambda: [torch.Generator().manual_seed(i) for i in range(3)]
    out, ref = make(mesh_of_one)(params, gens(), ys), make(None)(params, gens(), ys)
    _equal({k: out[k] for k in evaluate.STATS}, {k: ref[k] for k in evaluate.STATS})
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        make(pmesh.Mesh(2, 0, torch.device("cpu"), "gloo"))(params, gens(), ys)
    with pytest.raises(ValueError, match="2 generators for 3 conditions"):
        make(None)(params, gens()[:2], ys)


def test_eval_y_scatterometry_matches_jax_on_the_same_ground_truth():
    """One repeat of a 3 -> 16 -> 16 -> 3 CDE on JAX's init, against the
    surrogate, at 512 samples and 20 bins: the ground truth's histogram
    equal, its energy and score-MSE (deterministic in x_true) to rtol 1e-4;
    the sampled entries finite, each sampler on its own stream."""
    jfwd, fp = jscat.load_forward_model()
    tfwd, _ = scat.load_forward_model()
    cfg = {"model": "CDE", "loss_fn": "DSM", "hidden_layers": [16, 16]}
    jm, _ = jtrain.get_model_from_args(cfg, fp)
    tm, _ = train.get_model_from_args(cfg, fp)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp])
    rng = np.random.default_rng(0)
    x_cond = rng.uniform(-0.8, 0.8, size=(1, 3)).astype(np.float32)
    y = np.array(jscat.noisy_forward(jax.random.PRNGKey(1), jfwd, jnp.asarray(x_cond), fp["a"], fp["b"]))[0]
    x_true = (x_cond + 0.05 * rng.normal(size=(N_X, 3))).astype(np.float32)
    jscore = jscat.score_posterior(jfwd, fp["a"], fp["b"], fp["lambd_bd"])
    tscore = scat.score_posterior(tfwd, fp["a"], fp["b"], fp["lambd_bd"])
    jout = jeval.make_eval_y_scatterometry(jm, jfwd, fp, jscore, N_X, num_steps=STEPS, nbins=NBINS,
                                           method="xla").raw(jp, jax.random.PRNGKey(2), jnp.asarray(y),
                                                             jnp.asarray(x_true))
    tout = evaluate.make_eval_y_scatterometry(tm, tfwd, fp, tscore, N_X, num_steps=STEPS, nbins=NBINS)(
        tp, torch.Generator().manual_seed(2), torch.from_numpy(y), torch.from_numpy(x_true))
    assert set(tout) == set(jout)
    np.testing.assert_array_equal(tout["hist_true"].numpy(), np.asarray(jout["hist_true"]))
    for k in ("nll_true", "mse_score"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-4)
    assert tout["x_pred"].shape == jout["x_pred"].shape == (N_X, 3)
    assert all(np.isfinite(float(tout[k])) for k in ("nll_model", "w2"))


@pytest.mark.parametrize("d,lo,hi", [(2, -3.5, 3.5), (3, -1.2, 1.2)])
def test_histogram_drops_points_outside_and_keeps_the_upper_edge(d, lo, hi):
    """Points past either edge of the box in one coordinate, exactly on
    ``hi`` and on ``lo``, and inside: numpy's counts, and the mask-and-
    bincount histogram's."""
    rng = np.random.default_rng(d)
    x = rng.uniform(lo, hi, size=(3000, d)).astype(np.float32)
    x[:100, 0] = hi + rng.uniform(1e-3, 1.0, 100).astype(np.float32)
    x[100:200, d - 1] = lo - rng.uniform(1e-3, 1.0, 100).astype(np.float32)
    x[200:300] = hi
    x[300:400, 0] = lo
    x[400:450, 0], x[400:450, d - 1] = hi, hi + 0.5
    h = evaluate.histogramdd_flat(torch.from_numpy(x), NBINS, lo, hi)
    h_np, _ = np.histogramdd(x, bins=NBINS, range=[(float(np.float32(lo)), float(np.float32(hi)))] * d)
    assert h.shape == (NBINS**d,) and h.dtype == torch.int64
    np.testing.assert_array_equal(h.numpy(), h_np.reshape(-1))
    assert torch.equal(h, _bincount_hist(torch.from_numpy(x), NBINS, lo, hi))
    assert int(h.sum()) == 3000 - 250


def _b1(seed):
    tp = mlp_init(5, 2, (16, 16), generator=torch.Generator().manual_seed(1))
    x0 = torch.randn(64, 2, generator=torch.Generator().manual_seed(2))
    return fused_em_sampler(tp, x0, torch.tensor([0.4, -0.2]), 8, seed=seed)


def _b4(seed):
    tp = mlp_init(5, 4, (16, 16), generator=torch.Generator().manual_seed(1))
    x0 = torch.randn(64, 2, generator=torch.Generator().manual_seed(2))
    return fused_em_sampler_cdiffe(tp, x0, torch.tensor([0.4, -0.2]), 8, seed=seed)


def _b5(seed):
    prior = mlp_init(4, 3, (16, 16), generator=torch.Generator().manual_seed(1))
    surr = mlp_init(3, 5, (16,), generator=torch.Generator().manual_seed(3))
    x0 = torch.randn(64, 3, generator=torch.Generator().manual_seed(2))
    y = torch.randn(5, generator=torch.Generator().manual_seed(4))
    return fused_guided_em_sampler(prior, surr, x0, y, a=0.2, b=0.01, num_steps=8, seed=seed)


@pytest.mark.parametrize("sampler", [_b1, _b4, _b5], ids=["B1", "B4", "B5"])
def test_a_tensor_seed_is_its_int_on_the_plain_path(sampler):
    """Each wrapper's plain path takes the seed as an int or as a one-element
    int64 tensor, with the same samples."""
    seed = 2**61 + 12345
    assert torch.equal(sampler(seed), sampler(torch.tensor([seed])))
    assert not torch.equal(sampler(seed), sampler(seed + 1))


def test_kernel_seed_forms():
    """A CPU generator gives the kernel's seed as the int it draws; a seed
    tensor binds by its address, an int by its 64 bits; a tensor of
    another type, size or device is refused."""
    g = torch.Generator().manual_seed(5)
    x0, seed = _kernel_draws(g, 4, 2, 1.0, 2.0, torch.device("cpu"))
    g = torch.Generator().manual_seed(5)
    want_x0 = torch.randn(4, 2, generator=g) * 2.0 + 1.0
    assert isinstance(seed, int) and seed == int(torch.randint(0, 2**62, (1,), generator=g))
    assert torch.equal(x0, want_x0)
    cpu = torch.device("cpu")
    t = torch.tensor([7])
    assert build.seed_args(7, cpu) == (7, None)
    assert build.seed_args(-1, cpu) == (2**64 - 1, None)
    assert build.seed_args(t, cpu) == (0, t.data_ptr())
    for bad in (torch.tensor([7], dtype=torch.int32), torch.tensor([7, 8])):
        with pytest.raises(ValueError, match="a tensor seed is one int64"):
            build.seed_args(bad, cpu)
    with pytest.raises(ValueError, match="a tensor seed is one int64 on cuda"):
        build.seed_args(t, torch.device("cuda"))


def test_stage_ground_truth_on_the_cpu():
    """The chunk's GT repeats as float32 tensors, [condition][repeat], with
    the loader's values (float64 input rounded as torch.as_tensor rounds)."""
    gt = np.random.default_rng(0).normal(size=(4, 2, 10, 3))
    staged = evaluate.stage_ground_truth(lambda i, j: gt[i, j], range(1, 3), 2, "cpu")
    assert len(staged) == 2 and all(len(r) == 2 for r in staged)
    for c, i in enumerate((1, 2)):
        for j in range(2):
            assert staged[c][j].dtype == torch.float32 and not staged[c][j].is_pinned()
            assert torch.equal(staged[c][j], torch.as_tensor(gt[i, j], dtype=torch.float32))


def test_compare_checkouts_runs_both_in_turns(tmp_path):
    """The two-checkout timing tool on the CPU at a tiny size, this
    checkout on both sides: four runs in the order other, this, this,
    other, each timed, and the two results.csv equal."""
    from dmip_tpu_torch.utils import compare_checkouts

    res = compare_checkouts.run(compare_checkouts.THIS, "cpu", conditions=2, samples=200, repeats=1, steps=4, calls=1,
                                out_dir=str(tmp_path))
    assert [r["run"] for r in res["runs"]] == ["other", "this", "this", "other"]
    assert all(len(r["ms_per_condition"]) == 1 and r["ms_per_condition"][0] > 0 for r in res["runs"])
    assert res["rows_equal"]
