"""The epoch engines with the draws taken out of the loss, the form a CUDA
graph captures (``train.make_epoch_fn``, ``ensemble.make_ensemble_epoch_fn``).

Each engine draws a batch's numbers through the loss's own ``draws`` before
the step and hands them to it by keyword.  For every loss the engines
train, two epochs of three batches must give the params, Adam state and
losses of ``make_train_step`` drawing inside the loss, bit for bit; a step
must make no ``aten::lift_fresh`` (``torch.tensor`` of a Python number: on
a card a copy from pageable memory, a stream sync, and a failed capture);
and on the CPU the engines run that step eagerly.  Small nets (32 wide), 16
rows a batch; the graph itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from dmip_tpu_torch import data, ensemble, flows, nets, pytree, train
from dmip_tpu_torch.problems import LinearForwardProblem

WIDTH = (32, 32, 32)
BATCH, N_BATCHES, EPOCHS = 16, 3, 2
SEED = 11


def _linear_data():
    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, BATCH * N_BATCHES, torch.Generator().manual_seed(0))
    return prob, lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, BATCH)


def _diffusion(config):
    prob, batch_fn = _linear_data()
    model, cfg = train.get_model_from_args(dict(config, hidden_layers=list(WIDTH)), {"xdim": 2, "ydim": 2})
    loss_fn = model.make_loss_fn(cfg, initial_condition=prob.score_posterior)
    return loss_fn, model.init(torch.Generator().manual_seed(1)), batch_fn


def _posterior():
    """The DPS model's PosteriorLoss through a small random surrogate
    (3 -> 16 -> 23, tanh), on data of scatterometry's shapes."""
    surrogate = nets.mlp_init(3, 23, (16,), generator=torch.Generator().manual_seed(2))
    forward = lambda x: nets.mlp_apply(surrogate, x)
    gen = torch.Generator().manual_seed(0)
    xs = torch.rand(BATCH * N_BATCHES, 3, generator=gen) * 2 - 1
    ys = forward(xs) + 0.01 * torch.randn(BATCH * N_BATCHES, 23, generator=gen)
    model, cfg = train.get_model_from_args({"model": "Posterior", "lam": 1.0, "hidden_layers": list(WIDTH)},
                                           {"xdim": 3, "ydim": 23})
    loss_fn = model.make_loss_fn(cfg, forward_model=forward, forward_params={"a": 0.2, "b": 0.01})
    return loss_fn, model.init(torch.Generator().manual_seed(1)), \
        lambda g: data.linear_epoch_batches(g, xs, ys, 0.0, BATCH)


def _flow(kind):
    prob, batch_fn = _linear_data()
    energy = lambda x, ys: prob.log_posterior(x, ys)[:, 0]
    if kind == "inn":
        inn = flows.create_inn(2, 16, dimension=2, dimension_condition=2)
        return flows.inn_loss_fn(inn), inn.init(torch.Generator().manual_seed(1)), batch_fn
    kw = {"snf_mh": {}, "snf_mala_langevin": {"lang_steps": 1, "langevin_prop": True, "lang_steps_prop": 2}}[kind]
    snf = flows.create_snf(2, 16, energy, metr_steps_per_block=2, dimension=2, dimension_condition=2, **kw)
    return flows.snf_loss_fn(snf), snf.init(torch.Generator().manual_seed(1)), batch_fn


CASES = {
    "pinn_exact": lambda: _diffusion({"model": "CDE", "loss_fn": "PINNLoss", "lam": 0.1, "lam2": 0.1,
                                      "ic_metric": "L2"}),
    "pinn_hutchinson": lambda: _diffusion({"model": "CDE", "loss_fn": "PINNLoss", "lam": 0.1, "lam2": 0.1,
                                           "divergence_method": "hutchinson"}),
    "pinn2": lambda: _diffusion({"model": "CDE", "loss_fn": "PINNLoss2", "lam": 0.1, "lam2": 0.1}),
    "dsm": lambda: _diffusion({"model": "CDE", "loss_fn": "DSM"}),
    "dsm_cdiffe": lambda: _diffusion({"model": "CDiffE", "loss_fn": "DSM"}),
    "dsm_pde_hutchinson": lambda: _diffusion({"model": "CDE", "loss_fn": "DSM_PDE", "lam": 0.1,
                                              "divergence_method": "hutchinson"}),
    "dsm_pde_cscore": lambda: _diffusion({"model": "CDE", "loss_fn": "DSM_PDE", "lam": 0.1,
                                          "pde_loss": "cScoreFPE", "pde_metric": "L2"}),
    "posterior": _posterior,
    "snf_mh": lambda: _flow("snf_mh"),
    "snf_mala_langevin": lambda: _flow("snf_mala_langevin"),
    "inn": lambda: _flow("inn"),
}


def _equal(a, b) -> bool:
    la, lb = pytree.leaves(a), pytree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _reference(loss_fn, opt, batch_fn, params):
    """make_train_step with the loss drawing from the epoch's generator, as
    the engine ran before its draws left the loss, but for a loss with
    ``epoch_draws`` (DSM): that one draws its whole epoch's numbers after
    the batches and batch i takes row i; the epochs' mean losses and info
    as the engine reduced them."""
    step = train.make_train_step(loss_fn, opt)
    state = opt.init(params)
    losses, infos = [], {}
    for e in range(EPOCHS):
        gen = train.epoch_generator(SEED, e, "cpu")
        xb, yb = batch_fn(gen)
        rows = loss_fn.epoch_draws(gen, xb, yb) if hasattr(loss_fn, "epoch_draws") else None
        ls, ins = [], []
        for i, (x, y) in enumerate(zip(xb, yb)):
            draws = None if rows is None else {k: v[i] for k, v in rows.items()}
            params, state, loss, info = step(params, state, gen, x, y, draws)
            ls.append(loss)
            ins.append(info)
        losses.append(torch.stack(ls).mean())
        for k in ins[0]:
            infos.setdefault(k, []).append(torch.stack([i[k] for i in ins]).mean())
    return params, state, torch.stack(losses), {k: torch.stack(v) for k, v in infos.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_draws_the_losses_own_numbers_bit_for_bit(case):
    loss_fn, params, batch_fn = CASES[case]()
    assert hasattr(loss_fn, "draws")
    opt = train.build_optimizer(1e-3, grad_clip=1.0)
    ref = _reference(loss_fn, opt, batch_fn, params)
    fn = train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=EPOCHS)
    p, st, losses, infos = fn(params, opt.init(params), SEED, 0)
    assert _equal(p, ref[0]) and _equal(st, ref[1])
    assert torch.equal(losses, ref[2]) and sorted(infos) == sorted(ref[3])
    assert all(torch.equal(infos[k], ref[3][k]) for k in infos)
    assert int(st.count) == EPOCHS * N_BATCHES and bool(torch.isfinite(losses).all())
    # the draws reached the loss: other epochs, and another seed, give other
    # numbers (the INN draws none, so its batches alone move it)
    assert not torch.equal(fn(params, opt.init(params), SEED, EPOCHS)[2], losses)
    assert not torch.equal(fn(params, opt.init(params), SEED + 1, 0)[2], losses)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_step_copies_no_python_number_to_the_device(case):
    """After a first call has built the cached constants, an engine call
    (batches, draws, loss, gradient, clip, Adam, guard) runs no
    aten::lift_fresh."""
    loss_fn, params, batch_fn = CASES[case]()
    opt = train.build_optimizer(1e-3, grad_clip=1.0, schedule="cosine", decay_steps=10)
    fn = train.make_epoch_fn(loss_fn, opt, batch_fn)
    state = opt.init(params)
    params, state, _, _ = fn(params, state, SEED, 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(params, state, SEED, 1)
    names = [e.name for e in prof.events()]
    assert names.count("aten::lift_fresh") == 0
    assert names.count("aten::mm") + names.count("aten::addmm") > 0  # the step was traced


def test_ensemble_engine_is_its_step_bit_for_bit():
    """The K-trial engine, its draws made by ``loss_draws`` before each
    step, against make_ensemble_step run batch by batch."""
    prob, batch_fn = _linear_data()
    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": list(WIDTH)},
                                           {"xdim": 2, "ydim": 2})
    kw = {"initial_condition": prob.score_posterior}
    opt = train.build_optimizer(1e-3, grad_clip=1.0)
    lams, lam2s, _ = ensemble.pad_trials([0.5, 0.01], [1.0, 0.1], 1)
    ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(1), 2)
    step = ensemble.make_ensemble_step(model, cfg, opt, kw)
    p, st = ens, ensemble.init_opt_state(opt, ens)
    ref = []
    for e in range(EPOCHS):
        gen = train.epoch_generator(SEED, e, "cpu")
        xb, yb = batch_fn(gen)
        ls = []
        for x, y in zip(xb, yb):
            p, st, loss, _ = step(p, st, lams, lam2s, x, y, *model.loss_draws(cfg, gen, x, y))
            ls.append(loss)
        ref.append(torch.stack(ls).mean(0))
    efn = ensemble.make_ensemble_epoch_fn(model, cfg, opt, batch_fn, EPOCHS, kw)
    p2, st2, losses, infos = efn(ens, ensemble.init_opt_state(opt, ens), SEED, 0, lams, lam2s)
    assert _equal(p2, p) and _equal(st2, st) and torch.equal(losses, torch.stack(ref))
    assert sorted(infos) == ["DSM-Loss", "Initial Condition", "PDE-Loss"] and infos["PDE-Loss"].shape == (EPOCHS, 2)


def test_capture_runs_eagerly_on_the_cpu_and_over_a_mesh():
    """capture=True (the default) captures only on a CUDA device, with or
    without a mesh: on the CPU both engines run the eager step, equal to
    capture=False bit for bit, and capture nothing (a mesh on the CPU runs
    eagerly too: tests/test_torch_mesh.py)."""
    loss_fn, params, batch_fn = CASES["dsm"]()
    opt = train.build_optimizer(1e-3)
    runs = {c: train.make_epoch_fn(loss_fn, opt, batch_fn, capture=c) for c in (True, False)}
    out = {c: fn(params, opt.init(params), SEED, 0) for c, fn in runs.items()}
    assert _equal(out[True][:3], out[False][:3]) and runs[True].graph.captures == 0
    model, cfg = train.get_model_from_args({"model": "CDE", "loss_fn": "DSM", "hidden_layers": [8]},
                                           {"xdim": 2, "ydim": 2})
    ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(1), 2)
    lams, lam2s, _ = ensemble.pad_trials([1.0, 0.5], [1.0, 1.0], 1)
    efns = {c: ensemble.make_ensemble_epoch_fn(model, cfg, opt, batch_fn, capture=c) for c in (True, False)}
    eout = {c: fn(ens, ensemble.init_opt_state(opt, ens), SEED, 0, lams, lam2s) for c, fn in efns.items()}
    assert _equal(eout[True][:3], eout[False][:3]) and efns[True].graph.captures == 0
    assert train.use_capture(True, torch.device("cuda"))
    assert not train.use_capture(True, torch.device("cpu"))
    assert not train.use_capture(False, torch.device("cuda"))


def test_engine_needs_the_losses_draws():
    """A loss without ``draws`` is refused when the engine is built."""
    loss_fn, _, batch_fn = CASES["dsm"]()
    bare = lambda params, generator, x, y, **draws: loss_fn(params, generator, x, y, **draws)
    with pytest.raises(ValueError, match="loss_fn.draws"):
        train.make_epoch_fn(bare, train.build_optimizer(1e-3), batch_fn)


def test_epoch_generator_takes_the_seed_on_the_cpu():
    """The CPU's mt19937 keeps 32 bits of its seed, and the generator mixes
    the seed into them: two seeds give other batches and draws at the same
    epoch, two epochs other draws under one seed, and one (seed, epoch) the
    same draws."""
    draw = lambda seed, epoch: torch.rand(8, generator=train.epoch_generator(seed, epoch, "cpu"))
    assert not torch.equal(draw(11, 0), draw(12, 0)) and not torch.equal(draw(11, 0), draw(11, 1))
    assert not torch.equal(draw(2**31 - 1, 0), draw(0, 0))
    assert torch.equal(draw(11, 3), draw(11, 3)) and torch.equal(draw(11 + 2**31, 3), draw(11, 3))
    _, batch_fn = _linear_data()
    xs = [batch_fn(train.epoch_generator(s, 0, "cpu"))[0] for s in (11, 12)]
    assert not torch.equal(*xs)
    with pytest.raises(ValueError, match="epoch index"):
        train.epoch_generator(1, 2**32, "cpu")


def test_snf_draws_are_what_the_loss_draws():
    """flows.snf_draws in the loss's own order: the loss on them equals the
    loss drawing from a generator of the same seed, and the layout matches
    each layer's ``draws=``."""
    loss_fn, params, batch_fn = CASES["snf_mala_langevin"]()
    xb, yb = batch_fn(torch.Generator().manual_seed(4))
    drawn = loss_fn.draws(torch.Generator().manual_seed(5), xb[0], yb[0])["draws"]
    given = loss_fn(params, None, xb[0], yb[0], draws=drawn)[0]
    own = loss_fn(params, torch.Generator().manual_seed(5), xb[0], yb[0])[0]
    assert torch.equal(given, own)
    shapes = [None if d is None else {k: tuple(v.shape) for k, v in d.items()} for d in drawn]
    assert shapes == [None, {"eta": (1, BATCH, 2)}, {"noise": (2, 2, BATCH, 2), "uniforms": (2, BATCH)}] * 2
    assert np.isfinite(float(given))
