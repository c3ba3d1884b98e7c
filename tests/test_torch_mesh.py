"""The multi-GPU layer (``dmip_tpu_torch.parallel``) on two gloo ranks on
the CPU, against the meshless port and against ``dmip_tpu``.

Two module-scoped spawns of two ranks each: one trains (a data-parallel
step on JAX's draws, the data-parallel engine, the pinned and the sharded
``vmap`` ensembles, the linear grid driver), the other serves (sharded
``evaluate_linear`` / ``evaluate_scatterometry`` and the ground-truth
driver's ``--devices 2``).  Each rank records every file it opens for
writing under the run's directory.  The JAX package is imported only in
this process, inside the tests: the spawned ranks import this module.

Nets are 16 wide, two layers; batches of at most 64 rows.
"""

import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import yaml

from dmip_tpu_torch import data, ensemble, evaluate, flows, pytree, train
from dmip_tpu_torch.checkpoints import load_checkpoint, params_from_numpy
from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
from dmip_tpu_torch.mains import run_grid_search_linear
from dmip_tpu_torch.parallel import mesh as pmesh
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.problems import scatterometry as scat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = {"xdim": 2, "ydim": 2}
CONFIG = {"model": "CDE", "loss_fn": "PINNLoss", "hidden_layers": [16, 16], "lam": 0.5, "lam2": 0.3}
B = 64
# f32 through third derivatives of the net, in other sum orders: the
# tolerance of tests/test_torch_ensemble.py's step parity against JAX
REL = 2e-5
# the same step on two half batches against the whole batch: f32 sums of
# the two halves' means in another order
SPLIT_REL = 1e-5
# several steps apart in sum order: each leaf within this share of its update
UPDATE_REL = 1e-4
LAMS, LAM2S = [0.5, 0.05, 1.0], [1.0, 0.1, 0.3]
TINY_GRID = dict(dataset_size=1200, n_epochs=2, epochs_per_call=1, batch_size=400, hidden_layers=[16, 16],
                 n_samples_x=300, eval_n_repeats=1, eval_num_steps=8, n_samples_y=2)
# a third of the grid's trials: two of its ensemble groups of two
GRID_HOSTS = dict(host=0, n_hosts=4)
GT_CUTS = dict(n_samples_y=2, n_samples_x=50, n_repeats=2, METR_STEPS=5, plot_ys=[])
EVAL = dict(n_samples_x=200, n_repeats=2, num_steps=8)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _update_rel(p, ref, p0):
    """Per leaf, |p - ref| / |ref - p0|: the difference as a share of the update."""
    return max(float((a - b).norm() / (b - c).norm())
               for a, b, c in zip(pytree.leaves(p), pytree.leaves(ref), pytree.leaves(p0)))


def _model():
    return train.get_model_from_args(CONFIG, DIMS)


def _batch_fn():
    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, 96, torch.Generator().manual_seed(0))
    return prob, lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, 32)


def _engine(mesh, n_epochs=2):
    """The autograd engine over ``mesh`` for n_epochs from a seeded init."""
    prob, batch_fn = _batch_fn()
    model, cfg = _model()
    opt = train.build_optimizer(1e-3)
    fn = train.make_epoch_fn(model.make_loss_fn(cfg, initial_condition=prob.score_posterior), opt, batch_fn,
                             mesh=mesh)
    return train.fit(fn, model.init(torch.Generator().manual_seed(3)), opt, 5, num_epochs=n_epochs,
                     log_every=0)[0]


def _sequential(lam, lam2, n_epochs=2):
    prob, batch_fn = _batch_fn()
    model, cfg = _model()
    opt = train.build_optimizer(1e-3)
    loss_fn = model.make_loss_fn(dataclasses.replace(cfg, lam=lam, lam2=lam2), initial_condition=prob.score_posterior)
    fn = train.make_epoch_fn(loss_fn, opt, batch_fn)
    return train.fit(fn, model.init(torch.Generator().manual_seed(1)), opt, 2, num_epochs=n_epochs,
                     log_every=0)[0]


def _train_many(mesh, backend, root):
    """make_train_many on LAMS / LAM2S from init seed 1, train seed 2,
    writing under ``root``."""
    prob, batch_fn = _batch_fn()
    model, cfg = _model()
    tm = ensemble.make_train_many(batch_fn, 1, 2, 1e-3, n_epochs=2,
                                  loss_kwargs={"initial_condition": prob.score_posterior},
                                  mesh=mesh, backend=backend, device="cpu")
    full = [dict(CONFIG, lam=a, lam2=b) for a, b in zip(LAMS, LAM2S)]
    dirs = [os.path.join(root, f"t{i}") for i in range(3)]
    return tm(model, cfg, full, dirs, [os.path.join(d, "logs") for d in dirs])


def _step(mesh, inputs, n=B):
    """One train step on the given params, the first n rows of the batch
    and the batch's draws (JAX's), handed to the loss as its draws."""
    prob = LinearForwardProblem()
    model, cfg = _model()
    base = model.make_loss_fn(cfg, initial_condition=prob.score_posterior)
    x, y, t, eps = (torch.from_numpy(inputs[k][:n]) for k in ("x", "y", "t", "eps"))
    # the meshless step hands the loss no draws, the sharded one its rows'
    loss = lambda p, g, xx, yy, **draws: base(p, None, xx, yy, **(draws or {"t": t, "eps": eps}))
    loss.draws = lambda g, xx, yy: {"t": t, "eps": eps}
    opt = train.build_optimizer(1e-3)
    params = params_from_numpy(inputs["params"])
    p, _, value, info = train.make_train_step(loss, opt, mesh=mesh)(params, opt.init(params), None, x, y)
    return p, float(value), {k: float(v) for k, v in info.items()}


def _record_writes(root: str, log: list) -> None:
    """Record in ``log`` every path under ``root`` this process opens for
    writing (an audit hook: it sees every open, numpy's and json's
    included)."""
    root = os.path.realpath(root)

    def hook(event, args):
        if event != "open" or not isinstance(args[0], (str, bytes, os.PathLike)):
            return
        mode, flags = args[1], args[2]
        writes = any(c in mode for c in "wax+") if isinstance(mode, str) else bool(flags & (os.O_WRONLY | os.O_RDWR))
        path = os.path.realpath(os.fsdecode(args[0]))
        if writes and path.startswith(root):
            log.append(os.path.relpath(path, root))

    sys.addaudithook(hook)


def _spawn(fn, root, *args):
    """Run fn(rank, address, root, *args) on two gloo ranks; returns each
    rank's saved results."""
    mp.spawn(fn, args=(pmesh.local_address(), root, *args), nprocs=2, join=True)
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(2)]


def _join(rank, address, root):
    torch.set_num_threads(1)
    assert pmesh.init_multihost(address, 2, rank, device="cpu") and pmesh.init_multihost()
    writes = []
    _record_writes(root, writes)
    return pmesh.get_mesh(), writes


def _training_ranks(rank, address, root, inputs):
    mesh, writes = _join(rank, address, root)
    assert (mesh.size, mesh.rank, mesh.backend, str(mesh.device)) == (2, rank, "gloo", "cpu")
    out = {"step": _step(mesh, inputs), "ragged_step": _step(mesh, inputs, B - 1), "engine": _engine(mesh)}
    out["pinned"] = _train_many(mesh, "pinned", os.path.join(root, "pinned"))
    out["vmap"] = _train_many(mesh, "vmap", os.path.join(root, "vmap"))
    if rank == 0:
        # the references, run where no other rank writes
        out["sequential"] = [_sequential(a, b) for a, b in zip(LAMS, LAM2S)]
        out["vmap_meshless"] = _train_many(None, "vmap", os.path.join(root, "ref"))
    mesh.barrier()
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "config_gridsearch_linear_small.yml")))
    cfg.update(TINY_GRID, src_dir=os.path.join(root, "grid"))
    out["grid"] = run_grid_search_linear.run(cfg, device="cpu", **GRID_HOSTS)
    out["writes"] = writes
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def step_inputs():
    """Params, a batch and JAX's draws for it (``tests/test_torch_ensemble.py``'s rebuild)."""
    import jax

    from dmip_tpu import train as jtrain
    from dmip_tpu.sde import sample_t as jax_sample_t

    jmodel, _ = jtrain.get_model_from_args(CONFIG, DIMS)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(5)
    kt, keps, _ = jax.random.split(key, 3)
    return {
        "params": [(np.asarray(w), np.asarray(b)) for w, b in jmodel.init(jax.random.PRNGKey(1))],
        "x": rng.normal(size=(B, 2)).astype(np.float32), "y": rng.normal(size=(B, 2)).astype(np.float32),
        "t": np.array(jax_sample_t(jmodel.sde, kt, B)), "eps": np.array(jax.random.normal(keps, (B, 2))),
        "key": key,
    }


@pytest.fixture(scope="module")
def trained(tmp_path_factory, step_inputs):
    root = str(tmp_path_factory.mktemp("mesh_train"))
    inputs = {k: v for k, v in step_inputs.items() if k != "key"}
    return root, _spawn(_training_ranks, root, inputs)


def test_data_parallel_step_matches_the_meshless_port_and_jax(trained, step_inputs):
    """One PINNLoss step over two ranks: within SPLIT_REL of the meshless
    port's step on the same batch and draws (also for a ragged batch of 63
    rows: parts of 32 and 31, each weighted by its rows), the same on both
    ranks, and within REL of JAX's data-parallel step on two of conftest's
    virtual devices."""
    import jax
    import jax.numpy as jnp
    import optax

    from dmip_tpu import train as jtrain
    from dmip_tpu.parallel.mesh import batch_sharding, get_mesh, replicate
    from dmip_tpu.problems import LinearForwardProblem as JLinear

    _, ranks = trained
    for key, n in (("step", B), ("ragged_step", B - 1)):
        p, loss, info = ranks[0][key]
        ref_p, ref_loss, ref_info = _step(None, step_inputs, n)
        assert abs(loss - ref_loss) <= SPLIT_REL * abs(ref_loss)
        assert all(abs(info[k] - ref_info[k]) <= SPLIT_REL * abs(ref_info[k]) for k in ref_info)
        for a, b, c in zip(pytree.leaves(p), pytree.leaves(ref_p), pytree.leaves(ranks[1][key][0])):
            assert _rel(a, b) < SPLIT_REL and torch.equal(a, c)

    jmodel, jcfg = jtrain.get_model_from_args(CONFIG, DIMS)
    jloss = jmodel.make_loss_fn(jcfg, initial_condition=JLinear().score_posterior)
    tx = optax.adam(1e-3)
    mesh = get_mesh(2)
    data_sh, repl = batch_sharding(mesh), replicate(mesh)
    jstep = jax.jit(jtrain.make_train_step(jloss, tx), in_shardings=(repl, repl, repl, data_sh, data_sh),
                    out_shardings=(repl, repl, None, None))
    jp0 = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in step_inputs["params"])
    jp, _, jl, jinfo = jstep(jp0, tx.init(jp0), step_inputs["key"], jnp.asarray(step_inputs["x"]),
                             jnp.asarray(step_inputs["y"]))
    p, loss, info = ranks[0]["step"]
    assert _rel(loss, float(jl)) < REL and sorted(info) == sorted(jinfo)
    assert all(_rel(info[k], float(jinfo[k])) < REL for k in info)
    for a, b in zip(pytree.leaves(p), jax.tree_util.tree_leaves(jp)):
        assert _rel(a.numpy(), np.asarray(b)) < REL


def test_data_parallel_engine_matches_the_meshless_engine(trained):
    """Two epochs of three steps, every rank drawing the same batches and
    draws from the epoch generator: the ranks agree bit for bit, and every
    leaf is within UPDATE_REL of the meshless engine's update."""
    _, ranks = trained
    ref = _engine(None)
    p0 = _model()[0].init(torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(ranks[0]["engine"]), pytree.leaves(ranks[1]["engine"])))
    assert _update_rel(ranks[0]["engine"], ref, p0) < UPDATE_REL


def test_pinned_and_sharded_vmap_ensembles(trained):
    """Three trials padded to four: 'pinned' (two waves of one trial a
    rank) gives each trial its sequential run bit for bit; the sharded
    'vmap' (two trials a rank) is within UPDATE_REL of the meshless
    ensemble's update; every rank returns every trial; rank 0 alone writes
    each trial's log and checkpoint, once."""
    root, ranks = trained
    p0 = _model()[0].init(torch.Generator().manual_seed(1))
    for r in ranks:
        assert len(r["pinned"]) == len(r["vmap"]) == 3
        for mine, seq in zip(r["pinned"], ranks[0]["sequential"]):
            assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(mine), pytree.leaves(seq)))
        for mine, ref in zip(r["vmap"], ranks[0]["vmap_meshless"]):
            assert _update_rel(mine, ref, p0) < UPDATE_REL
    for backend in ("pinned", "vmap"):
        for i in range(3):
            back = load_checkpoint(os.path.join(root, backend, f"t{i}", "checkpoint"), p0)
            assert back["extra"] == {"lam": LAMS[i], "lam2": LAM2S[i]}
            assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(back["params"]),
                                                         pytree.leaves(ranks[0][backend][i])))
    written = [w for w in ranks[0]["writes"] if w.startswith(("pinned", "vmap"))]
    assert len(written) == len(set(written)) and not [w for w in ranks[1]["writes"] if "grid" not in w]
    assert {os.path.dirname(w).split(os.sep)[0] for w in written} == {"pinned", "vmap"}


def test_grid_driver_over_two_ranks_writes_the_one_process_tree(trained, tmp_path):
    """config_gridsearch_linear_small.yml, sizes cut, host 0 of 4 (2 of its
    6 groups), under a world of two: 'auto' trains each group pinned, one
    trial a rank, and splits each trial's two conditions;
    both ranks return the same summary, rank 1 writes nothing, and the tree
    holds the files of a one-process run."""
    root, ranks = trained
    assert ranks[0]["grid"]["results"] == ranks[1]["grid"]["results"] and len(ranks[0]["grid"]["results"]) == 4
    assert all(np.isfinite(r["kl"]) for r in ranks[0]["grid"]["results"])
    assert not [w for w in ranks[1]["writes"] if w.startswith("grid")]
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "config_gridsearch_linear_small.yml")))
    cfg.update(TINY_GRID, n_epochs=1, src_dir=str(tmp_path / "grid"))
    run_grid_search_linear.run(cfg, device="cpu", **GRID_HOSTS)
    tree = lambda d: sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "**", "*"), recursive=True)
                            if os.path.isfile(p))
    assert tree(os.path.join(root, "grid")) == tree(cfg["src_dir"])


def _serving_ranks(rank, address, root):
    mesh, writes = _join(rank, address, root)
    gt.run(dict(_gt_config(), plot_ys=[]), os.path.join(root, "gt"), device="cpu", devices=2)
    out = {"linear": _evaluate_linear(mesh, os.path.join(root, "lin")),
           "scat": _evaluate_scat(mesh, os.path.join(root, "gt"), os.path.join(root, "scat"))}
    out["writes"] = writes
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _gt_config():
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "config_scatterometry.yml")))
    return dict(cfg, **GT_CUTS)


def _evaluate_linear(mesh, out_dir):
    """3 conditions (parts of 2 and 1 over two ranks), 2 repeats; the
    corner plots of condition 2, which rank 1 evaluates."""
    prob = LinearForwardProblem()
    model, _ = _model()
    params = model.init(torch.Generator().manual_seed(4))
    ys = prob.forward(torch.randn(3, 2, generator=torch.Generator().manual_seed(6)))
    m = evaluate.evaluate_linear(model, params, prob, ys, torch.Generator().manual_seed(7), out_dir=out_dir,
                                 verbose=False, mesh=mesh, plot_ys=(2,), **EVAL)
    return m, _rows(out_dir)


def _evaluate_scat(mesh, gt_dir, out_dir):
    """The 2 GT conditions, one a rank, against the sharded GT."""
    forward_model, fparams = scat.load_forward_model()
    model, _ = train.get_model_from_args(dict(CONFIG, hidden_layers=[16]), fparams)
    params = model.init(torch.Generator().manual_seed(4))
    ys = gt.test_conditions(_gt_config(), forward_model, fparams, "cpu")
    score = scat.score_posterior(forward_model, fparams["a"], fparams["b"], fparams["lambd_bd"])
    m = evaluate.evaluate_scatterometry(model, params, forward_model, fparams, score, ys, data.gt_loader(gt_dir),
                                        torch.Generator().manual_seed(7), out_dir=out_dir, verbose=False,
                                        mesh=mesh, **EVAL)
    return m, _rows(out_dir)


def _rows(out_dir):
    """results.csv's rows, once it is written (rank 0 writes it before
    any rank returns)."""
    with open(os.path.join(out_dir, "results.csv")) as f:
        return f.read()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_serve"))
    return root, _spawn(_serving_ranks, root)


@pytest.fixture
def one_thread():
    """One intra-op thread, as the spawned ranks run: CPU reductions then
    sum in the ranks' order, so results can match bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def mesh_of_one(one_thread):
    """A world of one gloo rank in this process, torn down after the test."""
    assert pmesh.init_multihost(pmesh.local_address(), 1, 0, device="cpu")
    try:
        yield pmesh.get_mesh()
    finally:
        dist.destroy_process_group()


def _split_case(name):
    """(loss, params) for the two-rank split: the PINNLoss net, an SNF with
    Metropolis layers, an SNF with Langevin and MALA layers (their draws
    are not batch-first)."""
    prob = LinearForwardProblem()
    if name == "pinn":
        model, cfg = _model()
        return model.make_loss_fn(cfg, initial_condition=prob.score_posterior), \
            model.init(torch.Generator().manual_seed(3))
    kw = dict(metr_steps_per_block=2, dimension=2, dimension_condition=2)
    if name == "snf_mala":
        kw.update(lang_steps=2, langevin_prop=True, lang_steps_prop=2)
    snf = flows.create_snf(2, 16, lambda x, c: prob.log_posterior(x, c)[:, 0], **kw)
    return flows.snf_loss_fn(snf), snf.init(torch.Generator().manual_seed(3), "cpu")


@pytest.mark.parametrize("name", ["pinn", "snf", "snf_mala"])
def test_two_ranks_first_parts_sum_to_the_full_batch(one_thread, name):
    """The data-parallel step's first part on each rank of a world of two
    (Mesh objects alone: rows and cuts need no process group), summed as
    the all-reduce sums them, gives the full batch's gradient, loss and info
    (a mesh of one's part) within SPLIT_REL, for a ragged batch of 31 rows:
    every draw is cut along its own rows."""
    loss, params = _split_case(name)
    opt = train.build_optimizer(1e-3)
    _, batch_fn = _batch_fn()
    gen = torch.Generator().manual_seed(4)
    xb, yb = batch_fn(gen)
    x, y = xb[0][:31], yb[0][:31]
    draws = loss.draws(gen, x, y)
    cpu = torch.device("cpu")
    part = lambda size, rank: train.data_parallel_parts(loss, opt, pmesh.Mesh(size, rank, cpu, "gloo"))[0]
    summed = (part(2, 0)(params, x, y, draws) + part(2, 1)(params, x, y, draws)) / 2
    assert _rel(summed, part(1, 0)(params, x, y, draws)) < SPLIT_REL


def test_meshed_engine_runs_two_parts_around_one_all_reduce(mesh_of_one, monkeypatch):
    """The data-parallel engine over a world of one, eagerly (the CPU): its
    step is the two parts around one in-place all-reduce a step (six over
    two epochs of three), and it equals the meshless engine bit for bit."""
    reduced = []
    all_reduce_ = pmesh.Mesh.all_reduce_
    monkeypatch.setattr(pmesh.Mesh, "all_reduce_", lambda self, t: reduced.append(t.shape) or all_reduce_(self, t))
    got = _engine(mesh_of_one)
    n_params = sum(t.numel() for t in pytree.leaves(got))
    # the buffer: the gradient, the loss and PINNLoss's three info terms
    assert reduced == [(n_params + 4,)] * 6
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(got), pytree.leaves(_engine(None))))


def test_pinned_ensemble_builds_one_engine_a_trial(mesh_of_one):
    """The pinned backend over a world of one: a wave of two calls (its
    lams read once) builds one engine and gives the trial's sequential run
    bit for bit; a wave of another trial builds a second, and a wave whose
    tensors are new but whose trial is the last one's builds none."""
    prob, batch_fn = _batch_fn()
    model, cfg = _model()
    opt = train.build_optimizer(1e-3)
    fn = ensemble.make_pinned_ensemble_epoch_fn(model, cfg, opt, batch_fn, mesh_of_one,
                                                loss_kwargs={"initial_condition": prob.score_posterior})

    def wave(i):
        lams, lam2s, _ = ensemble.pad_trials([LAMS[i]], [LAM2S[i]], 1)
        ens = ensemble.init_ensemble(model, torch.Generator().manual_seed(1), 1)
        return ensemble.ensemble_fit(fn, ens, opt, 2, 2, lams, lam2s, log_every=0)[0]

    got = ensemble.trial_params(wave(0), 0)
    assert fn.engines == 1
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(got), pytree.leaves(_sequential(LAMS[0], LAM2S[0]))))
    wave(1)
    assert fn.engines == 2
    wave(1)
    assert fn.engines == 2


def test_sharded_evaluation_rows_equal_a_mesh_of_one(served, mesh_of_one, tmp_path):
    """Both harnesses over two ranks give, bit for bit, the rows and
    metrics of a mesh of one rank (each condition draws from its own
    generator); both ranks return the same metrics; rank 0 alone writes
    results.csv, and the plots of a condition rank 1 evaluated.  Without a
    mesh the walk keeps the caller's one stream, so its rows differ."""
    root, ranks = served
    for name, run in (("linear", lambda m, d: _evaluate_linear(m, d)),
                      ("scat", lambda m, d: _evaluate_scat(m, os.path.join(root, "gt"), d))):
        one = run(mesh_of_one, str(tmp_path / name))
        assert ranks[0][name] == ranks[1][name] == one
        assert run(None, str(tmp_path / (name + "_meshless")))[1] != one[1]
    rank0 = ["lin/results.csv", "lin/posterior-true-2.svg", "lin/posterior-diffusion-2.svg", "scat/results.csv"]
    for r, expect in ((0, rank0), (1, [])):
        assert sorted(w for w in ranks[r]["writes"] if not w.startswith("gt")) == sorted(expect)


def test_gt_driver_devices_2_shards_the_chains(served, one_thread):
    """--devices 2: (n_repeats, n_x, 3) per condition, written once by rank
    0; rank r's block of the chains starts where one process's would and
    runs on the drawn seed folded with r, so the ranks' chains differ; the
    world must have the ranks --devices names."""
    root, ranks = served
    cfg = _gt_config()
    forward_model, fparams = scat.load_forward_model()
    ys = gt.test_conditions(cfg, forward_model, fparams, "cpu")
    gen = torch.Generator().manual_seed(int(cfg["RANDOM_STATE"]) + 1)
    _check_gt_blocks(root, cfg, forward_model, fparams, ys, gen, cfg["n_repeats"] * cfg["n_samples_x"])
    gt_writes = [w for w in ranks[0]["writes"] if w.startswith("gt")]
    assert len(gt_writes) == len(set(gt_writes)) == cfg["n_samples_y"] * cfg["n_repeats"]
    assert not [w for w in ranks[1]["writes"] if w.startswith("gt")]
    with pytest.raises(ValueError, match="needs a world of 2 ranks"):
        gt.gt_mesh(2)
    assert gt.gt_mesh(0) is None


def _check_gt_blocks(root, cfg, forward_model, fparams, ys, gen, n):
    for i in range(cfg["n_samples_y"]):
        x0 = torch.rand(n, 3, generator=gen) * 2.0 - 1.0
        seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        got = np.stack([np.load(os.path.join(root, "gt", str(i), f"{j}.npy")) for j in range(cfg["n_repeats"])])
        assert got.shape == (cfg["n_repeats"], cfg["n_samples_x"], 3) and np.isfinite(got).all()
        blocks = [_scat_chains(forward_model, fparams, cfg, x0[r * n // 2:(r + 1) * n // 2], ys[i],
                              pmesh.fold_in(seed, r)) for r in range(2)]
        np.testing.assert_array_equal(got.reshape(n, 3), np.concatenate(blocks))
        assert not np.array_equal(blocks[1], _scat_chains(forward_model, fparams, cfg, x0[n // 2:], ys[i],
                                                         pmesh.fold_in(seed, 0)))


def _scat_chains(forward_model, fparams, cfg, x0, y, seed):
    from dmip_tpu_torch.ops import fused_mh_scatterometry

    return fused_mh_scatterometry(forward_model.weights, x0, y, int(cfg["METR_STEPS"]),
                                  noise_std=float(cfg["NOISE_STD_MCMC"]), a=fparams["a"], b=fparams["b"],
                                  lambd_bd=fparams["lambd_bd"], seed=seed).numpy()


# --- one process --------------------------------------------------------------


_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def test_init_multihost_without_a_coordinator(monkeypatch):
    """Without a coordinator init_multihost is a safe no-op."""
    for var in _DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: called.append((a, kw)))
    assert pmesh.init_multihost() is False and called == []


def test_init_multihost_from_torchrun_env_and_arguments(monkeypatch):
    """torchrun's variables give the coordinator, world, rank and the
    host's share; explicit arguments win; a CPU world is gloo."""
    env = dict(MASTER_ADDR="10.0.0.1", MASTER_PORT="1234", WORLD_SIZE="4", RANK="2", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: called.append((a, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert pmesh.init_multihost(device="cpu") is True
    assert called == [(("gloo",), dict(init_method="tcp://10.0.0.1:1234", world_size=4, rank=2))]
    called.clear()
    assert pmesh.init_multihost("other:1", 2, 1, device="cpu") is True
    assert called == [(("gloo",), dict(init_method="tcp://other:1", world_size=2, rank=1))]
    # ranks with a card each are NCCL; ranks sharing one card are gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh._placement(None, 1, 2) == ("nccl", torch.device("cuda", 1))
    assert pmesh._placement(None, 3, 4) == ("gloo", torch.device("cuda", 1))


def test_init_multihost_is_idempotent(monkeypatch):
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: called.append((a, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert pmesh.init_multihost() is True and pmesh.init_multihost("x:1", 2, 0) is True and called == []


@pytest.mark.parametrize("n,multiple,axis", [(10, 4, 0), (12, 4, 0), (5, 3, 1), (1, 8, 0)])
def test_pad_to_multiple_matches_jax(n, multiple, axis):
    import jax.numpy as jnp

    from dmip_tpu.parallel.mesh import pad_to_multiple as jax_pad

    x = np.random.default_rng(n).normal(size=(n, 3) if axis == 0 else (2, n)).astype(np.float32)
    got, nv = pmesh.pad_to_multiple(torch.from_numpy(x), multiple, axis)
    ref, rn = jax_pad(jnp.asarray(x), multiple, axis)
    assert nv == rn == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,size", [(1000, 2), (1000, 8), (63, 2), (5, 4), (3, 8)])
def test_rows_cover_the_axis_in_rank_order(n, size):
    parts = [pmesh.Mesh(size, r, torch.device("cpu"), "gloo").rows(n) for r in range(size)]
    assert [i for p in parts for i in range(n)[p]] == list(range(n))
    lengths = [p.stop - p.start for p in parts]
    assert max(lengths) - min(lengths) <= 1
    seeds = {pmesh.fold_in(7, r) for r in range(size)} | {pmesh.fold_in(8, 0)}
    assert len(seeds) == size + 1 and all(0 <= s < 2**62 for s in seeds)


def test_auto_mesh_in_one_process_on_a_multi_gpu_host(monkeypatch, capsys):
    """One process on a host reporting 8 GPUs: 'auto' is no mesh, with one
    note on stderr, and the autograd engine, the ensemble backends and the
    ensemble engine build (they raised before the port had a mesh)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    train._note_unused_gpus.cache_clear()
    assert train.resolve_mesh("auto") is None and train.resolve_mesh("auto") is None
    err = capsys.readouterr().err
    assert err.count("torchrun --nproc_per_node 8") == 1
    prob, batch_fn = _batch_fn()
    model, cfg = _model()
    opt = train.build_optimizer(1e-3)
    assert callable(train.make_epoch_fn(model.make_loss_fn(cfg, initial_condition=prob.score_posterior), opt,
                                        batch_fn, mesh="auto"))
    assert ensemble.resolve_backend("auto", "auto") == "vmap"
    assert callable(ensemble.make_ensemble_epoch_fn(model, cfg, opt, batch_fn, mesh="auto"))
    assert callable(ensemble.make_train_many(batch_fn, 1, 2, 1e-3, 1, mesh="auto"))
    with pytest.raises(ValueError, match="mesh must be None, 'auto' or a Mesh"):
        train.resolve_mesh(object())
