"""Grid search (``dmip_tpu_torch.gridsearch``), its drivers and the
evaluation pieces they add, against ``dmip_tpu``.

The pure logic (``product_dict``, ``should_skip``, ``trial_dir``,
``ensemble_signature``, ``get_params_from_path``, ``traverse_subfolders``)
is held to the JAX functions on the inputs of ``tests/test_gridsearch.py``
and on the trial list and groups of every shipped grid config;
``grid_search`` with stub train / evaluate / train_many to JAX's fed the
same stubs; ``gt_floor_scatterometry`` to JAX's on fixed GT arrays; the
port's ``chunk=`` to ``chunk=None``; and both grid drivers run end to end on
the CPU at a tiny size, their trees walked by ``get_best_model``."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

from dmip_tpu import gridsearch as jgs
from dmip_tpu import train as jtrain
from dmip_tpu.utils import config as jconfig
from dmip_tpu_torch import checkpoints, evaluate, gridsearch, train
from dmip_tpu_torch.mains import generate_scatterometry_ground_truth as gt
from dmip_tpu_torch.mains import get_best_model, run_grid_search_linear, run_grid_search_scatterometry
from dmip_tpu_torch.models import CDE
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.utils import check_wd, product_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "config_gridsearch_*.yml")))
DIMS = {"xdim": 2, "ydim": 2}


def _materialise(pkg, get_model, cfg):
    """(trial list, trial dirs, params from the dirs, groups) as grid_search
    builds them, by one package's functions."""
    visited, trials = [], []
    for trial_cfg in pkg.product_dict(**cfg["params"]):
        full = {**cfg, **trial_cfg}
        if not pkg.should_skip(full, visited):
            trials.append(trial_cfg)
    dirs = [pkg.trial_dir("root", {**cfg, **t}, get_model({**cfg, **t}, DIMS)[1].name) for t in trials]
    groups = {}
    for i, t in enumerate(trials):
        groups.setdefault(pkg.ensemble_signature(t), []).append(i)
    return trials, dirs, [pkg.get_params_from_path(d) for d in dirs], sorted(groups.values())


@pytest.mark.parametrize("path", GRID_CONFIGS, ids=os.path.basename)
def test_shipped_grids_materialise_as_in_jax(path):
    cfg = yaml.safe_load(open(path))
    assert list(product_dict(**cfg["params"])) == list(jconfig.product_dict(**cfg["params"]))
    ours = _materialise(gridsearch, train.get_model_from_args, cfg)
    theirs = _materialise(jgs, jtrain.get_model_from_args, cfg)
    assert ours == theirs
    assert len(ours[0]) in (12, 6, 135) and max(len(g) for g in ours[3]) >= 2


def test_pure_logic_on_the_jax_tests_inputs(tmp_path):
    assert list(product_dict(a=[1, 2], b=["x"])) == list(jconfig.product_dict(a=[1, 2], b=["x"]))
    cfgs = [
        {"pde_metric": "L1", "pde_loss": "cScoreFPE"},
        {"loss_fn": "DSM_PDE", "lam": 0.1, "pde_metric": "L2", "pde_loss": "FPE"},
        {"loss_fn": "DSM_PDE", "lam": 0.1, "pde_metric": "L2", "pde_loss": "FPE", "lam2": 99},
        {"loss_fn": "DSM_PDE", "lam": 0.1, "pde_metric": "L2", "pde_loss": "cScoreFPE"},
    ]
    visited, jvisited = [], []
    skips = [gridsearch.should_skip(c, visited) for c in cfgs]
    assert skips == [jgs.should_skip(c, jvisited) for c in cfgs] == [True, False, True, False]
    assert visited == jvisited
    for cfg, name in (({"pde_loss": "FPE", "pde_metric": "L1", "lam": 0.1}, "DSM_PDE"),
                      ({"pde_loss": "cScoreFPE", "pde_metric": "L2", "ic_metric": "L1", "lam": 1.0, "lam2": 0.01},
                       "PINNLoss")):
        assert gridsearch.trial_dir("root", cfg, name) == jgs.trial_dir("root", cfg, name)
    for p in ("FPE/PINNLoss/L1/L2/lam:0.1/lam2:0.01", "cScoreFPE/DSM_PDELoss/L2/lam:1.0", "x\\FPE\\PINNLoss2\\L1"):
        assert gridsearch.get_params_from_path(p) == jgs.get_params_from_path(p)
    d1 = tmp_path / "FPE" / "PINNLoss" / "L1" / "L2" / "lam:0.1" / "lam2:1.0"
    d2 = tmp_path / "FPE" / "DSM_PDELoss" / "L1" / "lam:1.0"
    d3 = tmp_path / "skipme" / "FPE" / "DSM_PDELoss" / "L1" / "lam:0.01"
    for d, kl, rev in ((d1, 0.5, ""), (d2, 0.2, ",KL_reverse"), (d3, 0.01, "")):
        d.mkdir(parents=True)
        extra = ",0.7" if rev else ""
        (d / "results.csv").write_text(f",KL2{rev},NLL_mcmc,NLL_diffusion,MSE\n0,{kl}{extra},1.0,1.5,0.3\n"
                                       f"1,{kl + 0.1}{extra},1.0,1.2,0.4\n")
    for exclude in ((), ("skipme",)):
        assert gridsearch.traverse_subfolders(str(tmp_path), exclude) == jgs.traverse_subfolders(str(tmp_path), exclude)
    assert get_best_model.main(["--src_dir", str(tmp_path), "--exclude", "skipme"])["kl"][1]["loss_fn"] == "DSM_PDELoss"


def test_check_wd_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    check_wd(tmp_path.name)
    jconfig.check_wd(tmp_path.name)
    for fn in (check_wd, jconfig.check_wd):
        with pytest.raises(ValueError, match="must be executed from the 'elsewhere' directory"):
            fn("elsewhere")


GRID = {
    "model": "CDE", "hidden_layers": [8],
    "params": {"loss_fn": ["PINNLoss", "DSM_PDE"], "lam": [1.0, 0.1], "lam2": [1.0, 0.01],
               "pde_loss": ["FPE", "cScoreFPE"], "pde_metric": ["L1", "L2"], "model": ["CDE"], "ic_metric": ["L2"]},
}


def _stubs(log):
    """train / train_many / evaluate stubs that record their calls and write
    a results.csv whose KL falls with lam and lam2."""

    def metric(cfg):
        return 10 * cfg["lam"] + cfg["lam2"] + (0.5 if cfg["pde_loss"] == "FPE" else 0.0)

    def fake_train(model, loss_cfg, cfg, tdir, log_dir):
        log.append(("train", cfg["lam"], cfg["lam2"]))
        return {"m": metric(cfg)}

    def fake_train_many(model, loss_cfg, cfgs, tdirs, log_dirs):
        log.append(("train_many", len(cfgs)))
        assert all(os.path.isdir(d) for d in log_dirs)
        return [{"m": metric(c)} for c in cfgs]

    def fake_eval(model, params, y_test, out_dir):
        log.append(("eval", params["m"]))
        with open(os.path.join(out_dir, "results.csv"), "w") as f:
            f.write(f",KL2,NLL_true,NLL_diffusion,MSE\n0,{params['m']},1.0,1.5,{params['m'] / 3}\n")
        return params["m"], 0.5, params["m"] / 3

    return fake_train, fake_train_many, fake_eval


def _tree(root):
    return sorted(os.path.relpath(d, root) for d, _, files in os.walk(root) if "results.csv" in files)


@pytest.mark.parametrize("host", [None, 0, 1])
def test_grid_search_with_stubs_matches_jax(tmp_path, host):
    """Same trial directories, calls, results order, best trials and
    grid_summary.csv rows as JAX's grid_search on the same stubs; then the
    skip_existing resume reuses every result untouched and calls nothing."""
    out, logs = {}, {}
    for name, pkg in (("torch", gridsearch), ("jax", jgs)):
        cfg = dict(GRID, src_dir=str(tmp_path / name))
        logs[name] = []
        tr, tm, ev = _stubs(logs[name])
        filt = None if host is None else (lambda idx, c: idx % 2 == host)
        out[name] = pkg.grid_search(None, cfg, DIMS, tr, ev, {}, {}, trial_filter=filt, train_many=tm)
    assert logs["torch"] == logs["jax"] and ("train_many", 2) in logs["torch"]
    assert out["torch"] == out["jax"]
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax") != []
    assert (tmp_path / "torch" / "grid_summary.csv").read_text() == (tmp_path / "jax" / "grid_summary.csv").read_text()

    stamps = {p: os.stat(p).st_mtime_ns for p in glob.glob(str(tmp_path / "torch" / "**" / "results.csv"),
                                                          recursive=True)}
    log = []
    tr, tm, ev = _stubs(log)
    cfg = dict(GRID, src_dir=str(tmp_path / "torch"))
    filt = None if host is None else (lambda idx, c: idx % 2 == host)
    again = gridsearch.grid_search(None, cfg, DIMS, tr, ev, {}, {}, trial_filter=filt, train_many=tm,
                                   skip_existing=True)
    assert log == [] and again == out["torch"]
    assert {p: os.stat(p).st_mtime_ns for p in stamps} == stamps


def test_grid_search_evaluates_a_checkpointed_trial_without_training(tmp_path):
    """Crash-resume: a trial with a checkpoint and no results is evaluated
    from the checkpoint (template model.init(seed 0)), on the device given."""
    cfg = dict(GRID, src_dir=str(tmp_path), params=dict(GRID["params"], loss_fn=["DSM_PDE"], lam=[0.1],
                                                         pde_loss=["FPE"], pde_metric=["L2"]))
    model, loss_cfg = train.get_model_from_args({**cfg, **next(product_dict(**cfg["params"]))}, DIMS)
    saved = model.init(torch.Generator().manual_seed(3))
    tdir = gridsearch.trial_dir(str(tmp_path), {"pde_loss": "FPE", "pde_metric": "L2", "lam": 0.1}, "DSM_PDE")
    checkpoints.save_checkpoint(os.path.join(tdir, "checkpoint"), saved, step=5)
    seen = []

    def fake_eval(model, params, y_test, out_dir):
        seen.append(params)
        return 1.0, 1.0, 1.0

    gridsearch.grid_search(None, cfg, DIMS, lambda *a: pytest.fail("trained"), fake_eval, {}, {},
                           skip_existing=True, device="cpu")
    assert len(seen) == 1 and all(torch.equal(a, b) for a, b in zip(checkpoints._leaves(seen[0]),
                                                                     checkpoints._leaves(saved)))


def test_gt_floor_matches_jax():
    """KL and reverse KL equal JAX's on the same GT arrays; sliced W2 (other
    random projections) agrees in distribution."""
    import jax

    from dmip_tpu import evaluate as jev

    rng = np.random.default_rng(0)
    gt_arr = rng.uniform(-1, 1, size=(3, 4, 2000, 3)).astype(np.float32)
    gt_arr[1] *= 0.5
    loader = lambda i, j: gt_arr[i, j]
    ours = evaluate.gt_floor_scatterometry(loader, 3, n_repeats=4, nbins=20)
    theirs = jev.gt_floor_scatterometry(loader, 3, n_repeats=4, nbins=20, key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(ours["kl"], theirs["kl"], rtol=1e-5)
    np.testing.assert_allclose(ours["kl_reverse"], theirs["kl_reverse"], rtol=1e-5)
    # W2 between two 4000-row halves of one distribution: noise of size
    # ~1/sqrt(4000) either way
    assert np.all(ours["w2"] < 0.05) and np.all(theirs["w2"] < 0.05)
    with pytest.raises(ValueError, match="n_repeats >= 2"):
        evaluate.gt_floor_scatterometry(loader, 1, n_repeats=1)


def test_chunk_gives_the_results_of_no_chunk(tmp_path, capsys):
    """chunk=2 walks 5 conditions as 2, 2, 1 with the results (and
    results.csv bytes) of chunk=None; the scatterometry heartbeat fires on
    the crossing of a progress_every boundary at a chunk's end."""
    prob = LinearForwardProblem()
    model = CDE(2, 2, (16, 16))
    params = model.init(torch.Generator().manual_seed(0))
    ys = prob.forward(torch.randn(5, 2, generator=torch.Generator().manual_seed(1)))
    common = dict(n_samples_x=200, n_repeats=2, num_steps=5, nbins=10, verbose=False)
    runs = {}
    for chunk in (None, 2):
        out = tmp_path / f"lin{chunk}"
        runs[chunk] = evaluate.evaluate_linear(model, params, prob, ys, torch.Generator().manual_seed(2),
                                               out_dir=str(out), chunk=chunk, **common)
    assert runs[None] == runs[2]
    assert (tmp_path / "linNone" / "results.csv").read_bytes() == (tmp_path / "lin2" / "results.csv").read_bytes()

    smodel = CDE(3, 4, (16, 16))
    sparams = smodel.init(torch.Generator().manual_seed(0))
    fwd = lambda x: torch.tanh(x @ torch.ones(3, 4) * 0.3)
    gt_arr = np.random.default_rng(0).uniform(-1, 1, size=(5, 2, 200, 3)).astype(np.float32)
    sys_ = fwd(torch.randn(5, 3, generator=torch.Generator().manual_seed(1)))
    fp = {"a": 0.2, "b": 0.01, "lambd_bd": 1000.0}
    res = {}
    for chunk in (None, 2):
        capsys.readouterr()
        res[chunk] = evaluate.evaluate_scatterometry(smodel, sparams, fwd, fp, lambda x, y: -x, sys_,
                                                     lambda i, j: gt_arr[i, j], torch.Generator().manual_seed(2),
                                                     chunk=chunk, progress_every=3, **common)
        beats = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[eval-scat]")]
        assert [b.split()[1] for b in beats] == (["3/5", "5/5"] if chunk is None else ["4/5", "5/5"])
    assert res[None] == res[2]
    with pytest.raises(ValueError, match="chunk"):
        evaluate.evaluate_linear(model, params, prob, ys, chunk=-1, **common)


TINY = dict(dataset_size=1200, n_epochs=2, epochs_per_call=1, batch_size=400, hidden_layers=[16, 16],
            n_samples_x=300, eval_n_repeats=1, eval_num_steps=8)


def _summary_min(src_dir):
    with open(os.path.join(src_dir, "grid_summary.csv")) as f:
        rows = [ln.strip().split(",") for ln in f]
    return min(float(r[rows[0].index("kl")]) for r in rows[1:]), len(rows) - 1


def test_linear_grid_driver_end_to_end_on_cpu(tmp_path):
    """config_gridsearch_linear_small.yml (12 trials, 6 ensemble groups),
    sizes cut: every trial's results and checkpoint, the summary, a resume
    that re-reads everything, and the walker's best KL = the summary's
    least.  Without a card the driver raises unless given --device cpu."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "config_gridsearch_linear_small.yml")))
    cfg.update(TINY, n_samples_y=2, src_dir=str(tmp_path / "grid"))
    path = tmp_path / "grid.yml"
    path.write_text(yaml.safe_dump(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_grid_search_linear.main(["--config", str(path)])
    run_grid_search_linear.main(["--config", str(path), "--device", "cpu"])
    least, n = _summary_min(cfg["src_dir"])
    assert n == 12 and len(_tree(cfg["src_dir"])) == 12
    manifests = glob.glob(os.path.join(cfg["src_dir"], "**", "checkpoint", "manifest.json"), recursive=True)
    assert len(manifests) == 12 and all(yaml.safe_load(open(m))["extra"]["lam2"] == 0.1 for m in manifests)
    stamps = {p: os.stat(p).st_mtime_ns for p in glob.glob(os.path.join(cfg["src_dir"], "**", "*.csv"),
                                                          recursive=True) if "grid_summary" not in p}
    cfg["skip_existing"] = True
    again = run_grid_search_linear.run(cfg, device="cpu")
    assert {p: os.stat(p).st_mtime_ns for p in stamps} == stamps and len(again["results"]) == 12
    best = get_best_model.main(["--src_dir", cfg["src_dir"]])
    assert best["kl"][0] == least and np.isfinite(least)


def test_scatterometry_grid_driver_end_to_end_on_cpu(tmp_path):
    """config_gridsearch_scatterometry_small.yml (6 trials in one group) on
    the GT driver's output for the same conditions, sizes cut, the
    sequential fallback (no_ensemble) and --n_hosts splitting the trials;
    without a card the driver raises unless given the CPU."""
    base = yaml.safe_load(open(os.path.join(REPO, "configs", "config_scatterometry.yml")))
    cfg = dict(base, **yaml.safe_load(open(os.path.join(REPO, "configs",
                                                        "config_gridsearch_scatterometry_small.yml"))))
    cfg.update(TINY, batch_size=100, n_samples_y=2, n_repeats=2, METR_STEPS=10, src_dir=str(tmp_path / "grid"))
    gpath = tmp_path / "gt.yml"
    gpath.write_text(yaml.safe_dump(cfg))
    gt.main(["--config", str(gpath), "--gt_dir", str(tmp_path / "gt"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_grid_search_scatterometry.run(cfg, str(tmp_path / "gt"))
    out = run_grid_search_scatterometry.run(cfg, str(tmp_path / "gt"), device="cpu")
    assert len(out["results"]) == 6 and all(np.isfinite(r["kl"]) for r in out["results"])
    assert _summary_min(cfg["src_dir"]) == (min(r["kl"] for r in out["results"]), 6)
    assert get_best_model.main(["--src_dir", cfg["src_dir"]])["kl"][0] == out["best_kl"][0]
    seq = dict(cfg, no_ensemble=True, n_epochs=1, src_dir=str(tmp_path / "seq"))
    path = tmp_path / "seq.yml"
    path.write_text(yaml.safe_dump(seq))
    run_grid_search_scatterometry.main(["--config", str(path), "--gt_dir", str(tmp_path / "gt"), "--device", "cpu",
                                        "--host", "1", "--n_hosts", "4"])
    assert len(_tree(seq["src_dir"])) == 2
