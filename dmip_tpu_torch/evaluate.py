"""Evaluation harnesses: histogram KL, NLPD, score-MSE and sliced W2.

Port of the single-device paths of ``dmip_tpu/evaluate.py``:
``histogramdd_flat`` (:37), ``kl_pair`` (:56), ``sliced_w2`` (:93),
``evaluate_linear`` (:439-563), ``evaluate_scatterometry`` (:566-772) and
``gt_floor_scatterometry`` (:357).
For each condition y, ``n_repeats`` x (posterior sampling + reference
samples), 75^d histograms on a fixed box, the eps-smoothed forward and
reverse histogram KL, the NLL under the true posterior (linear) or the MCMC
energy (scatterometry), score-MSE at t = 0 and sliced W2.  Both harnesses
write ``results.csv`` with the JAX package's columns, and for each condition
index in ``plot_ys`` the JAX package's corner plots of the last repeat's
samples (:534-546, :745-752), through :mod:`dmip_tpu_torch.utils.plotting`,
imported only then; the drivers call ``require_plotting`` before they
train, so a host without matplotlib fails at once.

``chunk=`` walks the conditions in groups of ``chunk`` with the results of
``chunk=None`` (the same draws in the same order); in the JAX package a
chunk is one dispatch, and batching a chunk into one pass here is the
eager evaluation's rework (ROADMAP.md C3).

``mesh=`` (None, the default; 'auto' or a Mesh, as the drivers pass it)
splits the conditions over the ranks, a block each.  Condition i then draws
from its own generator, seeded from one seed drawn from the caller's
generator and i, so its row does not depend on the number of ranks (a mesh
of one gives the rows of any other); without a mesh the walk keeps the
caller's one stream.  Rank 0 gathers the rows in condition order and the
plotted conditions' samples, and writes results.csv and the plots.
"""

from __future__ import annotations

import csv
import importlib
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.diffusion import DiffusionModel
from .parallel.mesh import Mesh, barrier, fold_in, is_writer
from .train import resolve_mesh

Tensor = torch.Tensor


def histogramdd_flat(x: Tensor, nbins: int, lo: float, hi: float) -> Tensor:
    """d-dimensional fixed-range histogram, flattened to (nbins**d,) int64
    counts, with np.histogramdd's edges: out-of-range points are dropped and
    points exactly on the upper edge land in the last bin."""
    d = x.shape[-1]
    width = (hi - lo) / nbins
    idx = torch.floor((x - lo) / width).to(torch.int64).clamp_(0, nbins - 1)
    in_range = torch.all((x >= lo) & (x <= hi), dim=-1)
    flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(d):
        flat = flat * nbins + idx[..., i]
    return torch.bincount(flat[in_range], minlength=nbins**d)


def kl_pair(
    hist_true: Tensor, hist_model: Tensor, epsilon: float = 1e-10
) -> Tuple[Tensor, Tensor]:
    """(forward KL, reverse KL) in float32: normalize, add eps, renormalize,
    sum the relative entropy.  An empty histogram becomes uniform-eps."""
    ht = hist_true.to(torch.float32)
    hm = hist_model.to(torch.float32)
    p = ht / torch.clamp(ht.sum(), min=1.0) + epsilon
    q = hm / torch.clamp(hm.sum(), min=1.0) + epsilon
    p = p / p.sum()
    q = q / q.sum()
    kl = torch.sum(p * (torch.log(p) - torch.log(q)))
    kl_rev = torch.sum(q * (torch.log(q) - torch.log(p)))
    return kl, kl_rev


def sliced_w2(
    x: Tensor,
    y: Tensor,
    n_proj: int = 128,
    generator: Optional[torch.Generator] = None,
    dirs: Optional[Tensor] = None,
) -> Tensor:
    """Sliced 2-Wasserstein distance between two equal-size sample sets:
    the exact 1-D W2 (sorted quantiles) averaged over random unit
    directions, given as ``dirs`` (n_proj, d) or drawn from ``generator``."""
    if dirs is None:
        gen_dev = generator.device if generator is not None else x.device
        dirs = torch.randn(n_proj, x.shape[-1], generator=generator, device=gen_dev).to(x.device)
    dirs = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)
    px = torch.sort(x @ dirs.T, dim=0).values
    py = torch.sort(y @ dirs.T, dim=0).values
    return torch.sqrt(torch.mean((px - py) ** 2))


def _score_mse(model: DiffusionModel, params, x_true: Tensor, ys: Tensor, score_true: Tensor) -> Tensor:
    t0 = torch.zeros(x_true.shape[0], 1, device=x_true.device)
    g0 = model.sde.base.g(t0)
    score_pred = (model.apply_a(params, x_true, ys, t0) / g0)[:, : x_true.shape[-1]]
    return torch.mean(torch.sum((score_pred - score_true) ** 2, dim=1))


def require_plotting(plot_ys: Sequence[int]) -> None:
    """Raises ImportError at once when ``plot_ys`` asks for figures and the
    plotting module (matplotlib) cannot be imported, so that a driver stops
    before it trains rather than at its first figure."""
    if not plot_ys:
        return
    try:
        importlib.import_module(".utils.plotting", __package__)
    except ImportError as e:
        raise ImportError(f"plot_ys {list(plot_ys)} asks for corner plots, which need matplotlib: "
                          "install it, or set plot_ys: [] in the config") from e


def plot_posteriors(out_dir: str, i: int, samples: Dict[str, Tensor], nbins: int, xlim: Tuple[float, float],
                    xticks, show_mean: bool = False) -> None:
    """``posterior-<tag>-<i>.svg`` in ``out_dir`` for each (tag, samples),
    with the JAX drivers' arguments: ``nbins`` bins on the box ``xlim``,
    size (12, 12), label size 30.  Off rank 0 of a multi-rank run, nothing
    (``parallel.is_writer``)."""
    if not is_writer():
        return
    from .utils.plotting import plot_density

    os.makedirs(out_dir, exist_ok=True)
    for tag, x in samples.items():
        plot_density(x.detach().cpu().numpy(), nbins, limits=xlim, xticks=xticks, size=(12, 12), labelsize=30,
                     show_mean=show_mean, fname=os.path.join(out_dir, f"posterior-{tag}-{i}.svg"))


def _write_results_csv(path: str, columns: Dict[str, Sequence[float]]) -> None:
    if not is_writer():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys = list(columns.keys())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + keys)
        for i in range(len(columns[keys[0]])):
            w.writerow([i] + [columns[k][i] for k in keys])


def _chunk_size(chunk: Optional[int]) -> int:
    """Conditions per chunk: ``chunk``, or 1 for None, 0 or 1 (the configs'
    ``eval_chunk: 0`` means none).  Anything but None or an int >= 0
    raises."""
    if chunk is None:
        return 1
    if int(chunk) != chunk or chunk < 0:
        raise ValueError(f"chunk must be None or a non-negative int, got {chunk!r}")
    return max(int(chunk), 1)


def _condition_order(n_y: int, chunk: Optional[int]):
    """The conditions 0 .. n_y - 1, walked chunk by chunk."""
    step = _chunk_size(chunk)
    for c0 in range(0, n_y, step):
        yield from range(c0, min(c0 + step, n_y))


def _walk(n_y: int, chunk: Optional[int], generator: Optional[torch.Generator], mesh: Optional[Mesh], device):
    """(the conditions this process evaluates, in order; condition i ->
    its generator).  Without a mesh: every condition, chunk by chunk, each
    from the caller's generator.  With one: this rank's block, condition i
    from a generator seeded by ``fold_in(seed, i)``, the seed drawn once
    from the caller's generator (rank 0's, broadcast)."""
    order = list(_condition_order(n_y, chunk))
    if mesh is None:
        return order, lambda i: generator
    gen_dev = generator.device if generator is not None else "cpu"
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=gen_dev)
    seed = int(mesh.broadcast(seed.to(mesh.device)))
    return order[mesh.rows(n_y)], lambda i: torch.Generator(device=device).manual_seed(fold_in(seed, i))


def _gather(cols: Dict[str, list], plots: Dict[int, Dict[str, Tensor]], mesh: Optional[Mesh]):
    """Every rank's rows (a block of conditions each, in rank order), so in
    condition order, and every rank's plot samples, on every rank."""
    if mesh is None:
        return cols, plots
    parts = mesh.all_gather_objects((cols, {i: {k: x.cpu() for k, x in p.items()} for i, p in plots.items()}))
    return {k: [v for c, _ in parts for v in c[k]] for k in cols}, {i: p for _, ps in parts for i, p in ps.items()}


def _write(out_dir: Optional[str], cols: Dict[str, Sequence[float]], plots: Dict[int, Dict[str, Tensor]],
           mesh: Optional[Mesh], nbins: int, xlim: Tuple[float, float], xticks, show_mean: bool = False) -> None:
    """results.csv and the corner plots of every condition in ``plots``
    into ``out_dir``; every rank returns once they are written."""
    if out_dir is not None:
        _write_results_csv(os.path.join(out_dir, "results.csv"), cols)
        for i, samples in sorted(plots.items()):
            plot_posteriors(out_dir, i, samples, nbins, xlim, xticks, show_mean=show_mean)
    barrier(mesh)


@torch.no_grad()
def gt_floor_scatterometry(
    gt_loader: Callable[[int, int], np.ndarray],
    n_conditions: int,
    n_repeats: int = 10,
    nbins: int = 75,
    xlim: Tuple[float, float] = (-1.2, 1.2),
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """The GT-against-GT floor of the metrics, per condition: each
    condition's first n_repeats // 2 ground-truth repeats against the next
    n_repeats // 2, by the evaluation's histogram KL (both directions) and
    sliced W2 (projections drawn from ``generator``, by default one seeded
    with 0).  A model's KL near this floor is at the metric's resolution.
    Arrays go to ``device`` (default: the loader's tensors' own, else the
    CPU).  Returns {'kl', 'kl_reverse', 'w2'}, each of shape
    (n_conditions,)."""
    lo, hi = xlim
    half = n_repeats // 2
    if half < 1:
        raise ValueError("need n_repeats >= 2 to split GT into halves")
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    out = {"kl": [], "kl_reverse": [], "w2": []}
    for i in range(n_conditions):
        a = torch.cat([as_t(gt_loader(i, j)) for j in range(half)])
        b = torch.cat([as_t(gt_loader(i, j)) for j in range(half, 2 * half)])
        if generator is None:
            generator = torch.Generator(device=a.device).manual_seed(0)
        kl, kl_rev = kl_pair(histogramdd_flat(a, nbins, lo, hi), histogramdd_flat(b, nbins, lo, hi))
        n = min(a.shape[0], b.shape[0])
        w2 = sliced_w2(a[:n], b[:n], generator=generator)
        for k, v in zip(out, (kl, kl_rev, w2)):
            out[k].append(float(v))
    return {k: np.asarray(v) for k, v in out.items()}


@torch.no_grad()
def evaluate_linear(
    model: DiffusionModel,
    params,
    problem,
    ys: Tensor,
    generator: Optional[torch.Generator] = None,
    out_dir: Optional[str] = None,
    n_samples_x: int = 5000,
    n_repeats: int = 10,
    num_steps: int = 200,
    nbins: int = 75,
    xlim: Tuple[float, float] = (-3.5, 3.5),
    verbose: bool = True,
    method: str = "auto",
    plot_ys: Sequence[int] = (),
    chunk: Optional[int] = None,
    mesh=None,
) -> Tuple[float, float, float]:
    """Linear evaluation against the analytic posterior; returns (mean KL,
    mean NLPD, mean score-MSE).  Runs on ys's device.  results.csv columns:
    KL2, NLL_true, NLL_diffusion, MSE, W2.  With ``out_dir``, each condition
    index in ``plot_ys`` gets ``posterior-{true,diffusion}-<i>.svg`` of the
    last repeat's samples.  ``chunk`` and ``mesh``: see the module
    docstring."""
    lo, hi = xlim
    mesh = resolve_mesh(mesh)
    cols = {"KL2": [], "NLL_true": [], "NLL_diffusion": [], "MSE": [], "W2": []}
    plots = {}
    conditions, generator_of = _walk(ys.shape[0], chunk, generator, mesh, ys.device)
    for i in conditions:
        y = ys[i]
        generator = generator_of(i)
        hist_t = hist_p = 0
        stats = []
        for _ in range(n_repeats):
            x_pred = model.sample(
                params, y, n_samples_x, num_steps, generator=generator,
                device=ys.device, method=method,
            )
            x_true = problem.sample_posterior(y, n_samples_x, generator)
            w2 = sliced_w2(x_pred, x_true, generator=generator)
            ys_tiled = y.expand(n_samples_x, y.shape[-1])
            mse = _score_mse(model, params, x_true, ys_tiled, problem.score_posterior(x_true, ys_tiled))
            hist_t = hist_t + histogramdd_flat(x_true, nbins, lo, hi)
            hist_p = hist_p + histogramdd_flat(x_pred, nbins, lo, hi)
            nll_t = -torch.mean(problem.posterior_log_prob(x_true, y))
            nll_p = -torch.mean(problem.posterior_log_prob(x_pred, y))
            stats.append(torch.stack([nll_t, nll_p, mse, w2]))
        if out_dir is not None and i in plot_ys:
            plots[i] = {"true": x_true, "diffusion": x_pred}
        kl, _ = kl_pair(hist_t, hist_p)
        nll_t, nll_p, mse, w2 = torch.stack(stats).mean(0).tolist()
        for k, v in zip(cols, (float(kl), nll_t, nll_p, mse, w2)):
            cols[k].append(v)
    cols, plots = _gather(cols, plots, mesh)
    kl_arr = np.asarray(cols["KL2"])
    nlpd = np.abs(np.asarray(cols["NLL_true"]) - np.asarray(cols["NLL_diffusion"]))
    _write(out_dir, cols, plots, mesh, nbins, xlim, list(xlim), show_mean=True)
    if verbose:
        var = np.sum((kl_arr - kl_arr.mean()) ** 2) / len(kl_arr)
        print(f"KL2: {kl_arr.mean()} +- {var}")
    return float(kl_arr.mean()), float(nlpd.mean()), float(np.mean(cols["MSE"]))


@torch.no_grad()
def evaluate_scatterometry(
    model: DiffusionModel,
    params,
    forward_model: Callable[[Tensor], Tensor],
    fparams: Dict[str, float],
    score_posterior_fn: Callable[[Tensor, Tensor], Tensor],
    ys: Tensor,
    gt_loader: Callable[[int, int], np.ndarray],
    generator: Optional[torch.Generator] = None,
    out_dir: Optional[str] = None,
    n_samples_x: int = 30000,
    n_repeats: int = 10,
    num_steps: int = 200,
    nbins: int = 75,
    xlim: Tuple[float, float] = (-1.2, 1.2),
    verbose: bool = True,
    method: str = "auto",
    progress_every: int = 0,
    plot_ys: Sequence[int] = (),
    chunk: Optional[int] = None,
    mesh=None,
) -> Tuple[float, float, float]:
    """Scatterometry evaluation against MCMC ground truth; ``gt_loader(i, j)``
    gives condition i's repeat j (each rank loads only its conditions').
    Returns (mean KL, mean NLPD, mean score-MSE).  Runs on ys's device.
    results.csv columns: KL2, KL_reverse, NLL_mcmc, NLL_diffusion, MSE, W2.

    ``progress_every=N`` prints a flushed heartbeat with the running rate
    each time the count of finished conditions crosses a multiple of N, and
    after the last one (``dmip_tpu/evaluate.py:635-650``'s rule), counted
    at the end of each chunk; with a mesh each rank counts its own
    conditions.  With ``out_dir``, each condition index in ``plot_ys`` gets
    ``posterior-{mcmc,diffusion}-<i>.svg`` of the last repeat's samples.
    ``chunk`` and ``mesh``: see the module docstring."""
    from .problems.scatterometry import get_log_posterior

    lo, hi = xlim
    dev = ys.device
    mesh = resolve_mesh(mesh)
    a, b, lambd_bd = fparams["a"], fparams["b"], fparams["lambd_bd"]
    cols = {"KL2": [], "KL_reverse": [], "NLL_mcmc": [], "NLL_diffusion": [], "MSE": [], "W2": []}
    plots = {}
    t_start = time.time()
    step = _chunk_size(chunk)
    conditions, generator_of = _walk(ys.shape[0], chunk, generator, mesh, dev)
    n_y = len(conditions)
    for done, i in enumerate(conditions, 1):
        y = ys[i]
        generator = generator_of(i)

        def energy(x):
            return get_log_posterior(x, forward_model, a, b, y.expand(x.shape[0], -1), lambd_bd)

        hist_t = hist_p = 0
        stats = []
        for j in range(n_repeats):
            x_true = torch.as_tensor(gt_loader(i, j), dtype=torch.float32, device=dev)
            x_pred = model.sample(
                params, y, n_samples_x, num_steps, generator=generator, device=dev, method=method
            )
            n_w2 = min(n_samples_x, x_true.shape[0])
            w2 = sliced_w2(x_pred[:n_w2], x_true[:n_w2], generator=generator)
            ys_true = y.expand(x_true.shape[0], -1)
            mse = _score_mse(model, params, x_true, ys_true, score_posterior_fn(x_true, ys_true))
            hist_t = hist_t + histogramdd_flat(x_true, nbins, lo, hi)
            hist_p = hist_p + histogramdd_flat(x_pred, nbins, lo, hi)
            stats.append(torch.stack([torch.mean(energy(x_true)), torch.mean(energy(x_pred)), mse, w2]))
        if out_dir is not None and i in plot_ys:
            plots[i] = {"mcmc": x_true, "diffusion": x_pred}
        kl, kl_rev = kl_pair(hist_t, hist_p)
        nll_t, nll_p, mse, w2 = torch.stack(stats).mean(0).tolist()
        for k, v in zip(cols, (float(kl), float(kl_rev), nll_t, nll_p, mse, w2)):
            cols[k].append(v)
        if done % step and done != n_y:
            continue  # inside a chunk
        prev = done - (done % step or step)
        if progress_every and (done // progress_every > prev // progress_every or done == n_y):
            rate = done / max(time.time() - t_start, 1e-9)
            print(f"[eval-scat] {done}/{n_y} conditions ({rate:.2f} cond/s, {n_repeats} repeats)", flush=True)
    cols, plots = _gather(cols, plots, mesh)
    kl_arr = np.asarray(cols["KL2"])
    nlpd = np.abs(np.asarray(cols["NLL_diffusion"]) - np.asarray(cols["NLL_mcmc"]))
    _write(out_dir, cols, plots, mesh, nbins, xlim, [-1, 0, 1])
    if verbose:
        var = np.sum((kl_arr - kl_arr.mean()) ** 2) / len(kl_arr)
        print(f"KL2: {kl_arr.mean()} +- {var}  W2: {np.mean(cols['W2']):.4f}")
    return float(kl_arr.mean()), float(nlpd.mean()), float(np.mean(cols["MSE"]))
