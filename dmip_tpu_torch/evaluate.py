"""Evaluation harnesses and their engine: histogram KL, NLPD, score-MSE
and sliced W2.

Port of ``dmip_tpu/evaluate.py``: ``histogramdd_flat`` (:37), ``kl_pair``
(:56), ``sliced_w2`` (:93), the compiled evaluation ``make_eval_y_linear``
(:108), ``make_eval_y_scatterometry`` (:175), ``make_eval_many_linear``
(:242) and ``make_eval_many_scatterometry`` (:297), ``evaluate_linear``
(:439-563), ``evaluate_scatterometry`` (:566-772) and
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

The engine.  The JAX package jits a condition's evaluation (the repeats
under ``lax.map``) and a chunk of conditions into one dispatch.  Here the
callables that ``make_eval_y_*`` and ``make_eval_many_*`` return queue the
same work on the device and leave every result there: nothing inside reads
a value back to the host, so on a card the host queues a whole chunk while
the card runs it.  The samplers take their Philox seed as a device tensor,
the histograms count without a boolean mask, and the ground truth reaches
the card from pinned memory.  ``evaluate_*`` read the results once per
chunk of ``chunk`` conditions, or once per condition for ``chunk=None``,
with the same rows either way (the same draws in the same order).

``mesh=`` (None, the default; 'auto' or a Mesh, as the drivers pass it)
splits the conditions over the ranks, a block each, which each rank walks
in chunks.  Condition i then draws from its own generator, seeded from one
seed drawn from the caller's generator and i, so its row does not depend on
the number of ranks (a mesh of one gives the rows of any other); without a
mesh the walk keeps the caller's one stream.  Rank 0 gathers the rows in
condition order and the plotted conditions' samples, and writes
results.csv and the plots.
"""

from __future__ import annotations

import csv
import importlib
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.diffusion import DiffusionModel
from .parallel.mesh import Mesh, barrier, fold_in, is_writer
from .train import resolve_mesh
from .utils import profiling

Tensor = torch.Tensor

# a condition's statistics, in the order the engine stacks them for its one read
STATS = ("kl", "kl_reverse", "nll_true", "nll_model", "mse_score", "w2")


def histogramdd_flat(x: Tensor, nbins: int, lo: float, hi: float) -> Tensor:
    """d-dimensional fixed-range histogram, flattened to (nbins**d,) int64
    counts, with np.histogramdd's edges: out-of-range points are dropped and
    points exactly on the upper edge land in the last bin.  A dropped point
    is counted in one extra bin, cut off at the end, so nothing waits for
    the device (a boolean mask and ``bincount`` would read back sizes)."""
    d = x.shape[-1]
    width = (hi - lo) / nbins
    idx = torch.floor((x - lo) / width).to(torch.int64).clamp_(0, nbins - 1)
    in_range = torch.all((x >= lo) & (x <= hi), dim=-1)
    flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(d):
        flat = flat * nbins + idx[..., i]
    flat = torch.where(in_range, flat, nbins**d)
    counts = torch.zeros(nbins**d + 1, dtype=torch.int64, device=x.device)
    return counts.index_add_(0, flat, torch.ones_like(flat))[:-1]


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


def _condition(hist_t: Tensor, hist_p: Tensor, stats: List[Tensor]) -> Dict[str, Tensor]:
    """A condition's statistics from its summed histograms and its repeats'
    (nll_true, nll_model, mse, w2) rows: the KL pair of the sums and the
    rows' mean, each a 0-d tensor."""
    kl, kl_rev = kl_pair(hist_t, hist_p)
    nll_t, nll_p, mse, w2 = torch.stack(stats).mean(0)
    return dict(kl=kl, kl_reverse=kl_rev, nll_true=nll_t, nll_model=nll_p, mse_score=mse, w2=w2)


def make_eval_y_linear(
    model: DiffusionModel,
    problem,
    n_samples_x: int,
    n_repeats: int,
    num_steps: int = 200,
    nbins: int = 75,
    xlim: Tuple[float, float] = (-3.5, 3.5),
    method: str = "auto",
):
    """One condition of the linear problem against its analytic posterior
    (``dmip_tpu/evaluate.py:108``): returns eval_y(params, generator, y) ->
    {'kl', 'kl_reverse', 'nll_true', 'nll_model', 'mse_score', 'w2'} (0-d
    tensors; histograms summed over the repeats, the rest averaged) and the
    last repeat's samples 'x_pred_last' and 'x_true_last', all on y's
    device and none read back.  Each of the ``n_repeats`` repeats draws
    from ``generator``: the sampler's x0 and seed, the posterior reference,
    the W2 directions.  ``method`` picks the sampler (``model.sample``)."""
    lo, hi = xlim

    def one_repeat(params, generator, y):
        x_pred = model.sample(params, y, n_samples_x, num_steps, generator=generator, device=y.device,
                              method=method)
        x_true = problem.sample_posterior(y, n_samples_x, generator)
        w2 = sliced_w2(x_pred, x_true, generator=generator)
        ys_tiled = y.expand(n_samples_x, y.shape[-1])
        mse = _score_mse(model, params, x_true, ys_tiled, problem.score_posterior(x_true, ys_tiled))
        nll_t = -torch.mean(problem.posterior_log_prob(x_true, y))
        nll_p = -torch.mean(problem.posterior_log_prob(x_pred, y))
        return (histogramdd_flat(x_true, nbins, lo, hi), histogramdd_flat(x_pred, nbins, lo, hi),
                torch.stack([nll_t, nll_p, mse, w2]), x_pred, x_true)

    @torch.no_grad()
    def eval_y(params, generator: Optional[torch.Generator], y: Tensor) -> Dict[str, Tensor]:
        hist_t = hist_p = 0
        stats = []
        for _ in range(n_repeats):
            h_t, h_p, row, x_pred, x_true = one_repeat(params, generator, y)
            hist_t, hist_p = hist_t + h_t, hist_p + h_p
            stats.append(row)
        return dict(_condition(hist_t, hist_p, stats), x_pred_last=x_pred, x_true_last=x_true)

    return eval_y


def make_eval_y_scatterometry(
    model: DiffusionModel,
    forward_model: Callable[[Tensor], Tensor],
    fparams: Dict[str, float],
    score_posterior_fn: Callable[[Tensor, Tensor], Tensor],
    n_samples_x: int,
    num_steps: int = 200,
    nbins: int = 75,
    xlim: Tuple[float, float] = (-1.2, 1.2),
    method: str = "auto",
):
    """One (condition, repeat) of scatterometry against an MCMC ground-truth
    repeat (``dmip_tpu/evaluate.py:175``): returns eval_y_repeat(params,
    generator, y, x_true) -> {'hist_true', 'hist_model', 'nll_true',
    'nll_model', 'mse_score', 'w2', 'x_pred'} on y's device, none read
    back; x_true goes to y's device without a wait when it lies in pinned
    memory.  It draws the sampler's x0 and seed, then the W2 directions,
    from ``generator``.  ``eval_y_repeat.eval_y(params, generator, y,
    x_trues)`` runs one repeat for each ground-truth repeat in ``x_trues``
    and gives the condition's statistics as :func:`make_eval_y_linear`'s
    eval_y does, 'x_true_last' the last repeat's on the device."""
    from .problems.scatterometry import get_log_posterior

    lo, hi = xlim
    a, b, lambd_bd = fparams["a"], fparams["b"], fparams["lambd_bd"]

    @torch.no_grad()
    def eval_y_repeat(params, generator: Optional[torch.Generator], y: Tensor, x_true: Tensor) -> Dict[str, Tensor]:
        x_true = x_true.to(device=y.device, dtype=torch.float32, non_blocking=True)

        def energy(x):
            return get_log_posterior(x, forward_model, a, b, y.expand(x.shape[0], -1), lambd_bd)

        x_pred = model.sample(params, y, n_samples_x, num_steps, generator=generator, device=y.device, method=method)
        # the 1-D quantile distance needs equal counts: both cut to the smaller
        n_w2 = min(n_samples_x, x_true.shape[0])
        w2 = sliced_w2(x_pred[:n_w2], x_true[:n_w2], generator=generator)
        ys_true = y.expand(x_true.shape[0], -1)
        mse = _score_mse(model, params, x_true, ys_true, score_posterior_fn(x_true, ys_true))
        return dict(hist_true=histogramdd_flat(x_true, nbins, lo, hi),
                    hist_model=histogramdd_flat(x_pred, nbins, lo, hi), nll_true=torch.mean(energy(x_true)),
                    nll_model=torch.mean(energy(x_pred)), mse_score=mse, w2=w2, x_pred=x_pred)

    @torch.no_grad()
    def eval_y(params, generator: Optional[torch.Generator], y: Tensor, x_trues: Sequence[Tensor]) -> Dict[str, Tensor]:
        hist_t = hist_p = 0
        stats = []
        for x_true in x_trues:
            x_true = x_true.to(device=y.device, dtype=torch.float32, non_blocking=True)
            r = eval_y_repeat(params, generator, y, x_true)
            hist_t, hist_p = hist_t + r["hist_true"], hist_p + r["hist_model"]
            stats.append(torch.stack([r["nll_true"], r["nll_model"], r["mse_score"], r["w2"]]))
        return dict(_condition(hist_t, hist_p, stats), x_pred_last=r["x_pred"], x_true_last=x_true)

    eval_y_repeat.eval_y = eval_y
    return eval_y_repeat


def _eval_many(mesh: Optional[Mesh], n: int, generators, one: Callable[[int, torch.Generator], Dict[str, Tensor]],
               keep: Sequence[int]) -> Dict[str, object]:
    """``one(i, generator_i)`` for the chunk's conditions i = 0 .. n - 1 (this
    rank's block of them with a mesh), queued back to back; each statistic
    stacked on the device, (n,), gathered over the ranks with a mesh; and
    'samples', {i: the last repeat's 'x_pred_last' and 'x_true_last'} for
    the i in ``keep`` this process evaluated."""
    gens = list(generators) if isinstance(generators, (list, tuple)) else [generators] * n
    if len(gens) != n:
        raise ValueError(f"{len(gens)} generators for {n} conditions")
    rows = range(n)
    if mesh is not None:
        if n % mesh.size:
            raise ValueError(f"a chunk of {n} conditions does not split over {mesh.size} ranks")
        rows = range(n)[mesh.rows(n)]
    with profiling.span("eval.chunk"):
        stats = {k: [] for k in STATS}
        samples = {}
        for i in rows:
            with profiling.span("eval.condition"):
                out = one(i, gens[i])
            for k in STATS:
                stats[k].append(out[k])
            if i in keep:
                samples[i] = {k: out[k] for k in ("x_pred_last", "x_true_last")}
        stacked = {k: torch.stack(v) for k, v in stats.items()}
        if mesh is not None:
            stacked = {k: mesh.all_gather(v) for k, v in stacked.items()}
        return dict(stacked, samples=samples)


def make_eval_many_linear(
    model: DiffusionModel,
    problem,
    n_samples_x: int,
    n_repeats: int,
    num_steps: int = 200,
    nbins: int = 75,
    xlim: Tuple[float, float] = (-3.5, 3.5),
    mesh: Optional[Mesh] = None,
    method: str = "auto",
):
    """A chunk of linear conditions (``dmip_tpu/evaluate.py:242``): returns
    eval_many(params, generators, ys, keep=()) -> each statistic of
    :func:`make_eval_y_linear`'s eval_y stacked on the device, shape
    (len(ys),), and 'samples' ({i: the last repeat's samples} for the chunk
    positions i in ``keep``).  Condition i draws from ``generators[i]``
    (one generator: all of them from it, in condition order); the
    conditions are queued back to back and nothing is read back.  With a
    ``mesh`` each rank evaluates its block of the chunk (len(ys) a multiple
    of the mesh size) and every rank returns the whole chunk's statistics."""
    eval_y = make_eval_y_linear(model, problem, n_samples_x, n_repeats, num_steps, nbins, xlim, method=method)

    def eval_many(params, generators, ys: Tensor, keep: Sequence[int] = ()):
        return _eval_many(mesh, ys.shape[0], generators, lambda i, g: eval_y(params, g, ys[i]), keep)

    return eval_many


def make_eval_many_scatterometry(
    model: DiffusionModel,
    forward_model: Callable[[Tensor], Tensor],
    fparams: Dict[str, float],
    score_posterior_fn: Callable[[Tensor, Tensor], Tensor],
    n_samples_x: int,
    num_steps: int = 200,
    nbins: int = 75,
    xlim: Tuple[float, float] = (-1.2, 1.2),
    mesh: Optional[Mesh] = None,
    method: str = "auto",
):
    """A chunk of scatterometry conditions (``dmip_tpu/evaluate.py:297``):
    returns eval_many(params, generators, ys, x_trues, keep=()) as
    :func:`make_eval_many_linear`'s, ``x_trues[i]`` condition i's
    ground-truth repeats (their count is the repeats'; see
    :func:`stage_ground_truth`)."""
    eval_y = make_eval_y_scatterometry(model, forward_model, fparams, score_posterior_fn, n_samples_x, num_steps,
                                       nbins, xlim, method=method).eval_y

    def eval_many(params, generators, ys: Tensor, x_trues: Sequence[Sequence[Tensor]], keep: Sequence[int] = ()):
        return _eval_many(mesh, ys.shape[0], generators, lambda i, g: eval_y(params, g, ys[i], x_trues[i]), keep)

    return eval_many


def stage_ground_truth(gt_loader: Callable[[int, int], np.ndarray], conditions: Sequence[int], n_repeats: int,
                       device) -> List[List[Tensor]]:
    """The conditions' ground-truth repeats as float32 tensors, read before
    a chunk's first launch: for a CUDA device in pinned host memory (or on
    the device, where the loader keeps them), so that each copies to the
    card without waiting for it; else as loaded."""
    pin = torch.device(device).type == "cuda"

    def load(i, j):
        t = torch.as_tensor(gt_loader(i, j), dtype=torch.float32)
        return t.pin_memory() if pin and t.device.type == "cpu" else t

    return [[load(i, j) for j in range(n_repeats)] for i in conditions]


def read_stats(out: Dict[str, Tensor]) -> List[List[float]]:
    """The chunk's statistics on the host, one row of STATS a condition: the
    chunk's one read, the one wait for the card (``host_waits``)."""
    with profiling.span("eval.read"):
        profiling.count("host_waits")
        return torch.stack([out[k] for k in STATS], dim=1).tolist()


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


def _chunks(conditions: range, chunk: Optional[int]) -> List[range]:
    """``conditions`` (a range) in consecutive chunks of ``_chunk_size(chunk)``."""
    step = _chunk_size(chunk)
    return [range(c0, min(c0 + step, conditions.stop)) for c0 in range(conditions.start, conditions.stop, step)]


def _walk(n_y: int, generator: Optional[torch.Generator], mesh: Optional[Mesh], device):
    """(the conditions this process evaluates, a range; condition i -> its
    generator).  Without a mesh: every condition, each from the caller's
    generator.  With one: this rank's block, condition i from a generator
    seeded by ``fold_in(seed, i)``, the seed drawn once from the caller's
    generator (rank 0's, broadcast)."""
    if mesh is None:
        return range(n_y), lambda i: generator
    gen_dev = generator.device if generator is not None else "cpu"
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=gen_dev)
    seed = int(mesh.broadcast(seed.to(mesh.device)))
    return range(n_y)[mesh.rows(n_y)], lambda i: torch.Generator(device=device).manual_seed(fold_in(seed, i))


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
    mesh = resolve_mesh(mesh)
    cols = {"KL2": [], "NLL_true": [], "NLL_diffusion": [], "MSE": [], "W2": []}
    plots = {}
    conditions, generator_of = _walk(ys.shape[0], generator, mesh, ys.device)
    eval_many = make_eval_many_linear(model, problem, n_samples_x, n_repeats, num_steps, nbins, xlim, method=method)
    for block in _chunks(conditions, chunk):
        keep = [j for j, i in enumerate(block) if out_dir is not None and i in plot_ys]
        out = eval_many(params, [generator_of(i) for i in block], ys[block.start:block.stop], keep=keep)
        for kl, _, nll_t, nll_p, mse, w2 in read_stats(out):
            for k, v in zip(cols, (kl, nll_t, nll_p, mse, w2)):
                cols[k].append(v)
        for j, x in out["samples"].items():
            plots[block[j]] = {"true": x["x_true_last"], "diffusion": x["x_pred_last"]}
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
    dev = ys.device
    mesh = resolve_mesh(mesh)
    cols = {"KL2": [], "KL_reverse": [], "NLL_mcmc": [], "NLL_diffusion": [], "MSE": [], "W2": []}
    plots = {}
    t_start = time.time()
    conditions, generator_of = _walk(ys.shape[0], generator, mesh, dev)
    eval_many = make_eval_many_scatterometry(model, forward_model, fparams, score_posterior_fn, n_samples_x,
                                             num_steps, nbins, xlim, method=method)
    n_y, done = len(conditions), 0
    for block in _chunks(conditions, chunk):
        x_trues = stage_ground_truth(gt_loader, block, n_repeats, dev)
        keep = [j for j, i in enumerate(block) if out_dir is not None and i in plot_ys]
        out = eval_many(params, [generator_of(i) for i in block], ys[block.start:block.stop], x_trues, keep=keep)
        for row in read_stats(out):
            for k, v in zip(cols, row):
                cols[k].append(v)
        for j, x in out["samples"].items():
            plots[block[j]] = {"mcmc": x["x_true_last"], "diffusion": x["x_pred_last"]}
        done += len(block)
        if progress_every and (done // progress_every > (done - len(block)) // progress_every or done == n_y):
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
