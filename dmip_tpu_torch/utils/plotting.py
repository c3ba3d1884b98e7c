"""Corner-style density plots and loss-curve plots.

The port's own copy of ``dmip_tpu/utils/plotting.py`` (``plot_density``
:32, ``plot_csv`` :122): the same calls in the same order, so that under a
fixed ``SOURCE_DATE_EPOCH`` and ``svg.hashsalt`` both write the same SVG
bytes.  Headless (Agg backend); seaborn is optional, and without it despine
removes the spines through matplotlib.  This module imports matplotlib, so
the package imports it only where a figure is drawn: nothing else in
``dmip_tpu_torch`` needs matplotlib.
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

try:  # seaborn only for despine cosmetics
    import seaborn as sns

    def _despine(**kw):
        sns.despine(**kw)

except ImportError:  # pragma: no cover

    def _despine(left=False, top=True, right=True, bottom=False):
        for ax in plt.gcf().axes:
            for side, off in (
                ("left", left), ("top", top), ("right", right), ("bottom", bottom)
            ):
                if off:
                    ax.spines[side].set_visible(False)


def plot_density(
    samples: np.ndarray,
    nbins: int,
    size=(12, 12),
    labelsize: int = 12,
    show: bool = False,
    cmap: str = "viridis",
    limits=None,
    fname=None,
    xticks=None,
    show_mean: bool = False,
):
    """Grid of 1D histogram diagonals and 2D histograms in the upper
    triangle, the lower triangle blanked, an optional mode line; written to
    ``fname`` (SVG by its extension)."""
    samples = np.asarray(samples)
    n_samples, n_dims = samples.shape
    fig, axes = plt.subplots(n_dims, n_dims, figsize=size, squeeze=False)
    for i in range(n_dims):
        for j in range(n_dims):
            ax = axes[i, j]
            if i == j:
                if limits:
                    bins = np.linspace(limits[0], limits[1], nbins)
                else:
                    bins = np.linspace(
                        np.min(samples[:, i]), np.max(samples[:, i]), nbins
                    )
                hist, edges = np.histogram(samples[:, i], bins=bins)
                ax.step(edges[:-1], hist, where="mid", color="steelblue", linewidth=2)
                ax.set_xlim(bins[0], bins[-1])
                ax.set_ylabel("")
                ax.set_xlabel("dim%d" % i, size=labelsize)
                ticks = xticks
                if show_mean:
                    mode_index = int(np.argmax(hist))
                    mode_value = (edges[mode_index] + edges[mode_index + 1]) / 2
                    centers = (edges[:-1] + edges[1:]) / 2
                    weighted_mean = (
                        np.sum(hist * centers) / np.sum(hist) if hist.sum() else 0.0
                    )
                    ax.axvline(
                        x=mode_value, color="lightsteelblue", linestyle="--",
                        linewidth=2,
                    )
                if ticks is None:
                    x_min = 0.5 * (edges[0] + edges[1])
                    x_max = 0.5 * (edges[-2] + edges[-1])
                    ticks = [x_min, x_max] if x_max < 0 else [x_min, 0, x_max]
                if show_mean:
                    ticks = [ticks[0], weighted_mean, ticks[-1]]
                    ticklabels = [ticks[0], np.round(weighted_mean, 1), ticks[-1]]
                else:
                    ticklabels = ticks
                ax.set_xticks(ticks)
                ax.set_xticklabels(ticklabels, size=labelsize)
                ax.set_yticks([])
                _despine(left=True, top=True, right=True)
            elif i < j:
                if limits:
                    hist_range = [limits, limits]
                else:
                    hist_range = [
                        (np.min(samples[:, j]), np.max(samples[:, j])),
                        (np.min(samples[:, i]), np.max(samples[:, i])),
                    ]
                H, xedges, yedges = np.histogram2d(
                    samples[:, j], samples[:, i], bins=nbins, range=hist_range
                )
                ax.imshow(
                    H.T, origin="lower", aspect="auto", interpolation="nearest",
                    extent=[xedges[0], xedges[-1], yedges[0], yedges[-1]], cmap=cmap,
                )
                ax.set_xlim(hist_range[0])
                ax.set_ylim(hist_range[1])
                _despine(right=True, top=True, bottom=True, left=True)
                ax.set_xticks([])
                ax.set_yticks([])
            else:
                ax.axis("off")
    if fname:
        plt.savefig(fname)
    if show:  # pragma: no cover
        plt.show()
    else:
        plt.close(fig)


def plot_csv(file_path, fname, labelsize, max_step: int = 1000, show_plot: bool = False):
    """A Step/Value CSV (a ``MetricsWriter`` scalar log) as a curve up to
    ``max_step``, written to ``fname``."""
    import csv as _csv

    steps, values = [], []
    with open(file_path) as f:
        reader = _csv.DictReader(f)
        if reader.fieldnames is None or not {"Step", "Value"} <= set(reader.fieldnames):
            raise ValueError("Columns 'Step' and 'Value' must be in the CSV.")
        for row in reader:
            s = float(row["Step"])
            if s <= max_step:
                steps.append(s)
                values.append(float(row["Value"]))
    plt.plot(steps, values)
    plt.xlabel("Step", size=labelsize)
    plt.ylabel("Value", size=labelsize)
    plt.grid(True)
    plt.savefig(fname)
    if show_plot:  # pragma: no cover
        plt.show()
    plt.close()
