"""Host-side matplotlib diagnostics (reference: gpet.py:666-764,
gpet_utils.py:315-366).

Port of ``gaussian_process_edge_trace_tpu/utils/plotting.py``. Plotting
stays on the host: tensors are brought over with ``.cpu().numpy()``. The
figures are the reference's three views: the per-iteration posterior fan
chart, the optimal-curve/cost diagnostics, and the final
prediction-vs-truth panel with the trace metrics in the title. matplotlib
is imported inside each function, so the module imports without it.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_process_edge_trace_torch.utils.metrics import (
    trace_MSE, trace_dicecoef, trace_relarea)


def _np(a):
    """A numpy array of a tensor (brought to the host) or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_iter(x_grid, y_samples, N_plt_samples, obs, init, img_shape,
              show=True):
    """Posterior fan chart of one iteration (gpet.py:666-723): mean curve,
    empirical 95% band, a subsample of curves, inits and observations."""
    import matplotlib.pyplot as plt

    y_samples = _np(y_samples)
    x_grid = _np(x_grid)
    obs = _np(obs).reshape(-1, 2)
    init = _np(init)
    M, N = img_shape

    mean = y_samples.mean(axis=1)
    std = y_samples.std(axis=1)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(x_grid, mean, c="k", lw=3, zorder=3,
            label="Posterior Predictive Mean")
    ax.fill_between(x_grid, mean - 1.96 * std, mean + 1.96 * std, alpha=0.2,
                    color="k", zorder=1, label="95% Credible Region")
    ax.plot(x_grid, y_samples[:, :N_plt_samples], lw=1, zorder=2)
    ax.scatter(init[:, 0], init[:, 1], c="m", s=80, zorder=5,
               edgecolors=(0, 0, 0), label="Edge Inits")
    if obs.size > 0:
        ax.scatter(obs[:, 0], obs[:, 1], c="r", s=48, zorder=4,
                   edgecolors=(0, 0, 0), label="Observations")
    ax.set_xlim([0, N - 1])
    ax.set_ylim([M - 1, 0])
    ax.set_xlabel("Pixel Column, $x$", fontsize=16)
    ax.set_ylabel("Pixel Row, $y$", fontsize=16)
    ax.legend(fontsize=10, ncol=2, loc="lower right")
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def plot_diagnostics(grad_img, x_grid, iter_optimal_curves,
                     iter_optimal_costs, credint=None, show=True):
    """Optimal curve per iteration over the gradient image + cost-vs-iter
    scatter (gpet.py:727-764)."""
    import matplotlib.pyplot as plt

    N_iter = len(iter_optimal_curves)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(20, 25))
    ax1.imshow(_np(grad_img), cmap="jet", zorder=0)
    for i, curve in enumerate(iter_optimal_curves[:-1]):
        ax1.plot(x_grid, _np(curve)[:, 1], "--", alpha=0.25, zorder=2,
                 label=f"Iteration {i + 1}")
    ax1.plot(x_grid, _np(iter_optimal_curves[-1])[:, 1], "-",
             label="Final Edge", zorder=3)
    if credint is not None:
        ax1.fill_between(x_grid, _np(credint[0]),
                         _np(credint[1]), alpha=0.2, color="m",
                         zorder=1, label="95% Credible Region")
    ax1.legend(loc="best", bbox_to_anchor=(1.05, 1.0))
    ax1.set_title("Most optimal curves of each iteration superimposed onto "
                  "gradient image", fontsize=18)
    costs = [float(c) for c in iter_optimal_costs]
    ax2.scatter(np.arange(1, N_iter + 1), costs, c="r", s=50,
                edgecolors=(0, 0, 0))
    ax2.set_title("Costs from optimal curves for each iteration", fontsize=18)
    ax2.set_xlabel("Iteration", fontsize=15)
    ax2.set_ylabel("Cost", fontsize=15)
    ax2.set_xticks(list(range(1, N_iter + 1)))
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def plot_results(edge_trace, true_edge, test_img, grad_img, credint=None,
                 string="True Edge vs. Edge Pred", show=True):
    """Prediction vs truth on the test and gradient images, trace metrics
    in the title (gpet_utils.py:315-366)."""
    import matplotlib.pyplot as plt

    edge_trace = _np(edge_trace)
    true_edge = _np(true_edge)
    if edge_trace.ndim == 1:
        edge_trace = edge_trace.reshape(-1, 1)
    mse = float(trace_MSE(edge_trace, true_edge))
    rel = float(trace_relarea(edge_trace, true_edge))
    dice = float(trace_dicecoef(edge_trace, true_edge))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 8))
    ax1.imshow(_np(test_img), cmap="gray")
    ax1.set_title(string, fontsize=20)
    ax2.imshow(_np(grad_img), cmap="gray")
    ax2.set_title(f"MSE: {mse}, Rel. Area Diff: {rel}, DICE: {dice}",
                  fontsize=20)
    for ax in (ax1, ax2):
        ax.plot(true_edge[[0, -1], 1], true_edge[[0, -1], 0], "o", c="r",
                markersize=5, label="Edge Endpoints")
        ax.plot(true_edge[:, 1], edge_trace[:, 0], "r-", zorder=2,
                label="Proposed")
        ax.plot(true_edge[:, 1], true_edge[:, 0], "b--", linewidth=2,
                label="Ground Truth")
        if credint is not None:
            ax.fill_between(true_edge[:, 1], _np(credint[0]),
                            _np(credint[1]), alpha=0.5, color="m",
                            zorder=1, label="95% Credible Region")
        ax.legend(fontsize=13, ncol=2, loc="lower right")
    fig.tight_layout()
    if show:
        plt.show()
    return fig
