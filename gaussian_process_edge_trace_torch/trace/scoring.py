"""Posterior-curve costs and top-k ranking (reference: gpet.py:371-451).

Port of ``gaussian_process_edge_trace_tpu/trace/scoring.py``. For a curve y
on the unit-spaced x grid, ``cost = arc_length / line_integral`` with

- ``line_integral = simpson(grad_score[:-1], cumsum(step))``, where
  ``grad_score`` is the gradient image interpolated along the curve plus
  ``kde_thresh`` and ``step = sqrt(1 + dy²)`` (gpet.py:392-404);
- ``arc_length = simpson(step, x[:-1])`` (gpet.py:400-405).

Lower is better. Eligible shapes run the fused K1 kernel; the rest run the
K2 interpolation kernel and the Simpson sums in PyTorch.
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.ops.cuda_interp import (
    column_interp, fused_cost_eligible, fused_curve_cost, line_and_arc)


def curve_costs(cols, y_samples, kde_thresh: float = 1e-3,
                even: str = "simpson"):
    """(S,) costs of all sampled curves.

    Args:
      cols: (E, M) gradient columns along the x grid (``grad_img.T`` sliced
        to the grid, ``TracerData.grad_cols``); the grid is contiguous, so
        the reference's ``x_grid`` argument enters only as unit spacing.
      y_samples: (E, S) curves.
      even: even-point Simpson rule; only reached on the unfused path with
        an odd E, since an even E gives both quadratures an odd count.
    """
    E, S = y_samples.shape
    if fused_cost_eligible(E, cols.shape[1], S):
        line, arc = fused_curve_cost(cols, y_samples, kde_thresh)
    else:
        line, arc = line_and_arc(
            column_interp(cols, y_samples, add_const=kde_thresh), y_samples,
            even)
    return arc / line


def best_curves(y_samples, costs, n_keep: int):
    """The ``n_keep`` cheapest curves (gpet.py:443-449): ``(best (E, n_keep),
    best_costs (n_keep,))``, index 0 the optimum. A stable ascending sort
    gives ``lax.top_k``'s order on ties, lower index first, on every
    device."""
    order = torch.sort(costs, stable=True)
    idx = order.indices[:n_keep]
    return y_samples.index_select(1, idx), order.values[:n_keep]
