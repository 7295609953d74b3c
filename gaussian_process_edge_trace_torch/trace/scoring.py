"""Posterior-curve costs and top-k ranking (reference: gpet.py:371-451).

Port of ``gaussian_process_edge_trace_tpu/trace/scoring.py``. For a curve y
on the unit-spaced x grid, ``cost = arc_length / line_integral`` with

- ``line_integral = simpson(grad_score[:-1], cumsum(step))``, where
  ``grad_score`` is the gradient image interpolated along the curve plus
  ``kde_thresh`` and ``step = sqrt(1 + dy²)`` (gpet.py:392-404);
- ``arc_length = simpson(step, x[:-1])`` (gpet.py:400-405).

Lower is better. Eligible shapes run the fused K1 kernel; the rest run the
K2 interpolation kernel and the Simpson sums in PyTorch. At S >= 8192 K1
also writes the samples transposed, and :func:`best_curves` takes the kept
curves as rows of that copy, as the reference driver does
(driver.py:401-408). Both take an optional leading frame axis; one kernel
launch then scores every frame. Under a sample axis (a rank holding S/k of
the samples) :func:`sharded_best_curves` ranks over the whole sample group.
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.ops.collectives import (
    SampleShard, all_gather_stack, all_reduce_sum)
from gaussian_process_edge_trace_torch.ops.cuda_interp import (
    column_interp, fused_cost_eligible, fused_curve_cost, line_and_arc)


def curve_costs(cols, y_samples, kde_thresh: float = 1e-3,
                even: str = "simpson", return_samples_t: bool = False,
                plan_samples=None):
    """(S,) costs of all sampled curves, or ``(costs, samples_t)`` with
    ``return_samples_t``.

    Args:
      cols: (E, M) gradient columns along the x grid (``grad_img.T`` sliced
        to the grid, ``TracerData.grad_cols``); the grid is contiguous, so
        the reference's ``x_grid`` argument enters only as unit spacing.
        (B, E, M) for frames with columns of their own.
      y_samples: (E, S) curves, or (B, E, S) for B frames; the costs are
        then (B, S).
      even: even-point Simpson rule; only reached on the unfused path with
        an odd E, since an even E gives both quadratures an odd count.
      return_samples_t: also return the (S, E) transposed samples that K1
        writes at S >= 8192 on the fused path, else ``None``
        (scoring.py:61-65 of the reference).
      plan_samples: the sample count K1's launch plan chunks for (default
        S): a rank scoring S/k of a group's samples passes the group's S,
        so its costs are bitwise those columns of one launch over S.
    """
    E, S = y_samples.shape[-2:]
    samples_t = None
    if fused_cost_eligible(E, cols.shape[-1], S):
        line, arc, samples_t = fused_curve_cost(
            cols, y_samples, kde_thresh, want_transpose=return_samples_t,
            plan_samples=plan_samples)
    else:
        line, arc = line_and_arc(
            column_interp(cols, y_samples, add_const=kde_thresh), y_samples,
            even)
    costs = arc / line
    return (costs, samples_t) if return_samples_t else costs


def best_curves(y_samples, costs, n_keep: int, samples_t=None):
    """The ``n_keep`` cheapest curves (gpet.py:443-449): ``(best (E, n_keep),
    best_costs (n_keep,))``, index 0 the optimum; with a leading frame
    axis, each frame's own. A stable ascending sort gives ``lax.top_k``'s
    order on ties, lower index first, on every device. With ``samples_t``
    (the (S, E) copy from :func:`curve_costs`) the curves are taken as rows
    of it, bitwise the same elements; the result is made contiguous, the
    layout K3 takes."""
    order = torch.sort(costs, stable=True)
    idx = order.indices[..., :n_keep]
    if samples_t is not None:
        best = torch.take_along_dim(samples_t, idx[..., None], dim=-2)
        best = best.transpose(-1, -2).contiguous()
    else:
        best = torch.take_along_dim(y_samples, idx[..., None, :], dim=-1)
    return best, order.values[..., :n_keep]


def sharded_best_curves(y_samples, costs, n_keep: int, shard: SampleShard):
    """:func:`best_curves` over a sample group, from this rank's
    ``shard.width`` samples and costs (the reference's sample-axis arm,
    driver.py:409-429): one ``all_gather`` of the costs in global column
    order, the same stable ascending sort, a clamped take of the kept
    columns this rank holds (the others masked to zero) and one
    ``all_reduce(SUM)``. Every kept column has exactly one rank that holds
    it, so the result is bitwise :func:`best_curves` over all S samples,
    on every rank of the group."""
    costs_g = all_gather_stack(costs, shard.group)     # (k, ..., S/k)
    costs_g = torch.movedim(costs_g, 0, -2).flatten(-2)  # (..., S)
    order = torch.sort(costs_g, stable=True)
    local = order.indices[..., :n_keep] - shard.offset
    held = (local >= 0) & (local < shard.width)
    taken = torch.take_along_dim(
        y_samples, torch.clamp(local, 0, shard.width - 1)[..., None, :],
        dim=-1)
    best = torch.where(held[..., None, :], taken,
                       torch.zeros((), dtype=taken.dtype,
                                   device=taken.device))
    return all_reduce_sum(best, shard.group), order.values[..., :n_keep]
