"""Composite Simpson quadrature on (possibly) non-uniform grids.

Port of ``gaussian_process_edge_trace_tpu/ops/integrate.py`` (the
reference's ``scipy.integrate.simps`` calls, gpet.py:404-405). Semantics
match ``scipy.integrate.simpson``: an odd point count runs the composite
non-uniform pair rule; an even count adds the Cartwright-corrected last
interval (``even="simpson"``) or averages the two one-sided rules
(``even="avg"``, the historical ``simps`` default).
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.ops.sums import fixed_sum


def _pair_contributions(y0, y1, y2, h0, h1):
    """Non-uniform Simpson contribution of one interval pair (scipy's
    ``_basic_simpson`` formula), h0 = x1-x0, h1 = x2-x1."""
    hsum = h0 + h1
    return (hsum / 6.0) * (
        y0 * (2.0 - h1 / h0)
        + y1 * hsum * hsum / (h0 * h1)
        + y2 * (2.0 - h0 / h1)
    )


def _odd_block(y, h):
    """Pair rule over an odd number of points along axis 0. Every window is
    evaluated from unit-stride slices and the odd starts are masked out, as
    the reference's ``_simpson_axis0`` does. The windows are summed by
    :func:`fixed_sum`: on the card in an order set by the point count
    alone, so a frame's sum does not depend on the frames beside it."""
    m = y.shape[0]
    contrib = _pair_contributions(y[:-2], y[1:-1], y[2:], h[:-1], h[1:])
    keep = (torch.arange(m - 2, device=y.device) % 2 == 0).reshape(
        (m - 2,) + (1,) * (contrib.dim() - 1))
    return fixed_sum(torch.where(keep, contrib, torch.zeros(
        (), dtype=y.dtype, device=y.device)), 0)


def _cartwright_tail(y, h):
    h0, h1 = h[-2], h[-1]
    alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
    beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
    eta = h1 * h1 * h1 / (6 * h0 * (h0 + h1))
    return alpha * y[-1] + beta * y[-2] - eta * y[-3]


def simpson_nonuniform(y, x=None, axis=-1, even="simpson", h=None):
    """Composite Simpson integral of ``y`` at locations ``x`` along ``axis``.

    Pass exactly one of ``x`` (the locations) or ``h`` (the interval widths,
    one shorter than ``y``): the curve cost passes its step lengths as ``h``.
    """
    if (x is None) == (h is None):
        raise ValueError("pass exactly one of x / h")
    y = torch.movedim(y, axis, 0)
    if x is not None:
        h = torch.diff(torch.movedim(torch.as_tensor(x), axis, 0), dim=0)
    else:
        h = torch.movedim(torch.as_tensor(h), axis, 0)
    n = y.shape[0]
    if n < 2:
        raise ValueError("simpson needs at least 2 samples")
    if h.shape[0] != n - 1:
        raise ValueError(f"h must have n-1 = {n - 1} intervals, "
                         f"got {h.shape[0]}")
    if h.dim() < y.dim():
        h = h.reshape(h.shape + (1,) * (y.dim() - h.dim()))
    if n == 2:
        return 0.5 * (y[0] + y[1]) * h[0]
    if n % 2 == 1:
        return _odd_block(y, h)
    if even == "avg":
        first = (_odd_block(y[: n - 1], h[: n - 2])
                 + 0.5 * (y[-1] + y[-2]) * h[-1])
        second = (0.5 * (y[0] + y[1]) * h[0]
                  + _odd_block(y[1:], h[1:]))
        return 0.5 * (first + second)
    return _odd_block(y[: n - 1], h[: n - 2]) + _cartwright_tail(y, h)


def simpson_weights(x, even="simpson"):
    """Weights ``w`` with ``simpson(y, x) == y @ w`` for fixed 1-D ``x``:
    the pair coefficients scattered onto the points (plus the Cartwright
    tail for even n, or the trapezoid average with ``even="avg"``)."""
    n = x.shape[-1]
    if n < 2:
        raise ValueError("simpson needs at least 2 samples")
    if n == 2:
        h = x[1] - x[0]
        return torch.stack([0.5 * h, 0.5 * h])
    h = torch.diff(x)

    def add_odd_block(w, m):
        h0 = h[0:m - 2:2]
        h1 = h[1:m - 1:2]
        hsum = h0 + h1
        w = w.clone()
        w[0:m - 2:2] += (hsum / 6.0) * (2.0 - h1 / h0)
        w[1:m - 1:2] += (hsum / 6.0) * (hsum * hsum / (h0 * h1))
        w[2:m:2] += (hsum / 6.0) * (2.0 - h0 / h1)
        return w

    w = torch.zeros(n, dtype=x.dtype, device=x.device)
    if n % 2 == 1:
        return add_odd_block(w, n)
    if even == "avg":
        w1 = add_odd_block(w, n - 1)
        w1[-1] += 0.5 * h[-1]
        w1[-2] += 0.5 * h[-1]
        w2 = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                        simpson_weights(x[1:])])
        w2[0] += 0.5 * h[0]
        w2[1] += 0.5 * h[0]
        return 0.5 * (w1 + w2)
    w = add_odd_block(w, n - 1)
    h0, h1 = h[-2], h[-1]
    w[-1] += (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
    w[-2] += (h1 * h1 + 3 * h0 * h1) / (6 * h0)
    w[-3] -= h1 * h1 * h1 / (6 * h0 * (h0 + h1))
    return w
