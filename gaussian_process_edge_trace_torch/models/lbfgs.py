"""Bound-constrained L-BFGS over a batch of starts.

Port of ``gaussian_process_edge_trace_tpu/models/lbfgs.py``, the
replacement of ``scipy.optimize.minimize(..., method='L-BFGS-B',
jac=True)`` (sklearn_gpr.py:587-607) for kernel hyperparameters. The
reference dropped the convergence check on purpose (sklearn_gpr.py:596-599),
so a projected L-BFGS with Armijo backtracking is enough:

- the JAX package's ``vmap`` over restarts is a leading batch axis here:
  every start steps at once, and a start that has converged keeps its
  iterate while the others go on (the vmapped ``while_loop``'s semantics),
  with one read of the batch's ``done`` flags by the host per iteration;
- the Armijo search evaluates every backtracking step in one batched
  objective call and takes the largest step of sufficient decrease,
  scipy's first accepted step;
- bounds by gradient projection: iterates are clipped to the box, and a
  direction is zeroed along an active bound it pushes out of.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor        # (B, d) final iterates, within the bounds
    f: torch.Tensor        # (B,) objective values at x
    n_iters: torch.Tensor  # (B,) iterations each start took


def _project(x, lb, ub):
    return torch.minimum(torch.maximum(x, lb), ub)


def _projected_dir(d, x, lb, ub, eps=1e-12):
    at_lo = (x <= lb + eps) & (d < 0)
    at_hi = (x >= ub - eps) & (d > 0)
    return torch.where(at_lo | at_hi, torch.zeros_like(d), d)


def _dot(a, b):
    return (a * b).sum(-1)


def _direction(g, S, Y, rho):
    """The two-loop recursion over each start's (history, d) pairs; a pair
    with rho == 0 is skipped (lbfgs.py:73-95)."""
    zero = torch.zeros_like(rho[:, 0])
    q = g
    alphas = []
    for k in reversed(range(S.shape[1])):
        a = rho[:, k] * _dot(S[:, k], q)
        q = q - torch.where(rho[:, k] > 0, a, zero)[:, None] * Y[:, k]
        alphas.append(a)
    alphas.reverse()
    sy = _dot(S[:, -1], Y[:, -1])
    yy = _dot(Y[:, -1], Y[:, -1])
    gamma = torch.where((sy > 0) & (yy > 0), sy / yy, zero + 1.0)
    r = gamma[:, None] * q
    for k in range(S.shape[1]):
        b = rho[:, k] * _dot(Y[:, k], r)
        r = r + torch.where(rho[:, k] > 0, alphas[k] - b, zero)[:, None] \
            * S[:, k]
    return -r


def _push(buf, v, valid):
    """Each start's history with ``v`` appended (the oldest dropped) where
    ``valid``, else as it was."""
    new = torch.cat([buf[:, 1:], v[:, None]], dim=1)
    return torch.where(valid.reshape(valid.shape + (1,) * (buf.dim() - 1)),
                       new, buf)


def minimize_lbfgs_b(fun, x0, lb, ub, max_iters=64, history=8,
                     max_backtracks=20, tol=1e-9, values=None):
    """Minimise ``fun`` within ``[lb, ub]`` from each row of ``x0``.

    Args:
      fun: (B, d) -> ((B,), (B, d)) values and gradients, row by row.
      x0: (B, d) starts (a (d,) start is a batch of one).
      values: optional (T, d) -> (T,) values alone, for the line search's
        candidates; ``fun``'s values by default.
    Returns an :class:`LBFGSResult` with a leading batch axis.
    """
    if x0.dim() == 1:
        x0 = x0[None]
    if values is None:
        def values(x):
            return fun(x)[0]
    B, d = x0.shape
    dt, dev = x0.dtype, x0.device
    lb = torch.as_tensor(lb, dtype=dt, device=dev)
    ub = torch.as_tensor(ub, dtype=dt, device=dev)
    x = _project(x0, lb, ub)
    f, g = fun(x)
    f = f.to(dt)
    S = torch.zeros((B, history, d), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((B, history), dtype=dt, device=dev)
    steps = 0.5 ** torch.arange(max_backtracks, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    for _ in range(max_iters):
        if bool(done.all()):
            break
        dvec = _projected_dir(_direction(g, S, Y, rho), x, lb, ub)
        gd = _dot(g, dvec)
        # Projected steepest descent where that is not a descent direction.
        sd = _projected_dir(-g, x, lb, ub)
        use_sd = gd >= 0
        dvec = torch.where(use_sd[:, None], sd, dvec)
        gd = torch.where(use_sd, _dot(g, sd), gd)

        # Armijo: every candidate step in one batched call; the largest
        # step of sufficient decrease.
        xts = _project(x[:, None, :] + steps[:, None] * dvec[:, None, :],
                       lb, ub)                                  # (B, T, d)
        fts = values(xts.reshape(-1, d)).reshape(B, -1).to(dt)
        accept = (fts <= f[:, None] + 1e-4 * steps * gd[:, None]) \
            & torch.isfinite(fts)
        found = accept.any(-1)
        j = torch.argmax(accept.to(torch.uint8), dim=-1)   # first True
        t_best = torch.where(found, steps[j], zero)

        x_new = _project(x + t_best[:, None] * dvec, lb, ub)
        f_new, g_new = fun(x_new)
        f_new = f_new.to(dt)
        s = x_new - x
        yv = g_new - g
        sy = _dot(s, yv)
        valid = sy > 1e-10
        S_new = _push(S, s, valid)
        Y_new = _push(Y, yv, valid)
        rho_new = _push(rho, 1.0 / torch.where(valid, sy, zero + 1.0), valid)
        pg = x_new - _project(x_new - g_new, lb, ub)
        new_done = ~found | (torch.abs(pg).amax(-1) < tol)

        # A start that had converged keeps its state.
        live = ~done
        x = torch.where(live[:, None], x_new, x)
        f = torch.where(live, f_new, f)
        g = torch.where(live[:, None], g_new, g)
        S = torch.where(live[:, None, None], S_new, S)
        Y = torch.where(live[:, None, None], Y_new, Y)
        rho = torch.where(live[:, None], rho_new, rho)
        it = it + live.to(torch.int64)
        done = done | (live & new_done)
    return LBFGSResult(x=x, f=f, n_iters=it)
