"""Box-constrained damped-Newton polish for the 3-dimensional LML fit.

Port of ``gaussian_process_edge_trace_tpu/models/newton.py`` (the batched
half): one batched screen of all starts, then a few damped-Newton steps on
the ``n_polish`` best. The Hessian is built from central differences of the
batched analytic gradient, so each iteration is two batched objective calls
(one gradient batch, one candidate-value batch).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class NewtonResult(NamedTuple):
    x: torch.Tensor   # (d,) best iterate
    f: torch.Tensor   # objective value at x


# Levenberg damping ladder: 0 = pure Newton, large = gradient-like steps.
_LAMBDAS = (0.0, 1e-3, 1e-1, 10.0, 1e3)


def _finite_or(x, fill):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, fill))


def lml_screen_grid(lb, ub, device=None):
    """Static screen grid over the (log c, log ℓ, log σn²) box: 4×4 over the
    kernel hyperparameters crossed with six noise decades (newton.py:130).
    ``lb``/``ub`` are host tensors; the (96, 3) grid goes to ``device``."""
    lb, ub = lb.cpu(), ub.cpu()
    cs = torch.linspace(float(lb[0]), float(ub[0]), 4, dtype=lb.dtype)
    ls = torch.linspace(float(lb[1]), float(ub[1]), 4, dtype=lb.dtype)
    nz = torch.clamp(
        torch.log(torch.tensor([1e-18, 1e-8, 1e-4, 1e-2, 1e-1, 0.5],
                               dtype=lb.dtype)),
        float(lb[2]), float(ub[2]))
    G = torch.stack(torch.meshgrid(cs, ls, nz, indexing="ij"), dim=-1)
    return G.reshape(-1, 3).to(device)


def screen_and_polish_batched(values_fn, vg_fn, starts, lb, ub, n_polish=8,
                              iters=6, lambdas=_LAMBDAS,
                              fd_h=1e-3) -> NewtonResult:
    """Minimise a batched objective over the box ``[lb, ub]``.

    Args:
      values_fn: (B, d) -> (B,) objective values (NaN/inf allowed).
      vg_fn: (B, d) -> ((B,), (B, d)) values and gradients.
      starts: (n_starts, d) starting points.
    """
    dt, dev = starts.dtype, starts.device
    d_dim = starts.shape[1]
    lam = torch.tensor(lambdas, dtype=dt, device=dev)
    eye = torch.eye(d_dim, dtype=dt, device=dev)
    offs = torch.cat([torch.zeros((1, d_dim), dtype=dt, device=dev),
                      fd_h * eye, -fd_h * eye])                 # (2d+1, d)

    f0s = values_fn(starts)
    P = min(n_polish, starts.shape[0])
    # lax.top_k order: smallest value first, ties to the lower index.
    top = torch.sort(_finite_or(f0s, math.inf), stable=True).indices[:P]
    X = starts[top]                                             # (P, d)
    F = _finite_or(f0s[top], math.inf)

    for _ in range(iters):
        pts = (X[None, :, :] + offs[:, None, :]).reshape(-1, d_dim)
        _, gv = vg_fn(pts)
        gv = gv.reshape(2 * d_dim + 1, P, d_dim)
        G = _finite_or(gv[0], 0.0)
        gp = _finite_or(gv[1:1 + d_dim], 0.0)
        gm = _finite_or(gv[1 + d_dim:], 0.0)
        H = ((gp - gm) / (2.0 * fd_h)).permute(1, 0, 2)
        H = 0.5 * (H + H.transpose(1, 2))                       # symmetrise
        scale = torch.clamp(
            torch.abs(torch.diagonal(H, dim1=1, dim2=2)).amax(1), min=1.0)
        Hd = H[:, None] + (lam[None, :, None, None]
                           * scale[:, None, None, None]) * eye
        rhs = G[:, None, :, None].expand(Hd.shape[:2] + (d_dim, 1))
        # solve_ex: a singular damped system yields inf/NaN, as in XLA, and
        # the candidate is then never chosen; no host check.
        dstep = -torch.linalg.solve_ex(Hd, rhs).result[..., 0]
        gstep = -0.5 * G / torch.clamp(
            torch.linalg.vector_norm(G, dim=1, keepdim=True), min=1e-12)
        cand = torch.cat([X[:, None] + dstep, (X + gstep)[:, None]], dim=1)
        cand = torch.minimum(torch.maximum(cand, lb), ub)       # (P, C, d)
        C = cand.shape[1]
        fc = _finite_or(values_fn(cand.reshape(P * C, d_dim)).reshape(P, C),
                        math.inf)
        j = torch.argmin(fc, dim=1)
        fbest = fc.gather(1, j[:, None])[:, 0]
        xbest = cand[torch.arange(P, device=dev), j]
        better = fbest < F                                      # monotone
        X = torch.where(better[:, None], xbest, X)
        F = torch.where(better, fbest, F)

    i = torch.argmin(_finite_or(F, math.inf))
    return NewtonResult(x=X[i], f=F[i])
