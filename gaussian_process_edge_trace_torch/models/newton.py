"""Box-constrained damped-Newton polish for the 3-dimensional LML fit.

Port of ``gaussian_process_edge_trace_tpu/models/newton.py``: one batched
screen of all starts, then a few damped-Newton steps on the ``n_polish``
best. :func:`screen_and_polish_batched` (the default final fit's) builds the
Hessian from central differences of a batched analytic gradient, so each
iteration is two batched objective calls (one gradient batch, one
candidate-value batch). :func:`screen_and_polish` takes a scalar objective
and differentiates it with ``torch.func`` (gradient and exact Hessian,
``vmap``-ped over the starts), the JAX package's path off the TPU (its
finite-difference Hessian option, which no caller sets, is not ported).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussian_process_edge_trace_torch.utils import profiling


class NewtonResult(NamedTuple):
    x: torch.Tensor   # (d,) best iterate (with frames, (F, d))
    f: torch.Tensor   # objective value at x ((F,))


# Levenberg damping ladder: 0 = pure Newton, large = gradient-like steps.
_LAMBDAS = (0.0, 1e-3, 1e-1, 10.0, 1e3)


def _finite_or(x, fill):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, fill))


def _damped_step(X, F, G, H, values, lb, ub, lam, eye):
    """One damped-Newton step of every start from its gradient ``G`` and
    Hessian ``H`` (newton.py:104-130): the Levenberg ladder and a
    projected-gradient fallback, each start keeping its best candidate if
    it improves. ``values`` maps (..., P, C, d) points to (..., P, C)."""
    G = _finite_or(G, 0.0)
    H = _finite_or(H, 0.0)
    d_dim = X.shape[-1]
    scale = torch.clamp(torch.abs(
        torch.diagonal(H, dim1=-2, dim2=-1)).amax(-1), min=1.0)
    Hd = H[..., None, :, :] + (lam[:, None, None]
                               * scale[..., None, None, None]) * eye
    rhs = G[..., None, :, None].expand(Hd.shape[:-2] + (d_dim, 1))
    # solve_ex: a singular damped system yields inf/NaN, as in XLA, and the
    # candidate is then never chosen; no host check.
    dstep = -torch.linalg.solve_ex(Hd, rhs).result[..., 0]
    gstep = -0.5 * G / torch.clamp(
        torch.linalg.vector_norm(G, dim=-1, keepdim=True), min=1e-12)
    cand = torch.cat([X[..., None, :] + dstep, (X + gstep)[..., None, :]],
                     dim=-2)
    cand = torch.minimum(torch.maximum(cand, lb), ub)       # (..., P, C, d)
    fc = _finite_or(values(cand), math.inf)
    j = torch.argmin(fc, dim=-1)
    fbest = torch.take_along_dim(fc, j[..., None], dim=-1)[..., 0]
    xbest = torch.take_along_dim(cand, j[..., None, None], dim=-2)[..., 0, :]
    better = fbest < F                                      # monotone
    return (torch.where(better[..., None], xbest, X),
            torch.where(better, fbest, F))


def _best(X, F) -> NewtonResult:
    i = torch.argmin(_finite_or(F, math.inf), dim=-1)
    return NewtonResult(
        x=torch.take_along_dim(X, i[..., None, None], dim=-2)[..., 0, :],
        f=torch.take_along_dim(F, i[..., None], dim=-1)[..., 0])


def _screen(f0s, starts, n_polish):
    """The ``n_polish`` best starts (lax.top_k order: smallest value first,
    ties to the lower index) and their values."""
    P = min(n_polish, starts.shape[-2])
    top = torch.sort(_finite_or(f0s, math.inf), stable=True).indices
    top = top[..., :P]
    X = torch.take_along_dim(starts, top[..., None], dim=-2)    # (..., P, d)
    F = _finite_or(torch.take_along_dim(f0s, top, dim=-1), math.inf)
    return X, F


def screen_and_polish(neg, starts, lb, ub, n_polish=8, iters=6,
                      lambdas=_LAMBDAS) -> NewtonResult:
    """Minimise the scalar objective ``neg`` (θ (d,) -> value, written in
    ``torch`` operations that ``torch.func`` can differentiate and vmap)
    over the box ``[lb, ub]`` from the (n_starts, d) ``starts``
    (newton.py:43-127), with ``torch.func.grad`` and the exact
    ``torch.func.hessian``, vmapped over the starts."""
    dt, dev = starts.dtype, starts.device
    lb = torch.as_tensor(lb, dtype=dt, device=dev)
    ub = torch.as_tensor(ub, dtype=dt, device=dev)
    with profiling.wait("fit"):
        lam = torch.tensor(lambdas, dtype=dt, device=dev)
    eye = torch.eye(starts.shape[-1], dtype=dt, device=dev)
    vneg = torch.func.vmap(neg)
    vgrad = torch.func.vmap(torch.func.grad(neg))
    vhess = torch.func.vmap(torch.func.hessian(neg))

    def values(cand):
        return vneg(cand.reshape(-1, cand.shape[-1])).reshape(
            cand.shape[:-1])

    X, F = _screen(vneg(starts), starts, n_polish)
    for _ in range(iters):
        X, F = _damped_step(X, F, vgrad(X), vhess(X), values, lb, ub, lam,
                            eye)
    return _best(X, F)


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
    with profiling.wait("fit"):
        return G.reshape(-1, 3).to(device)


def screen_and_polish_batched(values_fn, vg_fn, starts, lb, ub, n_polish=8,
                              iters=6, lambdas=_LAMBDAS,
                              fd_h=1e-3) -> NewtonResult:
    """Minimise a batched objective over the box ``[lb, ub]``.

    Args:
      values_fn: (B, d) -> (B,) objective values (NaN/inf allowed).
      vg_fn: (B, d) -> ((B,), (B, d)) values and gradients.
      starts: (n_starts, d) starting points.

    Frames: ``starts`` (F, n_starts, d) minimise F objectives at once, each
    over its own starts; the functions then map (F, B, d) to (F, B) and
    each step is still one call of each for all frames.
    """
    dt, dev = starts.dtype, starts.device
    lead = starts.shape[:-2]
    d_dim = starts.shape[-1]
    with profiling.wait("fit"):
        lam = torch.tensor(lambdas, dtype=dt, device=dev)
    eye = torch.eye(d_dim, dtype=dt, device=dev)
    offs = torch.cat([torch.zeros((1, d_dim), dtype=dt, device=dev),
                      fd_h * eye, -fd_h * eye])                 # (2d+1, d)

    X, F = _screen(values_fn(starts), starts, n_polish)
    P = X.shape[-2]

    def values(cand):
        C = cand.shape[-2]
        return values_fn(cand.reshape(lead + (P * C, d_dim))).reshape(
            lead + (P, C))

    for _ in range(iters):
        pts = (X[..., None, :, :] + offs[:, None, :]).reshape(
            lead + (-1, d_dim))
        _, gv = vg_fn(pts)
        gv = gv.reshape(lead + (2 * d_dim + 1, P, d_dim))
        gp = _finite_or(gv[..., 1:1 + d_dim, :, :], 0.0)
        gm = _finite_or(gv[..., 1 + d_dim:, :, :], 0.0)
        H = ((gp - gm) / (2.0 * fd_h)).movedim(-3, -2)      # (..., P, d, d)
        H = 0.5 * (H + H.transpose(-1, -2))                     # symmetrise
        X, F = _damped_step(X, F, gv[..., 0, :, :], H, values, lb, ub, lam,
                            eye)
    return _best(X, F)
