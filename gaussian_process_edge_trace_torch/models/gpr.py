"""Mask-aware Gaussian-process regression on fixed-shape padded buffers.

Port of ``gaussian_process_edge_trace_tpu/models/gpr.py``: the sampling
side (Matheron pathwise draws on the truncated prior factor) and the LML
of the final fit. The sampling round's Gram Cholesky, ``cho_solve`` and the
``F @ z`` prior draw are ``torch.linalg`` and ``torch.matmul``, as the
reference leaves them to XLA; :func:`batched_lml` runs its factorisations and
solves through the K5 and K6 kernels (:mod:`..ops.cuda_chol`).

Scalars such as the variance stay 0-d tensors on the device, so a sampling
round never waits for the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussian_process_edge_trace_torch.models.kernels import (
    KernelSpec, cross_gram, dk_unit_dlog_ls, k_unit, train_gram)
from gaussian_process_edge_trace_torch.ops.cuda_chol import (
    backward_solve_auto, cholesky_auto, forward_solve_auto)


class GPState(NamedTuple):
    """Posterior state after :func:`gp_fit`."""
    L: torch.Tensor       # (n, n) lower Cholesky of the masked Gram
    alpha: torch.Tensor   # (n,) dual coefficients (0 at padded slots)
    x: torch.Tensor       # (n,) training inputs
    y_mean: torch.Tensor  # scalar removed mean (0 if centre=False)
    mask: torch.Tensor    # (n,) bool validity


def safe_cholesky(K, jitter_scales=(0.0, 1e-5, 1e-3)):
    """Lower Cholesky with a branchless jitter ladder: every candidate
    ``K + jitter·mean(diag K)·I`` is factored in one batched call and the
    first that factored (``info == 0``) is taken; if none did, the last.
    ``cholesky_ex`` leaves finite garbage where a factorisation fails, so
    its ``info``, not the diagonal, decides."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    scale = torch.diagonal(K).mean()
    jit = torch.tensor(jitter_scales, dtype=K.dtype, device=K.device) * scale
    Ls, info = torch.linalg.cholesky_ex(K[None] + jit[:, None, None] * eye)
    ok = info == 0
    idx = torch.where(ok.any(), torch.argmax(ok.to(torch.uint8)),
                      torch.tensor(len(jitter_scales) - 1, device=K.device))
    return Ls.index_select(0, idx.reshape(1))[0]


def masked_mean(y, mask):
    m = mask.to(y.dtype)
    return (y * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_std(y, mask):
    m = mask.to(y.dtype)
    n = torch.clamp(m.sum(), min=1.0)
    mu = (y * m).sum() / n
    return torch.sqrt((m * (y - mu) ** 2).sum() / n)


def gp_fit(spec: KernelSpec, x, y, length_scale, variance, diag_noise, mask,
           centre=True):
    """Gram + Cholesky + dual coefficients (sklearn_gpr.py:304-320);
    ``centre=True`` removes the masked mean only, like the fork's
    ``normalize_y``."""
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    y_mean = masked_mean(y, mask) if centre else zero
    yc = torch.where(mask, y - y_mean, zero)
    K = train_gram(spec, x, length_scale, variance, diag_noise, mask=mask)
    L = safe_cholesky(K)
    alpha = torch.where(mask, torch.cholesky_solve(yc[:, None], L)[:, 0],
                        zero)
    return GPState(L=L, alpha=alpha, x=x, y_mean=y_mean, mask=mask)


def gp_predict(spec: KernelSpec, state: GPState, xq, length_scale, variance,
               return_std=False):
    """Posterior mean and, with ``return_std``, the std at query points
    (zero query noise, with the negative-variance clamp)."""
    Kq = cross_gram(spec, xq, state.x, length_scale, variance)
    Kq = torch.where(state.mask[None, :], Kq, torch.zeros_like(Kq))
    mean = Kq @ state.alpha + state.y_mean
    if not return_std:
        return mean
    V = torch.linalg.solve_triangular(state.L, Kq.T, upper=False)
    var = torch.clamp(variance - (V * V).sum(0), min=0.0)
    return mean, torch.sqrt(var)


def fit_and_sample(spec: KernelSpec, x, y, length_scale, variance, diag_noise,
                   mask, L_prior_unit, x_idx, grid_out, z, w, centre=True,
                   post_scale=1.0):
    """Fit the GP and draw posterior curves over the output grid by
    Matheron's rule (gpr.py:152-271):

        f*_j = ȳ + f0_j(X*) + K(X*,X) (K(X,X)+Σ)⁻¹ (yc − f0_j(X) − ε_j)

    with ``f0_j = sqrt(variance)·F z_j`` drawn through the (G, r) truncated
    prior factor ``F = L_prior_unit`` and ``ε_j = sqrt(Σ) w_j``. The normals
    are inputs: ``z`` (r, S) and ``w`` (n, S), so a caller can feed the
    reference's own draws.

    Args:
      x: (n,) padded training inputs (float); y: (n,) targets.
      diag_noise: (n,) training noise diagonal; mask: (n,) validity.
      x_idx: (n,) integer grid positions of the training inputs.
      grid_out: (E,) contiguous integer output columns.
      post_scale: multiplier on the centred posterior (the fork's rescale
        quirk, see ``trace/driver.py::_sample_round``).

    Returns:
      (E, S) posterior curves, mean included.
    """
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    y_mean = masked_mean(y, mask) if centre else zero
    yc = torch.where(mask, y - y_mean, zero)

    K = train_gram(spec, x, length_scale, variance, diag_noise, mask=mask)
    # Two-rung jitter ladder: the sampling Gram carries the full
    # observation-noise diagonal, so the 1e-5 rung is never the first to
    # factor (gpr.py:214-219).
    L = safe_cholesky(K, jitter_scales=(0.0, 1e-3))

    f0 = torch.sqrt(variance) * (L_prior_unit @ z)            # (G, S)
    eps = torch.sqrt(torch.clamp(diag_noise, min=0.0))[:, None] * w
    f0_x = f0.index_select(0, x_idx)                           # (n, S)
    resid = torch.where(mask[:, None], yc[:, None] - f0_x - eps, zero)
    A = torch.where(mask[:, None], torch.cholesky_solve(resid, L), zero)

    Kq = cross_gram(spec, grid_out.to(f0.dtype), x, length_scale, variance)
    Kq = torch.where(mask[None, :], Kq, zero)                  # (E, n)
    f0_grid = f0.index_select(0, grid_out)                     # (E, S)
    return y_mean + post_scale * (f0_grid + Kq @ A)            # (E, S)


def log_marginal_likelihood(spec: KernelSpec, x, yc, mask, theta,
                            noise_weight, jitter=1e-6):
    """LML of θ = (log c, log ℓ, log σn²) for centred targets (one θ);
    NaN where the Gram is not positive definite. Padded slots contribute
    zero; the −n/2·log 2π term counts valid points only."""
    return batched_lml(spec, x, yc, mask, theta[None], noise_weight,
                       jitter=jitter)[0]


def batched_lml(spec: KernelSpec, x, yc, mask, thetas, noise_weight,
                jitter=1e-6, with_grad=False):
    """LML of many θ = (log c, log ℓ, log σn²) at once (gpr.py:316-391).

    The B factorisations run through K5 and the solves through K6. NaN
    marks a non-PD Gram, for the caller to sanitise. Gradients are the
    reference's analytic trace formula, ∂LML/∂θᵢ = ½ tr((ααᵀ − K⁻¹)∂K/∂θᵢ),
    with K⁻¹ = L⁻ᵀL⁻¹ from one identity-RHS forward solve.

    Args:
      thetas: (B, 3). Returns (B,) values, or (values, (B, 3) gradients).
    """
    dt = thetas.dtype
    dev = thetas.device
    zero = torch.zeros((), dtype=dt, device=dev)
    x = x.to(dt)
    yc = torch.where(mask, yc, zero).to(dt)
    noise_weight = noise_weight.to(dt)
    B = thetas.shape[0]
    n = x.shape[0]
    c = torch.exp(thetas[:, 0])
    ls = torch.exp(thetas[:, 1])
    nz = torch.exp(thetas[:, 2])

    r = torch.abs(x[:, None] - x[None, :])                  # (n, n)
    d = r[None, :, :] / ls[:, None, None]                   # (B, n, n)
    Ku = k_unit(spec, d)
    m2 = (mask[:, None] & mask[None, :])[None]
    eye = torch.eye(n, dtype=dt, device=dev)
    diag_vals = torch.where(mask[None, :],
                            nz[:, None] * noise_weight[None, :] + jitter,
                            zero)                           # (B, n)
    cK = torch.where(m2, c[:, None, None] * Ku, zero)
    # Off-diagonal signal zeroed outside the valid block; padded diagonal 1.
    K = (cK * (1.0 - eye)[None]
         + eye[None] * (cK + diag_vals[:, None, :]
                        + torch.where(mask, zero, zero + 1.0)[None, None, :]))

    L = cholesky_auto(K)
    w1 = forward_solve_auto(L, yc[None, :, None].expand(B, n, 1).contiguous())
    quad = (w1[..., 0] ** 2).sum(1)
    logdet = torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
    n_valid = mask.sum().to(dt)
    vals = -0.5 * quad - logdet - 0.5 * n_valid * math.log(2.0 * math.pi)
    if not with_grad:
        return vals

    alpha = backward_solve_auto(L, w1)[..., 0]              # (B, n)
    alpha = torch.where(mask[None, :], alpha, zero)
    Linv = forward_solve_auto(L, eye.expand(B, n, n).contiguous())
    Kinv = Linv.transpose(1, 2) @ Linv                      # L⁻ᵀ L⁻¹
    A = alpha[:, :, None] * alpha[:, None, :] - Kinv

    dKl = torch.where(m2, c[:, None, None] * dk_unit_dlog_ls(spec, d), zero)
    g0 = 0.5 * (A * cK).sum((1, 2))
    g1 = 0.5 * (A * dKl).sum((1, 2))
    diagA = torch.diagonal(A, dim1=1, dim2=2)
    g2 = 0.5 * (diagA * (nz[:, None] * noise_weight[None, :])
                * mask[None, :]).sum(1)
    return vals, torch.stack([g0, g1, g2], dim=1)
