"""Mask-aware Gaussian-process regression on fixed-shape padded buffers.

Port of ``gaussian_process_edge_trace_tpu/models/gpr.py``: the sampling
side (Matheron pathwise draws on the truncated prior factor) and the LML
of the final fit. The sampling round's Gram Cholesky, ``cho_solve`` and the
``F @ z`` prior draw are ``torch.linalg`` and ``torch.matmul``, as the
reference leaves them to XLA; :func:`batched_lml` runs its factorisations and
solves through the K5 and K6 kernels (:mod:`..ops.cuda_chol`).

Scalars such as the variance stay 0-d tensors on the device, so a sampling
round never waits for the host. On the card a sampling round's solve runs
through K6, its cross product through K8 and its sums through K9
(:func:`frame_sum`), each one launch for all frames in an order of
operations set by one frame's shapes, so a frame's curves do not depend on
the batch. Every function takes an optional leading frame axis: (B, n)
training buffers give B fits at once, with the scalars then (B,) tensors,
one per frame.

The final fit (:func:`gp_fit`, :func:`gp_predict`, :func:`batched_lml`)
gives a frame the same bits whatever the number of frames fitted with it,
so a batch frame ends where its single trace does. On the card the
library's batched calls and ``torch.sum`` choose their order of operations
from the batch size, so there its factors and solves go through K5 and K6,
one block per matrix, and its sums through a fixed tree (:func:`fixed_sum`,
from ``ops/sums.py``). On the CPU the library's calls and ``torch.sum``
already keep one order per matrix and per sum, and hold the JAX package's
parity that the tests check; there they stay.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from gaussian_process_edge_trace_torch.models.kernels import (
    KernelSpec, cross_gram, dk_unit_dlog_ls, k_unit, per_frame, train_gram)
from gaussian_process_edge_trace_torch.ops.cuda_chol import (
    backward_solve_auto, cholesky_auto, forward_solve_auto)
from gaussian_process_edge_trace_torch.ops.cuda_frames import (
    frames_product, row_sum)
# Re-exported: the final fit's sums (ops/sums.py).
from gaussian_process_edge_trace_torch.ops.sums import (  # noqa: F401
    _on_card, fixed_sum, tree_sum)
from gaussian_process_edge_trace_torch.utils import profiling


class GPState(NamedTuple):
    """Posterior state after :func:`gp_fit` (a leading frame axis on
    every field when fitted on frames)."""
    L: torch.Tensor       # (n, n) lower Cholesky of the masked Gram
    alpha: torch.Tensor   # (n,) dual coefficients (0 at padded slots)
    x: torch.Tensor       # (n,) training inputs
    y_mean: torch.Tensor  # scalar removed mean (0 if centre=False)
    mask: torch.Tensor    # (n,) bool validity


def frames_span(x, min_dim=3):
    """The span ``gpet.frame_by_frame`` around a step of the loop that
    serves every frame in one call whose order of operations does not depend
    on the batch (K6's sampling solve, K8's products, K9's sums): opened on
    the card where ``x`` has a frame axis (``min_dim`` dimensions up: 3 for
    batches of matrices, 2 for rows) of more than one frame, as a batch
    runs them; a do-nothing context otherwise."""
    if _on_card(x) and x.dim() >= min_dim and x.shape[0] > 1:
        return profiling.span("gpet.frame_by_frame")
    return contextlib.nullcontext()


def frame_sum(x):
    """Sum over the last axis of (B, n) rows, every row in one launch of
    K9 on the card, in an order set by n alone: ``torch.sum`` picks its
    thread layout, and so its order, from the number of rows, which at 128
    demo frames moved a sampling round's sums off a single trace's. The
    loop's sums (the sampling round's masked mean and std, the kept curves'
    weights) take it, so a batch frame draws and weighs its curves as its
    single trace does. ``torch.sum`` on the CPU."""
    with frames_span(x, min_dim=2):
        return row_sum(x)


def safe_cholesky(K, jitter_scales=(0.0, 1e-5, 1e-3), per_matrix=False):
    """Lower Cholesky of each (n, n) matrix of ``K`` (..., n, n) with a
    branchless jitter ladder: every candidate ``K + jitter·mean(diag K)·I``
    is factored in one batched call and each matrix takes the first of its
    own that factored; if none did, the last. ``cholesky_ex`` leaves finite
    garbage where a factorisation fails, so its ``info``, not the diagonal,
    decides. With ``per_matrix``, on the card, the candidates go through
    K5 (:func:`cholesky_auto`), whose bits do not depend on the batch, and
    a failed factor has a diagonal that is not finite. Each rung scales the
    mean diagonal as a Python scalar (rounded to ``K``'s dtype, as a tensor
    of the ladder would be) and the fallback index is a Python scalar: the
    function copies nothing from the host and never waits for the device,
    so a CUDA graph can capture it."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    scale = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
    jit = torch.stack([scale * s for s in jitter_scales], dim=-1)  # (..., J)
    candidates = K[..., None, :, :] + jit[..., None, None] * eye
    if per_matrix and _on_card(K):
        Ls = cholesky_auto(candidates)
        ok = torch.isfinite(torch.diagonal(Ls, dim1=-2, dim2=-1)).all(-1)
    else:
        Ls, info = torch.linalg.cholesky_ex(candidates)
        ok = info == 0
    idx = torch.where(ok.any(-1), torch.argmax(ok.to(torch.uint8), dim=-1),
                      len(jitter_scales) - 1)
    return torch.take_along_dim(Ls, idx[..., None, None, None],
                                dim=-3)[..., 0, :, :]


def _last_sum(x):
    return x.sum(-1)


def masked_mean(y, mask, total=_last_sum):
    """Mean of the valid entries along the last axis; ``total`` sums that
    axis (:func:`fixed_sum` in the final fit)."""
    m = mask.to(y.dtype)
    return total(y * m) / torch.clamp(m.sum(-1), min=1.0)


def masked_std(y, mask, total=_last_sum):
    """Population std of the valid entries along the last axis."""
    m = mask.to(y.dtype)
    n = torch.clamp(m.sum(-1), min=1.0)
    mu = total(y * m) / n
    return torch.sqrt(total(m * (y - mu[..., None]) ** 2) / n)


def gp_fit(spec: KernelSpec, x, y, length_scale, variance, diag_noise, mask,
           centre=True):
    """Gram + Cholesky + dual coefficients (sklearn_gpr.py:304-320);
    ``centre=True`` removes the masked mean only, like the fork's
    ``normalize_y``."""
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    y_mean = masked_mean(y, mask, fixed_sum) if centre else zero
    yc = torch.where(mask, y - y_mean[..., None], zero)
    K = train_gram(spec, x, length_scale, variance, diag_noise, mask=mask)
    L = safe_cholesky(K, per_matrix=True)
    if _on_card(L):
        alpha = backward_solve_auto(L, forward_solve_auto(
            L, yc[..., None].contiguous()))[..., 0]
    else:
        alpha = torch.cholesky_solve(yc[..., None], L)[..., 0]
    alpha = torch.where(mask, alpha, zero)
    return GPState(L=L, alpha=alpha, x=x, y_mean=y_mean, mask=mask)


def _masked_cross(spec, state: GPState, xq, length_scale, variance):
    Kq = cross_gram(spec, xq, state.x, length_scale, variance)
    return torch.where(state.mask[..., None, :], Kq, torch.zeros_like(Kq))


def _mean(Kq, state: GPState):
    # A row sum, not a matrix-vector product: its bits do not depend on
    # the number of frames.
    return (fixed_sum(Kq * state.alpha[..., None, :])
            + state.y_mean[..., None])


def gp_predict_mean(spec: KernelSpec, state: GPState, xq, length_scale,
                    variance):
    """Posterior mean at query points (sklearn_gpr.py:381-385)."""
    return _mean(_masked_cross(spec, state, xq, length_scale, variance),
                 state)


def gp_predict(spec: KernelSpec, state: GPState, xq, length_scale, variance,
               return_std=False, return_cov=False):
    """Posterior mean and, with ``return_std``, the std at query points
    (zero query noise, with the negative-variance clamp), or with
    ``return_cov`` the (nq, nq) covariance ``K** − VᵀV`` (gpr.py:107-128;
    ``return_cov`` wins over ``return_std``, as there)."""
    Kq = _masked_cross(spec, state, xq, length_scale, variance)
    mean = _mean(Kq, state)
    if not (return_std or return_cov):
        return mean
    if _on_card(Kq):
        V = forward_solve_auto(state.L, Kq.transpose(-1, -2).contiguous())
    else:
        V = torch.linalg.solve_triangular(state.L, Kq.transpose(-1, -2),
                                          upper=False)
    if return_cov:
        cov = (cross_gram(spec, xq, xq, length_scale, variance)
               - V.transpose(-1, -2) @ V)
        return mean, cov
    var = torch.clamp(per_frame(variance, 1) - fixed_sum(V * V, dim=-2),
                      min=0.0)
    return mean, torch.sqrt(var)


def prior_grid_cholesky(spec: KernelSpec, grid, length_scale, jitter=1e-6):
    """A square-root factor F (F Fᵀ = K) of the unit-variance prior Gram
    over ``grid``, by a symmetric eigendecomposition, ``V·√max(λ, 0)``
    (gpr.py:131 of the reference package): a noise-free RBF Gram over
    hundreds of unit-spaced points is rank-deficient in float32, where a
    Cholesky fails. Public but unused by the trace, which takes its prior
    factor from ``trace/driver.py::prior_factor``. The eigenvectors' signs
    are the library's: any F with F Fᵀ = K gives the same sampling
    distribution."""
    Kg = cross_gram(spec, grid, grid, length_scale, 1.0)
    Kg = Kg + jitter * torch.eye(grid.shape[-1], dtype=Kg.dtype,
                                 device=Kg.device)
    w, V = torch.linalg.eigh(Kg)
    return V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]


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

    Frames: with (B, n) training buffers the scalars are (B,) and the
    result (B, E, S). Frames that draw the same normals (a batch: every
    frame draws from the config's seed) pass one (r, S) ``z`` and the prior
    draw ``F z`` is computed once for all of them; frames with draws of
    their own (an ensemble's members) pass (B, r, S) and (B, n, S). On the
    card the solve runs through K6, the cross product through K8 and a
    per-frame ``F z`` one member at a time, so a frame draws the curves its
    single trace draws, bit for bit.

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
    y_mean = masked_mean(y, mask, frame_sum) if centre else zero
    yc = torch.where(mask, y - y_mean[..., None], zero)

    K = train_gram(spec, x, length_scale, variance, diag_noise, mask=mask)
    # Two-rung jitter ladder: the sampling Gram carries the full
    # observation-noise diagonal, so the 1e-5 rung is never the first to
    # factor (gpr.py:214-219).
    L = safe_cholesky(K, jitter_scales=(0.0, 1e-3))

    # f0 = sqrt(variance)·F z, taken at the training and output rows only.
    Fz = (L_prior_unit @ z if z.dim() == 2 or not _on_card(z)
          else torch.stack([L_prior_unit @ zf for zf in z]))   # (..., G, S)
    scale = per_frame(torch.sqrt(variance))
    if Fz.dim() == 2:
        f0_x = scale * Fz[x_idx]                               # (..., n, S)
    else:
        f0_x = scale * torch.take_along_dim(Fz, x_idx[..., None], dim=-2)
    f0_grid = scale * Fz.index_select(-2, grid_out)            # (..., E, S)
    eps = torch.sqrt(torch.clamp(diag_noise, min=0.0))[..., None] * w
    resid = torch.where(mask[..., None], yc[..., None] - f0_x - eps, zero)
    with frames_span(resid):
        if _on_card(resid):
            A = backward_solve_auto(L, forward_solve_auto(L, resid))
        else:
            A = torch.cholesky_solve(resid, L)
    A = torch.where(mask[..., None], A, zero)

    Kq = cross_gram(spec, grid_out.to(Fz.dtype), x, length_scale, variance)
    Kq = torch.where(mask[..., None, :], Kq, zero)             # (..., E, n)
    with frames_span(Kq):
        KqA = frames_product(Kq, A)                            # (..., E, S)
    return per_frame(y_mean) + per_frame(post_scale) * (f0_grid + KqA)


def log_marginal_likelihood(spec: KernelSpec, x, yc, mask, theta,
                            noise_weight, jitter=1e-6, pd_guard=True):
    """LML of θ = (log c, log ℓ, log σn²) for centred targets (one θ).
    Padded slots contribute zero; the −n/2·log 2π term counts valid points
    only. With ``pd_guard`` (the default, as in the reference,
    gpr.py:274-313) a Gram that is not positive definite gives −inf: its
    factor's diagonal is not finite and positive. With ``pd_guard=False``
    it gives NaN, as :func:`batched_lml` does."""
    val, L = _batched_lml(spec, x, yc, mask, theta[None], noise_weight,
                          jitter, with_grad=False)
    if not pd_guard:
        return val[0]
    d = torch.diagonal(L[0])
    ok = (torch.isfinite(d) & (d > 0)).all()
    return torch.where(ok, val[0], torch.full_like(val[0], -math.inf))


def library_lml(spec: KernelSpec, x, yc, mask, thetas, noise_weight,
                jitter=1e-6, pd_guard=True):
    """LML of θ = (log c, log ℓ, log σn²) for centred targets through the
    library's Cholesky and triangular solves (``torch.linalg``), in the
    dtype of ``thetas`` and differentiable by autograd and ``torch.func``:
    the JAX package's :func:`log_marginal_likelihood` on its non-TPU path
    (gpr.py:274-313), which XLA computes outside any Pallas kernel.

    ``thetas`` (..., 3) gives one value per θ. ``yc`` (n,) or (n, m): m
    target columns share one Gram and their LMLs are summed
    (sklearn_gpr.py:542-546). With ``pd_guard`` a Gram that is not positive
    definite gives −inf with a zero gradient (a probe factorisation decides,
    and the Gram is replaced by the identity there); without it, NaN."""
    dt = thetas.dtype
    zero = torch.zeros((), dtype=dt, device=thetas.device)
    x = x.to(dt)
    yc = yc.to(dt)
    if yc.dim() == 1:
        yc = yc[:, None]
    yc = torch.where(mask[:, None], yc, zero)
    c = torch.exp(thetas[..., 0])
    ls = torch.exp(thetas[..., 1])
    nz = torch.exp(thetas[..., 2])
    diag_noise = nz[..., None] * noise_weight.to(dt) + jitter
    K = train_gram(spec, x, ls, c, diag_noise, mask=mask)
    L, info = torch.linalg.cholesky_ex(K.detach())
    ok = (info == 0) & (torch.diagonal(L, dim1=-2, dim2=-1) > 0).all(-1)
    if pd_guard:
        eye = torch.eye(K.shape[-1], dtype=dt, device=K.device)
        K = torch.where(ok[..., None, None], K, eye)
    L = torch.linalg.cholesky_ex(K).L
    w = torch.linalg.solve_triangular(L, yc.expand(K.shape[:-1] + (
        yc.shape[-1],)), upper=False)
    m = yc.shape[-1]
    diag = torch.where(mask, torch.diagonal(L, dim1=-2, dim2=-1),
                       zero + 1.0)
    lml = (-0.5 * (w * w).sum((-2, -1)) - m * torch.log(diag).sum(-1)
           - 0.5 * m * mask.sum().to(dt) * math.log(2.0 * math.pi))
    bad = torch.full_like(lml, -math.inf if pd_guard else math.nan)
    return torch.where(ok, lml, bad)


def batched_lml(spec: KernelSpec, x, yc, mask, thetas, noise_weight,
                jitter=1e-6, with_grad=False):
    """LML of many θ = (log c, log ℓ, log σn²) at once (gpr.py:316-391).

    The B factorisations run through K5 and the solves through K6. NaN
    marks a non-PD Gram, for the caller to sanitise. Gradients are the
    reference's analytic trace formula, ∂LML/∂θᵢ = ½ tr((ααᵀ − K⁻¹)∂K/∂θᵢ),
    with K⁻¹ = L⁻ᵀL⁻¹ from an identity-RHS forward solve; on the card a
    backward solve of its result (K6 both) takes the batched product's
    place.

    Args:
      thetas: (B, 3). Returns (B,) values, or (values, (B, 3) gradients).
        With frames, x, yc and mask are (F, n) and thetas (F, B, 3), and
        the F·B factorisations share one K5 launch.
    """
    return _batched_lml(spec, x, yc, mask, thetas, noise_weight, jitter,
                        with_grad)[0]


def _batched_lml(spec, x, yc, mask, thetas, noise_weight, jitter, with_grad):
    """:func:`batched_lml`'s result and the (..., B, n, n) factors."""
    dt = thetas.dtype
    dev = thetas.device
    zero = torch.zeros((), dtype=dt, device=dev)
    x = x.to(dt)
    yc = torch.where(mask, yc, zero).to(dt)
    noise_weight = noise_weight.to(dt)
    n = x.shape[-1]
    c = torch.exp(thetas[..., 0])                           # (..., B)
    ls = torch.exp(thetas[..., 1])
    nz = torch.exp(thetas[..., 2])
    mask_b = mask[..., None, :]                             # (..., 1, n)

    r = torch.abs(x[..., :, None] - x[..., None, :])        # (..., n, n)
    d = r[..., None, :, :] / ls[..., None, None]            # (..., B, n, n)
    Ku = k_unit(spec, d)
    m2 = (mask[..., :, None] & mask[..., None, :])[..., None, :, :]
    eye = torch.eye(n, dtype=dt, device=dev)
    diag_vals = torch.where(mask_b,
                            nz[..., None] * noise_weight[..., None, :]
                            + jitter, zero)                 # (..., B, n)
    cK = torch.where(m2, c[..., None, None] * Ku, zero)
    # Off-diagonal signal zeroed outside the valid block; padded diagonal 1.
    K = (cK * (1.0 - eye)
         + eye * (cK + diag_vals[..., None, :]
                  + torch.where(mask_b, zero, zero + 1.0)[..., None, :]))

    L = cholesky_auto(K)
    rhs = yc[..., None, :, None].expand(K.shape[:-1] + (1,))
    w1 = forward_solve_auto(L, rhs.contiguous())
    logdiag = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    quad, logdet = fixed_sum(torch.stack([w1[..., 0] ** 2, logdiag],
                                         dim=-2)).unbind(-1)
    n_valid = mask.sum(-1).to(dt)[..., None]
    vals = -0.5 * quad - logdet - 0.5 * n_valid * math.log(2.0 * math.pi)
    if not with_grad:
        return vals, L

    alpha = backward_solve_auto(L, w1)[..., 0]              # (..., B, n)
    alpha = torch.where(mask_b, alpha, zero)
    Linv = forward_solve_auto(L, eye.expand(K.shape).contiguous())
    if _on_card(L):
        Kinv = backward_solve_auto(L, Linv)                 # L⁻ᵀ L⁻¹
    else:
        Kinv = Linv.transpose(-1, -2) @ Linv
    A = alpha[..., :, None] * alpha[..., None, :] - Kinv

    dKl = torch.where(m2, c[..., None, None] * dk_unit_dlog_ls(spec, d),
                      zero)
    diagA = torch.diagonal(A, dim1=-2, dim2=-1)
    noise_terms = diagA * (nz[..., None] * noise_weight[..., None, :]) * mask_b
    if _on_card(A):
        # The trace products' row sums and the noise terms: (..., B, 3, n),
        # summed by one more tree.
        rows = tree_sum(A[..., None, :, :] * torch.stack([cK, dKl], dim=-3))
        grads = 0.5 * tree_sum(torch.cat([rows, noise_terms[..., None, :]],
                                         dim=-2))
    else:
        grads = 0.5 * torch.stack([(A * cK).sum((-2, -1)),
                                   (A * dKl).sum((-2, -1)),
                                   noise_terms.sum(-1)], dim=-1)
    return (vals, grads), L
