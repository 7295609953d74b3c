"""The plain reference of one edge trace, in PyTorch, with no kernel of the
program and nothing it made.

It follows the algorithm as ``gaussian_process_edge_trace_torch`` at commit
b71f8113f0c7ad4e79e6543cfb6e16f28479a0e3 states it (``trace/driver.py``,
``models/gpr.py``, ``models/kernels.py``, ``models/newton.py``,
``trace/scoring.py``, ``trace/kde.py``, ``trace/select.py``,
``ops/integrate.py``), for one trace at a time, written again from those
files in plain operations: the curve costs by a gather and Simpson sums (no
K1/K2), the KDE's binning as a dense hat contraction (no K3), the
factorisations and solves through ``torch.linalg`` (no K5/K6), the draws
through ``gpet_bench/threefry.py`` (no K7), every sum a ``torch.sum``. It
derives everything from the gradient image, the endpoints, the tracer
arguments and the seed.

``tf32=True`` is the control: every product that contracts an axis
(matrix, matrix-vector and dot products) takes its operands rounded to
TF32's 10-bit mantissa (round to nearest even), as a float32 product with
TF32 on computes them, and accumulates in float32.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gpet_bench import threefry

KDE_THRESH = 1e-3
GP_JITTER = 1e-6
MAX_ITERS = 48
MAX_DECAYS = 400
LML_RESTARTS = 12
DIRECT_FIT_N = 160
PRIOR_RANK_RTOL = 1e-8
BLUR_RADIUS = 8
BLUR_MATMUL_MAX = 600
BINNING_CHUNK = 128 * 1024 * 1024
LAMBDAS = (0.0, 1e-3, 1e-1, 10.0, 1e3)


def round_tf32(x):
    """``x`` (float32) rounded to 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    out = r.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


class Plan(NamedTuple):
    """The trace's static sizes, from the tracer arguments."""
    M: int
    N: int
    x_st: int
    x_en: int
    E: int
    kind: str
    nu: float
    sigma_f: float
    sigma_l: float
    noise_y: float
    S: int
    N_keep: int
    delta_x: int
    pixel_thresh: int
    algo_thresh: int
    score_thresh0: float
    fix_endpoints: bool
    bin_min: int
    n_bins: int
    n_train: int
    init_noise_weight: float


def make_plan(init_xy, shape, tracer: dict) -> Plan:
    """The reference's clamps (gpet.py:95-119) for ``tracer``, the
    configuration's tracer arguments; ``init_xy`` (2, 2) in xy-space."""
    init = np.asarray(init_xy)
    init = init[np.argsort(init[:, 0])].astype(int)
    x_st, x_en = int(init[0, 0]), int(init[-1, 0])
    M, N = shape
    S = int(tracer["N_samples"])
    S = S if S > 100 else 1000
    pixel_thresh = max(int(tracer["pixel_thresh"]), 2)
    st = float(tracer["score_thresh"])
    st = st if 0 < st <= 1 else 1.0
    dx = int(tracer["delta_x"])
    dx = dx if dx > 3 else 2
    E = x_en - x_st + 1
    n_sub = E // dx
    ko = tracer["kernel_options"]
    kind = ko["kernel"]
    nu = float(ko["nu"]) if kind == "Matern" else 2.5
    cols = np.arange(N)
    bins = np.round((cols - x_st) / dx).astype(int)
    bin_min = int(bins.min())
    n_bins = int(bins.max()) - bin_min + 1
    n_train = -(-(init.shape[0] + n_bins) // 8) * 8
    fix = bool(tracer["fix_endpoints"])
    return Plan(M=M, N=N, x_st=x_st, x_en=x_en, E=E, kind=kind, nu=nu,
                sigma_f=float(ko["sigma_f"]),
                sigma_l=float(ko["length_scale"]),
                noise_y=float(tracer["noise_y"]), S=S,
                N_keep=int(float(tracer["keep_ratio"]) * int(
                    tracer["N_samples"])),
                delta_x=dx, pixel_thresh=pixel_thresh,
                algo_thresh=n_sub - (pixel_thresh - 1), score_thresh0=st,
                fix_endpoints=fix, bin_min=bin_min, n_bins=n_bins,
                n_train=n_train, init_noise_weight=1e-7 if fix else 0.5)


# ------------------------------------------------------------- kernels ---

def k_unit(kind, nu, d):
    if kind == "RBF":
        return torch.exp(-0.5 * d * d)
    s = (math.sqrt(5.0) if nu == 2.5 else math.sqrt(3.0)) * d
    if nu == 2.5:
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    return (1.0 + s) * torch.exp(-s)


def dk_unit_dlog_ls(kind, nu, d):
    if kind == "RBF":
        return d * d * torch.exp(-0.5 * d * d)
    s = (math.sqrt(5.0) if nu == 2.5 else math.sqrt(3.0)) * d
    if nu == 2.5:
        return (s * s / 3.0) * (1.0 + s) * torch.exp(-s)
    return s * s * torch.exp(-s)


def k_unit_np(kind, nu, d):
    if kind == "RBF":
        return np.exp(-0.5 * d * d)
    s = (math.sqrt(5.0) if nu == 2.5 else math.sqrt(3.0)) * d
    if nu == 2.5:
        return (1.0 + s + s * s / 3.0) * np.exp(-s)
    return (1.0 + s) * np.exp(-s)


def cross_gram(p: Plan, x1, x2, ls, var):
    d = torch.abs(x1[:, None] - x2[None, :]) / ls
    return var * k_unit(p.kind, p.nu, d)


def train_gram(p: Plan, x, ls, var, diag_noise, mask, pad_diag=1.0):
    K = cross_gram(p, x, x, ls, var) + torch.diag_embed(diag_noise)
    n = x.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    m2 = mask[:, None] & mask[None, :]
    return (torch.where(m2, K, zero)
            + torch.where(mask[:, None], zero, pad_diag * eye))


def safe_cholesky(K, jitter_scales):
    """The first of ``K + j·mean(diag K)·I`` that factors."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    scale = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
    jit = torch.tensor(jitter_scales, dtype=K.dtype,
                       device=K.device) * scale[..., None]
    Ls, info = torch.linalg.cholesky_ex(K[..., None, :, :]
                                        + jit[..., None, None] * eye)
    ok = info == 0
    idx = torch.where(ok.any(-1), torch.argmax(ok.to(torch.uint8), dim=-1),
                      torch.tensor(len(jitter_scales) - 1, device=K.device))
    return torch.take_along_dim(Ls, idx[..., None, None, None],
                                dim=-3)[..., 0, :, :]


def masked_mean(y, mask):
    m = mask.to(y.dtype)
    return (y * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def masked_std(y, mask):
    m = mask.to(y.dtype)
    n = torch.clamp(m.sum(-1), min=1.0)
    mu = (y * m).sum(-1) / n
    return torch.sqrt((m * (y - mu[..., None]) ** 2).sum(-1) / n)


# ---------------------------------------------------------------- data ---

@functools.lru_cache(maxsize=8)
def prior_factor(p: Plan) -> np.ndarray:
    """(N, r) truncated unit prior factor: float64 eigh of the unit Gram
    plus the jitter, eigenpairs above max(2·jitter, w_max·1e-8), the rank
    rounded up to a multiple of 8."""
    cols = np.arange(p.N, dtype=np.float64)
    K = k_unit_np(p.kind, p.nu, np.abs(cols[:, None] - cols[None, :])
                  / p.sigma_l)
    K[np.diag_indices_from(K)] += GP_JITTER
    w, V = np.linalg.eigh(K)
    w = np.clip(w, 0.0, None)
    thr = max(2.0 * GP_JITTER, w[-1] * PRIOR_RANK_RTOL)
    r = min(p.N, -(-int(np.sum(w > thr)) // 8) * 8)
    w, V = w[p.N - r:], V[:, p.N - r:]
    return (V * np.sqrt(w)[None, :]).astype(np.float32)


def gaussian_taps(device):
    t = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32,
                     device=device)
    return torch.exp(-0.5 * t ** 2)


def _toeplitz(n, taps):
    r = (taps.shape[0] - 1) // 2
    idx = torch.arange(n, device=taps.device)
    d = idx[:, None] - idx[None, :]
    vals = taps[torch.clamp(d + r, 0, 2 * r)]
    return torch.where(torch.abs(d) <= r, vals, torch.zeros_like(vals))


def _blur_axis_fma(grid, taps, axis):
    r = (taps.shape[0] - 1) // 2
    n = grid.shape[axis]
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    g = torch.nn.functional.pad(grid, pad)
    out = taps[0] * g.narrow(axis, 0, n)
    for k in range(1, taps.shape[0]):
        out = out + taps[k] * g.narrow(axis, k, n)
    return out


def blur(grid, mm):
    """2-D zero-boundary Gaussian blur (bw 1, radius 8): a banded Toeplitz
    product along an axis of at most 600, else shifted multiply-adds."""
    taps = gaussian_taps(grid.device)
    m, n = grid.shape
    out = (mm(_toeplitz(m, taps), grid) if m <= BLUR_MATMUL_MAX
           else _blur_axis_fma(grid, taps, 0))
    return (mm(out, _toeplitz(n, taps)) if n <= BLUR_MATMUL_MAX
            else _blur_axis_fma(out, taps, 1))


def minmax(grid):
    return (grid - grid.min()) / (grid.max() - grid.min())


class Data(NamedTuple):
    grad: torch.Tensor      # (M, N) normalised gradient image
    grad_kde: torch.Tensor  # (M, N)
    cols: torch.Tensor      # (E, M) gradient columns along the x grid
    F: torch.Tensor         # (N, r) prior factor
    x_grid: torch.Tensor    # (E,) int64
    init_x: torch.Tensor
    init_y: torch.Tensor


def make_data(p: Plan, grad_img, init_xy, mm) -> Data:
    dev = grad_img.device
    g = grad_img.to(torch.float32)
    g = g - g.min()
    g = g / g.max()
    masked = torch.where(g > KDE_THRESH, g, torch.zeros_like(g))
    gkde = minmax(blur(torch.nn.functional.pad(masked, (1, 1, 1, 1)),
                       mm)[1:-1, 1:-1])
    init = torch.as_tensor(np.asarray(init_xy), dtype=torch.int64,
                           device=dev)
    init = init[torch.argsort(init[:, 0], stable=True)]
    return Data(grad=g, grad_kde=gkde,
                cols=g.T[p.x_st:p.x_st + p.E].contiguous(),
                F=torch.tensor(prior_factor(p), device=dev),
                x_grid=p.x_st + torch.arange(p.E, device=dev),
                init_x=init[:, 0].contiguous(), init_y=init[:, 1].contiguous())


# ------------------------------------------------------------- scoring ---

def _pair(y0, y1, y2, h0, h1):
    hsum = h0 + h1
    return (hsum / 6.0) * (y0 * (2.0 - h1 / h0) + y1 * hsum * hsum / (h0 * h1)
                           + y2 * (2.0 - h0 / h1))


def _odd_block(y, h):
    m = y.shape[0]
    c = _pair(y[:-2], y[1:-1], y[2:], h[:-1], h[1:])
    keep = (torch.arange(m - 2, device=y.device) % 2 == 0)[:, None]
    return torch.where(keep, c, torch.zeros((), dtype=y.dtype,
                                            device=y.device)).sum(0)


def simpson(y, h):
    """Composite Simpson over axis 0 of ``y`` with interval widths ``h``;
    an even count takes the Cartwright tail (scipy's ``even='simpson'``)."""
    n = y.shape[0]
    if n == 2:
        return 0.5 * (y[0] + y[1]) * h[0]
    if n % 2 == 1:
        return _odd_block(y, h)
    h0, h1 = h[-2], h[-1]
    alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
    beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
    eta = h1 * h1 * h1 / (6 * h0 * (h0 + h1))
    return (_odd_block(y[:n - 1], h[:n - 2])
            + alpha * y[-1] + beta * y[-2] - eta * y[-3])


def curve_costs(cols, ys):
    """(S,) costs ``arc / line`` of the (E, S) curves ``ys`` through the
    (E, M) gradient columns (gpet.py:371-405)."""
    M = cols.shape[-1]
    y = torch.clamp(ys, 0, M - 1)
    r0 = torch.clamp(torch.floor(y), 0, M - 2)
    fr = y - r0
    r0 = r0.long()
    ce = cols.expand(ys.shape[:-1] + (M,))
    v0 = torch.gather(ce, -1, r0)
    v1 = torch.gather(ce, -1, r0 + 1)
    score = v0 + fr * (v1 - v0) + KDE_THRESH
    dy = torch.diff(ys, dim=0)
    step = torch.sqrt(1.0 + dy * dy)
    line = simpson(score[:-1], step[1:])
    arc = simpson(step, torch.ones_like(step[1:]))
    return arc / line


# --------------------------------------------------------------- loop ----

def _train_set(p: Plan, d: Data, obs_x, obs_y, obs_valid):
    dev = d.x_grid.device
    pad = p.n_train - 2 - obs_x.shape[0]
    zi = torch.zeros(pad, dtype=torch.int64, device=dev)
    x = torch.cat([d.init_x, obs_x, zi])
    y = torch.cat([d.init_y, obs_y, zi])
    mask = torch.cat([torch.ones(2, dtype=torch.bool, device=dev), obs_valid,
                      torch.zeros(pad, dtype=torch.bool, device=dev)])
    noise_w = torch.cat([
        torch.full((2,), p.init_noise_weight, dtype=torch.float32,
                   device=dev),
        torch.ones(p.n_train - 2, dtype=torch.float32, device=dev)])
    return x, y, mask, noise_w


def sample_round(p: Plan, d: Data, x, y, mask, noise_w, z, w, mm):
    """(E, S) posterior curves by Matheron's rule on the prior factor."""
    yf = y.to(torch.float32)
    std_raw = masked_std(yf, mask)
    y_s = std_raw + 1.0
    variance = p.sigma_f ** 2 / y_s ** 2
    diag_noise = p.noise_y * noise_w + GP_JITTER
    s2 = std_raw / y_s
    post_scale = torch.where(s2 == 0.0, torch.ones_like(s2), s2)
    ys = yf / y_s
    xf = x.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    y_mean = masked_mean(ys, mask)
    yc = torch.where(mask, ys - y_mean, zero)
    K = train_gram(p, xf, p.sigma_l, variance, diag_noise, mask)
    L = safe_cholesky(K, (0.0, 1e-3))
    Fz = mm(d.F, z)
    scale = torch.sqrt(variance)
    f0_x = scale * Fz[x]
    f0_grid = scale * Fz.index_select(0, d.x_grid)
    eps = torch.sqrt(torch.clamp(diag_noise, min=0.0))[:, None] * w
    resid = torch.where(mask[:, None], yc[:, None] - f0_x - eps, zero)
    A = torch.where(mask[:, None], torch.cholesky_solve(resid, L), zero)
    Kq = cross_gram(p, d.x_grid.to(torch.float32), xf, p.sigma_l, variance)
    Kq = torch.where(mask[None, :], Kq, zero)
    return (y_mean + post_scale * (f0_grid + mm(Kq, A))) * y_s


def column_binning(y, wts, M):
    """(M+2, E) linear binning of the kept curves: the dense hat
    contraction, in chunks of curves whose sums are added in order."""
    E, S = y.shape
    rows = torch.arange(M + 2, dtype=y.dtype, device=y.device)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)

    def block(yb, wb):
        w = torch.where((yb >= 0) & (yb <= M - 1), wb[None, :], zero)
        hat = torch.clamp(1.0 - torch.abs((yb + 1.0)[None] - rows[:, None,
                                                                  None]),
                          min=0.0)
        return (hat * w[None]).sum(-1)

    chunk = max(1, BINNING_CHUNK // ((M + 2) * E))
    H = block(y[:, :chunk], wts[:chunk])
    for s0 in range(chunk, S, chunk):
        H = H + block(y[:, s0:s0 + chunk], wts[s0:s0 + chunk])
    return H


def curve_kde(p: Plan, curves, wts, mm):
    H = column_binning(curves, wts, p.M)
    grid = torch.zeros((p.M + 2, p.N + 2), dtype=curves.dtype,
                       device=curves.device)
    grid[:, p.x_st + 1:p.x_st + 1 + p.E] = H
    return minmax(blur(grid, mm)[1:-1, 1:-1])


def decay_ladder() -> np.ndarray:
    """1 then 0.95^j, as blocked prefix products of 16 (the grouping the
    JAX package's ``cumprod`` takes on the CPU)."""
    def prefix(a, block=16):
        if a.shape[0] <= block:
            return np.cumprod(a, dtype=np.float32)
        parts = [np.cumprod(a[k:k + block], dtype=np.float32)
                 for k in range(0, a.shape[0], block)]
        pre = prefix(np.array([q[-1] for q in parts], np.float32), block)
        out = [parts[0]] + [np.float32(pre[k - 1]) * parts[k]
                            for k in range(1, len(parts))]
        return np.concatenate(out).astype(np.float32)
    dec = np.full((MAX_DECAYS,), 0.95, np.float32)
    dec[0] = 1.0
    return prefix(dec)


def select(p: Plan, d: Data, kde, obs_x, obs_y, obs_valid, n_pre, thresh0,
           consts):
    """Scores, the adaptive threshold and each bin's best pixel
    (gpet.py:532-662): ``(obs_x, obs_y, obs_valid, n_fobs, thresh)``."""
    onehot, col_ok, ladder = consts
    M, N = kde.shape
    dev = kde.device
    dense = kde > KDE_THRESH
    cand = dense & col_ok if p.fix_endpoints else dense
    flat = torch.where(obs_valid, obs_y * N + obs_x,
                       torch.full_like(obs_x, M * N))
    old = torch.zeros(M * N + 1, dtype=torch.bool, device=dev)
    old[flat] = True
    elig = cand | (old[:M * N].reshape(M, N) & dense)
    raw = (kde * d.grad_kde + kde + d.grad_kde) / 3.0
    neg = torch.full((), -torch.inf, dtype=raw.dtype, device=dev)
    score = torch.where(elig, raw, neg)
    col_best = score.amax(0)
    col_best_y = torch.argmax(score, dim=0)
    per_bin = torch.where(onehot, col_best[None, :], neg)
    bin_col = torch.argmax(per_bin, dim=-1)
    bin_score = per_bin.amax(-1)
    threshs = thresh0 * ladder
    n_at = (bin_score[None, :] >= threshs[:, None]).sum(-1)
    stop = (n_at - n_pre >= p.pixel_thresh) | (n_at >= p.algo_thresh)
    j = (torch.argmax(stop.to(torch.uint8)) if bool(stop.any())
         else MAX_DECAYS - 1)
    thresh = threshs[j]
    valid = bin_score >= thresh
    zero = torch.zeros_like(bin_col)
    nx = torch.where(valid, bin_col, zero)
    ny = torch.where(valid, col_best_y[bin_col], zero)
    return nx, ny, valid, int(valid.sum()), thresh


def select_consts(p: Plan, device):
    cols = np.arange(p.N)
    q = ((np.arange(p.N, dtype=np.float32) - np.float32(p.x_st))
         / np.float32(p.delta_x))
    bin_of = np.round(q).astype(np.int64) - p.bin_min
    onehot = bin_of[None, :] == np.arange(p.n_bins)[:, None]
    return (torch.as_tensor(onehot, device=device),
            torch.as_tensor((cols > p.x_st) & (cols < p.x_en), device=device),
            torch.as_tensor(decay_ladder(), device=device))


# ----------------------------------------------------------- final fit ---

def batched_lml(p: Plan, x, yc, mask, thetas, noise_w, with_grad, mm):
    """LML of each θ = (log c, log ℓ, log σn²) (gpr.py:316-391), NaN for a
    Gram that does not factor; with ``with_grad`` also the analytic
    gradient ½ tr((ααᵀ − K⁻¹) ∂K/∂θᵢ)."""
    dev = thetas.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    yc = torch.where(mask, yc, zero)
    n = x.shape[-1]
    c = torch.exp(thetas[:, 0])
    ls = torch.exp(thetas[:, 1])
    nz = torch.exp(thetas[:, 2])
    d = torch.abs(x[:, None] - x[None, :])[None] / ls[:, None, None]
    Ku = k_unit(p.kind, p.nu, d)
    m2 = (mask[:, None] & mask[None, :])[None]
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    mask_b = mask[None, :]
    diag_vals = torch.where(mask_b, nz[:, None] * noise_w[None, :]
                            + GP_JITTER, zero)
    cK = torch.where(m2, c[:, None, None] * Ku, zero)
    K = (cK * (1.0 - eye) + eye * (cK + diag_vals[:, None, :]
                                   + torch.where(mask_b, zero,
                                                 zero + 1.0)[:, None, :]))
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info > 0)[:, None, None], torch.full_like(L, math.nan),
                    L)
    rhs = yc[None, :, None].expand(K.shape[:-1] + (1,))
    w1 = torch.linalg.solve_triangular(L, rhs, upper=False)
    quad = mm(w1.transpose(-1, -2), w1)[:, 0, 0]
    logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    vals = (-0.5 * quad - logdet
            - 0.5 * mask.sum().to(torch.float32) * math.log(2.0 * math.pi))
    if not with_grad:
        return vals
    alpha = torch.linalg.solve_triangular(L.transpose(-1, -2), w1,
                                          upper=True)[..., 0]
    alpha = torch.where(mask_b, alpha, zero)
    Linv = torch.linalg.solve_triangular(L, eye.expand(K.shape),
                                         upper=False)
    Kinv = mm(Linv.transpose(-1, -2), Linv)
    A = alpha[:, :, None] * alpha[:, None, :] - Kinv
    dKl = torch.where(m2, c[:, None, None] * dk_unit_dlog_ls(p.kind, p.nu, d),
                      zero)
    diagA = torch.diagonal(A, dim1=-2, dim2=-1)
    noise_terms = diagA * (nz[:, None] * noise_w[None, :]) * mask_b
    grads = 0.5 * torch.stack([(A * cK).sum((-2, -1)),
                               (A * dKl).sum((-2, -1)),
                               noise_terms.sum(-1)], dim=-1)
    return vals, grads


def _finite_or(x, fill):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, fill))


def _screen(f0s, starts, n_polish):
    P = min(n_polish, starts.shape[-2])
    top = torch.sort(_finite_or(f0s, math.inf), stable=True).indices[:P]
    return starts[top], _finite_or(f0s[top], math.inf)


def polish(values_fn, vg_fn, starts, lb, ub, n_polish, iters, fd_h=1e-3):
    """Minimise over the box [lb, ub] (newton.py): a screen of the starts,
    then damped-Newton steps (Levenberg ladder and a projected-gradient
    candidate) on the ``n_polish`` best, the Hessian from central
    differences of the gradient. Returns ``(θ, value)``."""
    dt, dev = starts.dtype, starts.device
    dd = starts.shape[-1]
    lam = torch.tensor(LAMBDAS, dtype=dt, device=dev)
    eye = torch.eye(dd, dtype=dt, device=dev)
    offs = torch.cat([torch.zeros((1, dd), dtype=dt, device=dev),
                      fd_h * eye, -fd_h * eye])
    X, Fv = _screen(values_fn(starts), starts, n_polish)
    P = X.shape[0]
    for _ in range(iters):
        pts = (X[None] + offs[:, None, :]).reshape(-1, dd)
        _, gv = vg_fn(pts)
        gv = gv.reshape(2 * dd + 1, P, dd)
        gp = _finite_or(gv[1:1 + dd], 0.0)
        gm = _finite_or(gv[1 + dd:], 0.0)
        H = ((gp - gm) / (2.0 * fd_h)).movedim(0, 1)
        H = 0.5 * (H + H.transpose(-1, -2))
        G = _finite_or(gv[0], 0.0)
        H = _finite_or(H, 0.0)
        sc = torch.clamp(torch.abs(torch.diagonal(H, dim1=-2,
                                                  dim2=-1)).amax(-1), min=1.0)
        Hd = H[:, None] + (lam[:, None, None] * sc[:, None, None, None]) * eye
        rhs = G[:, None, :, None].expand(Hd.shape[:-2] + (dd, 1))
        dstep = -torch.linalg.solve_ex(Hd, rhs).result[..., 0]
        gstep = -0.5 * G / torch.clamp(torch.linalg.vector_norm(
            G, dim=-1, keepdim=True), min=1e-12)
        cand = torch.cat([X[:, None, :] + dstep, (X + gstep)[:, None, :]],
                         dim=1)
        cand = torch.minimum(torch.maximum(cand, lb), ub)
        C = cand.shape[1]
        fc = _finite_or(values_fn(cand.reshape(P * C, dd)).reshape(P, C),
                        math.inf)
        j = torch.argmin(fc, dim=-1)
        fbest = fc.gather(1, j[:, None])[:, 0]
        xbest = cand[torch.arange(P, device=dev), j]
        better = fbest < Fv
        X = torch.where(better[:, None], xbest, X)
        Fv = torch.where(better, fbest, Fv)
    i = torch.argmin(_finite_or(Fv, math.inf))
    return X[i], Fv[i]


def screen_grid(lb, ub, device):
    cs = torch.linspace(float(lb[0]), float(ub[0]), 4)
    ls = torch.linspace(float(lb[1]), float(ub[1]), 4)
    nz = torch.clamp(torch.log(torch.tensor([1e-18, 1e-8, 1e-4, 1e-2, 1e-1,
                                             0.5])), float(lb[2]),
                     float(ub[2]))
    G = torch.stack(torch.meshgrid(cs, ls, nz, indexing="ij"), dim=-1)
    return G.reshape(-1, 3).to(device)


class Fit(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    mask: torch.Tensor
    noise_w: torch.Tensor
    X_m: torch.Tensor
    X_s: torch.Tensor
    y_m: torch.Tensor
    y_s: torch.Tensor
    starts: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor


def fit_inputs(p: Plan, x, y, mask, noise_w, restarts_u) -> Fit:
    """Standardised training buffers and the LML's starts and box."""
    dev = x.device
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    X_m, y_m = masked_mean(xf, mask), masked_mean(yf, mask)
    X_s, y_s = masked_std(xf, mask), masked_std(yf, mask)
    X_s = torch.where(X_s == 0.0, torch.ones_like(X_s), X_s)
    y_s = torch.where(y_s == 0.0, torch.ones_like(y_s), y_s)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    xs = torch.where(mask, (xf - X_m) / X_s, zero)
    ys = torch.where(mask, (yf - y_m) / y_s, zero)
    lb = torch.log(torch.tensor([0.01, 0.1, 1e-18], dtype=torch.float32))
    ub = torch.log(torch.tensor([1e3, 100.0, 1.0], dtype=torch.float32))
    theta0 = torch.minimum(torch.maximum(torch.log(torch.tensor(
        [5.0, 5.0, p.noise_y], dtype=torch.float32)), lb), ub)
    lb_d, ub_d = lb.to(dev), ub.to(dev)
    restarts = restarts_u.to(dev, torch.float32) * (ub_d - lb_d) + lb_d
    starts = torch.cat([theta0.to(dev)[None], restarts])
    return Fit(xs, ys, mask, noise_w, X_m, X_s, y_m, y_s, starts, lb_d, ub_d)


def optimize_lml(p: Plan, f: Fit, mm):
    """θ maximising the LML (driver.py:467-552): a screen of the 13 starts
    and a 96-point grid and a damped-Newton polish; above 160 training
    slots on a stride-subsampled set first, then polished at full size."""
    grid = screen_grid(f.lb.cpu(), f.ub.cpu(), f.xs.device)
    allstarts = torch.cat([f.starts, grid])

    def fns(xs, ys, mask, nw):
        def values(th):
            return -batched_lml(p, xs, ys, mask, th, nw, False, mm)

        def vg(th):
            v, g = batched_lml(p, xs, ys, mask, th, nw, True, mm)
            return -v, -g
        return values, vg

    values, vg = fns(f.xs, f.ys, f.mask, f.noise_w)
    n = f.xs.shape[-1]
    if n <= DIRECT_FIT_N:
        th, v = polish(values, vg, allstarts, f.lb, f.ub, 8, 4)
        return th, -v
    st = -(-n // 112)
    vs, vgs = fns(f.xs[::st], f.ys[::st], f.mask[::st], f.noise_w[::st])
    coarse, _ = polish(vs, vgs, allstarts, f.lb, f.ub, 8, 4)
    th, v = polish(values, vg, torch.stack([coarse, f.starts[0]]), f.lb,
                   f.ub, 2, 3)
    return th, -v


def predict(p: Plan, d: Data, f: Fit, theta, mm):
    """``(y_mean, y_std)`` on the x grid at θ (pixels; the std in
    standardised units, the reference's quirk)."""
    c, ls, noise = torch.exp(theta).unbind(-1)
    zero = torch.zeros((), dtype=torch.float32, device=theta.device)
    K = train_gram(p, f.xs, ls, c, noise * f.noise_w + GP_JITTER, f.mask)
    L = safe_cholesky(K, (0.0, 1e-5, 1e-3))
    alpha = torch.where(f.mask, torch.cholesky_solve(f.ys[:, None], L)[:, 0],
                        zero)
    xq = (d.x_grid.to(torch.float32) - f.X_m) / f.X_s
    Kq = torch.where(f.mask[None, :], cross_gram(p, xq, f.xs, ls, c), zero)
    mean = mm(Kq, alpha[:, None])[:, 0]
    V = torch.linalg.solve_triangular(L, Kq.T, upper=False)
    Vt = V.T[:, None, :]
    std = torch.sqrt(torch.clamp(c - mm(Vt, Vt.transpose(-1, -2))[:, 0, 0],
                                 min=0.0))
    return f.y_s * mean + f.y_m, std


# ------------------------------------------------------------- driver ----

# The first iteration's cheapest curves that a trace keeps, for the check.
FIRST_KEPT = 8


class Trace(NamedTuple):
    """One reference trace: the per-iteration record, the first
    iteration's ``FIRST_KEPT`` cheapest curves and costs, and the
    result."""
    n_iters: int
    first_curves: torch.Tensor  # (E, FIRST_KEPT)
    first_costs: torch.Tensor   # (FIRST_KEPT,)
    iter_curves: torch.Tensor   # (n_iters, E)
    iter_costs: torch.Tensor    # (n_iters,)
    iter_nobs: list
    iter_thresh: list
    obs_x: torch.Tensor
    obs_y: torch.Tensor
    obs_valid: torch.Tensor
    theta: torch.Tensor
    lml: float
    y_mean: torch.Tensor
    y_std: torch.Tensor
    edge_trace: torch.Tensor    # (E, 2) yx


class Reference:
    """The reference for one trace's inputs: ``grad_img`` (M, N) on the
    device where it runs, ``init_xy`` (2, 2) xy endpoints, ``tracer`` the
    configuration's tracer arguments."""

    def __init__(self, grad_img, init_xy, tracer: dict, tf32=False):
        self.tf32 = tf32
        self.p = make_plan(init_xy, tuple(grad_img.shape), tracer)
        self.d = make_data(self.p, grad_img, init_xy, self.mm)
        self.consts = select_consts(self.p, grad_img.device)

    def mm(self, a, b):
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    def draws(self, seed, it):
        key = threefry.prng_key(seed)
        kp, kn = threefry.split(threefry.fold_in(key, it + 1))
        dev = self.d.x_grid.device
        return (threefry.normal(kp, (self.d.F.shape[1], self.p.S), dev),
                threefry.normal(kn, (self.p.n_train, self.p.S), dev))

    def restarts(self, seed):
        return threefry.uniform(threefry.fold_in(threefry.prng_key(seed), 0),
                                (LML_RESTARTS, 3), self.d.x_grid.device)

    def iteration(self, state, z, w):
        """One outer iteration from ``state`` = (obs_x, obs_y, obs_valid,
        n_fobs, thresh): the new state, the optimal curve and its cost."""
        p, d = self.p, self.d
        ox, oy, ov, nf, th = state
        x, y, mask, nw = _train_set(p, d, ox, oy, ov)
        samples = sample_round(p, d, x, y, mask, nw, z, w, self.mm)
        costs = curve_costs(d.cols, samples)
        order = torch.sort(costs, stable=True)
        idx = order.indices[:p.N_keep]
        bc, bcosts = samples[:, idx], order.values[:p.N_keep]
        inv = 1.0 / bcosts
        kde = curve_kde(p, bc, inv / inv.sum(), self.mm)
        new = select(p, d, kde, ox, oy, ov, nf, th, self.consts)
        return new, bc, bcosts

    def final_fit(self, obs_x, obs_y, obs_valid, seed):
        p = self.p
        x, y, mask, nw = _train_set(p, self.d, obs_x, obs_y, obs_valid)
        return fit_inputs(p, x, y, mask, nw, self.restarts(seed))

    def run(self, seed) -> Trace:
        p, d = self.p, self.d
        dev = d.x_grid.device
        state = (torch.zeros(p.n_bins, dtype=torch.int64, device=dev),
                 torch.zeros(p.n_bins, dtype=torch.int64, device=dev),
                 torch.zeros(p.n_bins, dtype=torch.bool, device=dev), 0,
                 torch.tensor(p.score_thresh0, dtype=torch.float32,
                              device=dev))
        curves, costs, nobs, threshs, first = [], [], [], [], None
        it = 0
        while state[3] < p.algo_thresh and it < MAX_ITERS:
            z, w = self.draws(seed, it)
            state, bc, bcosts = self.iteration(state, z, w)
            curves.append(bc[:, 0])
            costs.append(bcosts[0])
            if first is None:
                first = (bc[:, :FIRST_KEPT], bcosts[:FIRST_KEPT])
            nobs.append(state[3])
            threshs.append(float(state[4]))
            it += 1
        f = self.final_fit(state[0], state[1], state[2], seed)
        theta, lml = optimize_lml(p, f, self.mm)
        y_mean, y_std = predict(p, d, f, theta, self.mm)
        edge = torch.stack([torch.round(y_mean).to(torch.int64), d.x_grid],
                           dim=-1)
        return Trace(it, *first, torch.stack(curves), torch.stack(costs),
                     nobs, threshs, state[0], state[1], state[2], theta,
                     float(lml), y_mean, y_std, edge)
