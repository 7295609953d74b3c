"""The recursive-Bayesian edge-trace driver (reference: gpet.py:768-908).

Port of ``gaussian_process_edge_trace_tpu/trace/driver.py`` (its
single-device path). The state lives in fixed-shape tensors on one device;
the outer loop runs on the host with the reference's condition
``n_fobs < algo_thresh and it < max_iters`` (driver.py:687-688), reading one
scalar from the device per iteration.

- :class:`TracerConfig` — static configuration with the reference's clamps
  (gpet.py:95-119).
- :class:`TracerData` — per-image tensors: the normalised gradient image,
  its KDE, the gradient columns along the x grid and the (N, r) truncated
  prior factor.
- :class:`TraceState` — the loop carry: per-bin observation buffers, the
  warm-start observations (first iteration only), the adaptive threshold
  and the telemetry buffers.
- :func:`run_trace` — the loop of :func:`_iteration`, then
  :func:`finish_trace`, the LML-optimised final fit.

Random numbers come from a draw source (:class:`TorchDraws` by default): the
normals of iteration ``it`` and the uniforms of the final fit's restarts. A
caller may pass another source with the same two methods, for instance one
that replays the JAX package's draws.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from gaussian_process_edge_trace_torch.models.gpr import (
    batched_lml, fit_and_sample, gp_fit, gp_predict, masked_mean, masked_std)
from gaussian_process_edge_trace_torch.models.kernels import (
    KernelSpec, k_unit_np, resolve_kernel_options)
from gaussian_process_edge_trace_torch.models.newton import (
    lml_screen_grid, screen_and_polish_batched)
from gaussian_process_edge_trace_torch.trace.kde import (
    blur_matrices, curve_kde, gradient_kde)
from gaussian_process_edge_trace_torch.trace.scoring import (
    best_curves, curve_costs)
from gaussian_process_edge_trace_torch.trace.select import (
    BinSpec, make_bin_spec, select_consts, select_pixels)
from gaussian_process_edge_trace_torch.utils.image import normalise

# Relative eigenvalue threshold of the truncated prior factor.
_PRIOR_RANK_RTOL = 1e-8

# Largest training set the batched LML fit screens at full size; above it
# the fit goes coarse-to-fine (driver.py:518-552).
_DIRECT_FIT_N = 160


class TracerConfig(NamedTuple):
    """Static trace configuration (hashable Python scalars)."""
    M: int
    N: int
    x_st: int
    x_en: int
    edge_length: int
    kernel: KernelSpec
    sigma_f: float
    sigma_l: float
    noise_y: float
    N_samples: int
    N_keep: int
    delta_x: int
    N_subints: int
    pixel_thresh: int
    algo_thresh: int
    score_thresh0: float
    kde_thresh: float
    fix_endpoints: bool
    n_inits: int
    n_user_obs: int
    bins: BinSpec
    n_train: int          # padded training capacity (multiple of 8)
    seed: int
    max_iters: int
    max_decays: int
    lml_restarts: int
    init_noise_weight: float  # 1e-7 if fix_endpoints else 0.5 (gpet.py:161)
    gp_jitter: float          # GPR alpha (gpet.py:155)
    # True reproduces the reference fork's posterior-rescale quirk and its
    # standardised-units credible interval; False gives the consistent
    # posterior (driver.py:105-110).
    reference_quirks: bool = True
    # True uses the historical scipy `simps` even='avg' rule.
    legacy_simpson: bool = False


class TracerData(NamedTuple):
    """Per-(config, image) tensors, computed once."""
    grad_img: torch.Tensor      # (M, N) normalised gradient image
    grad_kde: torch.Tensor      # (M, N) gradient KDE (gpet.py:127)
    grad_cols: torch.Tensor     # (E, M) grad_img.T sliced to the x grid
    L_prior_unit: torch.Tensor  # (N, r) truncated unit prior factor
    x_grid: torch.Tensor        # (E,) int64 output columns
    init_x: torch.Tensor        # (n_inits,) int64
    init_y: torch.Tensor        # (n_inits,) int64


class TraceState(NamedTuple):
    obs_x: torch.Tensor        # (B,) int64 per-bin observation buffer
    obs_y: torch.Tensor        # (B,) int64
    obs_valid: torch.Tensor    # (B,) bool
    user_x: torch.Tensor       # (U,) int64 warm-start observations
    user_y: torch.Tensor       # (U,) int64
    user_valid: torch.Tensor   # (U,) bool — cleared after the 1st iteration
    score_thresh: torch.Tensor  # scalar float32, adaptive threshold
    n_fobs: torch.Tensor       # scalar int64
    it: int                    # host-side iteration count
    iter_curves: torch.Tensor  # (max_iters, E) optimal curve per iteration
    iter_costs: torch.Tensor   # (max_iters,)
    iter_nobs: torch.Tensor    # (max_iters,) int64
    iter_thresh: torch.Tensor  # (max_iters,)


class TraceResult(NamedTuple):
    edge_trace: torch.Tensor        # (E, 2) int64, yx-space (gpet.py:886)
    y_mean: torch.Tensor            # (E,) posterior mean, pixel units
    y_std: torch.Tensor             # (E,) predictive std (see finish_trace)
    cred_interval: torch.Tensor     # (2, E) mean ∓ 1.96·y_std
    cred_interval_px: torch.Tensor  # (2, E) pixel-unit interval
    n_iters: int
    converged: bool                 # False = max_iters hit
    theta: torch.Tensor             # (3,) optimised (log c, log ℓ, log σn²)
    lml: torch.Tensor               # optimised log marginal likelihood
    final_cost: torch.Tensor        # cost of the final mean curve
    iter_curves: torch.Tensor
    iter_costs: torch.Tensor
    iter_nobs: torch.Tensor
    iter_thresh: torch.Tensor
    obs_x: torch.Tensor             # (U+B,) the final observation set
    obs_y: torch.Tensor
    obs_valid: torch.Tensor


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def make_config(init, grad_img_shape, kernel_options=(1, 3, 3), noise_y=1,
                n_user_obs=0, N_samples=500, score_thresh=1, delta_x=20,
                keep_ratio=0.1, pixel_thresh=5, seed=42, fix_endpoints=True,
                max_iters=48, max_decays=400, lml_restarts=12,
                reference_quirks=True, legacy_simpson=False) -> TracerConfig:
    """A :class:`TracerConfig` with the reference's clamps (gpet.py:95-119).
    ``init`` is the (n, 2) xy-space endpoint array."""
    init = np.asarray(init)
    init_sorted = init[np.argsort(init[:, 0])].astype(int)
    x_st, x_en = int(init_sorted[0, 0]), int(init_sorted[-1, 0])
    M, N = grad_img_shape

    n_samples_c = int(N_samples) if N_samples > 100 else 1000  # gpet.py:99
    pixel_thresh_c = int(pixel_thresh) if pixel_thresh >= 2 else 2
    score_thresh_c = float(score_thresh) if 0 < score_thresh <= 1 else 1.0
    delta_x_c = int(delta_x) if delta_x > 3 else 2             # gpet.py:105

    edge_length = x_en - x_st + 1
    N_subints = int(edge_length // delta_x_c)
    # N_keep uses the raw arguments, not the clamped ones (gpet.py:118).
    N_keep = int(keep_ratio * N_samples)
    algo_thresh = N_subints - (pixel_thresh_c - 1)             # gpet.py:119

    spec, sigma_f, sigma_l = resolve_kernel_options(kernel_options, M,
                                                    edge_length)
    bins = make_bin_spec(N, x_st, x_en, delta_x_c)
    n_inits = init_sorted.shape[0]
    n_train = _round_up(n_inits + int(n_user_obs) + bins.n_bins, 8)

    return TracerConfig(
        M=M, N=N, x_st=x_st, x_en=x_en, edge_length=edge_length,
        kernel=spec, sigma_f=sigma_f, sigma_l=sigma_l,
        noise_y=float(noise_y), N_samples=n_samples_c, N_keep=N_keep,
        delta_x=delta_x_c, N_subints=N_subints, pixel_thresh=pixel_thresh_c,
        algo_thresh=algo_thresh, score_thresh0=score_thresh_c,
        kde_thresh=1e-3, fix_endpoints=bool(fix_endpoints), n_inits=n_inits,
        n_user_obs=int(n_user_obs), bins=bins, n_train=n_train,
        seed=int(seed), max_iters=int(max_iters), max_decays=int(max_decays),
        lml_restarts=int(lml_restarts),
        init_noise_weight=[0.5, 1e-7][int(bool(fix_endpoints))],
        gp_jitter=1e-6, reference_quirks=bool(reference_quirks),
        legacy_simpson=bool(legacy_simpson))


def frame_arrays(cfg: TracerConfig, grad_img, init_xy, device):
    """Per-frame tensors (gpet.py:97,127): normalised gradient image, its
    KDE, the (E, M) gradient columns along the x grid and the init points
    sorted by x."""
    g = normalise(grad_img, (0, 1), device=device)
    gkde = gradient_kde(g, kde_thresh=cfg.kde_thresh)
    gcols = g.T[cfg.x_st:cfg.x_st + cfg.edge_length].contiguous()
    init_xy = torch.as_tensor(np.array(init_xy), dtype=torch.int64,
                              device=device)
    init_xy = init_xy[torch.argsort(init_xy[:, 0], stable=True)]
    return g, gkde, gcols, init_xy[:, 0].contiguous(), \
        init_xy[:, 1].contiguous()


@functools.lru_cache(maxsize=16)
def _prior_factor_np(N: int, kernel: KernelSpec, sigma_l: float,
                     gp_jitter: float, full_rank: bool) -> np.ndarray:
    cols = np.arange(N, dtype=np.float64)
    K = k_unit_np(kernel, np.abs(cols[:, None] - cols[None, :]) / sigma_l)
    K[np.diag_indices_from(K)] += gp_jitter
    w, V = np.linalg.eigh(K)                   # ascending
    w = np.clip(w, 0.0, None)
    if not full_rank:
        thr = max(2.0 * gp_jitter, w[-1] * _PRIOR_RANK_RTOL)
        r = int(np.sum(w > thr))
        r = min(N, ((r + 7) // 8) * 8)
        w, V = w[N - r:], V[:, N - r:]
    F = (V * np.sqrt(w)[None, :]).astype(np.float32)
    F.setflags(write=False)
    return F


def prior_factor(cfg: TracerConfig) -> np.ndarray:
    """The (N, r) unit prior factor over all image columns (driver.py:237).

    A host float64 eigendecomposition of the unit Gram plus ``gp_jitter``,
    truncated to the eigenpairs above ``max(2·gp_jitter, w_max·1e-8)``, the
    rank rounded up to a multiple of 8. The dropped variance per column is at
    most that threshold. ``GPET_FULL_RANK_PRIOR=1`` keeps the full factor;
    the flag is part of the cache key, so changing it takes effect at once.
    Cached per (N, kernel, ℓ, jitter, flag); a read-only float32 array."""
    full = bool(os.environ.get("GPET_FULL_RANK_PRIOR"))
    return _prior_factor_np(cfg.N, cfg.kernel, cfg.sigma_l, cfg.gp_jitter,
                            full)


def make_data(cfg: TracerConfig, grad_img, init_xy, device) -> TracerData:
    """Precompute the per-image tensors (gpet.py:97,122-127) on ``device``."""
    g, gkde, gcols, ix, iy = frame_arrays(cfg, grad_img, init_xy, device)
    return TracerData(
        grad_img=g, grad_kde=gkde, grad_cols=gcols,
        L_prior_unit=torch.tensor(prior_factor(cfg), device=device),
        x_grid=cfg.x_st + torch.arange(cfg.edge_length, device=device),
        init_x=ix, init_y=iy)


def init_state(cfg: TracerConfig, device, user_obs_xy=None) -> TraceState:
    """Initial loop state; ``user_obs_xy`` is the (U, 2) xy warm-start
    observation array (gpet.py:57-61,820)."""
    B = cfg.bins.n_bins
    U = cfg.n_user_obs
    if user_obs_xy is None:
        user_obs_xy = np.zeros((0, 2), np.int64)
    user = torch.as_tensor(np.array(user_obs_xy).reshape(-1, 2),
                           dtype=torch.int64, device=device)
    if user.shape[0] != U:
        raise ValueError(f"{user.shape[0]} warm-start observations for a "
                         f"config built with n_user_obs={U}")
    E, mi = cfg.edge_length, cfg.max_iters
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TraceState(
        obs_x=torch.zeros(B, **i64), obs_y=torch.zeros(B, **i64),
        obs_valid=torch.zeros(B, dtype=torch.bool, device=device),
        user_x=user[:, 0].contiguous(), user_y=user[:, 1].contiguous(),
        user_valid=torch.ones(U, dtype=torch.bool, device=device),
        score_thresh=torch.tensor(cfg.score_thresh0, **f32),
        n_fobs=torch.tensor(U, **i64), it=0,
        iter_curves=torch.zeros((mi, E), **f32),
        iter_costs=torch.zeros(mi, **f32),
        iter_nobs=torch.zeros(mi, **i64),
        iter_thresh=torch.zeros(mi, **f32))


def _train_set(cfg: TracerConfig, data: TracerData, state: TraceState):
    """Padded training buffers: init + user obs + binned obs
    (gpet.py:209-214; unsorted, the GP is permutation-invariant)."""
    dev = data.x_grid.device
    pad = cfg.n_train - cfg.n_inits - cfg.n_user_obs - cfg.bins.n_bins
    zeros = torch.zeros(pad, dtype=torch.int64, device=dev)
    x = torch.cat([data.init_x, state.user_x, state.obs_x, zeros])
    y = torch.cat([data.init_y, state.user_y, state.obs_y, zeros])
    mask = torch.cat([torch.ones(cfg.n_inits, dtype=torch.bool, device=dev),
                      state.user_valid, state.obs_valid,
                      torch.zeros(pad, dtype=torch.bool, device=dev)])
    # Endpoint noise weight 1e-7/0.5, observation weight 1 (gpet.py:161,209).
    noise_w = torch.cat([
        torch.full((cfg.n_inits,), cfg.init_noise_weight,
                   dtype=torch.float32, device=dev),
        torch.ones(cfg.n_train - cfg.n_inits, dtype=torch.float32,
                   device=dev)])
    return x, y, mask, noise_w


class TorchDraws:
    """The default draw source: ``torch.Generator``s on ``device``.
    Iteration ``it`` draws from seed ``seed + it + 1`` (the reference's
    ``fold_in(key, it+1)``, gpet.py:839); the final fit's restarts from
    ``seed``."""

    def __init__(self, cfg: TracerConfig, rank: int, device):
        self.cfg, self.rank = cfg, rank
        self.device = torch.device(device)

    def _gen(self, seed):
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def normals(self, it: int):
        """(z (r, S), w (n_train, S)) standard normals of iteration ``it``."""
        g = self._gen(self.cfg.seed + it + 1)
        S = self.cfg.N_samples
        z = torch.randn((self.rank, S), generator=g, device=self.device)
        w = torch.randn((self.cfg.n_train, S), generator=g,
                        device=self.device)
        return z, w

    def restarts(self):
        """(lml_restarts, 3) uniforms in [0, 1) for the final fit."""
        return torch.rand((self.cfg.lml_restarts, 3),
                          generator=self._gen(self.cfg.seed),
                          device=self.device)


def _default_draws(cfg: TracerConfig, data: TracerData) -> TorchDraws:
    return TorchDraws(cfg, data.L_prior_unit.shape[1], data.grad_img.device)


def _sample_round(cfg: TracerConfig, data: TracerData, x, y, mask, noise_w,
                  z, w):
    """One sampling-mode GP round (gpet.py:227-230,255-261): scale y by
    std+1, set the variance to σf²/y_s², draw Matheron curves, rescale."""
    yf = y.to(torch.float32)
    std_raw = masked_std(yf, mask)
    y_s = std_raw + 1.0
    variance = (cfg.sigma_f ** 2) / (y_s ** 2)
    diag_noise = cfg.noise_y * noise_w + cfg.gp_jitter
    # Reference-fork quirk (sklearn_gpr.py:227 vs :385,401): the centred
    # posterior is scaled by std_raw/(std_raw+1); a zero std maps to 1.
    if cfg.reference_quirks:
        s2 = std_raw / y_s
        post_scale = torch.where(s2 == 0.0, torch.ones_like(s2), s2)
    else:
        post_scale = 1.0
    samples = fit_and_sample(
        cfg.kernel, x.to(torch.float32), yf / y_s, cfg.sigma_l, variance,
        diag_noise, mask, data.L_prior_unit, x_idx=x, grid_out=data.x_grid,
        z=z, w=w, centre=True, post_scale=post_scale)
    return samples * y_s                                    # (E, S)


def _iteration(cfg: TracerConfig, data: TracerData, state: TraceState, z, w,
               blur=None, consts=None):
    """One outer-loop iteration (gpet.py:829-861): sample, score, rank,
    KDE, select. Returns the new state and the (E, S) samples."""
    x, y, mask, noise_w = _train_set(cfg, data, state)
    samples = _sample_round(cfg, data, x, y, mask, noise_w, z, w)
    costs = curve_costs(data.grad_cols, samples, kde_thresh=cfg.kde_thresh,
                        even="avg" if cfg.legacy_simpson else "simpson")
    bc, bcosts = best_curves(samples, costs, cfg.N_keep)
    inv = 1.0 / bcosts
    weights = inv / inv.sum()                               # gpet.py:492-493
    kde_arr = curve_kde(bc, weights, cfg.M, cfg.N, cfg.x_st, blur=blur)

    sel = select_pixels(
        kde_arr, data.grad_kde,
        torch.cat([state.user_x, state.obs_x]),
        torch.cat([state.user_y, state.obs_y]),
        torch.cat([state.user_valid, state.obs_valid]),
        n_pre=state.n_fobs, score_thresh=state.score_thresh, spec=cfg.bins,
        fix_endpoints=cfg.fix_endpoints, kde_thresh=cfg.kde_thresh,
        pixel_thresh=cfg.pixel_thresh, algo_thresh=cfg.algo_thresh,
        max_decays=cfg.max_decays, consts=consts)

    i = state.it

    def put(buf, v):
        buf = buf.clone()
        buf[i] = v
        return buf

    new_state = TraceState(
        obs_x=sel.obs_x, obs_y=sel.obs_y, obs_valid=sel.obs_valid,
        user_x=state.user_x, user_y=state.user_y,
        user_valid=torch.zeros_like(state.user_valid),  # first iteration only
        score_thresh=sel.score_thresh, n_fobs=sel.n_fobs, it=i + 1,
        iter_curves=put(state.iter_curves, bc[:, 0]),
        iter_costs=put(state.iter_costs, bcosts[0]),
        iter_nobs=put(state.iter_nobs, sel.n_fobs),
        iter_thresh=put(state.iter_thresh, sel.score_thresh))
    return new_state, samples


def optimize_lml(kernel: KernelSpec, xs, ys, mask, noise_w, starts, lb, ub,
                 jitter=1e-6, n_polish=8, polish_iters=4):
    """Maximise the LML over θ = (log c, log ℓ, log σn²) within [lb, ub]
    (driver.py:467-552, its batched path): one batched screen of the starts
    and a static grid, then a short damped-Newton polish, every objective
    batch through :func:`batched_lml` (K5 + K6). Above ``_DIRECT_FIT_N``
    training points it screens and polishes on a stride-subsampled set,
    then re-polishes the coarse optimum at full size. ``lb``/``ub`` are host
    tensors. Returns ``(theta, lml)``."""
    dev = starts.device
    allstarts = torch.cat([starts, lml_screen_grid(lb, ub, dev)])
    lb_d, ub_d = lb.to(dev), ub.to(dev)

    def fns(xs_, ys_, mask_, nw_):
        def values_fn(th):
            return -batched_lml(kernel, xs_, ys_, mask_, th, nw_,
                                jitter=jitter)

        def vg_fn(th):
            v, g = batched_lml(kernel, xs_, ys_, mask_, th, nw_,
                               jitter=jitter, with_grad=True)
            return -v, -g
        return values_fn, vg_fn

    values_fn, vg_fn = fns(xs, ys, mask, noise_w)
    if xs.shape[0] <= _DIRECT_FIT_N:
        res = screen_and_polish_batched(values_fn, vg_fn, allstarts, lb_d,
                                        ub_d, n_polish=n_polish,
                                        iters=polish_iters)
        return res.x, -res.f
    stride = -(-xs.shape[0] // 112)
    vs_sub, vg_sub = fns(xs[::stride], ys[::stride], mask[::stride],
                         noise_w[::stride])
    coarse = screen_and_polish_batched(vs_sub, vg_sub, allstarts, lb_d, ub_d,
                                       n_polish=n_polish, iters=polish_iters)
    fine_starts = torch.stack([coarse.x, starts[0]])
    res = screen_and_polish_batched(values_fn, vg_fn, fine_starts, lb_d, ub_d,
                                    n_polish=2,
                                    iters=max(polish_iters - 1, 2))
    return res.x, -res.f


def _final_fit_buffers(cfg: TracerConfig, data: TracerData, restarts_u, x,
                       y, mask, noise_w):
    """The converged fit on padded training buffers (gpet.py:233-266):
    standardise, maximise the LML from ``1 + lml_restarts`` starts, predict
    on the x grid. ``restarts_u`` are (lml_restarts, 3) uniforms in [0, 1).
    Returns ``(y_mean, std, y_s, theta, lml)``; ``std`` is in standardised
    units."""
    dev = x.device
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    X_m, X_s = masked_mean(xf, mask), masked_std(xf, mask)
    y_m, y_s = masked_mean(yf, mask), masked_std(yf, mask)
    # Zero-std guard for degenerate training sets (driver.py:575-581).
    X_s = torch.where(X_s == 0.0, torch.ones_like(X_s), X_s)
    y_s = torch.where(y_s == 0.0, torch.ones_like(y_s), y_s)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    xs = torch.where(mask, (xf - X_m) / X_s, zero)
    ys = torch.where(mask, (yf - y_m) / y_s, zero)

    # θ = (log c, log ℓ, log σn²); bounds gpet.py:246-248.
    lb = torch.log(torch.tensor([0.01, 0.1, 1e-18], dtype=torch.float32))
    ub = torch.log(torch.tensor([1e3, 100.0, 1.0], dtype=torch.float32))
    theta0 = torch.minimum(torch.maximum(torch.log(torch.tensor(
        [5.0, 5.0, cfg.noise_y], dtype=torch.float32)), lb), ub)
    lb_d, ub_d = lb.to(dev), ub.to(dev)
    restarts = restarts_u.to(dev, torch.float32) * (ub_d - lb_d) + lb_d
    starts = torch.cat([theta0.to(dev)[None], restarts], dim=0)

    theta, lml = optimize_lml(cfg.kernel, xs, ys, mask, noise_w, starts, lb,
                              ub, jitter=cfg.gp_jitter)

    c, ls, noise = torch.exp(theta).unbind()
    gp = gp_fit(cfg.kernel, xs, ys, ls, c, noise * noise_w + cfg.gp_jitter,
                mask, centre=False)
    xq = (data.x_grid.to(torch.float32) - X_m) / X_s
    mean_std, std = gp_predict(cfg.kernel, gp, xq, ls, c, return_std=True)
    y_mean = y_s * mean_std + y_m                            # gpet.py:266
    return y_mean, std, y_s, theta, lml


def finish_trace(cfg: TracerConfig, data: TracerData, state: TraceState,
                 draws) -> TraceResult:
    """Post-loop finalisation (gpet.py:874-890): the converged LML fit, the
    credible interval, the yx trace and the final mean curve's cost."""
    x, y, mask, noise_w = _train_set(cfg, data, state)
    y_mean, y_std_s, y_s, theta, lml = _final_fit_buffers(
        cfg, data, draws.restarts(), x, y, mask, noise_w)
    # Reference quirk: the interval and y_std keep the standardised-y std
    # (gpet.py:266); with reference_quirks=False both are in pixels.
    y_std_px = y_s * y_std_s
    y_std = y_std_s if cfg.reference_quirks else y_std_px
    cred = torch.stack([y_mean - 1.96 * y_std, y_mean + 1.96 * y_std])
    cred_px = torch.stack([y_mean - 1.96 * y_std_px,
                           y_mean + 1.96 * y_std_px])
    edge_trace = torch.stack([torch.round(y_mean).to(torch.int64),
                              data.x_grid], dim=1)
    final_cost = curve_costs(data.grad_cols, y_mean[:, None],
                             kde_thresh=cfg.kde_thresh,
                             even="avg" if cfg.legacy_simpson
                             else "simpson")[0]
    return TraceResult(
        edge_trace=edge_trace, y_mean=y_mean, y_std=y_std,
        cred_interval=cred, cred_interval_px=cred_px, n_iters=state.it,
        converged=bool(state.n_fobs.item() >= cfg.algo_thresh),
        theta=theta, lml=lml, final_cost=final_cost,
        iter_curves=state.iter_curves, iter_costs=state.iter_costs,
        iter_nobs=state.iter_nobs, iter_thresh=state.iter_thresh,
        obs_x=torch.cat([state.user_x, state.obs_x]),
        obs_y=torch.cat([state.user_y, state.obs_y]),
        obs_valid=torch.cat([state.user_valid, state.obs_valid]))


def run_loop(cfg: TracerConfig, data: TracerData, state0: TraceState,
             draws=None) -> TraceState:
    """The outer loop alone: iterate while ``n_fobs < algo_thresh`` and
    ``it < max_iters`` (driver.py:687-688), one device read per
    iteration."""
    if draws is None:
        draws = _default_draws(cfg, data)
    blur = blur_matrices(cfg.M, cfg.N, data.grad_kde.dtype,
                         data.grad_kde.device)
    consts = select_consts(cfg.bins, cfg.N, cfg.max_decays,
                           data.grad_kde.device)
    state = state0
    while state.it < cfg.max_iters and state.n_fobs.item() < cfg.algo_thresh:
        z, w = draws.normals(state.it)
        state, _ = _iteration(cfg, data, state, z, w, blur=blur,
                              consts=consts)
    return state


def run_trace(cfg: TracerConfig, data: TracerData, state0: TraceState,
              draws=None) -> TraceResult:
    """The full trace (gpet.py:768-908): the outer loop, then
    :func:`finish_trace`. ``draws`` defaults to :class:`TorchDraws`."""
    if draws is None:
        draws = _default_draws(cfg, data)
    state = run_loop(cfg, data, state0, draws)
    return finish_trace(cfg, data, state, draws)
