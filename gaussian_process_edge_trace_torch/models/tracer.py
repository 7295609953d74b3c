"""``GP_Edge_Tracing`` — the reference-compatible user API.

Port of ``gaussian_process_edge_trace_tpu/models/tracer.py``: the
reference class's positional constructor signature, defaults and clamps
(gpet.py:22-35) and its ``__call__`` (gpet.py:768-908), with two paths:

- **fused** (the default): :func:`..trace.driver.run_trace` on one device,
  or with ``ensemble=K`` :func:`..parallel.sharded.trace_ensemble`;
- **introspective** (``return_lines`` or ``verbose``): the loop stepped one
  :func:`..trace.driver.trace_step` at a time on the same draws, so every
  iteration's curves and observations can be handed back. The numerics are
  the fused path's, bit for bit; each iteration adds one read of the state
  and one of its (E, S) curves by the host.

The reference's pipeline stages are methods of the tracer
(gpet.py:182-662), thin wrappers of the functional core with the
reference's signatures and return shapes. Arrays come back as numpy. The
plotting options and methods (``show_init_post``, ``show_post_iter``,
``print_final_diagnostics``, :meth:`plot_iter`, :meth:`plot_diagnostics`)
draw with ``utils/plotting.py`` on the host and need matplotlib.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gaussian_process_edge_trace_torch.ops.diff import finite_diff
from gaussian_process_edge_trace_torch.ops.integrate import (
    simpson_nonuniform)
from gaussian_process_edge_trace_torch.ops.interp import bilinear_interp
from gaussian_process_edge_trace_torch.parallel.sharded import (
    trace_ensemble)
from gaussian_process_edge_trace_torch.trace.checkpoint import (
    obs_from_result)
from gaussian_process_edge_trace_torch.trace.driver import (
    _default_draws, _round_up, final_fit_buffers, finish_trace, init_state,
    loop_invariants, make_config, make_data, preview_samples, run_trace,
    sample_round_buffers, to_host, trace_step)
from gaussian_process_edge_trace_torch.trace.kde import (
    curve_kde, gradient_kde)
from gaussian_process_edge_trace_torch.trace.scoring import (
    best_curves, curve_costs)
from gaussian_process_edge_trace_torch.trace.select import select_pixels
from gaussian_process_edge_trace_torch.utils.profiling import span


def _numpy(t):
    return t.detach().cpu().numpy()


class GP_Edge_Tracing:
    """Trace one edge in one gradient image by GP regression.

    Positional signature as gpet.py:22-35: ``(init, grad_img,
    kernel_options, noise_y, obs, N_samples, score_thresh, delta_x,
    keep_ratio, pixel_thresh, seed, return_std, fix_endpoints)``. Keyword-only
    extras: ``max_iters``, ``reference_quirks``, ``legacy_simpson``,
    ``device`` (where the trace runs; ``"cuda"`` by default) and ``draws``
    (a draw source for the trace, :class:`StreamDraws` by default). The
    constructor runs in the span ``gpet.construct``.
    """

    def __init__(self, init, grad_img, kernel_options=(1, 3, 3), noise_y=1,
                 obs=np.array([], dtype=np.int8), N_samples=500,
                 score_thresh=1, delta_x=20, keep_ratio=0.1, pixel_thresh=5,
                 seed=42, return_std=False, fix_endpoints=True, *,
                 max_iters=48, reference_quirks=True, legacy_simpson=False,
                 device="cuda", draws=None):
        with span("gpet.construct"):
            init = np.asarray(init)
            # gpet.py:95
            self.init = init[np.argsort(init[:, 0])].astype(int)
            self.obs = np.asarray(obs).reshape(-1, 2).astype(np.int64)
            self.return_std = bool(return_std)
            self.device = device
            self.draws = draws
            if not isinstance(grad_img, torch.Tensor):
                grad_img = np.asarray(grad_img)
            self.cfg = make_config(
                self.init, tuple(grad_img.shape),
                kernel_options=kernel_options, noise_y=noise_y,
                n_user_obs=self.obs.shape[0], N_samples=N_samples,
                score_thresh=score_thresh, delta_x=delta_x,
                keep_ratio=keep_ratio, pixel_thresh=pixel_thresh, seed=seed,
                fix_endpoints=fix_endpoints, max_iters=max_iters,
                reference_quirks=reference_quirks,
                legacy_simpson=legacy_simpson)
            self.data = make_data(self.cfg, grad_img, self.init, device)
            # The reference's public attributes (gpet.py:95-119,161-162).
            cfg = self.cfg
            self.x_st, self.x_en = cfg.x_st, cfg.x_en
            self.M, self.N = cfg.M, cfg.N
            self.edge_length = cfg.edge_length
            self.N_samples = cfg.N_samples
            self.N_subints = cfg.N_subints
            self.N_keep = cfg.N_keep
            self.algo_thresh = cfg.algo_thresh
            self.delta_x = cfg.delta_x
            self.keep_ratio = (float(keep_ratio) if 0 < keep_ratio <= 1
                               else 0.1)
            self.pixel_thresh = cfg.pixel_thresh
            self.score_thresh = cfg.score_thresh0
            self.kde_thresh = cfg.kde_thresh
            self.seed = cfg.seed
            self.fix_endpoints = cfg.fix_endpoints
            self.noise_y = cfg.noise_y
            self.sigma_f, self.sigma_l = cfg.sigma_f, cfg.sigma_l
            self.x_grid = to_host(self.data.x_grid, "data").numpy()
            self.alpha_init = np.full((self.init.shape[0],),
                                      cfg.init_noise_weight)
            self._host = {}

    def _cached(self, name, make):
        if name not in self._host:
            self._host[name] = make()
        return self._host[name]

    @property
    def X(self):
        """The (edge_length, N_samples) tiled x grid (gpet.py:115), for the
        reference's API only; built on first access (O(E·S) host memory)."""
        return self._cached("X", lambda: np.tile(self.x_grid[:, None],
                                                 (1, self.N_samples)))

    @property
    def grad_img(self):
        """The normalised (M, N) gradient image, a numpy copy made on first
        access."""
        return self._cached("grad_img", lambda: _numpy(self.data.grad_img))

    @property
    def grad_kde(self):
        """The (M, N) gradient KDE (gpet.py:127), a numpy copy made on first
        access."""
        return self._cached("grad_kde", lambda: _numpy(self.data.grad_kde))

    # -- the reference's stages as methods (gpet.py:182-662) --------------

    def _tensor(self, a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.array(a), dtype=dtype, device=self.device)

    def _buffers_for_obs(self, obs):
        """Padded training buffers for the inits and an (n, 2) xy
        observation array (gpet.py:209-214; unsorted, the GP is
        permutation-invariant): ``(x, y, mask, noise_w)`` on the device,
        ``max(8, round_up(n, 8))`` slots."""
        obs = np.asarray(obs).reshape(-1, 2)
        n_init = self.init.shape[0]
        n = n_init + obs.shape[0]
        cap = max(8, _round_up(n, 8))
        x = np.zeros((cap,), np.int64)
        y = np.zeros((cap,), np.int64)
        mask = np.zeros((cap,), bool)
        noise_w = np.ones((cap,), np.float32)
        x[:n_init] = self.init[:, 0]
        y[:n_init] = self.init[:, 1]
        x[n_init:n] = obs[:, 0]
        y[n_init:n] = obs[:, 1]
        mask[:n] = True
        noise_w[:n_init] = self.cfg.init_noise_weight       # gpet.py:161-162
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (x, y, mask, noise_w))

    def fit_predict_GP(self, obs, converged=False, seed=0, draws=None):
        """Fit the GP on the inits and ``obs`` (gpet.py:182-268).

        ``converged=False``: ``N_samples`` posterior curves, (edge_length,
        N_samples) (gpet.py:259-261). ``converged=True``: the LML-optimised
        fit, ``(y_mean, y_std)`` with the std in standardised units
        (gpet.py:263-266). The draws are the reference's ``PRNGKey(seed)``
        stream, :class:`~..trace.driver.KeyDraws` of ``seed``, unless
        ``draws`` (a source with ``sample_normals(n)`` and ``restarts()``)
        is given."""
        bufs = self._buffers_for_obs(obs)
        if not converged:
            return _numpy(sample_round_buffers(self.cfg, self.data, *bufs,
                                               draws=draws, seed=seed))
        y_mean, y_std = final_fit_buffers(self.cfg, self.data, *bufs,
                                          draws=draws, seed=seed)
        return _numpy(y_mean), _numpy(y_std)

    def grad_interp(self, rows, cols, grid=False):
        """Bilinear lookup of the gradient image in float64, the reference's
        ``RectBivariateSpline(kx=1, ky=1)`` attribute (gpet.py:122-125),
        called as ``grad_interp(edge[:, 1], edge[:, 0], grid=False)``."""
        rows = self._tensor(rows, torch.float64)
        cols = self._tensor(cols, torch.float64)
        if grid:
            rows, cols = rows[:, None], cols[None, :]
        return _numpy(bilinear_interp(self.data.grad_img.to(torch.float64),
                                      rows, cols))

    def finite_diff(self, vec, typ=0, h=1):
        """Forward, backward or central differences (gpet.py:336-367)."""
        return _numpy(finite_diff(self._tensor(vec, None), typ=typ, h=h))

    def cost_funct(self, edge):
        """Cost of one xy-space edge, arc length over line integral
        (gpet.py:371-410), in float64 on the device. Any (n, 2) edge, not
        only curves on the x grid."""
        edge = np.asarray(edge, np.float64)
        edge = self._tensor(edge[edge[:, 0].argsort(), :],   # gpet.py:391
                            torch.float64)
        grad_score = bilinear_interp(self.data.grad_img.to(torch.float64),
                                     edge[:, 1], edge[:, 0]) + self.kde_thresh
        pixel_diff = torch.cumsum(torch.sqrt(
            (torch.diff(edge, dim=0) ** 2).sum(1)), 0)       # gpet.py:397
        deriv = finite_diff(edge[:, 1], typ=0, h=1)
        integrand = torch.sqrt(1.0 + deriv ** 2)             # gpet.py:400-401
        line_integral = simpson_nonuniform(grad_score[:-1], pixel_diff)
        arc_length = simpson_nonuniform(integrand, edge[:-1, 0])
        return float(arc_length / line_integral)             # gpet.py:408

    def get_best_curves(self, y_samples):
        """Rank the (edge_length, N_samples) curves by cost
        (gpet.py:414-451): ``(best_curves (E, N_keep, 2), best_costs
        (N_keep,), (optimal_curve (E, 2), optimal_cost))``, the curves
        stacked as xy pairs like the reference's ``np.stack((self.X,
        y_samples), axis=-1)``."""
        y = self._tensor(y_samples, torch.float32)
        costs = curve_costs(self.data.grad_cols, y,
                            kde_thresh=self.kde_thresh)
        bc, bcosts = best_curves(y, costs, self.N_keep)
        bcosts = _numpy(bcosts)
        X = np.tile(self.x_grid[:, None], (1, self.N_keep))
        curves = np.stack([X, _numpy(bc)], axis=-1)          # (E, K, 2)
        return curves, bcosts, (curves[:, 0, :], float(bcosts[0]))

    def _kde(self, best_curves=None, costs=None, bw=1):
        if costs is None or best_curves is None:             # gpet.py:503-509
            return gradient_kde(self.data.grad_img,
                                kde_thresh=self.kde_thresh, bw=bw)
        y = self._tensor(np.asarray(best_curves)[:, :, 1], torch.float32)
        inv = 1.0 / self._tensor(costs, torch.float32)
        weights = inv / inv.sum(-1, keepdim=True)            # gpet.py:492-493
        return curve_kde(y, weights, self.M, self.N, self.x_st, bw=bw)

    def kernel_density_estimate(self, best_curves=None, costs=None, bw=1):
        """The (M, N) min-max normalised KDE (gpet.py:455-529): of the
        (E, K, 2) xy curves weighted by normalised inverse cost when
        ``costs`` is given, else of the gradient image."""
        return _numpy(self._kde(best_curves, costs, bw))

    def _select(self, kde_arr, pre_fobs, cand_mask=None):
        """The selection round of compute_new_obs/get_best_pixels: keeps
        the adaptive threshold on the tracer (gpet.py:595) and returns the
        accepted pixels as a compact (n, 2) xy array."""
        pre = np.asarray(pre_fobs).reshape(-1, 2).astype(np.int64)  # yx
        n = pre.shape[0]
        cap = max(8, _round_up(n, 8))
        ox = np.zeros((cap,), np.int64)
        oy = np.zeros((cap,), np.int64)
        ov = np.zeros((cap,), bool)
        ox[:n] = pre[:, 1]
        oy[:n] = pre[:, 0]
        ov[:n] = True
        cfg = self.cfg
        sel = select_pixels(
            self._tensor(kde_arr, torch.float32), self.data.grad_kde,
            *(torch.as_tensor(a, device=self.device) for a in (ox, oy, ov)),
            n_pre=n, score_thresh=torch.tensor(
                self.score_thresh, dtype=torch.float32, device=self.device),
            spec=cfg.bins, fix_endpoints=cfg.fix_endpoints,
            kde_thresh=cfg.kde_thresh, pixel_thresh=cfg.pixel_thresh,
            algo_thresh=cfg.algo_thresh, max_decays=cfg.max_decays,
            cand_mask=None if cand_mask is None
            else self._tensor(cand_mask, torch.bool))
        self.score_thresh = float(sel.score_thresh)
        valid = _numpy(sel.obs_valid)
        return np.stack([_numpy(sel.obs_x)[valid], _numpy(sel.obs_y)[valid]],
                        axis=1).astype(np.int64)

    def compute_new_obs(self, pixel_idx, kde_arr, pre_fobs):
        """Score the yx candidate pixels ``pixel_idx`` and the rescored
        previous observations, threshold adaptively, keep the best pixel of
        each bin (gpet.py:532-619): the accepted xy pixels."""
        pixel_idx = np.asarray(pixel_idx).reshape(-1, 2)
        cand = np.zeros((self.M, self.N), bool)
        cand[pixel_idx[:, 0], pixel_idx[:, 1]] = True
        return self._select(kde_arr, pre_fobs, cand_mask=cand)

    def get_best_pixels(self, best_curves, costs, pre_fobs):
        """The best curves' KDE, its candidate pixels (without the fixed
        endpoints' columns) and :meth:`compute_new_obs` (gpet.py:622-662).
        ``pre_fobs`` is yx, as at the reference's call site
        (gpet.py:857)."""
        return self._select(self._kde(best_curves, costs), pre_fobs)

    def plot_iter(self, y_samples, N_plt_samples, obs):
        """Posterior fan chart of (E, S) curves (gpet.py:666-723)."""
        from gaussian_process_edge_trace_torch.utils.plotting import plot_iter
        return plot_iter(self.x_grid, y_samples, N_plt_samples, obs,
                         self.init, (self.M, self.N))

    def plot_diagnostics(self, iter_optimal_curves, iter_optimal_costs,
                         credint=None):
        """Optimal curve per iteration and cost scatter (gpet.py:727-764)."""
        from gaussian_process_edge_trace_torch.utils.plotting import (
            plot_diagnostics)
        return plot_diagnostics(self.grad_img, self.x_grid,
                                iter_optimal_curves, iter_optimal_costs,
                                credint)

    # -- the trace ---------------------------------------------------------

    def _obs_list(self, state):
        """The valid observations of a host-side state as (n, 2) xy."""
        xs = np.concatenate([state.user_x.numpy(), state.obs_x.numpy()])
        ys = np.concatenate([state.user_y.numpy(), state.obs_y.numpy()])
        valid = np.concatenate([state.user_valid.numpy(),
                                state.obs_valid.numpy()])
        return np.stack([xs[valid], ys[valid]], axis=1).astype(np.int64)

    def _introspect(self, state, draws, verbose, show_post_iter):
        """The loop one :func:`trace_step` at a time (gpet.py:829-870):
        the last state, each iteration's (E, S) curves, the observations
        before the first iteration and after each, and each iteration's
        optimal curve as (E, 2) xy and its cost. One read of the state by
        the host before the first iteration and after each, one of the
        curves. ``show_post_iter`` draws each iteration's fan chart with
        the observations it started from."""
        cfg, data = self.cfg, self.data
        invariants = loop_invariants(cfg, data)
        all_samples, all_obs, iter_curves, iter_costs = [], [self.obs], [], []
        h = to_host(state, "state")
        while int(h.n_fobs) < cfg.algo_thresh and h.it < cfg.max_iters:
            st = time.time()
            if verbose:
                print("Fitting Gaussian process and computing next set of "
                      "observations...")
            prev_obs = all_obs[-1]
            state, samples = trace_step(cfg, data, state, draws, invariants)
            all_samples.append(to_host(samples, "samples").numpy())
            if show_post_iter:
                self.plot_iter(all_samples[-1], 20, prev_obs)
            h = to_host(state, "state")
            all_obs.append(self._obs_list(h))
            iter_curves.append(np.stack(
                [self.x_grid, h.iter_curves[h.it - 1].numpy()], axis=1))
            iter_costs.append(float(h.iter_costs[h.it - 1]))
            if verbose:
                print(f"Number of observations: {int(h.n_fobs)}")
                print(f"Iteration {h.it} - Time Elapsed: "
                      f"{round(time.time() - st, 4)}\n\n")
        return state, all_samples, all_obs, iter_curves, iter_costs

    def __call__(self, print_final_diagnostics=False, show_init_post=False,
                 show_post_iter=False, verbose=False, return_lines=False,
                 ensemble=None):
        """Run the trace (gpet.py:768-908). Returns the (E, 2) yx
        ``edge_trace``; with ``return_std``, ``(edge_trace, (lower,
        upper))``, the 95% credible interval, in the reference's
        standardised units unless ``reference_quirks=False``
        (gpet.py:876); else with ``return_lines``, ``(edge_trace,
        (all_samples, all_obs, iter_curves))``: each iteration's (E, S)
        curves (after the initial posterior's, with ``show_init_post``) and
        then the final mean, the (n, 2) xy observations before the first
        iteration, after each and at the end, and each iteration's optimal
        curve and then the trace, (E, 2) xy.

        ``show_init_post`` draws the initial posterior's curves
        (:func:`~..trace.driver.preview_samples`), asks whether the kernel
        will do and returns ``None`` unless the answer starts with "y"
        (gpet.py:805-812). ``show_post_iter``, ``return_lines`` and
        ``verbose`` step the loop one iteration at a time (the introspective
        path); the result is the fused path's. ``print_final_diagnostics``
        draws each iteration's optimal curve and cost (gpet.py:888-893).
        ``ensemble=K`` traces K seeds at once and keeps the member with the
        lowest final cost (:func:`..parallel.sharded.trace_ensemble`;
        member 0 is the single trace, so K = 1 is the same as ``None``);
        its members draw from their own default sources, so it does not
        take the constructor's ``draws``, and it excludes the
        introspective options. ``last_result`` is the (chosen) trace's
        result."""
        introspective = bool(show_post_iter or return_lines or verbose)
        if ensemble is not None and introspective:
            raise ValueError("ensemble= is incompatible with the "
                             "introspective options (show_post_iter / "
                             "return_lines / verbose)")
        K = 1 if ensemble is None else int(ensemble)
        if K < 1:
            raise ValueError(f"ensemble must be >= 1, got {ensemble}")
        if K > 1 and self.draws is not None:
            raise ValueError("ensemble= draws each member from its own "
                             "source; pass per-member sources to "
                             "trace_ensemble instead of draws=")
        cfg, data = self.cfg, self.data
        state = init_state(cfg, user_obs_xy=self.obs, device=self.device)
        preview = []
        if show_init_post:
            preview.append(_numpy(preview_samples(cfg, data, state)))
            self.plot_iter(preview[0], 20, self.obs)
            print("Are you happy with your choice of kernel? y/n")
            if input().lower()[:1] != "y":
                return None
        alg_st = time.time()
        if introspective:
            draws = self.draws or _default_draws(cfg, data)
            state, all_samples, all_obs, iter_curves, iter_costs = \
                self._introspect(state, draws, verbose, show_post_iter)
            res = finish_trace(cfg, data, state, draws)
            all_samples = preview + all_samples + [_numpy(res.y_mean)]
            all_obs.append(obs_from_result(res))
        elif K > 1:
            res = trace_ensemble(cfg, data, state, n_seeds=K)
        else:
            res = run_trace(cfg, data, state, draws=self.draws)
        # The adaptive threshold persists, as the reference's mutable
        # attribute does (gpet.py:595).
        # One read of the trace, its interval and the last threshold.
        n_it = res.n_iters
        thresh, edge_trace, cred = (t.numpy() for t in to_host(
            (res.iter_thresh[max(n_it - 1, 0)], res.edge_trace,
             res.cred_interval), "result"))
        self.score_thresh = (float(thresh) if n_it > 0
                             else float(cfg.score_thresh0))
        self.last_result = res
        if print_final_diagnostics:
            if not introspective:
                curves = _numpy(res.iter_curves[:n_it])
                iter_curves = [np.stack([self.x_grid, c], axis=1)
                               for c in curves]
                iter_costs = [float(c) for c in _numpy(
                    res.iter_costs[:n_it])]
            self.plot_diagnostics(
                iter_curves + [edge_trace[:, [1, 0]]],
                iter_costs + [float(res.final_cost)], (cred[0], cred[1]))
        if verbose:
            print(f"Time elapsed before algorithm converged: "
                  f"{round(time.time() - alg_st, 3)}")
        if self.return_std:
            return edge_trace, (cred[0], cred[1])
        if return_lines:
            return edge_trace, (all_samples, all_obs,
                                iter_curves + [edge_trace[:, [1, 0]]])
        return edge_trace
