"""``GP_Edge_Tracing`` — the reference-compatible entry point, slimmed.

Same positional constructor signature, defaults and clamps as the reference
class (gpet.py:22-35), and its non-introspective ``__call__``
(gpet.py:768-908): the trace runs through :func:`..trace.driver.run_trace`
on one device and returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_process_edge_trace_torch.trace.driver import (
    init_state, make_config, make_data, run_trace)


class GP_Edge_Tracing:
    """Trace one edge in one gradient image by GP regression.

    Positional signature as gpet.py:22-35: ``(init, grad_img,
    kernel_options, noise_y, obs, N_samples, score_thresh, delta_x,
    keep_ratio, pixel_thresh, seed, return_std, fix_endpoints)``. Keyword-only
    extras: ``max_iters``, ``reference_quirks``, ``legacy_simpson``,
    ``device`` (where the trace runs; ``"cuda"`` by default) and ``draws``
    (a draw source for :func:`run_trace`, :class:`TorchDraws` by default).
    """

    def __init__(self, init, grad_img, kernel_options=(1, 3, 3), noise_y=1,
                 obs=np.array([], dtype=np.int8), N_samples=500,
                 score_thresh=1, delta_x=20, keep_ratio=0.1, pixel_thresh=5,
                 seed=42, return_std=False, fix_endpoints=True, *,
                 max_iters=48, reference_quirks=True, legacy_simpson=False,
                 device="cuda", draws=None):
        init = np.asarray(init)
        self.init = init[np.argsort(init[:, 0])].astype(int)  # gpet.py:95
        self.obs = np.asarray(obs).reshape(-1, 2).astype(np.int64)
        self.return_std = bool(return_std)
        self.device = device
        self.draws = draws
        if not isinstance(grad_img, torch.Tensor):
            grad_img = np.asarray(grad_img)
        self.cfg = make_config(
            self.init, tuple(grad_img.shape), kernel_options=kernel_options,
            noise_y=noise_y, n_user_obs=self.obs.shape[0],
            N_samples=N_samples, score_thresh=score_thresh, delta_x=delta_x,
            keep_ratio=keep_ratio, pixel_thresh=pixel_thresh, seed=seed,
            fix_endpoints=fix_endpoints, max_iters=max_iters,
            reference_quirks=reference_quirks,
            legacy_simpson=legacy_simpson)
        self.data = make_data(self.cfg, grad_img, self.init, device)
        # The reference's public attributes (gpet.py:95-119).
        cfg = self.cfg
        self.x_st, self.x_en = cfg.x_st, cfg.x_en
        self.M, self.N = cfg.M, cfg.N
        self.edge_length = cfg.edge_length
        self.N_samples = cfg.N_samples
        self.N_subints = cfg.N_subints
        self.N_keep = cfg.N_keep
        self.algo_thresh = cfg.algo_thresh
        self.delta_x = cfg.delta_x
        self.pixel_thresh = cfg.pixel_thresh
        self.score_thresh = cfg.score_thresh0
        self.kde_thresh = cfg.kde_thresh
        self.seed = cfg.seed
        self.fix_endpoints = cfg.fix_endpoints
        self.noise_y = cfg.noise_y
        self.sigma_f, self.sigma_l = cfg.sigma_f, cfg.sigma_l
        self.x_grid = self.data.x_grid.cpu().numpy()

    def __call__(self, print_final_diagnostics=False, show_init_post=False,
                 show_post_iter=False, verbose=False, return_lines=False,
                 ensemble=None):
        """Run the trace. Returns the (E, 2) yx ``edge_trace``, or
        ``(edge_trace, (lower, upper))`` with ``return_std`` — the 95%
        credible interval, in the reference's standardised units unless
        ``reference_quirks=False`` (gpet.py:876)."""
        unsupported = {"print_final_diagnostics": print_final_diagnostics,
                       "show_init_post": show_init_post,
                       "show_post_iter": show_post_iter, "verbose": verbose,
                       "return_lines": return_lines,
                       "ensemble": ensemble is not None}
        asked = [k for k, v in unsupported.items() if v]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: not ported to the PyTorch package yet")
        state = init_state(self.cfg, self.device, user_obs_xy=self.obs)
        res = run_trace(self.cfg, self.data, state, draws=self.draws)
        n_it = res.n_iters
        self.score_thresh = (float(res.iter_thresh[n_it - 1]) if n_it > 0
                             else float(self.cfg.score_thresh0))
        self.last_result = res
        edge_trace = res.edge_trace.cpu().numpy()
        if self.return_std:
            cred = res.cred_interval.cpu().numpy()
            return edge_trace, (cred[0], cred[1])
        return edge_trace
