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

On the card each of an iteration's four stages (sampling, scoring, KDE,
selection) replays one CUDA graph per shape (``trace/stage_graph.py``) in
place of its tens to ~140 launches; the loop's active-mask read and the
keeping of finished frames run between the graphs.

Frames: every stage takes an optional leading frame axis, and the loop runs
B traces at once (``parallel/sharded.py`` builds the batched data and
states): each stage launches once per iteration for all frames. The loop
keeps the semantics of the JAX package's vmapped ``while_loop``: it runs
while any frame is active, reading the (B,) active mask once per iteration,
and a frame that has finished keeps its state unchanged. In a batched
:class:`TraceState` ``it`` is a (B,) int64 tensor; every frame that is still
active stands at the same iteration. A single trace is the case B = 1: its
state (``it`` a Python int) exists only at the public edge, which lifts it
into a batch of one with no wait and takes frame 0 back out, at the
iteration the host counted, with no read.

Random numbers come from a draw source (:class:`StreamDraws` by default, the
JAX package's own random stream of the config's seed): the normals of
iteration ``it`` and the uniforms of the final fit's restarts. A caller may
pass another source with the same two methods (one that also states
``normal_shapes`` and takes ``out`` draws straight into the sampling stage's
graph on the card, as the package's sources do). A batch's frames share one
source, as the JAX package's frames share one key; sources whose draws carry a
leading frame axis give each frame its own (an ensemble's members). Under a
sample axis (``parallel/sharded.py::sharded_trace_batch``) a rank asks its
source for its columns of the normals, ``normals(it, cols)``.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from gaussian_process_edge_trace_torch.models.gpr import (
    batched_lml, fit_and_sample, fixed_sum, frame_sum, gp_fit, gp_predict,
    library_lml, masked_mean, masked_std)
from gaussian_process_edge_trace_torch.models.kernels import (
    KernelSpec, k_unit_np, per_frame, resolve_kernel_options)
from gaussian_process_edge_trace_torch.models.newton import (
    lml_screen_grid, screen_and_polish, screen_and_polish_batched)
from gaussian_process_edge_trace_torch.ops import prng
from gaussian_process_edge_trace_torch.trace import stage_graph
from gaussian_process_edge_trace_torch.trace.kde import (
    banded_pair, blur_matrices, curve_kde, gradient_kde)
from gaussian_process_edge_trace_torch.trace.scoring import (
    best_curves, curve_costs, sharded_best_curves)
from gaussian_process_edge_trace_torch.trace.select import (
    BinSpec, SelectConsts, make_bin_spec, select_consts, select_pixels)
from gaussian_process_edge_trace_torch.utils import profiling
from gaussian_process_edge_trace_torch.utils.image import normalise
# The host's waits for the device by kind, and the bytes ``to_host``
# copies: ``utils/profiling.py``'s counters, under their names here.
from gaussian_process_edge_trace_torch.utils.profiling import (  # noqa: F401
    GRAPHS, HOST_BYTES, HOST_READS, span)

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
    """The loop carry of one trace; a batch has a leading frame axis on
    every field, ``it`` included."""
    obs_x: torch.Tensor        # (n_bins,) int64 per-bin observation buffer
    obs_y: torch.Tensor        # (n_bins,) int64
    obs_valid: torch.Tensor    # (n_bins,) bool
    user_x: torch.Tensor       # (U,) int64 warm-start observations
    user_y: torch.Tensor       # (U,) int64
    user_valid: torch.Tensor   # (U,) bool — cleared after the 1st iteration
    score_thresh: torch.Tensor  # scalar float32, adaptive threshold
    n_fobs: torch.Tensor       # scalar int64
    it: int                    # host-side iteration count ((B,) tensor)
    iter_curves: torch.Tensor  # (max_iters, E) optimal curve per iteration
    iter_costs: torch.Tensor   # (max_iters,)
    iter_nobs: torch.Tensor    # (max_iters,) int64
    iter_thresh: torch.Tensor  # (max_iters,)


class TraceResult(NamedTuple):
    """One trace's result; a batch's has a leading frame axis on every
    field, with ``n_iters`` and ``converged`` host (CPU) tensors."""
    edge_trace: torch.Tensor        # (E, 2) int64, yx-space (gpet.py:886)
    y_mean: torch.Tensor            # (E,) posterior mean, pixel units
    y_std: torch.Tensor             # (E,) predictive std (see finish_trace)
    cred_interval: torch.Tensor     # (2, E) mean ∓ 1.96·y_std
    cred_interval_px: torch.Tensor  # (2, E) pixel-unit interval
    n_iters: int                    # ((B,) int64 for a batch)
    converged: bool                 # False = max_iters hit ((B,) bool)
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


def resolve_device(device, *inputs) -> torch.device:
    """``device`` if given, else the device of the first tensor among
    ``inputs``, else the card: where an entry point runs when the caller
    does not say."""
    if device is not None:
        return torch.device(device)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def _device_at(pos: int):
    """Accept the port's earlier form of a constructor, which took the
    device as positional argument ``pos``, where the reference has its
    optional arguments: a ``str`` or ``torch.device`` there is the device,
    and the arguments after it move up one place. Anything else there (an
    array, a tensor, None) is the reference's argument."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if len(args) > pos and isinstance(args[pos], (str, torch.device)):
                if "device" in kwargs:
                    raise TypeError(f"{fn.__name__}() got two devices")
                kwargs["device"] = args[pos]
                args = args[:pos] + args[pos + 1:]
            return fn(*args, **kwargs)
        return call
    return wrap


def frame_arrays(cfg: TracerConfig, grad_img, init_xy, device=None):
    """Per-frame tensors (gpet.py:97,127): normalised gradient image, its
    KDE, the (E, M) gradient columns along the x grid and the init points
    sorted by x. ``device`` defaults to that of a tensor input, else the
    card."""
    g, gcols, ix, iy = frame_parts(cfg, grad_img, init_xy, device)
    return g, gradient_kde(g, kde_thresh=cfg.kde_thresh), gcols, ix, iy


def frame_parts(cfg: TracerConfig, grad_img, init_xy, device=None):
    """:func:`frame_arrays` without the KDE: (normalised image, gradient
    columns, init x, init y), for a batch that takes every frame's KDE in
    one call."""
    device = resolve_device(device, grad_img, init_xy)
    g = normalise(grad_img, (0, 1), device=device)
    gcols = g.T[cfg.x_st:cfg.x_st + cfg.edge_length].contiguous()
    with profiling.wait("data"):
        init_xy = torch.as_tensor(np.array(init_xy), dtype=torch.int64,
                                  device=device)
    init_xy = init_xy[torch.argsort(init_xy[:, 0], stable=True)]
    return g, gcols, init_xy[:, 0].contiguous(), init_xy[:, 1].contiguous()


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


def make_data(cfg: TracerConfig, grad_img, init_xy,
              device=None) -> TracerData:
    """Precompute the per-image tensors (gpet.py:97,122-127) on ``device``,
    by default that of a tensor input, else the card."""
    device = resolve_device(device, grad_img, init_xy)
    g, gkde, gcols, ix, iy = frame_arrays(cfg, grad_img, init_xy, device)
    with profiling.wait("data"):
        L_prior_unit = torch.tensor(prior_factor(cfg), device=device)
    return TracerData(
        grad_img=g, grad_kde=gkde, grad_cols=gcols, L_prior_unit=L_prior_unit,
        x_grid=cfg.x_st + torch.arange(cfg.edge_length, device=device),
        init_x=ix, init_y=iy)


@_device_at(1)
def init_state(cfg: TracerConfig, user_obs_xy=None, user_obs_valid=None,
               device=None) -> TraceState:
    """Initial loop state; ``user_obs_xy`` is the (U, 2) xy warm-start
    observation array (gpet.py:57-61,820). ``user_obs_valid`` optionally
    masks padded warm-start slots (driver.py:294-322 of the reference), and
    ``n_fobs`` then counts the valid ones. Tensors stay on the device: a
    sequence hands one frame's observations to the next without a host
    copy. ``device`` defaults to that of a tensor input, else the card;
    the port's earlier form ``init_state(cfg, device, ...)`` still works."""
    device = resolve_device(device, user_obs_xy, user_obs_valid)
    B = cfg.bins.n_bins
    U = cfg.n_user_obs
    if user_obs_xy is None:
        user_obs_xy = np.zeros((0, 2), np.int64)
    if not isinstance(user_obs_xy, torch.Tensor):
        user_obs_xy = np.array(user_obs_xy)
    user = torch.as_tensor(user_obs_xy, dtype=torch.int64,
                           device=device).reshape(-1, 2)
    if user.shape[0] != U:
        raise ValueError(f"{user.shape[0]} warm-start observations for a "
                         f"config built with n_user_obs={U}")
    E, mi = cfg.edge_length, cfg.max_iters
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if user_obs_valid is None:
        valid = torch.ones(U, dtype=torch.bool, device=device)
        with profiling.wait("init"):
            n_fobs = torch.tensor(U, **i64)
    else:
        valid = torch.as_tensor(user_obs_valid, dtype=torch.bool,
                                device=device)
        if valid.shape != (U,):
            raise ValueError(f"user_obs_valid of shape {tuple(valid.shape)} "
                             f"for {U} warm-start observations")
        n_fobs = valid.sum(dtype=torch.int64)
    with profiling.wait("init"):
        score_thresh = torch.tensor(cfg.score_thresh0, **f32)
    return TraceState(
        obs_x=torch.zeros(B, **i64), obs_y=torch.zeros(B, **i64),
        obs_valid=torch.zeros(B, dtype=torch.bool, device=device),
        user_x=user[:, 0].contiguous(), user_y=user[:, 1].contiguous(),
        user_valid=valid, score_thresh=score_thresh,
        n_fobs=n_fobs, it=0,
        iter_curves=torch.zeros((mi, E), **f32),
        iter_costs=torch.zeros(mi, **f32),
        iter_nobs=torch.zeros(mi, **i64),
        iter_thresh=torch.zeros(mi, **f32))


def _train_set(cfg: TracerConfig, data: TracerData, state: TraceState):
    """Padded training buffers: init + user obs + binned obs
    (gpet.py:209-214; unsorted, the GP is permutation-invariant), with the
    state's frame axis. The noise weights are the same for every frame."""
    dev = data.x_grid.device
    lead = state.obs_x.shape[:-1]
    pad = cfg.n_train - cfg.n_inits - cfg.n_user_obs - cfg.bins.n_bins
    zeros = torch.zeros(lead + (pad,), dtype=torch.int64, device=dev)
    inits = lead + (cfg.n_inits,)
    x = torch.cat([data.init_x.expand(inits), state.user_x, state.obs_x,
                   zeros], dim=-1)
    y = torch.cat([data.init_y.expand(inits), state.user_y, state.obs_y,
                   zeros], dim=-1)
    mask = torch.cat([torch.ones(inits, dtype=torch.bool, device=dev),
                      state.user_valid, state.obs_valid,
                      torch.zeros(lead + (pad,), dtype=torch.bool,
                                  device=dev)], dim=-1)
    # Endpoint noise weight 1e-7/0.5, observation weight 1 (gpet.py:161,209).
    noise_w = torch.cat([
        torch.full((cfg.n_inits,), cfg.init_noise_weight,
                   dtype=torch.float32, device=dev),
        torch.ones(cfg.n_train - cfg.n_inits, dtype=torch.float32,
                   device=dev)])
    return x, y, mask, noise_w


class StreamDraws:
    """The default draw source: the JAX package's random stream of one
    tracer seed (``cfg.seed`` unless ``seed`` is given), derived as the JAX
    package derives it (``ops/prng.py``).

    ``normals(it, cols)`` are iteration ``it``'s draws: ``split(fold_in(
    PRNGKey(seed), it + 1))`` into a prior and a noise key (driver.py:394,
    gpr.py:208), then the (r, S) and (n_train, S) standard normals of those
    keys (gpr.py:233,238), or their columns ``cols``: a rank that holds
    samples [off, off + S/k) of a sample group takes ``slice(off, off +
    S/k)``, and its columns are the full draw's bit for bit.
    ``restarts()`` are the final fit's (lml_restarts, 3) uniforms in [0, 1)
    of ``fold_in(PRNGKey(seed), 0)`` (driver.py:590,639-640). Each is one
    table of :class:`~..ops.prng.Draw` s (``normal_table``,
    ``restart_table``): on the card one launch of
    ``csrc/threefry_normal_kernel.cu``, on the CPU its plain version, and
    both equal ``jax.random``'s draws."""

    def __init__(self, cfg: TracerConfig, rank: int, device, seed=None):
        self.cfg, self.rank = cfg, rank
        self.device = torch.device(device)
        self.seed = int(cfg.seed if seed is None else seed)
        self.key = prng.prng_key(self.seed)

    def normal_table(self, it: int, cols=slice(None)):
        k_prior, k_noise = prng.split(prng.fold_in(self.key, it + 1))
        S = self.cfg.N_samples
        return [prng.Draw("normal", k_prior, (self.rank, S), cols),
                prng.Draw("normal", k_noise, (self.cfg.n_train, S), cols)]

    def restart_table(self):
        return [prng.Draw("uniform", prng.fold_in(self.key, 0),
                          (self.cfg.lml_restarts, 3))]

    def normals(self, it: int, cols=slice(None), out=None):
        """(z (r, S), w (n_train, S)) standard normals of iteration ``it``,
        or their columns ``cols``; drawn into ``out`` (two tensors of
        :meth:`normal_shapes`) where given."""
        return tuple(prng.draw(self.normal_table(it, cols), self.device,
                               out=out))

    def normal_shapes(self, cols=slice(None)):
        """The shapes of :meth:`normals` ``(it, cols)``, any ``it``."""
        n = len(range(*cols.indices(self.cfg.N_samples)))
        return (self.rank, n), (self.cfg.n_train, n)

    def restarts(self):
        """(lml_restarts, 3) uniforms in [0, 1) for the final fit."""
        return prng.draw(self.restart_table(), self.device)[0]


class FrameDraws:
    """Draw sources of their own for each frame, as one source: the normals
    and restart uniforms of every frame's source stacked on a leading axis
    ((B, r, S), (B, n_train, S), (B, lml_restarts, 3)); ``normals(it,
    cols)`` passes the columns on. Sources with tables (:class:`StreamDraws`)
    draw every frame's table in one launch, straight into the stacked
    tensors; others are drawn one by one and stacked."""

    def __init__(self, sources):
        self.sources = list(sources)
        self.tabled = all(hasattr(src, "normal_table")
                          for src in self.sources)

    def _stacked(self, tables, out=None):
        """One tensor per entry of the sources' tables (equal in layout),
        frame k of it drawn from source k's entry, all in one table; into
        ``out`` where given."""
        dev = self.sources[0].device
        stacks = out or [prng.empty(d, dev, lead=(len(tables),))
                         for d in tables[0]]
        prng.draw([d for t in tables for d in t], dev,
                  out=[s[k] for k in range(len(tables)) for s in stacks])
        return stacks

    def normals(self, it: int, *cols, out=None):
        """Every frame's ``normals(it, *cols)`` stacked; sources with
        tables draw into ``out`` where given."""
        if self.tabled:
            return tuple(self._stacked([src.normal_table(it, *cols)
                                        for src in self.sources], out))
        z, w = zip(*(src.normals(it, *cols) for src in self.sources))
        return torch.stack(z), torch.stack(w)

    def normal_shapes(self, *cols):
        """The shapes of :meth:`normals` where every source states its
        own (:meth:`StreamDraws.normal_shapes`) and draws from tables,
        else None."""
        shapes = getattr(self.sources[0], "normal_shapes", None)
        if not self.tabled or shapes is None:
            return None
        return tuple((len(self.sources),) + tuple(s) for s in shapes(*cols))

    def restarts(self):
        if self.tabled:
            return self._stacked([src.restart_table()
                                  for src in self.sources])[0]
        return torch.stack([src.restarts() for src in self.sources])


class KeyDraws:
    """The draws of one unfolded key, ``PRNGKey(seed)``, as
    ``fit_predict_GP(seed=k)`` and ``preview_samples`` take it
    (models/tracer.py:158, driver.py:720): ``sample_normals(n)`` gives the
    sampling round's (z (r, S), w (n, S)) for a training buffer of ``n``
    slots from ``split(PRNGKey(seed))`` in one table, and ``restarts()``
    the final fit's (lml_restarts, 3) uniforms of ``PRNGKey(seed)`` itself
    (driver.py:590, 625)."""

    def __init__(self, cfg: TracerConfig, rank: int, device, seed=0):
        self.cfg, self.rank = cfg, rank
        self.device = torch.device(device)
        self.key = prng.prng_key(seed)

    def sample_normals(self, n: int):
        k_prior, k_noise = prng.split(self.key)
        S = self.cfg.N_samples
        return tuple(prng.draw([prng.Draw("normal", k_prior, (self.rank, S)),
                                prng.Draw("normal", k_noise, (n, S))],
                               self.device))

    def restarts(self):
        return prng.uniform(self.key, (self.cfg.lml_restarts, 3),
                            device=self.device)


def _default_draws(cfg: TracerConfig, data: TracerData) -> StreamDraws:
    return StreamDraws(cfg, data.L_prior_unit.shape[1], data.grad_img.device)


def _key_draws(cfg: TracerConfig, data: TracerData, seed) -> KeyDraws:
    return KeyDraws(cfg, data.L_prior_unit.shape[1], data.grad_img.device,
                    seed)


def to_host(tree, kind: str):
    """``tree`` (a tensor, or a tuple or NamedTuple of tensors and host
    values) on the CPU, copied with one wait for the device
    (:class:`~..utils.profiling.wait`: a span ``gpet.wait.<kind>`` and one
    count of ``kind`` in :data:`HOST_READS`), and its bytes counted in
    :data:`HOST_BYTES`."""
    one = isinstance(tree, torch.Tensor)
    items = [tree] if one else list(tree)
    with profiling.wait(kind):
        out = [v.to("cpu", non_blocking=True) if isinstance(v, torch.Tensor)
               else v for v in items]
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in items):
            torch.cuda.current_stream().synchronize()
    HOST_BYTES[kind] += sum(v.numel() * v.element_size() for v in out
                            if isinstance(v, torch.Tensor))
    if one:
        return out[0]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def _sample_round(cfg: TracerConfig, data: TracerData, x, y, mask, noise_w,
                  z, w):
    """One sampling-mode GP round (gpet.py:227-230,255-261): scale y by
    std+1, set the variance to σf²/y_s², draw Matheron curves, rescale."""
    yf = y.to(torch.float32)
    std_raw = masked_std(yf, mask, frame_sum)
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
        cfg.kernel, x.to(torch.float32), yf / y_s[..., None], cfg.sigma_l,
        variance, diag_noise, mask, data.L_prior_unit, x_idx=x,
        grid_out=data.x_grid, z=z, w=w, centre=True, post_scale=post_scale)
    return samples * per_frame(y_s)                         # (..., E, S)


def _sample_curves(cfg: TracerConfig, data: TracerData, state: TraceState,
                   z, w):
    """The sampling stage's work: the padded training buffers and the
    sampling round on them."""
    x, y, mask, noise_w = _train_set(cfg, data, state)
    return _sample_round(cfg, data, x, y, mask, noise_w, z, w)


# The fields of the data and of the state that the sampling stage reads.
_STAGE_DATA = ("init_x", "init_y", "L_prior_unit", "x_grid")
_STAGE_STATE = ("user_x", "user_y", "user_valid", "obs_x", "obs_y",
                "obs_valid")


def _stage_fn(cfg: TracerConfig):
    """:func:`_sample_curves` on the stage's tensors: those of
    ``_STAGE_DATA``, those of ``_STAGE_STATE``, then ``z`` and ``w``."""
    nd, ns = len(_STAGE_DATA), len(_STAGE_STATE)

    def fn(*ts):
        data = TracerData(*(None,) * len(TracerData._fields))._replace(
            **dict(zip(_STAGE_DATA, ts[:nd])))
        state = TraceState(*(None,) * len(TraceState._fields))._replace(
            **dict(zip(_STAGE_STATE, ts[nd:nd + ns])))
        return _sample_curves(cfg, data, state, *ts[nd + ns:])
    return fn


def _stage_key(cfg: TracerConfig, tensors, zw):
    """Everything the sampling stage's Python reads: each tensor's
    device, dtype and shape, those of ``zw`` (``(shape, dtype)`` pairs of
    ``z`` and ``w``) and the configuration's scalars that
    :func:`_train_set` and :func:`_sample_round` read (not its seed)."""
    return (stage_graph.specs(tensors), tuple(zw), cfg.kernel, cfg.sigma_f,
            cfg.sigma_l, cfg.noise_y, cfg.gp_jitter, cfg.init_noise_weight,
            cfg.reference_quirks, cfg.n_inits, cfg.n_user_obs,
            cfg.bins.n_bins, cfg.n_train)


def _sample_stage(cfg: TracerConfig, data: TracerData, state: TraceState,
                  draws, k: int, cols=()):
    """The sampling stage: iteration ``k``'s normals from ``draws`` (its
    columns ``cols``), then the (..., E, S) curves of
    :func:`_sample_curves`.

    Where :func:`stage_graph.engaged` (on the card) the stage replays its
    CUDA graph (``trace/stage_graph.py``), captured at its key's first use,
    in the span ``gpet.sample.replay``: a source that states its shapes
    (``normal_shapes``) draws straight into the graph's ``z`` and ``w``;
    the normals of another source, the state and the data are copied in.
    A replay's curves are the graph's output buffer, which the next replay
    overwrites: a caller that keeps them copies them. Elsewhere, and for a
    key whose capture failed, it runs op by op. ``GRAPHS`` counts either
    way."""
    dev = data.x_grid.device
    graph, zw = None, None
    if stage_graph.engaged(dev):
        normal_shapes = getattr(draws, "normal_shapes", None)
        shapes = normal_shapes(*cols) if normal_shapes else None
        if shapes is None:
            zw = draws.normals(k, *cols)
            specs = [(tuple(t.shape), t.dtype) for t in zw]
        else:
            specs = [(tuple(s), torch.float32) for s in shapes]
        tensors = ([getattr(data, f) for f in _STAGE_DATA]
                   + [getattr(state, f) for f in _STAGE_STATE])
        graph = stage_graph.lookup(
            _stage_key(cfg, tensors, specs),
            lambda: (_stage_fn(cfg), tensors + [
                torch.zeros(s, dtype=d, device=dev) for s, d in specs]),
            "gpet.sample.replay")
    if graph is None:
        GRAPHS["eager"] += 1
        return _sample_curves(cfg, data, state,
                              *(zw or draws.normals(k, *cols)))
    if zw is None:
        zw = draws.normals(k, *cols, out=graph.static[-2:])
    return graph(tensors + list(zw))


def _even(cfg: TracerConfig) -> str:
    return "avg" if cfg.legacy_simpson else "simpson"


def _score_curves(cfg: TracerConfig, grad_cols, samples):
    """The scoring stage's work: every curve's cost, then the ``N_keep``
    cheapest, ``(bc, bcosts)``."""
    costs, samples_t = curve_costs(grad_cols, samples,
                                   kde_thresh=cfg.kde_thresh,
                                   even=_even(cfg), return_samples_t=True)
    return best_curves(samples, costs, cfg.N_keep, samples_t=samples_t)


def _kde_curves(cfg: TracerConfig, bc, bcosts, blur):
    """The KDE stage's work: the kept curves weighted by their normalised
    inverse costs (gpet.py:492-493), then their KDE."""
    inv = 1.0 / bcosts
    weights = inv / frame_sum(inv)[..., None]
    return curve_kde(bc, weights, cfg.M, cfg.N, cfg.x_st, blur=blur)


# The fields of the state that the selection stage reads, and those of the
# new state that it writes.
_SELECT_STATE = ("user_x", "user_y", "user_valid", "obs_x", "obs_y",
                 "obs_valid", "n_fobs", "score_thresh", "it", "iter_curves",
                 "iter_costs", "iter_nobs", "iter_thresh")
_SELECT_OUT = ("obs_x", "obs_y", "obs_valid", "user_valid", "score_thresh",
               "n_fobs", "it", "iter_curves", "iter_costs", "iter_nobs",
               "iter_thresh")


def _put(buf, v, at):
    """``buf`` (B, max_iters, ...) with each frame's ``v`` written at its
    column of ``at`` ((B, max_iters) one-hot of its own iteration; none
    past the last)."""
    return torch.where(at.reshape(at.shape + (1,) * (buf.dim() - 2)),
                       v.unsqueeze(1), buf)


def _select_obs(cfg: TracerConfig, state: TraceState, kde_arr, grad_kde, bc,
                bcosts, consts: SelectConsts):
    """The selection stage's work on a batched state: :func:`select_pixels`
    on the KDE, then the new state's fields of ``_SELECT_OUT`` and the
    pixel scores. Each frame's telemetry goes to the column of its own
    ``it``, read on the device."""
    sel = select_pixels(
        kde_arr, grad_kde,
        torch.cat([state.user_x, state.obs_x], dim=-1),
        torch.cat([state.user_y, state.obs_y], dim=-1),
        torch.cat([state.user_valid, state.obs_valid], dim=-1),
        n_pre=state.n_fobs, score_thresh=state.score_thresh,
        spec=cfg.bins, fix_endpoints=cfg.fix_endpoints,
        kde_thresh=cfg.kde_thresh, pixel_thresh=cfg.pixel_thresh,
        algo_thresh=cfg.algo_thresh, max_decays=cfg.max_decays,
        consts=consts)
    at = torch.arange(cfg.max_iters, device=kde_arr.device) \
        == state.it[..., None]
    return (sel.obs_x, sel.obs_y, sel.obs_valid,
            torch.zeros_like(state.user_valid),        # 1st iteration only
            sel.score_thresh, sel.n_fobs, state.it + 1,
            _put(state.iter_curves, bc[..., 0], at),
            _put(state.iter_costs, bcosts[..., 0], at),
            _put(state.iter_nobs, sel.n_fobs, at),
            _put(state.iter_thresh, sel.score_thresh, at), sel.score)


def _score_stage(cfg: TracerConfig, data: TracerData, samples, shard=None):
    """The scoring stage, ``(bc, bcosts)``: :func:`_score_curves` through
    :func:`stage_graph.run`, the samples (the sampling graph's buffer) taken
    as its graph's own; with ``shard`` op by op, since
    :func:`sharded_best_curves` runs collectives: the rank scores its
    ``shard.width`` curves, with K1 planned on the group's S and no
    transposed copy, and ranks over the group."""
    if shard is None:
        return stage_graph.run(
            "gpet.score", functools.partial(_score_curves, cfg),
            [data.grad_cols, samples], _score_key(cfg), share=(1,))
    GRAPHS["eager"] += 1
    costs = curve_costs(data.grad_cols, samples, kde_thresh=cfg.kde_thresh,
                        even=_even(cfg), plan_samples=cfg.N_samples)
    return sharded_best_curves(samples, costs, cfg.N_keep, shard)


def _score_key(cfg: TracerConfig):
    """The configuration's scalars that the scoring stage reads."""
    return cfg.kde_thresh, cfg.legacy_simpson, cfg.N_keep


def _kde_stage(cfg: TracerConfig, bc, bcosts, blur):
    """The KDE stage: :func:`_kde_curves` through :func:`stage_graph.run`
    on the kept curves and costs (the scoring graph's buffers, taken as its
    graph's own) and the blur factors that are matrices."""
    layout = (None if blur is None else
              (tuple(m is not None for m in blur), blur.band))
    mats = [m for m in blur or () if m is not None]

    def fn(bc, bcosts, *mats):
        pair = None
        if layout is not None:
            it = iter(mats)
            pair = banded_pair(*(next(it) if m else None
                                 for m in layout[0]), layout[1])
        return _kde_curves(cfg, bc, bcosts, pair)
    return stage_graph.run("gpet.kde", fn, [bc, bcosts] + mats,
                           _kde_key(cfg, layout), share=(0, 1))


def _kde_key(cfg: TracerConfig, layout):
    """The configuration's scalars that the KDE stage reads, and which
    blur factors are matrices with their band."""
    return cfg.M, cfg.N, cfg.x_st, layout


def _select_stage(cfg: TracerConfig, data: TracerData, state: TraceState,
                  kde_arr, bc, bcosts, consts: SelectConsts):
    """The selection stage: :func:`_select_obs` through
    :func:`stage_graph.run` on the KDE, the kept curves and costs (the
    previous graphs' buffers, taken as its graph's own), the gradient KDE,
    the state's fields of ``_SELECT_STATE`` and the selection's
    constants."""
    ns = len(_SELECT_STATE)

    def fn(kde_arr, grad_kde, bc, bcosts, *ts):
        st = TraceState(*(None,) * len(TraceState._fields))._replace(
            **dict(zip(_SELECT_STATE, ts[:ns])))
        return _select_obs(cfg, st, kde_arr, grad_kde, bc, bcosts,
                           SelectConsts(*ts[ns:]))
    return stage_graph.run(
        "gpet.select", fn,
        [kde_arr, data.grad_kde, bc, bcosts]
        + [getattr(state, f) for f in _SELECT_STATE] + list(consts),
        _select_key(cfg), share=(0, 2, 3))


def _select_key(cfg: TracerConfig):
    """The configuration's scalars that the selection stage reads."""
    return (cfg.kde_thresh, cfg.legacy_simpson, cfg.N_keep, cfg.M, cfg.N,
            cfg.x_st, cfg.bins, cfg.fix_endpoints, cfg.pixel_thresh,
            cfg.algo_thresh, cfg.max_decays)


def _owned(state: TraceState) -> TraceState:
    """``state`` with a copy of each field that is a graph's output
    buffer (:func:`stage_graph.own`)."""
    return TraceState(*(stage_graph.own(v) for v in state))


def _lift(state: TraceState) -> TraceState:
    """One trace's state as a batch of one frame, its iteration count
    filled in on the device: no wait."""
    it = torch.full((1,), state.it, dtype=torch.int64,
                    device=state.obs_x.device)
    return TraceState(*(it if k == "it" else v[None]
                        for k, v in state._asdict().items()))


def _single(batch: TraceState, it: int) -> TraceState:
    """A batch of one frame as one trace's state at iteration ``it``, which
    the host knows: no read."""
    return TraceState(*(it if k == "it" else v[0]
                        for k, v in batch._asdict().items()))


def frame_of(batch, f: int):
    """Frame ``f`` of a batched :class:`TraceState` or :class:`TraceResult`
    as one trace's: ``it`` and ``n_iters`` as ints, ``converged`` a bool.
    A state's ``it`` lives on the device and is read in one
    :func:`to_host` of kind ``frame``; a result's ``n_iters`` and
    ``converged`` are host tensors already."""
    out = {k: v[f] for k, v in batch._asdict().items()}
    if "it" in out:
        out["it"] = int(to_host(out["it"], "frame"))
    else:
        out["n_iters"] = int(out["n_iters"])
        out["converged"] = bool(out["converged"])
    return type(batch)(**out)


def _iteration(cfg: TracerConfig, data: TracerData, state: TraceState, draws,
               k: int, invariants, shard=None, with_score=False):
    """One outer-loop iteration (gpet.py:829-861) of a batched state, at
    iteration ``k`` (where its active frames stand): sample from
    ``draws.normals(k)`` (:func:`_sample_stage`), score, rank, KDE, select,
    each stage in its span (``gpet.sample``, ``gpet.score``, ``gpet.kde``,
    ``gpet.select``) and once for all frames, on the card each replayed from
    its graph (``trace/stage_graph.py``); the caller keeps finished frames
    as they were. ``invariants``: :func:`loop_invariants`. Returns the new
    state and the (B, E, S) samples, and with ``with_score`` also copies of
    the (B, M, N) pixel scores the selection ranked (gpet.py:582) and of the
    KDE maps they were made from. On the card the samples and the new
    state's fields but ``user_x`` and ``user_y`` are graph buffers, which
    the next iteration's replays overwrite once its stages have copied them
    in: a caller that keeps them past that copies them (:func:`_owned`).

    With ``shard`` (a :class:`~..ops.collectives.SampleShard`; the
    reference's sample-axis arm, driver.py:372-429) the rank draws its
    columns of the iteration's normals, ``draws.normals(k, shard.cols)``:
    it samples and scores its ``shard.width`` curves, with K1 planned on
    the group's S and no transposed copy, and :func:`sharded_best_curves`
    ranks over the group (op by op). The KDE and the selection then run
    replicated on every rank."""
    blur, consts = invariants
    with span("gpet.sample"):
        samples = _sample_stage(cfg, data, state, draws, k,
                                () if shard is None else (shard.cols,))
    with span("gpet.score"):
        bc, bcosts = _score_stage(cfg, data, samples, shard)
    with span("gpet.kde"):
        kde_arr = _kde_stage(cfg, bc, bcosts, blur)
    with span("gpet.select"):
        *fields, score = _select_stage(cfg, data, state, kde_arr, bc, bcosts,
                                       consts)
        new_state = state._replace(**dict(zip(_SELECT_OUT, fields)))
    if with_score:
        return (new_state, samples, stage_graph.own(score),
                stage_graph.own(kde_arr))
    return new_state, samples


def optimize_lml(kernel: KernelSpec, xs, ys, mask, noise_w, starts, lb, ub,
                 jitter=1e-6, n_polish=8, polish_iters=4, use_batched=True):
    """Maximise the LML over θ = (log c, log ℓ, log σn²) within [lb, ub]
    (driver.py:467-552): one batched screen of the starts and a static
    grid, then a short damped-Newton polish. ``lb``/``ub`` are host tensors.
    Returns ``(theta, lml)``.

    ``use_batched`` (the default, on the card and on the CPU) sends every
    objective batch through :func:`batched_lml` (K5 + K6). Above
    ``_DIRECT_FIT_N`` training points it screens and polishes on a
    stride-subsampled set, then re-polishes the coarse optimum at full size.
    ``use_batched=False`` is the JAX package's path off the TPU: one fit,
    the LML through the library's Cholesky (:func:`library_lml`) and
    :func:`screen_and_polish` with ``torch.func`` derivatives.

    Frames (batched path only): (F, n) buffers fit F frames at once, each
    from ``starts`` ((T, 3) shared, or (F, T, 3)), with one objective batch
    per step for all of them; frames share n, so they all take the same
    branch."""
    dev = starts.device
    lead = xs.shape[:-1]
    starts = starts.expand(lead + starts.shape[-2:])
    grid = lml_screen_grid(lb, ub, dev)
    allstarts = torch.cat([starts, grid.expand(lead + grid.shape)], dim=-2)
    with profiling.wait("fit"):
        lb_d, ub_d = lb.to(dev), ub.to(dev)
    if not use_batched:
        if lead:
            raise ValueError("use_batched=False fits one training set")

        def neg_lml(th):
            # pd_guard=False: the polish sanitises NaN values itself.
            return -library_lml(kernel, xs, ys, mask, th, noise_w,
                                jitter=jitter, pd_guard=False)
        res = screen_and_polish(neg_lml, allstarts, lb_d, ub_d,
                                n_polish=n_polish, iters=polish_iters)
        return res.x, -res.f

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
    if xs.shape[-1] <= _DIRECT_FIT_N:
        res = screen_and_polish_batched(values_fn, vg_fn, allstarts, lb_d,
                                        ub_d, n_polish=n_polish,
                                        iters=polish_iters)
        return res.x, -res.f
    stride = -(-xs.shape[-1] // 112)
    vs_sub, vg_sub = fns(xs[..., ::stride], ys[..., ::stride],
                         mask[..., ::stride], noise_w[..., ::stride])
    coarse = screen_and_polish_batched(vs_sub, vg_sub, allstarts, lb_d, ub_d,
                                       n_polish=n_polish, iters=polish_iters)
    fine_starts = torch.stack([coarse.x, starts[..., 0, :]], dim=-2)
    res = screen_and_polish_batched(values_fn, vg_fn, fine_starts, lb_d, ub_d,
                                    n_polish=2,
                                    iters=max(polish_iters - 1, 2))
    return res.x, -res.f


def _final_fit_buffers(cfg: TracerConfig, data: TracerData, restarts_u, x,
                       y, mask, noise_w):
    """The converged fit on padded training buffers (gpet.py:233-266):
    standardise, maximise the LML from ``1 + lml_restarts`` starts, predict
    on the x grid. ``restarts_u`` are (lml_restarts, 3) uniforms in [0, 1)
    (or (F, lml_restarts, 3), one set per frame). Returns ``(y_mean, std,
    y_s, theta, lml)``; ``std`` is in standardised units. With (F, n)
    buffers every result has a leading frame axis, and a frame's bits do not
    depend on the number of frames (see ``models/gpr.py``)."""
    dev = x.device
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    xy = torch.stack([xf, yf])
    X_m, y_m = masked_mean(xy, mask, fixed_sum)
    X_s, y_s = masked_std(xy, mask, fixed_sum)
    # Zero-std guard for degenerate training sets (driver.py:575-581).
    X_s = torch.where(X_s == 0.0, torch.ones_like(X_s), X_s)
    y_s = torch.where(y_s == 0.0, torch.ones_like(y_s), y_s)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    xs = torch.where(mask, (xf - X_m[..., None]) / X_s[..., None], zero)
    ys = torch.where(mask, (yf - y_m[..., None]) / y_s[..., None], zero)

    # θ = (log c, log ℓ, log σn²); bounds gpet.py:246-248.
    lb = torch.log(torch.tensor([0.01, 0.1, 1e-18], dtype=torch.float32))
    ub = torch.log(torch.tensor([1e3, 100.0, 1.0], dtype=torch.float32))
    theta0 = torch.minimum(torch.maximum(torch.log(torch.tensor(
        [5.0, 5.0, cfg.noise_y], dtype=torch.float32)), lb), ub)
    with profiling.wait("fit"):
        lb_d, ub_d, theta0_d = lb.to(dev), ub.to(dev), theta0.to(dev)
    restarts = restarts_u.to(dev, torch.float32) * (ub_d - lb_d) + lb_d
    starts = torch.cat([theta0_d.expand(restarts.shape[:-2] + (1, 3)),
                        restarts], dim=-2)

    theta, lml = optimize_lml(cfg.kernel, xs, ys, mask, noise_w, starts, lb,
                              ub, jitter=cfg.gp_jitter)

    c, ls, noise = torch.exp(theta).unbind(-1)
    gp = gp_fit(cfg.kernel, xs, ys, ls, c,
                per_frame(noise, 1) * noise_w + cfg.gp_jitter, mask,
                centre=False)
    xq = (data.x_grid.to(torch.float32) - X_m[..., None]) / X_s[..., None]
    mean_std, std = gp_predict(cfg.kernel, gp, xq, ls, c, return_std=True)
    y_mean = y_s[..., None] * mean_std + y_m[..., None]     # gpet.py:266
    return y_mean, std, y_s, theta, lml


def sample_round_buffers(cfg: TracerConfig, data: TracerData, x, y, mask,
                         noise_w, draws=None, seed=0):
    """The sampling-mode GP round on explicit padded buffers (driver.py:
    609-616), behind ``GP_Edge_Tracing.fit_predict_GP(converged=False)``
    (gpet.py:182-261): (E, S) posterior curves. ``draws`` (a source with
    ``sample_normals(n)``) defaults to :class:`KeyDraws` of ``seed``."""
    if draws is None:
        draws = _key_draws(cfg, data, seed)
    z, w = draws.sample_normals(x.shape[-1])
    return _sample_round(cfg, data, x, y, mask, noise_w, z, w)


def final_fit_buffers(cfg: TracerConfig, data: TracerData, x, y, mask,
                      noise_w, draws=None, seed=0):
    """The converged LML fit on explicit padded buffers (driver.py:619-628),
    behind ``GP_Edge_Tracing.fit_predict_GP(converged=True)``
    (gpet.py:233-266): ``(y_mean, y_std)``, the std in standardised units
    (the reference's quirk). ``draws`` (a source with ``restarts()``)
    defaults to :class:`KeyDraws` of ``seed``."""
    if draws is None:
        draws = _key_draws(cfg, data, seed)
    y_mean, y_std, _, _, _ = _final_fit_buffers(cfg, data, draws.restarts(),
                                                x, y, mask, noise_w)
    return y_mean, y_std


def preview_samples(cfg: TracerConfig, data: TracerData, state: TraceState,
                    draws=None):
    """Curves of the initial posterior (gpet.py:806:
    ``fit_predict_GP(self.obs, converged=False, seed=0)``): the sampling
    round on ``state``'s training set, from the literal seed 0 whatever the
    config's seed (:class:`KeyDraws` of seed 0 by default)."""
    x, y, mask, noise_w = _train_set(cfg, data, state)
    return sample_round_buffers(cfg, data, x, y, mask, noise_w,
                                draws=draws, seed=0)


def loop_invariants(cfg: TracerConfig, data: TracerData):
    """The loop's invariants, built once per trace: the KDE's blur factors
    (:func:`blur_matrices`) and the selection's constants
    (:func:`select_consts`)."""
    dev = data.grad_kde.device
    return (blur_matrices(cfg.M, cfg.N, data.grad_kde.dtype, dev),
            select_consts(cfg.bins, cfg.N, cfg.max_decays, dev))


def trace_step(cfg: TracerConfig, data: TracerData, state: TraceState,
               draws=None, invariants=None):
    """One outer iteration of one trace (driver.py:699-706): ``(state,
    samples)``, the (E, S) curves it drew. It draws ``draws.normals(it)``
    (:class:`StreamDraws` by default), so stepping a state to the end of
    the loop and calling :func:`finish_trace` gives :func:`run_trace`'s
    result bit for bit. A caller that steps a whole trace builds
    :func:`loop_invariants` once and passes them. The state goes in as a
    batch of one and comes out with no wait; it and the curves are the
    caller's own, not the stages' graph buffers."""
    if not isinstance(state.it, int):
        raise ValueError("trace_step steps one trace; trace_batch steps "
                         "frames")
    if draws is None:
        draws = _default_draws(cfg, data)
    new, samples = _iteration(cfg, data, _lift(state), draws, state.it,
                              invariants or loop_invariants(cfg, data))
    return _single(_owned(new), state.it + 1), samples[0].clone()


def finish_trace(cfg: TracerConfig, data: TracerData, state: TraceState,
                 draws) -> TraceResult:
    """Post-loop finalisation (gpet.py:874-890), in the span
    ``gpet.finish``: the converged LML fit, the credible interval, the yx
    trace and the final mean curve's cost. A batched state is finished in
    one fit for all frames, with one host read for their ``n_iters`` and
    ``converged``; one trace's as a batch of one."""
    if isinstance(state.it, int):
        return frame_of(finish_trace(cfg, data, _lift(state), draws), 0)
    with span("gpet.finish"):
        x, y, mask, noise_w = _train_set(cfg, data, state)
        y_mean, y_std_s, y_s, theta, lml = _final_fit_buffers(
            cfg, data, draws.restarts(), x, y, mask, noise_w)
        # Reference quirk: the interval and y_std keep the standardised-y std
        # (gpet.py:266); with reference_quirks=False both are in pixels.
        y_std_px = y_s[..., None] * y_std_s
        y_std = y_std_s if cfg.reference_quirks else y_std_px
        cred = torch.stack([y_mean - 1.96 * y_std, y_mean + 1.96 * y_std],
                           dim=-2)
        cred_px = torch.stack([y_mean - 1.96 * y_std_px,
                               y_mean + 1.96 * y_std_px], dim=-2)
        edge_trace = torch.stack([torch.round(y_mean).to(torch.int64),
                                  data.x_grid.expand(y_mean.shape)], dim=-1)
        final_cost = curve_costs(data.grad_cols, y_mean[..., None],
                                 kde_thresh=cfg.kde_thresh,
                                 even=_even(cfg))[..., 0]
        host = to_host(torch.stack([state.it, (
            state.n_fobs >= cfg.algo_thresh).to(torch.int64)]), "finish")
        return TraceResult(
            edge_trace=edge_trace, y_mean=y_mean, y_std=y_std,
            cred_interval=cred, cred_interval_px=cred_px, n_iters=host[0],
            converged=host[1].to(torch.bool), theta=theta, lml=lml,
            final_cost=final_cost, iter_curves=state.iter_curves,
            iter_costs=state.iter_costs, iter_nobs=state.iter_nobs,
            iter_thresh=state.iter_thresh,
            obs_x=torch.cat([state.user_x, state.obs_x], dim=-1),
            obs_y=torch.cat([state.user_y, state.obs_y], dim=-1),
            obs_valid=torch.cat([state.user_valid, state.obs_valid], dim=-1))


def _active(cfg: TracerConfig, state: TraceState):
    """(B,) the frames the loop still steps (driver.py:687-688)."""
    return (state.n_fobs < cfg.algo_thresh) & (state.it < cfg.max_iters)


def _keep_finished(active, new: TraceState, old: TraceState) -> TraceState:
    """``new`` for the active frames, ``old`` for the others."""
    return TraceState(*(
        torch.where(active.reshape(active.shape + (1,) * (n.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def run_loop(cfg: TracerConfig, data: TracerData, state0: TraceState,
             draws=None, shard=None) -> TraceState:
    """The outer loop alone: iterate while ``n_fobs < algo_thresh`` and
    ``it < max_iters`` (driver.py:687-688), one device read per
    iteration. With a batched state it steps all frames while any is
    active, one read of the (B,) active mask per iteration, and keeps each
    finished frame's state as it was (the JAX package's vmapped
    ``while_loop``). The active frames must stand at one iteration. Each
    iteration, its active-mask read included, runs in the span
    ``gpet.iter``. ``shard``: the sample arm of :func:`_iteration`; the
    rank draws its columns ``draws.normals(it, shard.cols)``. One trace's
    state runs as a batch of one and comes back at the iteration the host
    counted. The state that comes back owns its memory."""
    one = isinstance(state0.it, int)
    state = _lift(state0) if one else state0
    if draws is None:
        draws = _default_draws(cfg, data)
    invariants = loop_invariants(cfg, data)
    active = _active(cfg, state)
    at = set(to_host(torch.where(active, state.it, -1), "active").tolist()) \
        - {-1}
    if len(at) > 1:
        raise ValueError(f"the active frames stand at iterations "
                         f"{sorted(at)}; a batch steps them together")
    k0 = k = at.pop() if at else cfg.max_iters
    # A lone frame is active whenever the loop steps it: nothing to keep.
    lone = state.it.shape[0] == 1
    while k < cfg.max_iters:
        with span("gpet.iter"):
            new, _ = _iteration(cfg, data, state, draws, k,
                                invariants=invariants, shard=shard)
            state = new if lone else _keep_finished(active, new, state)
            active = _active(cfg, state)
            k += 1
            if not bool(to_host(active.any(), "active")):
                break
    # A lone frame's state is the selection graph's buffers: copied out.
    state = _owned(state) if lone else state
    return _single(state, state0.it + k - k0) if one else state


def run_trace(cfg: TracerConfig, data: TracerData, state0: TraceState,
              draws=None, shard=None) -> TraceResult:
    """The full trace (gpet.py:768-908): the outer loop, then
    :func:`finish_trace`; for one trace (as a batch of one, frame 0 of the
    result) or, with a batched state, for every frame. ``draws`` defaults
    to :class:`StreamDraws`; ``shard``: see :func:`run_loop` (the final
    fit runs whole on every rank). In the span ``gpet.run_trace``."""
    with span("gpet.run_trace"):
        if draws is None:
            draws = _default_draws(cfg, data)
        one = isinstance(state0.it, int)
        state = run_loop(cfg, data, _lift(state0) if one else state0, draws,
                         shard)
        res = finish_trace(cfg, data, state, draws)
        return frame_of(res, 0) if one else res
