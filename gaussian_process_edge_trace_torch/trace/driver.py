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

Frames: every stage takes an optional leading frame axis, and the loop runs
B traces at once (``parallel/sharded.py`` builds the batched data and
states): each stage launches once per iteration for all frames. The loop
keeps the semantics of the JAX package's vmapped ``while_loop``: it runs
while any frame is active, reading the (B,) active mask once per iteration,
and a frame that has finished keeps its state unchanged. A single trace is
the case B = 1. In a batched :class:`TraceState` ``it`` is a (B,) int64
tensor; every frame that is still active stands at the same iteration.

Random numbers come from a draw source (:class:`TorchDraws` by default): the
normals of iteration ``it`` and the uniforms of the final fit's restarts. A
caller may pass another source with the same two methods, for instance one
that replays the JAX package's draws. A batch's frames share one source,
as the JAX package's frames share one key; sources whose draws carry a
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
    batched_lml, fit_and_sample, fixed_sum, gp_fit, gp_predict, library_lml,
    masked_mean, masked_std)
from gaussian_process_edge_trace_torch.models.kernels import (
    KernelSpec, k_unit_np, per_frame, resolve_kernel_options)
from gaussian_process_edge_trace_torch.models.newton import (
    lml_screen_grid, screen_and_polish, screen_and_polish_batched)
from gaussian_process_edge_trace_torch.trace.kde import (
    blur_matrices, curve_kde, gradient_kde)
from gaussian_process_edge_trace_torch.trace.scoring import (
    best_curves, curve_costs, sharded_best_curves)
from gaussian_process_edge_trace_torch.trace.select import (
    BinSpec, make_bin_spec, select_consts, select_pixels)
from gaussian_process_edge_trace_torch.utils.image import normalise

# Relative eigenvalue threshold of the truncated prior factor.
_PRIOR_RANK_RTOL = 1e-8

# Largest training set the batched LML fit screens at full size; above it
# the fit goes coarse-to-fine (driver.py:518-552).
_DIRECT_FIT_N = 160

# Reads of device values by the host: the loop's active mask (once before
# the first iteration and once after each), finish_trace's n_iters and
# converged, and the introspective tracer's reads (:func:`to_host`) of the
# state (once before the first iteration and once after each) and of each
# iteration's samples. HOST_BYTES counts the bytes that ``to_host`` copies.
HOST_READS = {"active": 0, "finish": 0, "state": 0, "samples": 0}
HOST_BYTES = {"state": 0, "samples": 0}


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
    device = resolve_device(device, grad_img, init_xy)
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


def make_data(cfg: TracerConfig, grad_img, init_xy,
              device=None) -> TracerData:
    """Precompute the per-image tensors (gpet.py:97,122-127) on ``device``,
    by default that of a tensor input, else the card."""
    device = resolve_device(device, grad_img, init_xy)
    g, gkde, gcols, ix, iy = frame_arrays(cfg, grad_img, init_xy, device)
    return TracerData(
        grad_img=g, grad_kde=gkde, grad_cols=gcols,
        L_prior_unit=torch.tensor(prior_factor(cfg), device=device),
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
        n_fobs = torch.tensor(U, **i64)
    else:
        valid = torch.as_tensor(user_obs_valid, dtype=torch.bool,
                                device=device)
        if valid.shape != (U,):
            raise ValueError(f"user_obs_valid of shape {tuple(valid.shape)} "
                             f"for {U} warm-start observations")
        n_fobs = valid.sum(dtype=torch.int64)
    return TraceState(
        obs_x=torch.zeros(B, **i64), obs_y=torch.zeros(B, **i64),
        obs_valid=torch.zeros(B, dtype=torch.bool, device=device),
        user_x=user[:, 0].contiguous(), user_y=user[:, 1].contiguous(),
        user_valid=valid, score_thresh=torch.tensor(cfg.score_thresh0, **f32),
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


# The default draw layout. A stream is (tracer seed s, ensemble member m,
# slot t): t = it + 1 for the normals of iteration it (the reference's
# ``fold_in(key, it+1)``, gpet.py:839), 0 for the final fit's restarts, and
# the last slot of a packing for :class:`SeedDraws`. Streams with
# 0 <= s < 2¹⁶, 0 <= m < 64 and t < 1024 take the 32-bit generator seed
# s·2¹⁶ + m·2¹⁰ + t, within the bits the CPU generator keeps of a seed
# (seeds 2³² apart give it the same normals). Any other stream takes the
# 64-bit seed (s + 1)·2³² + m·2¹⁶ + t, for s < 2³¹, m < 2¹⁶ and t < 2¹⁶,
# which only a generator that keeps all 64 bits tells apart: the card's
# Philox. Each packing is injective, and the second lies at 2³² and above,
# so no two streams share a generator seed.
_MEMBER_BITS = 6
_SLOT_BITS = 10
_WIDE_BITS = 16

# SeedDraws' slot in each packing: iterations take slots 1..max_iters below
# it and the restarts slot 0, so it is never a trace's.
SEED_SLOT = 2 ** _SLOT_BITS - 1
WIDE_SEED_SLOT = 2 ** _WIDE_BITS - 1


def _stream_seed(s: int, m: int, t: int, seed_slot: bool = False) -> int:
    """The generator seed of stream (s, m, t): the 32-bit packing where the
    stream fits it, else the 64-bit one. Trace streams take slots below
    ``SEED_SLOT`` in the first; ``seed_slot`` asks for SeedDraws' slot."""
    narrow = (s < 2 ** (32 - _MEMBER_BITS - _SLOT_BITS)
              and m < 2 ** _MEMBER_BITS and t < SEED_SLOT)
    if seed_slot:
        t = SEED_SLOT if narrow else WIDE_SEED_SLOT
    if narrow:
        return (s << (_MEMBER_BITS + _SLOT_BITS)) + (m << _SLOT_BITS) + t
    return ((s + 1) << 32) + (m << _WIDE_BITS) + t


def _check_streams(device, s: int, m: int, last_slot: int):
    """Raise unless the streams (s, m, 0..last_slot) each have a generator
    seed of their own on ``device``: within the 64-bit packing's limits, and
    within the 32-bit one's where the generator keeps only 32 bits of a
    seed (every generator but the card's)."""
    if not 0 <= s < 2 ** 31:
        raise ValueError(f"tracer seed {s} outside [0, 2**31)")
    if not 0 <= m < 2 ** _WIDE_BITS:
        raise ValueError(f"member {m} outside [0, 2**{_WIDE_BITS})")
    if last_slot >= WIDE_SEED_SLOT:
        raise ValueError(f"max_iters {last_slot} above "
                         f"{WIDE_SEED_SLOT - 1}, the layout's slot limit")
    if torch.device(device).type == "cuda":
        return
    over = [msg for bad, msg in (
        (s >= 2 ** 16, f"tracer seed {s} outside [0, 2**16)"),
        (m >= 2 ** _MEMBER_BITS, f"member {m} outside [0, 64)"),
        (last_slot >= SEED_SLOT, f"max_iters {last_slot} above "
                                 f"{SEED_SLOT - 1}")) if bad]
    if over:
        raise ValueError(
            f"{'; '.join(over)}: the generator on "
            f"{torch.device(device)} keeps 32 bits of a seed, and these "
            f"streams would share their normals with others (the card's "
            f"generator takes them)")


class TorchDraws:
    """The default draw source: ``torch.Generator``s on ``device``, one
    generator seed per stream.

    Tracer seed ``s``, ensemble member ``m`` and slot ``t`` (``it + 1`` for
    the normals of iteration ``it``, the reference's ``fold_in(key,
    it+1)``, gpet.py:839; 0 for the final fit's restarts) pack into the
    32-bit generator seed ``s·2¹⁶ + m·2¹⁰ + t`` for s < 2¹⁶, m < 64 and
    t <= 1022, and into the 64-bit ``(s + 1)·2³² + m·2¹⁶ + t`` otherwise,
    for s < 2³¹, m < 2¹⁶ and ``max_iters`` <= 2¹⁶ - 2. No two (seed,
    member, iteration-or-restart) streams share a generator seed, so seed
    s + 1 does not replay seed s's normals, no two members of an ensemble
    share a stream, and member 0 is the single trace's source. A stream's
    seed does not depend on ``max_iters``. The CPU generator keeps 32 bits
    of a seed, so there the source raises for a tracer seed of 2¹⁶ or
    more, a member of 64 or more or ``max_iters`` above 1022, rather than
    give two streams one seed; the card's generator takes both packings.

    ``normals(it, cols)`` hands out columns ``cols`` of the iteration's
    full (r, S) and (n_train, S) draws: a rank that holds samples
    [off, off + S/k) of a sample group takes ``slice(off, off + S/k)``,
    so every sample draws the numbers it draws on one device (the
    reference's stream-slicing contract, gpr.py:189-200)."""

    def __init__(self, cfg: TracerConfig, rank: int, device, member=0):
        self.cfg, self.rank = cfg, rank
        self.device = torch.device(device)
        self.seed, self.member = int(cfg.seed), int(member)
        _check_streams(self.device, self.seed, self.member, cfg.max_iters)

    def _gen(self, seed):
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def iteration_seed(self, it: int) -> int:
        return _stream_seed(self.seed, self.member, it + 1)

    def restart_seed(self) -> int:
        return _stream_seed(self.seed, self.member, 0)

    def normals(self, it: int, cols=slice(None)):
        """(z (r, S), w (n_train, S)) standard normals of iteration ``it``,
        or their columns ``cols``."""
        g = self._gen(self.iteration_seed(it))
        S = self.cfg.N_samples
        z = torch.randn((self.rank, S), generator=g, device=self.device)
        w = torch.randn((self.cfg.n_train, S), generator=g,
                        device=self.device)
        return z[:, cols], w[:, cols]

    def restarts(self):
        """(lml_restarts, 3) uniforms in [0, 1) for the final fit."""
        return torch.rand((self.cfg.lml_restarts, 3),
                          generator=self._gen(self.restart_seed()),
                          device=self.device)


class FrameDraws:
    """Draw sources of their own for each frame, as one source: the normals
    and restart uniforms of every frame's source stacked on a leading axis
    ((B, r, S), (B, n_train, S), (B, lml_restarts, 3)); ``normals(it,
    cols)`` passes the columns on."""

    def __init__(self, sources):
        self.sources = list(sources)

    def normals(self, it: int, *cols):
        z, w = zip(*(src.normals(it, *cols) for src in self.sources))
        return torch.stack(z), torch.stack(w)

    def restarts(self):
        return torch.stack([src.restarts() for src in self.sources])


class SeedDraws:
    """The draws of one unfolded seed: the reference's ``PRNGKey(seed)``
    taken without a fold, as ``fit_predict_GP(seed=k)`` and
    ``preview_samples`` take it (models/tracer.py:159, driver.py:719).

    One generator seed, member 0's ``SEED_SLOT`` (1023) of tracer seed
    ``seed`` in :class:`TorchDraws`' 32-bit packing for seed < 2¹⁶, its
    ``WIDE_SEED_SLOT`` in the 64-bit one above (the card only, for
    seed < 2³¹): slots that no trace stream uses. ``sample_normals(n)``
    gives the sampling round's (z (r, S), w (n, S)) for a training buffer
    of ``n`` slots, and ``restarts()`` the final fit's (lml_restarts, 3)
    uniforms, both from that generator seed, as the reference draws both
    from one key."""

    def __init__(self, cfg: TracerConfig, rank: int, device, seed=0):
        self.cfg, self.rank = cfg, rank
        self.device = torch.device(device)
        _check_streams(self.device, int(seed), 0, 0)
        self.seed = _stream_seed(int(seed), 0, 0, seed_slot=True)

    def _gen(self):
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g

    def sample_normals(self, n: int):
        g = self._gen()
        S = self.cfg.N_samples
        z = torch.randn((self.rank, S), generator=g, device=self.device)
        w = torch.randn((n, S), generator=g, device=self.device)
        return z, w

    def restarts(self):
        return torch.rand((self.cfg.lml_restarts, 3), generator=self._gen(),
                          device=self.device)


def _default_draws(cfg: TracerConfig, data: TracerData) -> TorchDraws:
    return TorchDraws(cfg, data.L_prior_unit.shape[1], data.grad_img.device)


def _seed_draws(cfg: TracerConfig, data: TracerData, seed) -> SeedDraws:
    return SeedDraws(cfg, data.L_prior_unit.shape[1], data.grad_img.device,
                     seed)


def to_host(tree, kind: str):
    """``tree`` (a tensor, or a NamedTuple of tensors and host values) on
    the CPU, copied with one wait for the device, counted as one read of
    ``kind`` in :data:`HOST_READS` and its bytes in :data:`HOST_BYTES`."""
    one = isinstance(tree, torch.Tensor)
    items = [tree] if one else list(tree)
    out = [v.to("cpu", non_blocking=True) if isinstance(v, torch.Tensor)
           else v for v in items]
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in items):
        torch.cuda.current_stream().synchronize()
    HOST_READS[kind] += 1
    HOST_BYTES[kind] += sum(v.numel() * v.element_size() for v in out
                            if isinstance(v, torch.Tensor))
    return out[0] if one else type(tree)(*out)


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
        cfg.kernel, x.to(torch.float32), yf / y_s[..., None], cfg.sigma_l,
        variance, diag_noise, mask, data.L_prior_unit, x_idx=x,
        grid_out=data.x_grid, z=z, w=w, centre=True, post_scale=post_scale)
    return samples * per_frame(y_s)                         # (..., E, S)


def _lift(state: TraceState) -> TraceState:
    """One trace's state as a batch of one frame."""
    return TraceState(*(
        torch.tensor([v], dtype=torch.int64, device=state.obs_x.device)
        if k == "it" else v[None] for k, v in state._asdict().items()))


def frame_of(batch, f: int):
    """Frame ``f`` of a batched :class:`TraceState` or :class:`TraceResult`
    as one trace's: ``it`` and ``n_iters`` as ints, ``converged`` a bool."""
    cast = {"it": int, "n_iters": int, "converged": bool}
    return type(batch)(**{k: cast[k](v[f]) if k in cast else v[f]
                          for k, v in batch._asdict().items()})


def _iteration(cfg: TracerConfig, data: TracerData, state: TraceState, z, w,
               blur=None, consts=None, k=None, with_score=False, shard=None):
    """One outer-loop iteration (gpet.py:829-861): sample, score, rank,
    KDE, select. Returns the new state and the (E, S) samples, and with
    ``with_score`` also the (M, N) pixel scores the selection ranked
    (gpet.py:582).

    With ``shard`` (a :class:`~..ops.collectives.SampleShard`; the
    reference's sample-axis arm, driver.py:372-429) ``z`` and ``w`` are the
    rank's columns of the iteration's draws: it samples and scores its
    ``shard.width`` curves, with K1 planned on the group's S and no
    transposed copy, and :func:`sharded_best_curves` ranks over the group.
    The KDE and the selection then run replicated on every rank.

    A batched state (``it`` a tensor) steps every frame, each stage once
    for all of them, and writes the telemetry of iteration ``k``, at which
    its active frames stand; the caller keeps finished frames as they
    were."""
    one = isinstance(state.it, int)
    if one:
        state, k = _lift(state), state.it
    x, y, mask, noise_w = _train_set(cfg, data, state)
    samples = _sample_round(cfg, data, x, y, mask, noise_w, z, w)
    even = "avg" if cfg.legacy_simpson else "simpson"
    if shard is None:
        costs, samples_t = curve_costs(
            data.grad_cols, samples, kde_thresh=cfg.kde_thresh, even=even,
            return_samples_t=True)
        bc, bcosts = best_curves(samples, costs, cfg.N_keep,
                                 samples_t=samples_t)
    else:
        costs = curve_costs(data.grad_cols, samples,
                            kde_thresh=cfg.kde_thresh, even=even,
                            plan_samples=cfg.N_samples)
        bc, bcosts = sharded_best_curves(samples, costs, cfg.N_keep, shard)
    inv = 1.0 / bcosts
    weights = inv / inv.sum(-1, keepdim=True)               # gpet.py:492-493
    kde_arr = curve_kde(bc, weights, cfg.M, cfg.N, cfg.x_st, blur=blur)

    sel = select_pixels(
        kde_arr, data.grad_kde,
        torch.cat([state.user_x, state.obs_x], dim=-1),
        torch.cat([state.user_y, state.obs_y], dim=-1),
        torch.cat([state.user_valid, state.obs_valid], dim=-1),
        n_pre=state.n_fobs, score_thresh=state.score_thresh, spec=cfg.bins,
        fix_endpoints=cfg.fix_endpoints, kde_thresh=cfg.kde_thresh,
        pixel_thresh=cfg.pixel_thresh, algo_thresh=cfg.algo_thresh,
        max_decays=cfg.max_decays, consts=consts)

    def put(buf, v):
        buf = buf.clone()
        buf[:, k] = v
        return buf

    new_state = TraceState(
        obs_x=sel.obs_x, obs_y=sel.obs_y, obs_valid=sel.obs_valid,
        user_x=state.user_x, user_y=state.user_y,
        user_valid=torch.zeros_like(state.user_valid),  # first iteration only
        score_thresh=sel.score_thresh, n_fobs=sel.n_fobs, it=state.it + 1,
        iter_curves=put(state.iter_curves, bc[..., 0]),
        iter_costs=put(state.iter_costs, bcosts[..., 0]),
        iter_nobs=put(state.iter_nobs, sel.n_fobs),
        iter_thresh=put(state.iter_thresh, sel.score_thresh))
    if one:
        new_state, samples = frame_of(new_state, 0), samples[0]
        score = sel.score[0]
    else:
        score = sel.score
    return (new_state, samples, score) if with_score else (new_state, samples)


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
    lb_d, ub_d = lb.to(dev), ub.to(dev)
    restarts = restarts_u.to(dev, torch.float32) * (ub_d - lb_d) + lb_d
    starts = torch.cat([theta0.to(dev).expand(restarts.shape[:-2] + (1, 3)),
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
    ``sample_normals(n)``) defaults to :class:`SeedDraws` of ``seed``."""
    if draws is None:
        draws = _seed_draws(cfg, data, seed)
    z, w = draws.sample_normals(x.shape[-1])
    return _sample_round(cfg, data, x, y, mask, noise_w, z, w)


def final_fit_buffers(cfg: TracerConfig, data: TracerData, x, y, mask,
                      noise_w, draws=None, seed=0):
    """The converged LML fit on explicit padded buffers (driver.py:619-628),
    behind ``GP_Edge_Tracing.fit_predict_GP(converged=True)``
    (gpet.py:233-266): ``(y_mean, y_std)``, the std in standardised units
    (the reference's quirk). ``draws`` (a source with ``restarts()``)
    defaults to :class:`SeedDraws` of ``seed``."""
    if draws is None:
        draws = _seed_draws(cfg, data, seed)
    y_mean, y_std, _, _, _ = _final_fit_buffers(cfg, data, draws.restarts(),
                                                x, y, mask, noise_w)
    return y_mean, y_std


def preview_samples(cfg: TracerConfig, data: TracerData, state: TraceState,
                    draws=None):
    """Curves of the initial posterior (gpet.py:806:
    ``fit_predict_GP(self.obs, converged=False, seed=0)``): the sampling
    round on ``state``'s training set, from the literal seed 0 whatever the
    config's seed (:class:`SeedDraws` of seed 0 by default)."""
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
    (:class:`TorchDraws` by default), so stepping a state to the end of
    the loop and calling :func:`finish_trace` gives :func:`run_trace`'s
    result bit for bit. A caller that steps a whole trace builds
    :func:`loop_invariants` once and passes them."""
    if not isinstance(state.it, int):
        raise ValueError("trace_step steps one trace; trace_batch steps "
                         "frames")
    if draws is None:
        draws = _default_draws(cfg, data)
    blur, consts = invariants or loop_invariants(cfg, data)
    z, w = draws.normals(state.it)
    return _iteration(cfg, data, state, z, w, blur=blur, consts=consts)


def finish_trace(cfg: TracerConfig, data: TracerData, state: TraceState,
                 draws) -> TraceResult:
    """Post-loop finalisation (gpet.py:874-890): the converged LML fit, the
    credible interval, the yx trace and the final mean curve's cost. A
    batched state is finished in one fit for all frames, with one host read
    for their ``n_iters`` and ``converged``."""
    if isinstance(state.it, int):
        return frame_of(finish_trace(cfg, data, _lift(state), draws), 0)
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
                             even="avg" if cfg.legacy_simpson
                             else "simpson")[..., 0]
    host = torch.stack([state.it, (state.n_fobs >= cfg.algo_thresh).to(
        torch.int64)]).cpu()                                # one read
    HOST_READS["finish"] += 1
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
    ``while_loop``). The active frames must stand at one iteration.
    ``shard``: the sample arm of :func:`_iteration`; the rank draws its
    columns ``draws.normals(it, shard.cols)``."""
    if isinstance(state0.it, int):
        return frame_of(run_loop(cfg, data, _lift(state0), draws, shard), 0)
    if draws is None:
        draws = _default_draws(cfg, data)
    blur, consts = loop_invariants(cfg, data)
    cols = () if shard is None else (shard.cols,)
    state = state0
    active = _active(cfg, state)
    at = set(torch.where(active, state.it, -1).tolist()) - {-1}
    HOST_READS["active"] += 1
    if len(at) > 1:
        raise ValueError(f"the active frames stand at iterations "
                         f"{sorted(at)}; a batch steps them together")
    k = at.pop() if at else cfg.max_iters
    # A lone frame is active whenever the loop steps it: nothing to keep.
    lone = state.it.shape[0] == 1
    while k < cfg.max_iters:
        z, w = draws.normals(k, *cols)
        new, _ = _iteration(cfg, data, state, z, w, blur=blur,
                            consts=consts, k=k, shard=shard)
        state = new if lone else _keep_finished(active, new, state)
        active = _active(cfg, state)
        HOST_READS["active"] += 1
        k = k + 1 if bool(active.any()) else cfg.max_iters
    return state


def run_trace(cfg: TracerConfig, data: TracerData, state0: TraceState,
              draws=None, shard=None) -> TraceResult:
    """The full trace (gpet.py:768-908): the outer loop, then
    :func:`finish_trace`; for one trace or, with a batched state, for every
    frame. ``draws`` defaults to :class:`TorchDraws`; ``shard``: see
    :func:`run_loop` (the final fit runs whole on every rank)."""
    if draws is None:
        draws = _default_draws(cfg, data)
    state = run_loop(cfg, data, state0, draws, shard)
    return finish_trace(cfg, data, state, draws)
