"""Batched serving on one device: B traces share one host loop.

Port of ``gaussian_process_edge_trace_tpu/parallel/sharded.py``, its
single-device serving modes. The JAX package vmaps whole traces; here the
frames are a leading axis of the driver's tensors (``trace/driver.py``),
and each stage of an iteration launches once for all of them:

- :func:`make_batch_data` / :func:`make_batch_state` — per-frame data and
  initial states with a leading frame axis (the prior factor is shared);
- :func:`trace_batch` — B independent frames, the counterpart of
  ``trace_batch_vmap``;
- :func:`trace_ensemble` — best-of-K seeds on one image;
- :func:`trace_multi_edge` — F edges of one image, its arrays computed once
  and shared.

Not ported yet: ``sharded_trace_batch`` (frames and samples over a device
mesh) and ``trace_sequence``. The JAX package's ``_BATCH_TILE`` is a TPU
layout choice and has no counterpart: a batch runs whole.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_process_edge_trace_torch.trace.driver import (
    FrameDraws, TorchDraws, TraceResult, TracerConfig, TracerData,
    TraceState, frame_arrays, frame_of, init_state, prior_factor, run_trace)


def _device(x, device):
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cuda")


def _shared_leaves(cfg: TracerConfig, device):
    """The prior factor and x grid: they depend on the config alone."""
    return (torch.tensor(prior_factor(cfg), device=device),
            cfg.x_st + torch.arange(cfg.edge_length, device=device))


def make_batch_data(cfg: TracerConfig, grad_imgs, inits,
                    device=None) -> TracerData:
    """:class:`TracerData` of B frames (sharded.py:50): each frame's
    :func:`frame_arrays` with a leading frame axis; the prior factor and x
    grid are shared. ``grad_imgs`` (B, M, N) and ``inits`` (B, n, 2) in
    xy-space; ``device`` defaults to that of a tensor input, else the
    card."""
    device = _device(grad_imgs, device)
    per = [frame_arrays(cfg, g, i, device) for g, i in zip(grad_imgs, inits)]
    g, gkde, gcols, ix, iy = (torch.stack(leaf) for leaf in zip(*per))
    L_unit, x_grid = _shared_leaves(cfg, device)
    return TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                      L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                      init_y=iy)


def make_batch_state(cfg: TracerConfig, n_frames: int, device,
                     user_obs_xy=None) -> TraceState:
    """Initial states of ``n_frames`` traces (sharded.py:170), stacked;
    ``user_obs_xy`` is None or an (F, U, 2) warm-start array."""
    states = [init_state(cfg, device, None if user_obs_xy is None
                         else user_obs_xy[f]) for f in range(n_frames)]
    return TraceState(*(
        torch.zeros(n_frames, dtype=torch.int64, device=device)
        if k == "it" else torch.stack([getattr(s, k) for s in states])
        for k in TraceState._fields))


def trace_batch(cfg: TracerConfig, data: TracerData, states0: TraceState,
                draws=None) -> TraceResult:
    """B complete traces in one host loop, the counterpart of the JAX
    package's ``trace_batch_vmap`` (sharded.py:324): each stage of an
    iteration launches once for all frames, the loop runs while any frame
    is active and a finished frame stays as it was. Every frame draws from
    the config's seed, as each frame of the JAX batch draws from
    ``PRNGKey(cfg.seed)``, so one ``draws`` source serves them all.
    Returns a :class:`TraceResult` with a leading frame axis
    (:func:`~..trace.driver.frame_of` takes one frame out)."""
    return run_trace(cfg, data, states0, draws)


def trace_ensemble(cfg: TracerConfig, data: TracerData, state0: TraceState,
                   n_seeds: int = 5, return_all: bool = False, draws=None):
    """Best-of-``n_seeds`` trace of one image (sharded.py:101-136): member
    k is one frame of a batch over the image's data, which every member
    shares (``state0`` is broadcast, not copied), and the member with the
    lowest ``final_cost`` is kept; a NaN cost counts as +inf.

    ``draws``: one draw source per member. By default member k is
    :class:`TorchDraws` with ``member=k``: member 0 draws what the single
    trace draws, and no two members' streams share a seed (a plain
    ``seed + k``, the JAX package's member key, would replay member 0's
    normals k iterations later in the port's seeding). Returns the
    chosen member as one trace's :class:`TraceResult`, or with
    ``return_all`` the pair ``(chosen, all)``, ``all`` with a leading
    member axis."""
    if n_seeds < 1:
        raise ValueError(f"n_seeds must be >= 1, got {n_seeds}")
    if draws is None:
        rank, dev = data.L_prior_unit.shape[1], data.grad_img.device
        draws = [TorchDraws(cfg, rank, dev, member=k) for k in range(n_seeds)]
    if len(draws) != n_seeds:
        raise ValueError(f"{len(draws)} draw sources for {n_seeds} members")
    states = TraceState(*(
        torch.full((n_seeds,), v, dtype=torch.int64, device=data.x_grid.device)
        if k == "it" else v.expand((n_seeds,) + v.shape)
        for k, v in state0._asdict().items()))
    results = run_trace(cfg, data, states, FrameDraws(draws))
    costs = results.final_cost
    best = int(torch.argmin(torch.where(torch.isnan(costs),
                                        torch.full_like(costs, torch.inf),
                                        costs)))
    chosen = frame_of(results, best)
    return (chosen, results) if return_all else chosen


def _sorted_edge_inits(inits, device):
    """Per-edge init sort by x (gpet.py:95), batched (sharded.py:64-73):
    (F, n, 2) -> ((F, n) init_x, (F, n) init_y)."""
    inits = torch.as_tensor(np.asarray(inits), dtype=torch.int64,
                            device=device)
    if inits.dim() != 3:
        raise ValueError(f"inits must be (F, n_inits, 2); got shape "
                         f"{tuple(inits.shape)}")
    order = torch.argsort(inits[:, :, 0], dim=1, stable=True)
    s = torch.take_along_dim(inits, order[:, :, None], dim=1)
    return s[..., 0].contiguous(), s[..., 1].contiguous()


def trace_multi_edge(cfg: TracerConfig, grad_img, inits, user_obs_xy=None,
                     device=None, draws=None) -> TraceResult:
    """F edges of one image in one batch (sharded.py:139-167): the image's
    arrays (normalised gradient, its KDE, the columns along the x grid) are
    computed once and every edge reads the same copy, which K1 and K2 take
    with a frame stride of 0; the edges' inits and states are per frame.
    Equal to a :func:`trace_batch` of the image tiled F times.

    Args:
      grad_img: (M, N) gradient image, shared by every edge.
      inits: (F, n_inits, 2) per-edge init points in xy-space.
      user_obs_xy: optional (F, U, 2) warm-start observations.
    """
    device = _device(grad_img, device)
    ix, iy = _sorted_edge_inits(inits, device)
    g, gkde, gcols, _, _ = frame_arrays(cfg, grad_img, np.asarray(inits)[0],
                                        device)
    L_unit, x_grid = _shared_leaves(cfg, device)
    data = TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                      L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                      init_y=iy)
    states = make_batch_state(cfg, ix.shape[0], device, user_obs_xy)
    return run_trace(cfg, data, states, draws)
