"""Serving many traces: batches on one device, sequences, and a batch
sharded over a (data, sample) mesh of processes.

Port of ``gaussian_process_edge_trace_tpu/parallel/sharded.py``. The JAX
package vmaps whole traces; here the frames are a leading axis of the
driver's tensors (``trace/driver.py``), and each stage of an iteration
launches once for all of them:

- :func:`make_batch_data` / :func:`make_batch_state` — per-frame data and
  initial states with a leading frame axis (the prior factor is shared);
- :func:`trace_batch` — B independent frames, the counterpart of
  ``trace_batch_vmap``;
- :func:`trace_ensemble` — best-of-K seeds on one image;
- :func:`trace_multi_edge` — F edges of one image, its arrays computed once
  and shared;
- :func:`trace_sequence` — frames in turn, each warm-started from the
  previous frame's accepted pixels, the hand-off on the device;
- :func:`make_mesh` / :func:`sharded_trace_batch` — frames over the mesh's
  ``data`` axis and each iteration's posterior samples over its ``sample``
  axis, on ``torch.distributed`` (NCCL on the card, gloo on the CPU), one
  process per rank.

The JAX package's ``_BATCH_TILE`` is a TPU layout choice and has no
counterpart: a batch runs whole.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gaussian_process_edge_trace_torch.ops.collectives import (
    SampleShard, all_gather_stack)
from gaussian_process_edge_trace_torch.trace.driver import (
    FrameDraws, StreamDraws, TraceResult, TracerConfig, TracerData,
    TraceState, _device_at, _round_up, frame_arrays, frame_of, frame_parts,
    init_state, prior_factor, resolve_device, run_trace)
from gaussian_process_edge_trace_torch.trace.kde import gradient_kde
from gaussian_process_edge_trace_torch.utils import profiling

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def _shared_leaves(cfg: TracerConfig, device):
    """The prior factor and x grid: they depend on the config alone. The
    factor goes to the device in a blocking copy, a wait of kind
    ``data``."""
    with profiling.wait("data"):
        L_unit = torch.tensor(prior_factor(cfg), device=device)
    return L_unit, cfg.x_st + torch.arange(cfg.edge_length, device=device)


def make_batch_data(cfg: TracerConfig, grad_imgs, inits,
                    device=None) -> TracerData:
    """:class:`TracerData` of B frames (sharded.py:50): each frame's
    :func:`frame_arrays` with a leading frame axis; the prior factor and x
    grid are shared. ``grad_imgs`` (B, M, N) and ``inits`` (B, n, 2) in
    xy-space; ``device`` defaults to that of a tensor input, else the
    card. The gradient KDEs are one call over every frame, each frame the
    bits of its own (the blur's products on K8, the min-max per frame)."""
    device = resolve_device(device, grad_imgs)
    per = [frame_parts(cfg, g, i, device) for g, i in zip(grad_imgs, inits)]
    g, gcols, ix, iy = (torch.stack(leaf) for leaf in zip(*per))
    gkde = gradient_kde(g, kde_thresh=cfg.kde_thresh)
    L_unit, x_grid = _shared_leaves(cfg, device)
    return TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                      L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                      init_y=iy)


@_device_at(2)
def make_batch_state(cfg: TracerConfig, n_frames: int, user_obs_xy=None,
                     device=None) -> TraceState:
    """Initial states of ``n_frames`` traces (sharded.py:170), stacked;
    ``user_obs_xy`` is None or an (F, U, 2) warm-start array. ``device``
    defaults to that of a tensor input, else the card; the port's earlier
    form ``make_batch_state(cfg, n_frames, device, ...)`` still works."""
    device = resolve_device(device, user_obs_xy)
    states = [init_state(cfg, None if user_obs_xy is None
                         else user_obs_xy[f], device=device)
              for f in range(n_frames)]
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

    ``draws``: one draw source per member. By default member k draws the
    JAX package's stream of ``PRNGKey(cfg.seed + k)`` (sharded.py:127,
    :class:`StreamDraws` of seed ``cfg.seed + k``), so member k is the
    single trace of seed ``cfg.seed + k`` and member 0 the config's own.
    Returns the chosen member as one trace's :class:`TraceResult`, or with
    ``return_all`` the pair ``(chosen, all)``, ``all`` with a leading
    member axis."""
    if n_seeds < 1:
        raise ValueError(f"n_seeds must be >= 1, got {n_seeds}")
    if draws is None:
        rank, dev = data.L_prior_unit.shape[1], data.grad_img.device
        draws = [StreamDraws(cfg, rank, dev, seed=cfg.seed + k)
                 for k in range(n_seeds)]
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
    device = resolve_device(device, grad_img)
    ix, iy = _sorted_edge_inits(inits, device)
    g, gkde, gcols, _, _ = frame_arrays(cfg, grad_img, np.asarray(inits)[0],
                                        device)
    L_unit, x_grid = _shared_leaves(cfg, device)
    data = TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                      L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                      init_y=iy)
    states = make_batch_state(cfg, ix.shape[0], user_obs_xy, device=device)
    return run_trace(cfg, data, states, draws)


def _compact_warm_obs(user_x, user_y, user_valid, U: int):
    """Fit a warm-start observation buffer to capacity ``U``
    (sharded.py:391-407): a longer buffer keeps its valid entries first, in
    their order (the host form ``xy[valid][:U]``), and its first U slots;
    a shorter one is padded with invalid slots. Returns ``((U, 2) xy,
    (U,) valid)`` on the buffers' device, with no host copy."""
    valid = user_valid.to(torch.bool)
    if user_x.shape[0] > U:
        order = torch.argsort((~valid).to(torch.uint8), stable=True)[:U]
        user_x, user_y, valid = user_x[order], user_y[order], valid[order]
    pad = U - user_x.shape[0]
    zeros = user_x.new_zeros(pad)
    xy = torch.stack([torch.cat([user_x, zeros]),
                      torch.cat([user_y, zeros])], dim=1)
    return xy, torch.cat([valid, valid.new_zeros(pad)])


def _sequence_configs(cfg: TracerConfig):
    """The cold config of frame 0 (no warm-start slots) and the warm config
    of the frames after it, with ``round_up(n_bins, 8)`` slots for the
    previous frame's observations (sharded.py:423-432)."""
    u_cap = _round_up(cfg.bins.n_bins, 8)
    cold = cfg._replace(n_user_obs=0,
                        n_train=_round_up(cfg.n_inits + cfg.bins.n_bins, 8))
    warm = cfg._replace(
        n_user_obs=u_cap,
        n_train=_round_up(cfg.n_inits + u_cap + cfg.bins.n_bins, 8))
    return cold, warm


def trace_sequence(cfg: TracerConfig, grad_imgs, inits, device=None,
                   draws=None):
    """Trace frames in turn, each warm-started from the previous frame's
    accepted observations (sharded.py:410-455; the reference's ``obs``
    hand-off, gpet.py:57-61).

    Frame 0 runs the cold config, the rest the warm one; both share one
    prior factor, the cold config's. The frames go to the device in one
    copy, and a frame's ``obs_x``/``obs_y``/``obs_valid`` go into the next
    frame's state on the device (:func:`_compact_warm_obs`): the host reads
    only the loop's active mask and each frame's ``n_iters`` and
    ``converged``. Every frame draws from the config's seed, as each JAX
    frame draws from ``PRNGKey(cfg.seed)``.

    Args:
      grad_imgs: (F, M, N) gradient images (a tensor, an array or a list).
      inits: (F, n_inits, 2) host init points in xy-space.
      device: where the frames run; that of a tensor input by default, else
        the card.
      draws: optional ``config -> draw source``, called with each frame's
        config (the warm config's ``n_train`` differs); :class:`StreamDraws`
        by default.

    Returns a list of one :class:`TraceResult` per frame.
    """
    device = resolve_device(device, grad_imgs)
    if isinstance(grad_imgs, torch.Tensor):
        grads = grad_imgs.to(device=device, dtype=torch.float32)
    else:
        grads = torch.as_tensor(np.stack([np.asarray(g, np.float32)
                                          for g in grad_imgs]),
                                device=device)
    cold, warm = _sequence_configs(cfg)
    L_unit, x_grid = _shared_leaves(cold, device)
    results = []
    for f in range(grads.shape[0]):
        c = cold if f == 0 else warm
        g, gkde, gcols, ix, iy = frame_arrays(c, grads[f], inits[f], device)
        data = TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                          L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                          init_y=iy)
        if f == 0:
            state = init_state(c, device=device)
        else:
            prev = results[-1]
            state = init_state(c, *_compact_warm_obs(
                prev.obs_x, prev.obs_y, prev.obs_valid, c.n_user_obs),
                device=device)
        src = (StreamDraws(c, L_unit.shape[1], device) if draws is None
               else draws(c))
        results.append(run_trace(c, data, state, src))
    return results


def make_mesh(n_data: int, n_sample: int, device_type: str = "cuda"):
    """A (data, sample) ``DeviceMesh`` over the process group's ranks
    (sharded.py:40-47): ``init_device_mesh(device_type, (n_data,
    n_sample), mesh_dim_names=("data", "sample"))``. The caller starts the
    process group, one process per rank (``torchrun``, or a spawn that calls
    ``init_process_group``): NCCL for ``"cuda"``, gloo for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_data, n_sample),
                            mesh_dim_names=(DATA_AXIS, SAMPLE_AXIS))


def _frame_rows(tree, lo: int, hi: int, own=None):
    """Frames [lo, hi) of a batched TracerData or TraceState; in a
    TracerData only the per-frame leaves (``own``) are cut."""
    return type(tree)(**{k: v[lo:hi] if own is None or k in own else v
                         for k, v in tree._asdict().items()})


def _gather_frames(res: TraceResult, group) -> TraceResult:
    """Every rank's frames of ``res`` over ``group``, in group-rank order,
    in one ``all_gather``: each field's bytes side by side in one (B, n)
    byte buffer on the device, split back after the gather. ``n_iters``
    and ``converged`` come back to the host, as in a batch's result."""
    fields = [getattr(res, k) for k in TraceResult._fields]
    dev = res.y_mean.device
    B = res.y_mean.shape[0]
    parts = [t.to(dev).contiguous().reshape(B, -1).view(torch.uint8)
             for t in fields]
    every = all_gather_stack(torch.cat(parts, dim=1), group)
    every = every.reshape(-1, every.shape[-1])
    out, at = {}, 0
    for k, t, p in zip(TraceResult._fields, fields, parts):
        n = p.shape[1]
        v = every[:, at:at + n].contiguous().view(t.dtype)
        out[k] = v.reshape((every.shape[0],) + t.shape[1:]).to(t.device)
        at += n
    return TraceResult(**out)


def sharded_trace_batch(cfg: TracerConfig, data: TracerData,
                        states0: TraceState, mesh, n_frames: int,
                        draws=None) -> TraceResult:
    """Trace ``n_frames`` independent frames on a (data, sample) mesh
    (sharded.py:186-267), called on every rank with the whole batch.

    Frames over ``data``: the rank at data coordinate d traces frames
    [d·n_frames/n_data, (d+1)·n_frames/n_data) in one batched loop; ranks
    on different data coordinates do not step in lockstep. Samples over
    ``sample``: each iteration the rank draws and scores its
    ``N_samples/n_sample`` columns of the draws, and one ``all_gather`` of
    the costs and one ``all_reduce`` of the kept curves give every rank of
    its sample group the single-device kept curves, bit for bit
    (:func:`..trace.scoring.sharded_best_curves`); the KDE, the selection
    and the final fit run replicated, so a sample group steps in lockstep.
    The arm runs whenever a mesh is given, also at ``n_sample = 1``. At
    the end one ``all_gather`` over the data group gives every rank all
    ``n_frames`` results in order, shaped as :func:`trace_batch`'s.

    ``draws``: one source for every frame (:class:`StreamDraws` by
    default, ``PRNGKey(cfg.seed)`` as in sharded.py:190); each rank draws
    only its columns of the normals. Raises
    ``ValueError`` unless ``n_data`` divides ``n_frames``, ``n_sample``
    divides ``cfg.N_samples``, the batch holds ``n_frames`` frames and the
    mesh's device type is the data's.
    """
    n_data, n_sample = mesh.size(0), mesh.size(1)
    if n_frames % n_data:
        raise ValueError(f"{n_frames} frames do not split over {n_data} "
                         f"data ranks")
    if cfg.N_samples % n_sample:
        raise ValueError(f"{cfg.N_samples} samples do not split over "
                         f"{n_sample} sample ranks")
    if states0.it.shape[0] != n_frames:
        raise ValueError(f"a batch of {states0.it.shape[0]} frames, "
                         f"n_frames={n_frames}")
    if mesh.device_type != data.grad_img.device.type:
        raise ValueError(f"a {mesh.device_type} mesh for data on "
                         f"{data.grad_img.device.type}")
    per = n_frames // n_data
    lo = mesh.get_local_rank(DATA_AXIS) * per
    own = ("grad_img", "grad_kde", "grad_cols", "init_x", "init_y")
    local = _frame_rows(data, lo, lo + per, own)
    group = mesh.get_group(SAMPLE_AXIS)
    width = cfg.N_samples // n_sample
    shard = SampleShard(group, dist.get_rank(group) * width, width)
    res = run_trace(cfg, local, _frame_rows(states0, lo, lo + per), draws,
                    shard=shard)
    return _gather_frames(res, mesh.get_group(DATA_AXIS))
