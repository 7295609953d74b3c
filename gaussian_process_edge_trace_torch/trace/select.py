"""Pixel scoring, adaptive thresholding and per-bin selection.

Port of ``gaussian_process_edge_trace_tpu/trace/select.py`` (reference
``get_best_pixels`` + ``compute_new_obs``, gpet.py:532-662), as dense
fixed-shape grid arithmetic:

- candidates are ``kde > kde_thresh``, minus the endpoint columns when the
  endpoints are fixed (gpet.py:651-657);
- previous observations stay eligible while the new KDE still covers them
  (gpet.py:568-574); they bypass the endpoint exclusion, as in the reference;
- ``score = (kde·grad + kde + grad)/3`` (gpet.py:582);
- the threshold decays by 0.95 per pass, the first pass not decaying
  (gpet.py:589-609), until enough bins are occupied; all passes are
  evaluated at once;
- each sub-interval bin keeps its best pixel (gpet.py:613-616), returned as
  fixed per-bin buffers ``(x, y, valid)``.

With a leading frame axis every frame has its own scores, threshold ladder
index and bins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gaussian_process_edge_trace_torch.utils import profiling


class BinSpec(NamedTuple):
    """Sub-interval binning over the whole image width:
    ``bin_of_col[x] = round((x - x_st)/delta_x) - bin_min``."""
    x_st: int
    x_en: int
    delta_x: int
    bin_min: int
    n_bins: int


def make_bin_spec(N: int, x_st: int, x_en: int, delta_x: int) -> BinSpec:
    cols = np.arange(N)
    bins = np.round((cols - x_st) / delta_x).astype(int)  # half to even
    bin_min = int(bins.min())
    return BinSpec(x_st=x_st, x_en=x_en, delta_x=delta_x, bin_min=bin_min,
                   n_bins=int(bins.max()) - bin_min + 1)


def bin_of_col(spec: BinSpec, N: int) -> np.ndarray:
    """(N,) bin index of every column, rounded half to even in float32 as
    the reference computes it (select.py:68-71)."""
    cols = np.arange(N, dtype=np.float32)
    q = (cols - np.float32(spec.x_st)) / np.float32(spec.delta_x)
    return np.round(q).astype(np.int64) - spec.bin_min


def _prefix_product(a: np.ndarray, block: int = 16) -> np.ndarray:
    # Blocked prefix product: sequential within 16-wide blocks, block
    # totals combined by the same rule recursively.
    if a.shape[0] <= block:
        return np.cumprod(a, dtype=np.float32)
    parts = [np.cumprod(a[k:k + block], dtype=np.float32)
             for k in range(0, a.shape[0], block)]
    pre = _prefix_product(np.array([p[-1] for p in parts], np.float32),
                          block)
    out = [parts[0]] + [np.float32(pre[k - 1]) * parts[k]
                        for k in range(1, len(parts))]
    return np.concatenate(out).astype(np.float32)


def decay_ladder(max_decays: int) -> np.ndarray:
    """(max_decays,) float32 multipliers of the adaptive threshold: 1 for
    the first pass, then 0.95^j. The products are grouped as the
    reference's ``jnp.cumprod`` groups them on the CPU (blocked prefix
    products), so the thresholds agree with it bit for bit."""
    decays = np.full((max_decays,), 0.95, np.float32)
    decays[0] = 1.0
    return _prefix_product(decays)


class Selection(NamedTuple):
    obs_x: torch.Tensor        # (n_bins,) x of the best pixel per bin
    obs_y: torch.Tensor        # (n_bins,)
    obs_valid: torch.Tensor    # (n_bins,) bool — bin occupied
    n_fobs: torch.Tensor       # scalar = sum(obs_valid)
    score_thresh: torch.Tensor  # scalar threshold after the decays
    score: torch.Tensor        # (M, N) pixel score before eligibility


class SelectConsts(NamedTuple):
    """Per-config constants of :func:`select_pixels`, built once."""
    bin_onehot: torch.Tensor   # (n_bins, N) bool
    col_ok: torch.Tensor       # (N,) bool, endpoint-column exclusion
    ladder: torch.Tensor       # (max_decays,) float32


def select_consts(spec: BinSpec, N: int, max_decays: int,
                  device) -> SelectConsts:
    cols = np.arange(N)
    onehot = bin_of_col(spec, N)[None, :] == np.arange(spec.n_bins)[:, None]
    with profiling.wait("consts"):
        return SelectConsts(
            bin_onehot=torch.as_tensor(onehot, device=device),
            col_ok=torch.as_tensor((cols > spec.x_st) & (cols < spec.x_en),
                                   device=device),
            ladder=torch.as_tensor(decay_ladder(max_decays), device=device))


def select_pixels(kde_arr, grad_kde, obs_x, obs_y, obs_valid, n_pre,
                  score_thresh, spec: BinSpec, fix_endpoints: bool,
                  kde_thresh: float, pixel_thresh: int, algo_thresh: int,
                  max_decays: int = 400, consts: SelectConsts = None,
                  cand_mask=None) -> Selection:
    """One selection round: scores, adaptive threshold, per-bin argmax.
    It copies nothing from the host and never waits for the device (given
    ``consts`` and tensors on the device), so a CUDA graph can capture it.

    Args:
      kde_arr: (M, N) curve KDE of this iteration, or (B, M, N) for B
        frames; every other argument then has the same leading axis, or
        none where the frames share it.
      grad_kde: (M, N) gradient KDE.
      obs_x/obs_y/obs_valid: previous observations (int64, int64, bool).
      n_pre: scalar count of previous observations (gpet.py:561).
      score_thresh: scalar threshold carried from the last iteration.
      consts: :func:`select_consts` for this config (built if omitted).
      cand_mask: optional (M, N) bool candidate set in place of the one
        derived from ``kde_arr`` (the reference's ``pixel_idx`` argument of
        ``compute_new_obs``, gpet.py:532-535; select.py:100,111); the
        endpoint exclusion is then the caller's.
    """
    M, N = kde_arr.shape[-2:]
    lead = kde_arr.shape[:-2]
    dev = kde_arr.device
    if consts is None:
        consts = select_consts(spec, N, max_decays, dev)

    dense_cand = kde_arr > kde_thresh                      # gpet.py:651
    if cand_mask is not None:
        cand = torch.as_tensor(cand_mask, dtype=torch.bool, device=dev)
    elif fix_endpoints:
        cand = dense_cand & consts.col_ok
    else:
        cand = dense_cand
    # Previous observations still covered by the KDE (gpet.py:571): a bool
    # grid written at each valid (y, x), each frame in its own M·N cells;
    # invalid slots go to a spare cell.
    frames = int(np.prod(lead, dtype=np.int64))
    base = (torch.arange(frames, device=dev) * (M * N)).reshape(lead + (1,))
    flat = torch.where(obs_valid, base + obs_y * N + obs_x,
                       torch.full_like(obs_x, frames * M * N))
    old = torch.zeros(frames * M * N + 1, dtype=torch.bool, device=dev)
    old.index_fill_(0, flat.reshape(-1), True)   # no copy from the host
    elig = cand | (old[:frames * M * N].reshape(kde_arr.shape) & dense_cand)

    raw_score = (kde_arr * grad_kde + kde_arr + grad_kde) / 3.0  # gpet.py:582
    neg_inf = torch.full((), -torch.inf, dtype=raw_score.dtype, device=dev)
    score = torch.where(elig, raw_score, neg_inf)

    # The pixel kept for an occupied bin is always its best eligible pixel,
    # so the argmax does not depend on the threshold: the threshold decides
    # occupancy only.
    col_best = score.amax(-2)                              # (..., N)
    col_best_y = torch.argmax(score, dim=-2)
    per_bin = torch.where(consts.bin_onehot, col_best[..., None, :], neg_inf)
    bin_best_col = torch.argmax(per_bin, dim=-1)
    bin_best_score = per_bin.amax(-1)                      # (..., n_bins)

    threshs = (torch.as_tensor(score_thresh, device=dev).to(score.dtype)
               [..., None] * consts.ladder)                # (..., J)
    n_at = (bin_best_score[..., None, :] >= threshs[..., :, None]).sum(-1)
    n_pre = torch.as_tensor(n_pre, device=dev)[..., None]
    stop = (n_at - n_pre >= pixel_thresh) | (n_at >= algo_thresh)
    last = torch.full((), max_decays - 1, dtype=torch.int64, device=dev)
    j = torch.where(stop.any(-1), torch.argmax(stop.to(torch.uint8), dim=-1),
                    last)
    thresh = torch.take_along_dim(threshs, j[..., None], dim=-1)[..., 0]

    valid = bin_best_score >= thresh[..., None]
    zero = torch.zeros_like(bin_best_col)
    new_x = torch.where(valid, bin_best_col, zero)
    new_y = torch.where(valid, torch.take_along_dim(col_best_y, bin_best_col,
                                                    dim=-1), zero)
    return Selection(obs_x=new_x, obs_y=new_y, obs_valid=valid,
                     n_fobs=valid.sum(-1), score_thresh=thresh,
                     score=raw_score)
