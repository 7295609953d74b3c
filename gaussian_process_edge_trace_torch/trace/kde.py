"""Kernel-density estimates on the pixel grid (reference: gpet.py:455-529,
``KDEpy.FFTKDE(kernel='gaussian', bw=1)``).

Port of ``gaussian_process_edge_trace_tpu/trace/kde.py``. FFTKDE is linear
binning of the weighted points onto the grid ``[-1, N] x [-1, M]`` followed
by a Gaussian convolution; the grid is cropped to (M, N) and min-max
normalised, so only the shape matters.

- :func:`curve_kde` — the best curves, each point weighted by its curve's
  normalised inverse cost; points with y outside [0, M-1] get weight 0.
  Curve x-coordinates are integer columns, so binning reduces to a per-column
  1-D hat contraction (:func:`column_binning`, kernel K3 on the card, K4
  with ``use_pallas_binning``; ``trace/cuda_kde.py``).
- :func:`kde_normalise` — the min-max step alone, for a summed raw grid.
- :func:`gradient_kde` — the gradient image's pixels above ``kde_thresh``,
  weighted by intensity: binning integer points is a masked copy.

Every function takes an optional leading frame axis; each frame is
normalised by its own minimum and maximum.

No scatter-add is used: float atomics on the card would make reruns differ
in the last bits, and one flipped bit can change a selected pixel.
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.models.gpr import frames_span
from gaussian_process_edge_trace_torch.ops.cuda_frames import frames_product
from gaussian_process_edge_trace_torch.trace.cuda_kde import column_binning

# Gaussian truncation radius in pixels (bw = 1): exp(-0.5·8²) ≈ 1.3e-14.
DEFAULT_RADIUS = 8

# An axis up to this length blurs as a banded Toeplitz matmul, a longer one
# as shifted multiply-adds (the reference's per-axis gate, kde.py:73).
_BLUR_MATMUL_MAX = 600


def gaussian_taps(radius: int, bw: float = 1.0, dtype=torch.float32,
                  device=None):
    """Unnormalised Gaussian samples exp(-t²/(2 bw²)) on [-radius, radius]."""
    t = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    return torch.exp(-0.5 * (t / bw) ** 2)


def _toeplitz(n, taps):
    """Banded Toeplitz blur matrix T[i, j] = taps[i - j + radius]."""
    r = (taps.shape[0] - 1) // 2
    idx = torch.arange(n, device=taps.device)
    d = idx[:, None] - idx[None, :]
    vals = taps[torch.clamp(d + r, 0, 2 * r)]
    return torch.where(torch.abs(d) <= r, vals, torch.zeros_like(vals))


def _blur_axis_fma(grid, taps, axis):
    """1-D zero-boundary convolution along ``axis``, one of the last two,
    as 2r+1 shifted multiply-adds."""
    r = (taps.shape[0] - 1) // 2
    n = grid.shape[axis]
    rows = axis % grid.dim() == grid.dim() - 2
    pad = (0, 0, r, r) if rows else (r, r, 0, 0)
    g = torch.nn.functional.pad(grid, pad)
    out = taps[0] * g.narrow(axis, 0, n)
    for k in range(1, taps.shape[0]):
        out = out + taps[k] * g.narrow(axis, k, n)
    return out


class _BandedPair(tuple):
    """(Ty, Tx) from :func:`blur_matrices`, with ``band``: the radius
    beyond which both factors are zero."""
    band = None


def _separable_blur(grid, taps, mats=None):
    """2-D zero-boundary convolution with ``taps ⊗ taps``; ``mats`` are the
    precomputed :func:`blur_matrices` (a ``None`` entry blurs that axis as
    multiply-adds)."""
    m, n = grid.shape[-2:]
    if mats is None:
        band = (taps.shape[0] - 1) // 2
        mats = (_toeplitz(m, taps) if m <= _BLUR_MATMUL_MAX else None,
                _toeplitz(n, taps) if n <= _BLUR_MATMUL_MAX else None)
    else:
        band = getattr(mats, "band", None)
    Ty, Tx = mats
    # On the card every frame's product runs in one K8 launch, the factor
    # shared, each element summed in an order set by the shapes of one
    # frame: cuBLAS picks its kernel, and so its order of sums, by the
    # batch (at 128 demo frames every frame's KDE moved off its single
    # trace's). Tiles skip the factor's zero band, which changes no value.
    if Ty is None:
        out = _blur_axis_fma(grid, taps, -2)
    else:
        with frames_span(grid):
            out = frames_product(Ty, grid, a_band=band)
    if Tx is None:
        return _blur_axis_fma(out, taps, -1)
    with frames_span(out):
        return frames_product(out, Tx, b_band=band)


def blur_matrices(M: int, N: int, dtype=torch.float32, device=None,
                  radius: int = DEFAULT_RADIUS, bw: float = 1.0):
    """Loop-invariant Toeplitz factors (Ty, Tx) for the padded (M+2, N+2)
    grid, built once per trace; ``None`` for an axis that blurs as
    multiply-adds, ``None`` overall when both do. The pair carries
    ``band``, the radius beyond which both are zero."""
    if min(M, N) + 2 > _BLUR_MATMUL_MAX:
        return None
    taps = gaussian_taps(radius, bw, dtype, device)
    return banded_pair(
        _toeplitz(M + 2, taps) if M + 2 <= _BLUR_MATMUL_MAX else None,
        _toeplitz(N + 2, taps) if N + 2 <= _BLUR_MATMUL_MAX else None,
        radius)


def banded_pair(Ty, Tx, band):
    """The factors ``(Ty, Tx)`` as :func:`blur_matrices` gives them, zero
    beyond the radius ``band``."""
    mats = _BandedPair((Ty, Tx))
    mats.band = band
    return mats


def _minmax(grid):
    """Each frame scaled to [0, 1] by its own minimum and maximum."""
    lo = grid.amin(dim=(-2, -1), keepdim=True)
    hi = grid.amax(dim=(-2, -1), keepdim=True)
    return (grid - lo) / (hi - lo)


def curve_kde_raw(y_curves, weights, M: int, N: int, x_start: int,
                  radius: int = DEFAULT_RADIUS, bw: float = 1.0,
                  use_pallas_binning: bool = False, blur=None):
    """Un-normalised curve KDE: binning, placement, blur and crop."""
    E = y_curves.shape[-2]
    H = column_binning(y_curves, weights, M,
                       use_pallas=use_pallas_binning)      # (..., M+2, E)
    grid = torch.zeros(H.shape[:-2] + (M + 2, N + 2), dtype=y_curves.dtype,
                       device=y_curves.device)
    grid[..., x_start + 1:x_start + 1 + E] = H
    taps = gaussian_taps(radius, bw, y_curves.dtype, y_curves.device)
    return _separable_blur(grid, taps, mats=blur)[..., 1:-1, 1:-1]


def curve_kde(y_curves, weights, M: int, N: int, x_start: int,
              radius: int = DEFAULT_RADIUS, bw: float = 1.0,
              use_pallas_binning: bool = False, blur=None):
    """KDE of the best curves on the (M, N) grid, min-max normalised.

    Args:
      y_curves: (E, S) y-values of the S kept curves at the columns
        ``x_start .. x_start+E-1``; (B, E, S) for B frames, which gives
        (B, M, N).
      weights: (S,) normalised inverse costs (gpet.py:492-493); (B, S).
      use_pallas_binning: bin with K4 instead of K3 on the card (the
        reference's flag, kde.py:147); no effect on the CPU.
      blur: optional :func:`blur_matrices`, built once per trace.
    """
    return _minmax(curve_kde_raw(y_curves, weights, M, N, x_start, radius,
                                 bw, use_pallas_binning=use_pallas_binning,
                                 blur=blur))


def kde_normalise(raw):
    """Min-max normalise a raw KDE grid (gpet.py:527; kde.py:196 of the
    reference), each frame by its own minimum and maximum: the last step of
    :func:`curve_kde`, for a grid summed elsewhere."""
    return _minmax(raw)


def gradient_kde(grad_img, kde_thresh: float = 1e-3,
                 radius: int = DEFAULT_RADIUS, bw: float = 1.0):
    """KDE of the gradient image (gpet.py:503-509): pixels above
    ``kde_thresh`` weighted by intensity. (M, N), or (B, M, N) frames."""
    masked = torch.where(grad_img > kde_thresh, grad_img,
                         torch.zeros_like(grad_img))
    grid = torch.nn.functional.pad(masked, (1, 1, 1, 1))
    taps = gaussian_taps(radius, bw, grad_img.dtype, grad_img.device)
    return _minmax(_separable_blur(grid, taps)[..., 1:-1, 1:-1])
