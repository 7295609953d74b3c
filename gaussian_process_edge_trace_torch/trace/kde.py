"""Kernel-density estimates on the pixel grid (reference: gpet.py:455-529,
``KDEpy.FFTKDE(kernel='gaussian', bw=1)``).

Port of ``gaussian_process_edge_trace_tpu/trace/kde.py`` and of the dense
form of ``trace/pallas_kde.py::column_binning``. FFTKDE is linear binning of
the weighted points onto the grid ``[-1, N] x [-1, M]`` followed by a
Gaussian convolution; the grid is cropped to (M, N) and min-max normalised,
so only the shape matters.

- :func:`curve_kde` — the best curves, each point weighted by its curve's
  normalised inverse cost; points with y outside [0, M-1] get weight 0.
  Curve x-coordinates are integer columns, so binning reduces to a per-column
  1-D hat contraction (:func:`column_binning`).
- :func:`gradient_kde` — the gradient image's pixels above ``kde_thresh``,
  weighted by intensity: binning integer points is a masked copy.

No scatter-add is used: float atomics on the card would make reruns differ
in the last bits, and one flipped bit can change a selected pixel.
"""

from __future__ import annotations

import torch

# Gaussian truncation radius in pixels (bw = 1): exp(-0.5·8²) ≈ 1.3e-14.
DEFAULT_RADIUS = 8

# An axis up to this length blurs as a banded Toeplitz matmul, a longer one
# as shifted multiply-adds (the reference's per-axis gate, kde.py:73).
_BLUR_MATMUL_MAX = 600

# Target size of one hat-contraction block, (M+2)·E·chunk elements; more
# kept curves are binned in chunks of this size (pallas_kde.py:256).
_CHUNK_ELEMS = 128 * 1024 * 1024


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
    """1-D zero-boundary convolution along ``axis`` as 2r+1 shifted
    multiply-adds."""
    r = (taps.shape[0] - 1) // 2
    n = grid.shape[axis]
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    g = torch.nn.functional.pad(grid, pad)
    out = taps[0] * g.narrow(axis, 0, n)
    for k in range(1, taps.shape[0]):
        out = out + taps[k] * g.narrow(axis, k, n)
    return out


def _separable_blur(grid, taps, mats=None):
    """2-D zero-boundary convolution with ``taps ⊗ taps``; ``mats`` are the
    precomputed :func:`blur_matrices` (a ``None`` entry blurs that axis as
    multiply-adds)."""
    m, n = grid.shape
    if mats is None:
        mats = (_toeplitz(m, taps) if m <= _BLUR_MATMUL_MAX else None,
                _toeplitz(n, taps) if n <= _BLUR_MATMUL_MAX else None)
    Ty, Tx = mats
    out = Ty @ grid if Ty is not None else _blur_axis_fma(grid, taps, 0)
    return out @ Tx if Tx is not None else _blur_axis_fma(out, taps, 1)


def blur_matrices(M: int, N: int, dtype=torch.float32, device=None,
                  radius: int = DEFAULT_RADIUS, bw: float = 1.0):
    """Loop-invariant Toeplitz factors (Ty, Tx) for the padded (M+2, N+2)
    grid, built once per trace; ``None`` for an axis that blurs as
    multiply-adds, ``None`` overall when both do."""
    if min(M, N) + 2 > _BLUR_MATMUL_MAX:
        return None
    taps = gaussian_taps(radius, bw, dtype, device)
    return (_toeplitz(M + 2, taps) if M + 2 <= _BLUR_MATMUL_MAX else None,
            _toeplitz(N + 2, taps) if N + 2 <= _BLUR_MATMUL_MAX else None)


def _minmax(grid):
    lo = grid.min()
    hi = grid.max()
    return (grid - lo) / (hi - lo)


def column_binning(y_curves, weights, M: int):
    """Binned column masses H (M+2, E) for the curve KDE:
    ``H[m, e] = Σ_s w_s·max(0, 1 − |y[e,s] + 1 − m|)``, with w = 0 where
    y ∉ [0, M−1]. The dense hat contraction of the reference's
    ``_binning_dense_chunked`` (pallas_kde.py:259), in chunks of kept
    curves; chunk sums are added in order."""
    E, S = y_curves.shape
    rows = torch.arange(M + 2, dtype=y_curves.dtype, device=y_curves.device)
    zero = torch.zeros((), dtype=y_curves.dtype, device=y_curves.device)

    def block(yb, wb):
        yp = yb + 1.0
        w = torch.where((yb >= 0) & (yb <= M - 1), wb[None, :], zero)
        hat = torch.clamp(1.0 - torch.abs(yp[None, :, :]
                                          - rows[:, None, None]), min=0.0)
        return (hat * w[None, :, :]).sum(-1)              # (M+2, E)

    chunk = max(1, _CHUNK_ELEMS // ((M + 2) * E))
    H = block(y_curves[:, :chunk], weights[:chunk])
    for s0 in range(chunk, S, chunk):
        H = H + block(y_curves[:, s0:s0 + chunk], weights[s0:s0 + chunk])
    return H


def curve_kde_raw(y_curves, weights, M: int, N: int, x_start: int,
                  radius: int = DEFAULT_RADIUS, bw: float = 1.0, blur=None):
    """Un-normalised curve KDE: binning, placement, blur and crop."""
    E = y_curves.shape[0]
    H = column_binning(y_curves, weights, M)               # (M+2, E)
    grid = torch.zeros((M + 2, N + 2), dtype=y_curves.dtype,
                       device=y_curves.device)
    grid[:, x_start + 1:x_start + 1 + E] = H
    taps = gaussian_taps(radius, bw, y_curves.dtype, y_curves.device)
    return _separable_blur(grid, taps, mats=blur)[1:-1, 1:-1]


def curve_kde(y_curves, weights, M: int, N: int, x_start: int,
              radius: int = DEFAULT_RADIUS, bw: float = 1.0, blur=None):
    """KDE of the best curves on the (M, N) grid, min-max normalised.

    Args:
      y_curves: (E, S) y-values of the S kept curves at the columns
        ``x_start .. x_start+E-1``.
      weights: (S,) normalised inverse costs (gpet.py:492-493).
      blur: optional :func:`blur_matrices`, built once per trace.
    """
    return _minmax(curve_kde_raw(y_curves, weights, M, N, x_start, radius,
                                 bw, blur=blur))


def gradient_kde(grad_img, kde_thresh: float = 1e-3,
                 radius: int = DEFAULT_RADIUS, bw: float = 1.0):
    """KDE of the gradient image (gpet.py:503-509): pixels above
    ``kde_thresh`` weighted by intensity."""
    masked = torch.where(grad_img > kde_thresh, grad_img,
                         torch.zeros_like(grad_img))
    grid = torch.nn.functional.pad(masked, (1, 1, 1, 1))
    taps = gaussian_taps(radius, bw, grad_img.dtype, grad_img.device)
    return _minmax(_separable_blur(grid, taps)[1:-1, 1:-1])
