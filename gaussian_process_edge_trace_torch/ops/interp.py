"""Bilinear image lookup with the FITPACK boundary clamp.

Port of ``gaussian_process_edge_trace_tpu/ops/interp.py``: the reference's
``RectBivariateSpline(kx=1, ky=1)`` gradient-image lookup (gpet.py:122-125,
evaluated at gpet.py:392). A degree-1 tensor spline on the integer pixel
grid is bilinear interpolation; FITPACK clamps a query outside the grid to
its boundary, axis by axis. It computes in the dtype of the image (the
cost function calls it in float64) on the image's device.
"""

from __future__ import annotations

import torch


def bilinear_interp(img, rows, cols):
    """``img`` (M, N) at real ``(rows, cols)`` (broadcast together), as
    ``RectBivariateSpline(arange(M), arange(N), img, kx=1, ky=1)(rows,
    cols, grid=False)`` with its boundary clamp."""
    img = torch.as_tensor(img)
    M, N = img.shape
    rows = torch.clamp(torch.as_tensor(rows, dtype=img.dtype,
                                       device=img.device), 0, M - 1)
    cols = torch.clamp(torch.as_tensor(cols, dtype=img.dtype,
                                       device=img.device), 0, N - 1)
    r0 = torch.clamp(torch.floor(rows), 0, M - 2).to(torch.int64)
    c0 = torch.clamp(torch.floor(cols), 0, N - 2).to(torch.int64)
    fr = rows - r0
    fc = cols - c0
    v00 = img[r0, c0]
    v01 = img[r0, c0 + 1]
    v10 = img[r0 + 1, c0]
    v11 = img[r0 + 1, c0 + 1]
    top = v00 + fc * (v01 - v00)
    bot = v10 + fc * (v11 - v10)
    return top + fr * (bot - top)
