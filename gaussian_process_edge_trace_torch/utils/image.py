"""Image preprocessing: the extended-Sobel filter, min-max normalisation and
the gradient image.

Port of ``kernel_builder``, ``normalise`` and ``comp_grad_img`` from
``gaussian_process_edge_trace_tpu/utils/image.py`` (reference:
gpet_utils.py:10-119). Functions take numpy arrays or tensors and return
float32 tensors on ``device`` (default: the input tensor's device, or the
CPU for a numpy input).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def kernel_builder(size, b2d=False, normalize=False, vertical_edges=False,
                   unit=False):
    """Extended-Sobel edge-detection kernel (gpet_utils.py:10-61): the top
    ``N//2`` rows hold ``1 + max(0, mid_r + 1 - |i-mid_r| - |j-mid_c|)``
    (all ones if ``unit``), the bottom rows the negated vertical flip, the
    middle row zero. A host-side numpy array."""
    N, M = size
    kernel = np.zeros((N, M), dtype=np.float64)
    mid_r = N // 2
    mid_c = M // 2
    if unit:
        kernel[:mid_r, :] = 1.0
    else:
        i = np.arange(mid_r)[:, None]
        j = np.arange(M)[None, :]
        weight = np.maximum(0, mid_r + 1 - np.abs(i - mid_r)
                            - np.abs(j - mid_c))
        kernel[:mid_r, :] = 1.0 + weight
    kernel[mid_r + 1:, :] = -np.flip(kernel[0:mid_r, :], axis=0)
    if b2d:
        kernel = np.flipud(kernel)
    if vertical_edges:
        kernel = kernel.T
    if normalize:
        kernel = kernel / kernel.max()
    return kernel


def _as_f32(img, device=None):
    if isinstance(img, torch.Tensor):
        return img.to(device=device or img.device, dtype=torch.float32)
    return torch.as_tensor(np.array(img), dtype=torch.float32,
                           device=device or "cpu")


def normalise(img, minmax_val=(0, 1), device=None):
    """Min-max rescale ``img`` into ``[min_val, max_val]`` in float32
    (gpet_utils.py:65-91)."""
    min_val, max_val = minmax_val
    img = _as_f32(img, device)
    img = img - img.min()
    img = img / img.max()
    return img * (max_val - min_val) + min_val


def comp_grad_img(img, kernel, norm=True, device=None):
    """Gradient image (gpet_utils.py:95-119): ``scipy.ndimage.convolve``
    with edge-replicate padding, negatives clamped to zero, then min-max
    normalised. The convolution is a shifted multiply-accumulate over the
    flipped taps in row-major order, as the reference writes it. ``norm``
    is honoured (the reference ignores it); without it the result is cast
    to int32."""
    img = _as_f32(img, device)
    k = np.asarray(kernel, dtype=np.float64)
    kh, kw = k.shape
    flip = k[::-1, ::-1]
    ph_lo, ph_hi = kh // 2, (kh - 1) // 2
    pw_lo, pw_hi = kw // 2, (kw - 1) // 2
    padded = F.pad(img[None, None], (pw_lo, pw_hi, ph_lo, ph_hi),
                   mode="replicate")[0, 0]
    H, W = img.shape
    out = torch.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            t = float(flip[dy, dx])
            if t != 0.0:
                out = out + t * padded[dy:dy + H, dx:dx + W]
    out = torch.clamp(out, min=0.0)
    if norm:
        return normalise(out)
    return out.to(torch.int32)
