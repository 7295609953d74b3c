"""Image preprocessing: the extended-Sobel filter, min-max normalisation,
the gradient image and the denoising dispatch.

Port of ``kernel_builder``, ``normalise``, ``comp_grad_img`` and
``denoise`` from ``gaussian_process_edge_trace_tpu/utils/image.py``
(reference: gpet_utils.py:10-158). Functions take numpy arrays or tensors and return
float32 tensors on ``device`` (default: the input tensor's device, or
``"cuda"`` for a numpy input, as ``GP_Edge_Tracing`` defaults; pass
``device="cpu"`` to run on the CPU).
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
    """A float32 tensor of ``img``: a tensor keeps its device unless
    ``device`` is given; a numpy input goes to ``device``, ``"cuda"`` by
    default, and raises where there is no card rather than fall back."""
    if isinstance(img, torch.Tensor):
        return img.to(device=device or img.device, dtype=torch.float32)
    return torch.as_tensor(np.array(img), dtype=torch.float32,
                           device=device or "cuda")


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


def _gaussian_filter_1d(size_sigma):
    sigma, radius = size_sigma
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def denoise(image, technique, kwargs, plot=False, verbose=False,
            device=None):
    """Denoise ``image`` by one of the reference's seven techniques
    (gpet_utils.py:122-158), on the image's device:

    - ``gaussian``: two separable ``conv2d`` passes after the boundary pad;
    - ``median`` / ``minimum``: over the unfolded window (an even ``size``
      averages the two middle values, as ``jnp.median`` does; ``minimum``
      at an even size returns the JAX function's (H+1, W+1) window);
    - ``tvc``, ``nl``, ``wavelet``, ``tvb``: :mod:`.denoise_native`.

    ``mode`` is scipy's boundary mode for the first three (default
    'reflect', which is numpy's 'symmetric'), the threshold mode for
    ``wavelet``. ``wavelet`` takes db1-db16 and sym2-sym16 and refuses
    other names; ``tvb`` uses a damped-Jacobi inner solve, so its pixels
    differ from skimage's Gauss-Seidel at equal ``max_num_iter``. With
    ``verbose`` the quality report is printed. An unknown technique prints
    and returns ``None``, as the JAX function does. ``plot`` is accepted
    and ignored, as there."""
    image = _as_f32(image, device)
    out = _denoise_dispatch(image, technique, kwargs)
    if verbose and out is not None:   # quality report, gpet_utils.py:151-156
        from gaussian_process_edge_trace_torch.utils.denoise_native import (
            normalized_root_mse, peak_signal_noise_ratio, shannon_entropy,
            structural_similarity)
        psnr = round(float(peak_signal_noise_ratio(image, out)), 2)
        ss = round(float(structural_similarity(image, out)), 2)
        nmse = round(float(normalized_root_mse(image, out)), 5)
        ent = round(float(shannon_entropy(out)), 3)
        print(f"Peak-SNR: {psnr}.\nStructural Similarity: {ss}.\n"
              f"Mean Square Error: {nmse}.\nShannon Entropy: {ent}.\n")
    return out


# scipy.ndimage boundary modes -> numpy pad modes (scipy's default
# 'reflect' mirrors without repeating the edge sample: numpy 'symmetric').
_PAD_MODES = {"reflect": "symmetric", "nearest": "edge", "mirror": "reflect",
              "wrap": "wrap", "constant": "constant"}


def _denoise_dispatch(image, technique, kwargs):
    from gaussian_process_edge_trace_torch.utils import denoise_native as dn
    if technique in ("gaussian", "median", "minimum"):
        # scipy.ndimage filters read 'mode' as a boundary mode; for
        # 'wavelet' it is the soft/hard switch instead.
        pad_mode = _PAD_MODES[kwargs.get("mode", "reflect")]
    if technique == "gaussian":
        sigma = float(kwargs.get("sigma", 1.0))
        radius = int(kwargs.get("radius", int(4.0 * sigma + 0.5)))
        k = torch.as_tensor(_gaussian_filter_1d((sigma, radius)),
                            dtype=torch.float32, device=image.device)
        out = dn.pad2d(image, (radius, radius), (0, 0), pad_mode)
        out = F.conv2d(out[None, None], k[None, None, :, None])[0, 0]
        out = dn.pad2d(out, (0, 0), (radius, radius), pad_mode)
        return F.conv2d(out[None, None], k[None, None, None, :])[0, 0]
    elif technique in ("median", "minimum"):
        size = int(kwargs.get("size", 3))
        pad = size // 2
        padded = dn.pad2d(image, (pad, pad), (pad, pad), pad_mode)
        if technique == "minimum":
            return -F.max_pool2d(-padded[None, None], size, stride=1)[0, 0]
        H, W = image.shape
        stack = torch.stack([padded[dy:dy + H, dx:dx + W]
                             for dy in range(size) for dx in range(size)],
                            dim=-1)
        return dn._median_last(stack)
    elif technique == "tvc":
        kwargs = {k: v for k, v in kwargs.items() if k != "mode"}
        return dn.denoise_tv_chambolle(image, **kwargs)
    elif technique == "nl":
        return dn.denoise_nl_means(image, **kwargs)
    elif technique == "wavelet":
        return dn.denoise_wavelet(image, **kwargs)
    elif technique == "tvb":
        return dn.denoise_tv_bregman(image, **kwargs)
    else:
        print("Denoising technique not implemented.")
        return None
