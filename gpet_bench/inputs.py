"""The benchmark's inputs and its accuracy metric, frozen so that no later
change to the program can move them.

Frozen copies, from commit b71f8113f0c7ad4e79e6543cfb6e16f28479a0e3, of

- ``gaussian_process_edge_trace_torch/utils/synthetic.py::
  construct_test_img`` (a noisy test image with a known edge; the noise
  from ``np.random.RandomState(seed)``);
- ``gaussian_process_edge_trace_torch/utils/image.py::kernel_builder``,
  ``normalise`` and ``comp_grad_img`` (the extended-Sobel gradient image,
  edge-replicate padding, a shifted multiply-accumulate over the flipped
  taps, negatives clamped, min-max normalised), here on any device;
- ``gaussian_process_edge_trace_torch/utils/metrics.py::trace_dicecoef``
  (DICE over binarised under-edge masks, rounded to 4 decimals), as
  ``dice_many``, many traces at once.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F


def derive(seed: int, purpose: str, index: int = 0) -> int:
    """A seed in [0, 2³¹) for ``purpose`` and ``index``, from the run's
    ``--seed``: the same run seed always gives the same derived seeds."""
    h = hashlib.sha256(f"{int(seed)}/{purpose}/{int(index)}".encode())
    return int.from_bytes(h.digest()[:8], "little") % (2 ** 31)


def construct_test_img(size, amplitude, curvature, noise_level, ltype,
                       intensity, gaps=False, seed=1):
    """``(test_img, edge_idx)``, ``edge_idx`` the (N, 2) yx true edge."""
    M, N = size
    x = np.linspace(-np.pi, np.pi, N)
    A = M // 2 if amplitude > M else amplitude // 2
    xwave_idx = np.arange(0, N, 1)
    cols = np.arange(N)

    def _sine_rows(fn):
        return (np.rint(A * fn(N * curvature * x)) + M // 2).astype(int)

    ywave1_idx = None
    if ltype == "sinusoidal":
        ywave_idx = _sine_rows(np.sin)
    elif ltype == "multi-sinusoidal":
        ywave_idx = _sine_rows(np.sin)
        ywave1_idx = ywave_idx + A // 2
    elif ltype == "close multi-sinusoidal":
        ywave_idx = _sine_rows(np.sin)
        ywave1_idx = ywave_idx + A // 6
    elif ltype == "co-sinusoidal":
        ywave_idx = _sine_rows(np.cos)
    elif ltype == "diag":
        ywave_idx = cols.copy()
    elif ltype == "straight":
        ywave_idx = np.full(N, M // 2, dtype=int)
    else:
        raise ValueError(f"unknown ltype {ltype!r}")

    rows = np.arange(M)[:, None]
    test_img = np.where(rows >= ywave_idx[None, :], intensity, 0.0)
    if ywave1_idx is not None:
        test_img = np.where(rows >= ywave1_idx[None, :], 1.0 - intensity,
                            test_img)
    edge_idx = np.stack([ywave_idx, xwave_idx], axis=1)
    if ywave1_idx is not None:
        edge_idx = np.concatenate(
            [edge_idx, np.stack([ywave1_idx, xwave_idx], axis=1)], axis=0)
    if gaps:
        test_img[:, 20:30] = 0
        test_img[:, N // 2:(N // 2 + 10)] = 0
        test_img[:, N - 100:N - 90] = 0
        test_img[:, N // 4:(N // 4 + 20)] = 0
    rng = np.random.RandomState(seed)
    test_img = test_img + rng.normal(0.0, np.sqrt(noise_level), test_img.shape)
    return np.clip(test_img, 0.0, 1.0), edge_idx


def kernel_builder(size, unit=False):
    """Extended-Sobel kernel (``b2d``, ``normalize`` and ``vertical_edges``
    off, as the benchmark's configurations use it)."""
    N, M = size
    kernel = np.zeros((N, M), dtype=np.float64)
    mid_r, mid_c = N // 2, M // 2
    if unit:
        kernel[:mid_r, :] = 1.0
    else:
        i = np.arange(mid_r)[:, None]
        j = np.arange(M)[None, :]
        kernel[:mid_r, :] = 1.0 + np.maximum(
            0, mid_r + 1 - np.abs(i - mid_r) - np.abs(j - mid_c))
    kernel[mid_r + 1:, :] = -np.flip(kernel[0:mid_r, :], axis=0)
    return kernel


def normalise(img):
    """Min-max rescale into [0, 1] in float32."""
    img = img - img.min()
    img = img / img.max()
    return img * 1.0 + 0.0


def comp_grad_img(img, kernel):
    """The normalised gradient image of a float32 tensor ``img``."""
    k = np.asarray(kernel, dtype=np.float64)
    kh, kw = k.shape
    flip = k[::-1, ::-1]
    padded = F.pad(img[None, None], (kw // 2, (kw - 1) // 2, kh // 2,
                                     (kh - 1) // 2), mode="replicate")[0, 0]
    H, W = img.shape
    out = torch.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            t = float(flip[dy, dx])
            if t != 0.0:
                out = out + t * padded[dy:dy + H, dx:dx + W]
    return normalise(torch.clamp(out, min=0.0))


def make_image(conf: dict, image_seed: int, device):
    """One pool image of configuration ``conf``: the float32 gradient image
    on ``device`` and the (N, 2) yx true edge on the host."""
    g = conf["image"]
    img, edge = construct_test_img(
        tuple(g["size"]), g["amplitude"], g["curvature"], g["noise_level"],
        g["ltype"], g["intensity"], gaps=g["gaps"], seed=image_seed)
    img = torch.as_tensor(img, dtype=torch.float32, device=device)
    grad = comp_grad_img(img, kernel_builder(tuple(g["grad_kernel"])))
    return grad, edge


def dice_many(edges, truth):
    """The program's ``utils/metrics.py::trace_dicecoef`` (DICE of two
    yx traces over their under-edge masks) of each of the (F, E, 2) traces
    ``edges`` against ``truth`` (E, 2) at once: a column's under-edge mask holds the
    rows from its start down, so the masks' intersection and union are
    counted per column from the two starts, exactly as the masks count
    them."""
    edges = np.asarray(edges)
    N = edges.shape[1]

    def start(y):
        y = y.astype(np.int64)
        return np.where(y < 0, np.maximum(N + y, 0), y)

    sp = start(edges[..., 0])
    st = start(np.asarray(truth)[None, :, 0])
    inter = np.clip(N - np.maximum(sp, st), 0, N).sum(-1)
    union = np.clip(N - np.minimum(sp, st), 0, N).sum(-1)
    jacc = torch.as_tensor(inter, dtype=torch.float64) / torch.as_tensor(
        union, dtype=torch.float64)
    return torch.round(2 * jacc / (jacc + 1), decimals=4).tolist()
