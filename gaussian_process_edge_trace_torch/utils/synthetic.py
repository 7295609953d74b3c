"""Synthetic test-image construction (reference: gpet_utils.py:163-253).

The edge families (``sinusoidal``, ``multi-sinusoidal``, ``close
multi-sinusoidal``, ``co-sinusoidal``, ``diag``, ``straight``), the fixed
occlusion gap bands, and the seeded additive Gaussian noise all follow the
reference semantics. The reference used ``skimage.util.random_noise(...,
seed=1)``; scikit-image is not a dependency here, so the noise is drawn from
``np.random.RandomState(seed)`` with the same mean/variance and the same
final clip to [0, 1] — statistically identical, different bit pattern.
"""

from __future__ import annotations

import numpy as np


def construct_test_img(size, amplitude, curvature, noise_level, ltype,
                       intensity, gaps=False, seed=1):
    """Build a noisy test image with a known edge.

    Returns ``(test_img, edge_idx)`` where ``edge_idx`` is in yx-space,
    matching gpet_utils.py:163-253.
    """
    M, N = size
    test_img = np.zeros((M, N), dtype=np.float64)
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
    # Fill everything at/below the (first) edge with `intensity`.
    test_img = np.where(rows >= ywave_idx[None, :], intensity, 0.0)
    if ywave1_idx is not None:
        # Second edge overwrites below it with 1-intensity (reference order).
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
    test_img = np.clip(test_img, 0.0, 1.0)

    return test_img, edge_idx
