"""Denoisers and image-quality metrics in PyTorch (reference C18,
gpet_utils.py:122-158).

Port of ``gaussian_process_edge_trace_tpu/utils/denoise_native.py``, the
same functions under the same names. The reference dispatches to
scikit-image and scipy; these run on the image's device without them:

- :func:`denoise_tv_chambolle`: Chambolle's projection for the ROF model
  (the ``tvc`` technique), a fixed number of forward-difference/divergence
  updates;
- :func:`denoise_nl_means`: non-local means over a dense window of patch
  offsets, each patch distance a box filter by cumulative sums;
- :func:`denoise_wavelet`: a multi-level 2-D DWT (Daubechies db1-db16,
  symlets sym2-sym16) with pywt's symmetric half-sample extension and
  BayesShrink / VisuShrink thresholds;
- :func:`denoise_tv_bregman`: split-Bregman TV with a damped-Jacobi inner
  solve (the JAX package's, not skimage's Gauss-Seidel);
- the verbose report's metrics with skimage's semantics, in float64:
  :func:`peak_signal_noise_ratio`, :func:`normalized_root_mse`,
  :func:`structural_similarity`, :func:`shannon_entropy`.

The denoisers compute in float32 on the input tensor's device, or on
``device`` (``"cuda"`` by default) for a numpy input. The filter tables and
their spectral-factorization generators are host numpy, copied from the JAX
module. Medians average the two middle values of an even count, as
``jnp.median`` does (``torch.median`` would return the lower one).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_process_edge_trace_torch.utils.image import _as_f32 as _f32


def _f64(image, device=None):
    if isinstance(image, torch.Tensor):
        return image.to(device=device or image.device, dtype=torch.float64)
    return torch.as_tensor(np.array(image), dtype=torch.float64,
                           device=device or "cuda")


def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    """Source indices of an axis of length ``n`` padded by ``lo`` and
    ``hi`` in numpy's ``mode`` ('symmetric', 'reflect', 'edge', 'wrap'),
    for any pad width (numpy repeats its reflections)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i.remainder(n)
    if mode == "symmetric":
        i = i.remainder(2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        i = i.remainder(2 * n - 2)
        return torch.where(i >= n, 2 * n - 2 - i, i)
    raise ValueError(f"pad mode {mode!r}")


def pad2d(x, rows, cols, mode: str):
    """``np.pad(x, (rows, cols), mode)`` for a 2-D tensor; ``rows`` and
    ``cols`` are (before, after) widths. ``F.pad`` has no 'symmetric'
    mode and limits 'reflect' to a pad smaller than the axis, so the pad
    is a take of source indices (``'constant'`` pads zeros)."""
    H, W = x.shape
    if mode == "constant":
        return F.pad(x, (cols[0], cols[1], rows[0], rows[1]))
    ri = _pad_index(H, rows[0], rows[1], mode, x.device)
    ci = _pad_index(W, cols[0], cols[1], mode, x.device)
    return x.index_select(0, ri).index_select(1, ci)


def _median_last(x):
    """``jnp.median`` over the last axis: the mean of the two middle
    values, ``(a + b) * 0.5``, of an even count."""
    v, _ = torch.sort(x, dim=-1)
    n = v.shape[-1]
    return (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5


def _median(x):
    """``jnp.median`` of all elements (see :func:`_median_last`)."""
    return _median_last(x.reshape(-1))


def denoise_tv_chambolle(image, weight=0.1, n_iter=100, device=None):
    """Chambolle 2004 dual projection for the ROF model.

    skimage's ``denoise_tv_chambolle`` update (step 1/4 in 2-D, the same
    weight convention) for a fixed ``n_iter`` instead of an eps-based
    stop, as the JAX function runs it."""
    img = _f32(image, device)
    tau = 0.25
    w = torch.tensor(weight, dtype=torch.float32, device=img.device)
    zrow = torch.zeros_like(img[:1])
    zcol = torch.zeros_like(img[:, :1])

    def grad(u):
        gy = torch.cat([u[1:] - u[:-1], zrow], 0)
        gx = torch.cat([u[:, 1:] - u[:, :-1], zcol], 1)
        return gy, gx

    def div(py, px):
        dy = torch.cat([py[:1], py[1:-1] - py[:-2], -py[-2:-1]], 0)
        dx = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2],
                        -px[:, -2:-1]], 1)
        return dy + dx

    py = torch.zeros_like(img)
    px = torch.zeros_like(img)
    for _ in range(n_iter):
        # p ← (p − (τ/λ)∇u) / (1 + (τ/λ)|∇u|) with u = f − λ·div p.
        u = img - w * div(py, px)
        gy, gx = grad(u)
        norm = torch.sqrt(gy * gy + gx * gx)
        denom = 1.0 + (tau / w) * norm
        py = (py - (tau / w) * gy) / denom
        px = (px - (tau / w) * gx) / denom
    return img - w * div(py, px)


def denoise_nl_means(image, patch_size=7, patch_distance=11, h=0.1,
                     sigma=0.0, device=None):
    """Non-local means over the dense (2·patch_distance+1)² offset window.

    For every offset, the per-pixel patch distance is a box filter of the
    shifted squared difference, by cumulative sums (accumulated in float64,
    so the card and the CPU agree at 1000² and beyond). Weights
    follow skimage's fast NL-means convention:
    ``exp(-max(dist² - 2σ², 0) / h²)``."""
    img = _f32(image, device)
    H, W = img.shape
    pr = patch_size // 2
    pad = patch_distance + pr
    padded = pad2d(img, (pad, pad), (pad, pad), "reflect")
    k = patch_size

    def box2d(a):
        # The running sums and their differences in float64: a float32
        # scan over a 1000-wide axis rounds by device (PyTorch's CPU scan
        # accumulates in double, the card's in float), and the weights
        # exp(-d2/h²) magnify that. In float64 both agree to float32.
        c = torch.cumsum(F.pad(a, (0, 0, 1, 0)), dim=0, dtype=torch.float64)
        a = c[k:] - c[:-k]
        c = torch.cumsum(F.pad(a, (1, 0)), dim=1)
        a = c[:, k:] - c[:, :-k]
        return (a / (k * k)).to(torch.float32)

    num = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    den = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    hp, wp = H + 2 * pr, W + 2 * pr
    centre = padded[pad - pr:pad - pr + hp, pad - pr:pad - pr + wp]
    s2 = 2.0 * sigma * sigma
    hh = h * h
    for dy in range(-patch_distance, patch_distance + 1):
        for dx in range(-patch_distance, patch_distance + 1):
            r0, c0 = pad + dy - pr, pad + dx - pr
            shifted = padded[r0:r0 + hp, c0:c0 + wp]
            d2 = box2d((centre - shifted) ** 2)
            wgt = torch.exp(-torch.clamp(d2 - s2, min=0.0) / hh)
            val = padded[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
            num = num + wgt * val
            den = den + wgt
    return num / den


def peak_signal_noise_ratio(image_true, image_test, data_range=None):
    """skimage.metrics.peak_signal_noise_ratio, in float64."""
    a = _f64(image_true)
    b = _f64(image_test, a.device)
    if data_range is None:
        data_range = a.max() - a.min()
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / mse)


def normalized_root_mse(image_true, image_test, normalization="min-max"):
    """skimage.metrics.normalized_root_mse (min-max / euclidean / mean),
    in float64."""
    a = _f64(image_true)
    b = _f64(image_test, a.device)
    rmse = torch.sqrt(torch.mean((a - b) ** 2))
    if normalization == "min-max":
        return rmse / (a.max() - a.min())
    if normalization == "euclidean":
        return rmse / torch.sqrt(torch.mean(a * a))
    return rmse / torch.mean(a)


def structural_similarity(im1, im2, data_range=None, win_size=7):
    """skimage.metrics.structural_similarity with the default uniform
    filter (gaussian_weights=False), K1=0.01, K2=0.03, in float64."""
    a = _f64(im1)
    b = _f64(im2, a.device)
    if data_range is None:
        data_range = a.max() - a.min()
    k = win_size

    def ufilt(x):
        c = torch.cumsum(F.pad(x, (0, 0, 1, 0)), dim=0)
        x = c[k:] - c[:-k]
        c = torch.cumsum(F.pad(x, (1, 0)), dim=1)
        return (c[:, k:] - c[:, :-k]) / (k * k)

    ua, ub = ufilt(a), ufilt(b)
    n = k * k
    cov_norm = n / (n - 1)
    vara = cov_norm * (ufilt(a * a) - ua * ua)
    varb = cov_norm * (ufilt(b * b) - ub * ub)
    covab = cov_norm * (ufilt(a * b) - ua * ub)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * ua * ub + C1) * (2 * covab + C2)) / (
        (ua * ua + ub * ub + C1) * (vara + varb + C2))
    return torch.mean(ssim_map)


def shannon_entropy(image, base=2):
    """skimage.measure.shannon_entropy over a 256-bin histogram of the
    image's range, in float64, with ``jnp.histogram``'s bins: the edges
    ``lo·(1 − t) + hi·t`` at t = i/256, a value in bin i where
    ``edges[i] <= v < edges[i+1]``, the last bin closed (``torch.histc``
    and ``torch.histogram`` bin otherwise or only on the CPU)."""
    img = _f64(image).reshape(-1)
    lo, hi = img.min(), img.max()
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    t = torch.arange(256, dtype=torch.float64, device=img.device) / 256.0
    edges = torch.cat([lo * (1 - t) + hi * t, hi[None]])
    idx = torch.searchsorted(edges, img, right=True)
    idx = torch.where(img == edges[-1], 256, idx)
    hist = torch.bincount(idx, minlength=258)[1:257].to(torch.float64)
    p = hist / hist.sum()
    p = torch.where(p > 0, p, 1.0)
    return -torch.sum(p * torch.log(p)) / math.log(base)


# ---------------------------------------------------------------------------
# Wavelet denoising (the reference's 'wavelet' technique,
# gpet_utils.py:134-140 -> skimage.restoration.denoise_wavelet, which
# forwards the user's ``wavelet=`` kwarg to pywt): the Daubechies family
# db1..db16 (db5+ by spectral factorization, _daubechies) and the symlets
# sym2..sym16 (least-asymmetric factorization, _symlet), pywt-style
# SYMMETRIC half-sample extension with the expansive coefficient layout,
# BayesShrink/VisuShrink soft/hard thresholds and the MAD noise estimate.
# Other wavelet names raise NotImplementedError rather than substitute.
# ---------------------------------------------------------------------------

_SQRT2 = 2.0 ** 0.5

# Daubechies orthonormal scaling filters (natural order; pywt rec_lo).
_DB_FILTERS = {
    "db1": np.array([0.7071067811865476, 0.7071067811865476]),
    "haar": np.array([0.7071067811865476, 0.7071067811865476]),
    "db2": np.array([0.48296291314469025, 0.8365163037378079,
                     0.22414386804185735, -0.12940952255092145]),
    "db3": np.array([0.3326705529509569, 0.8068915093133388,
                     0.4598775021193313, -0.13501102001039084,
                     -0.08544127388224149, 0.035226291882100656]),
    "db4": np.array([0.23037781330885523, 0.7148465705525415,
                     0.6308807679295904, -0.02798376941698385,
                     -0.18703481171888114, 0.030841381835986965,
                     0.032883011666982945, -0.010597401784997278]),
}


def _halfband_roots(N: int):
    """Roots of the Daubechies maxflat half-band autocorrelation
    ``P(y) = Σ_{i<N} C(N−1+i, i) y^i`` with ``y = (2 − z − z⁻¹)/4``,
    Newton-polished. Shared by the db (minimum-phase) and sym
    (least-asymmetric) spectral factorizations; the roots come in
    reciprocal-conjugate sets {z, z̄, 1/z, 1/z̄}."""
    from math import comb

    base = np.array([-0.25, 0.5, -0.25])        # y(z) Laurent coefficients
    terms, cur = [], np.array([1.0])
    for i in range(N):
        terms.append(comb(N - 1 + i, i) * cur)
        cur = np.convolve(cur, base)
    width = max(len(t) for t in terms)
    total = np.zeros(width)
    for t in terms:
        pad = (width - len(t)) // 2
        total[pad:pad + len(t)] += t
    p = total[::-1]                              # ordinary poly, z^{2N-2}..z^0
    roots = np.roots(p)
    dp = np.polyder(p)
    for _ in range(3):                           # Newton polish
        roots = roots - np.polyval(p, roots) / np.polyval(dp, roots)
    return roots


def _rebuild_filter(N: int, chosen_roots):
    """``h = √2 · ((1+z)/2)^N · Q(z)/Q(1)`` from a spectral-factor root
    selection (one root per reciprocal pair; conjugate-closed)."""
    q = np.real(np.poly(chosen_roots))           # conjugate pairs → real
    h = np.array([1.0])
    for _ in range(N):
        h = np.convolve(h, [0.5, 0.5])
    h = np.convolve(h, q)
    return h * (_SQRT2 / h.sum())


@functools.lru_cache(maxsize=None)
def _daubechies(N: int):
    """Daubechies-N orthonormal scaling filter (length 2N) by spectral
    factorization: the half-band roots inside the unit circle (minimum
    phase, pywt's convention). Reproduces the pinned db1-db4 tables to
    ≤ 5e-12 and holds double-shift orthonormality to ≤ 1e-8 through db16;
    beyond 16 the root-finding error crosses float32 resolution, so
    :func:`_wavelet_filter` refuses. Host numpy, cached per N."""
    if N == 1:
        return np.array([_SQRT2 / 2, _SQRT2 / 2])
    roots = _halfband_roots(N)
    inside = roots[np.abs(roots) < 1.0]
    assert len(inside) == N - 1, (len(inside), N)
    return _rebuild_filter(N, inside)


@functools.lru_cache(maxsize=None)
def _symlet(N: int):
    """Symlet-N (least-asymmetric Daubechies) orthonormal scaling filter
    (length 2N): each complex reciprocal quadruple contributes its inside
    or its outside conjugate pair, chosen exhaustively to minimise the
    deviation of the filter's phase from linear (Daubechies' criterion,
    Ten Lectures §8.1). Real pairs keep the inside root. sym2/sym3 equal
    db2/db3, sym4 reproduces the published table to ≤ 8e-13, and
    orthonormality holds to ≤ 2e-8 through sym16. Host numpy, cached per
    N."""
    import itertools

    if N == 1:
        return np.array([_SQRT2 / 2, _SQRT2 / 2])
    roots = _halfband_roots(N)
    inside = [z for z in roots if abs(z) < 1.0]
    assert len(inside) == N - 1, (len(inside), N)
    cplx = [z for z in inside if z.imag > 1e-12]
    real = [z for z in inside if abs(z.imag) <= 1e-12]

    w = np.linspace(0.01, np.pi - 0.01, 256)
    basis = np.stack([w, np.ones_like(w)], 1)

    def phase_nonlinearity(h):
        H = np.exp(-1j * np.outer(w, np.arange(h.shape[0]))) @ h
        ph = np.unwrap(np.angle(H))
        res = ph - basis @ np.linalg.lstsq(basis, ph, rcond=None)[0]
        return float(np.sum(res ** 2))

    # A time-reversed filter has the same objective: a candidate replaces
    # the incumbent only by a relative improvement, so ties keep the
    # earliest enumeration (all inside first: sym2/sym3 are db2/db3).
    best, best_nl = None, np.inf
    for picks in itertools.product([False, True], repeat=len(cplx)):
        chosen = list(real)
        for z, flip in zip(cplx, picks):
            zz = 1.0 / np.conj(z) if flip else z
            chosen += [zz, np.conj(zz)]
        h = _rebuild_filter(N, np.array(chosen))
        nl = phase_nonlinearity(h)
        if nl < best_nl * (1.0 - 1e-6):
            best, best_nl = h, nl
    return best


_DB_MAX_N = 16
_SYM_MAX_N = 16


def _wavelet_filter(wavelet):
    """A wavelet name's scaling filter, or a refusal: 'haar' and
    'db1'-'db4' from the pinned tables, 'db5'-'db16' and 'sym2'-'sym16'
    from the generators. Other pywt names (higher dbN/symN, coifN,
    biorX.Y, ...) raise NotImplementedError: the reference forwards
    ``wavelet=`` to pywt (gpet_utils.py:134-140), and substituting another
    wavelet would be worse than refusing."""
    if wavelet in _DB_FILTERS:
        return _DB_FILTERS[wavelet]
    for prefix, gen, cap in (("db", _daubechies, _DB_MAX_N),
                             ("sym", _symlet, _SYM_MAX_N)):
        if (isinstance(wavelet, str) and wavelet.startswith(prefix)
                and wavelet[len(prefix):].isdigit()):
            N = int(wavelet[len(prefix):])
            lo = 2 if prefix == "sym" else 1   # pywt's symN starts at sym2
            if lo <= N <= cap:
                return gen(N)
            raise NotImplementedError(
                f"native denoise_wavelet supports {prefix}{lo}.."
                f"{prefix}{cap}: the spectral-factorization construction "
                f"of {wavelet!r} exceeds f32-grade orthonormality "
                "(measured; see _daubechies/_symlet)")
    raise NotImplementedError(
        f"native denoise_wavelet supports 'haar', 'db1'..'db{_DB_MAX_N}' "
        f"and 'sym2'..'sym{_SYM_MAX_N}' only, got {wavelet!r} (the "
        "reference forwards this kwarg to pywt, gpet_utils.py:134-140; "
        "rather than silently substituting another wavelet we refuse)")


def _qmf(h):
    """Quadrature-mirror highpass: g[j] = (-1)^j h[L-1-j]."""
    sign = np.where(np.arange(h.shape[0]) % 2 == 0, 1.0, -1.0)
    return sign * h[::-1]


def _strided(x, start, stop, step, axis):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _wave_fwd_axis(x, h, g, axis):
    """One analysis level along ``axis`` with pywt's ``mode='symmetric'``
    boundary: the signal is extended by L−1 half-sample-mirrored samples
    each side (``[x_{L-2}..x_0 | x | x_{n-1}..x_{n-L+1}]``) and

        a[k] = Σ_j h[j] · ext[2k + 1 + j],   k < (n + L − 1) // 2

    (d with the QMF highpass g). Requires ``n ≥ L`` (the level cap in
    :func:`denoise_wavelet` guarantees it). ``h`` and ``g`` are 1-D
    tensors of the signal's dtype."""
    n = x.shape[axis]
    L = int(h.shape[0])
    assert n >= L, (n, L)
    left = torch.flip(x.narrow(axis, 0, L - 1), (axis,))
    right = torch.flip(x.narrow(axis, n - L + 1, L - 1), (axis,))
    ext = torch.cat([left, x, right], dim=axis)
    out_len = (n + L - 1) // 2
    lo = hi = None
    for j in range(L):
        xr = _strided(ext, 1 + j, 2 * out_len + j, 2, axis)
        lo = h[j] * xr if lo is None else lo + h[j] * xr
        hi = g[j] * xr if hi is None else hi + g[j] * xr
    return lo, hi


def _wave_inv_axis(lo, hi, h, g, n, axis):
    """Inverse of :func:`_wave_fwd_axis`: upsample by 2, full-convolve with
    the reconstruction pair (rolls over a zero-tail-padded array, which are
    shifts), sum, and crop the centred ``[L−2, L−2+n)`` window."""
    L = int(h.shape[0])
    up_shape = list(lo.shape)
    up_shape[axis] = 2 * up_shape[axis]
    za = torch.stack([lo, torch.zeros_like(lo)], dim=axis + 1
                     ).reshape(up_shape)
    zd = torch.stack([hi, torch.zeros_like(hi)], dim=axis + 1
                     ).reshape(up_shape)
    if L > 2:
        tail = list(up_shape)
        tail[axis] = L - 2
        za = torch.cat([za, za.new_zeros(tail)], dim=axis)
        zd = torch.cat([zd, zd.new_zeros(tail)], dim=axis)
    out = None
    for j in range(L):
        ra = torch.roll(za, j, dims=axis) if j else za
        rd = torch.roll(zd, j, dims=axis) if j else zd
        term = h[j] * ra + g[j] * rd
        out = term if out is None else out + term
    c = max(L - 2, 0)
    return out.narrow(axis, c, n)


def _filters(wavelet, dtype=torch.float32, device="cpu"):
    h_np = _wavelet_filter(wavelet)
    return (torch.as_tensor(h_np, dtype=dtype, device=device),
            torch.as_tensor(_qmf(h_np), dtype=dtype, device=device))


def wave_dwt2(x, wavelet="db1"):
    """One 2-D analysis level: returns (LL, (LH, HL, HH), shape)."""
    h, g = _filters(wavelet, x.dtype, x.device)
    shape = tuple(x.shape)
    lo, hi = _wave_fwd_axis(x, h, g, 0)
    ll, lh = _wave_fwd_axis(lo, h, g, 1)
    hl, hh = _wave_fwd_axis(hi, h, g, 1)
    return ll, (lh, hl, hh), shape


def wave_idwt2(ll, details, shape, wavelet="db1"):
    """One 2-D synthesis level, the inverse of :func:`wave_dwt2`."""
    h, g = _filters(wavelet, ll.dtype, ll.device)
    lh, hl, hh = details
    lo = _wave_inv_axis(ll, lh, h, g, shape[1], 1)
    hi = _wave_inv_axis(hl, hh, h, g, shape[1], 1)
    return _wave_inv_axis(lo, hi, h, g, shape[0], 0)


def _haar_fwd_axis(x, axis):
    n = x.shape[axis]
    if n % 2 == 1:                       # symmetric extension of odd axes
        x = torch.cat([x, x.narrow(axis, n - 1, 1)], dim=axis)
    a = _strided(x, 0, None, 2, axis)
    b = _strided(x, 1, None, 2, axis)
    return (a + b) / _SQRT2, (a - b) / _SQRT2


def _haar_inv_axis(lo, hi, n, axis):
    a = (lo + hi) / _SQRT2
    b = (lo - hi) / _SQRT2
    out = torch.stack([a, b], dim=axis + 1)
    shape = list(lo.shape)
    shape[axis] *= 2
    return out.reshape(shape).narrow(axis, 0, n)


def haar_dwt2(x):
    """One 2-D Haar analysis level: returns (LL, (LH, HL, HH), shape)."""
    shape = tuple(x.shape)
    lo, hi = _haar_fwd_axis(x, 0)
    ll, lh = _haar_fwd_axis(lo, 1)
    hl, hh = _haar_fwd_axis(hi, 1)
    return ll, (lh, hl, hh), shape


def haar_idwt2(ll, details, shape):
    lh, hl, hh = details
    lo = _haar_inv_axis(ll, lh, shape[1], 1)
    hi = _haar_inv_axis(hl, hh, shape[1], 1)
    return _haar_inv_axis(lo, hi, shape[0], 0)


def estimate_sigma(image, device=None):
    """Noise std by the MAD of the finest diagonal Haar detail
    (Donoho-Johnstone; skimage.restoration.estimate_sigma for 2-D input).
    A tensor keeps its dtype."""
    if not isinstance(image, torch.Tensor):
        image = _f32(image, device)
    _, (_, _, hh), _ = haar_dwt2(image)
    return _median(torch.abs(hh)) / 0.67448975019608171


def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _bayes_thresh(detail, sigma2):
    """BayesShrink per-subband threshold t = sigma^2 / sigma_x (Chang et
    al. 2000, as skimage's _bayes_thresh); a subband whose variance is all
    noise is cleared."""
    dvar = torch.mean(detail * detail)
    sig_x = torch.sqrt(torch.clamp(dvar - sigma2, min=1e-12))
    t = sigma2 / sig_x
    return torch.where(dvar <= sigma2, torch.abs(detail).max() + 1.0, t)


def denoise_wavelet(image, sigma=None, wavelet="db1", mode="soft",
                    wavelet_levels=None, method="BayesShrink", device=None):
    """Wavelet denoising (gpet_utils.py:134-140): a multi-level DWT with
    BayesShrink (per subband) or VisuShrink (universal) thresholds, 'soft'
    or 'hard'.

    ``wavelet`` is 'haar', 'db1'..'db16' or 'sym2'..'sym16'; other pywt
    names raise NotImplementedError. ``wavelet_levels`` defaults to
    skimage's ``max_level - 3`` (at least 1). ``sigma=None`` estimates the
    noise from the finest diagonal detail of the same wavelet's
    decomposition by MAD (skimage's ``_wavelet_threshold``)."""
    _wavelet_filter(wavelet)                # validate the name up front
    x = _f32(image, device)
    # pywt.dwt_max_level(n, L) = floor(log2(n / (L - 1))); the symmetric
    # extension needs n >= L at every level.
    L = len(_wavelet_filter(wavelet))
    max_level = int(np.floor(np.log2(min(x.shape) / max(L - 1, 1))))
    if wavelet_levels is None:
        wavelet_levels = max(max_level - 3, 1)
    wavelet_levels = max(min(wavelet_levels, max_level), 0)
    if wavelet_levels == 0:       # image smaller than one filter support
        return x

    ll = x
    pyramid = []
    for _ in range(wavelet_levels):
        ll, details, shape = wave_dwt2(ll, wavelet)
        pyramid.append((details, shape))

    if sigma is None:
        sig = _median(torch.abs(pyramid[0][0][2])) / 0.67448975019608171
    else:
        sig = torch.tensor(sigma, dtype=torch.float32, device=x.device)
    sigma2 = sig ** 2

    for lvl in range(wavelet_levels - 1, -1, -1):
        details, shape = pyramid[lvl]
        new = []
        for d in details:
            if method == "BayesShrink":
                t = _bayes_thresh(d, sigma2)
            elif method == "VisuShrink":
                t = torch.sqrt(sigma2) * math.sqrt(2.0 * math.log(x.numel()))
            else:
                raise NotImplementedError(method)
            new.append(_soft(d, t) if mode == "soft"
                       else torch.where(torch.abs(d) > t, d, 0.0))
        ll = wave_idwt2(ll, tuple(new), shape, wavelet)
    return ll


# ---------------------------------------------------------------------------
# TV-Bregman (the reference's 'tvb' technique, gpet_utils.py:140 ->
# skimage.restoration.denoise_tv_bregman): split-Bregman iteration for the
# (an)isotropic ROF model  min_u  weight/2 ||u-f||^2 + TV(u)  (Goldstein &
# Osher 2009), skimage's model and weight semantics (a larger weight stays
# closer to the input), with the JAX package's damped-Jacobi inner solve.
# ---------------------------------------------------------------------------


def denoise_tv_bregman(image, weight=5.0, max_num_iter=100, eps=1e-3,
                       isotropic=True, device=None):
    """Split-Bregman TV denoising.

    The stop is the JAX function's ``while_loop`` test, ``k <
    max_num_iter and err > eps``, run as a host loop: ``err`` (the relative
    RMS change of an iteration) is read by the host once per iteration, one
    synchronise each, and no iteration runs past the one that meets it."""
    f = _f32(image, device)
    mu = 2.0 * torch.tensor(weight, dtype=torch.float32, device=f.device)
    w = torch.tensor(weight, dtype=torch.float32, device=f.device)

    def grad(u):
        gx = torch.diff(u, dim=1, append=u[:, -1:])
        gy = torch.diff(u, dim=0, append=u[-1:, :])
        return gx, gy

    def div(px, py):
        dx = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2],
                        -px[:, -2:-1]], dim=1)
        dy = torch.cat([py[:1, :], py[1:-1, :] - py[:-2, :],
                        -py[-2:-1, :]], dim=0)
        return dx + dy

    def shrink(gx, gy):
        if isotropic:
            mag = torch.sqrt(gx * gx + gy * gy)
            scale = (torch.clamp(mag - 1.0 / mu, min=0.0)
                     / torch.clamp(mag, min=1e-12))
            return gx * scale, gy * scale
        return _soft(gx, 1.0 / mu), _soft(gy, 1.0 / mu)

    def laplace_jacobi(u, rhs, n_sweeps=4):
        # (w - mu*Lap) u = rhs, damped Jacobi with a 4-neighbour stencil.
        for _ in range(n_sweeps):
            nb = (torch.cat([u[:, :1], u[:, :-1]], 1)
                  + torch.cat([u[:, 1:], u[:, -1:]], 1)
                  + torch.cat([u[:1], u[:-1]], 0)
                  + torch.cat([u[1:], u[-1:]], 0))
            u = (rhs + mu * nb) / (w + 4.0 * mu)
        return u

    u = f
    z = torch.zeros_like(f)
    dx = dy = bx = by = z
    k, err = 0, math.inf
    while k < max_num_iter and err > eps:
        # (w - mu*Lap) u = w f + mu div(b - d): the Goldstein-Osher update.
        rhs = w * f + mu * div(bx - dx, by - dy)
        u_new = laplace_jacobi(u, rhs)
        gx, gy = grad(u_new)
        dx, dy = shrink(gx + bx, gy + by)
        bx = bx + gx - dx
        by = by + gy - dy
        e = torch.sqrt(torch.mean((u_new - u) ** 2)) / torch.clamp(
            torch.sqrt(torch.mean(u_new * u_new)), min=1e-12)
        u, k, err = u_new, k + 1, float(e)
    return u
