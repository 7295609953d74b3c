"""The JAX package's random stream in plain PyTorch, for the reference.

Frozen copy of the plain path of ``gaussian_process_edge_trace_torch/
ops/prng.py`` at commit b71f8113f0c7ad4e79e6543cfb6e16f28479a0e3
(``_threefry_host``, ``prng_key``, ``fold_in``, ``split``,
``_threefry_tensor``, ``random_bits_plain``, ``uniform_plain``, the float32
``log``/``log1p``/``erf_inv`` as XLA compiles them, ``normal_plain``). It
imports nothing of the port, so the reference works the draws out from the
seed itself: threefry2x32 keys, ``fold_in``/``split``, uniforms in [0, 1)
and normals ``sqrt(2)·erf_inv(u)``, elementwise on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


NORMAL_LO = _f32(0xBF7FFFFF)
_SQRT2 = _f32(0x3FB504F3)
_LOG_SQRTHF = _f32(0x3F3504F3)
_LOG_P = tuple(map(_f32, (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F,
                          0x3E11E9BF, 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC,
                          0x3EAAAAAA)))
_LOG_Q1 = _f32(0xB95E8083)
_LOG_Q2 = _f32(0x3F318000)
_LOG1P_SMALL = _f32(0x3ED413CD)
_LOG1P_DEN = tuple(map(_f32, (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                              0x43586D8A, 0x42707982)))
_LOG1P_NUM = tuple(map(_f32, (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                              0x4273CC76, 0x426473AD, 0x41A05101)))
_ERFINV_LT5 = tuple(map(_f32, (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1,
                               0x396532DB, 0xBAA45408, 0xBB88E4EF, 0x3E7C8F63,
                               0x3FC02E2F)))
_ERFINV_GE5 = tuple(map(_f32, (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7,
                               0x3BBC127B, 0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB,
                               0x40354F7E)))


def _threefry_host(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` with x64 off: (0, seed mod 2³²)."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    return 0, seed & MASK32


def fold_in(key, data):
    return _threefry_host(key[0], key[1], 0, int(data))


def split(key, n=2):
    return tuple(_threefry_host(key[0], key[1], 0, i) for i in range(n))


def _threefry_tensor(key, x0, x1):
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0.add_(ks[0]).bitwise_and_(MASK32)
    x1.add_(ks[1]).bitwise_and_(MASK32)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            torch.bitwise_right_shift(x1, 32 - r, out=t)
            x1.bitwise_left_shift_(r).bitwise_and_(MASK32).bitwise_or_(t)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK32)
    return x0, x1


def random_bits(key, shape, device):
    """uint32 bits (in int64) of a ``shape`` draw: element (i, j) hashes the
    counter i·shape[-1] + j."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    i64 = dict(dtype=torch.int64, device=device)
    idx = (torch.arange(rows, **i64)[:, None] * cols
           + torch.arange(cols, **i64)[None, :])
    x0 = idx >> 32
    x1 = idx.bitwise_and_(MASK32)
    b0, b1 = _threefry_tensor(key, x0, x1)
    return b0.bitwise_xor_(b1).reshape(shape)


def _as_f32(bits):
    b = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return b.to(torch.int32).view(torch.float32)


def uniform(key, shape, device, minval=0.0, maxval=1.0):
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(lo)))
    f = _as_f32((random_bits(key, shape, device) >> 9) | 0x3F800000) - 1.0
    return torch.clamp_min(f * span + lo, lo)


def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(x)


def fma32(a, b, c):
    """float32 ``a·b + c`` rounded once (round-to-odd in float64)."""
    p = _f64(a) * _f64(b)
    c = _f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _div32(a, b):
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def _sqrt32(a):
    return torch.sqrt(a.to(torch.float64)).to(torch.float32)


def _xla_log(a):
    a = torch.clamp_min(a, _f32(0x00800000))
    bits = a.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    e = e - small.to(torch.float32)
    z = (m + -1.0) + torch.where(small, m, torch.zeros_like(m))
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    y = fma32(fma32(p[0], z, p[1]), z, p[2])
    y1 = fma32(fma32(p[3], z, p[4]), z, p[5])
    y2 = fma32(fma32(p[6], z, p[7]), z, p[8])
    y = fma32(y, z3, y1)
    y = fma32(y, z3, y2)
    y = fma32(y, z3, e * _LOG_Q1)
    lg = fma32(-z2, 0.5, z) + y
    return fma32(e, _LOG_Q2, lg)


def _xla_log1p(t):
    large = _xla_log(t + 1.0)
    t2 = t * t
    den = torch.ones_like(t)
    for c in _LOG1P_DEN:
        den = fma32(den, t, c)
    num = torch.full_like(t, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma32(num, t, c)
    r = (t * t2) * _div32(num, den)
    small = t + fma32(-t2, 0.5, r)
    return torch.where(torch.abs(t) < _LOG1P_SMALL, small, large)


def _xla_erf_inv(x):
    l1p = _xla_log1p(x * -x)
    lt = l1p > -5.0
    w = torch.where(lt, -2.5 - l1p, _sqrt32(-l1p) + -3.0)
    coef = [torch.where(lt, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = fma32(coef[0], w, coef[1])
    for c in coef[2:]:
        p = fma32(w, p, c)
    return x * p


def normal(key, shape, device):
    """``jax.random.normal(key, shape)`` in float32."""
    return _xla_erf_inv(uniform(key, shape, device, NORMAL_LO, 1.0)) * _SQRT2
