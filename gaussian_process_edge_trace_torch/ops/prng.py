"""The JAX package's random stream: threefry2x32 keys, ``fold_in``,
``split``, random bits, uniforms and normals.

The port's own copy of the parts of ``jax.random`` that the JAX package
draws from, as defined under ``jax_threefry_partitionable=True`` (JAX
0.9.0's default) with the default ``threefry2x32`` implementation, so that
one seed draws the same numbers in both packages:

- a key is a pair of Python ints ``(k0, k1)``, each 32 bits:
  :func:`prng_key` is ``jax.random.PRNGKey`` as the JAX package runs it,
  with ``jax_enable_x64`` off (a seed in [-2⁶³, 2⁶³) keys as (0, seed mod
  2³²)), and :func:`prng_key_x64` the same with x64 on, for the float64 draws
  of the sklearn-style GPR (the seed's 64-bit two's complement as (high,
  low) words); the two agree on seeds in [0, 2³²). :func:`fold_in` and
  :func:`split` are the foldlike forms (``_threefry_fold_in``,
  ``_threefry_split_foldlike``). Keys are derived on the host, one threefry
  block each, so drawing never reads the device;
- :func:`random_bits` of a key and a (rows, S_tot) shape: element (i, j)
  hashes the 64-bit counter ``i·S_tot + j`` split into (high, low) words and
  is ``bits1 ^ bits2`` (``_threefry_random_bits_partitionable``). A column
  window ``cols`` is computed directly and is bit for bit the full draw's
  columns, so a sample shard draws only its own;
- :func:`uniform` is ``jax.random.uniform``'s float32 transform
  (``random.py::_uniform``): ``(bits >> 9) | 0x3F800000`` bitcast, minus 1,
  scaled, shifted, then ``max(minval, ·)``;
- :func:`normal` is ``_normal_real``: ``√2·erf_inv(u)`` for u uniform in
  ``[nextafter(-1, 0), 1)``, with the ``erf_inv`` and ``log1p`` that XLA
  compiles for the CPU in float32 (the fused multiply-adds where its
  compiled code has them, plain float32 operations elsewhere), so the
  normals equal ``jax.random.normal``'s on the CPU bit for bit.

Shapes of more than two axes draw as (prod(shape[:-1]), shape[-1]): the flat
index is the same. :func:`draw` takes a table of :class:`Draw` s at once. On
the CPU the functions take their plain versions, int64 tensors masked to 32
bits; on the card they launch ``csrc/threefry_normal_kernel.cu``, one launch
for a table of up to :data:`_MAX_DRAWS` draws, and raise if it cannot run.
``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from gaussian_process_edge_trace_torch.ops import cuda_build

LAUNCHES = {"threefry": 0}

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# The kernel's modes and the draws one launch takes
# (csrc/threefry_normal_kernel.cu).
_MODE = {"bits": 0, "uniform": 1, "normal": 2}
_MAX_DRAWS = 64


def _f32(bits: int) -> float:
    """The float32 value of a 32-bit pattern, as a Python float."""
    return float(np.array(bits, np.uint32).view(np.float32))


# nextafter(-1, 0) in float32: the normal's lower uniform bound.
NORMAL_LO = _f32(0xBF7FFFFF)
_SQRT2 = _f32(0x3FB504F3)
# XLA's CPU float32 log (a Cephes polynomial): sqrt(1/2), the polynomial's
# nine coefficients and the two parts of ln 2.
_LOG_SQRTHF = _f32(0x3F3504F3)
_LOG_P = tuple(map(_f32, (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F,
                          0x3E11E9BF, 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC,
                          0x3EAAAAAA)))
_LOG_Q1 = _f32(0xB95E8083)
_LOG_Q2 = _f32(0x3F318000)
# XLA's float32 log1p: |x| below sqrt(2) - 1 takes a rational form
# (Cephes), above it log(1 + x).
_LOG1P_SMALL = _f32(0x3ED413CD)
_LOG1P_DEN = tuple(map(_f32, (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                              0x43586D8A, 0x42707982)))
_LOG1P_NUM = tuple(map(_f32, (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                              0x4273CC76, 0x426473AD, 0x41A05101)))
# XLA's float32 erf_inv (Giles): nine coefficients for w < 5 and nine for
# w >= 5, w = -log1p(-x²).
_ERFINV_LT5 = tuple(map(_f32, (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1,
                               0x396532DB, 0xBAA45408, 0xBB88E4EF, 0x3E7C8F63,
                               0x3FC02E2F)))
_ERFINV_GE5 = tuple(map(_f32, (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7,
                               0x3BBC127B, 0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB,
                               0x40354F7E)))


# ----------------------------------------------------------------- keys ---

def _threefry_host(k0: int, k1: int, x0: int, x1: int):
    """threefry2x32 of one counter pair, in Python ints."""
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


def _seed64(seed) -> int:
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit a signed 64-bit "
                            f"integer")
    return seed


def prng_key(seed) -> tuple:
    """``jax.random.PRNGKey(seed)`` as the JAX package runs it, with
    ``jax_enable_x64`` off: ``(0, seed mod 2³²)`` for a seed in [-2⁶³, 2⁶³)
    (so -1 keys as (0, 2³² - 1), 2³² + 5 as (0, 5)); ``OverflowError``
    outside that range, as JAX raises."""
    return 0, _seed64(seed) & MASK32


def prng_key_x64(seed) -> tuple:
    """``jax.random.PRNGKey(seed)`` with ``jax_enable_x64`` on: the (high,
    low) words of the seed's 64-bit two's complement; ``OverflowError``
    outside [-2⁶³, 2⁶³). Only the sklearn-style GPR keys so, as it follows
    the JAX package's float64 path (models/sklearn_api.py)."""
    seed = _seed64(seed) & (2 ** 64 - 1)
    return seed >> 32, seed & MASK32


def fold_in(key, data) -> tuple:
    """``jax.random.fold_in(key, data)`` for data in [0, 2³²)."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data {data} outside [0, 2**32)")
    return _threefry_host(key[0], key[1], 0, data)


def split(key, n: int = 2) -> tuple:
    """``jax.random.split(key, n)``: n keys, key i from the counter (0, i)."""
    return tuple(_threefry_host(key[0], key[1], 0, i) for i in range(n))


# ----------------------------------------------------------- plain bits ---

def _rows_cols(shape, cols):
    """(rows, S_tot, first column, column count) of a draw of ``shape``
    windowed to the slice ``cols`` of its last axis."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        shape = (1,)
    S_tot = shape[-1]
    rows = math.prod(shape[:-1])
    c0, c1, step = cols.indices(S_tot)
    if step != 1:
        raise ValueError("a column window is a slice of step 1")
    return rows, S_tot, c0, max(c1 - c0, 0)


def _out_shape(shape, ncols):
    shape = tuple(int(s) for s in shape) or (1,)
    return shape[:-1] + (ncols,)


def _threefry_tensor(key, x0, x1):
    """threefry2x32 of counter tensors (int64, 32-bit values), in place."""
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


def random_bits_plain(key, shape, cols=slice(None), device="cpu"):
    """Plain version: the uint32 bits (as int64) of columns ``cols`` of the
    ``shape`` draw of ``key``, computed with PyTorch operations on
    ``device`` (the CPU, or the card where ``chip_smoke.py`` holds the
    kernel to it)."""
    rows, S_tot, c0, n = _rows_cols(shape, cols)
    i64 = dict(dtype=torch.int64, device=device)
    idx = (torch.arange(rows, **i64)[:, None] * S_tot
           + torch.arange(c0, c0 + n, **i64)[None, :])
    x0 = idx >> 32
    x1 = idx.bitwise_and_(MASK32)
    b0, b1 = _threefry_tensor(key, x0, x1)
    return b0.bitwise_xor_(b1).reshape(_out_shape(shape, n))


def _as_f32(bits):
    """int64 holding uint32 patterns -> float32 of those bits."""
    b = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return b.to(torch.int32).view(torch.float32)


def _unit_from_bits(bits):
    """``bitcast((bits >> 9) | 0x3F800000) - 1``: float32 in [0, 1)."""
    return _as_f32((bits >> 9) | 0x3F800000) - 1.0


def _bounds(minval, maxval):
    """float32 ``minval`` and ``maxval - minval``, as Python floats."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(np.float32(maxval) - lo))


def uniform_plain(key, shape, minval=0.0, maxval=1.0, cols=slice(None),
                  device="cpu"):
    """Plain version of :func:`uniform` on ``device``. The product is
    exact for the spans the JAX package draws with (1 and 2), so whether
    XLA fuses it into the add does not change a bit."""
    lo, span = _bounds(minval, maxval)
    f = _unit_from_bits(random_bits_plain(key, shape, cols, device))
    return torch.clamp_min(f * span + lo, lo)


# -------------------------------------------------- XLA's float32 maths ---

def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(x)


def fma32(a, b, c):
    """float32 ``a·b + c`` rounded once, as a fused multiply-add rounds it.

    The product is exact in float64; the sum is rounded to odd in float64
    (the exact error of the float64 add, from TwoSum, decides the last
    bit), and rounding that to float32 is then the correctly rounded
    fused result (53 >= 2·24 + 2 bits)."""
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
    """float32 ``a / b`` correctly rounded: through float64, whose 53 bits
    make the double rounding exact (>= 2·24 + 2); the CPU's float32 kernels
    need not round correctly."""
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def _sqrt32(a):
    """float32 ``sqrt(a)`` correctly rounded, through float64 as
    :func:`_div32` (``torch.sqrt`` of float32 on the CPU is not)."""
    return torch.sqrt(a.to(torch.float64)).to(torch.float32)


def _xla_log(a):
    """XLA's CPU float32 log for a in (0, inf) (a Cephes polynomial)."""
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
    """XLA's CPU float32 log1p of t = -x·x in (-1, 0]."""
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
    """XLA's float32 erf_inv for x in (-1, 1): Giles' two polynomials in
    w = -log1p(-x²), split at w = 5, Horner steps fused."""
    l1p = _xla_log1p(x * -x)
    lt = l1p > -5.0
    w = torch.where(lt, -2.5 - l1p, _sqrt32(-l1p) + -3.0)
    coef = [torch.where(lt, a, b) for a, b in zip(_ERFINV_LT5,
                                                   _ERFINV_GE5)]
    p = fma32(coef[0], w, coef[1])
    for c in coef[2:]:
        p = fma32(w, p, c)
    return x * p


def normal_plain(key, shape, cols=slice(None), device="cpu"):
    """Plain version of :func:`normal` on ``device``."""
    u = uniform_plain(key, shape, NORMAL_LO, 1.0, cols, device)
    return _xla_erf_inv(u) * _SQRT2


def normal64_plain(key, shape):
    """``jax.random.normal(key, shape, float64)`` up to the last bits: the
    64-bit uniform of ``_uniform`` (exact) through ``torch.special.erfinv``
    in float64, where XLA takes its own float64 erf_inv (the CPU test
    states the bound). For the float64 draws of ``models/sklearn_api.py``."""
    u = uniform64_plain(key, shape, math.nextafter(-1.0, 0.0), 1.0)
    return math.sqrt(2.0) * torch.special.erfinv(u)


def uniform64_plain(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float64, minval, maxval)``: 64-bit
    bits ``bits1 << 32 | bits2``, ``(bits >> 12) | 0x3FF0...`` bitcast,
    minus 1, scaled, shifted, then ``max(minval, ·)``; exact."""
    rows, S_tot, _, n = _rows_cols(shape, slice(None))
    idx = torch.arange(rows * S_tot, dtype=torch.int64)
    b0, b1 = _threefry_tensor(key, idx >> 32, idx & MASK32)
    mant = (b0 << 20) | (b1 >> 12)
    f = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    lo = torch.tensor(float(minval), dtype=torch.float64)
    span = torch.tensor(float(maxval), dtype=torch.float64) - lo
    return torch.maximum(lo, f * span + lo).reshape(_out_shape(shape, n))


# ------------------------------------------------------------ the table ---

class Draw(NamedTuple):
    """One draw of a table: ``mode`` (``"bits"``, ``"uniform"`` or
    ``"normal"``) of ``key`` at ``shape``, its columns ``cols``; a
    uniform's ``[minval, maxval)`` (a normal's are its own)."""
    mode: str
    key: tuple
    shape: tuple
    cols: slice = slice(None)
    minval: float = 0.0
    maxval: float = 1.0


def draw_plain(d: Draw, device="cpu"):
    """Plain version of one draw of a table, on ``device``."""
    if d.mode == "normal":
        return normal_plain(d.key, d.shape, d.cols, device)
    if d.mode == "uniform":
        return uniform_plain(d.key, d.shape, d.minval, d.maxval, d.cols,
                             device)
    if d.mode == "bits":
        return random_bits_plain(d.key, d.shape, d.cols, device)
    raise ValueError(f"unknown draw mode {d.mode!r}")


def empty(d: Draw, device, lead=()):
    """An uninitialised tensor for the draw ``d`` on ``device`` (its shape,
    with ``lead`` axes in front; int32 bits on the card, int64 on the
    CPU)."""
    _, _, _, n = _rows_cols(d.shape, d.cols)
    dtype = (torch.float32 if d.mode != "bits" else
             torch.int32 if _on_card(device) else torch.int64)
    return torch.empty(tuple(lead) + _out_shape(d.shape, n), dtype=dtype,
                       device=device)


def draw(table, device="cpu", out=None):
    """Every :class:`Draw` of ``table``, as a list of tensors on ``device``,
    or written into ``out`` (one tensor per draw, of the draw's shape, dtype
    and device, e.g. the frames of one stacked tensor) and returned.

    On the card one kernel launch draws up to :data:`_MAX_DRAWS` of them
    (the table is cut into as many launches as it needs), each into its own
    output rows, which need a column stride of 1 and a row stride that
    fits 32 bits; the bits come as int32. On the CPU each draw is its plain
    version, the bits as int64."""
    table = list(table)
    if out is not None and len(out) != len(table):
        raise ValueError(f"{len(out)} outputs for {len(table)} draws")
    if not _on_card(device):
        plain = [draw_plain(d, device) for d in table]
        if out is None:
            return plain
        for o, p in zip(out, plain):
            o.copy_(p)
        return out
    if out is None:
        out = [empty(d, device) for d in table]
    for at in range(0, len(table), _MAX_DRAWS):
        _launch(table[at:at + _MAX_DRAWS], out[at:at + _MAX_DRAWS])
    return out


# -------------------------------------------------------------- the card ---

class _DrawArgs(ctypes.Structure):
    """One draw as the kernel takes it (``GpetDrawArgs`` in
    csrc/threefry_normal_kernel.cu)."""
    _fields_ = [("out", ctypes.c_void_p), ("k0", ctypes.c_uint32),
                ("k1", ctypes.c_uint32), ("rows", ctypes.c_int),
                ("S_tot", ctypes.c_int), ("c0", ctypes.c_int),
                ("ncols", ctypes.c_int), ("row_stride", ctypes.c_int),
                ("mode", ctypes.c_int), ("lo", ctypes.c_float),
                ("span", ctypes.c_float)]


def _args(d: Draw, o) -> _DrawArgs:
    rows, S_tot, c0, n = _rows_cols(d.shape, d.cols)
    want = (torch.int32 if d.mode == "bits" else torch.float32)
    if o.dtype != want:
        raise TypeError(f"threefry: a {d.mode} draw writes {want} on the "
                        f"card, not {o.dtype}")
    if tuple(o.shape) != _out_shape(d.shape, n):
        raise ValueError(f"threefry: output {tuple(o.shape)} for a "
                         f"{_out_shape(d.shape, n)} draw")
    view = o.reshape(rows, n) if o.numel() else o.reshape(rows, 0)
    if view.data_ptr() != o.data_ptr() or (n > 1 and view.stride(1) != 1):
        raise ValueError("threefry: output rows need a column stride of 1")
    row_stride = view.stride(0) if rows > 1 else n
    if max(S_tot, rows, row_stride) > 2 ** 31 - 1:
        raise ValueError(f"threefry: a ({rows}, {S_tot}) draw with rows "
                         f"{row_stride} apart does not fit 32-bit offsets")
    if d.mode == "normal":
        lo, span = _bounds(NORMAL_LO, 1.0)
    else:
        lo, span = _bounds(d.minval, d.maxval)
    return _DrawArgs(o.data_ptr(), d.key[0], d.key[1], rows, S_tot, c0, n,
                     row_stride, _MODE[d.mode], lo, span)


def _launch(table, out):
    if any(o.device != out[0].device or o.device.type != "cuda"
           for o in out):
        raise ValueError(f"threefry: outputs on "
                         f"{sorted({str(o.device) for o in out})}, not on "
                         f"one card")
    args = (_DrawArgs * len(table))(*(_args(d, o) for d, o in zip(table,
                                                                   out)))
    if all(a.rows * a.ncols == 0 for a in args):
        return
    lib = cuda_build.library()
    with torch.cuda.device(out[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpet_threefry_table(args, len(table), stream)
    cuda_build.check(rc, "threefry")
    LAUNCHES["threefry"] += 1


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def random_bits(key, shape, cols=slice(None), device="cpu"):
    """The uint32 random bits of columns ``cols`` of the ``shape`` draw of
    ``key``: int64 on the CPU (the plain version), the same bit patterns
    as int32 on the card (the kernel)."""
    return draw([Draw("bits", key, shape, cols)], device)[0]


def uniform(key, shape, minval=0.0, maxval=1.0, cols=slice(None),
            device="cpu"):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, or its
    columns ``cols``, on ``device``."""
    return draw([Draw("uniform", key, shape, cols, minval, maxval)],
                device)[0]


def normal(key, shape, cols=slice(None), device="cpu"):
    """``jax.random.normal(key, shape, float32)``, or its columns ``cols``,
    on ``device``."""
    return draw([Draw("normal", key, shape, cols)], device)[0]
