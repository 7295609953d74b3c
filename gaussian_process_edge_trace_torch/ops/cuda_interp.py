"""Curve-cost kernels K1 and K2 and their plain PyTorch versions.

Counterpart of ``gaussian_process_edge_trace_tpu/ops/pallas_interp.py``:

- **K1**, :func:`fused_curve_cost` (``csrc/fused_cost_kernel.cu``): per
  sample, the non-uniform Simpson line integral of the interpolated gradient
  column plus ``kde_thresh`` and the uniform Simpson arc length, in one pass.
  Replaces ``_fused_cost_call`` (pallas_interp.py:230), including its
  ``with_transpose`` arm: at S >= 8192 it can also write ``ys`` transposed,
  which ``best_curves`` then takes rows from.
- **K2**, :func:`column_interp` (``csrc/column_interp_kernel.cu``):
  ``out[e, s] = lerp(cols[e, :], clip(ys[e, s], 0, M-1)) + add_const``.
  Replaces ``_column_interp_pallas_2l`` (:167) and ``_column_interp_pallas``
  (:57), two TPU forms of one function.

Each wrapper takes its plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel, or raises if the kernel cannot run; it never
falls back. ``LAUNCHES`` counts kernel launches, one per wrapper call that
launched.
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.ops import cuda_build
from gaussian_process_edge_trace_torch.ops.integrate import (
    simpson_nonuniform, simpson_weights)

# "fused_cost_transpose" counts the K1 launches that also wrote samples_t.
LAUNCHES = {"fused_cost": 0, "fused_cost_transpose": 0, "column_interp": 0}

# Pair windows per K1 chunk (gridDim.y), shrunk for tall columns so the
# staged rows of cols stay within 48 KB of shared memory.
_PAIRS_PER_CHUNK = 8

# K1 writes the transposed samples only from this S up, as the reference
# does (pallas_interp.py:427).
_TRANSPOSE_MIN_S = 8192

# K1's block width (threads per block, one sample each).
_K1_THREADS = 128


def fused_cost_eligible(E: int, M: int, S: int) -> bool:
    """The reference's fused-kernel gate without its backend test
    (pallas_interp.py:447-449): even E, E >= 16, S >= 128 and
    M >= 4*_H_for(M), which holds exactly when M >= 16."""
    return E % 2 == 0 and E >= 16 and S >= 128 and M >= 16


def _check_shapes(cols, ys):
    if cols.dim() != 2 or ys.dim() != 2 or cols.shape[0] != ys.shape[0]:
        raise ValueError(f"cols (E, M) and ys (E, S) expected, got "
                         f"{tuple(cols.shape)} and {tuple(ys.shape)}")
    if cols.shape[1] < 2:
        raise ValueError("interpolation needs M >= 2 rows")


# --- K2: column interpolation ---------------------------------------------

def column_interp_plain(cols, ys, add_const=0.0):
    """Plain version of K2: the gather formulation of the reference
    (``_column_interp_gather``, pallas_interp.py:458-466)."""
    M = cols.shape[1]
    y = torch.clamp(ys, 0, M - 1)
    r0 = torch.clamp(torch.floor(y), 0, M - 2)
    fr = (y - r0).to(cols.dtype)
    r0 = r0.long()
    v0 = torch.gather(cols, 1, r0)
    v1 = torch.gather(cols, 1, r0 + 1)
    res = v0 + fr * (v1 - v0)
    return res + add_const if add_const else res


def column_interp_cuda(cols, ys, add_const=0.0):
    """K2 on the card."""
    _check_shapes(cols, ys)
    cuda_build.check_tensors("column_interp", cols, ys)
    E, M = cols.shape
    S = ys.shape[1]
    out = torch.empty((E, S), dtype=torch.float32, device=ys.device)
    lib = cuda_build.library()
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpet_column_interp(cols.data_ptr(), ys.data_ptr(),
                                    out.data_ptr(), E, M, S,
                                    float(add_const), stream)
    cuda_build.check(rc, "column_interp")
    LAUNCHES["column_interp"] += 1
    return out


def column_interp(cols, ys, add_const=0.0):
    """Linear interpolation of ``cols[e, :]`` at rows ``ys[e, :]`` plus
    ``add_const``: K2 for CUDA tensors, the plain version on the CPU."""
    if ys.device.type == "cpu":
        return column_interp_plain(cols, ys, add_const)
    return column_interp_cuda(cols, ys, add_const)


# --- K1: fused curve cost --------------------------------------------------

def line_and_arc(grad_score, ys, even="simpson"):
    """The unfused curve-cost sums of the reference
    (``trace/scoring.py::curve_costs``, :97-118) on a unit-spaced x grid:
    ``simpson_nonuniform(grad_score[:-1], h=step[1:])`` and the arc length
    from ``simpson_weights``, with ``step = sqrt(1 + dy²)``. The curvilinear
    coordinate cumsum(step) enters Simpson only through its widths, which
    are step[1:]. Returns ``(line, arc)``, each (S,)."""
    dy = torch.diff(ys, dim=0)
    step = torch.sqrt(1.0 + dy * dy)
    line = simpson_nonuniform(grad_score[:-1], h=step[1:], even=even, axis=0)
    arc_w = simpson_weights(torch.arange(ys.shape[0] - 1, dtype=ys.dtype,
                                         device=ys.device), even=even)
    return line, (arc_w[:, None] * step).sum(0)


def fused_cost_plain(cols, ys, kde_thresh=0.0, with_transpose=False):
    """Plain version of K1: gather interpolation, then
    :func:`line_and_arc`. Returns ``(line, arc)``, each (S,), and with
    ``with_transpose`` also ``ys.T`` as a contiguous (S, E) tensor."""
    line, arc = line_and_arc(
        column_interp_plain(cols, ys, add_const=kde_thresh), ys)
    if with_transpose:
        return line, arc, ys.T.contiguous()
    return line, arc


def _pairs_per_chunk(M: int) -> int:
    rows = (48 * 1024) // (4 * M)           # rows of cols in 48 KB
    return max(1, min(_PAIRS_PER_CHUNK, (rows - 1) // 2))


def fused_cost_cuda(cols, ys, kde_thresh=0.0, with_transpose=False):
    """K1 on the card. Requires even E >= 4. Returns what
    :func:`fused_cost_plain` returns; the transposed copy is written by the
    kernel itself."""
    _check_shapes(cols, ys)
    cuda_build.check_tensors("fused_cost", cols, ys)
    E, M = cols.shape
    S = ys.shape[1]
    if E % 2 or E < 4:
        raise ValueError(f"fused cost kernel requires even E >= 4, got {E}")
    ppc = _pairs_per_chunk(M)
    smem = (2 * ppc + 1) * M * 4
    if with_transpose:
        smem += (2 * ppc + 2) * (_K1_THREADS + 1) * 4
    if smem > 227 * 1024:
        raise ValueError(f"M={M} rows do not fit the kernel's shared memory")
    n_chunks = -(-((E - 2) // 2) // ppc)
    f32 = dict(dtype=torch.float32, device=ys.device)
    partial = torch.empty((n_chunks, 2, S), **f32)
    line = torch.empty((S,), **f32)
    arc = torch.empty((S,), **f32)
    samples_t = torch.empty((S, E), **f32) if with_transpose else None
    lib = cuda_build.library()
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpet_fused_cost(
            cols.data_ptr(), ys.data_ptr(), partial.data_ptr(),
            line.data_ptr(), arc.data_ptr(),
            samples_t.data_ptr() if with_transpose else None, E, M, S,
            float(kde_thresh), ppc, n_chunks, stream)
    cuda_build.check(rc, "fused_cost")
    LAUNCHES["fused_cost"] += 1
    if with_transpose:
        LAUNCHES["fused_cost_transpose"] += 1
        return line, arc, samples_t
    return line, arc


def fused_curve_cost(cols, ys, kde_thresh=0.0, want_transpose=False):
    """``(line_integral, arc_length, samples_t)`` of every curve: K1 for
    CUDA tensors, the plain version on the CPU (pallas_interp.py:430-454).
    ``samples_t`` is ``ys`` transposed to (S, E) when ``want_transpose``
    and S >= ``_TRANSPOSE_MIN_S``, else ``None``; the reference pads its
    columns to E_pad, the port does not."""
    wt = bool(want_transpose) and ys.shape[1] >= _TRANSPOSE_MIN_S
    fn = fused_cost_plain if ys.device.type == "cpu" else fused_cost_cuda
    out = fn(cols, ys, kde_thresh, with_transpose=wt)
    return out if wt else (*out, None)
