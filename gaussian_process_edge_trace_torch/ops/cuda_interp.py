"""Curve-cost kernels K1 and K2 and their plain PyTorch versions.

Counterpart of ``gaussian_process_edge_trace_tpu/ops/pallas_interp.py``:

- **K1**, :func:`fused_curve_cost` (``csrc/fused_cost_kernel.cu``): per
  sample, the non-uniform Simpson line integral of the interpolated gradient
  column plus ``kde_thresh`` and the uniform Simpson arc length, in one pass
  (:func:`k1_launch_plan` sizes its launch).
  Replaces ``_fused_cost_call`` (pallas_interp.py:230), including its
  ``with_transpose`` arm: at S >= 8192 it can also write ``ys`` transposed,
  which ``best_curves`` then takes rows from.
- **K2**, :func:`column_interp` (``csrc/column_interp_kernel.cu``):
  ``out[e, s] = lerp(cols[e, :], clip(ys[e, s], 0, M-1)) + add_const``
  (:func:`k2_launch_plan` sizes its launch). Replaces
  ``_column_interp_pallas_2l`` (:167) and ``_column_interp_pallas`` (:57),
  two TPU forms of one function. It scores the curves of an odd edge
  length, which K1 does not serve, and every trace's final cost.

Both take a leading frame axis: ``ys`` (B, E, S) with ``cols`` (B, E, M),
or one (E, M) that every frame shares (the frames of a multi-edge trace),
and one launch serves all B frames. The launch plans depend on (E, M, S)
alone, so a frame's output is bitwise that of a single-frame launch.

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
from gaussian_process_edge_trace_torch.ops.sums import fixed_sum

# "fused_cost_transpose" counts the K1 launches that also wrote samples_t.
LAUNCHES = {"fused_cost": 0, "fused_cost_transpose": 0, "column_interp": 0}

# K1 writes the transposed samples only from this S up, as the reference
# does (pallas_interp.py:427).
_TRANSPOSE_MIN_S = 8192

# K1 (csrc/fused_cost_kernel.cu): threads per block (one sample each at a
# time), the most pair windows of one chunk (kPairs), the transpose tile's
# row stride, and the blocks per SM its plan aims for (each block holds its
# chunk's rows of cols in shared memory).
_K1_THREADS = 256
_K1_PAIRS = 8
_K1_TILE_LD = 34
_K1_BLOCKS_PER_SM = 2

# K2 (csrc/column_interp_kernel.cu): threads per block, the blocks its tiled
# layout aims for (eight blocks of _K2_THREADS per SM), and the fewest
# samples a tile of one column may hold.
_K2_THREADS = 256
_K2_TARGET_BLOCKS = 8 * cuda_build.SMS
_K2_MIN_SPAN = 1024


def fused_cost_eligible(E: int, M: int, S: int) -> bool:
    """The reference's fused-kernel gate without its backend test
    (pallas_interp.py:447-449): even E, E >= 16, S >= 128 and
    M >= 4*_H_for(M), which holds exactly when M >= 16."""
    return E % 2 == 0 and E >= 16 and S >= 128 and M >= 16


def _frames(cols, ys):
    """``(B, cols_shared)`` of a launch: ys (E, S) or (B, E, S) frames, cols
    (E, M), shared by every frame, or (B, E, M). Raises on other shapes."""
    shared = cols.dim() == 2
    if (ys.dim() not in (2, 3) or cols.dim() not in (2, ys.dim())
            or cols.shape[-2] != ys.shape[-2]
            or cols.shape[:-2] != ys.shape[:cols.dim() - 2]):
        raise ValueError(f"cols (E, M) or (B, E, M) and ys (E, S) or "
                         f"(B, E, S) expected, got {tuple(cols.shape)} and "
                         f"{tuple(ys.shape)}")
    if cols.shape[-1] < 2:
        raise ValueError("interpolation needs M >= 2 rows")
    B = ys.shape[0] if ys.dim() == 3 else 1
    if not 1 <= B <= 65535:
        raise ValueError(f"1 to 65535 frames per launch, got {B}")
    return B, int(shared)


# --- K2: column interpolation ---------------------------------------------

def column_interp_plain(cols, ys, add_const=0.0):
    """Plain version of K2: the gather formulation of the reference
    (``_column_interp_gather``, pallas_interp.py:458-466), with the kernel's
    frame axis."""
    M = cols.shape[-1]
    cols = cols.expand(ys.shape[:-1] + (M,))
    y = torch.clamp(ys, 0, M - 1)
    r0 = torch.clamp(torch.floor(y), 0, M - 2)
    fr = (y - r0).to(cols.dtype)
    r0 = r0.long()
    v0 = torch.gather(cols, -1, r0)
    v1 = torch.gather(cols, -1, r0 + 1)
    res = v0 + fr * (v1 - v0)
    return res + add_const if add_const else res


def k2_launch_plan(E: int, M: int, S: int):
    """K2's launch. ``layout`` "tiled" where a column's samples outweigh
    the column (S >= 64 and 2·S >= M, the column fitting shared memory): an
    (E, ``tiles``) grid, block (e, t) staging cols[e, :] (``smem_bytes``;
    the launcher's own count is ``gpet_column_interp_smem``) and taking the
    ``span`` samples from t·span of row e. The rows are split into tiles
    only as far as the grid falls short of ``_K2_TARGET_BLOCKS``, and no
    tile holds fewer than ``_K2_MIN_SPAN`` samples. Else ``layout`` "flat":
    one thread per element in ``blocks`` blocks (the final cost, S = 1).
    ``tiles``, ``span`` and ``blocks`` are those of one frame; B frames take
    B times the blocks. Raises where neither fits an int index."""
    if E < 1 or M < 2 or S < 1:
        raise ValueError(f"column_interp: no launch for E={E}, M={M}, S={S}")
    threads = _K2_THREADS
    smem = 4 * M
    if S >= 64 and 2 * S >= M and smem <= cuda_build.SMEM_LIMIT:
        tiles = min(max(1, _K2_TARGET_BLOCKS // E),
                    max(1, S // _K2_MIN_SPAN), 65535)
        span = -(-S // tiles)
        span = -(-span // 4) * 4
        tiles = -(-S // span)
        return {"layout": "tiled", "tiles": tiles, "span": span,
                "threads": threads, "blocks": E * tiles, "smem_bytes": smem}
    if E * S >= 2 ** 31:
        raise ValueError(f"column_interp: E*S = {E * S} elements do not fit "
                         f"the flat layout's int index")
    return {"layout": "flat", "tiles": 0, "span": S, "threads": threads,
            "blocks": -(-E * S // threads), "smem_bytes": 0}


def column_interp_cuda(cols, ys, add_const=0.0):
    """K2 on the card, one launch for every frame."""
    B, shared = _frames(cols, ys)
    cuda_build.check_tensors("column_interp", cols, ys)
    E, M = cols.shape[-2:]
    S = ys.shape[-1]
    plan = k2_launch_plan(E, M, S)
    if plan["layout"] == "flat" and B * E * S >= 2 ** 31:
        raise ValueError(f"column_interp: B*E*S = {B * E * S} elements do "
                         f"not fit the flat layout's int index")
    out = torch.empty(ys.shape, dtype=torch.float32, device=ys.device)
    lib = cuda_build.library()
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpet_column_interp(cols.data_ptr(), ys.data_ptr(),
                                    out.data_ptr(), E, M, S,
                                    float(add_const), plan["tiles"],
                                    plan["span"], plan["threads"], B, shared,
                                    stream)
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
    are step[1:]. ``ys`` is (E, S) or (B, E, S); returns ``(line, arc)``,
    each (S,) or (B, S). Both sums over E are :func:`fixed_sum`s, whose
    order on the card depends on E alone, so a frame's costs are bitwise
    those of a batch of one."""
    dy = torch.diff(ys, dim=-2)
    step = torch.sqrt(1.0 + dy * dy)
    line = simpson_nonuniform(grad_score[..., :-1, :], h=step[..., 1:, :],
                              even=even, axis=-2)
    arc_w = simpson_weights(torch.arange(ys.shape[-2] - 1, dtype=ys.dtype,
                                         device=ys.device), even=even)
    return line, fixed_sum(arc_w[:, None] * step, -2)


def fused_cost_plain(cols, ys, kde_thresh=0.0, with_transpose=False):
    """Plain version of K1: gather interpolation, then
    :func:`line_and_arc`. Returns ``(line, arc)``, each (S,) (or (B, S)),
    and with ``with_transpose`` also ``ys`` transposed as a contiguous
    (S, E) (or (B, S, E)) tensor."""
    line, arc = line_and_arc(
        column_interp_plain(cols, ys, add_const=kde_thresh), ys)
    if with_transpose:
        return line, arc, ys.transpose(-1, -2).contiguous()
    return line, arc


def k1_launch_plan(E: int, M: int, S: int, with_transpose: bool = False,
                   plan_samples=None):
    """K1's launch: ``pairs_per_chunk`` pair windows per chunk
    (gridDim.y = ``n_chunks``), ``samples_per_block`` samples per block
    (gridDim.x = ``sample_groups``), ``threads`` per block, so each thread
    takes ``samples_per_thread`` samples in turn, ``blocks`` in all and the
    dynamic shared memory of one block (``smem_bytes``: the chunk's
    2·pairs_per_chunk+1 rows of cols and, with the copy, one transpose tile
    per warp; the launcher's own count is ``gpet_fused_cost_smem``).

    The grid is one wave of ``_K1_BLOCKS_PER_SM`` blocks per SM: chunks of
    up to ``_K1_PAIRS`` pairs, a multiple of 4 so that every chunk
    starts on an 8-row (32-byte) boundary of ``samples_t``, fewer where
    the samples alone cannot fill the wave, and the samples split into
    groups of whole thread tiles. Tall columns take fewer pairs per chunk,
    then one block per SM. The plan is that of one frame: B frames take B
    times the blocks (gridDim.z) and the same chunks, so the order of a
    frame's sums does not depend on B. The chunks follow from
    ``plan_samples`` (default S): a shard's launch over S/k of a sample
    group's S samples, planned on S, sums every sample in the chunks of a
    launch over S, so its costs are bitwise those columns of that launch.
    Raises where nothing fits."""
    if E % 2 or E < 4:
        raise ValueError(f"fused cost kernel requires even E >= 4, got {E}")
    if M < 2 or S < 1:
        raise ValueError(f"fused cost kernel requires M >= 2 and S >= 1, "
                         f"got M={M}, S={S}")
    P = (E - 2) // 2
    threads = _K1_THREADS
    # The chunks do not depend on the copy, so neither do the sums.
    tiles = (threads // 32) * 2 * _K1_PAIRS * _K1_TILE_LD * 4
    per_sm = cuda_build.SMEM_PER_SM // _K1_BLOCKS_PER_SM - 1024
    cap = ((per_sm - tiles) // (4 * M) - 1) // 2
    if cap < 1:                        # tall columns: one block per SM
        cap = ((cuda_build.SMEM_LIMIT - tiles) // (4 * M) - 1) // 2
    if cap < 1:
        raise ValueError(f"fused cost kernel: M={M} rows do not fit shared "
                         f"memory")
    target = _K1_BLOCKS_PER_SM * cuda_build.SMS
    planned = S if plan_samples is None else int(plan_samples)
    want = -(-P * -(-planned // threads) // target)  # pairs: chunks × groups
    ppc = min(_K1_PAIRS, max(4, -(-want // 4) * 4),
              cap if cap < 4 else cap // 4 * 4, P)
    n_chunks = -(-P // ppc)
    groups_max = -(-S // threads)
    groups = min(groups_max, max(1, round(target / n_chunks)))
    spb = threads * -(-groups_max // groups)
    groups = -(-S // spb)
    smem = 4 * (2 * ppc + 1) * M + (tiles if with_transpose else 0)
    if n_chunks > 65535:
        raise ValueError(f"fused cost kernel: no launch fits E={E}")
    return {"pairs_per_chunk": ppc, "n_chunks": n_chunks,
            "samples_per_block": spb, "sample_groups": groups,
            "threads": threads, "samples_per_thread": spb // threads,
            "blocks": groups * n_chunks, "smem_bytes": smem}


def fused_cost_cuda(cols, ys, kde_thresh=0.0, with_transpose=False,
                    plan_samples=None):
    """K1 on the card, one launch (and one chunk sum) for every frame.
    Requires even E >= 4. Returns what :func:`fused_cost_plain` returns; the
    transposed copy is written by the kernel itself. ``plan_samples``: see
    :func:`k1_launch_plan`."""
    B, shared = _frames(cols, ys)
    cuda_build.check_tensors("fused_cost", cols, ys)
    E, M = cols.shape[-2:]
    S = ys.shape[-1]
    plan = k1_launch_plan(E, M, S, with_transpose, plan_samples)
    lead = ys.shape[:-2]
    f32 = dict(dtype=torch.float32, device=ys.device)
    partial = torch.empty((B, plan["n_chunks"], 2, S), **f32)
    line = torch.empty(lead + (S,), **f32)
    arc = torch.empty(lead + (S,), **f32)
    samples_t = torch.empty(lead + (S, E), **f32) if with_transpose else None
    lib = cuda_build.library()
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpet_fused_cost(
            cols.data_ptr(), ys.data_ptr(), partial.data_ptr(),
            line.data_ptr(), arc.data_ptr(),
            samples_t.data_ptr() if with_transpose else None, E, M, S,
            float(kde_thresh), plan["pairs_per_chunk"], plan["n_chunks"],
            plan["samples_per_block"], plan["threads"], B, shared, stream)
    cuda_build.check(rc, "fused_cost")
    LAUNCHES["fused_cost"] += 1
    if with_transpose:
        LAUNCHES["fused_cost_transpose"] += 1
        return line, arc, samples_t
    return line, arc


def fused_curve_cost(cols, ys, kde_thresh=0.0, want_transpose=False,
                     plan_samples=None):
    """``(line_integral, arc_length, samples_t)`` of every curve: K1 for
    CUDA tensors, the plain version on the CPU (pallas_interp.py:430-454).
    ``samples_t`` is ``ys`` transposed to (S, E) (per frame) when
    ``want_transpose`` and S >= ``_TRANSPOSE_MIN_S``, else ``None``; the
    reference pads its columns to E_pad, the port does not.
    ``plan_samples``: see :func:`k1_launch_plan`."""
    wt = bool(want_transpose) and ys.shape[-1] >= _TRANSPOSE_MIN_S
    if ys.device.type == "cpu":
        out = fused_cost_plain(cols, ys, kde_thresh, with_transpose=wt)
    else:
        out = fused_cost_cuda(cols, ys, kde_thresh, with_transpose=wt,
                              plan_samples=plan_samples)
    return out if wt else (*out, None)
