"""KDE binning kernels K3 and K4 and their plain PyTorch version.

Counterpart of ``gaussian_process_edge_trace_tpu/trace/pallas_kde.py``. Both
kernels compute one function, the linear binning of the kept curves onto the
padded (M+2)-row grid column by column,

    H[m, e] = Σ_s w_s·max(0, 1 − |y[e,s] + 1 − m|),  w = 0 where y ∉ [0, M−1],

returned as (M+2, E) float32:

- **K3**, :func:`binning_2l_cuda` (``csrc/binning_2l_kernel.cu``): the
  adjoint of linear interpolation, two taps per sample, summed per row by
  a warp 32 samples at a time (:func:`k3_launch_plan` sizes its launch).
  Replaces ``_binning_2l`` (pallas_kde.py:153). The main path runs it for
  every number of kept curves.
- **K4**, :func:`binning_dense_cuda` (``csrc/binning_dense_kernel.cu``): the
  dense per-column hat GEMV's order, every row summed over the samples in
  index order, with the exact zeros skipped (:func:`k4_launch_plan` sizes
  its launch). Replaces ``_binning_pallas`` (:199); reached only with
  ``use_pallas=True``, as in the reference.
- :func:`column_binning_plain`: the dense hat contraction of the reference's
  ``_binning_dense_chunked`` (:259), in chunks of kept curves. The CPU runs
  it; on the card only the checks do.
- :func:`column_binning_sequential`: the same terms added one sample at a
  time in sample order, the order K4 keeps; only the tests and
  ``chip_smoke.py`` call it.

Every version takes a leading frame axis, y (B, E, S) with w (B, S), and
returns (B, M+2, E); one K3 or K4 launch serves all frames (the frame is
gridDim.y), and each plan depends on (E, S, M) alone, so a frame's output is
bitwise that of a single-frame launch.

The wrappers take CUDA tensors only and raise otherwise; ``LAUNCHES`` counts
kernel launches. Neither kernel uses float atomics: reruns are bitwise
equal.
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.ops import cuda_build

LAUNCHES = {"binning_2l": 0, "binning_dense": 0}

# Target size of one hat-contraction block, (M+2)·E·chunk elements; more
# kept curves are binned in chunks of this size (pallas_kde.py:256).
_CHUNK_ELEMS = 128 * 1024 * 1024

# K3 (binning_2l_kernel.cu): columns per block, at most, and the warps its
# plan aims for, about sixteen per SM.
_K3_COLS = 4
_K3_TARGET_WARPS = 16 * cuda_build.SMS

# K4 (binning_dense_kernel.cu): threads per column (two warps), the most
# columns per block, and the most samples of a column a block takes at a
# time.
_K4_COL_THREADS = 64
_K4_COLS = 4
_K4_TILE = 4096


def k3_launch_plan(E: int, S: int, M: int):
    """K3's launch: ``cols`` columns per block, ``warps_per_col`` warps
    per column, each over ``batches_per_warp`` batches of 32 samples (the
    last warp of a column may have fewer), ``threads`` per block, ``blocks``
    and the dynamic shared memory of one block (``smem_bytes``: each warp's
    M+3 accumulators and its 3 × 32 group-order entries; the launcher's own
    count is ``gpet_binning_2l_smem``). The warps per column are raised,
    up to 8 and to one per batch, until the grid holds about
    ``_K3_TARGET_WARPS``; they, then the columns, are lowered where shared
    memory does not fit. The plan is that of one frame: B frames take B
    times the blocks (gridDim.y) and the same warps per column, so the
    order of a frame's sums does not depend on B. Raises where nothing
    fits."""
    if E < 1 or S < 0 or M < 1:
        raise ValueError(f"binning_2l: no launch for E={E}, S={S}, M={M}")
    batches = max(1, -(-S // 32))
    want = max(1, min(8, batches, -(-_K3_TARGET_WARPS // E)))
    for cols in range(min(_K3_COLS, E), 0, -1):
        for wpc in range(want, 0, -1):
            per_warp = -(-batches // wpc)
            wpc = -(-batches // per_warp)        # no warp without samples
            smem = 4 * cols * wpc * (M + 3 + 3 * 32)
            if smem <= cuda_build.SMEM_LIMIT:
                return {"cols": cols, "warps_per_col": wpc,
                        "batches_per_warp": per_warp,
                        "threads": 32 * cols * wpc,
                        "blocks": -(-E // cols), "smem_bytes": smem}
    raise ValueError(f"binning_2l: M={M} does not fit shared memory")


def k4_smem_bytes(M: int, tile: int, cols: int) -> int:
    """Shared memory of one K4 block of ``cols`` columns (the launcher's own
    count is ``gpet_binning_dense_smem``): the tile's weights, then a slice
    per column, in 4-byte words: the tile's samples and their two taps in
    row order, the rows' sums and two 16-bit counts per row, two warp
    totals and two warps' lane masks by lo>>1 (M/2 + 2 keys); each part
    16-byte aligned."""
    words = 3 * tile + 2 * (M + 2) + 2 + 2 * (M // 2 + 2)
    return (((tile + 3) & ~3) + cols * ((words + 3) & ~3)) * 4


def k4_launch_plan(E: int, S: int, M: int):
    """K4's launch: ``cols`` consecutive columns per block, a power of two
    (so a row's stores are ``cols`` consecutive floats), each column with
    two warps (``threads`` = 64·cols), ``blocks`` blocks, each column's
    samples taken ``tile`` at a time in ``tiles`` steps, and ``smem_bytes``
    of shared memory. The tile is the whole column up to ``_K4_TILE``
    samples; where shared memory does not fit, the columns per block are
    halved, then the tile. The plan is that of one frame: B frames take B
    times the blocks (gridDim.y). Raises where nothing fits."""
    if E < 1 or S < 0 or M < 1:
        raise ValueError(f"binning_dense: no launch for E={E}, S={S}, M={M}")
    tile = max(1, min(S, _K4_TILE))
    cols = 1 << (min(_K4_COLS, E).bit_length() - 1)
    while k4_smem_bytes(M, tile, cols) > cuda_build.SMEM_LIMIT:
        if cols > 1:
            cols //= 2
        elif tile > 1:
            tile = -(-tile // 2)
        else:
            raise ValueError(f"binning_dense: M={M} does not fit shared "
                             f"memory")
    return {"cols": cols, "threads": _K4_COL_THREADS * cols, "tile": tile,
            "tiles": -(-S // tile), "blocks": -(-E // cols),
            "smem_bytes": k4_smem_bytes(M, tile, cols)}


def column_binning_plain(y_curves, weights, M: int):
    """Plain version of K3 and K4: the dense hat contraction, in chunks of
    kept curves whose sums are added in order. y (E, S) with w (S,), or
    frames y (B, E, S) with w (B, S); the chunks are those of one frame."""
    E, S = y_curves.shape[-2:]
    rows = torch.arange(M + 2, dtype=y_curves.dtype, device=y_curves.device)
    zero = torch.zeros((), dtype=y_curves.dtype, device=y_curves.device)

    def block(yb, wb):
        yp = yb + 1.0
        w = torch.where((yb >= 0) & (yb <= M - 1), wb[..., None, :], zero)
        hat = torch.clamp(1.0 - torch.abs(yp[..., None, :, :]
                                          - rows[:, None, None]), min=0.0)
        return (hat * w[..., None, :, :]).sum(-1)         # (..., M+2, E)

    chunk = max(1, _CHUNK_ELEMS // ((M + 2) * E))
    H = block(y_curves[..., :chunk], weights[..., :chunk])
    for s0 in range(chunk, S, chunk):
        H = H + block(y_curves[..., s0:s0 + chunk],
                      weights[..., s0:s0 + chunk])
    return H


def column_binning_sequential(y_curves, weights, M: int):
    """The binning as a loop over the samples in index order: each sample's
    (M+2, E) term ``hat·w``, rounded on its own, is added to the running
    sum. K4 adds the same terms in the same order, so for finite weights it
    equals this bit for bit (it skips the terms that are exactly zero,
    which leave a sum that starts at +0 unchanged). y (E, S) with w (S,),
    or frames y (B, E, S) with w (B, S), each frame summed on its own.
    S steps of a few elementwise passes each: for the tests,
    ``chip_smoke.py`` and the self-test only."""
    E, S = y_curves.shape[-2:]
    rows = torch.arange(M + 2, dtype=y_curves.dtype,
                        device=y_curves.device)[:, None]
    zero = torch.zeros((), dtype=y_curves.dtype, device=y_curves.device)
    H = torch.zeros(y_curves.shape[:-2] + (M + 2, E), dtype=y_curves.dtype,
                    device=y_curves.device)
    for s in range(S):
        y = y_curves[..., s]                                 # (..., E)
        w = torch.where((y >= 0) & (y <= M - 1), weights[..., s, None], zero)
        hat = torch.clamp(1.0 - torch.abs((y + 1.0)[..., None, :] - rows),
                          min=0.0)
        H = H + hat * w[..., None, :]
    return H


def _check(name, y_curves, weights, M, frames=False):
    """Raise unless y is (E, S) with w (S,), or with ``frames`` also
    (B, E, S) with w (B, S), 1 <= B <= 65535."""
    dims = (2, 3) if frames else (2,)
    if (y_curves.dim() not in dims
            or weights.shape != y_curves.shape[:-2] + y_curves.shape[-1:]):
        raise ValueError(f"{name}: y (E, S) and w (S,)"
                         f"{' or y (B, E, S) and w (B, S)' if frames else ''}"
                         f" expected, got {tuple(y_curves.shape)} and "
                         f"{tuple(weights.shape)}")
    if y_curves.dim() == 3 and not 1 <= y_curves.shape[0] <= 65535:
        raise ValueError(f"{name}: 1 to 65535 frames per launch, got "
                         f"{y_curves.shape[0]}")
    if M < 1:
        raise ValueError(f"{name}: M >= 1 expected, got {M}")
    cuda_build.check_tensors(name, y_curves, weights)


def binning_2l_cuda(y_curves, weights, M: int):
    """K3 on the card: (M+2, E) float32, or (B, M+2, E) for B frames in
    one launch."""
    _check("binning_2l", y_curves, weights, M, frames=True)
    E, S = y_curves.shape[-2:]
    B = y_curves.shape[0] if y_curves.dim() == 3 else 1
    plan = k3_launch_plan(E, S, M)
    H = torch.empty(y_curves.shape[:-2] + (M + 2, E), dtype=torch.float32,
                    device=y_curves.device)
    lib = cuda_build.library()
    with torch.cuda.device(y_curves.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpet_binning_2l(y_curves.data_ptr(), weights.data_ptr(),
                                 H.data_ptr(), E, S, M, plan["cols"],
                                 plan["warps_per_col"],
                                 plan["batches_per_warp"], B, stream)
    cuda_build.check(rc, "binning_2l")
    LAUNCHES["binning_2l"] += 1
    return H


def binning_dense_cuda(y_curves, weights, M: int):
    """K4 on the card: (M+2, E) float32, or (B, M+2, E) for B frames in
    one launch."""
    _check("binning_dense", y_curves, weights, M, frames=True)
    E, S = y_curves.shape[-2:]
    B = y_curves.shape[0] if y_curves.dim() == 3 else 1
    plan = k4_launch_plan(E, S, M)
    H = torch.empty(y_curves.shape[:-2] + (M + 2, E), dtype=torch.float32,
                    device=y_curves.device)
    lib = cuda_build.library()
    with torch.cuda.device(y_curves.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpet_binning_dense(y_curves.data_ptr(), weights.data_ptr(),
                                    H.data_ptr(), E, S, M, plan["tile"],
                                    plan["cols"], B, stream)
    cuda_build.check(rc, "binning_dense")
    LAUNCHES["binning_dense"] += 1
    return H


def column_binning(y_curves, weights, M: int, use_pallas: bool = False):
    """Binned column masses H (M+2, E), or (B, M+2, E) for frames, for the
    curve KDE (pallas_kde.py:225): K3 for CUDA tensors, K4 with
    ``use_pallas``, the plain version on the CPU. The reference's
    ``_2L_MIN_S`` gate is a TPU crossover and is not carried over: K3 runs
    at every S."""
    if y_curves.device.type == "cpu":
        return column_binning_plain(y_curves, weights, M)
    if use_pallas:
        return binning_dense_cuda(y_curves, weights, M)
    return binning_2l_cuda(y_curves, weights, M)
