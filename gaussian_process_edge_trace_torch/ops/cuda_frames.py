"""Frame-batched products (K8) and row sums (K9) whose order of operations
does not depend on the number of frames.

The tracing loop takes a leading frame axis at every stage, and a batch
frame must give the bits of its single trace. cuBLAS's batched product and
``torch.sum`` on the card choose their kernel, and so their order of adds,
by the number of frames; these two kernels fix every sum's order by the
shapes of one frame, so one launch serves all frames:

- **K8**, :func:`frames_product` (``csrc/frames_product_kernel.cu``):
  ``C[f] = A[f] @ B[f]``, either operand given once for every frame (a
  matrix without the frame axis, not expanded into a copy); each element a
  chain of fused multiply-adds in ascending k. A shared operand that is zero
  more than ``band`` off its diagonal (the KDE blur's Toeplitz factors)
  lets a tile skip the k-tiles outside the band, which changes no value.
  It serves the sampling round's cross product and the blur's two products.
- **K9**, :func:`row_sum` (``csrc/row_sum_kernel.cu``): the sum over the
  last axis of every row in one launch, one warp a row in an order set by
  the row's length. It serves the loop's sums over a frame's row
  (``models/gpr.py::frame_sum``).

Neither replaces a Pallas kernel: the JAX package leaves both to XLA. Each
wrapper takes its plain version (``torch.matmul``, ``torch.sum``) only for
tensors on the CPU, where the library keeps one order per matrix and per
sum and the JAX package's parity is checked; for a CUDA tensor it launches
the kernel or raises. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.ops import cuda_build

LAUNCHES = {"frames_product": 0, "row_sum": 0}

# The launchers' constants: K8's output tile (rows, columns), its k-tile and
# threads per block; K9's threads per block (one warp a row).
TILE_M = 128
TILE_N = 128
TILE_K = 8
THREADS = 256
ROW_SUM_THREADS = 256


def _ceil(a, b):
    return -(-a // b)


def product_launch_plan(F, M, N, K):
    """How K8 runs ``F`` frames of (M, K) @ (K, N): a pure function of the
    shapes that mirrors the launcher. ``grid`` (column tiles, row tiles,
    frames), ``blocks``, ``threads`` per block and ``smem_bytes`` of one
    block (two stages of the transposed A tile, its rows padded by 4, and
    the B tile)."""
    grid = (_ceil(N, TILE_N), _ceil(M, TILE_M), F)
    return {"grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            "threads": THREADS,
            "smem_bytes": 4 * 2 * TILE_K * (TILE_M + 4 + TILE_N)}


def product_k_range(K, row0, col0, a_band=None, b_band=None):
    """The k range ``[lo, hi)`` that K8's tile at (``row0``, ``col0``)
    walks, ``lo`` rounded down to a k-tile: all of K, or where a band
    operand is nonzero over the tile's rows (A) or columns (B)."""
    lo, hi = 0, K
    if a_band is not None:
        lo, hi = max(lo, row0 - a_band), min(hi, row0 + TILE_M + a_band)
    if b_band is not None:
        lo, hi = max(lo, col0 - b_band), min(hi, col0 + TILE_N + b_band)
    return lo // TILE_K * TILE_K, hi


def row_sum_launch_plan(rows):
    """K9's launch for ``rows`` rows: ``blocks`` of ``threads``, one warp a
    row."""
    per_block = ROW_SUM_THREADS // 32
    return {"blocks": _ceil(rows, per_block), "threads": ROW_SUM_THREADS}


# --- K8 --------------------------------------------------------------------

def _operands(a, b):
    """(F, lead, a_shared, b_shared) of ``a`` (..., M, K) or (M, K) and
    ``b`` (..., K, N) or (K, N); raises on other shapes."""
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"a (..., M, K) and b (..., K, N) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    la, lb = a.shape[:-2], b.shape[:-2]
    if la and lb and la != lb:
        raise ValueError(f"frame axes differ: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    lead = la or lb
    F = 1
    for d in lead:
        F *= d
    return F, lead, not la and bool(lb), not lb and bool(la)


def frames_product_plain(a, b):
    """Plain version of K8: ``torch.matmul``, a shared operand broadcast."""
    return torch.matmul(a, b)


def frames_product_cuda(a, b, a_band=None, b_band=None):
    """K8 on the card: ``a`` (F, M, K) or shared (M, K) times ``b``
    (F, K, N) or shared (K, N), extra leading axes flattened into the
    frames; (M, K) @ (K, N) is one frame. ``a_band`` / ``b_band``: the
    shared operand is zero more than that many places off its diagonal."""
    F, lead, a_shared, b_shared = _operands(a, b)
    for band, shared, name in ((a_band, a_shared, "a"),
                               (b_band, b_shared, "b")):
        if band is not None and (band < 0 or (lead and not shared)):
            raise ValueError(f"{name}_band needs a shared {name} and a "
                             f"band >= 0, got {band}")
    M, K = a.shape[-2:]
    N = b.shape[-1]
    af = a.contiguous()
    bf = b.contiguous()
    cuda_build.check_tensors("frames_product", af, bf)
    C = torch.empty(lead + (M, N), dtype=af.dtype, device=af.device)
    if F and M and N:
        if K == 0:
            return C.zero_()
        lib = cuda_build.library()
        with torch.cuda.device(af.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gpet_frames_product(
                af.data_ptr(), bf.data_ptr(), C.data_ptr(), F, M, N, K,
                int(a_shared), int(b_shared),
                -1 if a_band is None else int(a_band),
                -1 if b_band is None else int(b_band), stream)
        cuda_build.check(rc, "frames_product")
        LAUNCHES["frames_product"] += 1
    return C


def frames_product(a, b, a_band=None, b_band=None):
    """``a @ b`` over a leading frame axis, either operand shared by every
    frame (given without the axis): K8 on the card, ``torch.matmul`` on
    the CPU."""
    if a.device.type == "cpu":
        return frames_product_plain(a, b)
    return frames_product_cuda(a, b, a_band, b_band)


# --- K9 --------------------------------------------------------------------

def row_sum_plain(x):
    """Plain version of K9: ``torch.sum`` over the last axis."""
    return x.sum(-1)


def row_sum_cuda(x):
    """K9 on the card: the sum over the last axis of every row of ``x``
    (..., n) in one launch."""
    xf = x.contiguous()
    cuda_build.check_tensors("row_sum", xf)
    n = x.shape[-1]
    rows = xf.numel() // n if n else 0
    out = torch.zeros(x.shape[:-1], dtype=xf.dtype, device=xf.device)
    if rows:
        lib = cuda_build.library()
        with torch.cuda.device(xf.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gpet_row_sum(xf.data_ptr(), out.data_ptr(), rows, n,
                                  stream)
        cuda_build.check(rc, "row_sum")
        LAUNCHES["row_sum"] += 1
    return out


def row_sum(x):
    """The sum over the last axis of (..., n) rows: K9 on the card, each
    row in an order set by n alone; ``torch.sum`` on the CPU."""
    if x.device.type == "cpu":
        return row_sum_plain(x)
    return row_sum_cuda(x)
