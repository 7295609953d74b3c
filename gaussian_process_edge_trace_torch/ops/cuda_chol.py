"""Batched small-matrix Cholesky (K5) and triangular solves (K6).

Counterpart of ``gaussian_process_edge_trace_tpu/ops/pallas_chol.py``:

- **K5**, :func:`batched_cholesky` (``csrc/batched_chol_kernel.cu``): the
  lower factor of each of B SPD (n, n) matrices; a non-PD matrix gives NaN,
  not an error. Replaces ``_batched_cholesky_impl`` (pallas_chol.py:218).
- **K6**, :func:`batched_forward_solve` / :func:`batched_backward_solve`
  (``csrc/batched_trsm_kernel.cu``): ``L Z = R`` and ``Lᵀ Z = R``. Replaces
  ``_solve_one_block`` (pallas_chol.py:274).

The direct kernels hold a whole matrix in shared memory and take
n <= ``_DIRECT_N`` (223: the largest n whose layout, :func:`launch_plan`,
fits one block's shared memory in both kernels, so the 1000² config's
n = 208 runs direct); :func:`cholesky_auto`, :func:`forward_solve_auto` and
:func:`backward_solve_auto` run a blocked right-looking orchestration above
that (pallas_chol.py:334-410): panels through the kernels, trailing updates
as batched ``torch.matmul`` (as the reference leaves them to XLA), on the
card one per frame, so a frame's factor does not depend on the batch. On the
CPU the plain versions run whole only up to ``_CPU_DIRECT_N`` = 160 and
blocked above it: run whole at n = 176, the CPU parity test of the
coarse-to-fine fit moves one column of the integer trace against the JAX
package (:func:`runs_direct`).

Extra leading axes flatten into the batch. Each wrapper takes its plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises. ``LAUNCHES`` counts kernel launches; ``BLOCKED`` counts the calls
that took the blocked orchestration, each of which launches its kernel once
per panel.
"""

from __future__ import annotations

import torch

from gaussian_process_edge_trace_torch.ops import cuda_build

LAUNCHES = {"cholesky": 0, "trsm": 0}
BLOCKED = {"cholesky": 0, "forward": 0, "backward": 0}

_PANEL = 128        # panel width of the blocked orchestration
_CPU_DIRECT_N = 160  # largest n the plain versions take whole on the CPU

# The launchers' constants (csrc/batched_chol_kernel.cu,
# csrc/batched_trsm_kernel.cu): threads per block, the panel / row-tile
# width, right-hand-side columns per block, and the dynamic shared memory
# one block may use on sm_90.
THREADS = 256
TILE = 32
CHUNK = 32
SMEM_LIMIT = cuda_build.SMEM_LIMIT


def _round4(x):
    return (x + 3) // 4 * 4


def smem_ld(n):
    """Row stride (floats) of a matrix in shared memory: n rounded up to a
    multiple of 4 with an odd number of float4s, so float4 reads of 8
    consecutive rows at one column fall in 8 distinct bank groups."""
    return 4 * (((n + 3) // 4) | 1)


def _smem_bytes(n, m):
    """Shared memory of one direct block: K5 when ``m`` is None, else K6
    with ``m`` right-hand-side columns (its m = 1 kernel, or the wide one,
    whose layout does not depend on m)."""
    ld = smem_ld(n)
    if m is None:
        floats = (n * ld + TILE * _round4(max(n - TILE, 1)) + TILE * TILE
                  + TILE)
    elif m == 1:
        floats = n * ld + ld + THREADS
    else:
        floats = n * (ld + CHUNK) + TILE
    return 4 * floats


def _largest_direct_n():
    n = 1
    while all(_smem_bytes(n + 1, m) <= SMEM_LIMIT for m in (None, 1, 2)):
        n += 1
    return n


# Largest n the direct kernels take: both fit one block's shared memory.
_DIRECT_N = _largest_direct_n()     # 223


def runs_direct(n, device):
    """Whether the ``*_auto`` functions take an (n, n) problem on ``device``
    whole: on the card up to ``_DIRECT_N``; on the CPU up to
    ``_CPU_DIRECT_N`` too, where the blocked form keeps the CPU parity with
    the JAX package that the tests hold."""
    limit = _DIRECT_N
    if torch.device(device).type != "cuda":
        limit = min(limit, _CPU_DIRECT_N)
    return n <= limit


def launch_plan(n, m=None):
    """How an (n, n) problem runs on the card: K5 when ``m`` is None, K6
    with ``m`` right-hand-side columns otherwise. A pure function of the
    shapes that mirrors the launchers: ``direct`` (one kernel launch, else
    the blocked orchestration in panels of ``_PANEL``), ``threads`` per
    block, ``chunk`` (right-hand-side columns per block; None for K5) and
    ``smem_bytes`` of one direct block."""
    chunk = None if m is None else 1 if m == 1 else CHUNK
    return {"direct": n <= _DIRECT_N, "threads": THREADS, "chunk": chunk,
            "smem_bytes": _smem_bytes(n, m)}


def _flat(x, tail):
    """(..., *tail) → (B, *tail) and the leading shape."""
    lead = x.shape[:x.dim() - tail]
    return x.reshape((-1,) + tuple(x.shape[x.dim() - tail:])), lead


# --- K5 --------------------------------------------------------------------

def cholesky_plain(K):
    """Plain version of K5: ``torch.linalg.cholesky_ex``, with NaN for every
    matrix whose factorisation failed (``info > 0``), the reference's
    contract for non-PD input."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cholesky_cuda(K):
    """K5 on the card, n <= ``_DIRECT_N``."""
    Kf, lead = _flat(K, 2)
    Kf = Kf.contiguous()
    cuda_build.check_tensors("batched_cholesky", Kf)
    B, n, n2 = Kf.shape
    if n != n2 or n > _DIRECT_N:
        raise ValueError(f"batched_cholesky takes square n <= {_DIRECT_N}, "
                         f"got {tuple(K.shape)}")
    L = torch.empty_like(Kf)
    if B:
        lib = cuda_build.library()
        with torch.cuda.device(Kf.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gpet_batched_cholesky(Kf.data_ptr(), L.data_ptr(), B, n,
                                           stream)
        cuda_build.check(rc, "batched_cholesky")
        LAUNCHES["cholesky"] += 1
    return L.reshape(lead + (n, n))


def batched_cholesky(K):
    """Lower Cholesky factor of a (..., n, n) batch, n <= ``_DIRECT_N``."""
    if K.device.type == "cpu":
        return cholesky_plain(K)
    return cholesky_cuda(K)


# --- K6 --------------------------------------------------------------------

def solve_plain(L, R, transpose: bool):
    """Plain version of K6: ``torch.linalg.solve_triangular``."""
    if transpose:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), R,
                                             upper=True)
    return torch.linalg.solve_triangular(L, R, upper=False)


def solve_cuda(L, R, transpose: bool):
    """K6 on the card, n <= ``_DIRECT_N``."""
    Lf, lead = _flat(L, 2)
    Rf, lead_r = _flat(R, 2)
    Lf = Lf.contiguous()
    Rf = Rf.contiguous()
    cuda_build.check_tensors("batched_trsm", Lf, Rf)
    B, n, _ = Lf.shape
    if (Rf.shape[0] != B or Rf.shape[1] != n or Lf.shape[2] != n
            or lead != lead_r):
        raise ValueError(f"L (B, n, n) and R (B, n, m) expected, got "
                         f"{tuple(L.shape)} and {tuple(R.shape)}")
    if n > _DIRECT_N:
        raise ValueError(f"batched_trsm takes n <= {_DIRECT_N}, got {n}")
    m = Rf.shape[2]
    Z = torch.empty_like(Rf)
    if B and m:
        lib = cuda_build.library()
        with torch.cuda.device(Lf.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gpet_batched_trsm(Lf.data_ptr(), Rf.data_ptr(),
                                       Z.data_ptr(), B, n, m,
                                       int(bool(transpose)), stream)
        cuda_build.check(rc, "batched_trsm")
        LAUNCHES["trsm"] += 1
    return Z.reshape(R.shape)


def batched_forward_solve(L, R):
    """Solve ``L Z = R`` for a (..., n, n) lower batch, R (..., n, m)."""
    if R.device.type == "cpu":
        return solve_plain(L, R, False)
    return solve_cuda(L, R, False)


def batched_backward_solve(L, R):
    """Solve ``Lᵀ Z = R`` for a (..., n, n) lower batch, R (..., n, m)."""
    if R.device.type == "cpu":
        return solve_plain(L, R, True)
    return solve_cuda(L, R, True)


# --- blocked orchestration above the direct limit ----------------------------

def _product(a, b):
    """``a @ b`` for the blocked orchestration's trailing updates, (F, ...)
    batches of matrices: on the card one batched product per leading frame,
    each as a single trace (F = 1) forms it, since cuBLAS chooses its
    kernel, and so its order of operations, by the batch size; one product
    on the CPU, where the library keeps one order per matrix."""
    if a.device.type != "cuda" or a.dim() < 3 or a.shape[0] == 1:
        return a @ b
    return torch.cat([a[f:f + 1] @ b[f:f + 1] for f in range(a.shape[0])])


def cholesky_auto(K):
    """Batched lower Cholesky for any n: the direct kernel up to
    ``_DIRECT_N``, blocked panels above it (see :func:`runs_direct`)."""
    if runs_direct(K.shape[-1], K.device):
        return batched_cholesky(K)
    return _cholesky_blocked(K)


def _cholesky_blocked(K):
    BLOCKED["cholesky"] += 1
    n = K.shape[-1]
    L = torch.zeros_like(K)
    off = 0
    while off < n:
        w = min(_PANEL, n - off)
        Lrow = L[..., off:off + w, :off]
        D = (K[..., off:off + w, off:off + w]
             - _product(Lrow, Lrow.transpose(-1, -2)))
        Lkk = batched_cholesky(D.contiguous())
        L[..., off:off + w, off:off + w] = Lkk
        if off + w < n:
            Lbelow = L[..., off + w:, :off]
            R = (K[..., off + w:, off:off + w]
                 - _product(Lbelow, Lrow.transpose(-1, -2)))
            # Solve X Lkkᵀ = R  ⇔  Lkk Xᵀ = Rᵀ.
            Xt = batched_forward_solve(Lkk, R.transpose(-1, -2).contiguous())
            L[..., off + w:, off:off + w] = Xt.transpose(-1, -2)
        off += w
    return L


def forward_solve_auto(L, R):
    """Blocked-capable ``L Z = R`` (see :func:`cholesky_auto`)."""
    n = R.shape[-2]
    if runs_direct(n, R.device):
        return batched_forward_solve(L, R)
    BLOCKED["forward"] += 1
    Z = torch.zeros_like(R)
    off = 0
    while off < n:
        w = min(_PANEL, n - off)
        Lrow = L[..., off:off + w, :off]
        rhs = R[..., off:off + w, :] - _product(Lrow, Z[..., :off, :])
        Z[..., off:off + w, :] = batched_forward_solve(
            L[..., off:off + w, off:off + w].contiguous(), rhs.contiguous())
        off += w
    return Z


def backward_solve_auto(L, R):
    """Blocked-capable ``Lᵀ Z = R``."""
    n = R.shape[-2]
    if runs_direct(n, R.device):
        return batched_backward_solve(L, R)
    BLOCKED["backward"] += 1
    Z = torch.zeros_like(R)
    for off in reversed(range(0, n, _PANEL)):
        w = min(_PANEL, n - off)
        Lcol = L[..., off + w:, off:off + w]
        rhs = (R[..., off:off + w, :]
               - _product(Lcol.transpose(-1, -2), Z[..., off + w:, :]))
        Z[..., off:off + w, :] = batched_backward_solve(
            L[..., off:off + w, off:off + w].contiguous(), rhs.contiguous())
    return Z
