"""The least time of K7 (the draws, ``csrc/threefry_normal_kernel.cu``) and
K8 (the frame-batched product, ``csrc/frames_product_kernel.cu``), beside
``work.py``'s bounds of the other kernels.

``work_k8`` and ``work_threefry`` with its per-element work are frozen
copies of ``chip_smoke.py`` (:352-356, :1077-1112) at commit
4060fc1922cd1785256dd2bdd9d9470e23f41c99. K7's bound also takes its
instructions at the card's issue rate, at the H100 SXM's largest SM clock
as NVIDIA publishes it (1,980 MHz; ``chip_smoke.py`` reads the card's
``clocks.max.sm`` instead). A normal's work depends on its uniform's arm of
log1p and of erf_inv; the shares here are those of a uniform on (−1, 1),
which a draw of 10⁷ elements meets to four digits.
"""

from __future__ import annotations

import math

from gpet_bench import work

SMS = 132
INSTRUCTIONS_PER_SM = 4 * 32      # warp-instructions of 32 threads a clock
SM_CLOCK_HZ = 1.98e9

# Work per element, as (float32 operations with a fused multiply-add
# counted 2, instructions with one counted 1).
THREEFRY_WORK = (0, 73)
UNIFORM_WORK = (4, 6)
NORMAL_WORK = (21, 13)
W_LT_WORK, W_GE_WORK = (1, 1), (2, 2)
LOG1P_SMALL_WORK = (31, 18)
LOG1P_LARGE_WORK = (34, 27)
# A normal's uniform u on (−1, 1) takes log1p(−u²)'s rational arm where
# u² < √2 − 1, and erf_inv's w ≥ 5 where log1p(−u²) ≤ −5.
SMALL_SHARE = math.sqrt(math.sqrt(2.0) - 1.0)
GE_SHARE = 1.0 - math.sqrt(1.0 - math.exp(-5.0))


def work_k8(B, M, N, K, a_shared=False, b_shared=False, band=None):
    """(bytes, operations) of B products (M, K) @ (K, N): each input read
    once (a shared operand once for every frame), C written once; a
    multiply-add for each k that meets the band of a banded factor
    (2·band + 1 a row), else each k."""
    k_need = K if band is None else min(K, 2 * band + 1)
    return (4 * (M * K * (1 if a_shared else B) + K * N * (1 if b_shared
                                                           else B)
                 + B * M * N), 2 * B * M * N * k_need)


def work_threefry(n, normal=True, small=SMALL_SHARE, ge=GE_SHARE):
    """(bytes, float32 operations, instructions) of ``n`` draws, the
    output written once; for normals ``small`` is the share of elements on
    log1p's rational arm and ``ge`` that with w >= 5."""
    parts = [(THREEFRY_WORK, 1), (UNIFORM_WORK, 1)]
    if normal:
        parts += [(NORMAL_WORK, 1), (W_LT_WORK, 1 - ge), (W_GE_WORK, ge),
                  (LOG1P_SMALL_WORK, small), (LOG1P_LARGE_WORK, 1 - small)]
    per = [sum(w[i] * share for w, share in parts) for i in range(2)]
    return (4 * n,) + tuple(n * p for p in per)


def bound_k7(n_bytes, n_ops, instructions):
    """(seconds, "bytes", "operations" or "issue"): ``work.bound`` with the
    instructions at the issue rate as a third floor."""
    t, kind = work.bound(n_bytes, n_ops)
    issue = instructions / (INSTRUCTIONS_PER_SM * SMS * SM_CLOCK_HZ)
    return (issue, "issue") if issue > t else (t, kind)


def bound_k8(B, M, N, K, **kw):
    """Seconds: ``work.bound`` of :func:`work_k8`."""
    return work.bound(*work_k8(B, M, N, K, **kw))[0]


def iteration_table_s(r, n_train, S):
    """K7's least time for one iteration's table: the (r, S) prior and
    (n_train, S) noise normals."""
    return bound_k7(*work_threefry((r + n_train) * S))[0]
