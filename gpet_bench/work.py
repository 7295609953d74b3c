"""The yardstick's arithmetic: the card's peaks, each kernel's least time,
and the float32 operations that one trace's algorithm needs.

``bound``, ``work_k1``, ``work_k2``, ``work_binning``, ``work_k5`` and
``work_k6`` are frozen copies of ``chip_smoke.py`` (:326-327, :393-435) at
commit b71f8113f0c7ad4e79e6543cfb6e16f28479a0e3, without the issue-rate
term, which only K7's bound takes: each input read once and each output
written once, 3.35 TB/s of device memory and 67 TFLOP/s of float32
outside the tensor cores (one H100 SXM at 700 W, NVIDIA's data sheet).

``trace_flops`` counts the algorithm, not an implementation of it: every
dense product 2·m·k·n, a Cholesky factor n³/3, a triangular solve with m
right-hand sides n²·m, each elementwise pass its operations per element,
with the training set of each round as large as its valid observations
(not the padded buffer), and the final fit's LML evaluations as its
optimiser's schedule makes them.
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(n_bytes, n_ops):
    """(seconds, "bytes" or "operations"): the least time the card could
    take for work that moves ``n_bytes`` and does ``n_ops`` float32
    operations (a fused multiply-add counts 2)."""
    by_bytes = n_bytes / MEM_BYTES_PER_S
    by_ops = n_ops / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def work_k1(E, M, S, transpose, B=1, shared=False):
    """(bytes, operations) of K1, the fused curve cost."""
    per = E * S + 2 * S + (S * E if transpose else 0)
    return 4 * (E * M * (1 if shared else B) + B * per), 23 * E * S * B


def work_k2(E, M, S, B=1, shared=False):
    """K2, the column interpolation: at most two entries of a column per
    sample."""
    cols = min(E * M, 2 * E * S) * (1 if shared else B)
    return 4 * (2 * E * S * B + cols), 8 * E * S * B


def work_binning(E, S, M, B=1):
    """K3, the KDE's binning: two taps of ~10 operations per sample."""
    return 4 * B * (E * S + S + (M + 2) * E), 10 * E * S * B


def work_k5(B, n):
    """K5, the batched Cholesky: the lower triangle in, the factor out."""
    return 4 * B * (n * (n + 1) // 2 + n * n), B * n ** 3 / 3


def work_k6(B, n, m):
    """K6, the batched triangular solve."""
    return 4 * B * (n * (n + 1) // 2 + 2 * n * m), B * n * n * m


# Operations per element of the elementwise passes.
KERNEL_EVAL = 7      # |x - x'|, / ℓ, d·d, · -1/2, exp, · c
CURVE_COST = 23      # K1's count per (column, sample) of the curve cost
BINNING = 10         # per kept (column, curve), as work_binning
BLUR_TAPS = 17       # the KDE's Gaussian, radius 8, two passes
COMBINE = 4          # f0 + K·A, · scale, + mean, · y_s per curve point
SCORE = 4            # kde·grad + kde + grad, / 3
MINMAX = 2


def lml_value_flops(n):
    """One LML value at n valid points: Gram, factor, one solve, the
    quadratic form and the log-determinant."""
    return KERNEL_EVAL * n * n + n ** 3 / 3 + n * n + 3 * n


def lml_grad_flops(n):
    """One LML value and its gradient: the value, α by a second solve, K⁻¹
    from the factor (2n³/3), ααᵀ − K⁻¹, ∂K/∂log ℓ and three traces."""
    return (lml_value_flops(n) + n * n + 2 * n ** 3 / 3 + 2 * n * n
            + 4 * n * n + 6 * n * n)


def polish_flops(n, starts, n_polish, iters, d=3, candidates=6):
    """A screen of ``starts`` values, then ``iters`` damped-Newton steps of
    ``n_polish`` points: 2d + 1 gradients (central differences) and
    ``candidates`` values each."""
    P = min(n_polish, starts)
    return (starts * lml_value_flops(n)
            + iters * P * ((2 * d + 1) * lml_grad_flops(n)
                           + candidates * lml_value_flops(n)))


def sampling_flops(E, S, r, n):
    """One sampling round at n valid training points: Gram and factor, the
    prior draw at the training and output columns, noise and residual, the
    solve with S right-hand sides, the cross Gram and product, and the
    combination."""
    return (KERNEL_EVAL * n * n + n + n ** 3 / 3
            + 2 * (n + E) * r * S + (n + E) * S + 3 * n * S
            + 2 * n * n * S + KERNEL_EVAL * E * n + 2 * E * n * S
            + COMBINE * E * S)


def iteration_flops(E, M, N, S, N_keep, r, n):
    """One outer iteration: sampling, the curve costs, the KDE of the kept
    curves (binning, blur, min-max) and the selection's scores."""
    return (sampling_flops(E, S, r, n) + CURVE_COST * E * S + 2 * N_keep
            + BINNING * E * N_keep
            + 2 * 2 * BLUR_TAPS * (M + 2) * (N + 2) + MINMAX * M * N
            + SCORE * M * N)


def final_fit_flops(E, n, n_train, restarts=12, grid=96, direct_n=160):
    """The LML fit (the starts and the grid screened, polished; above
    ``direct_n`` slots coarse on a stride-subsampled set, then two starts
    polished at full size), the fit at θ and the prediction with its std on
    the E grid columns, and the final mean curve's cost."""
    starts = 1 + restarts + grid
    if n_train <= direct_n:
        fit = polish_flops(n, starts, 8, 4)
    else:
        stride = -(-n_train // 112)
        fit = (polish_flops(-(-n // stride), starts, 8, 4)
               + polish_flops(n, 2, 2, 3))
    gp = KERNEL_EVAL * n * n + n ** 3 / 3 + 2 * n * n
    pred = KERNEL_EVAL * E * n + 2 * E * n + n * n * E + 2 * n * E + E
    return fit + gp + pred + 6 * E + CURVE_COST * E


def trace_flops(sizes: dict, n_iters: int, iter_nobs) -> float:
    """Float32 operations of one trace that ran ``n_iters`` iterations with
    ``iter_nobs[k]`` observations accepted after iteration k; ``sizes``
    holds E, M, N, S, N_keep, r (the prior factor's rank), n_inits and
    n_train."""
    E, M, N = sizes["E"], sizes["M"], sizes["N"]
    S, keep, r, n0 = sizes["S"], sizes["N_keep"], sizes["r"], sizes["n_inits"]
    total = 0.0
    for k in range(n_iters):
        n = n0 + (int(iter_nobs[k - 1]) if k else 0)
        total += iteration_flops(E, M, N, S, keep, r, n)
    n_fit = n0 + (int(iter_nobs[n_iters - 1]) if n_iters else 0)
    return total + final_fit_flops(E, n_fit, sizes["n_train"])
