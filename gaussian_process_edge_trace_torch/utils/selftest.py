"""On-card checks of the hand-written kernels K1-K6.

Port of ``gaussian_process_edge_trace_tpu/utils/selftest.py``. The CPU
tests run the kernels' plain PyTorch versions, since a CUDA kernel has no
interpret mode; this module pins each kernel to its plain version on the
card itself, at small shapes, with the GPU tests' tolerances
(``tests/test_torch_cuda.py``):

- K1 ``fused_cost_kernel.cu`` (the fused curve cost), line within rtol
  1e-4 and arc within 1e-5 of the plain version, with and without the
  transposed copy, which equals ``ys.T``;
- K2 ``column_interp_kernel.cu`` (column interpolation), bitwise, tiled
  and flat;
- K3 ``binning_2l_kernel.cu`` (KDE binning), within rtol 1e-5 and
  1e-6·max|H| of the dense plain version;
- K4 ``binning_dense_kernel.cu`` (KDE binning in the dense order), bitwise
  the sequential plain version, one frame and four frames in one launch;
- K5 ``batched_chol_kernel.cu`` (batched Cholesky) and K6
  ``batched_trsm_kernel.cu`` (batched triangular solves, m = 1 and m > 1,
  forward and backward), within 2e-5·max|·|, at n = 104 (direct) and
  n = 240 (the blocked path).

The JAX self-test's TPU-only checks are not ported: the bf16 three-way
split and the one-hot take / top-k equivalences exist for the TPU's MXU,
and the port has no such helpers (its kernels compute in plain float32).

Entry point: :func:`run_selftest` (returns ``[(name, seconds), ...]``,
raises on a mismatch). It needs a card and raises without one; it does not
run on the CPU in place of the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _curves(rng, E, M, S):
    y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
    y[:, :2] = rng.uniform(-3 - M, -1, (E, 2))     # beyond both clamp edges
    y[:, 2:4] = rng.uniform(M, 2 * M, (E, 2))
    return y


def _kept(rng, E, S, M):
    y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
    y[:, :4] = [0.0, M - 1.0, M // 3, -1.0]
    y[::3, 4] = float(M)
    w = 1.0 / rng.uniform(0.5, 2.0, S)
    return y, w / w.sum()


def _close(got, want, name, rtol=0.0, atol=0.0):
    bad = ~(torch.abs(got - want) <= atol + rtol * torch.abs(want))
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} of {bad.numel()} "
                             "elements outside the tolerance")


def _equal(got, want, name):
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise equal to the plain "
                             "version")


def _check_k1(rng, dev):
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    for E, M, S in ((500, 500, 1000), (38, 61, 8197)):
        cols = torch.tensor(rng.random((E, M)), dtype=torch.float32,
                            device=dev)
        ys = torch.tensor(_curves(rng, E, M, S), dtype=torch.float32,
                          device=dev)
        pline, parc = ci.fused_cost_plain(cols, ys, 1e-3)
        line, arc = ci.fused_cost_cuda(cols, ys, 1e-3)
        _close(line, pline, f"K1 line {E}x{M}x{S}", rtol=1e-4)
        _close(arc, parc, f"K1 arc {E}x{M}x{S}", rtol=1e-5)
        line_t, arc_t, ys_t = ci.fused_cost_cuda(cols, ys, 1e-3,
                                                 with_transpose=True)
        _equal(ys_t, ys.T.contiguous(), "K1 transposed copy")
        _equal(line_t, line, "K1 line with the copy")
        _equal(arc_t, arc, "K1 arc with the copy")


def _check_k2(rng, dev):
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    E, M = 499, 500
    cols = torch.tensor(rng.random((E, M)), dtype=torch.float32, device=dev)
    for S in (1, 1000):
        ys = torch.tensor(rng.uniform(-20, M + 20, (E, S)),
                          dtype=torch.float32, device=dev)
        _equal(ci.column_interp_cuda(cols, ys, 1e-3),
               ci.column_interp_plain(cols, ys, 1e-3), f"K2 S={S}")


def _check_k3(rng, dev):
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
    for E, S, M in ((500, 100, 500), (37, 33, 129)):
        y, w = (torch.tensor(a, dtype=torch.float32, device=dev)
                for a in _kept(rng, E, S, M))
        ref = ck.column_binning_plain(y, w, M)
        _close(ck.binning_2l_cuda(y, w, M), ref, f"K3 {E}x{S}x{M}",
               rtol=1e-5, atol=1e-6 * ref.abs().max().item())


def _check_k4(rng, dev):
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
    E, S, M = 300, 200, 400
    kept = [_kept(rng, E, S, M) for _ in range(4)]
    y = torch.tensor(np.stack([k[0] for k in kept]), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(np.stack([k[1] for k in kept]), dtype=torch.float32,
                     device=dev)
    H = ck.binning_dense_cuda(y, w, M)
    _equal(H, ck.column_binning_sequential(y, w, M), "K4 four frames")
    _equal(ck.binning_dense_cuda(y[0], w[0], M), H[0], "K4 one frame")


def _spd(rng, B, n):
    A = rng.normal(size=(B, n, n))
    return A @ np.transpose(A, (0, 2, 1)) / n + np.eye(n)


def _check_k5_k6(rng, dev):
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    for n in (104, 240):
        K = torch.tensor(_spd(rng, 8, n), dtype=torch.float32, device=dev)
        Lp = cc.cholesky_plain(K)
        _close(cc.cholesky_auto(K), Lp, f"K5 n={n}",
               atol=2e-5 * Lp.abs().max().item())
        for m in (1, 8):
            R = torch.tensor(rng.normal(size=(8, n, m)), dtype=torch.float32,
                             device=dev)
            for transpose, solve in ((False, cc.forward_solve_auto),
                                     (True, cc.backward_solve_auto)):
                Zp = cc.solve_plain(Lp, R, transpose)
                _close(solve(Lp, R), Zp,
                       f"K6 n={n} m={m} {'backward' if transpose else 'fwd'}",
                       atol=2e-5 * Zp.abs().max().item())


_CHECKS = [
    ("fused_cost_vs_plain", _check_k1),
    ("column_interp_vs_plain", _check_k2),
    ("binning_2l_vs_plain", _check_k3),
    ("binning_dense_frames_vs_sequential", _check_k4),
    ("cholesky_and_solves_vs_plain", _check_k5_k6),
]


def run_selftest(log=None):
    """Run every check on the card; raise on a mismatch (AssertionError)
    or where there is no card (RuntimeError). Returns ``[(name, seconds),
    ...]``; ``log``, if given, is called with one line per check."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_selftest checks the CUDA kernels on the "
                           "card, and no CUDA device is available "
                           "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda", torch.cuda.current_device())
    results = []
    for name, fn in _CHECKS:
        t0 = time.perf_counter()
        fn(np.random.default_rng(0), dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results.append((name, dt))
        if log is not None:
            log(f"selftest {name}: ok ({dt:.2f}s, "
                f"{torch.cuda.get_device_name(dev)})")
    return results
