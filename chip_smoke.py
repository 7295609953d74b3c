#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build from ``gaussian_process_edge_trace_torch/csrc`` with
   ``nvcc`` (set-up time);
3. each hand-written kernel (K1 fused curve cost with its transposed-samples
   output, K2 column interpolation, K3 two-level adjoint binning, K4 dense
   binning, K5 batched Cholesky, K6 batched triangular solves) against its
   plain PyTorch version on CUDA tensors, at the main paths' shapes, with
   the tolerance stated beside each check (K1 and K3 at both traces'
   shapes, K3 also at its worst cases: every sample in one row, every
   sample outside the image, S = 1; K5 and K6 at every batch of the final
   fit, n = 104 and 208 direct, n = 408 blocked; each rerun bitwise);
   the kernel's time, the plain version's, the time of one PyTorch library
   call that computes the same function where there is one (many calls
   back to back in one CUDA graph between one event pair, over the count:
   ``cuda_ms``), and the least time the card could take (bytes over
   3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is larger);
4. the README demo config (500×500, RBF σf=75 ℓ=20, 1000 samples, δx=5)
   traced through ``GP_Edge_Tracing(...)()`` for seeds 1-3: the launch
   counts of every kernel during those traces (K5 and K6 per trace), MSE
   and DICE against the true edge with the accuracy gates of ``bench.py``
   (median DICE > 0.985, every seed > 0.97), a rerun of seed 1 that must
   give the same trace, and the warm wall time per trace;
5. the 1000² config (``benchmarks/suite.py`` config 4: RBF σf=200 ℓ=50,
   S=10⁴, δx=5) traced the same way for seeds 1-3: iterations, MSE, DICE
   (gates: median > 0.97, every seed > 0.95, the spread of the JAX package
   itself there: ``tests/torch_reference_1000.py`` reads DICE 0.963-0.980
   over its seeds 1-10 on a CPU, and the port's CPU path gives the
   reference's trace from the reference's draws), the launches of K1 (and
   how many wrote the transposed copy), K2, K3, K5 and K6 (per trace too),
   peak device memory, a rerun of seed 1 that must be identical and the
   warm wall time;
6. ``curve_kde(..., use_pallas_binning=True)`` at that config's kept-curve
   shape, which launches K4, held against the K3 KDE;
7. one ``torch.profiler`` trace of each config: device busy and idle share,
   the top device operations, K1, K3, K5 and K6 per launch, K1 + K3 device
   time per trace, the final fit's
   (``finish_trace``) host time and share of the wall time, and peak memory;
8. one JSON line of kernel results, the card line again, and as the last
   line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np

DEMO_SEEDS = (1, 2, 3)
BIG_SEEDS = (1, 2, 3)

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory bytes/s and float32 operations/s outside the tensor cores.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, target_ms=10.0, rounds=5):
    """Device time of one call of ``fn`` in ms: ``reps`` back-to-back calls
    captured in one CUDA graph, the graph replayed between one CUDA event
    pair, the elapsed time divided by ``reps``; the median of ``rounds``
    replays. ``reps`` is set from one warm call so a replay lasts about
    ``target_ms`` (3 to 400 calls). A graph keeps the host's launch gaps
    out of kernels of a few µs, which the host cannot enqueue as fast as
    the card runs them; the inputs stay in L2 between calls, as they are
    for the caller, which has just written them."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    reps = int(min(400, max(3, target_ms / max(a.elapsed_time(b), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves ``n_bytes`` and does ``n_ops`` float32 operations."""
    by_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# Work of each kernel's function at its shape: (bytes, float32 operations).
# Each input is read once and each output written once; operations are
# counted from the kernels' arithmetic per element.
def work_k1(E, M, S, transpose):
    return 4 * (E * M + E * S + 2 * S + (S * E if transpose else 0)), \
        23 * E * S


def work_k2(E, M, S):
    # The lerp touches at most two entries of cols per sample.
    return 4 * (2 * E * S + min(E * M, 2 * E * S)), 8 * E * S


def work_binning(E, S, M):
    # The adjoint: two taps of ~10 operations per sample.
    return 4 * (E * S + S + (M + 2) * E), 10 * E * S


# K5 and K6 need only the lower triangle of their input, n(n+1)/2 entries;
# K5 writes the whole (n, n) factor, its upper triangle zero.
def work_k5(B, n):
    return 4 * B * (n * (n + 1) // 2 + n * n), B * n ** 3 / 3


def work_k6(B, n, m):
    return 4 * B * (n * (n + 1) // 2 + 2 * n * m), B * n * n * m


class Checks:
    def __init__(self):
        self.failed = []
        self.kernels = {}

    def record(self, kernel, case, err, tol, ok, ms, plain_ms, work,
               library_ms=None, main=False, also_main=False):
        """``main``: the case whose numbers stand in the kernel's row of
        the JSON line; ``also_main``: another main-path shape, listed in
        that row's ``main_path_cases``."""
        entry = self.kernels.setdefault(kernel, {"max_abs_err": 0.0,
                                                 "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], float(err))
        b_ms, b_by = bound(*work)
        entry["cases"].append({
            "case": case, "max_abs_err": float(err), "tol": tol,
            "main": main, "also_main": also_main, "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by})
        lib = f"{library_ms:.4f} ms" if library_ms is not None else "none"
        log(f"[kernels] {kernel} {case}: max_abs_err={err:.3e} ({tol}) "
            f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  library {lib}  bound {b_ms:.4g} ms ({b_by})")
        if not ok:
            self.failed.append(f"{kernel} {case}")


def rel_err(a, b):
    """max |a - b| and that over max |b| (NaN-aware: NaN must match NaN)."""
    import torch
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf"), float("inf")
    d = (a - b).abs()[~nan_b]
    scale = b.abs()[~nan_b].max().item() if d.numel() else 1.0
    m = d.max().item() if d.numel() else 0.0
    return m, m / max(scale, 1e-30)


def curve_samples(rng, E, M, S):
    """Smooth random-walk curves like posterior draws, plus values beyond
    both clamp edges: 8 whole samples, or for S < 16 every 7th row."""
    y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
    if S >= 16:
        y[:, :4] = rng.uniform(-3 - M, -1, (E, 4))
        y[:, 4:8] = rng.uniform(M, 2 * M, (E, 4))
    else:
        y[0::14] = rng.uniform(-3 - M, -1, y[0::14].shape)
        y[7::14] = rng.uniform(M, 2 * M, y[7::14].shape)
    return y


def kept_curves(rng, E, S, M, kind="walk"):
    """Kept curves for the binning kernels; weights are normalised inverse
    costs. ``walk``: random walks around the middle row, with exact
    integers, both image edges, just-outside values and out-of-image
    sentinels. K3's worst cases: ``one row`` (every sample in one row, the
    largest group), ``outside`` (every sample outside the image, zero
    weight, the rows just beyond both edges included)."""
    if kind == "walk":
        y = M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), axis=0)
        y[:, :4] = [0.0, M - 1.0, np.floor(M / 3), -1.0][:S]
        y[::3, 4 % S] = float(M)
        y[1::3, 5 % S] = -10.0
        y[::7] = np.rint(y[::7])
    elif kind == "one row":
        y = np.full((E, S), np.floor(M / 2) + 0.25)
    else:
        y = np.where(rng.random((E, S)) < 0.5,
                     rng.uniform(-40, -1e-3, (E, S)),
                     rng.uniform(M - 1 + 1e-3, M + 40, (E, S)))
        y[:, 0] = -1.0
        y[:, -1] = float(M)
    w = 1.0 / rng.uniform(0.5, 2.0, S)
    return y, w / w.sum()


def check_k1(checks, rng, f32):
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci

    # Both sides sum ~E/2 pair terms of size ~1 in f32 in different orders:
    # the gap is f32 rounding, ~1e-6 relative; the bound is the reference's
    # own interpret-mode test bound (rtol 1e-4 line, 1e-5 arc). The
    # transposed copy must equal ys.T bit for bit, and the quadratures with
    # and without it must be bitwise equal, and so must a rerun. No single
    # PyTorch call computes this function, so there is no library time.
    # Role "main": the kernel's row of the JSON line; "also": another
    # main-path shape (the demo trace's), listed in that row.
    for case, (E, M, S), transpose, role in (
            ("demo E=M=500 S=1000", (500, 500, 1000), False, "also"),
            ("ragged E=38 M=61 S=130", (38, 61, 130), False, ""),
            ("1000² E=M=1000 S=10⁴ +transpose", (1000, 1000, 10000), True,
             "main"),
            ("ragged E=38 M=61 S=8197 +transpose", (38, 61, 8197), True, ""),
            ("M=2000 E=2000 S=8200 +transpose", (2000, 2000, 8200), True,
             "")):
        cols = torch.tensor(rng.random((E, M)), **f32)
        ys = torch.tensor(curve_samples(rng, E, M, S), **f32)
        out = ci.fused_cost_cuda(cols, ys, 1e-3, with_transpose=transpose)
        pline, parc = ci.fused_cost_plain(cols, ys, 1e-3)
        again = ci.fused_cost_cuda(cols, ys, 1e-3, with_transpose=transpose)
        torch.cuda.synchronize()
        el, rl = rel_err(out[0], pline)
        ea, ra = rel_err(out[1], parc)
        same_r = all(torch.equal(a, b) for a, b in zip(out, again))
        log(f"[kernels] K1 {case}: rerun bitwise equal: {same_r}")
        ok = rl <= 1e-4 and ra <= 1e-5 and same_r
        tol = "rel 1e-4 line, 1e-5 arc; rerun bitwise"
        if transpose:
            line0, arc0 = ci.fused_cost_cuda(cols, ys, 1e-3)
            same_t = torch.equal(out[2], ys.T.contiguous())
            same_q = torch.equal(line0, out[0]) and torch.equal(arc0, out[1])
            ok = ok and same_t and same_q
            tol += "; samples_t == ys.T bitwise"
            log(f"[kernels] K1 {case}: samples_t {tuple(out[2].shape)} "
                f"equals ys.T: {same_t}; line/arc unchanged by the copy: "
                f"{same_q}")
            if role == "main":
                checks.record(
                    "K1", case.replace("+transpose", "without the copy"),
                    max(el, ea), "as above", rl <= 1e-4 and ra <= 1e-5,
                    ms=cuda_ms(lambda: ci.fused_cost_cuda(cols, ys, 1e-3)),
                    plain_ms=cuda_ms(lambda: ci.fused_cost_plain(
                        cols, ys, 1e-3)),
                    work=work_k1(E, M, S, False))
        checks.record(
            "K1", case, max(el, ea), tol, ok,
            ms=cuda_ms(lambda: ci.fused_cost_cuda(
                cols, ys, 1e-3, with_transpose=transpose)),
            plain_ms=cuda_ms(lambda: ci.fused_cost_plain(
                cols, ys, 1e-3, with_transpose=transpose)),
            work=work_k1(E, M, S, transpose), main=role == "main",
            also_main=role == "also")


def check_k2(checks, rng, f32):
    import torch
    import torch.nn.functional as F
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci

    # Same arithmetic, each op rounded once on both sides (the kernel uses
    # the _rn intrinsics): bitwise equal is expected; the bound allows one
    # ulp. The library yardstick is grid_sample (bilinear, align_corners,
    # border padding) on the (1, 1, E, M) columns at the same points; it is
    # timed only, the port never calls it.
    for case, (E, M, S), main in (
            ("final cost E=M=500 S=1", (500, 500, 1), False),
            ("final cost E=M=1000 S=1", (1000, 1000, 1), True),
            ("E=M=500 S=1000", (500, 500, 1000), False)):
        cols = torch.tensor(rng.random((E, M)), **f32)
        ys = torch.tensor(curve_samples(rng, E, M, S), **f32)
        out = ci.column_interp_cuda(cols, ys, 1e-3)
        ref = ci.column_interp_plain(cols, ys, 1e-3)
        torch.cuda.synchronize()
        e, r = rel_err(out, ref)
        img = cols[None, None]
        gx = 2.0 * torch.clamp(ys, 0, M - 1) / (M - 1) - 1.0
        gy = (2.0 * torch.arange(E, **f32) / (E - 1) - 1.0)[:, None]
        grid = torch.stack([gx, gy.expand(E, S)], dim=-1)[None]

        def library():
            return F.grid_sample(img, grid, mode="bilinear",
                                 padding_mode="border",
                                 align_corners=True)[0, 0] + 1e-3
        le, _ = rel_err(library(), ref)
        log(f"[kernels] K2 {case}: grid_sample yardstick max_abs_err "
            f"{le:.3e} (not a gate)")
        checks.record(
            "K2", case, e, "rel 1.2e-7 (1 ulp)", r <= 1.2e-7,
            ms=cuda_ms(lambda: ci.column_interp_cuda(cols, ys, 1e-3)),
            plain_ms=cuda_ms(lambda: ci.column_interp_plain(cols, ys, 1e-3)),
            library_ms=cuda_ms(library), work=work_k2(E, M, S), main=main)


def check_binning(checks, rng, f32):
    import torch
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck

    # K3 and K4 sum the same taps as the dense plain version in other
    # orders; the bound is the reference's own test bound (test_trace.py:74):
    # |H - plain| <= 1e-5·|plain| + 1e-6·max|plain|. A K3 rerun must be
    # bitwise equal (no atomics). No single PyTorch call computes this
    # function, so there is no library time. Roles as in check_k1; the demo
    # trace's shape is a main-path shape of K3 only (K4 is off the path).
    # The last three are K3's worst cases: one group of 32 lanes per batch,
    # no weight at all, S = 1.
    for case, (E, S, M), role, kind in (
            ("1000² kept curves E=S=M=1000", (1000, 1000, 1000), "main",
             "walk"),
            ("demo kept curves E=500 S=100 M=500", (500, 100, 500), "also",
             "walk"),
            ("E=2000 S=100 M=2000", (2000, 100, 2000), "", "walk"),
            ("ragged E=37 S=33 M=129", (37, 33, 129), "", "walk"),
            ("every sample in one row E=S=M=1000", (1000, 1000, 1000), "",
             "one row"),
            ("every sample outside the image E=S=M=1000", (1000, 1000, 1000),
             "", "outside"),
            ("one kept curve E=M=1000 S=1", (1000, 1, 1000), "", "walk")):
        yn, wn = kept_curves(rng, E, S, M, kind)
        y = torch.tensor(yn, **f32)
        w = torch.tensor(wn, **f32)
        ref = ck.column_binning_plain(y, w, M)
        scale = ref.abs().max().item()
        plain_ms = cuda_ms(lambda: ck.column_binning_plain(y, w, M))
        for key, fn in (("K3", ck.binning_2l_cuda),
                        ("K4", ck.binning_dense_cuda)):
            H = fn(y, w, M)
            torch.cuda.synchronize()
            err = (H - ref).abs()
            ok = bool((err <= 1e-5 * ref.abs() + 1e-6 * scale).all().item())
            tol = "1e-5·|H| + 1e-6·max|H|"
            if key == "K3":
                same = torch.equal(H, fn(y, w, M))
                ok = ok and same
                tol += "; rerun bitwise"
                log(f"[kernels] K3 {case}: rerun bitwise equal: {same}")
            checks.record(key, case, err.max().item(), tol, ok,
                          ms=cuda_ms(lambda: fn(y, w, M)), plain_ms=plain_ms,
                          work=work_binning(E, S, M), main=role == "main",
                          also_main=role == "also" and key == "K3")


def check_chol(checks, rng, f32, dev):
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc

    def spd(B, n):
        A = rng.normal(size=(B, n, n))
        return torch.tensor(A @ np.transpose(A, (0, 2, 1)) / n + np.eye(n),
                            **f32)

    # K5 at the final fit's batches: the screen (96 grid points + 13
    # restarts), the gradient batch (7 points × 8 polished starts) and the
    # candidate values (8 × 6) at n = 104, the 1000² config's fine fit at
    # n = 208 (direct since this PR), and n = 408 (the 2000² config) through
    # the blocked orchestration. Right-looking blocked Cholesky vs cuSOLVER's
    # potrf: f32 rounding in another order, ~n·eps relative on a
    # well-conditioned batch; the bound is 2e-5 of max |L|. In the screen
    # batch one non-PD matrix must give NaN on both sides (on the kernel's
    # diagonal) and leave the others finite. A rerun must be bitwise equal.
    # The library yardstick is cholesky_ex alone.
    for case, B, n, main in (("screen B=109 n=104 (+1 non-PD -> NaN)", 109,
                              104, True),
                             ("gradient B=56 n=104", 56, 104, False),
                             ("candidates B=48 n=104", 48, 104, False),
                             ("fine fit B=14 n=208 direct", 14, 208, False),
                             ("blocked B=2 n=408", 2, 408, False)):
        K = spd(B, n)
        ok_nan = True
        if main:
            K[7] = -K[7]
        L = cc.cholesky_auto(K)
        Lp = cc.cholesky_plain(K)
        torch.cuda.synchronize()
        keep = torch.ones(B, dtype=torch.bool, device=dev)
        if main:
            keep[7] = False
            ok_nan = (torch.isnan(torch.diagonal(L[7])).any().item()
                      and torch.isnan(Lp[7]).all().item())
        e, r = rel_err(L[keep], Lp[keep])
        same = torch.equal(cc.cholesky_auto(K).view(torch.int32),
                           L.view(torch.int32))    # NaN bits too
        log(f"[kernels] K5 {case}: rerun bitwise equal: {same}")
        checks.record(
            "K5", case, e, "rel 2e-5; rerun bitwise",
            r <= 2e-5 and ok_nan and same
            and not torch.isnan(L[keep]).any().item(),
            ms=cuda_ms(lambda: cc.cholesky_auto(K)),
            plain_ms=cuda_ms(lambda: cc.cholesky_plain(K)),
            library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(K)),
            work=work_k5(B, n), main=main)

    # K6 at the final fit's solves: m = 1 forward (the dual weights, every
    # batch), m = 1 backward and m = n forward (the identity right-hand
    # side that forms K⁻¹, the gradient batch), at n = 104 and at the fine
    # fit's n = 208; m = n backward, which holds the wide kernel's
    # transposed branch; n = 408 through the blocked orchestration. Blocked
    # substitution vs cuBLAS trsm: f32 rounding in another order on
    # well-conditioned factors; the bound is 2e-5 of max |Z|; a rerun must
    # be bitwise equal. The library yardstick is solve_triangular alone.
    def library_solve(L, R, transpose):
        if transpose:
            return torch.linalg.solve_triangular(L.transpose(-1, -2), R,
                                                 upper=True)
        return torch.linalg.solve_triangular(L, R, upper=False)

    factors = {}
    for case, B, n, m, transpose, main in (
            ("screen forward B=109 n=104 m=1", 109, 104, 1, False, False),
            ("forward B=56 n=104 m=1", 56, 104, 1, False, False),
            ("backward B=56 n=104 m=1", 56, 104, 1, True, False),
            ("forward B=56 n=104 m=104", 56, 104, 104, False, True),
            ("backward B=56 n=104 m=104", 56, 104, 104, True, False),
            ("fine fit forward B=14 n=208 m=1", 14, 208, 1, False, False),
            ("fine fit backward B=14 n=208 m=1", 14, 208, 1, True, False),
            ("fine fit forward B=14 n=208 m=208", 14, 208, 208, False,
             False),
            ("blocked forward B=2 n=408 m=1", 2, 408, 1, False, False),
            ("blocked backward B=2 n=408 m=1", 2, 408, 1, True, False)):
        if (B, n) not in factors:
            factors[B, n] = cc.cholesky_plain(spd(B, n))
        Lw = factors[B, n]
        R = (torch.eye(n, **f32).expand(B, n, n).contiguous() if m == n
             else torch.tensor(rng.normal(size=(B, n, m)), **f32))
        fn = cc.backward_solve_auto if transpose else cc.forward_solve_auto
        Z = fn(Lw, R)
        Zp = cc.solve_plain(Lw, R, transpose)
        torch.cuda.synchronize()
        e, r = rel_err(Z, Zp)
        same = torch.equal(fn(Lw, R), Z)
        log(f"[kernels] K6 {case}: rerun bitwise equal: {same}")
        checks.record(
            "K6", case, e, "rel 2e-5; rerun bitwise", r <= 2e-5 and same,
            ms=cuda_ms(lambda: fn(Lw, R)),
            plain_ms=cuda_ms(lambda: cc.solve_plain(Lw, R, transpose)),
            library_ms=cuda_ms(lambda: library_solve(Lw, R, transpose)),
            work=work_k6(B, n, m), main=main)


def check_kernels(checks, dev):
    import torch
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    check_k1(checks, rng, f32)
    check_k2(checks, rng, f32)
    check_binning(checks, rng, f32)
    check_chol(checks, rng, f32, dev)
    # Release what the timing graphs left allocated before the traces, so
    # the traces' peak memory does not carry it: their pools, and the cuBLAS
    # workspace (32 MiB) made for the capture stream, which PyTorch keeps
    # and counts as allocated.
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def reset_counts():
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
    for counts in (ci.LAUNCHES, cc.LAUNCHES, ck.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts():
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
    return {"K1": ci.LAUNCHES["fused_cost"],
            "K1_transpose": ci.LAUNCHES["fused_cost_transpose"],
            "K2": ci.LAUNCHES["column_interp"],
            "K3": ck.LAUNCHES["binning_2l"],
            "K4": ck.LAUNCHES["binning_dense"],
            "K5": cc.LAUNCHES["cholesky"], "K6": cc.LAUNCHES["trsm"]}


class Config:
    """One traced configuration: its image, truth and tracer arguments."""

    def __init__(self, dev, size, amplitude, ko, n_samples):
        import gaussian_process_edge_trace_torch as gpt
        self.img, self.true_edge = gpt.construct_test_img(
            size, amplitude, 4, 0.05, "sinusoidal", 0.3, gaps=True)
        self.grad = gpt.comp_grad_img(
            self.img, gpt.kernel_builder((11, 5), unit=False), device=dev)
        self.init = self.true_edge[[0, -1]][:, [1, 0]]
        self.ko, self.n_samples, self.dev = ko, n_samples, dev
        self.size = size

    def tracer(self, seed):
        import gaussian_process_edge_trace_torch as gpt
        return gpt.GP_Edge_Tracing(self.init, self.grad, self.ko, 1,
                                   np.array([]), self.n_samples, 1, 5, 0.1, 5,
                                   seed, True, True, device=self.dev)

    def trace(self, seed):
        import torch
        tracer = self.tracer(seed)
        edge, cred = tracer()
        torch.cuda.synchronize()
        return edge, cred, tracer.last_result

    def report(self, checks, tag, seed, run):
        import gaussian_process_edge_trace_torch as gpt
        import torch
        edge, cred, res = run
        mse = gpt.trace_MSE(edge, self.true_edge)
        dice = gpt.trace_dicecoef(edge, self.true_edge)
        finite = bool(np.isfinite(cred[0]).all() and np.isfinite(cred[1]).all()
                      and torch.isfinite(res.y_mean).all().item())
        shape_ok = (edge.shape == (self.size[1], 2)
                    and cred[0].shape == (self.size[1],))
        log(f"[{tag}] seed {seed}: n_iters={res.n_iters} MSE={mse} "
            f"DICE={dice} theta={res.theta.tolist()} "
            f"final_cost={res.final_cost.item():.6f} finite={finite}")
        if not (finite and shape_ok):
            checks.failed.append(f"{tag} seed {seed}: non-finite or shape")
        return dice

    def rerun_and_wall(self, checks, tag, seed, first):
        again = self.trace(seed)[0]
        same = np.array_equal(again, first)
        log(f"[{tag}] rerun of seed {seed} identical: {same}")
        if not same:
            checks.failed.append(f"{tag} rerun differs")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            self.trace(seed)
            walls.append((time.perf_counter() - t0) * 1e3)
        log(f"[{tag}] warm wall time per trace (seed {seed}, median of "
            f"3 after warm-up): {statistics.median(walls):.2f} ms "
            f"(runs {[round(w, 2) for w in walls]})")


def per_trace(launches, tag, n_traces):
    log(f"[{tag}] K5 launches per trace {launches['K5'] / n_traces:g}, K6 "
        f"launches per trace {launches['K6'] / n_traces:g}")


def require(checks, tag, launches, keys):
    for k in keys:
        if launches[k] <= 0:
            checks.failed.append(f"{tag} did not launch {k}")


def demo(checks, dev):
    """The README demo through GP_Edge_Tracing on the card."""
    cfg = Config(dev, (500, 500), 200,
                 {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}, 1000)
    reset_counts()
    runs = {seed: cfg.trace(seed) for seed in DEMO_SEEDS}
    launches = read_counts()
    log(f"[demo] kernel launches over seeds {DEMO_SEEDS}: "
        f"{json.dumps(launches)}")
    per_trace(launches, "demo", len(DEMO_SEEDS))
    require(checks, "demo", launches, ("K1", "K2", "K3", "K5", "K6"))

    dices = [cfg.report(checks, "demo", seed, run)
             for seed, run in runs.items()]
    median = sorted(dices)[len(dices) // 2]
    gates = median > 0.985 and min(dices) > 0.97
    log(f"[demo] DICE median={median} min={min(dices)} "
        f"(gates: median > 0.985, min > 0.97) {'ok' if gates else 'FAIL'}")
    if not gates:
        checks.failed.append("demo DICE gates")
    cfg.rerun_and_wall(checks, "demo", DEMO_SEEDS[0],
                       runs[DEMO_SEEDS[0]][0])
    return cfg, launches


def big_config(dev):
    return Config(dev, (1000, 1000), 400,
                  {"kernel": "RBF", "sigma_f": 200, "length_scale": 50},
                  10000)


def big(checks, dev):
    """The 1000² S=10⁴ config through GP_Edge_Tracing on the card."""
    import torch
    cfg = big_config(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    runs = {seed: cfg.trace(seed) for seed in BIG_SEEDS}
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[1000²] kernel launches over seeds {BIG_SEEDS}: "
        f"{json.dumps(launches)}")
    per_trace(launches, "1000²", len(BIG_SEEDS))
    log(f"[1000²] peak device memory (max_memory_allocated): {peak} bytes "
        f"({peak / 2**20:.1f} MiB; {before / 2**20:.1f} MiB of it allocated "
        f"before the traces)")
    require(checks, "1000²", launches,
            ("K1", "K1_transpose", "K2", "K3", "K5", "K6"))
    dices = [cfg.report(checks, "1000²", seed, run)
             for seed, run in runs.items()]
    median = sorted(dices)[len(dices) // 2]
    ok = median > 0.97 and min(dices) > 0.95
    log(f"[1000²] DICE median={median} min={min(dices)} (gates: median > "
        f"0.97, min > 0.95) {'ok' if ok else 'FAIL'}")
    if not ok:
        checks.failed.append("1000² DICE gates")
    cfg.rerun_and_wall(checks, "1000²", BIG_SEEDS[0], runs[BIG_SEEDS[0]][0])
    return cfg, launches


def pallas_binning_kde(checks, dev):
    """``curve_kde(..., use_pallas_binning=True)`` at the 1000² config's
    kept-curve shape: K4 bins; held against the K3 KDE."""
    import torch
    from gaussian_process_edge_trace_torch.trace.kde import curve_kde
    rng = np.random.default_rng(1)
    yn, wn = kept_curves(rng, 1000, 1000, 1000)
    y = torch.tensor(yn, dtype=torch.float32, device=dev)
    w = torch.tensor(wn, dtype=torch.float32, device=dev)
    reset_counts()
    kde4 = curve_kde(y, w, 1000, 1000, 0, use_pallas_binning=True)
    torch.cuda.synchronize()
    launches = read_counts()
    kde3 = curve_kde(y, w, 1000, 1000, 0)
    e, _ = rel_err(kde4, kde3)
    ok = launches["K4"] > 0 and e <= 1e-5
    log(f"[kde K4] launches {json.dumps(launches)}; K4 KDE vs K3 KDE "
        f"max_abs_err={e:.3e} (1e-5 on a [0, 1] grid) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        checks.failed.append("curve_kde with use_pallas_binning")
    return launches


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(checks, tag, cfg, seed):
    """The loop and the final fit (``finish_trace``) on the host clock and
    peak memory; then one profiled trace: device busy time, the idle share
    of the unprofiled and of the profiled wall time, top device ops, K1, K3,
    K5 and K6 (its m > 1 and m = 1 kernels) per launch."""
    import torch
    from torch.profiler import ProfilerActivity
    from gaussian_process_edge_trace_torch.trace import driver as pd

    tracer = cfg.tracer(seed)
    cfg_, data = tracer.cfg, tracer.data
    draws = pd.TorchDraws(cfg_, data.L_prior_unit.shape[1], cfg.dev)
    loop, fit = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):                          # the first one warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = pd.run_loop(cfg_, data, pd.init_state(cfg_, cfg.dev), draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pd.finish_trace(cfg_, data, state, draws)
        torch.cuda.synchronize()
        loop.append((t1 - t0) * 1e3)
        fit.append((time.perf_counter() - t1) * 1e3)
    lm, fm = statistics.median(loop[1:]), statistics.median(fit[1:])
    log(f"[profile {tag}] host clock, median of 3: loop {lm:.2f} ms over "
        f"{state.it} iterations ({lm / max(state.it, 1):.2f} ms each), final "
        f"fit {fm:.2f} ms ({100 * fm / (lm + fm):.1f}% of the trace); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tracer()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Device-side events only: a CPU op's own row repeats its kernels' time.
    rows = [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0]
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        checks.failed.append(f"{tag} profile shows no device time")
    log(f"[profile {tag}] device busy {busy:.3f} ms per trace: idle "
        f"{100 * (1 - busy / (lm + fm)):.1f}% of the unprofiled "
        f"{lm + fm:.2f} ms, {100 * (1 - busy / wall):.1f}% of the profiled "
        f"{wall:.2f} ms")
    rows.sort(key=lambda r: -r[1])
    for key, ms, count in rows[:14]:
        log(f"[profile {tag}]   {ms:8.3f} ms  {count:5d}x  "
            f"{1e3 * ms / count:9.2f} us/launch  {key[:90]}")
    k1_k3 = 0.0
    for name in ("fused_cost_partial_kernel", "fused_cost_reduce_kernel",
                 "binning_2l_kernel", "batched_chol_kernel",
                 "batched_trsm_kernel", "batched_trsv_kernel"):
        for key, ms, count in rows:
            if name in key:
                log(f"[profile {tag}] {name}: {count} launches, "
                    f"{1e3 * ms / count:.2f} us each, {ms:.3f} ms in all")
                if name.startswith(("fused_cost", "binning_2l")):
                    k1_k3 += ms
    log(f"[profile {tag}] K1 + K3 device time per trace: {k1_k3:.3f} ms")


KERNEL_ROWS = {
    "K1": ("fused_curve_cost", "gaussian_process_edge_trace_torch/csrc/"
           "fused_cost_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_interp.py:230"),
    "K2": ("column_interp", "gaussian_process_edge_trace_torch/csrc/"
           "column_interp_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_interp.py:167"),
    "K3": ("binning_2l", "gaussian_process_edge_trace_torch/csrc/"
           "binning_2l_kernel.cu",
           "gaussian_process_edge_trace_tpu/trace/pallas_kde.py:153"),
    "K4": ("binning_dense", "gaussian_process_edge_trace_torch/csrc/"
           "binning_dense_kernel.cu",
           "gaussian_process_edge_trace_tpu/trace/pallas_kde.py:199"),
    "K5": ("batched_cholesky", "gaussian_process_edge_trace_torch/csrc/"
           "batched_chol_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_chol.py:218"),
    "K6": ("batched_triangular_solve", "gaussian_process_edge_trace_torch/"
           "csrc/batched_trsm_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_chol.py:274"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        import gaussian_process_edge_trace_torch  # noqa: F401
        from gaussian_process_edge_trace_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the port package is not importable here: {exc}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc build {cuda_build.build_seconds})")
    log_path = cuda_build.BUILD_DIR / "build.log"
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"[build] {line.strip()}")

    checks = Checks()
    check_kernels(checks, dev)
    demo_cfg, demo_launches = demo(checks, dev)
    big_cfg, big_launches = big(checks, dev)
    kde_launches = pallas_binning_kde(checks, dev)
    profile(checks, "demo", demo_cfg, DEMO_SEEDS[0])
    profile(checks, "1000²", big_cfg, BIG_SEEDS[0])

    paths = {"demo": demo_launches, "1000_S1e4": big_launches,
             "curve_kde_pallas_binning": kde_launches}
    rows = []
    for key, (name, source, replaces) in KERNEL_ROWS.items():
        k = checks.kernels.get(key, {"max_abs_err": float("nan"),
                                     "cases": []})
        main_case = next((c for c in k["cases"] if c["main"]), None)
        if main_case is None:
            checks.failed.append(f"{key} has no timed main-path case")
            continue
        rows.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p[key] for p in paths.values()),
            "launches_by_path": {p: n[key] for p, n in paths.items()},
            "max_abs_err": k["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "timed_case": main_case["case"],
            "main_path_cases": [
                {f: c[f] for f in ("case", "ms", "plain_ms", "bound_ms")}
                for c in k["cases"] if c["main"] or c["also_main"]]})
    if checks.failed:
        log(f"chip_smoke: FAILED: {checks.failed}")
        return 1
    log(json.dumps({"kernels": rows, "not_ported": []}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
