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
   the tolerance stated beside each check (K1 and K3 at both even traces'
   shapes and at those of the 2000² and non-square traces, with their
   launch plans; K2 at the odd-E trace's unfused cost, the odd demo shape, the
   final cost and a ragged S, bitwise; K3 and K4 also at their worst
   cases: every sample in one row, every sample outside the image, S = 1,
   K4 bitwise equal to the sequential plain version; K5 and K6 at every
   batch of the final fit, n = 104 and 208 direct, n = 408 blocked; each
   rerun bitwise); the kernel's time, the plain version's, the time of one
   PyTorch library call that computes the same function where there is one
   (many calls back to back in one CUDA graph between one event pair, over
   the count: ``cuda_ms``), and the least time the card could take (bytes
   over 3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is
   larger);
4. four configurations traced through ``GP_Edge_Tracing(...)()`` for seeds
   1-3, each with every kernel's launches per trace (counts set to 0 before
   each trace and read after it; K2 must run once per trace where K1
   scores, n_iters + 1 times where it cannot), peak device memory, MSE and
   DICE against the true edge with its gates, a rerun of seed 1 that must
   give the same trace, and the warm wall time per trace:
   - the README demo config (500×500, RBF σf=75 ℓ=20, 1000 samples, δx=5),
     gates of ``bench.py``: median DICE > 0.985, every seed > 0.97;
   - the 1000² config (``benchmarks/suite.py`` config 4: RBF σf=200 ℓ=50,
     S=10⁴, δx=5): gates median > 0.97, every seed > 0.95, the spread of
     the JAX package itself there (``tests/torch_reference_1000.py`` reads
     DICE 0.963-0.980 over its seeds 1-10 on a CPU, and the port's CPU path
     gives the reference's trace from the reference's draws);
   - the same image with the right endpoint at column 998, so the edge
     length E = 999 is odd and every iteration scores through K2 and the
     PyTorch Simpson sums (K1 never runs): the same gates (the reference
     reads DICE 0.966-0.980 over seeds 1-10 there,
     ``tests/torch_reference_1000.py --right-end 998``);
   - the 2000² config (``benchmarks/suite.py`` config 4b: amplitude 700,
     RBF σf=400 ℓ=100, S=1000, δx=5): n_train 408, so the final fit's
     fine stage runs K5/K6's blocked orchestration inside the trace (each
     trace must call the blocked Cholesky, forward and backward solve);
     gates median DICE > 0.987, every seed > 0.977 (``BIG2K_GATES``, below
     the JAX package's own CPU readings, ``tests/torch_reference_2000.py``);
   then the non-square pair (config 4c: 512×1536 and 1536×512, σf=100,
   ℓ=60 and 30), tracer seed 1, each under an MSE gate (``NON_SQUARE``),
   with K1 at E ≠ M and one KDE axis blurred by shifted FMAs, the other by
   a matmul (512×1536's n_train of 312 takes the blocked path too: every
   trace whose n_train is above K5/K6's direct limit is held to the
   blocked-call check); ``coverage_demo`` (the share of the true edge
   inside each demo seed's pixel-unit interval, > 0.85); ``wide_draws``
   (the card's generator tells seeds 2³² apart, and demo tracer seeds 1
   and 1 + 2¹⁶ trace differently); ``final_fit_frames_n408`` (four
   frames' final fit at n = 408, each bitwise its single fit, timed
   beside one batched trailing product and four single fits);
5. ``curve_kde(..., use_pallas_binning=True)`` at the 1000² config's
   kept-curve shape, which launches K4, held against the K3 KDE;
6. one ``torch.profiler`` trace of each of the four configurations: device
   busy and idle share, the top device operations, K1, K2, K3, K5 and K6
   per launch, K1 + K3 device time per trace, the device time of the
   unfused path's passes (``line_and_arc``, the Simpson tail,
   ``best_curves`` and its row or column take), the final fit's
   (``finish_trace``) host time and share of the wall time, and peak
   memory;
7. K1 (with and without its transposed copy, and with the columns shared
   by the frames), K2 (S = 10⁴ at an odd E, and S = 1) and K3 over 16
   frames in one launch: every frame bitwise equal to its own single-frame
   launch, the launch timed against 16 single launches beside the bound;
8. the serving modes through ``parallel.sharded``, each frame against its
   single trace on the card in the same phase (where a frame differs, the
   batch and the single trace are stepped in lockstep to the first
   iteration that differs and the score gap of the two pixels is logged;
   the phase fails unless it is a near-tie, relative 1e-5, and the DICE
   gates hold; loops that agree must give equal results, as the final fit
   does not depend on the batch),
   launches per batch (K1 and K3 once per loop iteration, K2
   once where K1 scores, K5/K6 as often as one trace's final fit), DICE
   gates, a determinism rerun, peak memory and the warm wall time per
   trace beside a single trace's:
   - ``batch_demo_B16``: the demo config on the 16 images of
     ``bench.py:148-156`` (image seeds 1-16), tracer seed 1; gate median
     DICE > 0.97 (the JAX package's own batch row reads 0.9841 on them,
     ``BENCH_r05.json:44``), with a profiled batch (device busy and idle
     share);
   - ``batch_1000_B4`` and ``batch_1000_oddE_B4``: the 1000² config on
     image seeds 1-4 at E = 1000 and E = 999; gates median > 0.92, every
     frame > 0.84 (``BIG_BATCH_GATES``, set from the JAX package's own
     readings on these images);
   - ``ensemble_demo_K5``: best-of-5 on the demo image through
     ``GP_Edge_Tracing(...)(ensemble=5)``; member 0 is the single seed-1
     trace, the chosen member the argmin of the final costs, DICE > 0.97;
   - ``multi_edge``: two boundaries of one 500² multi-sinusoidal image
     through ``trace_multi_edge``, each edge equal to the tiled image's
     ``trace_batch`` and DICE > 0.97;
   - ``sequence_demo_3``: the JAX package's sequence row
     (``benchmarks/suite.py:307-335``), three noisy frames of one 500²
     image through ``trace_sequence``, cold then warm: each frame bitwise
     its stand-alone ``run_trace`` from the handed-off state, warm frames'
     n_iters <= frame 0's + 1, every frame DICE > 0.99 (the JAX package's
     own readings 0.9965-0.9981, ``tests/torch_sequence_reference.py``),
     launches and host reads per frame, the wall time per frame beside a
     cold single trace's;
   - ``sharded_1x1_demo_B16`` and ``sharded_1x1_1000_B4``:
     ``sharded_trace_batch`` on a (1, 1) NCCL mesh in this process on the
     two batches' inputs, each frame bitwise ``trace_batch``'s, the
     collectives per loop iteration (one all_gather of the costs, one
     all_reduce of the kept curves) with their bytes and host time, and
     the wall time per trace beside ``trace_batch``'s;
   and, with the kernels (phase 3), K1 over shards of S = 10⁴ samples
   planned on the global S (k = 2, 4), each shard bitwise the full
   launch's columns and timed beside its share, and K2 + ``line_and_arc``
   at E = 999 over the same shards, bitwise;
9. the last modules, after every phase above:
   - ``k4_frames``: K4 over 16 frames at E = S_keep = M = 1000 in one
     launch, each frame bitwise its single launch and the sequential plain
     version, timed against 16 single launches; then ``curve_kde(...,
     use_pallas_binning=True)`` over the frames (one K4 launch) bitwise
     the per-frame calls;
   - ``selftest``: ``utils.selftest.run_selftest`` (K1-K6 against their
     plain versions, K4 over frames) green, with its seconds;
   - ``cli_trace_demo``: ``python -m gaussian_process_edge_trace_torch
     trace`` on the README demo image (``.npy``) in a subprocess for seeds
     1-3, each ``edge_trace`` and interval bitwise the in-process
     ``GP_Edge_Tracing(...)()`` under the demo DICE gates, the
     subprocess's wall beside the in-process warm wall;
     ``cli_batch_demo_B16`` (``batch`` over ``batch_demo_B16``'s frames,
     each bitwise ``trace_batch``'s) and ``cli_sequence_demo_3`` (``batch
     --sequence`` over ``sequence_demo_3``'s frames, each bitwise
     ``trace_sequence``'s); each path's launches from the CLI's ``main``
     run in this process;
   - ``denoise_1000``: every technique on the 1000² config's noisy image
     on the card against the same call on this machine's CPU through the
     port (``DENOISE_CASES``: bitwise where it only sorts or compares,
     else within the stated tolerance), its PSNR against the noise-free
     image (it must rise for tvc, nl, wavelet and tvb) and its time;
   - ``denoised_trace_1000``: the 1000² config traced from
     ``comp_grad_img(denoise(img, 'tvc', {}))`` for seeds 1-3 as in phase
     4, with gates below the JAX package's readings of that pipeline
     (``DENOISED_GATES``, ``tests/torch_denoised_reference.py``);
   - ``profiling``: ``device_op_breakdown`` of one demo trace names K1,
     K3, K5 and K6; ``sync_timer`` of K1 at 1000² within 2x of its
     ``cuda_ms``; ``trace_telemetry`` of the trace;
   - ``debug``: ``debug_nans`` raises on a NaN made on the card and is
     restored after; ``assert_all_finite`` passes the demo result;
   - ``examples``: each ``python -m
     gaussian_process_edge_trace_torch.examples.*`` exits 0 (``multichip``
     on a (1, 1) NCCL mesh; ``demo --plot`` is not run, as it needs
     matplotlib);
10. one JSON line of kernel results, the card line again, and as the last
   line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

DEMO_SEEDS = (1, 2, 3)
BIG_SEEDS = (1, 2, 3)
ODD_SEEDS = (1, 2, 3)
# The serving modes: frames per kernel check, the batches' image seeds (the
# demo batch is bench.py:148-156's), the ensemble's members.
FRAMES = 16
BATCH_DEMO_IMAGES = tuple(range(1, 17))
BATCH_BIG_IMAGES = (1, 2, 3, 4)
# DICE gates (median, every frame) of the 1000² batches, from the JAX
# package's own readings on their images at E = 1000 (on a CPU,
# tests/torch_reference_1000.py --image-seed K --reference-only): its
# lowest over tracer seeds 1-91 of image seed 2 is 0.8503 (the port's CPU
# path from the same draws: 0.8500), and over seeds 1-20 of image seeds 1,
# 3 and 4 0.9527, 0.9862 and 0.8977; the median of the four images' lowest
# readings is 0.9252.
BIG_BATCH_GATES = (0.92, 0.84)
ENSEMBLE_K = 5
# The 2000² config (benchmarks/suite.py:254-271) and the non-square pair
# (:276-305), traced through GP_Edge_Tracing on the card. The 2000² DICE
# gates (median, every seed) lie below the JAX package's own readings on a
# CPU (tests/torch_reference_2000.py, tracer seeds 1-10: median 0.9921,
# lowest 0.9908) by the margins the 1000² gates keep below theirs (median
# 0.9752 - 0.97, lowest 0.9634 - 0.95, tests/torch_reference_1000.py,
# seeds 1-10). The non-square MSE gates (tracer seed 1) are twice the JAX
# package's largest MSE over tracer seeds 1-10 on a CPU (512×1536:
# 0.310-0.424; 1536×512: 1.83-32.98), a seed of the card's draws being one
# more sample of that spread.
BIG2K_SEEDS = (1, 2, 3)
BIG2K_GATES = (0.987, 0.977)
NON_SQUARE = {"512x1536": ((512, 1536), 60, 0.85),
              "1536x512": ((1536, 512), 30, 66.0)}
# The share of the true edge's columns inside the pixel-unit credible
# interval, each demo seed (tests/test_e2e_parity.py:156's gate).
COVERAGE_GATE = 0.85
# Where a batch frame and its single trace first accept different pixels,
# the two pixels' scores must lie within this relative gap. Where they
# accept the same pixels, the results must be equal: the final fit gives a
# frame the same bits whatever the batch (models/gpr.py).
NEAR_TIE = 1e-5

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
# B frames: B times the work, the columns read once where the frames share
# them.
def work_k1(E, M, S, transpose, B=1, shared=False):
    per = E * S + 2 * S + (S * E if transpose else 0)
    return 4 * (E * M * (1 if shared else B) + B * per), 23 * E * S * B


def work_k2(E, M, S, B=1, shared=False):
    # The lerp touches at most two entries of cols per sample.
    cols = min(E * M, 2 * E * S) * (1 if shared else B)
    return 4 * (2 * E * S * B + cols), 8 * E * S * B


def work_binning(E, S, M, B=1):
    # The adjoint: two taps of ~10 operations per sample.
    return 4 * B * (E * S + S + (M + 2) * E), 10 * E * S * B


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
        self.frames = {}

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
    # main-path shape (the demo trace's, the 2000² and non-square traces'),
    # listed in that row.
    for case, (E, M, S), transpose, role in (
            ("demo E=M=500 S=1000", (500, 500, 1000), False, "also"),
            ("ragged E=38 M=61 S=130", (38, 61, 130), False, ""),
            ("1000² E=M=1000 S=10⁴ +transpose", (1000, 1000, 10000), True,
             "main"),
            ("ragged E=38 M=61 S=8197 +transpose", (38, 61, 8197), True, ""),
            ("M=2000 E=2000 S=8200 +transpose", (2000, 2000, 8200), True,
             ""),
            ("2000² E=M=2000 S=1000", (2000, 2000, 1000), False, "also"),
            ("512×1536 E=1536 M=512 S=1000", (1536, 512, 1000), False,
             "also"),
            ("1536×512 E=512 M=1536 S=1000", (512, 1536, 1000), False,
             "also")):
        cols = torch.tensor(rng.random((E, M)), **f32)
        ys = torch.tensor(curve_samples(rng, E, M, S), **f32)
        log(f"[kernels] K1 {case}: launch plan "
            f"{ci.k1_launch_plan(E, M, S, transpose)}")
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


def grid_sample_interp(cols, ys, add_const):
    """K2's library yardstick: ``grid_sample`` (bilinear, align_corners,
    border padding) on the (1, 1, E, M) columns at the points (row e,
    clip(ys[e, s], 0, M-1)), plus ``add_const``; a function of no
    arguments."""
    import torch
    import torch.nn.functional as F
    E, M = cols.shape
    S = ys.shape[1]
    img = cols[None, None]
    gx = 2.0 * torch.clamp(ys, 0, M - 1) / (M - 1) - 1.0
    gy = (2.0 * torch.arange(E, dtype=cols.dtype, device=cols.device)
          / (E - 1) - 1.0)[:, None]
    grid = torch.stack([gx, gy.expand(E, S)], dim=-1)[None]
    return lambda: F.grid_sample(img, grid, mode="bilinear",
                                 padding_mode="border",
                                 align_corners=True)[0, 0] + add_const


def check_k2(checks, rng, f32):
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci

    # Same arithmetic, each op rounded once on both sides (the kernel uses
    # the _rn intrinsics): the kernel must equal the plain version bit for
    # bit. The library yardstick is grid_sample (bilinear, align_corners,
    # border padding) on the (1, 1, E, M) columns at the same points; it is
    # timed only, the port never calls it. Roles as in check_k1: the odd-E
    # trace's unfused cost is the main case, the odd demo shape and the
    # final cost (S = 1, every trace) are main-path shapes too.
    for case, (E, M, S), role in (
            ("unfused cost E=999 M=1000 S=10⁴", (999, 1000, 10000), "main"),
            ("odd demo E=499 M=500 S=1000", (499, 500, 1000), "also"),
            ("final cost E=M=1000 S=1", (1000, 1000, 1), "also"),
            ("final cost E=M=500 S=1", (500, 500, 1), ""),
            ("E=M=500 S=1000", (500, 500, 1000), ""),
            ("ragged E=37 M=61 S=10003", (37, 61, 10003), "")):
        cols = torch.tensor(rng.random((E, M)), **f32)
        ys = torch.tensor(curve_samples(rng, E, M, S), **f32)
        out = ci.column_interp_cuda(cols, ys, 1e-3)
        ref = ci.column_interp_plain(cols, ys, 1e-3)
        torch.cuda.synchronize()
        e, _ = rel_err(out, ref)
        same = torch.equal(out, ref)
        library = grid_sample_interp(cols, ys, 1e-3)
        le, _ = rel_err(library(), ref)
        log(f"[kernels] K2 {case}: launch plan {ci.k2_launch_plan(E, M, S)}"
            f"; grid_sample yardstick max_abs_err {le:.3e} (not a gate)")
        checks.record(
            "K2", case, e, "bitwise", same,
            ms=cuda_ms(lambda: ci.column_interp_cuda(cols, ys, 1e-3)),
            plain_ms=cuda_ms(lambda: ci.column_interp_plain(cols, ys, 1e-3)),
            library_ms=cuda_ms(library), work=work_k2(E, M, S),
            main=role == "main", also_main=role == "also")


def check_binning(checks, rng, f32):
    import torch
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck

    # K3 sums the same taps as the dense plain version in another order; the
    # bound is the reference's own test bound (test_trace.py:74):
    # |H - plain| <= 1e-5·|plain| + 1e-6·max|plain|; a K3 rerun must be
    # bitwise equal (no atomics). K4 adds each row's terms in sample order,
    # so it must equal the sequential plain version bit for bit, and a rerun
    # too, besides the bound. No single PyTorch call computes this function,
    # so there is no library time. Roles as in check_k1; the demo, 2000² and
    # non-square traces' shapes are main-path shapes of K3 only (K4 is off
    # the traces). The last
    # three are the worst cases: every sample in one row (K3: one group of
    # 32 lanes per batch; K4: two rows that add all S terms in a chain), no
    # weight at all, S = 1.
    for case, (E, S, M), role, kind in (
            ("1000² kept curves E=S=M=1000", (1000, 1000, 1000), "main",
             "walk"),
            ("demo kept curves E=500 S=100 M=500", (500, 100, 500), "also",
             "walk"),
            ("2000² kept curves E=M=2000 S=100", (2000, 100, 2000), "also",
             "walk"),
            ("512×1536 kept curves E=1536 S=100 M=512", (1536, 100, 512),
             "also", "walk"),
            ("1536×512 kept curves E=512 S=100 M=1536", (512, 100, 1536),
             "also", "walk"),
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
        seq = ck.column_binning_sequential(y, w, M)
        scale = ref.abs().max().item()
        plain_ms = cuda_ms(lambda: ck.column_binning_plain(y, w, M))
        log(f"[kernels] K3 {case}: launch plan {ck.k3_launch_plan(E, S, M)}")
        for key, fn in (("K3", ck.binning_2l_cuda),
                        ("K4", ck.binning_dense_cuda)):
            H = fn(y, w, M)
            torch.cuda.synchronize()
            err = (H - ref).abs()
            ok = bool((err <= 1e-5 * ref.abs() + 1e-6 * scale).all().item())
            tol = "1e-5·|H| + 1e-6·max|H|; rerun bitwise"
            same = torch.equal(H, fn(y, w, M))
            ok = ok and same
            if key == "K4":
                in_order = torch.equal(H, seq)
                ok = ok and in_order
                tol += "; == sequential bitwise"
                log(f"[kernels] K4 {case}: launch plan "
                    f"{ck.k4_launch_plan(E, S, M)}; equals the sequential "
                    f"version bit for bit: {in_order}")
            log(f"[kernels] {key} {case}: rerun bitwise equal: {same}")
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


def frames_case(checks, kernel, case, batch, single, work):
    """``batch()`` launches ``kernel`` once over FRAMES frames and
    ``single(f)`` once on frame f, each returning a tuple of outputs. Every
    frame of the batch must equal its single launch bit for bit; the one
    launch is timed against FRAMES single launches (``cuda_ms``)."""
    import torch
    out = batch()
    torch.cuda.synchronize()
    same = all(torch.equal(a[f], b) for f in range(FRAMES)
               for a, b in zip(out, single(f)))
    ms = cuda_ms(batch)
    singles_ms = cuda_ms(lambda: [single(f) for f in range(FRAMES)])
    b_ms, b_by = bound(*work)
    checks.frames.setdefault(kernel, []).append({
        "case": case, "frames": FRAMES, "bitwise_equal_to_single": same,
        "ms": ms, "single_launches_ms": singles_ms, "bound_ms": b_ms,
        "bound_by": b_by})
    log(f"[frames] {kernel} {case}, {FRAMES} frames: each frame bitwise "
        f"equal to its single launch: {same}; one launch {ms:.4f} ms, "
        f"{FRAMES} single launches {singles_ms:.4f} ms "
        f"({singles_ms / ms:.2f}x), bound {b_ms:.4g} ms ({b_by})")
    if not same:
        checks.failed.append(f"{kernel} {case}: frames differ from single "
                             f"launches")


def check_frames(checks, rng, f32):
    """K1, K2 and K3 over FRAMES frames at the serving paths' shapes."""
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
    B = FRAMES

    def frames(fn, *shape):
        return torch.tensor(np.stack([fn(*shape) for _ in range(B)]), **f32)

    for case, (E, M, S), transpose, shared in (
            ("1000² E=M=1000 S=10⁴ +transpose", (1000, 1000, 10000), True,
             False),
            ("1000² E=M=1000 S=10⁴", (1000, 1000, 10000), False, False),
            ("demo E=M=500 S=1000", (500, 500, 1000), False, False),
            ("demo E=M=500 S=1000, shared columns", (500, 500, 1000), False,
             True)):
        cols = torch.tensor(rng.random((E, M) if shared else (B, E, M)),
                            **f32)
        ys = frames(lambda *a: curve_samples(rng, *a), E, M, S)
        col = (lambda f: cols) if shared else (lambda f: cols[f])
        frames_case(
            checks, "K1", case,
            lambda: ci.fused_cost_cuda(cols, ys, 1e-3,
                                       with_transpose=transpose),
            lambda f: ci.fused_cost_cuda(col(f), ys[f], 1e-3,
                                         with_transpose=transpose),
            work_k1(E, M, S, transpose, B, shared))
    for case, (E, M, S) in (("unfused cost E=999 M=1000 S=10⁴",
                             (999, 1000, 10000)),
                            ("final cost E=M=1000 S=1", (1000, 1000, 1)),
                            ("final cost E=M=500 S=1", (500, 500, 1))):
        cols = torch.tensor(rng.random((B, E, M)), **f32)
        ys = frames(lambda *a: curve_samples(rng, *a), E, M, S)
        frames_case(checks, "K2", case,
                    lambda: (ci.column_interp_cuda(cols, ys, 1e-3),),
                    lambda f: (ci.column_interp_cuda(cols[f], ys[f], 1e-3),),
                    work_k2(E, M, S, B))
    for case, (E, S, M) in (("1000² kept curves E=S=M=1000",
                             (1000, 1000, 1000)),
                            ("demo kept curves E=500 S=100 M=500",
                             (500, 100, 500))):
        kept = [kept_curves(rng, E, S, M) for _ in range(B)]
        y = torch.tensor(np.stack([k[0] for k in kept]), **f32)
        w = torch.tensor(np.stack([k[1] for k in kept]), **f32)
        frames_case(checks, "K3", case,
                    lambda: (ck.binning_2l_cuda(y, w, M),),
                    lambda f: (ck.binning_2l_cuda(y[f], w[f], M),),
                    work_binning(E, S, M, B))


def check_shard_widths(checks, rng, f32):
    """The sample arm's scoring over shards of the 1000² config's S = 10⁴
    samples: K1 over S/k samples planned on the global S (k = 2, 4) equals
    the full launch's columns bit for bit, timed beside the full launch and
    its k-th share; at E = 999, K2 and ``line_and_arc`` over the shards
    equal the full S's columns bit for bit."""
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    E = M = 1000
    S = 10000
    cols = torch.tensor(rng.random((E, M)), **f32)
    ys = torch.tensor(curve_samples(rng, E, M, S), **f32)
    full = ci.fused_cost_cuda(cols, ys, 1e-3)
    full_ms = cuda_ms(lambda: ci.fused_cost_cuda(cols, ys, 1e-3))
    odd_cols = cols[:999].contiguous()

    def unfused(y):
        return ci.line_and_arc(ci.column_interp(odd_cols, y, 1e-3), y)
    odd_full = unfused(ys[:999].contiguous())
    for k in (2, 4):
        w = S // k
        parts = [ys[:, j * w:(j + 1) * w].contiguous() for j in range(k)]
        outs = [ci.fused_cost_cuda(cols, p, 1e-3, plan_samples=S)
                for p in parts]
        odd = [unfused(p[:999].contiguous()) for p in parts]
        torch.cuda.synchronize()
        same = all(torch.equal(o[i], full[i][j * w:(j + 1) * w])
                   for j, o in enumerate(outs) for i in range(2))
        same_odd = all(torch.equal(o[i], odd_full[i][j * w:(j + 1) * w])
                       for j, o in enumerate(odd) for i in range(2))
        err = max((o[i] - full[i][j * w:(j + 1) * w]).abs().max().item()
                  for j, o in enumerate(outs) for i in range(2))
        plan = ci.k1_launch_plan(E, M, w, plan_samples=S)
        log(f"[kernels] K1 shard S/{k}: plan {plan} (the full launch's "
            f"chunks: {ci.k1_launch_plan(E, M, S)['pairs_per_chunk']} pairs "
            f"each); every shard bitwise the full launch's columns: {same}; "
            f"K2 + line_and_arc at E=999 over the shards bitwise the full "
            f"S's columns: {same_odd}")
        ms = cuda_ms(lambda: ci.fused_cost_cuda(cols, parts[0], 1e-3,
                                                plan_samples=S))
        log(f"[kernels] K1 shard S/{k}: {ms:.4f} ms against the full "
            f"launch's {full_ms:.4f} ms / {k} = {full_ms / k:.4f} ms "
            f"({ms * k / full_ms:.2f}x its share)")
        checks.record("K1", f"1000² shard S/{k} of S=10⁴ planned on S", err,
                      "bitwise the full launch's columns", same and same_odd,
                      ms=ms, plain_ms=cuda_ms(lambda: ci.fused_cost_plain(
                          cols, parts[0], 1e-3)),
                      work=work_k1(E, M, w, False), also_main=True)


def check_kernels(checks, dev):
    import torch
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    check_k1(checks, rng, f32)
    check_k2(checks, rng, f32)
    check_binning(checks, rng, f32)
    check_chol(checks, rng, f32, dev)
    check_frames(checks, rng, f32)
    check_shard_widths(checks, rng, f32)
    # Release what the timing graphs left allocated before the traces, so
    # the traces' peak memory does not carry it: their pools, and the cuBLAS
    # workspace (32 MiB) made for the capture stream, which PyTorch keeps
    # and counts as allocated.
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def reset_counts():
    """Every kernel's launch count, the host reads and the collectives set
    to 0."""
    from gaussian_process_edge_trace_torch.ops import collectives
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
    from gaussian_process_edge_trace_torch.trace import driver as pd
    for counts in (ci.LAUNCHES, cc.LAUNCHES, cc.BLOCKED, ck.LAUNCHES,
                   pd.HOST_READS, collectives.COLLECTIVES):
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
    """One traced configuration: its image, truth and tracer arguments. The
    endpoints are the true edge's first column and column ``right`` (the
    last by default), so the edge length E is right + 1 columns."""

    def __init__(self, dev, size, amplitude, ko, n_samples, right=-1,
                 image_seed=1):
        import gaussian_process_edge_trace_torch as gpt
        self.img, self.true_edge = gpt.construct_test_img(
            size, amplitude, 4, 0.05, "sinusoidal", 0.3, gaps=True,
            seed=image_seed)
        self.grad = gpt.comp_grad_img(
            self.img, gpt.kernel_builder((11, 5), unit=False), device=dev)
        self.image_seed = image_seed
        self.init = self.true_edge[[0, right]][:, [1, 0]]
        self.E = int(self.init[1, 0] - self.init[0, 0]) + 1
        self.ko, self.n_samples, self.dev = ko, n_samples, dev

    def tracer(self, seed, return_std=True):
        import gaussian_process_edge_trace_torch as gpt
        return gpt.GP_Edge_Tracing(self.init, self.grad, self.ko, 1,
                                   np.array([]), self.n_samples, 1, 5, 0.1, 5,
                                   seed, return_std, True, device=self.dev)

    def trace(self, seed):
        import torch
        tracer = self.tracer(seed)
        edge, cred = tracer()
        torch.cuda.synchronize()
        self.n_train = tracer.cfg.n_train
        return edge, cred, tracer.last_result

    def report(self, checks, tag, seed, run):
        import gaussian_process_edge_trace_torch as gpt
        import torch
        edge, cred, res = run
        truth = self.true_edge[:self.E]
        mse = gpt.trace_MSE(edge, truth)
        dice = gpt.trace_dicecoef(edge, truth)
        finite = bool(np.isfinite(cred[0]).all() and np.isfinite(cred[1]).all()
                      and torch.isfinite(res.y_mean).all().item())
        shape_ok = edge.shape == (self.E, 2) and cred[0].shape == (self.E,)
        log(f"[{tag}] seed {seed}: n_iters={res.n_iters} MSE={mse} "
            f"DICE={dice} theta={res.theta.tolist()} "
            f"final_cost={res.final_cost.item():.6f} finite={finite}")
        if not (finite and shape_ok):
            checks.failed.append(f"{tag} seed {seed}: non-finite or shape")
        return mse, dice

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


def traced(checks, tag, cfg, seeds, need, absent, gates, mse_gate=None):
    """``cfg`` through GP_Edge_Tracing for ``seeds``: the kernels' launches
    (counts set to 0 before each trace and read after it), which must
    include every kernel of ``need`` and none of ``absent``, K2's per
    trace (n_iters + 1 where K1 is absent, else 1), the calls that took
    K5/K6's blocked orchestration (where the config's n_train is above
    K5/K6's direct limit, each of the blocked Cholesky, forward and
    backward solve at least once per trace), peak
    device memory, MSE and DICE against the truth with ``gates`` =
    (median, every seed) on DICE, or with ``mse_gate`` an upper bound on
    every seed's MSE, a rerun of the first seed that must be identical and
    the warm wall time. Returns the summed launches."""
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    runs, launches = {}, None
    for seed in seeds:
        reset_counts()
        runs[seed] = cfg.trace(seed)
        got = read_counts()
        n_iters = runs[seed][2].n_iters
        log(f"[{tag}] seed {seed}: launches {json.dumps(got)} (n_iters + 1 "
            f"= {n_iters + 1}); blocked K5/K6 calls {json.dumps(cc.BLOCKED)}")
        if (not cc.runs_direct(cfg.n_train, "cuda")
                and not all(cc.BLOCKED.values())):
            checks.failed.append(f"{tag} seed {seed}: the blocked K5/K6 "
                                 f"path did not run")
        # K2 scores every iteration where K1 does not, and the final cost.
        want = n_iters + 1 if "K1" in absent else 1
        if got["K2"] != want:
            checks.failed.append(f"{tag} seed {seed}: K2 launches "
                                 f"{got['K2']}, {want} expected")
        launches = got if launches is None else {
            k: launches[k] + got[k] for k in got}
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] kernel launches over seeds {seeds}: {json.dumps(launches)}")
    log(f"[{tag}] peak device memory (max_memory_allocated): {peak} bytes "
        f"({peak / 2**20:.1f} MiB; {before / 2**20:.1f} MiB of it allocated "
        f"before the traces)")
    for k in need:
        if launches[k] <= 0:
            checks.failed.append(f"{tag} did not launch {k}")
    for k in absent:
        if launches[k] != 0:
            checks.failed.append(f"{tag} launched {k}")
    scores = [cfg.report(checks, tag, seed, run) for seed, run in runs.items()]
    if mse_gate is not None:
        worst = max(m for m, _ in scores)
        ok = worst < mse_gate
        log(f"[{tag}] MSE max={worst} (gate: every seed < {mse_gate}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            checks.failed.append(f"{tag} MSE gate")
    else:
        dices = [d for _, d in scores]
        median = sorted(dices)[len(dices) // 2]
        ok = median > gates[0] and min(dices) > gates[1]
        log(f"[{tag}] DICE median={median} min={min(dices)} (gates: median "
            f"> {gates[0]}, min > {gates[1]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            checks.failed.append(f"{tag} DICE gates")
    cfg.rerun_and_wall(checks, tag, seeds[0], runs[seeds[0]][0])
    return launches


def demo_config(dev, image_seed=1):
    return Config(dev, (500, 500), 200,
                  {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}, 1000,
                  image_seed=image_seed)


def big_config(dev, right=-1, image_seed=1):
    return Config(dev, (1000, 1000), 400,
                  {"kernel": "RBF", "sigma_f": 200, "length_scale": 50},
                  10000, right, image_seed=image_seed)


def config_2000(dev):
    """``benchmarks/suite.py`` config 4b: 2000², amplitude 700, RBF σf 400
    ℓ 100, S = 1000 (n_train 408: the blocked K5/K6 path)."""
    return Config(dev, (2000, 2000), 700,
                  {"kernel": "RBF", "sigma_f": 400, "length_scale": 100},
                  1000)


def non_square_config(dev, name):
    """``benchmarks/suite.py`` config 4c: amplitude 150, RBF σf 100, S =
    1000, on a 512×1536 (ℓ 60) or 1536×512 (ℓ 30) image."""
    size, ls, _ = NON_SQUARE[name]
    return Config(dev, size, 150,
                  {"kernel": "RBF", "sigma_f": 100, "length_scale": ls}, 1000)


def coverage_phase(checks, cfg):
    """``coverage_demo``: the share of the true edge's columns inside the
    pixel-unit credible interval (``cred_interval_px``) of each demo seed,
    each gated at ``COVERAGE_GATE`` (tests/test_e2e_parity.py:156)."""
    truth = cfg.true_edge[:cfg.E, 0]
    for seed in DEMO_SEEDS:
        res = cfg.trace(seed)[2]
        lo, hi = res.cred_interval_px.cpu().numpy()
        cov = float(np.mean((truth >= lo) & (truth <= hi)))
        ok = cov > COVERAGE_GATE
        log(f"[coverage_demo] seed {seed}: {cov} of {cfg.E} columns inside "
            f"the interval, median width {float(np.median(hi - lo)):.3f} px "
            f"(gate > {COVERAGE_GATE}) {'ok' if ok else 'FAIL'}")
        if not ok:
            checks.failed.append(f"coverage_demo seed {seed}")


def wide_draws_phase(checks, cfg):
    """The default draws beyond the 32-bit packing: the card's generator
    gives seeds 2³² apart different normals, and the demo's tracer seeds 1
    and 1 + 2¹⁶ different traces."""
    import torch

    def normals(seed):
        g = torch.Generator(device=cfg.dev)
        g.manual_seed(seed)
        return torch.randn(1000, generator=g, device=cfg.dev)
    keeps = not torch.equal(normals(65537), normals(65537 + 2 ** 32))
    one, far = cfg.trace(1)[2], cfg.trace(1 + 2 ** 16)[2]
    differ = not torch.equal(one.y_mean, far.y_mean)
    log(f"[wide_draws] the generator tells seeds 2**32 apart: {keeps}; "
        f"tracer seeds 1 and 65537 trace differently: {differ} (n_iters "
        f"{one.n_iters} and {far.n_iters})")
    if not (keeps and differ):
        checks.failed.append("wide_draws")


def final_fit_frames_phase(checks, dev):
    """``final_fit_frames_n408``: the final fit of four frames at n = 408
    (coarse to fine, the fine fit through the blocked orchestration), each
    frame's results bitwise its single fit; the same with the blocked
    path's trailing products as one batched product over all frames, for
    the record; the host times of both batched fits and of the four single
    fits (median of 3, after a warm-up)."""
    import types

    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    from gaussian_process_edge_trace_torch.trace import driver as pd
    F, n, N = 4, 408, 2000
    cfg = pd.make_config(np.array([[0, 1000], [N - 1, 1000]]), (N, N),
                         {"kernel": "RBF", "sigma_f": 400,
                          "length_scale": 100}, N_samples=1000, delta_x=5)
    rng = np.random.default_rng(n)
    x = np.sort(rng.choice(N, (F, n)), axis=-1)
    y = np.rint(1000 + 160 * np.sin(x / (180 + 20 * np.arange(F)[:, None]))
                + rng.normal(0, 3, (F, n)))
    mask = rng.random((F, n)) < 0.9
    mask[:, :2] = True
    noise_w = np.ones(n, np.float32)
    noise_w[:2] = cfg.init_noise_weight
    data = types.SimpleNamespace(x_grid=torch.arange(N, device=dev))
    u = torch.rand((cfg.lml_restarts, 3), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    args = [torch.as_tensor(a, device=dev) for a in (x, y, mask)]
    nw = torch.as_tensor(noise_w, device=dev)

    def fit(*a):
        out = pd._final_fit_buffers(cfg, data, u, *a, nw)
        torch.cuda.synchronize()
        return out

    def singles():
        return [fit(*(a[f:f + 1] for a in args)) for f in range(F)]

    def same(batch, one):
        return all(torch.equal(b[f], o[0]) for f in range(F)
                   for b, o in zip(batch, one[f]))
    reset_counts()
    batch = fit(*args)
    blocked = dict(cc.BLOCKED)
    one = singles()
    frame_wise = same(batch, one)
    product = cc._product
    cc._product = torch.matmul
    try:
        joint = fit(*args)
        joint_same = same(joint, one)
        joint_ms = warm_wall(lambda: fit(*args))[0]
    finally:
        cc._product = product
    batch_ms = warm_wall(lambda: fit(*args))[0]
    singles_ms = warm_wall(singles)[0]
    log(f"[final_fit_frames_n408] {F} frames at n = {n}: blocked calls "
        f"{json.dumps(blocked)}; each frame bitwise its single fit with the "
        f"trailing products frame by frame: {frame_wise}; with one batched "
        f"product over the frames: {joint_same}; host ms (median of 3): "
        f"frame by frame {batch_ms:.2f}, one product {joint_ms:.2f}, four "
        f"single fits {singles_ms:.2f}")
    if not (frame_wise and all(blocked.values())):
        checks.failed.append("final_fit_frames_n408")


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


# --- the serving modes ---------------------------------------------------

EXACT_FIELDS = ("edge_trace", "n_iters", "obs_x", "obs_y", "obs_valid")


def differing_fields(a, b):
    """The fields of EXACT_FIELDS in which two traces' results differ."""
    import torch
    return [f for f in EXACT_FIELDS
            if not (torch.equal(getattr(a, f), getattr(b, f))
                    if isinstance(getattr(a, f), torch.Tensor)
                    else getattr(a, f) == getattr(b, f))]


def first_divergence(cfg, a, b):
    """Step two batched traces in lockstep from their initial states, each
    side ``(data, states, draws, frame)``, to the first iteration where the
    two frames accept different pixels. Returns None if they never do, else
    a dict: the iteration, the first bin that differs, each side's pixel
    there and both pixels' scores in each side's grid, and the relative
    score gap (an unoccupied bin's side contributes its threshold)."""
    import torch
    from gaussian_process_edge_trace_torch.trace import driver as pd
    from gaussian_process_edge_trace_torch.trace.kde import blur_matrices
    from gaussian_process_edge_trace_torch.trace.select import select_consts
    dev = a[0].x_grid.device
    blur = blur_matrices(cfg.M, cfg.N, torch.float32, dev)
    consts = select_consts(cfg.bins, cfg.N, cfg.max_decays, dev)
    states = [a[1], b[1]]
    for k in range(cfg.max_iters):
        act = [pd._active(cfg, s) for s in states]
        if not any(bool(x[side[3]]) for x, side in zip(act, (a, b))):
            return None
        grids = []
        for i, (data, _, draws, f) in enumerate((a, b)):
            z, w = draws.normals(k)
            new, _, score = pd._iteration(cfg, data, states[i], z, w, blur,
                                          consts, k=k, with_score=True)
            states[i] = pd._keep_finished(act[i], new, states[i])
            grids.append(score[f])
        obs = [(s.obs_x[side[3]], s.obs_y[side[3]], s.obs_valid[side[3]],
                s.score_thresh[side[3]]) for s, side in zip(states, (a, b))]
        diff = ((obs[0][0] != obs[1][0]) | (obs[0][1] != obs[1][1])
                | (obs[0][2] != obs[1][2]))
        if not bool(diff.any()):
            continue
        j = int(torch.nonzero(diff)[0])
        pix = [(int(o[0][j]), int(o[1][j]), bool(o[2][j])) for o in obs]
        scores = [[float(g[y, x]) for x, y, _ in pix] for g in grids]
        gaps = []
        for g, (sa, sb) in enumerate(scores):
            va, vb = pix[0][2], pix[1][2]
            if va and vb:
                gaps.append(abs(sa - sb) / max(abs(sa), abs(sb), 1e-30))
            else:         # one side left the bin empty: its threshold
                t = float(obs[0 if not va else 1][3])
                s_ = sa if va else sb
                gaps.append(abs(s_ - t) / max(abs(t), 1e-30))
        return {"iteration": k, "bin": j, "pixels (x, y, valid)": pix,
                "scores in each side's grid": scores, "gap": max(gaps)}
    return None


def explain_difference(checks, tag, label, got, want, a, b, cfg):
    """``got`` and ``want`` (two traces of one frame) differ: log where
    and why. The phase fails unless their loops first differ at a near-tie
    (relative gap <= NEAR_TIE). Loops that agree (the same pixels in the
    same iterations) leave the final fit the same training set, from which
    it must give the same result in a batch as alone."""
    import torch
    div = first_divergence(cfg, a, b)
    ok = div is not None and div["gap"] <= NEAR_TIE
    if div is not None:
        log(f"[{tag}] {label}: the loops first differ at {div} "
            f"({'a near-tie' if ok else 'NOT a near-tie'}, bound "
            f"{NEAR_TIE})")
    else:
        cols = torch.nonzero(got.edge_trace[:, 0] != want.edge_trace[:, 0])
        log(f"[{tag}] {label}: the loops agree but the final fits differ "
            f"(NOT explained): LMLs {got.lml.item():.6f} vs "
            f"{want.lml.item():.6f}, theta {got.theta.tolist()} vs "
            f"{want.theta.tolist()}, mean curves up to "
            f"{(got.y_mean - want.y_mean).abs().max().item():.4g} px apart, "
            f"integer traces in {cols.shape[0]} columns "
            f"{cols[:, 0].tolist()[:12]}")
    if not ok:
        checks.failed.append(f"{tag} {label}: unexplained difference")


def lift_single(tracer, dev):
    """A single trace's side for :func:`first_divergence`: its data, its
    initial state as a batch of one, its draws, frame 0."""
    from gaussian_process_edge_trace_torch.trace import driver as pd
    cfg, data = tracer.cfg, tracer.data
    return (data, pd._lift(pd.init_state(cfg, dev, user_obs_xy=tracer.obs)),
            pd.TorchDraws(cfg, data.L_prior_unit.shape[1], dev), 0)


def warm_wall(fn, runs=3):
    """Median host-clock ms of ``fn`` after a warm-up, ending in a
    synchronise, and the runs."""
    import torch
    fn()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), walls


def device_busy(fn):
    """(device busy ms, profiled wall ms) of one profiled call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, wall


def check_launches(checks, tag, got, want):
    log(f"[{tag}] launches {json.dumps(got)}, expected {json.dumps(want)}")
    for k, n in want.items():
        if got[k] != n:
            checks.failed.append(f"{tag}: {k} launched {got[k]} times, "
                                 f"{n} expected")


def traced_batch(checks, tag, configs, gates, odd=False, profiled=False):
    """The frames of ``configs`` (one image each, one config) through
    ``trace_batch`` with tracer seed 1, against each frame's single trace
    on the card: launches, frames equal to their singles (or explained),
    DICE gates (median, and every frame unless None), a rerun, peak memory,
    and the warm wall time per trace beside the single trace's. Returns the
    launches."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, trace_batch)
    from gaussian_process_edge_trace_torch.trace import driver as pd
    B = len(configs)
    dev = configs[0].dev
    tracers = [c.tracer(1) for c in configs]
    cfg = tracers[0].cfg
    grads = torch.stack([c.grad for c in configs])
    inits = np.stack([c.init for c in configs])

    def run():
        data = make_batch_data(cfg, grads, inits)
        return trace_batch(cfg, data, make_batch_state(cfg, B, dev))

    singles = []
    for i, c in enumerate(configs):
        reset_counts()
        singles.append(c.trace(1)[2])
        if i == 0:
            one = read_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    res = run()
    torch.cuda.synchronize()
    got = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_max = int(res.n_iters.max())
    want = {"K1": 0 if odd else n_max,
            "K1_transpose": n_max if cfg.N_samples >= 8192 and not odd
            else 0,
            "K2": n_max + 1 if odd else 1, "K3": n_max, "K4": 0,
            "K5": one["K5"], "K6": one["K6"]}
    check_launches(checks, tag, got, want)
    log(f"[{tag}] n_iters {res.n_iters.tolist()}; one single trace "
        f"launched {json.dumps(one)}")
    log(f"[{tag}] peak device memory (max_memory_allocated): {peak} bytes "
        f"({peak / 2**20:.1f} MiB; {before / 2**20:.1f} MiB of it allocated "
        f"before the batch)")
    data = make_batch_data(cfg, grads, inits)
    dices = []
    for f, (c, single) in enumerate(zip(configs, singles)):
        frame = pd.frame_of(res, f)
        diff = differing_fields(frame, single)
        _, dice = c.report(checks, f"{tag} frame {f} (image seed "
                           f"{c.image_seed})", 1,
                           (frame.edge_trace.cpu().numpy(),
                            frame.cred_interval.cpu().numpy(), frame))
        dices.append(dice)
        solo = gpt.trace_dicecoef(single.edge_trace.cpu().numpy(),
                                  c.true_edge[:c.E])
        log(f"[{tag}] frame {f}: equal to its single trace: "
            f"{not diff}{'' if not diff else f' (differs in {diff})'}; the "
            f"single trace's DICE {solo}")
        if diff:
            explain_difference(
                checks, tag, f"frame {f}", frame, single,
                (data, make_batch_state(cfg, B, dev),
                 pd.TorchDraws(cfg, data.L_prior_unit.shape[1], dev), f),
                lift_single(tracers[f], dev), cfg)
    median = float(np.median(dices))
    ok = median > gates[0] and (gates[1] is None or min(dices) > gates[1])
    log(f"[{tag}] DICE median={median} min={min(dices)} (gates: median > "
        f"{gates[0]}, every frame > {gates[1]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        checks.failed.append(f"{tag} DICE gates")
    again = run()
    same = torch.equal(again.edge_trace, res.edge_trace)
    log(f"[{tag}] rerun identical: {same}")
    if not same:
        checks.failed.append(f"{tag} rerun differs")
    batch_ms, batch_runs = warm_wall(run)
    single_ms, single_runs = warm_wall(lambda: configs[0].trace(1))
    log(f"[{tag}] warm wall time (median of 3 after warm-up): batch of {B} "
        f"{batch_ms:.2f} ms, {batch_ms / B:.2f} ms per trace (runs "
        f"{[round(w, 2) for w in batch_runs]}); one trace (image seed "
        f"{configs[0].image_seed}) {single_ms:.2f} ms (runs "
        f"{[round(w, 2) for w in single_runs]}); "
        f"{single_ms * B / batch_ms:.2f} traces in the batch's time per "
        f"single trace's")
    if profiled:
        busy, wall = device_busy(run)
        log(f"[{tag}] profiled batch: device busy {busy:.3f} ms of "
            f"{wall:.2f} ms ({busy / B:.3f} ms per trace): idle "
            f"{100 * (1 - busy / batch_ms):.1f}% of the unprofiled "
            f"{batch_ms:.2f} ms, {100 * (1 - busy / wall):.1f}% of the "
            f"profiled")
    return got


def ensemble_phase(checks, dev):
    """Best-of-ENSEMBLE_K on the demo image through
    ``GP_Edge_Tracing(...)(ensemble=K)``: launches, member 0 against the
    single seed-1 trace, the chosen member the argmin of the final costs
    (NaN as +inf), its DICE > 0.97. Returns the launches."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import trace_ensemble
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tag = f"ensemble_demo_K{ENSEMBLE_K}"
    c = demo_config(dev)
    tracer = c.tracer(1)
    single = c.trace(1)[2]
    reset_counts()
    edge, _ = tracer(ensemble=ENSEMBLE_K)
    torch.cuda.synchronize()
    got = read_counts()
    chosen = tracer.last_result
    cfg, data = tracer.cfg, tracer.data
    state0 = pd.init_state(cfg, dev)
    _, every = trace_ensemble(cfg, data, state0, n_seeds=ENSEMBLE_K,
                              return_all=True)
    n_max = int(every.n_iters.max())
    reset_counts()
    c.trace(1)
    one = read_counts()
    check_launches(checks, tag, got, {
        "K1": n_max, "K1_transpose": 0, "K2": 1, "K3": n_max, "K4": 0,
        "K5": one["K5"], "K6": one["K6"]})
    costs = every.final_cost
    pick = int(torch.argmin(torch.where(torch.isnan(costs),
                                        torch.full_like(costs, torch.inf),
                                        costs)))
    dices = [gpt.trace_dicecoef(every.edge_trace[k].cpu().numpy(),
                                c.true_edge[:c.E]) for k in range(ENSEMBLE_K)]
    log(f"[{tag}] members' n_iters {every.n_iters.tolist()}, final costs "
        f"{costs.tolist()}, DICE {dices}; chosen member {pick}")
    if not (np.array_equal(edge, every.edge_trace[pick].cpu().numpy())
            and float(chosen.final_cost) == float(costs[pick])):
        checks.failed.append(f"{tag}: the chosen member is not the argmin")
    member0 = pd.frame_of(every, 0)
    diff = differing_fields(member0, single)
    log(f"[{tag}] member 0 equal to the single seed-1 trace: {not diff}"
        f"{'' if not diff else f' (differs in {diff})'}")
    if diff:
        draws = pd.FrameDraws([pd.TorchDraws(
            cfg, data.L_prior_unit.shape[1], dev, member=k)
            for k in range(ENSEMBLE_K)])
        states = pd.TraceState(*(
            torch.full((ENSEMBLE_K,), v, dtype=torch.int64, device=dev)
            if k == "it" else v.expand((ENSEMBLE_K,) + v.shape)
            for k, v in state0._asdict().items()))
        explain_difference(checks, tag, "member 0", member0, single,
                           (data, states, draws, 0), lift_single(tracer, dev),
                           cfg)
    dice = gpt.trace_dicecoef(edge, c.true_edge[:c.E])
    log(f"[{tag}] chosen member's DICE {dice} (gate > 0.97) "
        f"{'ok' if dice > 0.97 else 'FAIL'}")
    if not dice > 0.97:
        checks.failed.append(f"{tag} DICE gate")
    return got


# The multi-edge image: two 250×500 bands stacked, each with one sinusoidal
# boundary (image seeds 2 and 3), so the edges lie ~250 rows apart. On
# construct_test_img's "multi-sinusoidal" image (the second boundary A/2
# below the first) one edge's trace falls largely onto the other boundary
# at 500², whatever the intensity, curvature, kernel or warm start: the
# algorithm's, in both packages (tests/torch_multi_edge_images.py).
MULTI_EDGE_BAND = dict(size=(250, 500), amplitude=100, curvature=4,
                       noise_level=0.05, ltype="sinusoidal", intensity=0.3,
                       gaps=False)


def multi_edge_image():
    """(image, [edge 0, edge 1]) of the two-band multi-edge image."""
    import gaussian_process_edge_trace_torch as gpt
    (top, e0), (bottom, e1) = (gpt.construct_test_img(**MULTI_EDGE_BAND,
                                                      seed=s)
                               for s in (2, 3))
    return np.concatenate([top, bottom]), [e0, e1 + [top.shape[0], 0]]


def multi_edge_phase(checks, dev):
    """Two boundaries of one image through ``trace_multi_edge`` (the demo
    config): launches, each edge equal to the tiled image's
    ``trace_batch``, each edge's DICE > 0.97. Returns the launches."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, trace_batch, trace_multi_edge)
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tag = "multi_edge"
    img, edges = multi_edge_image()
    N = img.shape[1]
    inits = np.asarray([[[0, e[0, 0]], [N - 1, e[N - 1, 0]]] for e in edges])
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5), unit=False),
                             device=dev)
    cfg = pd.make_config(inits[0], (500, 500), {
        "kernel": "RBF", "sigma_f": 75, "length_scale": 20}, N_samples=1000,
        delta_x=5, keep_ratio=0.1, pixel_thresh=5, seed=1)
    reset_counts()
    res = trace_multi_edge(cfg, grad, inits)
    torch.cuda.synchronize()
    got = read_counts()
    n_max = int(res.n_iters.max())
    reset_counts()
    tiled_data = make_batch_data(cfg, torch.stack([grad, grad]), inits)
    tiled = trace_batch(cfg, tiled_data, make_batch_state(cfg, 2, dev))
    one = read_counts()
    check_launches(checks, tag, got, {
        "K1": n_max, "K1_transpose": 0, "K2": 1, "K3": n_max, "K4": 0,
        "K5": one["K5"], "K6": one["K6"]})
    shared = pd.TracerData(**{k: (v[0] if k in ("grad_img", "grad_kde",
                                                "grad_cols") else v)
                              for k, v in tiled_data._asdict().items()})
    draws = pd.TorchDraws(cfg, shared.L_prior_unit.shape[1], dev)
    for f in range(2):
        a, b = pd.frame_of(res, f), pd.frame_of(tiled, f)
        diff = differing_fields(a, b)
        dice = gpt.trace_dicecoef(a.edge_trace.cpu().numpy(), edges[f])
        log(f"[{tag}] edge {f}: n_iters {a.n_iters}, DICE {dice} (gate > "
            f"0.97); equal to the tiled image's batch: {not diff}"
            f"{'' if not diff else f' (differs in {diff})'}")
        if diff:
            explain_difference(
                checks, tag, f"edge {f}", a, b,
                (shared, make_batch_state(cfg, 2, dev), draws, f),
                (tiled_data, make_batch_state(cfg, 2, dev), draws, f), cfg)
        if not dice > 0.97:
            checks.failed.append(f"{tag} edge {f} DICE gate")
    return got


# --- sequences and the sharded batch --------------------------------------

# The JAX package's sequence row (benchmarks/suite.py:307-335): three frames
# of one 500² sinusoidal image (noise 0.03, no gaps), each with N(0, 0.02)
# noise of its own from RandomState(0). DICE gate on every frame, against
# the base image's edge: the JAX package's own readings of these frames on
# a CPU are 0.9965-0.9981 over tracer seeds 1-6, every frame
# (tests/torch_sequence_reference.py).
SEQUENCE_FRAMES = 3
SEQUENCE_DICE_GATE = 0.99


def sequence_images():
    """(the noisy 500² frames, inits, base edge) of the sequence row."""
    import gaussian_process_edge_trace_torch as gpt
    rngf = np.random.RandomState(0)
    base, edge = gpt.construct_test_img((500, 500), 200, 4, 0.03,
                                        "sinusoidal", 0.3, gaps=False)
    images = [np.clip(base + rngf.normal(0, 0.02, base.shape), 0, 1)
              for _ in range(SEQUENCE_FRAMES)]
    return images, [edge[[0, -1]][:, [1, 0]]] * SEQUENCE_FRAMES, edge


def sequence_frames(dev):
    """(gradient images (F, 500, 500) on ``dev``, inits, base edge)."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    images, inits, edge = sequence_images()
    kb = gpt.kernel_builder((11, 5), unit=False)
    grads = torch.stack([gpt.comp_grad_img(img, kb, device=dev)
                         for img in images])
    return grads, inits, edge


def same_result(a, b):
    """Two traces' results equal field by field, bit for bit."""
    import torch
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


def sequence_phase(checks, dev):
    """``trace_sequence`` on the three frames (seed 1, the demo config),
    cold then warm: each frame bitwise its stand-alone ``run_trace`` from
    the handed-off state, n_iters (warm frames <= frame 0's + 1), DICE,
    launches and host reads per frame, and the warm wall time per frame
    beside a cold single trace's. Returns the sequence's launches."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import sharded as ps
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tag = "sequence_demo_3"
    grads, inits, edge = sequence_frames(dev)
    cfg = pd.make_config(inits[0], (500, 500), {
        "kernel": "RBF", "sigma_f": 75, "length_scale": 20}, N_samples=1000,
        score_thresh=1, delta_x=5, keep_ratio=0.1, pixel_thresh=5, seed=1)
    reset_counts()
    res = ps.trace_sequence(cfg, grads, inits)
    torch.cuda.synchronize()
    got = read_counts()
    reads = dict(pd.HOST_READS)
    cold, warm = ps._sequence_configs(cfg)
    total = {k: 0 for k in got}
    for f, r in enumerate(res):
        c = cold if f == 0 else warm
        data = pd.make_data(c, grads[f], inits[f], dev)
        if f == 0:
            state = pd.init_state(c, dev)
        else:
            prev = res[f - 1]
            state = pd.init_state(c, dev, *ps._compact_warm_obs(
                prev.obs_x, prev.obs_y, prev.obs_valid, c.n_user_obs))
        reset_counts()
        alone = pd.run_trace(c, data, state)
        torch.cuda.synchronize()
        one = read_counts()
        total = {k: total[k] + one[k] for k in total}
        same = same_result(r, alone)
        frame_ms, _ = warm_wall(lambda: pd.run_trace(c, data, state))
        dice = gpt.trace_dicecoef(r.edge_trace.cpu().numpy(), edge)
        mse = gpt.trace_MSE(r.edge_trace.cpu().numpy(), edge)
        log(f"[{tag}] frame {f} ({'cold' if f == 0 else 'warm'}, n_user_obs "
            f"{c.n_user_obs}, n_train {c.n_train}): n_iters {r.n_iters}, "
            f"warm-start pixels {int(state.n_fobs)}, MSE {mse} DICE {dice} "
            f"(gate > {SEQUENCE_DICE_GATE}); launches {json.dumps(one)}; "
            f"host reads {r.n_iters + 2} (one before the loop, one after "
            f"each iteration, one in finish_trace); bitwise its stand-alone "
            f"run_trace from the handed-off state: {same}; its warm wall "
            f"time {frame_ms:.2f} ms (median of 3)")
        if not same:
            checks.failed.append(f"{tag} frame {f} differs from its run_trace")
        if not dice > SEQUENCE_DICE_GATE:
            checks.failed.append(f"{tag} frame {f} DICE gate")
        if f and r.n_iters > res[0].n_iters + 1:
            checks.failed.append(f"{tag} frame {f}: n_iters {r.n_iters} > "
                                 f"frame 0's + 1")
    n_iters = [r.n_iters for r in res]
    want_reads = {"active": sum(n_iters) + len(res), "finish": len(res),
                  "state": 0, "samples": 0}
    log(f"[{tag}] host reads over the sequence {json.dumps(reads)}, "
        f"expected {json.dumps(want_reads)}")
    if reads != want_reads:
        checks.failed.append(f"{tag}: host reads {reads}")
    check_launches(checks, tag, got, total)
    seq_ms, seq_runs = warm_wall(lambda: ps.trace_sequence(cfg, grads,
                                                           inits))
    tracer = gpt.GP_Edge_Tracing(inits[0], grads[0], {
        "kernel": "RBF", "sigma_f": 75, "length_scale": 20}, 1, np.array([]),
        1000, 1, 5, 0.1, 5, 1, True, True, device=dev)
    cold_ms, cold_runs = warm_wall(tracer)
    log(f"[{tag}] warm wall time (median of 3 after warm-up): sequence of "
        f"{len(res)} {seq_ms:.2f} ms, {seq_ms / len(res):.2f} ms per frame "
        f"(runs {[round(w, 2) for w in seq_runs]}); a cold single trace of "
        f"frame 0 through GP_Edge_Tracing {cold_ms:.2f} ms (runs "
        f"{[round(w, 2) for w in cold_runs]}); n_iters {n_iters}")
    return got


def free_port():
    """A free TCP port on localhost for the process group's store."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_phase(checks, dev):
    """``sharded_trace_batch`` on a (1, 1) NCCL mesh, world size 1, in this
    process (the script needs one card, and NCCL refuses two ranks on one
    device), on the inputs of ``batch_demo_B16`` and ``batch_1000_B4``:
    each frame bitwise ``trace_batch``'s in the same phase, launches, the
    collectives per loop iteration with their bytes and times, and the
    wall time per trace beside ``trace_batch``'s. Returns the launches of
    each batch by path."""
    import torch
    import torch.distributed as dist
    from gaussian_process_edge_trace_torch.ops import collectives as col
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, make_mesh, sharded_trace_batch,
        trace_batch)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    paths = {}
    try:
        mesh = make_mesh(1, 1, "cuda")
        for tag, make, images in (
                ("sharded_1x1_demo_B16", demo_config, BATCH_DEMO_IMAGES),
                ("sharded_1x1_1000_B4", big_config, BATCH_BIG_IMAGES)):
            frames = [make(dev, image_seed=i) for i in images]
            B = len(frames)
            cfg = frames[0].tracer(1).cfg
            data = make_batch_data(cfg, torch.stack([c.grad for c in frames]),
                                   np.stack([c.init for c in frames]))

            def batch():
                return trace_batch(cfg, data, make_batch_state(cfg, B, dev))

            def sharded():
                return sharded_trace_batch(
                    cfg, data, make_batch_state(cfg, B, dev), mesh, B)
            want = batch()
            reset_counts()
            got = sharded()
            torch.cuda.synchronize()
            launches = read_counts()
            coll = dict(col.COLLECTIVES)
            loops = int(want.n_iters.max())
            want_launches = {"K1": loops, "K1_transpose": 0, "K2": 1,
                             "K3": loops, "K4": 0}
            check_launches(checks, tag, {k: launches[k]
                                         for k in want_launches},
                           want_launches)
            same = [same_result(tuple(getattr(got, f)[i] for f in
                                      got._fields),
                                tuple(getattr(want, f)[i] for f in
                                      want._fields)) for i in range(B)]
            log(f"[{tag}] n_iters {got.n_iters.tolist()}; launches "
                f"{json.dumps(launches)}; every frame bitwise trace_batch's: "
                f"{all(same)} ({sum(same)} of {B})")
            if not all(same):
                differ = [i for i, ok in enumerate(same) if not ok]
                checks.failed.append(f"{tag}: frames {differ} differ from "
                                     f"trace_batch")
            want_coll = {"all_gather": loops + 1, "all_reduce": loops}
            if coll != want_coll:
                checks.failed.append(f"{tag}: collectives {coll}, "
                                     f"{want_coll} expected")
            group = mesh.get_group("sample")
            costs = torch.zeros((B, cfg.N_samples), device=dev)
            kept = torch.zeros((B, cfg.edge_length, cfg.N_keep), device=dev)
            out_bytes = sum(t.numel() * t.element_size() for t in got
                            if isinstance(t, torch.Tensor))
            gather_ms, _ = warm_wall(
                lambda: col.all_gather_stack(costs, group), runs=20)
            reduce_ms, _ = warm_wall(
                lambda: col.all_reduce_sum(kept, group), runs=20)
            log(f"[{tag}] collectives {json.dumps(coll)} over {loops} loop "
                f"iterations (expected {json.dumps(want_coll)}): per "
                f"iteration one all_gather of the ({B}, {cfg.N_samples}) f32 "
                f"costs, {costs.numel() * 4} bytes, {gather_ms:.4f} ms, and "
                f"one all_reduce of the ({B}, {cfg.edge_length}, "
                f"{cfg.N_keep}) f32 kept curves, {kept.numel() * 4} bytes, "
                f"{reduce_ms:.4f} ms (host clock, median of 20); at the end "
                f"one all_gather of the results, {out_bytes} bytes")
            walls = {batch: [], sharded: []}
            for fn in (batch, sharded, sharded, batch) * 2:
                walls[fn].append(warm_wall(fn, runs=1)[0])
            log(f"[{tag}] warm wall time per trace, median of 4 runs each "
                f"taken in turns (batch, sharded, sharded, batch, twice): "
                f"sharded_trace_batch "
                f"{statistics.median(walls[sharded]) / B:.2f} ms (batch runs "
                f"{[round(w, 2) for w in walls[sharded]]}), trace_batch "
                f"{statistics.median(walls[batch]) / B:.2f} ms (batch runs "
                f"{[round(w, 2) for w in walls[batch]]})")
            for name, fn in (("trace_batch", batch),
                             ("sharded_trace_batch", sharded)):
                busy, wall = device_busy(fn)
                log(f"[{tag}] profiled {name}: device busy {busy:.3f} ms of "
                    f"{wall:.2f} ms, idle {100 * (1 - busy / wall):.1f}%")
            paths[tag] = launches
            del frames, data
    finally:
        dist.destroy_process_group()
    return paths


def introspective_phase(checks, tag, c):
    """``GP_Edge_Tracing(...)(return_lines=True)`` and ``(verbose=True)``
    with tracer seed 1 against the fused call on the same tracer: every
    field of the result bitwise, every kernel's launches equal, the lines'
    shapes, the host reads (one of the state before the loop and after each
    iteration, one of each iteration's curves) and the bytes they copy, and
    the warm wall time per trace beside the fused call's. Returns the
    launches of the ``return_lines`` call."""
    import contextlib
    import io
    import torch
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tracer = c.tracer(1, return_std=False)
    runs = {}
    for name, kw in (("fused", {}), ("return_lines", {"return_lines": True}),
                     ("verbose", {"verbose": True})):
        reset_counts()
        for k in pd.HOST_BYTES:
            pd.HOST_BYTES[k] = 0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = tracer(**kw)
        torch.cuda.synchronize()
        runs[name] = (out, tracer.last_result, read_counts(),
                      dict(pd.HOST_READS), dict(pd.HOST_BYTES),
                      printed.getvalue().count("\n"))
    fused, res_f, launches_f = runs["fused"][:3]
    n = res_f.n_iters
    for name in ("return_lines", "verbose"):
        out, res, launches, reads, nbytes, lines = runs[name]
        edge = out[0] if name == "return_lines" else out
        same = same_result(res, res_f) and np.array_equal(edge, fused)
        diff = [f for f in res._fields if not (
            torch.equal(getattr(res, f), getattr(res_f, f))
            if isinstance(getattr(res, f), torch.Tensor)
            else getattr(res, f) == getattr(res_f, f))]
        want_reads = {"state": n + 1, "samples": n}
        got_reads = {k: reads[k] for k in want_reads}
        log(f"[{tag}] {name}: n_iters {res.n_iters}, iter_nobs "
            f"{res.iter_nobs[:n].tolist()}, theta {res.theta.tolist()}; "
            f"every field bitwise the fused call's: {same}"
            f"{'' if same else f' (differs in {diff})'}; launches "
            f"{json.dumps(launches)} (fused {json.dumps(launches_f)}); host "
            f"reads {json.dumps(reads)} (expected {json.dumps(want_reads)} "
            f"beside finish_trace's), bytes copied {json.dumps(nbytes)}, "
            f"{nbytes['samples'] // max(n, 1)} bytes of curves and "
            f"{nbytes['state'] // (n + 1)} bytes of state per read; "
            f"{lines} lines printed")
        if not same:
            checks.failed.append(f"{tag} {name} differs from the fused call "
                                 f"in {diff}")
        if launches != launches_f:
            checks.failed.append(f"{tag} {name}: launches {launches}, the "
                                 f"fused call's {launches_f}")
        if got_reads != want_reads:
            checks.failed.append(f"{tag} {name}: host reads {got_reads}")
    _, (samples, obs, curves) = runs["return_lines"][0]
    shapes_ok = (len(samples) == n + 1 and len(obs) == n + 2
                 and len(curves) == n + 1
                 and samples[0].shape == (c.E, c.n_samples)
                 and samples[0].dtype == np.float32)
    log(f"[{tag}] lines: {len(samples)} sample blocks of "
        f"{samples[0].shape}, {len(obs)} observation lists, {len(curves)} "
        f"curves; shapes as the reference's: {shapes_ok}")
    if not shapes_ok:
        checks.failed.append(f"{tag}: the lines' shapes")
    fused_ms, fused_runs = warm_wall(tracer)
    intro_ms, intro_runs = warm_wall(lambda: tracer(return_lines=True))
    log(f"[{tag}] warm wall time per trace (median of 3 after warm-up): "
        f"return_lines {intro_ms:.2f} ms (runs "
        f"{[round(w, 2) for w in intro_runs]}), fused {fused_ms:.2f} ms "
        f"(runs {[round(w, 2) for w in fused_runs]}); n_iters {n}")
    return runs["return_lines"][2]


class IterationDraws:
    """Iteration ``it``'s draws of a trace's source as a source for the
    per-stage methods: its prior normals, and the first ``n`` rows of its
    noise normals (the training slots that hold the inits first in both
    buffer layouts)."""

    def __init__(self, draws, it):
        self.z, self.w = draws.normals(it)

    def sample_normals(self, n):
        return self.z, self.w[:n]


def per_stage_phase(checks, dev):
    """One manual iteration the reference's way (``fit_predict_GP``,
    ``get_best_curves``, ``kernel_density_estimate``, ``get_best_pixels``)
    on the demo config, tracer seed 1, from the first iteration's draws:
    its accepted pixels and threshold must equal the first ``trace_step``'s.
    Then ``fit_predict_GP(converged=True)`` on those pixels. Returns the
    phase's launches."""
    import torch
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tag = "per_stage_demo"
    tracer = demo_config(dev).tracer(1)
    cfg, data = tracer.cfg, tracer.data
    draws = pd.TorchDraws(cfg, data.L_prior_unit.shape[1], dev)
    state, samples = pd.trace_step(cfg, data, pd.init_state(cfg, dev), draws)
    valid = state.obs_valid.cpu().numpy()
    want = np.stack([state.obs_x.cpu().numpy()[valid],
                     state.obs_y.cpu().numpy()[valid]], axis=1)
    empty = np.zeros((0, 2), np.int64)
    reset_counts()
    t0 = time.perf_counter()
    mine = tracer.fit_predict_GP(empty, draws=IterationDraws(draws, 0))
    curves, costs, (opt, opt_cost) = tracer.get_best_curves(mine)
    kde = tracer.kernel_density_estimate(curves, costs)
    fobs = tracer.get_best_pixels(curves, costs, empty)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    y_mean, y_std = tracer.fit_predict_GP(fobs, converged=True, seed=1)
    torch.cuda.synchronize()
    got = read_counts()
    dsamp = float(np.abs(mine - samples.cpu().numpy()).max())
    same = np.array_equal(fobs, want)
    thresh_ok = tracer.score_thresh == float(state.score_thresh)
    fit_ok = bool(np.isfinite(y_mean).all() and (y_std >= 0).all()
                  and np.abs(y_mean[fobs[:, 0] - cfg.x_st]
                             - fobs[:, 1]).max() < 5.0)
    log(f"[{tag}] samples: max |fit_predict_GP - trace_step| {dsamp:.3e}; "
        f"kept {curves.shape[1]} curves, optimal cost {opt_cost:.6f}; KDE "
        f"{kde.shape} in [{kde.min()}, {kde.max()}]; {len(fobs)} pixels "
        f"accepted, equal to the first trace_step's: {same}; threshold "
        f"{tracer.score_thresh} (trace_step's {float(state.score_thresh)}); "
        f"the four stages {stage_ms:.2f} ms on the host clock; "
        f"fit_predict_GP(converged=True) on the pixels finite and within 5 "
        f"px of them: {fit_ok}; launches {json.dumps(got)}")
    if not same:
        checks.failed.append(f"{tag}: pixels {fobs.tolist()} differ from "
                             f"trace_step's {want.tolist()}")
    if not (thresh_ok and fit_ok):
        checks.failed.append(f"{tag}: threshold or converged fit")
    # K1 in get_best_curves, K3 in kernel_density_estimate and again in
    # get_best_pixels, K5 and K6 in the converged fit.
    check_launches(checks, tag, got, {"K1": 1, "K1_transpose": 0, "K2": 0,
                                      "K3": 2, "K4": 0})
    if not (got["K5"] and got["K6"]):
        checks.failed.append(f"{tag}: the converged fit launched no K5/K6")
    return got


def checkpoint_phase(checks, dev):
    """The 1000² config, tracer seed 1: two ``trace_step``s,
    ``save_checkpoint`` to a temporary directory, ``load_checkpoint`` with
    the config and data, ``resume_trace``: bitwise the uninterrupted
    ``run_trace``; a changed config and an image with one pixel changed
    raise ``ValueError``. The round trip's times. Returns the launches of
    the resumed trace."""
    import tempfile
    import torch
    from gaussian_process_edge_trace_torch.trace import checkpoint as pck
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tag = "checkpoint_1000_S1e4"
    c = big_config(dev)
    tracer = c.tracer(1)
    cfg, data = tracer.cfg, tracer.data
    full = pd.run_trace(cfg, data, pd.init_state(cfg, dev))
    state = pd.init_state(cfg, dev)
    for _ in range(2):
        state, _ = pd.trace_step(cfg, data, state)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pck.save_checkpoint(path, cfg, state, data=data)
        t1 = time.perf_counter()
        lcfg, loaded = pck.load_checkpoint(path, expect_cfg=cfg, data=data)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        reset_counts()
        resumed = pck.resume_trace(lcfg, data, loaded)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        got = read_counts()
        size = os.path.getsize(path)
        grad = c.grad.clone()
        grad[500, 500] += 0.25
        refused = []
        for what, kw in (
                ("config", dict(expect_cfg=cfg._replace(N_samples=9999),
                                device=dev)),
                ("image", dict(data=pd.make_data(cfg, grad, tracer.init,
                                                 dev)))):
            try:
                pck.load_checkpoint(path, **kw)
            except ValueError as exc:
                refused.append(what)
                log(f"[{tag}] changed {what} refused: {exc}")
    same = same_result(resumed, full)
    log(f"[{tag}] after 2 steps: save {(t1 - t0) * 1e3:.2f} ms "
        f"({size} bytes), load with config and fingerprint checks "
        f"{(t2 - t1) * 1e3:.2f} ms, resume to the end {(t3 - t2) * 1e3:.2f} "
        f"ms; n_iters {resumed.n_iters} (uninterrupted {full.n_iters}); "
        f"resumed bitwise the uninterrupted run_trace: {same}; launches "
        f"of the resumed trace {json.dumps(got)}")
    if not same:
        checks.failed.append(f"{tag}: resumed trace differs")
    if refused != ["config", "image"]:
        checks.failed.append(f"{tag}: refused only {refused}")
    loops = full.n_iters - 2
    check_launches(checks, tag, got, {"K1": loops, "K1_transpose": loops,
                                      "K2": 1, "K3": loops, "K4": 0})
    if not (got["K5"] and got["K6"]):
        checks.failed.append(f"{tag}: the final fit launched no K5/K6")
    return got


def sklearn_phase(checks, dev):
    """A float64 ``GaussianProcessRegressor`` (C·RBF + white noise, all
    three free, 12 restarts) on the demo trace's accepted pixels (tracer
    seed 1): ``fit`` and ``predict(return_std=True)`` on the card against
    the same calls on the CPU, mean and std within relative 1e-9, the LML
    within 1e-6; the fit's wall time on each. Its Cholesky factors and
    solves are the library's in float64 (K5/K6 take float32), so it must
    launch none of K1-K6. Returns its launches."""
    import torch
    from gaussian_process_edge_trace_torch.models import sklearn_api as ska
    from gaussian_process_edge_trace_torch.trace.checkpoint import (
        obs_from_result)
    tag = "sklearn_gpr"
    c = demo_config(dev)
    obs = obs_from_result(c.trace(1)[2])
    X, y = obs[:, 0].astype(np.float64), obs[:, 1].astype(np.float64)
    xq = np.arange(c.E, dtype=np.float64)

    def fit(device):
        kernel = (ska.ConstantKernel(1.0, (1e-2, 1e3))
                  * ska.RBF(10.0, (1e-1, 1e3))
                  + ska.WeightedWhiteKernel(noise_weight=1.0,
                                            noise_level=0.1,
                                            noise_level_bounds=(1e-6, 10.0)))
        gp = ska.GaussianProcessRegressor(kernel=kernel, alpha=1e-6,
                                          n_restarts_optimizer=12,
                                          random_state=0, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp.fit(X, y)
        torch.cuda.synchronize()
        return gp, (time.perf_counter() - t0) * 1e3
    reset_counts()
    card, card_ms = fit(dev)
    m_card, s_card = card.predict(xq, return_std=True)
    got = read_counts()
    cpu, cpu_ms = fit("cpu")
    m_cpu, s_cpu = cpu.predict(xq, return_std=True)
    card_again_ms = fit(dev)[1]

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    r_mean, r_std = rel(m_card, m_cpu), rel(s_card, s_cpu)
    r_lml = abs(card.log_marginal_likelihood_value_
                - cpu.log_marginal_likelihood_value_) / abs(
                    cpu.log_marginal_likelihood_value_)
    ok = r_mean <= 1e-9 and r_std <= 1e-9 and r_lml <= 1e-6
    k = card.kernel_
    log(f"[{tag}] {len(X)} accepted pixels, float64: fit on the card "
        f"{card_ms:.1f} ms (again {card_again_ms:.1f} ms), on the CPU "
        f"{cpu_ms:.1f} ms; c {k.signal.k1.constant_value:.6g}, ℓ "
        f"{k.signal.k2.length_scale:.6g}, noise {k.noise.noise_level:.6g}; "
        f"LML card {card.log_marginal_likelihood_value_!r} CPU "
        f"{cpu.log_marginal_likelihood_value_!r}; max relative difference "
        f"mean {r_mean:.3e}, std {r_std:.3e} (<= 1e-9), LML {r_lml:.3e} "
        f"(<= 1e-6) {'ok' if ok else 'FAIL'}; launches {json.dumps(got)}")
    if not ok:
        checks.failed.append(f"{tag}: card and CPU differ")
    if any(got.values()):
        checks.failed.append(f"{tag}: launched a float32 kernel")
    return got


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _subtree_us(evt):
    """Device time of the kernels that ``evt`` and the ops under it
    launched, in µs."""
    return _device_us(evt) + sum(_subtree_us(c) for c in evt.cpu_children)


# Host-side ranges put around the unfused path's PyTorch passes for the
# profiled trace only (module, attribute): the Simpson sums of the cost,
# the Cartwright tail of an even point count inside them, the ranking with
# its column take of the kept curves.
PROFILED_RANGES = (
    ("gaussian_process_edge_trace_torch.trace.scoring", "line_and_arc"),
    ("gaussian_process_edge_trace_torch.ops.integrate", "_cartwright_tail"),
    ("gaussian_process_edge_trace_torch.trace.driver", "best_curves"))


def profile(checks, tag, cfg, seed):
    """The loop and the final fit (``finish_trace``) on the host clock and
    peak memory; then one profiled trace: device busy time, the idle share
    of the unprofiled and of the profiled wall time, top device ops, K1, K2,
    K3, K5 and K6 (its m > 1 and m = 1 kernels) per launch, and the device
    time of the passes in ``PROFILED_RANGES`` (for ``best_curves``, also its
    ``index_select``)."""
    import functools
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, record_function
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

    def ranged(fn, name):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    saved = [(importlib.import_module(m), a) for m, a in PROFILED_RANGES]
    saved = [(mod, a, getattr(mod, a)) for mod, a in saved]
    for mod, a, fn in saved:
        setattr(mod, a, ranged(fn, f"gpet::{a}"))
    try:
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tracer()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, a, fn in saved:
            setattr(mod, a, fn)
    # Device-side events only: a CPU op's own row repeats its kernels' time,
    # and so does a range's device-side span.
    rows = [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0 and not e.key.startswith("gpet::")]
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
                 "column_interp", "binning_2l_kernel", "batched_chol_kernel",
                 "batched_trsm_kernel", "batched_trsv_kernel"):
        for key, ms, count in rows:
            if name in key:
                log(f"[profile {tag}] {key[:60]}: {count} launches, "
                    f"{1e3 * ms / count:.2f} us each, {ms:.3f} ms in all")
                if name.startswith(("fused_cost", "binning_2l")):
                    k1_k3 += ms
    log(f"[profile {tag}] K1 + K3 device time per trace: {k1_k3:.3f} ms")
    for _, a, _ in saved:
        evts = [e for e in prof.events() if e.name == f"gpet::{a}"
                and e.device_type == torch.autograd.DeviceType.CPU]
        us = sum(_subtree_us(e) for e in evts)
        line = (f"[profile {tag}] {a}: {len(evts)} calls, device "
                f"{us / 1e3:.3f} ms per trace")
        if a == "best_curves":
            take = sum(_subtree_us(c) for e in evts for c in e.cpu_children
                       if c.name == "aten::take_along_dim")
            line += f" (its take_along_dim {take / 1e3:.3f} ms)"
        log(line)


# --- the last modules: K4's frames, the self-test, the CLI, denoising,
# --- profiling, debug and the examples -----------------------------------

def k4_frames_phase(checks, dev):
    """K4 over FRAMES frames at the 1000² kept-curve shape in one launch:
    every frame bitwise its single launch and the sequential plain version,
    the launch timed against FRAMES single launches; then ``curve_kde(...,
    use_pallas_binning=True)`` over the frames (one K4 launch, counted)
    bitwise the per-frame calls. Returns that call's launches."""
    import torch
    from gaussian_process_edge_trace_torch.trace import cuda_kde as ck
    from gaussian_process_edge_trace_torch.trace.kde import curve_kde
    rng = np.random.default_rng(4)
    E = S = M = 1000
    kept = [kept_curves(rng, E, S, M) for _ in range(FRAMES)]
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.tensor(np.stack([k[0] for k in kept]), **f32)
    w = torch.tensor(np.stack([k[1] for k in kept]), **f32)
    frames_case(checks, "K4", "1000² kept curves E=S=M=1000",
                lambda: (ck.binning_dense_cuda(y, w, M),),
                lambda f: (ck.binning_dense_cuda(y[f], w[f], M),),
                work_binning(E, S, M, FRAMES))
    seq = torch.equal(ck.binning_dense_cuda(y, w, M),
                      ck.column_binning_sequential(y, w, M))
    reset_counts()
    kde = curve_kde(y, w, M, 1000, 0, use_pallas_binning=True)
    torch.cuda.synchronize()
    launches = read_counts()
    same = all(torch.equal(kde[f], curve_kde(y[f], w[f], M, 1000, 0,
                                             use_pallas_binning=True))
               for f in range(FRAMES))
    log(f"[k4_frames] {FRAMES} frames bitwise the sequential plain version: "
        f"{seq}; curve_kde(use_pallas_binning=True) over the frames: "
        f"launches {json.dumps(launches)}, each frame bitwise its own call: "
        f"{same}")
    if not (seq and same and launches["K4"] == 1):
        checks.failed.append("k4_frames")
    return launches


def selftest_phase(checks):
    from gaussian_process_edge_trace_torch.utils.selftest import run_selftest
    t0 = time.perf_counter()
    results = run_selftest(lambda line: log(f"[selftest] {line}"))
    log(f"[selftest] {len(results)} checks green in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{json.dumps({n: round(s, 3) for n, s in results})}")


ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_DEMO_FLAGS = ["--sigma-f", "75", "--length-scale", "20", "--n-samples",
                  "1000", "--delta-x", "5"]
CLI = "gaussian_process_edge_trace_torch"


def run_module(module, args, timeout=600):
    """``python -m module *args`` in a subprocess from the repository root:
    (its stdout lines, wall seconds). A nonzero exit raises."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if done.returncode:
        raise RuntimeError(f"python -m {module} {' '.join(args)} exited "
                           f"{done.returncode}:\n{done.stdout[-3000:]}\n"
                           f"{done.stderr[-3000:]}")
    return done.stdout.splitlines(), wall


def cli_in_process(args):
    """The CLI's ``main(args)`` in this process, its counts set to 0 before
    and read after: (launches, its JSON lines)."""
    import contextlib
    import io

    import torch
    from gaussian_process_edge_trace_torch.__main__ import main as cli
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        cli(args)
    torch.cuda.synchronize()
    return read_counts(), [json.loads(ln) for ln in
                           buf.getvalue().splitlines()]


def init_flags(init):
    return ["--init", f"{init[0, 0]},{init[0, 1]}",
            f"{init[1, 0]},{init[1, 1]}"]


def check_path_launches(checks, tag, launches, need, absent=("K4",)):
    log(f"[{tag}] launches {json.dumps(launches)}")
    for k in need:
        if launches[k] <= 0:
            checks.failed.append(f"{tag} did not launch {k}")
    for k in absent:
        if launches[k]:
            checks.failed.append(f"{tag} launched {k}")


def cli_trace_phase(checks, dev, tmp):
    """``python -m gaussian_process_edge_trace_torch trace`` on the README
    demo image (``.npy``) for seeds 1-3 in a subprocess each: every
    ``edge_trace`` and interval bitwise the in-process
    ``GP_Edge_Tracing(...)()``, its JSON line equal, the demo DICE gates;
    the subprocess's wall (CUDA start-up and the library load included)
    beside the in-process warm wall. The launches are those of the CLI's
    ``main`` run in this process for seed 1."""
    import gaussian_process_edge_trace_torch as gpt
    tag = "cli_trace_demo"
    c = demo_config(dev)
    path = os.path.join(tmp, "demo.npy")
    np.save(path, c.img)
    flags = [*init_flags(c.init), *CLI_DEMO_FLAGS]
    dices = []
    for seed in DEMO_SEEDS:
        out = os.path.join(tmp, f"demo_seed{seed}.npz")
        lines, wall = run_module(CLI, ["trace", path, *flags, "--seed",
                                       str(seed), "--out", out])
        line = json.loads(lines[-1])
        z = np.load(out)
        edge, cred, res = c.trace(seed)
        same = (np.array_equal(z["edge_trace"], edge)
                and np.array_equal(z["cred_lower"], cred[0])
                and np.array_equal(z["cred_upper"], cred[1])
                and np.array_equal(z["y_mean"], res.y_mean.cpu().numpy())
                and line["n_iters"] == res.n_iters
                and line["lml"] == round(float(res.lml), 3))
        dice = gpt.trace_dicecoef(z["edge_trace"], c.true_edge[:c.E])
        dices.append(dice)
        api_ms, _ = warm_wall(lambda: c.trace(seed))
        log(f"[{tag}] seed {seed}: n_iters {line['n_iters']} DICE {dice}; "
            f"bitwise the in-process GP_Edge_Tracing: {same}; subprocess "
            f"wall {wall * 1e3:.1f} ms (start-up and library load "
            f"included), its trace {line['wall_s'] * 1e3:.1f} ms; "
            f"in-process warm wall {api_ms:.2f} ms (median of 3)")
        if not same:
            checks.failed.append(f"{tag} seed {seed} differs from the API")
    median = sorted(dices)[len(dices) // 2]
    if not (median > 0.985 and min(dices) > 0.97):
        checks.failed.append(f"{tag} DICE gates")
    launches, _ = cli_in_process(["trace", path, *flags, "--seed", "1",
                                  "--out", os.path.join(tmp, "in.npz")])
    check_path_launches(checks, tag, launches, ("K1", "K2", "K3", "K5",
                                                "K6"))
    return launches


def cli_batch_phase(checks, dev, tmp):
    """``batch`` over the 16 frames of ``batch_demo_B16`` (``.npy`` files)
    in a subprocess: every frame's ``edge_trace`` bitwise
    ``trace_batch``'s, DICE median > 0.97."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, trace_batch)
    tag = "cli_batch_demo_B16"
    frames = [demo_config(dev, image_seed=i) for i in BATCH_DEMO_IMAGES]
    d = os.path.join(tmp, "batch")
    os.makedirs(d)
    for i, c in enumerate(frames):
        np.save(os.path.join(d, f"f{i:02d}.npy"), c.img)
    args = ["batch", os.path.join(d, "*.npy"), *init_flags(frames[0].init),
            *CLI_DEMO_FLAGS, "--seed", "1"]
    lines, wall = run_module(CLI, args + ["--out-dir",
                                          os.path.join(tmp, "batch_out")])
    rows = [json.loads(ln) for ln in lines]
    B = len(frames)
    cfg = frames[0].tracer(1).cfg
    data = make_batch_data(cfg, torch.stack([c.grad for c in frames]),
                           np.stack([c.init for c in frames]))
    want = trace_batch(cfg, data, make_batch_state(cfg, B, dev))
    edges = want.edge_trace.cpu().numpy()
    same, dices = [], []
    for f, row in enumerate(rows[:-1]):
        got = np.load(row["out"])["edge_trace"]
        same.append(np.array_equal(got, edges[f])
                    and row["n_iters"] == int(want.n_iters[f]))
        dices.append(gpt.trace_dicecoef(got, frames[f].true_edge))
    median = sorted(dices)[B // 2]
    log(f"[{tag}] {len(rows) - 1} frames, each bitwise trace_batch's: "
        f"{all(same)} ({sum(same)} of {B}); DICE median {median} min "
        f"{min(dices)} (gate median > 0.97); subprocess wall "
        f"{wall * 1e3:.1f} ms, its batch {rows[-1]['wall_s'] * 1e3:.1f} ms")
    if len(rows) != B + 1 or not all(same):
        checks.failed.append(f"{tag} differs from trace_batch")
    if not median > 0.97:
        checks.failed.append(f"{tag} DICE gate")
    launches, _ = cli_in_process(args + ["--out-dir",
                                         os.path.join(tmp, "batch_in")])
    check_path_launches(checks, tag, launches, ("K1", "K2", "K3", "K5",
                                                "K6"))
    return launches


def cli_sequence_phase(checks, dev, tmp):
    """``batch --sequence`` over ``sequence_demo_3``'s frames in a
    subprocess: every frame bitwise ``trace_sequence``'s, DICE > 0.99."""
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import sharded as ps
    from gaussian_process_edge_trace_torch.trace import driver as pd
    tag = "cli_sequence_demo_3"
    images, inits, edge = sequence_images()
    d = os.path.join(tmp, "sequence")
    os.makedirs(d)
    for i, img in enumerate(images):
        np.save(os.path.join(d, f"f{i}.npy"), img)
    args = ["batch", os.path.join(d, "*.npy"), "--sequence",
            *init_flags(inits[0]), *CLI_DEMO_FLAGS, "--seed", "1"]
    lines, wall = run_module(CLI, args + ["--out-dir",
                                          os.path.join(tmp, "seq_out")])
    rows = [json.loads(ln) for ln in lines]
    grads, _, _ = sequence_frames(dev)
    cfg = pd.make_config(inits[0], (500, 500), {
        "kernel": "RBF", "sigma_f": 75, "length_scale": 20}, N_samples=1000,
        score_thresh=1, delta_x=5, keep_ratio=0.1, pixel_thresh=5, seed=1)
    want = ps.trace_sequence(cfg, grads, inits)
    same, dices = [], []
    for row, r in zip(rows[:-1], want):
        got = np.load(row["out"])["edge_trace"]
        same.append(np.array_equal(got, r.edge_trace.cpu().numpy())
                    and row["n_iters"] == r.n_iters)
        dices.append(gpt.trace_dicecoef(got, edge))
    log(f"[{tag}] {len(rows) - 1} frames, each bitwise trace_sequence's: "
        f"{same}; n_iters {[r['n_iters'] for r in rows[:-1]]}; DICE "
        f"{dices} (gate > {SEQUENCE_DICE_GATE}); subprocess wall "
        f"{wall * 1e3:.1f} ms, its sequence {rows[-1]['wall_s'] * 1e3:.1f} ms")
    if len(rows) != SEQUENCE_FRAMES + 1 or not all(same):
        checks.failed.append(f"{tag} differs from trace_sequence")
    if not min(dices) > SEQUENCE_DICE_GATE:
        checks.failed.append(f"{tag} DICE gate")
    launches, _ = cli_in_process(args + ["--out-dir",
                                         os.path.join(tmp, "seq_in")])
    check_path_launches(checks, tag, launches, ("K1", "K2", "K3", "K5",
                                                "K6"))
    return launches


# (technique, kwargs, tolerance of the card against the CPU relative to the
# largest magnitude; 0: bitwise, the filter only sorts or compares). tvc's
# 100 projections amplify last-bit differences (the library's exp, sqrt
# and reductions are the same functions, rounded otherwise on the card);
# tvb's stop reads a mean.
DENOISE_CASES = (
    ("gaussian", {}, 1e-5), ("median", {"size": 3}, 0.0),
    ("median", {"size": 4}, 0.0), ("minimum", {}, 0.0), ("tvc", {}, 5e-4),
    ("nl", {}, 1e-5),
    ("wavelet", {"wavelet": "db1"}, 1e-5),
    ("wavelet", {"wavelet": "db1", "method": "VisuShrink"}, 1e-5),
    ("wavelet", {"wavelet": "db4"}, 1e-5),
    ("wavelet", {"wavelet": "db4", "method": "VisuShrink"}, 1e-5),
    ("wavelet", {"wavelet": "sym8"}, 1e-5),
    ("wavelet", {"wavelet": "sym8", "method": "VisuShrink"}, 1e-5),
    ("tvb", {}, 1e-4))
PSNR_MUST_RISE = ("tvc", "nl", "wavelet", "tvb")


def event_ms(fn, runs=3):
    """Median ms of ``fn`` between two CUDA events after a warm-up call
    (the host's launches included where the card waits for them)."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def denoise_phase(checks, dev):
    """Every technique on the 1000² config's noisy image (image seed 1)
    on the card against the same call on this machine's CPU through the
    port, with its tolerance; PSNR against the noise-free image, which must
    rise over the noisy input's for tvc, nl, wavelet and tvb; each
    technique's time on the card (``event_ms``) and on the CPU."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.utils import denoise_native as dn
    tag = "denoise_1000"
    kw = dict(size=(1000, 1000), amplitude=400, curvature=4,
              ltype="sinusoidal", intensity=0.3, gaps=True, seed=1)
    noisy, _ = gpt.construct_test_img(noise_level=0.05, **kw)
    clean, _ = gpt.construct_test_img(noise_level=0.0, **kw)
    clean_t = torch.tensor(clean, dtype=torch.float64, device=dev)
    x_cpu = torch.tensor(noisy, dtype=torch.float32)
    x = x_cpu.to(dev)
    base = float(dn.peak_signal_noise_ratio(clean_t, x, data_range=1.0))
    log(f"[{tag}] noisy input PSNR {base:.4f} dB")
    for technique, kwargs, tol in DENOISE_CASES:
        got = gpt.denoise(x, technique, kwargs)
        t0 = time.perf_counter()
        cpu = gpt.denoise(x_cpu, technique, kwargs)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        ms = event_ms(lambda: gpt.denoise(x, technique, kwargs))
        err = ((got.cpu() - cpu).abs().max().item()
               / cpu.abs().max().item())
        ok = torch.equal(got.cpu(), cpu) if tol == 0.0 else err <= tol
        psnr = float(dn.peak_signal_noise_ratio(
            clean_t, got[:1000, :1000], data_range=1.0))
        rises = psnr > base
        log(f"[{tag}] {technique} {json.dumps(kwargs)}: card {ms:.3f} ms, "
            f"CPU {cpu_ms:.1f} ms; card vs CPU relative error {err:.3e} "
            f"({'bitwise' if tol == 0.0 else f'tol {tol:g}'}) "
            f"{'ok' if ok else 'FAIL'}; PSNR {psnr:.4f} dB "
            f"({'rises' if rises else 'does not rise'})")
        if not ok:
            checks.failed.append(f"{tag} {technique} {kwargs}: card vs CPU")
        if technique in PSNR_MUST_RISE and not rises:
            checks.failed.append(f"{tag} {technique} {kwargs}: PSNR")


# The JAX package's DICE on the denoised 1000² pipeline over tracer seeds
# 1-12, on a CPU: 0.9853-0.9952, median 0.9927
# (tests/torch_denoised_reference.py); the gates lie below that spread.
DENOISED_GATES = (0.985, 0.975)


def denoised_trace_phase(checks, dev):
    """The 1000² S=10⁴ config traced from ``comp_grad_img(denoise(img,
    'tvc', {}))`` for seeds 1-3 through ``traced``: launches per trace, the
    gates, a rerun and the warm wall. Returns the summed launches."""
    import gaussian_process_edge_trace_torch as gpt
    c = big_config(dev)
    t0 = time.perf_counter()
    den = gpt.denoise(c.img, "tvc", {}, device=dev)
    c.grad = gpt.comp_grad_img(den, gpt.kernel_builder((11, 5), unit=False),
                               device=dev)
    log(f"[denoised_trace_1000] denoise + gradient image "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    return traced(checks, "denoised_trace_1000", c, BIG_SEEDS,
                  ("K1", "K1_transpose", "K2", "K3", "K5", "K6"), ("K4",),
                  DENOISED_GATES)


def profiling_phase(checks, dev, demo):
    """``device_op_breakdown`` of one demo trace names K1, K3, K5 and K6;
    ``sync_timer`` of K1 at 1000² (with its copy) within 2x of
    ``cuda_ms``; ``trace_telemetry`` of the demo trace."""
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
    from gaussian_process_edge_trace_torch.utils import profiling as prof
    tag = "profiling"
    tracer = demo.tracer(1)
    rows = prof.device_op_breakdown(tracer, top=400)
    names = {"K1": ("fused_cost_partial_kernel",),
             "K3": ("binning_2l_kernel",), "K5": ("batched_chol_kernel",),
             "K6": ("batched_trsv_kernel", "batched_trsm_kernel")}
    found = {k: round(sum(ms for ms, n in rows if any(s in n for s in v)),
                      4) for k, v in names.items()}
    log(f"[{tag}] device_op_breakdown of one demo trace: {len(rows)} rows; "
        f"top 5 {[(round(ms, 4), n[:60]) for ms, n in rows[:5]]}; ms by "
        f"kernel {json.dumps(found)}")
    if not all(v > 0 for v in found.values()):
        checks.failed.append(f"{tag}: breakdown lacks one of K1/K3/K5/K6")
    rng = np.random.default_rng(5)
    f32 = dict(dtype=torch.float32, device=dev)
    cols = torch.tensor(rng.random((1000, 1000)), **f32)
    ys = torch.tensor(curve_samples(rng, 1000, 1000, 10000), **f32)

    def k1():
        return ci.fused_cost_cuda(cols, ys, 1e-3, with_transpose=True)
    st_ms = prof.sync_timer(k1) * 1e3
    g_ms = cuda_ms(k1)
    ratio = st_ms / g_ms
    log(f"[{tag}] sync_timer K1 1000² with copy {st_ms:.4f} ms, cuda_ms "
        f"{g_ms:.4f} ms, ratio {ratio:.3f} (gate 0.5-2)")
    if not 0.5 <= ratio <= 2.0:
        checks.failed.append(f"{tag}: sync_timer off cuda_ms by {ratio}")
    tel = prof.trace_telemetry(tracer.last_result)
    log(f"[{tag}] trace_telemetry of the demo trace: " + json.dumps(
        {k: (v.tolist() if hasattr(v, "tolist") else v)
         for k, v in tel.items()}))


def debug_phase(checks, dev, demo):
    """``debug_nans`` raises on a NaN made on the card and leaves no mode
    behind; ``assert_all_finite`` passes the demo result."""
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from gaussian_process_edge_trace_torch.utils import debug
    neg = torch.tensor(-1.0, device=dev)
    raised = False
    try:
        with debug.debug_nans():
            torch.log(neg) / torch.log(neg)
    except FloatingPointError as e:
        raised = True
        log(f"[debug] debug_nans raised on the card: {e}")
    restored = (_get_current_dispatch_mode() is None
                and bool(torch.isnan(torch.log(neg) / torch.log(neg))))
    tracer = demo.tracer(1)
    tracer()
    debug.assert_all_finite(tracer.last_result, "demo result")
    log(f"[debug] raised: {raised}; restored afterwards: {restored}; "
        f"assert_all_finite passed the demo result")
    if not (raised and restored):
        checks.failed.append("debug_nans")


EXAMPLES = (("demo", []), ("serving", []), ("sequence", []),
            ("checkpoint_resume", []), ("multichip", ["--mesh", "1,1"]))


def examples_phase(checks):
    """Each ``python -m gaussian_process_edge_trace_torch.examples.*`` on
    the card exits 0 (``demo --plot`` needs matplotlib and is not run)."""
    for name, args in EXAMPLES:
        lines, wall = run_module(f"{CLI}.examples.{name}", args)
        log(f"[examples] {name} {' '.join(args)}: exit 0 in {wall:.1f} s; "
            f"{' | '.join(ln for ln in lines[-4:] if 'W1' not in ln)}")


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
    log_path = cuda_build.build_dir() / "build.log"
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"[build] {line.strip()}")

    checks = Checks()
    check_kernels(checks, dev)
    # Each path: its configuration, seeds, the kernels it must launch and
    # those it must not, and its DICE gates (median, every seed).
    paths, configs = {}, {}
    for path, tag, make, seeds, need, absent, gates in (
            ("demo", "demo", demo_config, DEMO_SEEDS,
             ("K1", "K2", "K3", "K5", "K6"), ("K1_transpose", "K4"),
             (0.985, 0.97)),
            ("1000_S1e4", "1000²", big_config, BIG_SEEDS,
             ("K1", "K1_transpose", "K2", "K3", "K5", "K6"), ("K4",),
             (0.97, 0.95)),
            ("1000_S1e4_oddE", "1000² odd E",
             lambda dev: big_config(dev, right=-2), ODD_SEEDS,
             ("K2", "K3", "K5", "K6"), ("K1", "K1_transpose", "K4"),
             (0.97, 0.95)),
            ("2000_S1e3", "2000²", config_2000, BIG2K_SEEDS,
             ("K1", "K2", "K3", "K5", "K6"), ("K1_transpose", "K4"),
             BIG2K_GATES)):
        cfg = make(dev)
        paths[path] = traced(checks, tag, cfg, seeds, need, absent, gates)
        configs[tag] = (cfg, seeds[0])
    # The non-square pair: tracer seed 1, an MSE gate each (the tall
    # image's DICE is undefined, as in the JAX package).
    for name, (_, _, mse_gate) in NON_SQUARE.items():
        paths[f"{name}_S1e3"] = traced(
            checks, name, non_square_config(dev, name), (1,),
            ("K1", "K2", "K3", "K5", "K6"), ("K1_transpose", "K4"), None,
            mse_gate=mse_gate)
    coverage_phase(checks, configs["demo"][0])
    wide_draws_phase(checks, configs["demo"][0])
    final_fit_frames_phase(checks, dev)
    paths["curve_kde_pallas_binning"] = pallas_binning_kde(checks, dev)
    # The serving modes: each frame against its own single trace, gates
    # (median, every frame; the demo batch's every-frame gate is its log).
    for path, make, images, gates, odd in (
            ("batch_demo_B16", demo_config, BATCH_DEMO_IMAGES, (0.97, None),
             False),
            ("batch_1000_B4", big_config, BATCH_BIG_IMAGES, BIG_BATCH_GATES,
             False),
            ("batch_1000_oddE_B4", lambda d, image_seed: big_config(
                d, right=-2, image_seed=image_seed), BATCH_BIG_IMAGES,
             BIG_BATCH_GATES, True)):
        frames = [make(dev, image_seed=i) for i in images]
        paths[path] = traced_batch(checks, path, frames, gates, odd=odd,
                                   profiled=path == "batch_demo_B16")
        del frames
    paths[f"ensemble_demo_K{ENSEMBLE_K}"] = ensemble_phase(checks, dev)
    paths["multi_edge"] = multi_edge_phase(checks, dev)
    paths["sequence_demo_3"] = sequence_phase(checks, dev)
    paths.update(sharded_phase(checks, dev))
    # The reference-compatible API.
    paths["introspective_demo"] = introspective_phase(
        checks, "introspective_demo", configs["demo"][0])
    paths["introspective_1000_S1e4"] = introspective_phase(
        checks, "introspective_1000_S1e4", configs["1000²"][0])
    paths["per_stage_demo"] = per_stage_phase(checks, dev)
    paths["checkpoint_1000_S1e4"] = checkpoint_phase(checks, dev)
    paths["sklearn_gpr"] = sklearn_phase(checks, dev)
    for tag, (cfg, seed) in configs.items():
        profile(checks, tag, cfg, seed)
    # The last modules' phases.
    import tempfile
    paths["k4_frames_curve_kde"] = k4_frames_phase(checks, dev)
    selftest_phase(checks)
    with tempfile.TemporaryDirectory() as tmp:
        paths["cli_trace_demo"] = cli_trace_phase(checks, dev, tmp)
        paths["cli_batch_demo_B16"] = cli_batch_phase(checks, dev, tmp)
        paths["cli_sequence_demo_3"] = cli_sequence_phase(checks, dev, tmp)
    denoise_phase(checks, dev)
    paths["denoised_trace_1000"] = denoised_trace_phase(checks, dev)
    profiling_phase(checks, dev, configs["demo"][0])
    debug_phase(checks, dev, configs["demo"][0])
    examples_phase(checks)

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
                for c in k["cases"] if c["main"] or c["also_main"]],
            "frames_cases": checks.frames.get(key, [])})
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
