#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build from ``gaussian_process_edge_trace_torch/csrc`` with
   ``nvcc`` (set-up time);
3. each hand-written kernel (K1 fused curve cost, K2 column interpolation,
   K5 batched Cholesky, K6 batched triangular solves) against its plain
   PyTorch version on CUDA tensors, at the main path's shapes, with the
   tolerance stated beside each check, and both times (CUDA events, median
   of warm runs);
4. the README demo config (500×500, RBF σf=75 ℓ=20, 1000 samples, δx=5)
   traced through ``GP_Edge_Tracing(...)()`` on the card for seeds 1-3: the
   launch counts of every kernel during those traces, MSE and DICE against
   the true edge with the accuracy gates of ``bench.py`` (median DICE >
   0.985, every seed > 0.97), a rerun of seed 1 that must give the same
   trace, and the warm wall time per trace;
5. one JSON line of kernel results, the card line again, and as the last
   line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

DEMO_SEEDS = (1, 2, 3)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warm=3, reps=25):
    """Median device time of ``fn()`` in ms, one CUDA event pair per run."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Checks:
    def __init__(self):
        self.failed = []
        self.kernels = {}

    def record(self, kernel, case, err, tol, ok, ms=None, plain_ms=None):
        entry = self.kernels.setdefault(kernel, {"max_abs_err": 0.0,
                                                 "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], float(err))
        case_row = {"case": case, "max_abs_err": float(err), "tol": tol}
        if ms is not None:
            case_row.update(ms=ms, plain_ms=plain_ms)
        entry["cases"].append(case_row)
        status = "ok" if ok else "FAIL"
        timing = (f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                  if ms is not None else "")
        log(f"[kernels] {kernel} {case}: max_abs_err={err:.3e} ({tol}) "
            f"{status}{timing}")
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


def check_kernels(checks, dev):
    import torch
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci

    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)

    # K1. Both sides sum ~E/2 pair terms of size ~1 in f32 in different
    # orders: the gap is f32 rounding, ~1e-6 relative; the bound is the
    # reference's own interpret-mode test bound (rtol 1e-4 line, 1e-5 arc).
    for case, (E, M, S) in (("demo E=M=500 S=1000", (500, 500, 1000)),
                            ("ragged E=38 M=61 S=130", (38, 61, 130))):
        cols = torch.tensor(rng.random((E, M)), **f32)
        ys = torch.tensor(curve_samples(rng, E, M, S), **f32)
        line, arc = ci.fused_cost_cuda(cols, ys, 1e-3)
        pline, parc = ci.fused_cost_plain(cols, ys, 1e-3)
        torch.cuda.synchronize()
        el, rl = rel_err(line, pline)
        ea, ra = rel_err(arc, parc)
        ok = rl <= 1e-4 and ra <= 1e-5
        kw = {}
        if E == 500:
            kw = dict(ms=cuda_ms(lambda: ci.fused_cost_cuda(cols, ys, 1e-3)),
                      plain_ms=cuda_ms(
                          lambda: ci.fused_cost_plain(cols, ys, 1e-3)))
        checks.record("K1", case, max(el, ea), "rel 1e-4 line, 1e-5 arc",
                      ok, **kw)

    # K2. Same arithmetic, each op rounded once on both sides (the kernel
    # uses the _rn intrinsics): bitwise equal is expected; the bound allows
    # one ulp.
    for case, (E, M, S) in (("final cost E=M=500 S=1", (500, 500, 1)),
                            ("E=M=500 S=1000", (500, 500, 1000))):
        cols = torch.tensor(rng.random((E, M)), **f32)
        ys = torch.tensor(curve_samples(rng, E, M, S), **f32)
        out = ci.column_interp_cuda(cols, ys, 1e-3)
        ref = ci.column_interp_plain(cols, ys, 1e-3)
        torch.cuda.synchronize()
        e, r = rel_err(out, ref)
        kw = {}
        if S == 1:
            kw = dict(ms=cuda_ms(lambda: ci.column_interp_cuda(cols, ys,
                                                               1e-3)),
                      plain_ms=cuda_ms(lambda: ci.column_interp_plain(
                          cols, ys, 1e-3)))
        checks.record("K2", case, e, "rel 1.2e-7 (1 ulp)", r <= 1.2e-7, **kw)

    def spd(B, n):
        A = rng.normal(size=(B, n, n))
        return A @ np.transpose(A, (0, 2, 1)) / n + np.eye(n)

    # K5. Right-looking Cholesky vs LAPACK-style blocked potrf: f32
    # rounding in another order, ~n·eps relative on a well-conditioned
    # batch; the bound is 2e-5 of max |L|. One non-PD matrix must give NaN
    # on both sides.
    K = spd(109, 104)
    K[7] = -K[7]
    Kt = torch.tensor(K, **f32)
    L = cc.cholesky_cuda(Kt)
    Lp = cc.cholesky_plain(Kt)
    torch.cuda.synchronize()
    nan_k = torch.isnan(torch.diagonal(L[7])).any().item()
    nan_p = torch.isnan(Lp[7]).all().item()
    keep = torch.ones(109, dtype=torch.bool, device=dev)
    keep[7] = False
    e, r = rel_err(L[keep], Lp[keep])
    checks.record("K5", "B=109 n=104 (+1 non-PD -> NaN)", e, "rel 2e-5",
                  r <= 2e-5 and nan_k and nan_p and
                  not torch.isnan(L[keep]).any().item(),
                  ms=cuda_ms(lambda: cc.cholesky_cuda(Kt)),
                  plain_ms=cuda_ms(lambda: cc.cholesky_plain(Kt)))
    K2 = torch.tensor(spd(8, 200), **f32)
    Lb = cc.cholesky_auto(K2)
    torch.cuda.synchronize()
    e, r = rel_err(Lb, cc.cholesky_plain(K2))
    checks.record("K5", "blocked n=200 B=8", e, "rel 2e-5", r <= 2e-5)

    # K6. Substitution in row order vs LAPACK trsm: f32 rounding in another
    # order on well-conditioned factors; the bound is 2e-5 of max |Z|.
    Lw = cc.cholesky_plain(torch.tensor(spd(56, 104), **f32))
    for m in (1, 104):
        R = (torch.eye(104, **f32).expand(56, 104, 104).contiguous() if m > 1
             else torch.tensor(rng.normal(size=(56, 104, 1)), **f32))
        for name, transpose in (("forward", False), ("backward", True)):
            Z = cc.solve_cuda(Lw, R, transpose)
            Zp = cc.solve_plain(Lw, R, transpose)
            torch.cuda.synchronize()
            e, r = rel_err(Z, Zp)
            kw = {}
            if m > 1 and not transpose:
                kw = dict(ms=cuda_ms(lambda: cc.solve_cuda(Lw, R, False)),
                          plain_ms=cuda_ms(
                              lambda: cc.solve_plain(Lw, R, False)))
            checks.record("K6", f"{name} B=56 n=104 m={m}", e, "rel 2e-5",
                          r <= 2e-5, **kw)
    R = torch.tensor(rng.normal(size=(8, 200, 3)), **f32)
    e, r = rel_err(cc.forward_solve_auto(Lb, R),
                   cc.solve_plain(Lb, R, False))
    checks.record("K6", "blocked forward n=200 m=3", e, "rel 2e-5",
                  r <= 2e-5)
    e, r = rel_err(cc.backward_solve_auto(Lb, R),
                   cc.solve_plain(Lb, R, True))
    checks.record("K6", "blocked backward n=200 m=3", e, "rel 2e-5",
                  r <= 2e-5)


def demo(checks, dev):
    """The README demo through GP_Edge_Tracing on the card."""
    import torch
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.ops import cuda_chol as cc
    from gaussian_process_edge_trace_torch.ops import cuda_interp as ci

    img, true_edge = gpt.construct_test_img((500, 500), 200, 4, 0.05,
                                            "sinusoidal", 0.3, gaps=True)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5), unit=False),
                             device=dev)
    init = true_edge[[0, -1]][:, [1, 0]]
    ko = {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}

    def trace(seed):
        tracer = gpt.GP_Edge_Tracing(init, grad, ko, 1, np.array([]), 1000,
                                     1, 5, 0.1, 5, seed, True, True,
                                     device=dev)
        edge, cred = tracer()
        torch.cuda.synchronize()
        return edge, cred, tracer.last_result

    for counts in (ci.LAUNCHES, cc.LAUNCHES):
        for k in counts:
            counts[k] = 0
    runs = {seed: trace(seed) for seed in DEMO_SEEDS}
    launches = {"K1": ci.LAUNCHES["fused_cost"],
                "K2": ci.LAUNCHES["column_interp"],
                "K5": cc.LAUNCHES["cholesky"], "K6": cc.LAUNCHES["trsm"]}
    log(f"[demo] kernel launches over seeds {DEMO_SEEDS}: "
        f"{json.dumps(launches)}")
    for k, n in launches.items():
        if n <= 0:
            checks.failed.append(f"demo did not launch {k}")

    dices = []
    for seed, (edge, cred, res) in runs.items():
        mse = gpt.trace_MSE(edge, true_edge)
        dice = gpt.trace_dicecoef(edge, true_edge)
        dices.append(dice)
        finite = bool(np.isfinite(cred[0]).all() and np.isfinite(cred[1]).all()
                      and torch.isfinite(res.y_mean).all().item())
        shape_ok = edge.shape == (500, 2) and cred[0].shape == (500,)
        log(f"[demo] seed {seed}: n_iters={res.n_iters} MSE={mse} "
            f"DICE={dice} theta={res.theta.tolist()} "
            f"final_cost={res.final_cost.item():.6f} finite={finite}")
        if not (finite and shape_ok):
            checks.failed.append(f"demo seed {seed}: non-finite or shape")
    median = sorted(dices)[len(dices) // 2]
    gates = median > 0.985 and min(dices) > 0.97
    log(f"[demo] DICE median={median} min={min(dices)} "
        f"(gates: median > 0.985, min > 0.97) {'ok' if gates else 'FAIL'}")
    if not gates:
        checks.failed.append("demo DICE gates")

    again = trace(DEMO_SEEDS[0])[0]
    same = np.array_equal(again, runs[DEMO_SEEDS[0]][0])
    log(f"[demo] rerun of seed {DEMO_SEEDS[0]} identical: {same}")
    if not same:
        checks.failed.append("demo rerun differs")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        trace(DEMO_SEEDS[0])
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[demo] warm wall time per trace (seed {DEMO_SEEDS[0]}, median of "
        f"3 after warm-up): {statistics.median(walls):.2f} ms "
        f"(runs {[round(w, 2) for w in walls]})")
    return launches


KERNEL_ROWS = {
    "K1": ("fused_curve_cost", "gaussian_process_edge_trace_torch/csrc/"
           "fused_cost_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_interp.py:230"),
    "K2": ("column_interp", "gaussian_process_edge_trace_torch/csrc/"
           "column_interp_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_interp.py:167"),
    "K5": ("batched_cholesky", "gaussian_process_edge_trace_torch/csrc/"
           "batched_chol_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_chol.py:218"),
    "K6": ("batched_triangular_solve", "gaussian_process_edge_trace_torch/"
           "csrc/batched_trsm_kernel.cu",
           "gaussian_process_edge_trace_tpu/ops/pallas_chol.py:274"),
}
NOT_PORTED = [
    {"name": "K3 binning_2l", "status": "not_ported",
     "replaces": "gaussian_process_edge_trace_tpu/trace/pallas_kde.py:153"},
    {"name": "K4 binning_pallas", "status": "not_ported",
     "replaces": "gaussian_process_edge_trace_tpu/trace/pallas_kde.py:199"},
]


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
    launches = demo(checks, dev)

    rows = []
    for key, (name, source, replaces) in KERNEL_ROWS.items():
        k = checks.kernels.get(key, {"max_abs_err": float("nan"),
                                     "cases": []})
        timed = [c for c in k["cases"] if "ms" in c]
        rows.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": k["max_abs_err"],
            "ms": timed[0]["ms"] if timed else None,
            "plain_ms": timed[0]["plain_ms"] if timed else None,
            "timed_case": timed[0]["case"] if timed else None})
    if checks.failed:
        log(f"chip_smoke: FAILED: {checks.failed}")
        return 1
    log(json.dumps({"kernels": rows, "not_ported": NOT_PORTED}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
