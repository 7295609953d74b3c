#!/usr/bin/env python3
"""The port's kernels against the designs they were chosen over, on an
NVIDIA GPU: K1 and K3 at inputs taken from the traces themselves, K2 and
K4 at ``chip_smoke.py``'s check shapes.

Not collected by pytest. Run from the repository root on a machine with a
CUDA card and ``nvcc``:

    python3 tests/torch_kernel_variants.py [--only K1K3|K2K4]
        [--previous DIR]

``--previous DIR`` names the ``csrc`` directory of an earlier tree (for
example one unpacked with ``git archive``): its ``column_interp_kernel.cu``
and ``binning_dense_kernel.cu``, whose launchers take no launch plan, are
built and timed beside the shipped K2 and K4 in the same run.

K2 and K4: K2 at the odd-E trace's unfused cost (E=999, M=1000, S=10⁴),
the odd demo shape (E=499, M=500, S=1000) and the final cost (S = 1),
beside ``grid_sample``; K4 at the 1000² kept-curve shape and its worst
cases, also with fewer columns per block than its plan's; each held
bitwise to the plain version (K2) or the sequential plain version (K4).

K1 and K3: it traces the README demo and the 1000² S=10⁴ config once each
(seed 1, ``chip_smoke.py``'s configurations), keeps the inputs of the
fourth K1 and K3 launch of each, and times, as ``chip_smoke.cuda_ms`` does:

- K1 as shipped; with the interpolation taps read from device memory (L2)
  instead of the chunk's rows staged in shared memory; with IEEE square
  roots and divisions instead of rsqrt and approximate reciprocals; and at
  other block sizes and blocks per SM of its launch plan;
- K3 as shipped (lanes sorted by row through comparison ranks) and with
  ``__match_any_sync`` grouping the lanes instead.

Each variant is a copy of the shipped source with one substitution, built
into ``build/kernel_variants/``; a substitution that no longer applies
stops the script. Every variant is held against the plain version with
the smoke's tolerances. It also prints how far a warp's 32 curves spread
over the rows at one column, which decides how K1 reads its taps, and on
how many rows a batch of 32 kept curves falls, which is what
``__match_any_sync``'s time grows with.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gaussian_process_edge_trace_torch.ops import cuda_build  # noqa: E402
from gaussian_process_edge_trace_torch.ops import (  # noqa: E402
    cuda_interp as ci)
from gaussian_process_edge_trace_torch.trace import cuda_kde as ck  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

K1_VARIANTS = {
    "taps from L2": [
        ("const int nstage = (2 * np + 1) * M;", "const int nstage = 0;"),
        ("float g0 = lerp_row(srow, y[0], M, kde_thresh);",
         "float g0 = lerp_row(src, y[0], M, kde_thresh);"),
        ("const float* rows = srow + (size_t)(2 * p + 1) * M;",
         "const float* rows = src + (size_t)(2 * p + 1) * M;")],
    "IEEE sqrt and division": [
        ("  float x = 1.0f + d * d;\n  return x * rsqrtf(x);",
         "  return sqrtf(1.0f + d * d);"),
        ("        const float i0 = __fdividef(1.0f, h0);\n"
         "        const float i1 = __fdividef(1.0f, h1);\n"
         "        const float q = hsum * (1.0f / 6.0f);\n"
         "        const float c0 = q * (2.0f - h1 * i0);\n"
         "        const float c1 = q * (hsum * hsum * (i0 * i1));\n"
         "        const float c2 = q * (2.0f - h0 * i1);",
         "        const float c0 = (hsum / 6.0f) * (2.0f - h1 / h0);\n"
         "        const float c1 = (hsum / 6.0f) * (hsum * hsum / (h0 * h1));\n"
         "        const float c2 = (hsum / 6.0f) * (2.0f - h0 / h1);")],
}
MATCH_ANY = """      // Group order: groups by their first lane, lanes in order.
      const unsigned grp = __match_any_sync(kFull, lo);
      const int leader = __ffs(grp) - 1;
      const int rank = __popc(grp & ((1u << lane) - 1u));
      const int size = lane == leader ? __popc(grp) : 0;
      int incl = size;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      const int dst = __shfl_sync(kFull, incl - size, leader) + rank;
"""
# Launch plans of K1 other than the shipped one: (threads, blocks per SM).
K1_PLANS = ((128, 4), (512, 1), (1024, 1))


def build(name, src):
    """Build one variant's source into its own library and load it."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    lib = cuda_build.compile_library(cu, OUT / f"lib{name}.so")
    for fn, argtypes in (("gpet_fused_cost",
                          [P] * 6 + [I, I, I, F, I, I, I, I, I, I, P]),
                         ("gpet_binning_2l", [P] * 3 + [I] * 7 + [P])):
        if hasattr(lib, fn):         # each source has one of the two
            getattr(lib, fn).argtypes = argtypes
    return lib


def substituted(src, subs):
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"variant substitution no longer applies: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def captured_inputs(dev):
    """The fourth K1 and K3 launch of one demo and one 1000² trace."""
    seen = {"K1": [], "K3": []}
    k1, k3 = ci.fused_cost_cuda, ck.binning_2l_cuda

    def k1_spy(cols, ys, kde_thresh=0.0, with_transpose=False):
        seen["K1"].append((cols.clone(), ys.clone(), kde_thresh,
                           with_transpose))
        return k1(cols, ys, kde_thresh, with_transpose)

    def k3_spy(y, w, M):
        seen["K3"].append((y.clone(), w.clone(), M))
        return k3(y, w, M)

    ci.fused_cost_cuda, ck.binning_2l_cuda = k1_spy, k3_spy
    inputs = {}
    try:
        for tag, cfg in (("demo", cs.demo_config(dev)),
                         ("1000²", cs.big_config(dev))):
            for key in seen:
                seen[key].clear()
            cfg.trace(1)
            inputs[tag] = {key: seen[key][3] for key in seen}
    finally:
        ci.fused_cost_cuda, ck.binning_2l_cuda = k1, k3
    return inputs


def row_spread(ys):
    """Mean over rows e of (max - min) of y over a warp's 32 samples."""
    E, S = ys.shape
    w = ys[:, :S // 32 * 32].reshape(E, -1, 32)
    return (w.amax(-1) - w.amin(-1)).mean().item()


def rows_per_batch(y, M):
    """Mean number of distinct rows lo among a batch of 32 kept curves at
    one column, as K3 groups them."""
    E, S = y.shape
    lo = torch.floor(torch.clamp(y, -1, M) + 1)[:, :S // 32 * 32]
    lo = torch.sort(lo.reshape(E, -1, 32), dim=-1).values
    return (1 + (torch.diff(lo, dim=-1) != 0).sum(-1)).float().mean().item()


def time_k1(lib, cols, ys, kde_thresh, transpose, plan):
    E, M = cols.shape
    S = ys.shape[1]
    f32 = dict(dtype=torch.float32, device=ys.device)
    partial = torch.empty(plan["n_chunks"], 2, S, **f32)
    line, arc = torch.empty(S, **f32), torch.empty(S, **f32)
    st = torch.empty(S, E, **f32) if transpose else None

    def launch():
        rc = lib.gpet_fused_cost(
            cols.data_ptr(), ys.data_ptr(), partial.data_ptr(),
            line.data_ptr(), arc.data_ptr(), st.data_ptr() if transpose
            else None, E, M, S, kde_thresh, plan["pairs_per_chunk"],
            plan["n_chunks"], plan["samples_per_block"], plan["threads"],
            1, 0, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(rc, "fused_cost variant")
    launch()
    pline, parc = ci.fused_cost_plain(cols, ys, kde_thresh)
    torch.cuda.synchronize()
    ok = (cs.rel_err(line, pline)[1] <= 1e-4 and cs.rel_err(arc, parc)[1]
          <= 1e-5 and (not transpose or torch.equal(st, ys.T.contiguous())))
    return cs.cuda_ms(launch), ok


def time_k3(lib, y, w, M):
    E, S = y.shape
    plan = ck.k3_launch_plan(E, S, M)
    H = torch.empty(M + 2, E, dtype=torch.float32, device=y.device)

    def launch():
        rc = lib.gpet_binning_2l(
            y.data_ptr(), w.data_ptr(), H.data_ptr(), E, S, M, plan["cols"],
            plan["warps_per_col"], plan["batches_per_warp"], 1,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check(rc, "binning_2l variant")
    launch()
    ref = ck.column_binning_plain(y, w, M)
    torch.cuda.synchronize()
    ok = bool(((H - ref).abs() <= 1e-5 * ref.abs()
               + 1e-6 * ref.abs().max()).all().item())
    return cs.cuda_ms(launch), ok


def k1_plan(E, M, S, transpose, threads, per_sm):
    saved = ci._K1_THREADS, ci._K1_BLOCKS_PER_SM
    ci._K1_THREADS, ci._K1_BLOCKS_PER_SM = threads, per_sm
    try:
        return ci.k1_launch_plan(E, M, S, transpose)
    finally:
        ci._K1_THREADS, ci._K1_BLOCKS_PER_SM = saved


K2_CASES = (("unfused cost E=999 M=1000 S=10⁴", (999, 1000, 10000)),
            ("odd demo E=499 M=500 S=1000", (499, 500, 1000)),
            ("final cost E=M=1000 S=1", (1000, 1000, 1)))
# K4's plan at other columns per block than the shipped one.
K4_COLS = (1, 2, 4, 8)
K4_CASES = (("1000² kept curves E=S=M=1000", "walk"),
            ("every sample in one row E=S=M=1000", "one row"),
            ("every sample outside the image E=S=M=1000", "outside"))


def previous_kernels(csrc):
    """K2 and K4 built from an earlier tree's sources, with that tree's
    launchers: (cols, ys, out, E, M, S, add_const, stream) and (y, w, H, E,
    S, M, stream)."""
    libs = {}
    for name, fn, argtypes in (
            ("column_interp_kernel", "gpet_column_interp",
             [P, P, P, I, I, I, F, P]),
            ("binning_dense_kernel", "gpet_binning_dense",
             [P, P, P, I, I, I, P])):
        OUT.mkdir(parents=True, exist_ok=True)
        lib = cuda_build.compile_library(Path(csrc) / f"{name}.cu",
                                         OUT / f"libprevious_{name}.so")
        getattr(lib, fn).argtypes = argtypes
        libs[fn] = getattr(lib, fn)
    return libs


def k2_k4(dev, previous):
    """Shipped K2 and K4 (and, with ``previous``, the earlier tree's) at
    their check shapes; returns the names of the runs that failed."""
    import numpy as np
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)

    def stream():      # read at each call: cuda_ms captures on its own stream
        return torch.cuda.current_stream().cuda_stream
    failed = []
    lib = cuda_build.library()
    for case, (E, M, S) in K2_CASES:
        cols = torch.tensor(rng.random((E, M)), **f32)
        ys = torch.tensor(cs.curve_samples(rng, E, M, S), **f32)
        ref = ci.column_interp_plain(cols, ys, 1e-3)
        runs = {"shipped": lambda: ci.column_interp_cuda(cols, ys, 1e-3)}
        if previous:
            out = torch.empty_like(ys)

            def old():
                cuda_build.check(previous["gpet_column_interp"](
                    cols.data_ptr(), ys.data_ptr(), out.data_ptr(), E, M, S,
                    1e-3, stream()), "previous column_interp")
                return out
            runs["previous"] = old
        runs["grid_sample"] = cs.grid_sample_interp(cols, ys, 1e-3)
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            print(f"[K2 {case}] {name}: {cs.cuda_ms(fn):.4f} ms, bitwise "
                  f"equal to the plain version: {same}")
            if not same and name != "grid_sample":
                failed.append(f"K2 {case} {name}")
    for case, kind in K4_CASES:
        yn, wn = cs.kept_curves(rng, 1000, 1000, 1000, kind)
        y = torch.tensor(yn, **f32)
        w = torch.tensor(wn, **f32)
        seq = ck.column_binning_sequential(y, w, 1000)
        runs = {"shipped": lambda: ck.binning_dense_cuda(y, w, 1000)}
        if previous:
            H = torch.empty(1002, 1000, **f32)

            def old():
                cuda_build.check(previous["gpet_binning_dense"](
                    y.data_ptr(), w.data_ptr(), H.data_ptr(), 1000, 1000,
                    1000, stream()), "previous binning_dense")
                return H
            runs["previous"] = old
        for cols in K4_COLS:
            Hc = torch.empty(1002, 1000, **f32)

            def other(cols=cols, Hc=Hc):
                cuda_build.check(lib.gpet_binning_dense(
                    y.data_ptr(), w.data_ptr(), Hc.data_ptr(), 1000, 1000,
                    1000, 1000, cols, 1, stream()), "binning_dense")
                return Hc
            runs[f"shipped at {cols} columns per block"] = other
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            same = torch.equal(got, seq)
            print(f"[K4 {case}] {name}: {cs.cuda_ms(fn):.4f} ms, bitwise "
                  f"equal to the sequential version: {same}")
            if not same:
                failed.append(f"K4 {case} {name}")
    return failed


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", choices=("K1K3", "K2K4"))
    p.add_argument("--previous", help="an earlier tree's csrc directory")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    failed = []
    if args.only != "K1K3":
        failed += k2_k4(dev, args.previous and previous_kernels(
            args.previous))
    if args.only != "K2K4":
        failed += k1_k3(dev)
    if failed:
        print(f"torch_kernel_variants: FAILED {failed}")
        return 1
    return 0


def k1_k3(dev):
    """K1 and K3 against their variants on the traces' inputs; returns the
    names of the runs that failed."""
    k1_src = (cuda_build.CSRC_DIR / "fused_cost_kernel.cu").read_text()
    k3_src = (cuda_build.CSRC_DIR / "binning_2l_kernel.cu").read_text()
    a = k3_src.index("      // Group order:")
    b = k3_src.index("      b1[dst] = w1;")
    libs = {"shipped": build("shipped", k1_src)}
    for name, subs in K1_VARIANTS.items():
        libs[name] = build(name.replace(" ", "_"), substituted(k1_src, subs))
    k3_libs = {"shipped": build("shipped_k3", k3_src),
               "match_any": build("match_any",
                                  k3_src[:a] + MATCH_ANY + k3_src[b:])}
    failed = []
    for tag, got in captured_inputs(dev).items():
        cols, ys, kde_thresh, transpose = got["K1"]
        E, M = cols.shape
        S = ys.shape[1]
        print(f"[{tag}] K1 E={E} M={M} S={S}{' +copy' if transpose else ''}:"
              f" a warp's 32 curves span {row_spread(ys):.1f} rows on "
              f"average")
        runs = [(name, lib, ci.k1_launch_plan(E, M, S, transpose))
                for name, lib in libs.items()]
        runs += [(f"shipped, {t} threads x {n} per SM", libs["shipped"],
                  k1_plan(E, M, S, transpose, t, n)) for t, n in K1_PLANS]
        for name, lib, plan in runs:
            for copy in ((True, False) if transpose else (False,)):
                ms, ok = time_k1(lib, cols, ys, kde_thresh, copy, plan)
                print(f"[{tag}]   K1 {name}{' +copy' if copy else ''}: "
                      f"{ms:.4f} ms {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{tag} K1 {name}")
        y, w, M = got["K3"]
        print(f"[{tag}] K3 E={y.shape[0]} S={y.shape[1]} M={M}: a batch of "
              f"32 kept curves falls on {rows_per_batch(y, M):.1f} rows on "
              f"average")
        for name, lib in k3_libs.items():
            ms, ok = time_k3(lib, y, w, M)
            print(f"[{tag}]   K3 {name}: {ms:.4f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{tag} K3 {name}")
    return failed


if __name__ == "__main__":
    sys.exit(main())
