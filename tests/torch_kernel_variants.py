#!/usr/bin/env python3
"""The port's kernels against the designs they were chosen over, on an
NVIDIA GPU: K1 and K3 at inputs taken from the traces themselves, K2, K4
and K7 at ``chip_smoke.py``'s check shapes.

Not collected by pytest. Run from the repository root on a machine with a
CUDA card and ``nvcc``:

    python3 tests/torch_kernel_variants.py [--only K1K3|K2K4|K7]
        [--previous DIR]

``--previous DIR`` names the ``csrc`` directory of an earlier tree (for
example one unpacked with ``git archive``): its ``column_interp_kernel.cu``
and ``binning_dense_kernel.cu``, whose launchers take no launch plan, are
built and timed beside the shipped K2 and K4 in the same run, and with
``--only K7`` its ``threefry_normal_kernel.cu`` (the one-draw launcher
``gpet_threefry``, where the tree has it) beside the shipped K7.

K7: the shipped draw kernel and its variants (256 threads per block where
it takes 128; 2 and 4 elements per thread where it takes 8; threefry's adds
all on the ALU, or only the rounds' adds on the FMA pipe, where it issues
every add there; erf_inv's coefficient selected at each Horner step, or
both chains evaluated and one selected, where it branches to the rare
w >= 5 chain; log1p's arms behind a branch where it computes both; the
one-element kernel's forms of both), each bitwise the shipped kernel's
draws, timed at the 1000² noise draw (208, 10⁴), one iteration's table of
the demo, the 1000² config and its S = 10⁵ row, beside ``torch.randn`` of
the same shapes; and each build's SASS (``cuobjdump -sass``): the draw
kernel's static instructions by opcode class, and per element (over its
elements per thread).

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
import json
import re
import subprocess
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


# K7's launch shape as shipped (csrc/threefry_normal_kernel.cu) and the
# variants of it that are timed: threads per block, elements per thread.
K7_SHAPE = {"kThreads": 128, "kPerThread": 8}
K7_SHAPE_VARIANTS = {
    "256 threads": {"kThreads": 256},
    "4 per thread, 256 threads": {"kThreads": 256, "kPerThread": 4},
    "2 per thread, 256 threads": {"kThreads": 256, "kPerThread": 2}}
K7_VARIANTS = {
    name: [(f"constexpr int {k} = {K7_SHAPE[k]};",
            f"constexpr int {k} = {v};") for k, v in shape.items()]
    for name, shape in K7_SHAPE_VARIANTS.items()}
# threefry's adds: all on the ALU, or only the rounds' on the FMA pipe.
INJECTIONS = (
    "    x0 = add_on_fma(x0, ks[(i + 1) % 3], one);\n"
    "    x1 = add_on_fma(x1, ks[(i + 2) % 3] + (uint32_t)(i + 1), one);",
    "    x0 += ks[(i + 1) % 3];\n"
    "    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);")
K7_VARIANTS["adds on the ALU"] = [
    ('  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), '
     '"r"(b));', "  d = a + b;"), INJECTIONS]
K7_VARIANTS["rounds' adds only on the FMA pipe"] = [INJECTIONS]
K7_VARIANTS["log1p behind a branch"] = [
    ("  const float large = xla_log(__fadd_rn(t, 1.0f));",
     "  if (!(fabsf(t) < bits_f(0x3ED413CDu)))\n"
     "    return xla_log(__fadd_rn(t, 1.0f));"),
    ("  return fabsf(t) < bits_f(0x3ED413CDu) ? small : large;",
     "  return small;")]
# erf_inv's w < 5 and w >= 5 arms as the one-element kernel had them (one
# Horner chain, its coefficient selected at each step) and as both chains
# evaluated for every element, one selected: each takes the place of the
# shipped branch, from ``float p;`` to the return.
ERF_FORMS = {
    "erf_inv selects per step": (
        "  const bool lt = l1p > -5.0f;\n"
        "  const float w = lt ? __fsub_rn(-2.5f, l1p)\n"
        "                     : __fadd_rn(__fsqrt_rn(-l1p), -3.0f);\n"
        "  const uint32_t lt5[9] = {0x32F16588u, 0x34B84B36u, 0xB66C7357u,\n"
        "                           0xB6935AC1u, 0x396532DBu, 0xBAA45408u,\n"
        "                           0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};\n"
        "  const uint32_t ge5[9] = {0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u,\n"
        "                           0xBB70BDE7u, 0x3BBC127Bu, 0xBBF9C5D7u,\n"
        "                           0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};\n"
        "  float p = fmaf(bits_f(lt ? lt5[0] : ge5[0]), w,\n"
        "                 bits_f(lt ? lt5[1] : ge5[1]));\n"
        "#pragma unroll\n"
        "  for (int i = 2; i < 9; ++i)\n"
        "    p = fmaf(w, p, bits_f(lt ? lt5[i] : ge5[i]));\n"
        "  return __fmul_rn(x, p);"),
    "erf_inv both chains selected": (
        "  const bool lt = l1p > -5.0f;\n"
        "  const float w = lt ? __fsub_rn(-2.5f, l1p)\n"
        "                     : __fadd_rn(__fsqrt_rn(-l1p), -3.0f);\n"
        "  float p = fmaf(bits_f(0x32F16588u), w, bits_f(0x34B84B36u));\n"
        "  float q = fmaf(bits_f(0xB951F09Bu), w, bits_f(0x38D3B56Bu));\n"
        + "".join(f"  p = fmaf(w, p, bits_f({a}));\n  q = fmaf(w, q, bits_f({b}));\n"
                  for a, b in zip(
                      ("0xB66C7357u", "0xB6935AC1u", "0x396532DBu",
                       "0xBAA45408u", "0xBB88E4EFu", "0x3E7C8F63u",
                       "0x3FC02E2Fu"),
                      ("0x3AB0DC72u", "0xBB70BDE7u", "0x3BBC127Bu",
                       "0xBBF9C5D7u", "0x3C1AA57Eu", "0x3F8036DBu",
                       "0x40354F7Eu")))
        + "  return __fmul_rn(x, lt ? p : q);")}


def erf_form(src, name):
    a = src.index("  float p;\n  if (l1p > -5.0f) {")
    end = "  return __fmul_rn(x, p);"
    b = src.index(end, a) + len(end)
    return src[:a] + ERF_FORMS[name] + src[b:]


# Opcode classes of the SASS counts (Hopper): integer ALU, integer
# multiply-add (issued to the FMA pipe), float32, uniform datapath, memory
# and the rest (control, moves, conversions).
SASS_CLASSES = (
    ("int", ("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP",
             "SEL", "LEA", "PRMT", "IABS", "IMNMX", "FLO", "POPC", "BMSK",
             "PLOP3", "P2R", "R2P")),
    ("imad", ("IMAD",)),
    ("float", ("FFMA", "FADD", "FMUL", "FSETP", "FSEL", "FMNMX", "MUFU",
               "FCHK", "I2F", "F2I", "FRND", "FSWZADD")),
    ("uniform", ("U",)),
    ("memory", ("LDG", "STG", "LDC", "LDS", "STS", "LDL", "STL", "LD",
                "ST")))


def sass_counts(so, name):
    """Static SASS instructions of the kernel whose symbol holds ``name``
    in the library ``so``: {opcode class: count}, NOPs left out."""
    import collections
    import shutil
    tool = shutil.which("cuobjdump") or str(
        Path(cuda_build._nvcc()).with_name("cuobjdump"))
    dump = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in dump.splitlines():
        fn = re.match(r"\s*Function : (\S+)", line)
        if fn:
            inside = name in fn.group(1)
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if inside and op and op.group(1) != "NOP":
            base = op.group(1)
            cls = next((c for c, ops in SASS_CLASSES
                        if base in ops or (c == "uniform"
                                           and base.startswith("U"))),
                       "other")
            counts[cls] += 1
            counts["all"] += 1
    return dict(counts)


def k7(dev, previous):
    """K7 as shipped against its variants and, with ``previous``, the
    earlier tree's kernel; returns the names of the runs that failed."""
    import chip_smoke as smoke
    from gaussian_process_edge_trace_torch.ops import prng
    src = (cuda_build.CSRC_DIR / "threefry_normal_kernel.cu").read_text()
    variants = {name: substituted(src, subs)
                for name, subs in K7_VARIANTS.items()}
    for name in ERF_FORMS:
        variants[name] = erf_form(src, name)
    variants["both as in the one-element kernel"] = erf_form(
        variants["log1p behind a branch"], "erf_inv selects per step")
    libs = {}
    for name, vsrc in {"shipped": src, **variants}.items():
        libs[name] = (vsrc, int(re.search(r"constexpr int kPerThread = "
                                          r"(\d+);", vsrc).group(1)))
    built = {}
    for name, (vsrc, per) in libs.items():
        OUT.mkdir(parents=True, exist_ok=True)
        stem = "k7_" + re.sub(r"\W+", "_", name)
        cu = OUT / f"{stem}.cu"
        cu.write_text(vsrc)
        lib = cuda_build.compile_library(cu, OUT / f"lib{stem}.so")
        lib.gpet_threefry_table.argtypes = [P, I, P]
        built[name] = (lib, OUT / f"lib{stem}.so", per)
    old = None
    if previous and (Path(previous) / "threefry_normal_kernel.cu").exists():
        so = OUT / "libprevious_threefry.so"
        old = cuda_build.compile_library(
            Path(previous) / "threefry_normal_kernel.cu", so)
        if hasattr(old, "gpet_threefry"):
            old.gpet_threefry.argtypes = [P, ctypes.c_uint, ctypes.c_uint] + [
                ctypes.c_longlong] * 4 + [I, F, F, I, P]
            built_old = (old, so, 1)
        else:
            old = None
    key = prng.split(prng.fold_in(prng.prng_key(1), 1))
    cases = {
        "normals (208, 10^4)": [prng.Draw("normal", key[1], (208, 10000))],
        "demo iteration (56 + 104, 1000)": [
            prng.Draw("normal", key[0], (56, 1000)),
            prng.Draw("normal", key[1], (104, 1000))],
        "1000^2 iteration (48 + 208, 10^4)": [
            prng.Draw("normal", key[0], (48, 10000)),
            prng.Draw("normal", key[1], (208, 10000))],
        "S=10^5 iteration (48 + 208, 10^5)": [
            prng.Draw("normal", key[0], (48, 100000)),
            prng.Draw("normal", key[1], (208, 100000))]}
    failed = []
    for case, table in cases.items():
        outs = [prng.empty(d, dev) for d in table]
        args = (prng._DrawArgs * len(table))(
            *(prng._args(d, o) for d, o in zip(table, outs)))
        want = prng.draw(table, dev)
        randn_ms = smoke.cuda_ms(lambda: [torch.randn(d.shape, device=dev)
                                          for d in table])
        print(f"[K7] {case}: torch.randn of the same shapes {randn_ms:.4f} "
              f"ms (context)")

        def launch(lib):
            stream = torch.cuda.current_stream().cuda_stream
            cuda_build.check(lib.gpet_threefry_table(args, len(table),
                                                     stream), "threefry")

        runs = [(name, lambda lib=lib: launch(lib))
                for name, (lib, _, _) in built.items()]
        if old is not None:
            def launch_old():
                stream = torch.cuda.current_stream().cuda_stream
                for d, o in zip(table, outs):
                    rows, S, c0, n = prng._rows_cols(d.shape, d.cols)
                    lo, span = prng._bounds(prng.NORMAL_LO, 1.0)
                    cuda_build.check(old.gpet_threefry(
                        o.data_ptr(), d.key[0], d.key[1], rows, S, c0, n, 2,
                        lo, span, 256, stream), "previous threefry")
            runs.append(("previous tree (one launch per draw)", launch_old))
        for name, fn in runs:
            for o in outs:
                o.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            ok = all(smoke.same_bits(o, w) for o, w in zip(outs, want))
            ms = smoke.cuda_ms(fn)
            print(f"[K7] {case}: {name} {ms:.4f} ms "
                  f"{'bitwise the shipped draws' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"K7 {case} {name}")
    if old is not None:
        built["previous tree"] = built_old
    for name, (_, so, per) in built.items():
        counts = sass_counts(so, "threefry")
        print(f"[K7] SASS {name}: {json.dumps(counts)} static instructions "
              f"of the draw kernel; {counts.get('all', 0) / per:.1f} per "
              f"element ({per} per thread)")
    return failed


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", choices=("K1K3", "K2K4", "K7"))
    p.add_argument("--previous", help="an earlier tree's csrc directory")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    failed = []
    if args.only in (None, "K2K4"):
        failed += k2_k4(dev, args.previous and previous_kernels(
            args.previous))
    if args.only in (None, "K1K3"):
        failed += k1_k3(dev)
    if args.only in (None, "K7"):
        failed += k7(dev, args.previous)
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
