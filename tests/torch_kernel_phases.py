#!/usr/bin/env python3
"""Where the time of K1, K3 and K4 goes, phase by phase, on an NVIDIA GPU.

Not collected by pytest. Run from the repository root on a machine with a
CUDA card and ``nvcc``:

    python3 tests/torch_kernel_phases.py

It copies ``csrc/fused_cost_kernel.cu``, ``csrc/binning_2l_kernel.cu`` and
``csrc/binning_dense_kernel.cu`` into ``build/kernel_phases/``, adds a
``clock64()`` stamp after every line that carries a phase marker
(``// phase: <name>``), builds the copies into their own libraries and, at
the main path's shapes, prints the SM cycles from the previous stamp to
each marker, read by thread 0 of every block, summed over the loops and
averaged over the blocks (kept in registers and added to the global sums
once per block, as the kernel returns). A stamp marks where thread 0
issues that point; a load is paid where its value is first used, so a
phase that only issues loads looks short and the phase that reads them
carries their latency. The same method as ``torch_chol_phases.py``,
which stamps K5's and K6's block barriers in block 0.

The shipped kernels are not changed; a stamp costs a few cycles, and the
counters add a few registers to every thread.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gaussian_process_edge_trace_torch.ops import cuda_build  # noqa: E402
from gaussian_process_edge_trace_torch.ops import (  # noqa: E402
    cuda_interp as ci)
from gaussian_process_edge_trace_torch.trace import cuda_kde as ck  # noqa: E402
from torch_chol_phases import READ  # noqa: E402

OUT = ROOT / "build" / "kernel_phases"
# Thread 0 of every block adds the cycles since the previous stamp to its
# phase's counter in registers, and adds the counters to the global sums
# once, when the kernel returns (the clock's destructor): no atomic on the
# clock's path.
STAMP = ('__device__ unsigned long long g_phase[64];\n'
         'struct PhaseClock {\n'
         '  unsigned c[8];\n'
         '  long long last;\n'
         '  __device__ PhaseClock() {\n'
         '#ifdef __CUDA_ARCH__\n'
         '    last = clock64();\n'
         '    for (int k = 0; k < 8; ++k) c[k] = 0;\n'
         '#endif\n'
         '  }\n'
         '  __device__ ~PhaseClock() {\n'
         '#ifdef __CUDA_ARCH__\n'
         '    if (threadIdx.x == 0)\n'
         '      for (int k = 0; k < 8; ++k)\n'
         '        if (c[k]) atomicAdd(&g_phase[k], (unsigned long long)c[k]);\n'
         '#endif\n'
         '  }\n'
         '};\n'
         '#define PHASE_STAMP(k) do { if (threadIdx.x == 0) { '
         'long long now = clock64(); '
         'phase_clock.c[k] += (unsigned)(now - phase_clock.last); '
         'phase_clock.last = now; } } while (0)\n')
MARKER = re.compile(r"^(.*?)[ \t]*// phase: ([^\n]+)$", re.M)


def instrumented(name):
    """Build an instrumented copy of csrc/<name>.cu and load it; returns the
    library and the phase names by stamp index."""
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>",
                      "#include <cuda_runtime.h>\n" + STAMP)
    src, n = re.subn(
        r"(extern __shared__ (?:__align__\(16\) )?float \w+\[\];)",
        r"\1\n  PhaseClock phase_clock;", src)
    if n != 1:
        raise SystemExit(f"{name}.cu: expected one kernel with dynamic "
                         f"shared memory, found {n}")
    names = []

    def stamp(match):
        names.append(match.group(2).strip())
        return f"{match.group(1)} PHASE_STAMP({len(names) - 1});"
    src = MARKER.sub(stamp, src) + READ
    if not 0 < len(names) <= 8:
        raise SystemExit(f"{name}.cu: {len(names)} phase markers, 1-8 "
                         f"expected")
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    return cuda_build.compile_library(cu, OUT / f"lib{name}.so"), names


def phases(built, launch, blocks):
    """"name cycles, ..." per block over one launch, after a warm launch."""
    lib, names = built
    launch()
    torch.cuda.synchronize()
    lib.phase_reset()
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    lib.phase_read(buf)
    return ", ".join(f"{name} {buf[k] / blocks:.0f}"
                     for k, name in enumerate(names) if buf[k])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {clock.strip()}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k1 = instrumented("fused_cost_kernel")
    k3 = instrumented("binning_2l_kernel")
    k4 = instrumented("binning_dense_kernel")
    k1[0].gpet_fused_cost.argtypes = [P] * 6 + [I, I, I, F] + [I] * 6 + [P]
    k3[0].gpet_binning_2l.argtypes = [P] * 3 + [I] * 7 + [P]
    k4[0].gpet_binning_dense.argtypes = [P] * 3 + [I] * 6 + [P]

    for E, M, S, transpose in ((1000, 1000, 10000, True),
                               (1000, 1000, 10000, False),
                               (500, 500, 1000, False)):
        cols = torch.rand(E, M, **f32)
        ys = torch.tensor(M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), 0),
                          **f32)
        plan = ci.k1_launch_plan(E, M, S, transpose)
        partial = torch.empty(plan["n_chunks"], 2, S, **f32)
        line, arc = torch.empty(S, **f32), torch.empty(S, **f32)
        st = torch.empty(S, E, **f32) if transpose else None
        c = phases(k1, lambda: k1[0].gpet_fused_cost(
            cols.data_ptr(), ys.data_ptr(), partial.data_ptr(),
            line.data_ptr(), arc.data_ptr(),
            st.data_ptr() if transpose else None, E, M, S, 1e-3,
            plan["pairs_per_chunk"], plan["n_chunks"],
            plan["samples_per_block"], plan["threads"], 1, 0, stream()),
            plan["blocks"])
        print(f"[K1] E={E} M={M} S={S} {'+copy' if transpose else ''} "
              f"({plan['blocks']} blocks of {plan['pairs_per_chunk']} "
              f"pairs): {c} cycles per block")
    for E, S, M in ((1000, 1000, 1000), (500, 100, 500)):
        y = torch.tensor(M / 2 + np.cumsum(rng.normal(0, 1.5, (E, S)), 0),
                         **f32)
        w = torch.full((S,), 1.0 / S, **f32)
        H = torch.empty(M + 2, E, **f32)
        plan = ck.k3_launch_plan(E, S, M)
        c = phases(k3, lambda: k3[0].gpet_binning_2l(
            y.data_ptr(), w.data_ptr(), H.data_ptr(), E, S, M, plan["cols"],
            plan["warps_per_col"], plan["batches_per_warp"], 1, stream()),
            plan["blocks"])
        print(f"[K3] E={E} S={S} M={M} ({plan['blocks']} blocks, "
              f"{plan['warps_per_col']} warps per column): {c} cycles per "
              f"block")
    import chip_smoke as cs
    for kind in ("walk", "one row", "outside"):
        E = S = M = 1000
        yn, wn = cs.kept_curves(rng, E, S, M, kind)
        y, w = torch.tensor(yn, **f32), torch.tensor(wn, **f32)
        H = torch.empty(M + 2, E, **f32)
        plan = ck.k4_launch_plan(E, S, M)
        c = phases(k4, lambda: k4[0].gpet_binning_dense(
            y.data_ptr(), w.data_ptr(), H.data_ptr(), E, S, M, plan["tile"],
            plan["cols"], 1, stream()), plan["blocks"])
        print(f"[K4] E=S=M=1000 {kind} ({plan['blocks']} blocks of "
              f"{plan['cols']} columns): {c} cycles per block")
    return 0


if __name__ == "__main__":
    sys.exit(main())
