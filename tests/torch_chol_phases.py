#!/usr/bin/env python3
"""Where the time of K5 and K6 goes, phase by phase, on an NVIDIA GPU.

Not collected by pytest. Run from the repository root on a machine with a
CUDA card and ``nvcc``:

    python3 tests/torch_chol_phases.py

It copies ``csrc/batched_chol_kernel.cu`` and ``csrc/batched_trsm_kernel.cu``
into ``build/chol_phases/``, adds a ``clock64()`` stamp after every block
barrier (read by thread 0 of block 0), builds the copies into their own
libraries and, at the final fit's shapes, prints the SM cycles of block 0
from the previous barrier to each barrier, summed over the loop. Each
phase is named by the marker on its barrier in the source
(``__syncthreads();  // phase: K5 (a) diagonal tile``); a barrier without
one stops the script, so an added or moved barrier cannot shift the names.

The shipped kernels are not changed; a stamp costs a few cycles.
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
from gaussian_process_edge_trace_torch.ops import cuda_chol as cc  # noqa: E402

OUT = ROOT / "build" / "chol_phases"
STAMP = ('__device__ unsigned long long g_phase[64];\n'
         '#define PHASE_STAMP(k) do { if (threadIdx.x == 0 && '
         'blockIdx.x == 0) { long long now = clock64(); '
         'g_phase[k] += now - phase_last; phase_last = now; } } while (0)\n')
READ = ('\nextern "C" int phase_read(unsigned long long* out) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_phase,\n'
        '                                   sizeof(g_phase));\n}\n'
        'extern "C" int phase_reset() {\n'
        '  unsigned long long z[64] = {0};\n'
        '  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n}\n')


def instrumented(name):
    """Build an instrumented copy of csrc/<name>.cu and load it; returns the
    library and the phase names by stamp index."""
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    src = src.replace('#include "chol_common.cuh"',
                      '#include "chol_common.cuh"\n' + STAMP)
    src = src.replace("extern __shared__ float sm[];",
                      "extern __shared__ float sm[];\n"
                      "  long long phase_last = clock64();")
    barriers = src.count("__syncthreads()")
    names = []

    def stamp(match):
        names.append(match.group(1).strip())
        return f"__syncthreads(); PHASE_STAMP({len(names) - 1});"
    src = re.sub(r"__syncthreads\(\);[ \t]*// phase: ([^\n]+)", stamp, src)
    if len(names) != barriers:
        raise SystemExit(f"{name}.cu: {barriers - len(names)} of its "
                         f"{barriers} barriers carry no phase marker")
    src += READ
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    return cuda_build.compile_library(cu, OUT / f"lib{name}.so"), names


def phases(built, launch):
    """"name cycles, ..." of block 0 over one launch, after a warm launch:
    the phases whose barrier that launch reached."""
    lib, names = built
    launch()
    torch.cuda.synchronize()
    lib.phase_reset()
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    lib.phase_read(buf)
    return ", ".join(f"{name} {int(buf[k])}" for k, name in enumerate(names)
                     if buf[k])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_chol_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {clock.strip()}")

    def spd(B, n):
        A = rng.normal(size=(B, n, n))
        return torch.tensor(A @ np.transpose(A, (0, 2, 1)) / n + np.eye(n),
                            dtype=torch.float32, device=dev)

    P, I = ctypes.c_void_p, ctypes.c_int
    chol = instrumented("batched_chol_kernel")
    trsm = instrumented("batched_trsm_kernel")
    chol[0].gpet_batched_cholesky.argtypes = [P, P, I, I, P]
    trsm[0].gpet_batched_trsm.argtypes = [P, P, P, I, I, I, I, P]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for B, n in ((109, 104), (14, 208)):
        K = spd(B, n)
        L = torch.empty_like(K)
        c = phases(chol, lambda: chol[0].gpet_batched_cholesky(
            K.data_ptr(), L.data_ptr(), B, n, stream()))
        print(f"[K5] B={B} n={n}: {c} cycles")
    for B, n, m, transpose in ((56, 104, 1, 0), (56, 104, 1, 1),
                               (56, 104, 104, 0), (14, 208, 1, 0),
                               (14, 208, 1, 1), (14, 208, 208, 0)):
        Lw = cc.cholesky_plain(spd(B, n))
        R = torch.randn(B, n, m, device=dev)
        Z = torch.empty_like(R)
        c = phases(trsm, lambda: trsm[0].gpet_batched_trsm(
            Lw.data_ptr(), R.data_ptr(), Z.data_ptr(), B, n, m, transpose,
            stream()))
        kind = "backward" if transpose else "forward"
        print(f"[K6] {kind} B={B} n={n} m={m}: {c} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
