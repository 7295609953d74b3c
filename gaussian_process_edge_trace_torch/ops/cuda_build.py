"""Build and load the port's hand-written CUDA kernels.

The sources under ``gaussian_process_edge_trace_torch/csrc/`` have a plain C
interface. At first use they are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, then
linked into one shared library that is loaded with :mod:`ctypes`. The library
lands in ``build/gpet_torch_kernels/`` beside the package, or in the
directory that ``$GPET_TORCH_BUILD_DIR`` names (read at first use; the CLI's
``--compilation-cache DIR`` sets it), and is named by a digest of the
sources and flags, so an edited source builds anew and an unchanged one
loads the library already built.

Nothing here runs at import: the CPU tests import every module, and a
machine without a GPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "gpet_torch_kernels"
BUILD_DIR_ENV = "GPET_TORCH_BUILD_DIR"

# The card the kernels are planned for (H100 SXM): streaming multiprocessors,
# the shared memory one block can use, and that of one SM, of which every
# resident block also reserves 1 KB.
SMS = 132
SMEM_LIMIT = 232_448
SMEM_PER_SM = 233_472

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point; a launcher returns its cudaError_t as int.
_SIGNATURES = {
    "gpet_fused_cost": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I,
                        _I, _I, _I, _P],
    "gpet_column_interp": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                           _P],
    "gpet_binning_2l": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gpet_binning_dense": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gpet_batched_cholesky": [_P, _P, _I, _I, _P],
    "gpet_batched_trsm": [_P, _P, _P, _I, _I, _I, _I, _P],
    # Shared-memory bytes of one block (not kernels: ints, not cudaError_t).
    "gpet_batched_cholesky_smem": [_I],
    "gpet_batched_trsm_smem": [_I, _I],
    "gpet_fused_cost_smem": [_I, _I, _I, _I],
    "gpet_binning_2l_smem": [_I, _I, _I],
    "gpet_column_interp_smem": [_I, _I],
    "gpet_binning_dense_smem": [_I, _I, _I],
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build that produced the library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """The directory the kernels build into and load from:
    ``$GPET_TORCH_BUILD_DIR`` where it is set, else :data:`BUILD_DIR`."""
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env).expanduser().resolve() if env else BUILD_DIR


def build() -> Path:
    """Compile the sources into the shared library in :func:`build_dir`,
    unless it is built there. Returns the library's path. Compiler output
    goes to ``build.log``."""
    global build_seconds
    where = build_dir()
    cu, cuh = _sources()
    lib_path = where / f"libgpet_kernels_{_digest(cu + cuh)}.so"
    if lib_path.exists():
        return lib_path
    where.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [where / f"{src.stem}.{tag}.o" for src in cu]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o",
         str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for src, obj in zip(cu, objs)]
    logs = []
    failed = []
    for src, p in zip(cu, procs):
        output, _ = p.communicate()
        logs.append(f"== {src.name} (rc {p.returncode})\n{output}")
        if p.returncode != 0:
            failed.append(src.name)
    tmp = where / f"{lib_path.name}.{tag}.tmp"
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (where / "build.log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}; see "
                           f"{where / 'build.log'}:\n" + "\n".join(logs))
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def compile_library(cu: Path, so: Path):
    """Compile one ``.cu`` file with the kernels' flags into a shared
    library of its own and load it: for the measurement scripts under
    ``tests/`` that build instrumented or altered copies of a source."""
    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
                           "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {cu}:\n{done.stdout}"
                           f"{done.stderr}")
    return ctypes.CDLL(str(so))


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check_tensors(name: str, *tensors) -> None:
    """Raise unless every tensor is contiguous float32 on one CUDA device:
    the kernels take raw pointers and nothing else."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, not cuda")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 expected, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")
