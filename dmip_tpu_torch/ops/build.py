"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds.  Libraries go to ``dmip_tpu_torch/_kernels_build/``
(listed in ``.gitignore``), named by a hash of the source, and are built at
first use, never at import.  :func:`build_all` starts one nvcc per source at
once, for callers that want every kernel ready up front.  ``defines``
(``NAME=VALUE`` strings, passed as ``-D``) build a variant of a source, kept
beside the plain one under its own hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels_build")
KERNELS = ("em_kernel", "mh_kernel", "dsm_train_kernel", "dps_kernel")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")
    return path


def _lib_path(name: str, defines: Sequence[str] = ()) -> str:
    """Library path keyed by the source, every shared header and the
    defines."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    for d in defines:
        h.update(f"-D{d}".encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str, defines: Sequence[str] = ()):
    """Start nvcc for one source; returns (Popen, tmp path, final path), or
    None when the library is already built."""
    out = _lib_path(name, defines)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNELS, defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every named kernel in parallel; returns nvcc's report (its
    ``-Xptxas -v`` register/shared-memory lines) per kernel.  Raises with
    the compiler's output if any build fails."""
    jobs = {n: _start(n, defines) for n in names}
    reports = {}
    failed = []
    for name, job in jobs.items():
        if job is None:
            reports[name] = "(cached)"
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    building it if needed."""
    key = (name, tuple(defines))
    if key not in _loaded:
        build_all([name], defines)
        _loaded[key] = ctypes.CDLL(_lib_path(name, defines))
    return _loaded[key]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError_t {err} ({msg})")
