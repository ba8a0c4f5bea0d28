"""Build-at-first-use of the package's native libraries.

Two shared libraries with plain C interfaces, loaded with ctypes:

* the CUDA kernels (csrc/*.cu), compiled by nvcc for sm_90a,
* the host runtime (csrc/host/*.cpp), compiled by g++.

Each is built into cube_slam_tpu_torch/_build/ (ignored by git) under a name
that carries a hash of its sources and flags, so an edited source rebuilds
and an unchanged one is reused, with the compiler's output beside it
(lib*.log: ptxas's register and spill report for the CUDA kernels). A
build that fails raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# -Xptxas -v: ptxas reports each kernel's registers, shared memory and spills
CUDA_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_loaded: dict = {}
# seconds each library took to build in this process (0.0 when reused)
build_seconds: dict = {}
# the compiler's output of each library, kept beside it as lib*.log
build_logs: dict = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build(name, compiler, flags, sources):
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    log = so[:-3] + ".log"
    if os.path.exists(so):
        if not os.path.exists(log):  # built before the logs were kept
            return so, 0.0, ""
        with open(log) as f:
            return so, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    # build under a temporary name and rename: concurrent builders (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building lib{name} failed:\n{proc.stdout}\n{proc.stderr}")
        with open(log, "w") as f:  # before the library appears, so a reuse finds it
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, time.perf_counter() - t0, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library `name`: "cuda_kernels" or "host"."""
    with _lock:
        if name not in _loaded:
            if name == "cuda_kernels":
                srcs = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))
                so, secs, log = _build(name, nvcc_path(), CUDA_FLAGS, srcs)
            elif name == "host":
                hdir = os.path.join(CSRC, "host")
                srcs = sorted(os.path.join(hdir, f) for f in os.listdir(hdir) if f.endswith(".cpp"))
                so, secs, log = _build(name, shutil.which("g++") or "g++", HOST_FLAGS, srcs)
            else:
                raise ValueError(f"unknown library {name!r}")
            _loaded[name] = ctypes.CDLL(so)
            build_seconds[name] = secs
            build_logs[name] = log
        return _loaded[name]
