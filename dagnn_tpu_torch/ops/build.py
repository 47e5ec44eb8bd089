"""Build and load the package's CUDA kernels.

Counterpart of the JAX package's Pallas build glue: where Pallas compiled
each kernel inside the XLA program, here `nvcc` compiles
dagnn_tpu_torch/csrc/*.cu for sm_90a into a shared library with a plain C
interface at first use, and ctypes loads it. The library lands in the
package's build directory (dagnn_tpu_torch/_build/, not committed), named
by a hash of its source and the shared headers (csrc/*.cuh), so a changed
source is rebuilt and concurrent processes never load a half-written file.
build_all compiles several sources at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
build_log = {}      # source name -> (seconds, nvcc output) of the last build


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; returns its path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = out + f".{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, name + ".cu")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
            build_log[name] = (time.perf_counter() - t0,
                               proc.stdout + proc.stderr)
    return out


def build_all(names):
    """Compile several sources concurrently (one nvcc each); returns their
    library paths in order. A failed build raises."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def load(name: str, signatures) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; `signatures` maps each C
    entry to its argument kinds: "p" pointer (a Python int from
    Tensor.data_ptr(), 0 for null), "i" 32-bit int."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(build(name))
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        for fn, sig in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = [kinds[c] for c in sig]
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib
