"""Build and load the package's hand-written CUDA kernels and its C++ host
library.

Every kernel source under ``gpsat_tpu_torch/csrc/`` has a plain C interface
and is compiled on its own with ``nvcc`` for ``sm_90a`` into a shared
library in ``gpsat_tpu_torch/build/`` (listed in ``.gitignore``) at first
use, then loaded with ctypes. The library's name carries a hash of the
source, the shared headers and the flags, so an edited source is rebuilt and
an unchanged one is not. ``nvcc``'s resource report (``-Xptxas -v``) is kept
beside the library as ``<library>.log``.

The host library (``csrc/host/gpsat_native.cpp``: the grid-hash radius
index, the masks and weights, the blosc codec loops) takes the g++ arm
beside the nvcc one: ``g++ -O3 -march=native -std=c++17 -shared -fPIC
-pthread`` into the same directory, its name hashed from the source, the
flags, the compiler (its path and ``--version``) and the host CPU's feature
flags, since ``-march=native`` code runs only where the CPU has them.

A failed build raises; nothing here gives way to a kernel's plain version.
Builds write a temporary file and ``os.replace`` it into place, so processes
that build one library at once (test workers) never load a partial file.

The wrappers may run from several host threads at once (one per shard of a
mesh, ``parallel/engine.run_on_mesh``): each library is built and loaded
under a lock of its own, so two threads that reach a kernel's first call
together build it once, and ``count_launch`` adds to a launch counter under
a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v"]
HOST_CSRC = CSRC / "host"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.RLock] = {}
_locks_lock = threading.Lock()
_count_lock = threading.Lock()


def _lock_of(name: str) -> threading.RLock:
    """The lock that one library's build and load hold."""
    with _locks_lock:
        return _locks.setdefault(name, threading.RLock())


def count_launch(fn) -> None:
    """Add one to ``fn.launches`` atomically (``+= 1`` reads, adds and
    writes, and two threads can lose an increment between them)."""
    with _count_lock:
        fn.launches += 1


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return nvcc


def build_library(name: str) -> Path:
    """Compile csrc/<name>.cu (once per content of the source, the shared
    ``*.cuh`` headers and the flags) and return the library path. Builds
    of different sources run in parallel; of one source, one at a time."""
    with _lock_of(name):
        return _build_library(name)


def _build_library(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    lib_path = library_path(name)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    Path(str(lib_path) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    return lib_path


def _find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: it builds the host library (csrc/host/)")
    return os.path.realpath(gxx)


_gxx_ids: Dict[str, str] = {}


def _gxx_identity(gxx: str) -> str:
    """The compiler's path and ``--version`` line, once per process."""
    ident = _gxx_ids.get(gxx)
    if ident is None:
        out = subprocess.run([gxx, "--version"], capture_output=True, text=True, check=True).stdout
        ident = _gxx_ids[gxx] = f"{gxx}\n{out.splitlines()[0] if out else ''}"
    return ident


def _cpu_identity() -> str:
    """The host CPU's architecture and feature flags (Linux: the first
    ``flags`` line of /proc/cpuinfo), which ``-march=native`` builds for."""
    flags = ""
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    return f"{platform.machine()}\n{flags}"


def host_library_path(name: str) -> Path:
    """Where csrc/host/<name>.cpp's library lives once built."""
    gxx = _find_gxx()
    h = hashlib.sha256((HOST_CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_gxx_identity(gxx).encode())
    h.update(_cpu_identity().encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_host_library(name: str) -> Path:
    """Compile csrc/host/<name>.cpp with g++ (once per content of the
    source, the flags and the compiler) and return the library path."""
    with _lock_of("host:" + name):
        lib_path = host_library_path(name)
        if lib_path.exists():
            return lib_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        source = HOST_CSRC / f"{name}.cpp"
        cmd = [_find_gxx(), *GXX_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {source.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
        return lib_path


def load_host_library(name: str, symbols: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of csrc/host/<name>.cpp, built if need be.
    ``symbols`` maps each exported function to (argument types, return
    type)."""
    key = "host:" + name
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock_of(key):
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host_library(name)))
            for symbol, (argtypes, restype) in symbols.items():
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _libs[key] = lib
    return lib


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library lives once built (no build)."""
    source = CSRC / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_library(name: str, symbols: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built if need be. ``symbols``
    maps each exported function to its ctypes argument types; all return the
    ``cudaError_t`` of their launch as an int."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock_of(name):
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name)))
            for symbol, argtypes in symbols.items():
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check_kernel_input(name: str, K, shape_ok: bool, shape_text: str):
    """The refusals every kernel wrapper shares: shape, device, dtype,
    layout (contiguous and 16-byte aligned: the kernels move float4).
    Returns True when ``K`` lies on the CPU (the caller then runs the plain
    version), False for a CUDA tensor the kernel takes."""
    if not shape_ok:
        raise ValueError(f"{name} takes {shape_text}, got {tuple(K.shape)}")
    if K.device.type == "cpu":
        return True
    if K.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 only, got {K.dtype}")
    if not K.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    if K.data_ptr() % 16 != 0:
        raise ValueError("the CUDA kernel takes a 16-byte aligned tensor")
    if K.shape[0] > 2**31 - 1:
        raise ValueError(f"batch {K.shape[0]} exceeds the kernel's grid limit")
    return False


def launch(name: str, fn, K, *args) -> None:
    """Call a library entry on ``K``'s device and current stream; raise on a
    non-zero ``cudaError_t``."""
    with torch.cuda.device(K.device):
        err = fn(*args, torch.cuda.current_stream(K.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
