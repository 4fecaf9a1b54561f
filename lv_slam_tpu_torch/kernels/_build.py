"""Builds the hand-written CUDA kernels at first use and binds them with ctypes.

All `csrc/*.cu` files compile in ONE `nvcc` call into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o _build/liblvs_<hash>.so csrc/*.cu

The library lands in `lv_slam_tpu_torch/_build/` (git-ignored), named by a
hash of the sources and flags, so an edit rebuilds and a rerun reuses it.
No `--use_fast_math`: parity needs IEEE `acosf`, `cosf`, `expf`, `floorf`
and division. `--fmad=false` rounds every product on its own, as the plain
PyTorch twins (one rounding per tensor op) round it, so the kernels' parity
checks compare like with like. `-Xptxas -v` writes each kernel's registers
and spills to `_build/build.log`.

Every C entry point takes PyTorch's current stream as its last argument and
returns `cudaGetLastError()`; `Kernel.call` raises on anything but 0. A
`Kernel` also carries the launch count that shows a run went through it:
its wrapper adds one where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

KERNELS: Dict[str, "Kernel"] = {}

# ctypes argument types of the C entry points: a device pointer, an int, a float
PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Library:
    """The built shared library, loaded once per process."""

    def __init__(self):
        self.handle: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None  # None: reused an existing build
        self.path: Optional[Path] = None

    def load(self) -> ctypes.CDLL:
        if self.handle is None:
            sources = sorted(CSRC.glob("*.cu"))
            digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
            for src in sorted(CSRC.glob("*.cu*")):
                digest.update(src.name.encode())
                digest.update(src.read_bytes())
            path = BUILD_DIR / f"liblvs_{digest.hexdigest()[:16]}.so"
            if not path.exists():
                self.build_seconds = _nvcc(sources, path)
            self.path = path
            self.handle = ctypes.CDLL(str(path))
            self.handle.lvs_error_string.argtypes = [ctypes.c_int]
            self.handle.lvs_error_string.restype = ctypes.c_char_p
        return self.handle


LIBRARY = _Library()


def _nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME to the directory holding bin/nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _nvcc(sources: List[Path], out: Path) -> float:
    """Compile `sources` into `out`; returns the build's wall seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return seconds


class Kernel:
    """One hand-written kernel: its C entry points, provenance and launch count."""

    def __init__(self, name: str, source: str, replaces: str, entries: Dict[str, list]):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._argtypes = entries
        self._fns: Optional[Dict[str, ctypes._CFuncPtr]] = None
        KERNELS[name] = self

    def call(self, entry: str, *args) -> None:
        """Launch C entry point `entry` on the current stream; raise on a CUDA error."""
        if self._fns is None:
            lib = LIBRARY.load()
            fns = {}
            for fn_name, argtypes in self._argtypes.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = [*argtypes, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[fn_name] = fn
            self._fns = fns
        err = self._fns[entry](*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = LIBRARY.handle.lvs_error_string(err).decode()
            raise RuntimeError(f"{self.name}: {entry} failed with CUDA error {err} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The tensors a kernel reads or writes are contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors, got strides {t.stride()}")


def check_dtype(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
