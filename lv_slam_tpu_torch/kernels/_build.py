"""Builds the hand-written CUDA kernels at first use and binds them with ctypes.

Each `csrc/*.cu` file compiles in its own `nvcc` process, all started
together, and one more `nvcc` links the objects into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<src>.o csrc/<src>.cu   (per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/liblvs_<hash>.so _build/*.o

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
import functools
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def _run(cmds: List[List[str]]) -> str:
    """Runs the commands in parallel; returns their logs, raises if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out[-8000:]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def _nvcc(sources: List[Path], out: Path) -> float:
    """Compile `sources` into `out`; returns the build's wall seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    nvcc = _nvcc_path()
    t0 = time.perf_counter()
    log = ""
    try:
        log = _run([
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)
        ])
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log += _run([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        (BUILD_DIR / "build.log").write_text(log)
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return time.perf_counter() - t0


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


MAX_SORT_LANES = (1 << 27) - 1  # csrc/key_sort.cuh: its tile status words count below 2^27


@functools.lru_cache(maxsize=256)
def scratch_bytes(entry: str, *shape: int) -> int:
    """Bytes of scratch that a kernel's C side lays out for `shape` (its
    lanes, or its batch and sizes), from its `lvs_*_scratch_bytes(...)` entry."""
    fn = getattr(LIBRARY.load(), entry)
    fn.argtypes, fn.restype = [ctypes.c_int] * len(shape), ctypes.c_longlong
    return int(fn(*shape))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, *tensors: torch.Tensor, lane_strided: bool = False) -> None:
    """The tensors a kernel reads or writes are contiguous CUDA tensors on one
    device; with `lane_strided`, rows (dimension 0) may lie any positive
    stride apart, each row contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on {dev}, got one on {t.device}")
        rows_ok = lane_strided and t.dim() > 0 and t.stride(0) > 0 and t[:1].is_contiguous()
        if not (t.is_contiguous() or rows_ok):
            raise ValueError(f"{name}: expected contiguous tensors, got strides {t.stride()}")


def check_dtype(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
