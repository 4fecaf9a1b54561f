"""What the proof scripts that hold a kernel bit for bit against an earlier
tree's kernels share: the earlier sources from git, their libraries built
with `kernels/_build.py`'s nvcc flags, and bit-level comparisons of
outputs. A script in this folder imports it as `_parent` (the folder is on
`sys.path` when the script runs)."""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def fetch_parent(parent: Path, commit: str, sources) -> Path:
    """`parent`'s lv_slam_tpu_torch/csrc, its `sources` written from
    `git show commit:...` where any is missing."""
    csrc = parent / "lv_slam_tpu_torch" / "csrc"
    if all((csrc / name).is_file() for name in sources):
        return csrc
    csrc.mkdir(parents=True, exist_ok=True)
    for name in sources:
        text = subprocess.run(["git", "-C", str(ROOT), "show", f"{commit}:lv_slam_tpu_torch/csrc/{name}"],
                              capture_output=True, text=True, check=True).stdout
        (csrc / name).write_text(text)
    return csrc


def build(csrc: Path, libraries, out_dir: Path) -> dict:
    """{source: CDLL} of `csrc`'s `libraries`, one nvcc process each, all
    started together."""
    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    outs = {src: out_dir / f"lib{Path(src).stem}_parent.so" for src in libraries}
    procs = {src: subprocess.Popen([_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(out),
                                    str(csrc / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, out in outs.items()}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return {src: ctypes.CDLL(str(out)) for src, out in outs.items()}


def bits(torch, t):
    """A float32 tensor as its int32 bits; any other as it is."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def flatten(torch, out) -> list:
    """The tensors of a (nested) tuple of outputs, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flatten(torch, o)]


def differ(torch, got, want) -> list:
    """Indices of the tensors of two outputs that are not bit-identical."""
    return [i for i, (a, b) in enumerate(zip(flatten(torch, got), flatten(torch, want)))
            if not (a.shape == b.shape and torch.equal(bits(torch, a), bits(torch, b)))]


def span_ms(torch, cs, fn, reps: int = 20) -> float:
    """The median over the whole calls among `reps` of a call's device span,
    from its first kernel's start to its last kernel's end (gaps between
    launches included), in a torch.profiler trace with a marker before each
    call (`chip_smoke.whole_calls`)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(cs.WARM):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):  # a trace with whole calls for at most half of `reps` is taken again
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        calls = [call for call in cs.whole_calls([e.name for e in events]) if call]
        if 2 * len(calls) > reps:
            return float(np.median([events[c[-1]].time_range.end - events[c[0]].time_range.start
                                    for c in calls])) / 1e3
    raise AssertionError(f"five traces held whole device work for at most {reps // 2} of {reps} calls")
