#!/usr/bin/env python3
"""Times design variants of kernels 9g (the sorted k-NN grid's build) and 9c
(the host mapping's cell-table build) on one NVIDIA GPU, each held bit for
bit to its plain twin.

    python scripts/k9_variants.py [--out FILE]

- K9g's one-launch cluster route (up to 8192 lanes) with each word's place
  found by binary searches over distributed shared memory (as kernel 9a
  places its rows) or over a copy of every block's sorted words in the
  block's own shared memory (the shipped design): `scripts/k9_variants.cu`,
  built with `kernels/_build.py`'s nvcc flags into `_cache/k9_variants/`;
  device-only times (`chip_smoke.device_ms`) at standalone LFA's 4096 and
  8064 lanes and the median of five runs' %globaltimer stamps per phase
  (block 0, thread 0, after a barrier: the block minima across the cluster,
  the origin and the words, the warps' sorts, the block's merge, the
  places, the cluster barrier, the outputs).
- The shipped sources built from copies with the key sort's look-back window
  (`csrc/key_sort.cuh` kWindow) at 8 (shipped), 16 and 32 words a round
  trip: K9g's key sort route at 22000 and 131072 lanes, K9c at 2^14, 2^15 and
  2^18 buckets, with their `key_sort_pass` time.
- K9c with its keys pass's grid capped at 66, 132 (shipped) and 264 blocks.

Prints one line per variant and writes them as JSON to FILE (default
`chiprun_out/k9_variants.json`), beside the card's name and power limit
(~3 minutes of command).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from _parent import build  # noqa: E402  (scripts/_parent.py)

CACHE = ROOT / "_cache" / "k9_variants"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PHASES = ("block minima", "origin and words", "warp sorts", "block merge", "places", "cluster barrier", "outputs")


def copy_built(name: str, sources, edits: dict) -> dict:
    """{source: CDLL} of the shipped `sources` built from a copy of csrc with
    `edits` ({file: (pattern, replacement)}) made."""
    csrc = CACHE / name / "lv_slam_tpu_torch" / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(ROOT / "lv_slam_tpu_torch" / "csrc", csrc)
    for file, (pattern, repl) in edits.items():
        text = (csrc / file).read_text()
        new = re.sub(pattern, repl, text)
        if new == text and not re.search(pattern, text):
            raise RuntimeError(f"{file}: no {pattern!r} to edit")
        (csrc / file).write_text(new)
    return build(csrc, sources, CACHE / f"{name}_build")


def use(kernel, lib) -> None:
    """The shipped wrapper of `kernel` over `lib`'s entries (the same C signatures)."""
    fns = {}
    for entry, argtypes in kernel._argtypes.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = [*argtypes, P], ctypes.c_int
        fns[entry] = fn
    kernel._fns = fns


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "k9_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k9_variants: no CUDA device")
    import chip_smoke as cs
    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path, ptr
    from lv_slam_tpu_torch.ops import knn
    from lv_slam_tpu_torch.ops.cells import inv_resolution

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    rows, failed = [], []

    def cloud(n, masked=0.3):
        x = torch.from_numpy(rng.uniform(-60.0, 60.0, (n, 3)).astype(np.float32)).to(dev)
        return x, torch.from_numpy(rng.random(n) >= masked).to(dev)

    # K9g's cluster route: searches over distributed shared memory or over a copy
    CACHE.mkdir(parents=True, exist_ok=True)
    lib_path = CACHE / "libk9_variants.so"
    subprocess.run([_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(ROOT / "lv_slam_tpu_torch" / "csrc"), "-o",
                    str(lib_path), str(ROOT / "scripts" / "k9_variants.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.k9_variant_grid.argtypes = [I, P, P, I, F, P, P, P, P, P]
    lib.k9_variant_grid.restype = ctypes.c_int
    for n in (4096, 8064):
        x, m = cloud(n)
        want = knn.build_grid_ref(x, m, 2.0)
        for staged in (0, 1):
            keys = torch.empty((n,), dtype=torch.int32, device=dev)
            out = torch.empty((n, 3), dtype=torch.float32, device=dev)
            origin = torch.empty((3,), dtype=torch.int32, device=dev)
            stamps = torch.zeros((8,), dtype=torch.int64, device=dev)

            def run(staged=staged, x=x, m=m, n=n, keys=keys, out=out, origin=origin, stamps=stamps):
                err = lib.k9_variant_grid(staged, ptr(x), ptr(m), n, inv_resolution(2.0), ptr(keys), ptr(out),
                                          ptr(origin), ptr(stamps), P(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"k9_variant_grid failed with CUDA error {err}")

            run()
            torch.cuda.synchronize()
            same = torch.equal(keys, want.keys) and torch.equal(out.view(torch.int32), want.xyz.view(torch.int32)) \
                and torch.equal(origin, want.origin_cell)
            ms = cs.device_ms(torch, run, ("variant_cluster",))[0]
            phases = []
            for _ in range(5):
                run()
                torch.cuda.synchronize()
                phases.append(np.diff(stamps.cpu().numpy()))
            split = dict(zip(PHASES, np.median(np.array(phases), axis=0).astype(int).tolist()))
            what = "a copy in shared memory (shipped)" if staged else "distributed shared memory"
            row = dict(variant=f"K9g cluster route, {n} lanes, searches over {what}", ms=ms, phase_ns=split,
                       bit_identical=same)
            rows.append(row)
            failed += [] if same else [row["variant"]]
            print(f"{row['variant']}: {ms:.4f} ms{'' if same else ' DIFFERS from the twin'}; ns per phase {split}",
                  flush=True)

    # the key sort's look-back window, and K9c's keys pass's grid
    grid_fns, table_fns = cs.DEVICE_FUNCTIONS["build_grid"], cs.DEVICE_FUNCTIONS["build_cell_table"]
    variants = {f"look-back window {w}": copy_built(f"window{w}", ("knn_grid.cu", "cell_table.cu"), {
        "key_sort.cuh": (r"constexpr int kWindow = \d+;", f"constexpr int kWindow = {w};")}) for w in (8, 16, 32)}
    variants.update({f"K9c keys pass on {b} blocks": copy_built(f"count{b}", ("knn_grid.cu", "cell_table.cu"), {
        "cell_table.cu": (r"constexpr int kCountBlocks = \d+;", f"constexpr int kCountBlocks = {b};")})
        for b in (66, 264)})
    cases = []
    for n in (22000, 131072):
        x, m = cloud(n)
        cases.append((f"K9g {n} lanes", lambda x=x, m=m: knn.build_grid(x, m, 2.0), grid_fns,
                      knn.build_grid_ref(x, m, 2.0)[:3]))
    for n, nb in ((32768, 1 << 14), (65536, 1 << 15), (131072, 1 << 18)):
        x, m = cloud(n)
        cases.append((f"K9c {n} rows -> {nb} x 6", lambda x=x, m=m, nb=nb: (knn.build_cell_table(x, m, 2.0, nb, 6).table,),
                      table_fns, (knn.build_cell_table_ref(x, m, 2.0, nb, 6).table,)))
    for name, libs in variants.items():
        if "K9c keys pass" in name:
            cases_here = [c for c in cases if c[0].startswith("K9c")]
        else:
            cases_here = cases
        use(knn.GRID_KERNEL, libs["knn_grid.cu"])
        use(knn.BUILD_TABLE_KERNEL, libs["cell_table.cu"])
        for what, fn, fns, want in cases_here:
            got = fn()
            same = all(torch.equal(a, b) for a, b in zip(got[:3] if hasattr(got, "keys") else got, want))
            ms = cs.device_ms(torch, fn, fns)[0]
            passes = cs.device_ms(torch, fn, ("key_sort_pass",))[0]
            row = dict(variant=f"{name}: {what}", ms=ms, passes_ms=passes, bit_identical=same)
            rows.append(row)
            failed += [] if same else [row["variant"]]
            print(f"{row['variant']}: {ms:.4f} ms (key_sort_pass {passes:.4f}){'' if same else ' DIFFERS'}", flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    if failed:
        print(f"k9_variants: not bit-identical: {failed}", flush=True)
        return 1
    print(f"k9_variants: all {len(rows)} variants bit-identical to the twins", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
