#!/usr/bin/env python3
"""Times design variants of kernel 14's query (`grid_query`,
`lv_slam_tpu_torch/csrc/centroid_grid.cu`) and kernel 9b's two-table crop
(`crop_tables`, `csrc/cell_table.cu`) side by side on one NVIDIA GPU.

    python scripts/k14_variants.py [--out FILE]

Each variant is the shipped source with one constant changed, built with
`kernels/_build.py`'s nvcc flags into `_cache/k14_variants/<name>/` and
swapped into the shipped wrapper (its C entries keep their signatures):
the query with a shared-memory sample of 256, 1024 (shipped) and 4096 sorted
keys a block, and with `__launch_bounds__(256, 4)` (64 registers); the crop
with one, four and eight (shipped) slots a thread. Every variant's output
must be bit-identical to the shipped kernel's. The query runs `fitness_batch`
at chip_smoke.py phase 2's shape (the 16-scan keyframe cloud's 0.25 m grid,
8 candidates x 131072 lanes at their guesses); the crop runs both LFA tables
at the flagship's sizes (2^14 x 6 and 2^15 x 6 slots, seeded: 30% valid,
points within +-60 m) with the gate open (a fresh copy of the tables a call)
and closed. Times are device-only medians as chip_smoke.py takes them
(`device_ms`), beside ptxas's registers and spills. Prints one line per
variant and writes them as JSON to FILE (default
`chiprun_out/k14_variants.json`) beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

SAMPLES = "constexpr int kSamples = 1024;"
BOUNDS = "__global__ void __launch_bounds__(lvs::kThreads)\ngrid_query("
UNROLL = "constexpr int kCropUnroll = 8;"
QUERY_VARIANTS = {
    "sample 1024 (shipped)": [],
    "sample 256": [(SAMPLES, "constexpr int kSamples = 256;")],
    "sample 4096": [(SAMPLES, "constexpr int kSamples = 4096;")],
    "64 registers": [(BOUNDS, "__global__ void __launch_bounds__(lvs::kThreads, 4)\ngrid_query(")],
}
CROP_VARIANTS = {
    "eight slots a thread (shipped)": [],
    "four slots a thread": [(UNROLL, "constexpr int kCropUnroll = 4;")],
    "one slot a thread": [(UNROLL, "constexpr int kCropUnroll = 1;")],
}


def build(name: str, source: str, subs) -> tuple:
    """(library, ptxas log) of the shipped `source` with `subs` applied."""
    from lv_slam_tpu_torch.kernels._build import CSRC, NVCC_FLAGS, _nvcc_path

    d = ROOT / "_cache" / "k14_variants" / name.split(" (")[0].replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    text = (CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {source}")
        text = text.replace(old, new)
    (d / source).write_text(text)
    out = d / "lib.so"
    done = subprocess.run([_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(d), "-o", str(out), str(d / source)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out)), done.stdout + done.stderr


def swapped(kernel, lib):
    """The kernel's C entries taken from `lib`; returns the shipped ones."""
    fns = {}
    for entry, argtypes in kernel._argtypes.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
        fns[entry] = fn
    saved, kernel._fns = kernel._fns, fns
    return saved


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "k14_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k14_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    import k14_parent
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import knn, nn, prefilter
    from lv_slam_tpu_torch.pipeline import window

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    pf = kitti_flagship_config().prefilter
    scans, gt = k14_parent.load_inputs(torch, cs, dev)
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)

    def filtered(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        band = prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)
        return prefilter.voxel_downsample(band, pf.downsample_resolution, pf.out_cap)

    rows_f = [filtered(i) for i in range(k14_parent.N_WINDOW + 2)]
    win = rows_f[:k14_parent.N_WINDOW]
    keyframe = window.window_group_filtered(
        torch.stack([c.xyz.T for c in win]).contiguous(), torch.stack([c.intensity for c in win]),
        torch.stack([c.mask for c in win]), 0, torch.from_numpy(rel[:len(win)].copy()).to(dev),
        torch.ones(len(win), dtype=torch.bool, device=dev), pf.downsample_resolution, 131072)
    grid = nn.build_centroid_grid(keyframe, 0.25)
    cands = rows_f[2:18:2]
    guesses = torch.from_numpy(rel[2:18:2].copy()).to(dev)
    guesses[:, 0, 3] += 0.2
    batch = PointCloud(torch.stack([c.xyz for c in cands]), torch.stack([c.intensity for c in cands]),
                       torch.stack([c.mask for c in cands]))
    want = nn.fitness_batch(grid, batch, guesses)
    print(f"fitness_batch: {int(batch.mask.sum())} of {batch.mask.numel()} lanes masked in, "
          f"{int((grid.counts > 0).sum())} leaves", flush=True)
    rows, failed = [], []
    for name, subs in QUERY_VARIANTS.items():
        lib, log = build(name, "centroid_grid.cu", subs)
        saved = swapped(nn.QUERY_KERNEL, lib)
        try:
            same = torch.equal(nn.fitness_batch(grid, batch, guesses).view(torch.int32), want.view(torch.int32))
            ms = cs.device_ms(torch, lambda: nn.fitness_batch(grid, batch, guesses),
                              cs.DEVICE_FUNCTIONS["nn_sq_dists"])[0]
        finally:
            nn.QUERY_KERNEL._fns = saved
        usage = list(cs.ptxas_usage(log, ("grid_query",)).values())
        rows.append(dict(kernel="grid_query", variant=name, ms=ms, bit_identical=same, ptxas=usage))
        failed += [] if same else [name]
        print(f"grid_query, {name}: {ms:.4f} ms, {'bit-identical' if same else 'DIFFERS'}, ptxas {usage}", flush=True)

    rng = np.random.default_rng(cs.SEED)
    tables = []
    for buckets in (1 << 14, 1 << 15):
        slots = rng.uniform(-60.0, 60.0, (buckets * 6, 4)).astype(np.float32)
        slots[:, 3] = (rng.random(buckets * 6) < 0.3).astype(np.float32)
        tables.append(knn.CellTable(torch.from_numpy(slots.reshape(buckets, 24)).to(dev), 2.0))
    center = torch.tensor([3.0, -2.0, 0.5], device=dev)
    gates = {"open": center + 1e6, "closed": center + 15.0}
    reference = [knn.CellTable(t.table.clone(), t.cell_size) for t in tables]
    knn.crop_cell_tables_(*reference, center, 60.0, gates["open"], 30.0)
    for name, subs in CROP_VARIANTS.items():
        lib, log = build(name, "cell_table.cu", subs)
        saved = swapped(knn.CROP_KERNEL, lib)
        try:
            got = [knn.CellTable(t.table.clone(), t.cell_size) for t in tables]
            knn.crop_cell_tables_(*got, center, 60.0, gates["open"], 30.0)
            same = all(torch.equal(a.table.view(torch.int32), b.table.view(torch.int32))
                       for a, b in zip(got, reference))
            ms = {}
            for gate, last in gates.items():
                call = cs.on_copies(tuple(tables), lambda a, b, last=last: knn.crop_cell_tables_(
                    a, b, center, 60.0, last, 30.0))
                ms[gate] = cs.device_ms(torch, call, cs.DEVICE_FUNCTIONS["crop_cell_table"])[0]
        finally:
            knn.CROP_KERNEL._fns = saved
        rows.append(dict(kernel="crop_tables", variant=name, ms_open=ms["open"], ms_closed=ms["closed"],
                         bit_identical=same))
        failed += [] if same else [name]
        print(f"crop_tables, {name}: gate open {ms['open']:.4f} ms, closed {ms['closed']:.4f} ms, "
              f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    if failed:
        print(f"k14_variants: not bit-identical: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
