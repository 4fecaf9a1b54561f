#!/usr/bin/env python3
"""Times design variants of kernel 10 (the LFA line / plane fits over the
cell tables, `lv_slam_tpu_torch/csrc/lfa_fit.cu`) side by side on one NVIDIA
GPU, at chip_smoke.py phase 2's shape: scan 4's 4096 less-sharp / 8064
less-flat features of the reference benchmark's circle at its true pose
against the edge / surf maps of scans 0-3 (2^14 / 2^15 buckets x 6 slots).

    python scripts/k10_variants.py [--parent DIR] [--out FILE]

Builds `scripts/k10_variants.cu` (which includes the shipped source) with
`kernels/_build.py`'s nvcc flags into `_cache/k10_variants/`, and with
`--parent DIR` also DIR's `lv_slam_tpu_torch/csrc/lfa_fit.cu` (an earlier
tree, e.g. `git archive <commit> lv_slam_tpu_torch/csrc | tar -x -C DIR`).
Variants (`VARIANTS`): lanes per query (8, 4, 2, 1); the shipped design
(the block's queries staged in shared memory, then one thread a query runs
the ordered sums), the grouped one (one lane of each query's group runs
them) or the relayed one (the running sums passed from lane to lane by
shuffles); blocks of 256 or 128 threads. And the shipped and the relayed
lines kernels with clock stamps between their phases. Every
variant's outputs must equal the shipped wrapper's bit for bit (the parent's
too); each is timed device-only as chip_smoke.py times a kernel (the median
over the whole calls among 20 in a torch.profiler trace). Prints one line
per variant and writes them as JSON to FILE (default
`chiprun_out/k10_variants.json`), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (lanes per query, design, threads per block); designs: 0 the shipped kernels (G lanes a query stage the
# block's candidates, then one thread a query runs the chain), 1 relayed by shuffles, 2 grouped (lane 0 of
# each group runs the chain over the group's slice)
VARIANTS = [(8, 0, 256), (8, 0, 128), (4, 0, 256), (4, 0, 128), (2, 0, 256), (1, 0, 256),
            (8, 1, 256), (8, 1, 128), (4, 1, 256), (4, 1, 128), (8, 2, 256), (8, 2, 128), (4, 2, 256), (4, 2, 128)]
DESIGNS = ("staged, one thread a query", "relayed by shuffles", "grouped, one lane of the group")


def build(sources, out: Path, include: Path) -> ctypes.CDLL:
    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(include), "-o", str(out), *map(str, sources)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():  # ptxas -v: each kernel's registers and spills
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas {out.name}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(out))


def inputs(torch, cs, dev):
    """(cfg, {"lines": (queries, mask, edge table), "planes": (queries, mask, surf table)})."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.lfa import features
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL, _n_buckets
    from lv_slam_tpu_torch.ops import knn

    full = kitti_flagship_config()
    cfg = full.lfa
    with multiprocessing.get_context("spawn").Pool(5) as pool:
        scans = pool.starmap(cs._simulate, [(i, cs.N_FULL) for i in range(5)])
    gt = synthetic.circle_trajectory(cs.N_FULL, step=1.0)
    poses = [torch.from_numpy((np.linalg.inv(gt[0]) @ gt[i]).astype(np.float32)).to(dev) for i in range(5)]
    feats = [features.extract_features(PointCloud.from_numpy(s, cap=full.prefilter.raw_cap, device=dev), cfg)
             for s in scans]
    edge = knn.empty_cell_table(_n_buckets(cfg, cfg.map_edge_cap), cfg.knn_slots, _GRID_CELL, dev)
    surf = knn.empty_cell_table(_n_buckets(cfg, cfg.map_planar_cap), cfg.knn_slots, _GRID_CELL, dev)
    for f, pose in zip(feats[:4], poses):
        knn.insert_cell_table_(edge, se3.transform_points(pose, f.less_sharp), f.less_sharp_mask,
                               cfg.mapping_line_resolution)
        knn.insert_cell_table_(surf, se3.transform_points(pose, f.less_flat), f.less_flat_mask,
                               cfg.mapping_plane_resolution)
    f4 = feats[4]
    return cfg, {
        "lines": (se3.transform_points(poses[4], f4.less_sharp).contiguous(), f4.less_sharp_mask.contiguous(), edge),
        "planes": (se3.transform_points(poses[4], f4.less_flat).contiguous(), f4.less_flat_mask.contiguous(), surf),
    }


def identical(torch, a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y) for x, y in zip(a, b))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="an earlier tree whose lfa_fit.cu is timed beside")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "k10_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k10_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs

    from lv_slam_tpu_torch.kernels._build import CSRC, PTR, I32, F32, ptr
    from lv_slam_tpu_torch.lfa import registration

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    cache = ROOT / "_cache" / "k10_variants"
    lib = build([ROOT / "scripts" / "k10_variants.cu"], cache / "libk10v.so", CSRC)
    lib.k10v_fit.argtypes = [I32, I32, I32, I32, PTR, PTR, I32, PTR, I32, I32, F32, I32, PTR, PTR, PTR, PTR]
    lib.k10v_fit.restype = ctypes.c_int
    parent = None
    if args.parent is not None:
        src = args.parent / "lv_slam_tpu_torch" / "csrc"
        parent = build([src / "lfa_fit.cu"], cache / "libk10_parent.so", src)
        for fn in (parent.lvs_lines_from_fit, parent.lvs_planes_from_fit):
            fn.argtypes = [PTR, PTR, I32, PTR, I32, I32, F32, I32, PTR, PTR, PTR, PTR]
            fn.restype = ctypes.c_int

    cfg, data = inputs(torch, cs, dev)
    rows = []
    for kind, (y, m, table) in data.items():
        q = y.shape[0]
        wrapper = registration.lines_from_fit if kind == "lines" else registration.planes_from_fit
        shipped = wrapper(y, m, table, k=cfg.knn_k)
        second = (q, 3) if kind == "lines" else (q,)

        def call(launch):
            out = (torch.empty((q, 3), device=dev), torch.empty(second, device=dev),
                   torch.empty((q,), dtype=torch.bool, device=dev))
            err = launch(ptr(y), ptr(m), q, ptr(table.table), table.table.shape[0], table.slots, table.cell_size,
                         cfg.knn_k, *map(ptr, out), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{kind}: CUDA error {err}")
            return out

        runs = [("shipped wrapper", lambda: wrapper(y, m, table, k=cfg.knn_k), (kind,))]
        if parent is not None:
            entry = parent.lvs_lines_from_fit if kind == "lines" else parent.lvs_planes_from_fit
            runs.append(("parent tree", lambda entry=entry: call(entry), (kind,)))
        for g, design, threads in VARIANTS:
            launch = (lambda *a, g=g, design=design, threads=threads:
                      lib.k10v_fit(int(kind == "planes"), g, design, threads, *a))
            name = f"{g} lanes/query, {DESIGNS[design]}, {threads} threads"
            runs.append((name, lambda launch=launch: call(launch), (kind + ("", "_relay", "_grouped")[design],)))
        for name, fn, functions in runs:
            got = fn()
            torch.cuda.synchronize()
            if not identical(torch, got, shipped):
                raise AssertionError(f"{kind}, {name}: outputs differ from the shipped kernel's")
            ms, all_ms, n = cs.device_ms(torch, fn, functions)
            rows.append(dict(kernel=kind, variant=name, ms=ms, device_ms=all_ms, calls=n, queries=q))
            print(f"{kind:6s} {name:52s} {ms:.4f} ms (all device work {all_ms:.4f} ms, {n} whole calls), "
                  f"outputs bit-identical", flush=True)
    # where a warp's cycles go: lines at 8 lanes per query with clock stamps, both designs, at the same shape
    lib.k10v_lines_stamped.argtypes = [I32, PTR, PTR, I32, PTR, I32, I32, F32, I32, PTR, PTR, PTR, PTR, PTR]
    lib.k10v_lines_stamped.restype = ctypes.c_int
    y, m, table = data["lines"]
    q = y.shape[0]
    stamped = {}
    for relayed, design, rows_of, phases in (
        (0, "staged, per block", (q + 31) // 32,
         ("query read", "block's candidates staged", "mean sums", "covariance sums", "eigh and writes")),
        (1, "relayed, per warp", q * 8 // 32,
         ("query read", "rows gathered and gated", "mean relay", "covariance relay", "eigh and writes")),
    ):
        cycles = torch.zeros((rows_of, len(phases)), dtype=torch.int64, device=dev)
        out = (torch.empty((q, 3), device=dev), torch.empty((q, 3), device=dev),
               torch.empty((q,), dtype=torch.bool, device=dev))
        for _ in range(3):
            if lib.k10v_lines_stamped(relayed, ptr(y), ptr(m), q, ptr(table.table), table.table.shape[0], table.slots,
                                      table.cell_size, cfg.knn_k, *map(ptr, out), ptr(cycles),
                                      torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("lines_stamped: CUDA error")
            torch.cuda.synchronize()
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                                capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        c = cycles.double().cpu()
        total = c.sum(1)
        stamped[design] = {p: dict(mean=float(c[:, j].mean()), max=float(c[:, j].max())) for j, p in enumerate(phases)}
        stamped[design]["whole"] = dict(mean=float(total.mean()), max=float(total.max()))
        print(f"lines, 8 lanes/query, {design}: clock stamps over {c.shape[0]} rows (SM clock now, max: {clocks}):",
              flush=True)
        for p, v in stamped[design].items():
            print(f"  {p:26s} mean {v['mean']:8.0f} cycles, max {v['max']:8.0f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, rows=rows, stamps=stamped), indent=1))
    n_cases = cs.check_fit_cases(torch, dev)
    print(f"fit_cases: {n_cases} cases, decisions identical to the CPU twin, the lines' means bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
