#!/usr/bin/env python3
"""Holds kernel 14 (the centroid grid's build and its 27-cell probe,
`lv_slam_tpu_torch/csrc/centroid_grid.cu`, with kernels 17 and 18, which
share the probe) and kernel 9b (the LFA tables' crop, `csrc/cell_table.cu`)
bit for bit against an earlier tree's kernels on one NVIDIA GPU, and times
both side by side.

    python scripts/k14_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/k14_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc`. Where it is missing and the checkout has git, the
script writes `centroid_grid.cu`, `cell_table.cu` and `common.cuh` there
from `git show C:...` (C defaults to f390644, the tree whose grid build sat
behind torch.sort and torch.cumsum, whose probe made 27 binary searches and
whose crop took a launch a table); on a copy without git, unpack it first
(`git archive C lv_slam_tpu_torch/csrc | tar -x -C DIR`). It builds both
files with `kernels/_build.py`'s nvcc flags into `_cache/k14_parent/` and
runs that tree's routes beside the shipped entries: the build as its
wrapper ran it (`ops/nn._grid_keys`, `torch.sort`, `lvs_grid_mark`,
`torch.cumsum`, `lvs_grid_reduce`), the query, K17 and K18 entries (the
same C signatures) through the shipped wrappers with the earlier library's
functions swapped in, and the crop as two `lvs_crop_cell_table` launches.

Checks, every one bit for bit (float bits):
- the grid (keys, centroids, counts, origin) at chip_smoke.py phase 2's
  16-scan keyframe cloud (131072 lanes, 0.25 m), at phase 10a's ICP target
  (scan 40 through the flagship prefilter) and at K18's grids of that cloud
  (the radius removal's and the statistical removal's cells), and on every
  `chip_smoke.grid_cases` entry;
- `nn_sq_dists` of phase 2's first candidate and `fitness_batch` of its 8
  candidates (8 x 131072 lanes) at their guesses;
- `nn_points` and one ICP iteration (`ops/icp.icp_step`) of scan 41 at
  phase 10's guess;
- both removals of scan 40's filtered cloud;
- every `grid_cases` query (`nn_sq_dists`, `nn_points`) and radius removal;
- K9b on phase 2's tables (scans 0-3's edge and surf maps), gate open,
  closed and absent: both tables and the returned center.

Times, the earlier route's whole device work (its torch glue included) and
the shipped kernels' own launches, in the same call (device-only medians
over the whole calls among 20 in a torch.profiler trace, as chip_smoke.py
times a kernel, `device_ms`): the build, `fitness_batch`, `nn_points`, the
ICP iteration, both removals, the crop of both tables with the gate open
and closed. Prints one line per check and timing and writes them as JSON to
FILE (default `chiprun_out/k14_parent.json`), beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import multiprocessing
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

COMMIT = "f390644"  # the tree before the redesign
SOURCES = ("centroid_grid.cu", "cell_table.cu", "common.cuh")
N_WINDOW = 16  # scans in the keyframe cloud
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_BUILD = ("grid_mark", "grid_reduce")  # the earlier build's hand kernels


def fetch_parent(parent: Path, commit: str) -> Path:
    """DIR's csrc, written from git when it is missing."""
    csrc = parent / "lv_slam_tpu_torch" / "csrc"
    if all((csrc / name).is_file() for name in SOURCES):
        return csrc
    csrc.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        text = subprocess.run(["git", "-C", str(ROOT), "show", f"{commit}:lv_slam_tpu_torch/csrc/{name}"],
                              capture_output=True, text=True, check=True).stdout
        (csrc / name).write_text(text)
    return csrc


def build(source: Path, out: Path) -> ctypes.CDLL:
    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(source.parent), "-o", str(out), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def stream(torch):
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class Parent:
    """The earlier tree's routes over its libraries."""

    def __init__(self, torch, grid_lib, table_lib):
        self.torch, self.grid_lib, self.table_lib = torch, grid_lib, table_lib
        for fn, args in ((grid_lib.lvs_grid_mark, [P, I, P]),
                         (grid_lib.lvs_grid_reduce, [P, P, P, P, I, P, I, P, P, P]),
                         (table_lib.lvs_crop_cell_table, [P, I, P, P, F, F, P])):
            fn.argtypes, fn.restype = [*args, P], ctypes.c_int

    def build(self, cloud, resolution: float, leaf_cap: int = 65536):
        """The earlier `build_centroid_grid` on CUDA: torch glue around two launches."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops import nn

        torch = self.torch
        keys, origin, xyz = nn._grid_keys(cloud, resolution)
        skeys, order = torch.sort(keys, stable=True)
        n, dev = keys.shape[0], xyz.device
        flag = torch.empty((n,), dtype=torch.int32, device=dev)
        out_keys = torch.empty((leaf_cap,), dtype=torch.int32, device=dev)
        centroids = torch.empty((leaf_cap, 3), dtype=torch.float32, device=dev)
        counts = torch.empty((leaf_cap,), dtype=torch.float32, device=dev)
        if self.grid_lib.lvs_grid_mark(ptr(skeys), n, ptr(flag), stream(torch)):
            raise RuntimeError("lvs_grid_mark failed")
        cum = torch.cumsum(flag, dim=0, dtype=torch.int32)
        if self.grid_lib.lvs_grid_reduce(ptr(skeys), ptr(order), ptr(flag), ptr(cum), n, ptr(xyz), leaf_cap,
                                         ptr(out_keys), ptr(centroids), ptr(counts), stream(torch)):
            raise RuntimeError("lvs_grid_reduce failed")
        return nn.CentroidGrid(out_keys, centroids, counts, origin, float(resolution))

    @contextlib.contextmanager
    def kernels(self):
        """The shipped query, K17 and K18 wrappers over the earlier library's
        entries (the same C signatures), and the earlier build under the
        removals."""
        from lv_slam_tpu_torch.ops import nn

        swapped = (nn.QUERY_KERNEL, nn.NN_POINTS_KERNEL, nn.RADIUS_KERNEL, nn.STATISTICAL_KERNEL)
        saved = [k._fns for k in swapped]
        shipped_build = nn.build_centroid_grid
        for k in swapped:
            fns = {}
            for entry, argtypes in k._argtypes.items():
                fn = getattr(self.grid_lib, entry)
                fn.argtypes, fn.restype = [*argtypes, P], ctypes.c_int
                fns[entry] = fn
            k._fns = fns
        nn.build_centroid_grid = self.build
        try:
            yield
        finally:
            for k, fns in zip(swapped, saved):
                k._fns = fns
            nn.build_centroid_grid = shipped_build

    def crop(self, tables, center, radius, last_center=None, interval=0.0):
        """The earlier crop: one launch a table on the same gate."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops.knn import _sq

        torch = self.torch
        out = torch.empty((3,), dtype=torch.float32, device=center.device)
        for t in tables:
            if self.table_lib.lvs_crop_cell_table(
                    ptr(t.table), t.table.numel() // 4, ptr(center),
                    ptr(last_center) if last_center is not None else None, _sq(interval), _sq(radius), ptr(out),
                    stream(torch)):
                raise RuntimeError("lvs_crop_cell_table failed")
        return out


def bits(torch, t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def differ(torch, got, want) -> list:
    """Indices of the tensors of two tuples that are not bit-identical."""
    return [i for i, (a, b) in enumerate(zip(got, want))
            if isinstance(a, torch.Tensor) and not (a.shape == b.shape and torch.equal(bits(torch, a), bits(torch, b)))]


def load_inputs(torch, cs, dev):
    """Scans 0-17 and 40-41 of chip_smoke's circle (its cache, or simulated),
    and the ground truth."""
    from lv_slam_tpu_torch.io import synthetic

    need = list(range(N_WINDOW + 2)) + list(cs.PAIR)
    if (cs.CACHE / f"scans_v1_{cs.N_FULL}.npz").exists():
        all_scans = cs.load_scans(cs.N_FULL)[0]
        scans = {i: all_scans[i] for i in need}
    else:
        with multiprocessing.get_context("spawn").Pool(8) as pool:
            scans = dict(zip(need, pool.starmap(cs._simulate, [(i, cs.N_FULL) for i in need])))
    return scans, synthetic.circle_trajectory(cs.N_FULL, step=1.0)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "k14_parent.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k14_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.lfa import features
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL, _n_buckets
    from lv_slam_tpu_torch.ops import icp, knn, nn, prefilter
    from lv_slam_tpu_torch.pipeline import window

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    csrc = fetch_parent(args.parent or ROOT / "_cache" / "k14_parent" / args.commit, args.commit)
    out_dir = ROOT / "_cache" / "k14_parent"
    parent = Parent(torch, build(csrc / "centroid_grid.cu", out_dir / "libgrid_parent.so"),
                    build(csrc / "cell_table.cu", out_dir / "libtable_parent.so"))
    cfg = kitti_flagship_config()
    pf, lfa = cfg.prefilter, cfg.lfa
    scans, gt = load_inputs(torch, cs, dev)
    rows, failed = [], []

    def check(name, shipped, earlier, time=None):
        """Runs both routes once, demands every tensor bit-identical; with
        `time` = (shipped device functions,) times both."""
        got, want = shipped(), earlier()
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        bad = differ(torch, got, want)
        row = dict(check=name, bit_identical=not bad, differ=bad)
        if time is not None:
            row["ms"], row["wrapper_ms"], _ = cs.device_ms(torch, shipped, time)
            row["parent_ms"] = cs.device_ms(torch, earlier)[1]
        if bad:
            failed.append(name)
        rows.append(row)
        times = (f"; shipped {row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}), parent route "
                 f"{row['parent_ms']:.4f} ms") if time is not None else ""
        print(f"{name}: {'bit-identical' if not bad else f'DIFFERS in outputs {bad}'}{times}", flush=True)
        return got

    def timed_only(name, shipped, earlier, functions):
        row = dict(check=name, timing_only=True)
        row["ms"], row["wrapper_ms"], _ = cs.device_ms(torch, shipped, functions)
        row["parent_ms"] = cs.device_ms(torch, earlier)[1]
        rows.append(row)
        print(f"{name}: shipped {row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}), parent route "
              f"{row['parent_ms']:.4f} ms", flush=True)

    build_fns = cs.DEVICE_FUNCTIONS["build_centroid_grid"]

    # phase 2's keyframe cloud and its 8 candidates (chip_smoke.check_backend_kernels)
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)

    def filtered(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        band = prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)
        return prefilter.voxel_downsample(band, pf.downsample_resolution, pf.out_cap)

    scans_f = [filtered(i) for i in range(N_WINDOW + 2)]
    rows_f = scans_f[:N_WINDOW]
    keyframe = window.window_group_filtered(
        torch.stack([c.xyz.T for c in rows_f]).contiguous(), torch.stack([c.intensity for c in rows_f]),
        torch.stack([c.mask for c in rows_f]), 0, torch.from_numpy(rel[:N_WINDOW].copy()).to(dev),
        torch.ones(N_WINDOW, dtype=torch.bool, device=dev), pf.downsample_resolution, 131072)
    grid = check("K14 build, phase 2's keyframe cloud (131072 lanes, 0.25 m)",
                 lambda: nn.build_centroid_grid(keyframe, 0.25), lambda: parent.build(keyframe, 0.25), build_fns)
    rows[-1]["parent_kernels_ms"] = cs.device_ms(torch, lambda: parent.build(keyframe, 0.25), PARENT_BUILD)[0]
    key14, _, _ = nn._grid_keys(keyframe, 0.25)
    rows[-1]["torch_sort_ms"] = cs.device_ms(torch, lambda: torch.sort(key14, stable=True))[1]
    print(f"  the earlier build's own kernels {rows[-1]['parent_kernels_ms']:.4f} ms; torch.sort of its "
          f"{key14.numel()} int32 keys alone {rows[-1]['torch_sort_ms']:.4f} ms", flush=True)
    cands = [scans_f[i] for i in range(2, 18, 2)]
    guesses = torch.from_numpy(rel[2:18:2].copy()).to(dev)
    guesses[:, 0, 3] += 0.2
    batch = PointCloud(torch.stack([c.xyz for c in cands]), torch.stack([c.intensity for c in cands]),
                       torch.stack([c.mask for c in cands]))
    moved = cands[0].transformed(guesses[0])
    y0, m0 = moved.masked_xyz(), moved.mask

    def earlier(fn):
        def run():
            with parent.kernels():
                return fn()
        return run

    check("K14 query: nn_sq_dists of candidate 0 at its guess", lambda: nn.nn_sq_dists(grid, y0, m0),
          earlier(lambda: nn.nn_sq_dists(grid, y0, m0)))
    check("K14 query: fitness_batch, 8 x 131072 lanes", lambda: nn.fitness_batch(grid, batch, guesses),
          earlier(lambda: nn.fitness_batch(grid, batch, guesses)), cs.DEVICE_FUNCTIONS["nn_sq_dists"])

    # phase 10's pair: K17 on scan 41 against scan 40's grid, K18 on scan 40
    target, source, _, guess = cs.registration_pair(torch, scans, gt, dev)
    check("K14 build, phase 10a's ICP target (scan 40 through the flagship prefilter)",
          lambda: nn.build_centroid_grid(target, 0.25), lambda: parent.build(target, 0.25), build_fns)
    for r in sorted({pf.radius_radius, nn._STAT_RADIUS}):
        check(f"K14 build, K18's grid of scan 40 at {r:g} m (a leaf per lane)",
              lambda r=r: nn.build_centroid_grid(target, r, leaf_cap=target.cap),
              lambda r=r: parent.build(target, r, leaf_cap=target.cap), build_fns)
    tgrid = nn.build_centroid_grid(target, 0.25)
    src, mask = source.masked_xyz().contiguous(), source.mask.contiguous()
    y = se3.transform_points_fma(guess, src)
    nn_fns = cs.DEVICE_FUNCTIONS["nn_points"]
    check("K17 nn_points of scan 41 at the guess", lambda: nn.nn_points(tgrid, y, mask),
          earlier(lambda: nn.nn_points(tgrid, y, mask)), nn_fns)
    check("K17 one ICP iteration (icp_step)", lambda: icp.icp_step(tgrid, src, mask, guess, 4.0),
          earlier(lambda: icp.icp_step(tgrid, src, mask, guess, 4.0)), nn_fns)
    removals = (("radius_outlier_removal", (pf.radius_radius, pf.radius_min_neighbors)),
                ("statistical_outlier_removal", (pf.statistical_mean_k, pf.statistical_stddev)))
    for name, a in removals:
        fn = getattr(nn, name)
        check(f"K18 {name} of scan 40 (the build included)", lambda fn=fn, a=a: tuple(fn(target, *a)),
              earlier(lambda fn=fn, a=a: tuple(fn(target, *a))),
              cs.DEVICE_FUNCTIONS[name] + build_fns)

    # every grid_cases entry: the build, the queries, the radius removal
    for name, pts, m, leaf_cap, queries, qmask in cs.grid_cases():
        cloud = PointCloud(torch.from_numpy(pts).to(dev), torch.zeros(len(pts), device=dev),
                           torch.from_numpy(m).to(dev))
        g = check(f"grid_cases {name}: build", lambda: nn.build_centroid_grid(cloud, cs.GRID_RES, leaf_cap),
                  lambda: parent.build(cloud, cs.GRID_RES, leaf_cap))
        q = PointCloud(torch.from_numpy(queries).to(dev), torch.zeros(len(queries), device=dev),
                       torch.from_numpy(qmask).to(dev))
        yq, mq = q.masked_xyz(), q.mask
        check(f"grid_cases {name}: nn_sq_dists and nn_points",
              lambda: (nn.nn_sq_dists(g, yq, mq), *nn.nn_points(g, yq, mq)),
              earlier(lambda: (nn.nn_sq_dists(g, yq, mq), *nn.nn_points(g, yq, mq))))
        check(f"grid_cases {name}: radius removal", lambda: tuple(nn.radius_outlier_removal(cloud, cs.GRID_RES, 3)),
              earlier(lambda: tuple(nn.radius_outlier_removal(cloud, cs.GRID_RES, 3))))

    # K9b on phase 2's tables: scans 0-3's maps, cropped at scan 4's pose
    poses = [torch.from_numpy(p).to(dev) for p in rel[:5]]
    raw = [PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev) for i in range(5)]
    tables = [knn.empty_cell_table(_n_buckets(lfa, lfa.map_edge_cap), lfa.knn_slots, _GRID_CELL, dev),
              knn.empty_cell_table(_n_buckets(lfa, lfa.map_planar_cap), lfa.knn_slots, _GRID_CELL, dev)]
    for i in range(4):
        f = features.extract_features(raw[i], lfa)
        knn.insert_cell_table_(tables[0], se3.transform_points(poses[i], f.less_sharp), f.less_sharp_mask,
                               lfa.mapping_line_resolution)
        knn.insert_cell_table_(tables[1], se3.transform_points(poses[i], f.less_flat), f.less_flat_mask,
                               lfa.mapping_plane_resolution)
    center = poses[4][:3, 3].contiguous()
    gates = (("gate open", center + 1e6, lfa.crop_interval), ("gate closed", center + 0.5 * lfa.crop_interval,
                                                              lfa.crop_interval), ("no gate", None, 0.0))
    for what, last, interval in gates:
        def copies():
            return [knn.CellTable(t.table.clone(), t.cell_size) for t in tables]

        def shipped(last=last, interval=interval):
            a, b = copies()
            return (knn.crop_cell_tables_(a, b, center, lfa.crop_radius, last, interval), a.table, b.table)

        def earlier_crop(last=last, interval=interval):
            a, b = copies()
            return (parent.crop((a, b), center, lfa.crop_radius, last, interval), a.table, b.table)

        check(f"K9b both tables, {what}", shipped, earlier_crop)
    for what, last in (("gate open", center + 1e6), ("gate closed", center + 0.5 * lfa.crop_interval)):
        timed_only(f"K9b both tables, {what}",
                   cs.on_copies(tuple(tables), lambda a, b, last=last: knn.crop_cell_tables_(
                       a, b, center, lfa.crop_radius, last, lfa.crop_interval)),
                   cs.on_copies(tuple(tables), lambda a, b, last=last: parent.crop(
                       (a, b), center, lfa.crop_radius, last, lfa.crop_interval)),
                   cs.DEVICE_FUNCTIONS["crop_cell_table"])

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, commit=args.commit, rows=rows), indent=1))
    if failed:
        print(f"k14_parent: not bit-identical on {failed}", flush=True)
        return 1
    n = sum(1 for r in rows if "bit_identical" in r)
    print(f"k14_parent: all {n} checks bit-identical to the parent tree's kernels", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
