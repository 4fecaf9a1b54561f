#!/usr/bin/env python3
"""Holds kernel 2r (the raw window group, `lv_slam_tpu_torch/csrc/voxel_dedup.cu`
`lvs_window_raw`) bit for bit against an earlier tree's route, and kernel 21
(the uniform subsample, `csrc/subsample.cu`) against the earlier tree's plain
PyTorch version, on one NVIDIA GPU; times both side by side and times kernel
21's design variants.

    python scripts/window_subsample_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/window_subsample_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc` and `lv_slam_tpu_torch/ops/prefilter.py`. Where they
are missing and the checkout has git, the script writes `voxel_dedup.cu`,
`voxel_downsample.cu`, `voxel_keys.cuh`, `key_sort.cuh`, `common.cuh` and
`prefilter.py` there from `git show C:...` (C defaults to c5bd611, the tree
whose raw window group sorted int64 keys with `torch.sort` and whose
`uniform_subsample` was plain torch); on a copy without git, unpack them
first (`git archive C lv_slam_tpu_torch/csrc lv_slam_tpu_torch/ops/prefilter.py
| tar -x -C DIR`). It builds `voxel_dedup.cu` and `voxel_downsample.cu` with
`kernels/_build.py`'s nvcc flags into `_cache/window_subsample_parent/` (two
nvcc processes, started together) and runs the earlier K2r route as its
wrapper ran it: `lvs_window_raw_keys`, a stable `torch.sort` of the int64
keys, `lvs_voxel_mark_runs`, a `torch.cumsum`, `lvs_voxel_reduce_runs`. The
earlier `uniform_subsample` is that tree's function, compiled from its source.
`scripts/subsample_variants.cu` (it includes the shipped `subsample.cu`) is
built beside them.

Checks, every one bit for bit (masks, lane order, float bits):
- K2r at chip_smoke.py phase 2g's flagship group (scans 0-15 of the circle,
  16 x 131072 raw lanes into 131072 centroids) and on every
  `chip_smoke.raw_window_cases` entry;
- K2r on each window group of a whole raw-chunk pass (phase 9a's feed, the
  170-scan circle through `run_full(raw=True)`), replayed by both routes;
- K21 at phase 2f's shape (scan 1's filtered cloud into 65536 lanes), on
  every `chip_smoke.subsample_cases` entry and on the 170 subsamples of a
  host-DLO pass (phase 8a's), replayed;
- every K21 variant at 2f's shape and at KITTI density.

Times (device-only medians over the whole calls among 20 in a torch.profiler
trace, `chip_smoke.device_ms`), in the same call: K2r at the flagship group
(the shipped kernels' own launches, the earlier route's whole device work,
torch.sort included); K21 at 2f's shape and at KITTI density (100000 of
131072 lanes into 65536), the shipped kernel, the earlier plain version and
each variant (one cluster of 8 blocks; 2, 4, 8 and 16 clusters; two
launches, the count over 32 or 132 blocks), each also as its device span
(first kernel's start to last kernel's end, the gap between two launches
included); and traced totals
(`chip_smoke.trace_rows`) of both K2r routes over the raw pass's window
groups and of K21 against the earlier plain version over the DLO pass's
170 subsamples, with the library's onesweep launches; and a traced raw
pass with each K2r route, their onesweep launches. Prints one line per check
and timing and writes them as JSON to FILE (default
`chiprun_out/window_subsample_parent.json`), beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from _parent import build, differ, fetch_parent, span_ms  # noqa: E402  (scripts/_parent.py)

COMMIT = "c5bd611"  # the tree before the redesign
SOURCES = ("voxel_dedup.cu", "voxel_downsample.cu", "voxel_keys.cuh", "key_sort.cuh", "common.cuh")
LIBRARIES = ("voxel_dedup.cu", "voxel_downsample.cu")
CACHE = ROOT / "_cache" / "window_subsample_parent"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ONESWEEP = "DeviceRadixSortOnesweepKernel"


def parent_function(parent: Path, commit: str, name: str, namespace: dict):
    """Function `name` of the earlier tree's `ops/prefilter.py`, compiled
    into `namespace` (the file is written from `git show` where missing)."""
    path = parent / "lv_slam_tpu_torch" / "ops" / "prefilter.py"
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(subprocess.run(["git", "-C", str(ROOT), "show", f"{commit}:lv_slam_tpu_torch/ops/prefilter.py"],
                                       capture_output=True, text=True, check=True).stdout)
    node = next(n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), namespace)
    return namespace[name]


class Parent:
    """The earlier tree's K2r route: its C entries around `torch.sort` and
    `torch.cumsum`."""

    def __init__(self, torch, libs):
        self.torch = torch
        self.dedup, self.down = libs["voxel_dedup.cu"], libs["voxel_downsample.cu"]
        for fn, args in ((self.dedup.lvs_window_raw_keys, [P, P, P, I, I, I, I, P, P, F, F, F, P, P, P, P]),
                         (self.down.lvs_voxel_mark_runs, [P, I, P, P]),
                         (self.down.lvs_voxel_reduce_runs, [P, P, P, P, I, P, P, I, P, P, P, P])):
            fn.argtypes, fn.restype = args, ctypes.c_int

    def _stream(self):
        return ctypes.c_void_p(self.torch.cuda.current_stream().cuda_stream)

    def _check(self, err, entry):
        if err:
            raise RuntimeError(f"the earlier {entry} failed with CUDA error {err}")

    def window_group(self, chunk_xyz, chunk_inten, chunk_mask, start, rels, valid, near, far, resolution, out_cap):
        """The earlier `window_group` on CUDA: keys, torch.sort, run marks,
        cumsum, the run reduction."""
        from lv_slam_tpu_torch.core.cloud import PointCloud
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops.cells import inv_resolution

        torch = self.torch
        n_rows, cap, _ = chunk_xyz.shape
        length = rels.shape[0]
        n = length * cap
        dev = chunk_xyz.device
        xyz = torch.empty((n, 3), dtype=torch.float32, device=dev)
        inten = torch.empty((n,), dtype=torch.float32, device=dev)
        key = torch.empty((n,), dtype=torch.int64, device=dev)
        self._check(self.dedup.lvs_window_raw_keys(
            ptr(chunk_xyz), ptr(chunk_inten), ptr(chunk_mask), n_rows, cap, int(start), length, ptr(rels), ptr(valid),
            float(near), float(far), inv_resolution(resolution), ptr(xyz), ptr(inten), ptr(key), self._stream()),
            "lvs_window_raw_keys")
        skey, order = torch.sort(key, stable=True)
        flag = torch.empty((n,), dtype=torch.int32, device=dev)
        out_xyz = torch.empty((out_cap, 3), dtype=torch.float32, device=dev)
        out_int = torch.empty((out_cap,), dtype=torch.float32, device=dev)
        out_mask = torch.empty((out_cap,), dtype=torch.bool, device=dev)
        self._check(self.down.lvs_voxel_mark_runs(ptr(skey), n, ptr(flag), self._stream()), "lvs_voxel_mark_runs")
        cum = torch.cumsum(flag, dim=0, dtype=torch.int32)
        self._check(self.down.lvs_voxel_reduce_runs(
            ptr(skey), ptr(order), ptr(flag), ptr(cum), n, ptr(xyz), ptr(inten), out_cap, ptr(out_xyz), ptr(out_int),
            ptr(out_mask), self._stream()), "lvs_voxel_reduce_runs")
        return PointCloud(out_xyz, out_int, out_mask)


class Variants:
    """Kernel 21's design variants (`scripts/subsample_variants.cu`)."""

    def __init__(self, torch):
        from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

        self.torch = torch
        CACHE.mkdir(parents=True, exist_ok=True)
        out = CACHE / "libsubsample_variants.so"
        subprocess.run([_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(ROOT / "lv_slam_tpu_torch" / "csrc"), "-o",
                        str(out), str(ROOT / "scripts" / "subsample_variants.cu")], check=True, capture_output=True)
        self.lib = ctypes.CDLL(str(out))
        self.lib.variant_clusters.argtypes = [P, P, P, I, I, I, P, P, P, P]
        self.lib.variant_two_launches.argtypes = [P, P, P, I, I, I, P, P, P, P, P]
        self.lib.variant_clusters.restype = self.lib.variant_two_launches.restype = ctypes.c_int

    def run(self, cloud, out_cap, clusters=None, count_blocks=None):
        """The subsample of `cloud` into out_cap rows by one variant."""
        from lv_slam_tpu_torch.core.cloud import PointCloud
        from lv_slam_tpu_torch.kernels._build import ptr

        torch = self.torch
        dev = cloud.xyz.device
        outs = (torch.empty((out_cap, 3), dtype=torch.float32, device=dev),
                torch.empty((out_cap,), dtype=torch.float32, device=dev),
                torch.empty((out_cap,), dtype=torch.bool, device=dev))
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = (ptr(cloud.xyz), ptr(cloud.intensity), ptr(cloud.mask), cloud.cap, out_cap)
        if clusters is not None:
            err = self.lib.variant_clusters(*args, clusters, *map(ptr, outs), stream)
        else:
            part = torch.empty((count_blocks,), dtype=torch.int32, device=dev)
            err = self.lib.variant_two_launches(*args, count_blocks, ptr(part), *map(ptr, outs), stream)
        if err:
            raise RuntimeError(f"variant failed with CUDA error {err}")
        return PointCloud(*outs)


VARIANTS = ([(f"{g} cluster{'s' if g > 1 else ''} of 8 blocks", dict(clusters=g)) for g in (1, 2, 4, 8, 16)]
            + [(f"two launches, the count over {b} blocks", dict(count_blocks=b)) for b in (32, 132)])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "window_subsample_parent.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("window_subsample_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
    from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry
    from lv_slam_tpu_torch.ops import prefilter
    from lv_slam_tpu_torch.pipeline import backend as backend_module, window

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    parent_dir = args.parent or CACHE / args.commit
    csrc = fetch_parent(parent_dir, args.commit, SOURCES)
    parent = Parent(torch, build(csrc, LIBRARIES, CACHE))
    parent_subsample = parent_function(parent_dir, args.commit, "uniform_subsample",
                                       dict(torch=torch, SENTINEL=SENTINEL, PointCloud=PointCloud))
    variants = Variants(torch)
    cfg = kitti_flagship_config()
    pf = cfg.prefilter
    scans, gt = cs.load_scans(cs.N_FULL)
    rows, failed = [], []
    k2r_fns, k21_fns = cs.DEVICE_FUNCTIONS["window_group_fn"], cs.DEVICE_FUNCTIONS["uniform_subsample"]

    def check(name, shipped, parent_fn, time=None):
        """Runs both once, demands every tensor bit-identical; with `time`
        (the shipped device functions) times both."""
        got, want = shipped(), parent_fn()
        torch.cuda.synchronize()
        bad = differ(torch, got, want)
        row = dict(check=name, bit_identical=not bad, differ=bad)
        if time is not None:
            row["ms"], row["wrapper_ms"], _ = cs.device_ms(torch, shipped, time)
            row["parent_ms"] = cs.device_ms(torch, parent_fn)[1]
        if bad:
            failed.append(name)
        rows.append(row)
        times = (f"; shipped {row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}), parent {row['parent_ms']:.4f} ms"
                 if time is not None else "")
        print(f"{name}: {'bit-identical' if not bad else f'DIFFERS in outputs {bad}'}{times}", flush=True)

    def traced_total(name, calls, shipped, earlier):
        """Both routes' whole device time over one traced replay each of
        `calls` (the arguments a run handed the function), every kernel of
        the trace but its lead-in markers, with their onesweep launches; and
        every call's outputs bit-identical."""
        row = dict(check=name, traced=True, calls=len(calls))
        bad = [i for i, a in enumerate(calls) if differ(torch, shipped(*a), earlier(*a))]
        row["bit_identical"] = not bad
        for key, fn in (("", shipped), ("parent_", earlier)):
            trace = [(t, k, c) for t, k, c in cs.trace_rows(torch, lambda fn=fn: [fn(*a) for a in calls])
                     if cs.MARKER not in k]
            row[f"{key}ms"] = sum(t for t, _, _ in trace) / 1e3
            row[f"{key}launches"] = sum(c for _, _, c in trace)
            row[f"{key}onesweep_launches"] = sum(c for _, k, c in trace if ONESWEEP in k)
        rows.append(row)
        if bad:
            failed.append(name)
        print(f"{name}: {'bit-identical' if not bad else f'DIFFERS at calls {bad}'}; shipped {row['ms']:.3f} ms over "
              f"{row['launches']} device launches ({row['onesweep_launches']} onesweep); parent {row['parent_ms']:.3f} "
              f"ms over {row['parent_launches']} ({row['parent_onesweep_launches']} onesweep)", flush=True)
        return row

    def cloud_out(c):
        return (c.xyz, c.intensity, c.mask)

    # K2r at phase 2g's flagship group
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    raw = [PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev) for i in range(16)]
    group = (torch.stack([c.xyz for c in raw]), torch.stack([c.intensity for c in raw]),
             torch.stack([c.mask for c in raw]), 0, torch.from_numpy(rel[:16].copy()).to(dev),
             torch.ones(16, dtype=torch.bool, device=dev), pf.distance_near_thresh, pf.distance_far_thresh,
             pf.downsample_resolution, 131072)
    check(f"K2r at phase 2g's flagship group (16 x {pf.raw_cap} raw lanes -> 131072)",
          lambda: cloud_out(window.window_group(*group)), lambda: cloud_out(parent.window_group(*group)), k2r_fns)

    # K2r on raw_window_cases
    for name, xyz, inten, mask, start, rels, valid, near, far, res, out_cap in cs.raw_window_cases():
        a = [torch.from_numpy(t).to(dev) for t in (xyz, inten, mask)]
        b = [torch.from_numpy(t).to(dev) for t in (rels, valid)]
        case = (*a, start, *b, near, far, res, out_cap)
        check(f"K2r on raw_window_cases {name}", lambda c=case: cloud_out(window.window_group(*c)),
              lambda c=case: cloud_out(parent.window_group(*c)))

    # K2r over a whole raw-chunk pass's window groups (phase 9a's feed), and
    # the pass traced with either route
    xyz, mask, stamps, inten = cs.stack_scans(torch, scans, pf.raw_cap, dev)
    groups = []
    feed = backend_module.window_group
    backend_module.window_group = lambda *a: groups.append(a) or feed(*a)
    try:
        cs.run_full(torch, xyz, mask, stamps, inten, cfg, cs.make_backend(dev, True), raw=True)
    finally:
        backend_module.window_group = feed
    traced_total(f"K2r over a {len(scans)}-scan raw-chunk pass's {len(groups)} window groups, replayed", groups,
                 lambda *a: cloud_out(window.window_group(*a)), lambda *a: cloud_out(parent.window_group(*a)))
    passes = dict(check="a raw-chunk pass traced with either K2r route", traced=True)
    for key, fn in (("", feed), ("parent_", parent.window_group)):
        backend_module.window_group = fn
        try:
            trace = cs.trace_rows(torch, lambda: cs.run_full(torch, xyz, mask, stamps, inten, cfg,
                                                              cs.make_backend(dev, True), raw=True))
        finally:
            backend_module.window_group = feed
        passes[f"{key}ms"] = sum(t for t, k, _ in trace if cs.MARKER not in k) / 1e3
        passes[f"{key}onesweep_launches"] = sum(c for _, k, c in trace if ONESWEEP in k)
    rows.append(passes)
    print(f"{passes['check']}: device busy {passes['ms']:.3f} ms, onesweep {passes['onesweep_launches']}; parent "
          f"{passes['parent_ms']:.3f} ms, onesweep {passes['parent_onesweep_launches']}", flush=True)

    # K21 at phase 2f's shape and at KITTI density, its variants beside it
    k = cfg.odometry.scan_matching_cap
    filtered = prefilter.prefilter(PointCloud.from_numpy(scans[1], cap=pf.raw_cap, device=dev), pf)
    kitti = next(c for c in cs.subsample_cases() if c[0] == "KITTI density")
    dense = PointCloud(*(torch.from_numpy(t).to(dev) for t in (kitti[1][:, :3].copy(), kitti[1][:, 3].copy(),
                                                                kitti[2])))
    for what, cloud, cap in ((f"phase 2f's shape ({int(filtered.mask.sum())} points in {filtered.cap} lanes -> {k})",
                              filtered, k), (f"KITTI density (100000 points in 131072 lanes -> {kitti[3]})", dense,
                                             kitti[3])):
        check(f"K21 at {what}", lambda c=cloud, o=cap: cloud_out(prefilter.uniform_subsample(c, o)),
              lambda c=cloud, o=cap: cloud_out(parent_subsample(c, o)), k21_fns)
        rows[-1]["span_ms"] = span_ms(torch, cs, lambda c=cloud, o=cap: prefilter.uniform_subsample(c, o))
        for name, kw in VARIANTS:
            check(f"K21 variant, {name}, at {what}", lambda c=cloud, o=cap, kw=kw: cloud_out(variants.run(c, o, **kw)),
                  lambda c=cloud, o=cap: cloud_out(parent_subsample(c, o)), ("subsample_cluster", "count_partials",
                                                                           "rows_from_partials"))
            rows[-1]["span_ms"] = span_ms(torch, cs, lambda c=cloud, o=cap, kw=kw: variants.run(c, o, **kw))
        print("  device spans, first kernel's start to last kernel's end (ms): "
              + "; ".join(f"{r['check'].split(', at ')[0]} {r['span_ms']:.4f}" for r in rows if "span_ms" in r
                          and what in r["check"]), flush=True)

    # K21 on subsample_cases
    for name, pts, m, out_cap in cs.subsample_cases():
        cloud = PointCloud(*(torch.from_numpy(t).to(dev) for t in (pts[:, :3].copy(), pts[:, 3].copy(), m)))
        check(f"K21 on subsample_cases {name}", lambda c=cloud, o=out_cap: cloud_out(prefilter.uniform_subsample(c, o)),
              lambda c=cloud, o=out_cap: cloud_out(parent_subsample(c, o)))

    # K21 over a host-DLO pass's subsamples (phase 8a's)
    odo = DirectLidarOdometry(cfg.odometry, pf, device=dev)
    clouds, sub = [], odo._subsample
    odo._subsample = lambda c: clouds.append(c) or sub(c)
    for i, scan in enumerate(scans):
        odo.process(PointCloud.from_numpy(scan, cap=pf.raw_cap, device=dev), i * 0.1)
    traced_total(f"K21 over a {len(scans)}-scan host-DLO pass's {len(clouds)} subsamples, replayed",
                 [(c, k) for c in clouds], lambda c, o: cloud_out(prefilter.uniform_subsample(c, o)),
                 lambda c, o: cloud_out(parent_subsample(c, o)))

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, commit=args.commit, rows=rows), indent=1))
    if failed:
        print(f"window_subsample_parent: not bit-identical on {failed}", flush=True)
        return 1
    n = sum(1 for r in rows if "bit_identical" in r)
    print(f"window_subsample_parent: all {n} checks bit-identical to the parent tree's routes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
