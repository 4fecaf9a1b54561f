#!/usr/bin/env python3
"""Holds kernel 9g (the sorted k-NN grid's build, `lv_slam_tpu_torch/csrc/knn_grid.cu`)
and kernel 9c (the host mapping's cell-table build, `csrc/cell_table.cu`)
bit for bit against an earlier tree's routes on one NVIDIA GPU, and times
both side by side.

    python scripts/grid_table_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/grid_table_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc`. Where it is missing and the checkout has git, the
script writes `knn_grid.cu`, `knn_search.cuh`, `cell_table.cu` and
`common.cuh` there from `git show C:...` (C defaults to f6d6cf8, the tree
whose grid and table builds sorted their keys with `torch.sort` between two
C calls); on a copy without git, unpack it first (`git archive C
lv_slam_tpu_torch/csrc | tar -x -C DIR`). It builds `knn_grid.cu` and
`cell_table.cu` with `kernels/_build.py`'s nvcc flags into
`_cache/grid_table_parent/` (two nvcc processes, started together) and runs
the earlier routes as their wrappers ran them: `lvs_knn_grid_keys`, a
stable `torch.sort` of the int32 keys, `lvs_knn_grid_gather`; and
`lvs_table_keys`, a stable `torch.sort` of the buckets, `lvs_table_build`.

Checks, every one bit for bit (keys, float bits, origin, tables):
- K9g at chip_smoke.py phase 2e's shapes (scan 0's 4096 less-sharp and 8064
  less-flat features: the one-launch cluster route) and at phase 10a's
  GICP shapes (scans 40 and 41 through the flagship prefilter, 131072-lane
  grids at 1 m: the key sort's route), and on every `chip_smoke.knn_cases`
  grid;
- K9c at phase 2e's shapes (the host mapping's 32768-row edge and
  65536-row surf buffers after scans 0-3 of `LfaPipeline`), on the mapping
  buffers of `LvSlam(use_dlo=False)` after 12 scans, and on every
  `chip_smoke.table_cases` entry;
- phase 7a's 170 poses (standalone LFA) with either K9g.

Times, the earlier route's whole device work (its torch.sort included) and
the shipped kernels' own launches, in the same call (device-only medians
over the whole calls among 20 in a torch.profiler trace, `chip_smoke.device_ms`):
K9g at 2e's two grids and at 10a's target grid, K9c at both maps; and
traced totals (`chip_smoke.trace_rows`, every kernel of the trace) of both
routes replaying the builds of phase 7a's whole standalone LFA run (K9g's
340) and of a 170-scan pass of `LvSlam(use_dlo=False)` without images
(K9c's 338), each with the library's onesweep launches. Prints one line per check and timing and
writes them as JSON to FILE (default `chiprun_out/grid_table_parent.json`),
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from _parent import build, differ, fetch_parent  # noqa: E402  (scripts/_parent.py)

COMMIT = "f6d6cf8"  # the tree before the redesign
SOURCES = ("knn_grid.cu", "knn_search.cuh", "cell_table.cu", "common.cuh")
LIBRARIES = ("knn_grid.cu", "cell_table.cu")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ONESWEEP = "DeviceRadixSortOnesweepKernel"


class Parent:
    """The earlier tree's K9g and K9c routes: its C entries around `torch.sort`."""

    def __init__(self, torch, libs):
        self.torch = torch
        self.grid_lib, self.table_lib = libs["knn_grid.cu"], libs["cell_table.cu"]
        for fn, args in ((self.grid_lib.lvs_knn_grid_keys, [P, P, I, F, P, P, P, P]),
                         (self.grid_lib.lvs_knn_grid_gather, [P, P, I, P, P]),
                         (self.table_lib.lvs_table_keys, [P, P, I, I, F, P, P]),
                         (self.table_lib.lvs_table_build, [P, P, P, I, I, I, P, P])):
            fn.argtypes, fn.restype = args, ctypes.c_int

    def _stream(self):
        return ctypes.c_void_p(self.torch.cuda.current_stream().cuda_stream)

    def _check(self, err, entry):
        if err:
            raise RuntimeError(f"the earlier {entry} failed with CUDA error {err}")

    def build_grid(self, xyz, mask, cell_size):
        """The earlier `build_grid` on CUDA: keys, torch.sort, gather."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops import knn
        from lv_slam_tpu_torch.ops.cells import inv_resolution

        torch = self.torch
        n, dev = xyz.shape[0], xyz.device
        xyz, mask = xyz.contiguous(), mask.contiguous()
        keys = torch.empty((n,), dtype=torch.int32, device=dev)
        low = torch.empty((3,), dtype=torch.int32, device=dev)
        origin = torch.empty((3,), dtype=torch.int32, device=dev)
        self._check(self.grid_lib.lvs_knn_grid_keys(ptr(xyz), ptr(mask), n, inv_resolution(cell_size), ptr(low),
                                                    ptr(origin), ptr(keys), self._stream()), "lvs_knn_grid_keys")
        skeys, order = torch.sort(keys, stable=True)
        out = torch.empty((n, 3), dtype=torch.float32, device=dev)
        self._check(self.grid_lib.lvs_knn_grid_gather(ptr(order), ptr(xyz), n, ptr(out), self._stream()),
                    "lvs_knn_grid_gather")
        return knn.KnnGrid(keys=skeys, xyz=out, origin_cell=origin, cell_size=float(np.float32(cell_size)))

    def build_cell_table(self, xyz, mask, cell_size, n_buckets=None, slots=8):
        """The earlier `build_cell_table` on CUDA: buckets, torch.sort, clear and place."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops import knn
        from lv_slam_tpu_torch.ops.cells import inv_resolution

        torch = self.torch
        n, dev = xyz.shape[0], xyz.device
        n_buckets = n_buckets or knn._default_buckets(n)
        xyz, mask = xyz.contiguous(), mask.contiguous()
        b = torch.empty((n,), dtype=torch.int32, device=dev)
        self._check(self.table_lib.lvs_table_keys(ptr(xyz), ptr(mask), n, n_buckets, inv_resolution(cell_size),
                                                  ptr(b), self._stream()), "lvs_table_keys")
        sb, order = torch.sort(b, stable=True)
        table = torch.empty((n_buckets, slots * 4), dtype=torch.float32, device=dev)
        self._check(self.table_lib.lvs_table_build(ptr(sb), ptr(order), ptr(xyz), n, n_buckets, slots, ptr(table),
                                                   self._stream()), "lvs_table_build")
        return knn.CellTable(table=table, cell_size=float(np.float32(cell_size)))

    @contextlib.contextmanager
    def routes(self):
        """The earlier routes in place of the shipped ones, where the port's modules call them."""
        from lv_slam_tpu_torch.lfa import mapping, odometry
        from lv_slam_tpu_torch.ops import gicp, knn

        swapped = [(m, "build_grid", self.build_grid) for m in (knn, odometry, gicp)]
        swapped += [(m, "build_cell_table", self.build_cell_table) for m in (knn, mapping)]
        saved = [(m, name, getattr(m, name)) for m, name, _ in swapped]
        for m, name, fn in swapped:
            setattr(m, name, fn)
        try:
            yield
        finally:
            for m, name, fn in saved:
                setattr(m, name, fn)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "grid_table_parent.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grid_table_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.lfa import LfaPipeline, features
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL, _n_buckets
    from lv_slam_tpu_torch.ops import knn
    from lv_slam_tpu_torch.pipeline.slam import LvSlam

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    csrc = fetch_parent(args.parent or ROOT / "_cache" / "grid_table_parent" / args.commit, args.commit, SOURCES)
    parent = Parent(torch, build(csrc, LIBRARIES, ROOT / "_cache" / "grid_table_parent"))
    cfg = kitti_flagship_config()
    pf, lfa = cfg.prefilter, cfg.lfa
    scans, gt = cs.load_scans(cs.N_FULL)
    rows, failed = [], []
    grid_fns, table_fns = cs.DEVICE_FUNCTIONS["build_grid"], cs.DEVICE_FUNCTIONS["build_cell_table"]

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
        return got

    def grid_out(g):
        return (g.keys, g.xyz, g.origin_cell)

    def traced_total(name, builds, shipped, earlier):
        """Both routes' whole device time over one traced replay each of
        `builds` (the inputs a run handed the build), every kernel of the
        trace but its lead-in markers: the shipped route's launches, the
        earlier route's with its torch.sort and glue; and their onesweep
        launches."""
        row = dict(check=name, traced=True, builds=len(builds))
        for key, fn in (("", shipped), ("parent_", earlier)):
            trace = [(t, k, c) for t, k, c in cs.trace_rows(torch, lambda: [fn(*b) for b in builds])
                     if cs.MARKER not in k]
            row[f"{key}ms"] = sum(t for t, _, _ in trace) / 1e3
            row[f"{key}launches"] = sum(c for _, _, c in trace)
            row[f"{key}onesweep_launches"] = sum(c for _, k, c in trace if ONESWEEP in k)
        rows.append(row)
        print(f"{name}: shipped {row['ms']:.3f} ms over {row['launches']} device launches ({row['onesweep_launches']} "
              f"onesweep); parent {row['parent_ms']:.3f} ms over {row['parent_launches']} "
              f"({row['parent_onesweep_launches']} onesweep)", flush=True)

    @contextlib.contextmanager
    def recording(module, name, into):
        """`module.name` records its arguments into `into` while it runs."""
        fn = getattr(module, name)

        def record(*a):
            into.append(tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in a))
            return fn(*a)

        setattr(module, name, record)
        try:
            yield
        finally:
            setattr(module, name, fn)

    # K9g at phase 2e's shapes: the one-launch cluster route
    raw = [PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev) for i in range(4)]
    f0 = features.extract_features(raw[0], lfa)
    for what, pts, m in (("less-sharp", f0.less_sharp, f0.less_sharp_mask), ("less-flat", f0.less_flat,
                                                                            f0.less_flat_mask)):
        check(f"K9g at phase 2e's {what} grid ({pts.shape[0]} lanes)",
              lambda p=pts, mm=m: grid_out(knn.build_grid(p, mm, _GRID_CELL)),
              lambda p=pts, mm=m: grid_out(parent.build_grid(p, mm, _GRID_CELL)), grid_fns)

    # K9g at phase 10a's GICP shapes: the key sort's route
    target, source, _, _ = cs.registration_pair(torch, scans, gt, dev)
    for what, cloud in (("target (scan 40)", target), ("source (scan 41)", source)):
        x, m = cloud.masked_xyz().contiguous(), cloud.mask.contiguous()
        check(f"K9g at phase 10a's GICP {what} grid ({x.shape[0]} lanes, {int(m.sum())} valid, 1 m)",
              lambda x=x, m=m: grid_out(knn.build_grid(x, m, 1.0)),
              lambda x=x, m=m: grid_out(parent.build_grid(x, m, 1.0)), grid_fns if "target" in what else None)

    # K9g on knn_cases
    for name, pts, mask, _, _ in cs.knn_cases():
        x, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
        check(f"K9g on knn_cases {name}", lambda x=x, m=m: grid_out(knn.build_grid(x, m, cs.KNN_CELL)),
              lambda x=x, m=m: grid_out(parent.build_grid(x, m, cs.KNN_CELL)))

    # K9c at phase 2e's shapes: the host mapping after scans 0-3
    pipe = LfaPipeline(lfa, device=dev)
    for c in raw:
        pipe.process(c)
    for what, x, m, cap in (("edge", pipe.mapping._edge_map, pipe.mapping._edge_mask, lfa.map_edge_cap),
                            ("surf", pipe.mapping._surf_map, pipe.mapping._surf_mask, lfa.map_planar_cap)):
        nb = _n_buckets(lfa, cap)
        check(f"K9c at phase 2e's {what} map ({x.shape[0]} rows -> {nb} x {lfa.knn_slots})",
              lambda x=x, m=m, nb=nb: knn.build_cell_table(x, m, _GRID_CELL, nb, lfa.knn_slots).table,
              lambda x=x, m=m, nb=nb: parent.build_cell_table(x, m, _GRID_CELL, nb, lfa.knn_slots).table, table_fns)

    # K9c on LvSlam(use_dlo=False)'s mapping buffers after 12 scans
    slam = LvSlam(cfg, use_dlo=False, device=dev)
    for i in range(12):
        slam.process(scans[i], 0.1 * i)
    mp = slam.mapping
    for what, x, m, nb in (("edge", mp._edge_map, mp._edge_mask, mp._edge_buckets),
                           ("surf", mp._surf_map, mp._surf_mask, mp._surf_buckets)):
        check(f"K9c on LvSlam(use_dlo=False)'s {what} buffer after 12 scans ({int(m.sum())} of {m.numel()} rows)",
              lambda x=x, m=m, nb=nb: knn.build_cell_table(x, m, _GRID_CELL, nb, lfa.knn_slots).table,
              lambda x=x, m=m, nb=nb: parent.build_cell_table(x, m, _GRID_CELL, nb, lfa.knn_slots).table)

    # K9c on table_cases
    for name, pts, mask, nb, slots in cs.table_cases():
        x, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
        check(f"K9c on table_cases {name}",
              lambda x=x, m=m, nb=nb, s=slots: knn.build_cell_table(x, m, cs.KNN_CELL, nb, s).table,
              lambda x=x, m=m, nb=nb, s=slots: parent.build_cell_table(x, m, cs.KNN_CELL, nb, s).table)

    # phase 7a's whole standalone run with either K9g, then its 340 builds
    # replayed by both routes in traces
    from lv_slam_tpu_torch.lfa import mapping, odometry

    xyz, mask, _, _ = cs.stack_scans(torch, scans, pf.raw_cap, dev)

    def run_7a():
        return cs.run_lfa_chunks(torch, xyz, mask, lfa)

    grids = []
    with recording(odometry, "build_grid", grids):
        poses_now = run_7a()
    with parent.routes():
        poses_then = run_7a()
    torch.cuda.synchronize()
    same = torch.equal(poses_now, poses_then)
    rows.append(dict(check="phase 7a's poses, shipped and earlier K9g", bit_identical=same))
    print(f"phase 7a's {len(scans)} poses with the shipped and the earlier K9g: "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        failed.append("7a poses")
    traced_total(f"K9g over phase 7a's {len(grids)} builds, replayed", grids, knn.build_grid, parent.build_grid)

    # K9c over a whole LvSlam(use_dlo=False) pass (no images): its builds replayed
    tables = []
    with recording(mapping, "build_cell_table", tables):
        s = LvSlam(cfg, use_dlo=False, device=dev)
        for i, scan in enumerate(scans):
            s.process(scan, 0.1 * i)
        s.finalize()
    traced_total(f"K9c over a {len(scans)}-scan LvSlam(use_dlo=False) pass's {len(tables)} builds, replayed", tables,
                 knn.build_cell_table, parent.build_cell_table)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, commit=args.commit, rows=rows), indent=1))
    if failed:
        print(f"grid_table_parent: not bit-identical on {failed}", flush=True)
        return 1
    n = sum(1 for r in rows if "bit_identical" in r)
    print(f"grid_table_parent: all {n} checks bit-identical to the parent tree's routes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
