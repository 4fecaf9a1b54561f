#!/usr/bin/env python3
"""Holds kernel 9k (the sorted grid's k-NN search with its 2-point lines and
3-point planes, `lv_slam_tpu_torch/csrc/knn_grid.cu`), kernel 10g (the fits
over the same grid, `csrc/lfa_fit.cu`) and kernel 16 (RANSAC floor
detection, `csrc/floor.cu`) bit for bit against an earlier tree's kernels
on one NVIDIA GPU, and times both side by side.

    python scripts/knn_floor_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/knn_floor_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc`. Where it is missing and the checkout has git, the
script writes `knn_grid.cu`, `knn_search.cuh`, `lfa_fit.cu`, `floor.cu`,
`common.cuh` and `linalg3.cuh` there from `git show C:...` (C defaults to
00aa305, the tree whose k-NN search ran one thread a query and whose floor
detection took three launches, its finish on one block); on a copy without
git, unpack it first (`git archive C lv_slam_tpu_torch/csrc | tar -x -C
DIR`). It builds `knn_grid.cu`, `lfa_fit.cu` and `floor.cu` with
`kernels/_build.py`'s nvcc flags into `_cache/knn_floor_parent/` (three
nvcc processes, started together) and runs the earlier kernels through the
shipped wrappers (the k-NN and grid-fit entries keep their C signatures)
or, for the floor, through the earlier wrapper's call.

Checks, every one bit for bit (float bits, flags, counts):
- K9k's three entries at chip_smoke.py phase 2e's shapes (scan 0's
  less-sharp and less-flat grids, scan 1's 768 sharp and 1536 flat queries;
  `knn` at k = 1, 2, 3, 5 and 8 on the flat ones), at phase 10a's GICP
  shapes (scans 40 and 41 through the flagship prefilter, 131072-lane grids
  at 1 m: the source covariances' k = 8, the matches' k = 1, the matches'
  neighbourhoods' k = 8) and on every `chip_smoke.knn_cases` entry;
- K10g at phase 2j's shapes (scan 3's grids at its true pose, scan 4's
  queries, k = 5);
- K16 on phase 2g's scan 0, on phase 9b's 170 scans (each through the
  flagship prefilter, as `LvSlam` hands them to floor detection) and on
  every `chip_smoke.floor_cases` entry; the earlier kernel's coefficient
  bits are printed as `chip_smoke.FLOOR_PARENT_COEFFS` holds them.

Times, device-only medians over the whole calls among 20 in a
torch.profiler trace (`chip_smoke.device_ms`): the shipped kernels' own
launches beside the earlier route's whole device work, for a round of
lines and planes at 2e's shapes, the three GICP calls, K16 on scan 0; and
traced totals (`chip_smoke.trace_rows`) of both routes over phase 7a's whole
standalone LFA run (its 676 K9k launches) and over 9b's 170 floor
detections. Prints one line per check and timing and writes them as JSON
to FILE (default `chiprun_out/knn_floor_parent.json`), beside the card's
name and power limit.
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

COMMIT = "00aa305"  # the tree before the redesign
SOURCES = ("knn_grid.cu", "knn_search.cuh", "lfa_fit.cu", "floor.cu", "common.cuh", "linalg3.cuh")
LIBRARIES = ("knn_grid.cu", "lfa_fit.cu", "floor.cu")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K9K_FUNCTIONS = ("knn_query", "knn_lines", "knn_planes")
K16_FUNCTIONS = ("floor_hypotheses", "floor_count", "floor_finish")  # the earlier three and the shipped two


class Parent:
    """The earlier tree's kernels over its libraries."""

    def __init__(self, torch, libs):
        self.torch, self.libs = torch, libs
        fn = libs["floor.cu"].lvs_floor
        fn.argtypes, fn.restype = [P, P, I, P, I, F, F, F, F, F, P, P, P, P, P, P], ctypes.c_int

    @contextlib.contextmanager
    def kernels(self):
        """The shipped k-NN and grid-fit wrappers over the earlier libraries' entries."""
        from lv_slam_tpu_torch.lfa import registration
        from lv_slam_tpu_torch.ops import knn

        swapped = ((knn.KNN_KERNEL, self.libs["knn_grid.cu"]), (registration.GRID_FITS_KERNEL, self.libs["lfa_fit.cu"]))
        saved = [k._fns for k, _ in swapped]
        for k, lib in swapped:
            fns = {}
            for entry, argtypes in k._argtypes.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = [*argtypes, P], ctypes.c_int
                fns[entry] = fn
            k._fns = fns
        try:
            yield
        finally:
            for (k, _), fns in zip(swapped, saved):
                k._fns = fns

    def detect_floor(self, cloud, n_hypotheses: int = 256):
        """The earlier `detect_floor` on CUDA (the defaults of ops/floor.py): three launches."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops import floor

        torch = self.torch
        n = cloud.cap
        xyz, mask = cloud.xyz.contiguous(), cloud.mask.contiguous()
        idx = floor._triples(0, n, n_hypotheses, xyz.device)
        dev = xyz.device
        counts = torch.empty((n_hypotheses,), dtype=torch.int32, device=dev)
        planes = torch.empty((n_hypotheses, 4), dtype=torch.float32, device=dev)
        coeffs = torch.empty((4,), dtype=torch.float32, device=dev)
        stats = torch.empty((2,), dtype=torch.int32, device=dev)
        found = torch.empty((), dtype=torch.bool, device=dev)
        err = self.libs["floor.cu"].lvs_floor(
            ptr(xyz), ptr(mask), n, ptr(idx), n_hypotheses, 1.73, 1.0, 0.1, floor._cos_thresh(10.0), 0.1,
            ptr(planes), ptr(counts), ptr(coeffs), ptr(stats), ptr(found),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the earlier lvs_floor failed with CUDA error {err}")
        return floor.FloorResult(coeffs, stats[0], found, stats[1])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "knn_floor_parent.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("knn_floor_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.lfa import features, registration
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL
    from lv_slam_tpu_torch.ops import floor, knn, prefilter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    csrc = fetch_parent(args.parent or ROOT / "_cache" / "knn_floor_parent" / args.commit, args.commit, SOURCES)
    parent = Parent(torch, build(csrc, LIBRARIES, ROOT / "_cache" / "knn_floor_parent"))
    cfg = kitti_flagship_config()
    pf, lfa = cfg.prefilter, cfg.lfa
    scans, gt = cs.load_scans(cs.N_FULL)
    rows, failed = [], []

    def earlier(fn):
        def run():
            with parent.kernels():
                return fn()
        return run

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

    def traced_total(name, shipped, parent_fn, functions):
        """Both routes' summed device time of `functions` over one traced run each."""
        row = dict(check=name, traced=True)
        for key, fn in (("ms", shipped), ("parent_ms", parent_fn)):
            trace = cs.trace_rows(torch, fn)
            hit = [(t, c) for t, k, c in trace if any(cs._is_function(k, f) for f in functions)]
            row[key], row[key.replace("ms", "launches")] = sum(t for t, _ in hit) / 1e3, sum(c for _, c in hit)
        rows.append(row)
        print(f"{name}: shipped {row['ms']:.3f} ms over {row['launches']} launches, parent {row['parent_ms']:.3f} ms "
              f"over {row['parent_launches']}", flush=True)

    # K9k at phase 2e's shapes
    raw = [PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev) for i in range(5)]
    feats = [features.extract_features(c, lfa) for c in raw]
    f0, f1 = feats[0], feats[1]
    ge = knn.build_grid(f0.less_sharp, f0.less_sharp_mask, _GRID_CELL)
    gs = knn.build_grid(f0.less_flat, f0.less_flat_mask, _GRID_CELL)
    guess = torch.eye(4, dtype=torch.float32, device=dev)
    ye, ys = se3.transform_points(guess, f1.sharp), se3.transform_points(guess, f1.flat)

    def round_2e():
        return (registration.lines_from_2nn(ye, f1.sharp_mask, ge), registration.planes_from_3nn(ys, f1.flat_mask, gs))

    check("K9k round at phase 2e's shapes (768 sharp + 1536 flat queries)", round_2e, earlier(round_2e), K9K_FUNCTIONS)
    for k in (1, 2, 3, 5, 8):
        check(f"K9k knn k = {k}, 2e's flat queries", lambda k=k: knn.knn(gs, ys, k), earlier(lambda k=k: knn.knn(gs, ys, k)))

    # K9k at phase 10a's GICP shapes
    target, source, _, guess10 = cs.registration_pair(torch, scans, gt, dev)
    tgt, tm = target.masked_xyz().contiguous(), target.mask.contiguous()
    src, sm = source.masked_xyz().contiguous(), source.mask.contiguous()
    tg, sg = knn.build_grid(tgt, tm, 1.0), knn.build_grid(src, sm, 1.0)
    y = se3.transform_points_fma(guess10, src)
    nn = knn.knn(tg, y, 1)[1][:, 0].contiguous()
    for name, fn in (("source covariances, k = 8", lambda: knn.knn(sg, src, 8)),
                     ("matches, k = 1", lambda: knn.knn(tg, y, 1)),
                     ("the matches' neighbourhoods, k = 8", lambda: knn.knn(tg, nn, 8))):
        check(f"K9k knn at 10a's GICP shapes ({tg.keys.shape[0]} lanes): {name}", fn, earlier(fn), ("knn_query",))

    # K9k on knn_cases
    for name, *arrays in cs.knn_cases():
        def case(inputs=cs.knn_case_inputs(torch, *arrays, dev)):
            return cs.knn_case_outputs(torch, inputs, False)[1:]
        check(f"knn_cases {name}", case, earlier(case))

    # K10g at phase 2j's shapes
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    poses = [torch.from_numpy(p).to(dev) for p in rel[:5]]
    f3, f4 = feats[3], feats[4]
    g3e = knn.build_grid_ref(se3.transform_points(poses[3], f3.less_sharp), f3.less_sharp_mask, _GRID_CELL)
    g3s = knn.build_grid_ref(se3.transform_points(poses[3], f3.less_flat), f3.less_flat_mask, _GRID_CELL)
    y4e, y4s = se3.transform_points(poses[4], f4.sharp), se3.transform_points(poses[4], f4.flat)

    def fits():
        return (registration.lines_from_fit(y4e, f4.sharp_mask, g3e, lfa.knn_k),
                registration.planes_from_fit(y4s, f4.flat_mask, g3s, lfa.knn_k))

    check("K10g grid fits at phase 2j's shapes", fits, earlier(fits))

    # K16: phase 2g's scan 0, floor_cases, phase 9b's scans
    def filtered(i):
        return prefilter.prefilter(PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev), pf)

    band = prefilter.distance_filter(PointCloud.from_numpy(scans[0], cap=pf.raw_cap, device=dev),
                                     pf.distance_near_thresh, pf.distance_far_thresh)
    scan0 = prefilter.voxel_downsample(band, pf.downsample_resolution, pf.out_cap)
    coeffs = {}
    check("K16 on phase 2g's scan 0 (131072 lanes)", lambda: floor.detect_floor(scan0),
          lambda: parent.detect_floor(scan0), cs.DEVICE_FUNCTIONS["detect_floor"])
    rows[-1]["parent_split_ms"] = {f: cs.device_ms(torch, lambda: parent.detect_floor(scan0), (f,))[0]
                                   for f in K16_FUNCTIONS}
    print(f"  the earlier kernel's split: {rows[-1]['parent_split_ms']}", flush=True)
    rows[-1]["split_ms"] = {f: cs.device_ms(torch, lambda: floor.detect_floor(scan0), (f,))[0]
                            for f in cs.DEVICE_FUNCTIONS["detect_floor"]}
    print(f"  the shipped kernel's split: {rows[-1]['split_ms']}", flush=True)
    coeffs["scan 0"] = cs.floor_bits(torch, parent.detect_floor(scan0).coeffs)
    for name, pts, mask, n_hyp in cs.floor_cases():
        cloud = PointCloud(torch.from_numpy(pts).to(dev), torch.zeros(len(pts), device=dev),
                           torch.from_numpy(mask).to(dev))
        check(f"floor_cases {name}", lambda c=cloud, h=n_hyp: floor.detect_floor(c, n_hypotheses=h),
              lambda c=cloud, h=n_hyp: parent.detect_floor(c, n_hypotheses=h))
        coeffs[name] = cs.floor_bits(torch, parent.detect_floor(cloud, n_hypotheses=n_hyp).coeffs)
    clouds = [filtered(i) for i in range(len(scans))]
    bad = [i for i, c in enumerate(clouds) if differ(torch, floor.detect_floor(c), parent.detect_floor(c))]
    rows.append(dict(check=f"K16 on phase 9b's {len(clouds)} scans", bit_identical=not bad, differ=bad))
    print(f"K16 on phase 9b's {len(clouds)} scans: {'bit-identical' if not bad else f'DIFFERS on scans {bad}'}",
          flush=True)
    if bad:
        failed.append("K16 on 9b's scans")
    traced_total(f"K16 over phase 9b's {len(clouds)} detections", lambda: [floor.detect_floor(c) for c in clouds],
                 lambda: [parent.detect_floor(c) for c in clouds], K16_FUNCTIONS)
    print("FLOOR_PARENT_COEFFS = " + json.dumps(coeffs), flush=True)

    # phase 7a's whole standalone run, both routes traced
    xyz, mask, _, _ = cs.stack_scans(torch, scans, pf.raw_cap, dev)

    def run_7a():
        return cs.run_lfa_chunks(torch, xyz, mask, lfa)

    poses_now, poses_then = run_7a(), earlier(run_7a)()
    torch.cuda.synchronize()
    same = torch.equal(poses_now, poses_then)
    rows.append(dict(check="phase 7a's poses, shipped and earlier K9k", bit_identical=same))
    print(f"phase 7a's {len(scans)} poses with the shipped and the earlier K9k: "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        failed.append("7a poses")
    traced_total(f"K9k over phase 7a's {len(scans)}-scan run", run_7a, earlier(run_7a), K9K_FUNCTIONS)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, commit=args.commit, rows=rows, floor_parent_coeffs=coeffs),
                                   indent=1))
    if failed:
        print(f"knn_floor_parent: not bit-identical on {failed}", flush=True)
        return 1
    n = sum(1 for r in rows if "bit_identical" in r)
    print(f"knn_floor_parent: all {n} checks bit-identical to the parent tree's kernels", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
