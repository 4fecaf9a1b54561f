#!/usr/bin/env python3
"""Holds kernel 0a's prefilter front (`lv_slam_tpu_torch/csrc/angle_calibration.cu`
`lvs_prefilter_front`: the calibration, the distance band, both in one pass)
and kernel 19a (`csrc/gicp.cu` `lvs_plane_cov`) bit for bit against an
earlier tree's routes on one NVIDIA GPU, and times both side by side.

    python scripts/prefilter_gicp_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/prefilter_gicp_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc` and `lv_slam_tpu_torch/ops/prefilter.py`. Where they
are missing and the checkout has git, the script writes the sources it
builds, their headers and `prefilter.py` there from `git show C:...` (C
defaults to 8b6dbe9, the tree whose calibration was one thread a lane,
whose band was plain torch, whose plane covariances ran every lane of the
target's call and whose eigh3x3 called `cosf`); on a copy without git,
unpack them first (`git archive C lv_slam_tpu_torch/csrc
lv_slam_tpu_torch/ops/prefilter.py | tar -x -C DIR`). It builds that
`angle_calibration.cu`, `gicp.cu`, `voxel_map.cu`, `lfa_fit.cu` and
`floor.cu` with `kernels/_build.py`'s nvcc flags into
`_cache/prefilter_gicp_parent/` (one nvcc process each, started together),
and `scripts/front_variants.cu` and `scripts/cos_reduced_check.cu` against
the checkout's headers. The earlier routes: the calibration's kernel, then
that tree's `distance_filter` (torch ops on the card, compiled from its
source); the plane covariances' kernel with the source's mask, and on every
lane for the target's call; K3's, K10's, K10g's and K16's kernels (sources
unchanged since C) over C's `linalg3.cuh`, bound in place of the shipped
ones.

Checks, every one bit for bit (masks, float bits):
- the front of phase 10c (calibration and band) on each of the circle's 170
  raw scans, and the band alone and the calibration alone on each (phases
  3-5 and 8a);
- each form of the front at 2 and 4 lanes a thread, and at one with the
  point read only where the mask is set (`scripts/front_variants.cu`),
  against the shipped kernel;
- every lane of K19a's source call and every lane that K19b reads of its
  target call (K19b's lane test), at phase 2h's shapes (scans 40 -> 41 at
  the guess);
- phase 10a's GICP align (its 20 iterations) with the earlier K19a route in
  place of the shipped one: the transform, fitness and match count;
- `lvs::cos_reduced` against `cosf` on every float of |x| <= 105615
  (`scripts/cos_reduced_check.cu`);
- kernel 4's eigh where it changed with `cos_reduced`, against C's: K3's
  maps (1 m and 4 m) of every tenth filtered scan, K10's lines and planes on
  every `chip_smoke.fit_cases` entry, K10g's on phase 2h's source grid, K16
  on every `chip_smoke.floor_cases` entry, and 8 scans of the dlo -> LFA
  chain (phases 4-5) and of the host DLO (8a) end to end.

Times (device-only medians over the whole calls among 20 in a
torch.profiler trace, `chip_smoke.device_ms`), in the same call: each of K0a's
three forms (raw scan 40; the band on raw scan 0) at one lane a thread
(shipped), at 2 and 4, and with the point read behind the mask, the earlier calibration kernel, the earlier band's
torch chain (and its device launches a call) and the two in a row; K19a's
source call and its target call beside the earlier kernel's; the
calibration's variants of `scripts/front_variants.cu` (`sincosf`; `fmaf` in
place of the float64 emulation, which is not the twin's arithmetic) beside
the shipped kernel, with the points whose bits differ from it; phase 10a's
GICP align traced with either K19a route (K19a's 21 launches' total); and
the device time and launches of an 8-scan window of the dlo -> LFA chain
(phases 4-5) and of the host DLO (8a) with either band. Prints one line per
check and timing and writes them as JSON to FILE (default
`chiprun_out/prefilter_gicp_parent.json`), beside the card's name and power
limit.
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

from _parent import build, differ, fetch_parent  # noqa: E402  (scripts/_parent.py)

COMMIT = "8b6dbe9"  # the tree before the redesign
EIGH_LIBRARIES = ("voxel_map.cu", "lfa_fit.cu", "floor.cu")  # kernel 4's eigh3x3 besides K19a's
LIBRARIES = ("angle_calibration.cu", "gicp.cu") + EIGH_LIBRARIES
SOURCES = LIBRARIES + ("common.cuh", "linalg3.cuh", "key_sort.cuh", "voxel_keys.cuh", "knn_search.cuh")
CACHE = ROOT / "_cache" / "prefilter_gicp_parent"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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
    """The earlier tree's kernel 0a and kernel 19a, called as their wrappers
    called them."""

    def __init__(self, torch, libs, band):
        self.torch = torch
        self.band = band  # the earlier `distance_filter`: torch ops
        self.cal, self.cov = libs["angle_calibration.cu"], libs["gicp.cu"]
        for fn, args in ((self.cal.lvs_angle_calibration, [P, P, I, F, P, P]),
                         (self.cov.lvs_plane_cov, [P, P, I, I, P, P, P, P])):
            fn.argtypes, fn.restype = args, ctypes.c_int

    def _stream(self):
        return ctypes.c_void_p(self.torch.cuda.current_stream().cuda_stream)

    def calibration(self, cloud, angle_deg):
        from lv_slam_tpu_torch.core.cloud import PointCloud
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops.prefilter import _deg2rad32

        out = self.torch.empty_like(cloud.xyz)
        err = self.cal.lvs_angle_calibration(ptr(cloud.xyz), ptr(cloud.mask), cloud.cap, _deg2rad32(angle_deg),
                                             ptr(out), self._stream())
        if err:
            raise RuntimeError(f"the earlier lvs_angle_calibration failed with CUDA error {err}")
        return PointCloud(out, cloud.intensity, cloud.mask)

    def front(self, cloud, angle_deg, near, far):
        return self.band(self.calibration(cloud, angle_deg), near, far)

    def plane_cov(self, pts, valid, mask=None):
        from lv_slam_tpu_torch.kernels._build import ptr

        torch = self.torch
        n, k = valid.shape
        cov = torch.empty((n, 3, 3), dtype=torch.float32, device=pts.device)
        ok = None if mask is None else torch.empty((n,), dtype=torch.bool, device=pts.device)
        err = self.cov.lvs_plane_cov(ptr(pts), ptr(valid), n, k, None if mask is None else ptr(mask), ptr(cov),
                                     None if ok is None else ptr(ok), self._stream())
        if err:
            raise RuntimeError(f"the earlier lvs_plane_cov failed with CUDA error {err}")
        return cov, ok


class Variants:
    """Kernel 0a's variants (`scripts/front_variants.cu`) and the exhaustive
    check of `lvs::cos_reduced` (`scripts/cos_reduced_check.cu`)."""

    def __init__(self, torch):
        self.torch = torch
        libs = build(ROOT / "lv_slam_tpu_torch" / "csrc",
                     [str(ROOT / "scripts" / name) for name in ("front_variants.cu", "cos_reduced_check.cu")],
                     CACHE / "variants")
        self.lib, self.cos = libs.values()
        for fn, args in ((self.lib.variant_calibration, [P, P, I, F, I, P, P]),
                         (self.lib.variant_front, [P, P, I, I, F, I, F, F, I, P, P, P]),
                         (self.cos.cos_reduced_mismatches, [ctypes.c_uint, P, P, P])):
            fn.argtypes, fn.restype = args, ctypes.c_int

    def _stream(self):
        return ctypes.c_void_p(self.torch.cuda.current_stream().cuda_stream)

    def calibration(self, cloud, angle_deg, variant):
        from lv_slam_tpu_torch.core.cloud import PointCloud
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops.prefilter import _deg2rad32

        out = self.torch.empty_like(cloud.xyz)
        err = self.lib.variant_calibration(ptr(cloud.xyz), ptr(cloud.mask), cloud.cap, _deg2rad32(angle_deg), variant,
                                           ptr(out), self._stream())
        if err:
            raise RuntimeError(f"variant_calibration failed with CUDA error {err}")
        return PointCloud(out, cloud.intensity, cloud.mask)

    def front(self, cloud, angle_deg, band, lanes):
        """The shipped front's form (the calibration by `angle_deg` and / or
        the band (near, far)) at `lanes` (2 or 4) lanes a thread, or at one
        with the point read behind the mask (`lanes` 1)."""
        from lv_slam_tpu_torch.core.cloud import PointCloud
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops.prefilter import _deg2rad32

        torch = self.torch
        out = torch.empty_like(cloud.xyz)
        keep = None if band is None else torch.empty_like(cloud.mask)
        near, far = band if band is not None else (0.0, 0.0)
        err = self.lib.variant_front(ptr(cloud.xyz), ptr(cloud.mask), cloud.cap, int(angle_deg is not None),
                                     0.0 if angle_deg is None else _deg2rad32(angle_deg), int(band is not None),
                                     near, far, lanes, ptr(out), None if keep is None else ptr(keep), self._stream())
        if err:
            raise RuntimeError(f"variant_front failed with CUDA error {err}")
        return PointCloud(out, cloud.intensity, cloud.mask if keep is None else keep)

    def cos_mismatches(self, limit: float = 105615.0):
        """(the floats x of |x| <= limit where cos_reduced(x) and cosf(x)
        differ in a bit, the first 16 of them, the floats checked)."""
        torch = self.torch
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        first = torch.zeros(16, dtype=torch.int32, device="cuda")
        hi = int(np.float32(limit).view(np.uint32))
        err = self.cos.cos_reduced_mismatches(hi, bad.data_ptr(), first.data_ptr(), self._stream())
        if err:
            raise RuntimeError(f"cos_reduced_mismatches failed with CUDA error {err}")
        n = int(bad.item())
        return n, first[:min(n, 16)].cpu().numpy().view(np.float32).tolist(), 2 * (hi + 1)


def bind(lib, entries) -> dict:
    """A `Kernel`'s C entry points (`entries`: name -> argument types) from
    another build of its source, as `Kernel.call` binds them."""
    fns = {}
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
        fns[name] = fn
    return fns


def tensors(out) -> list:
    """The tensors of a (nested) tuple of outputs, in order; other fields
    left out."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensors(o)]
    return []


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "prefilter_gicp_parent.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prefilter_gicp_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
    from lv_slam_tpu_torch.kernels import KERNELS
    from lv_slam_tpu_torch.lfa import registration
    from lv_slam_tpu_torch.odometry import fused
    from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry
    from lv_slam_tpu_torch.ops import floor, gicp, knn, prefilter, voxel_map
    from lv_slam_tpu_torch.ops.knn import CellTable
    from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, sqrt32
    from lv_slam_tpu_torch.ops.registrations import RegistrationParams, select_registration_method
    from lv_slam_tpu_torch.pipeline.fused_chain import run_sequence_chain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    parent_dir = args.parent or CACHE / args.commit
    csrc = fetch_parent(parent_dir, args.commit, SOURCES)
    band = parent_function(parent_dir, args.commit, "distance_filter",
                           dict(torch=torch, SENTINEL=SENTINEL, PointCloud=PointCloud, sqrt32=sqrt32,
                                dot3_fma=dot3_fma))
    libs = build(csrc, LIBRARIES, CACHE)
    parent = Parent(torch, libs, band)
    cfg = kitti_flagship_config()
    pf = cfg.prefilter
    near, far, angle = pf.distance_near_thresh, pf.distance_far_thresh, pf.angle_base
    scans, gt = cs.load_scans(cs.N_FULL)
    rows, failed = [], []
    front_fns = cs.DEVICE_FUNCTIONS["vertical_angle_calibration"]
    cov_fns = cs.DEVICE_FUNCTIONS["_plane_covariances"]

    def record(row, bad):
        rows.append(row)
        if bad:
            failed.append(row["check"])

    def timing(name, shipped, earlier, functions):
        """Both routes timed: the shipped kernel's own launches, the earlier
        route's whole device work and its device launches a call."""
        row = dict(check=name)
        row["ms"], row["wrapper_ms"], _ = cs.device_ms(torch, shipped, functions)
        row["parent_ms"] = cs.device_ms(torch, earlier)[1]
        row["parent_launches"] = cs.foreign_functions(torch, earlier, ())[1]
        rows.append(row)
        print(f"{name}: shipped {row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}), parent {row['parent_ms']:.4f} ms "
              f"over {row['parent_launches']} device launches", flush=True)
        return row

    def cloud_out(c):
        return (c.xyz, c.intensity, c.mask)

    # K0a's front on each of the 170 raw scans: both stages (10c), the band alone (3-5, 8a)
    raws = [PointCloud.from_numpy(s, cap=pf.raw_cap, device=dev) for s in scans]
    for what, shipped, earlier in (
            ("calibration and band (10c)", lambda c: prefilter.calibrated_band(c, angle, near, far),
             lambda c: parent.front(c, angle, near, far)),
            ("band alone (3-5, 8a)", lambda c: prefilter.distance_filter(c, near, far),
             lambda c: parent.band(c, near, far)),
            ("calibration alone", lambda c: prefilter.vertical_angle_calibration(c, angle),
             lambda c: parent.calibration(c, angle))):
        bad = [i for i, c in enumerate(raws) if differ(torch, cloud_out(shipped(c)), cloud_out(earlier(c)))]
        record(dict(check=f"K0a's front, {what}, on the {len(raws)} raw scans", bit_identical=not bad, differ=bad), bad)
        print(f"K0a's front, {what}, on the {len(raws)} raw scans: "
              f"{'bit-identical' if not bad else f'DIFFERS at scans {bad}'}", flush=True)

    # K0a's three forms, shipped (one lane a thread) beside the earlier
    # routes, and their variants (scripts/front_variants.cu): 2 and 4 lanes
    # a thread, and one with the point read only where the mask is set
    variants = Variants(torch)
    raw, raw3 = raws[cs.PAIR[0]], raws[0]
    forms = (("calibration", lambda: prefilter.vertical_angle_calibration(raw, angle), raw, angle, None,
              lambda: parent.calibration(raw, angle)),
             ("band", lambda: prefilter.distance_filter(raw3, near, far), raw3, None, (near, far),
              lambda: parent.band(raw3, near, far)),
             ("calibration and band", lambda: prefilter.calibrated_band(raw, angle, near, far), raw, angle,
              (near, far), lambda: parent.front(raw, angle, near, far)))
    for what, shipped, cloud, a, b, earlier in forms:
        size = f"({int(cloud.mask.sum())} points in {cloud.cap} lanes)"
        row = timing(f"K0a's {what}, shipped {size}", shipped, earlier, front_fns)
        row.update(lanes=1)
        for lanes in (1, 2, 4):
            fn = (lambda c=cloud, a=a, b=b, n=lanes: variants.front(c, a, b, n))
            how = "one lane a thread, the point read behind the mask" if lanes == 1 else f"{lanes} lanes a thread"
            bad = differ(torch, cloud_out(fn()), cloud_out(shipped()))
            record(dict(check=f"K0a's {what} at {how} against the shipped kernel", bit_identical=not bad,
                        differ=bad), bad)
            row = timing(f"K0a's {what} at {how} {size} (variant; 'parent': the shipped kernel)", fn, shipped,
                         ("front_masked_read",) if lanes == 1 else ("front_lanes",))
            row.update(lanes=lanes, variant=True)
            if bad:
                print(f"  DIFFERS from the shipped kernel in outputs {bad}", flush=True)

    # the calibration's variants (scripts/front_variants.cu): sincosf, and
    # fmaf in place of the float64 emulation (not the twin's bits: what the
    # emulation costs)
    shipped_cal = prefilter.vertical_angle_calibration(raw, angle)
    for name, v in (("sincosf", 0), ("fmaf for every float64-rounded fma (other bits)", 1)):
        got = variants.calibration(raw, angle, v)
        n_diff = int((got.xyz.view(torch.int32) != shipped_cal.xyz.view(torch.int32)).any(1).sum())
        row = timing(f"K0a's calibration variant, {name}", lambda v=v: variants.calibration(raw, angle, v),
                     lambda: prefilter.vertical_angle_calibration(raw, angle), ("front_variant",))
        row.update(variant=True, lanes_differing_from_shipped=n_diff)
        print(f"  (the 'parent' column above is the shipped kernel's whole device time; {n_diff} of "
              f"{int(raw.mask.sum())} points differ from the shipped kernel's bits)", flush=True)

    # K19a at phase 2h's shapes: the source call, and the target call on K19b's lanes
    target, source, _, guess = cs.registration_pair(torch, scans, gt, dev)
    src, mask = source.masked_xyz().contiguous(), source.mask.contiguous()
    tgt_grid = knn.build_grid(target.masked_xyz(), target.mask, 1.0)
    _, pts, valid = knn.knn(knn.build_grid(src, mask, 1.0), src, 8)
    (cov, ok), (cov_p, ok_p) = gicp.regularized_covariances(pts, valid, mask), parent.plane_cov(pts, valid, mask)
    bad = differ(torch, (cov, ok), (cov_p, ok_p))
    record(dict(check=f"K19a's source call ({int(mask.sum())} of {mask.numel()} lanes masked in): every lane",
                bit_identical=not bad, differ=bad), bad)
    print(f"{rows[-1]['check']}: {'bit-identical' if not bad else f'DIFFERS in outputs {bad}'}", flush=True)
    timing("K19a's source call", lambda: gicp.regularized_covariances(pts, valid, mask),
           lambda: parent.plane_cov(pts, valid, mask), cov_fns)
    from lv_slam_tpu_torch.core import se3

    y = se3.transform_points_fma(guess, src)
    dists, nn_pts, nn_valid = knn.knn(tgt_grid, y, 1)
    _, nbrs, nbr_valid = knn.knn(tgt_grid, nn_pts[:, 0].contiguous(), 8)
    need = gicp.LaneTest(mask & ok, nn_valid[:, 0].contiguous(), dists[:, 0].contiguous(), 2.0)
    lanes = need.lanes()
    got, _ = gicp.regularized_covariances(nbrs, nbr_valid, need=need)
    want, _ = parent.plane_cov(nbrs, nbr_valid)
    bad = differ(torch, got[lanes], want[lanes])
    record(dict(check=f"K19a's target call: the {int(lanes.sum())} lanes that K19b reads", bit_identical=not bad,
                differ=bad), bad)
    print(f"{rows[-1]['check']}: {'bit-identical' if not bad else 'DIFFERS'}", flush=True)
    timing("K19a's target call (shipped: K19b's lanes; parent: every lane)",
           lambda: gicp.regularized_covariances(nbrs, nbr_valid, need=need),
           lambda: parent.plane_cov(nbrs, nbr_valid), cov_fns)

    # phase 10a's GICP align with either K19a route
    reg = select_registration_method(
        RegistrationParams(registration_method="GICP", max_iterations=40, ndt_nn_search_method="DIRECT7"))
    shipped_cov = gicp.regularized_covariances

    def earlier_cov(pts, valid, mask=None, need=None):  # the earlier target call ran every lane
        return parent.plane_cov(pts.contiguous(), valid.contiguous(), None if mask is None else mask.contiguous())

    results, traced = {}, {}
    for key, fn in (("shipped", shipped_cov), ("parent", earlier_cov)):
        gicp.regularized_covariances = fn
        try:
            results[key] = reg(target, source, guess)
            trace = cs.trace_rows(torch, lambda: reg(target, source, guess))
        finally:
            gicp.regularized_covariances = shipped_cov
        cov_rows = [(t, c) for t, k, c in trace if any(cs._is_function(k, f) for f in cov_fns)]
        traced[key] = dict(ms=sum(t for t, _ in cov_rows) / 1e3, launches=sum(c for _, c in cov_rows),
                           align_ms=sum(t for t, k, _ in trace if cs.MARKER not in k) / 1e3)
    bad = differ(torch, tuple(results["shipped"]), tuple(results["parent"]))
    record(dict(check="phase 10a's GICP align (20 iterations): transform, fitness, matches", bit_identical=not bad,
                differ=bad, traced=traced), bad)
    print(f"{rows[-1]['check']}: {'bit-identical' if not bad else f'DIFFERS in outputs {bad}'}; K19a traced "
          f"{traced['shipped']['ms']:.4f} ms over {traced['shipped']['launches']} launches (parent "
          f"{traced['parent']['ms']:.4f} over {traced['parent']['launches']}); the align's device work "
          f"{traced['shipped']['align_ms']:.4f} ms (parent {traced['parent']['align_ms']:.4f})", flush=True)

    # lvs::cos_reduced against cosf, every float of |x| <= 105615
    n_bad, first, n_checked = variants.cos_mismatches()
    record(dict(check=f"cos_reduced against cosf on all {n_checked} floats of |x| <= 105615",
                bit_identical=not n_bad, mismatches=n_bad, first=first), n_bad)
    print(f"{rows[-1]['check']}: {'bit-identical' if not n_bad else f'{n_bad} DIFFER, first {first}'}", flush=True)

    # kernel 4's eigh where it changed with cos_reduced (K3, K10, K10g, K16:
    # sources unchanged since the parent but for linalg3.cuh), against the
    # same sources over the parent's linalg3.cuh
    eigh_kernels = [k for k in KERNELS.values() if Path(k.source).name in EIGH_LIBRARIES]
    parent_fns = {k.name: bind(libs[Path(k.source).name], k._argtypes) for k in eigh_kernels}

    def eigh_check(what, fn):
        got = fn()
        saved = {k.name: k._fns for k in eigh_kernels}
        try:
            for k in eigh_kernels:
                k._fns = parent_fns[k.name]
            want = fn()
        finally:
            for k in eigh_kernels:
                k._fns = saved[k.name]
        bad = differ(torch, tensors(got), tensors(want))
        record(dict(check=f"kernel 4's eigh, {what}", bit_identical=not bad, differ=bad), bad)
        print(f"{rows[-1]['check']}: {'bit-identical' if not bad else f'DIFFERS in outputs {bad}'}", flush=True)

    filtered = [prefilter.prefilter(raws[i], pf) for i in range(0, len(raws), 10)]
    for res in (1.0, 4.0):
        eigh_check(f"K3's maps at {res} m of {len(filtered)} filtered scans (every tenth)",
                   lambda res=res: [voxel_map.build_voxel_map(c, res) for c in filtered])
    fits = []
    for _, table, y, m, k in cs.fit_cases():
        grid = CellTable(torch.from_numpy(table).to(dev), cs.FIT_CELL)
        y, m = torch.from_numpy(y).to(dev), torch.from_numpy(m).to(dev)
        fits.append(lambda y=y, m=m, grid=grid, k=k: (registration.lines_from_fit(y, m, grid, k=k),
                                                      registration.planes_from_fit(y, m, grid, k=k)))
    eigh_check(f"K10's lines and planes on the {len(fits)} fit_cases", lambda: [f() for f in fits])
    src_grid = knn.build_grid(src, mask, 1.0)
    y_fit = target.masked_xyz()[:8192].contiguous()
    m_fit = target.mask[:8192].contiguous()
    eigh_check(f"K10g's lines and planes, {int(m_fit.sum())} of scan {cs.PAIR[0]}'s points on scan "
               f"{cs.PAIR[1]}'s 1 m grid", lambda: (registration.lines_from_fit(y_fit, m_fit, src_grid),
                                                  registration.planes_from_fit(y_fit, m_fit, src_grid)))
    floors = []
    for _, pts_f, mask_f, n_hyp in cs.floor_cases():
        c = PointCloud(torch.from_numpy(pts_f).to(dev), torch.zeros(len(pts_f), device=dev),
                       torch.from_numpy(mask_f).to(dev))
        floors.append(lambda c=c, n_hyp=n_hyp: floor.detect_floor(c, n_hypotheses=n_hyp))
    eigh_check(f"K16 on the {len(floors)} floor_cases", lambda: [f() for f in floors])
    xyz8, m8, stamps8, inten8 = cs.stack_scans(torch, scans[:8], pf.raw_cap, dev)
    eigh_check("8 scans of the dlo -> LFA chain (phases 4-5), every output",
               lambda: run_sequence_chain(xyz8, m8, stamps8, cfg.odometry, pf, cfg.lfa, inten=inten8, device=dev,
                                          return_filtered=True))

    def dlo_poses():
        odo = DirectLidarOdometry(cfg.odometry, pf, device=dev)
        for i in range(8):
            odo.process(raws[i], i * 0.1)
        return [torch.from_numpy(np.stack(odo.poses))]

    eigh_check("8 scans of the host DLO (8a), its poses", dlo_poses)

    # the band's share of an 8-scan window: the chain (phases 4-5) and the host DLO (8a)
    shipped_band = prefilter.distance_filter

    def chain():
        run_sequence_chain(xyz8, m8, stamps8, cfg.odometry, pf, cfg.lfa, inten=inten8, device=dev)

    def host_dlo():
        odo = DirectLidarOdometry(cfg.odometry, pf, device=dev)
        for i in range(8):
            odo.process(raws[i], i * 0.1)

    for what, fn in (("the dlo -> LFA chain (phases 4-5)", chain), ("the host DLO (8a)", host_dlo)):
        row = dict(check=f"8 scans of {what}", traced=True)
        for key, b in (("", shipped_band), ("parent_", parent.band)):
            fused.distance_filter = prefilter.distance_filter = b
            try:
                fn()
                trace = [(t, k, c) for t, k, c in cs.trace_rows(torch, fn) if cs.MARKER not in k]
            finally:
                fused.distance_filter = prefilter.distance_filter = shipped_band
            row[f"{key}ms"] = sum(t for t, _, _ in trace) / 1e3
            row[f"{key}launches"] = sum(c for _, _, c in trace)
        rows.append(row)
        print(f"{row['check']}: device busy {row['ms']:.3f} ms over {row['launches']} launches with the band's "
              f"kernel; {row['parent_ms']:.3f} ms over {row['parent_launches']} with the earlier torch band",
              flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, commit=args.commit, rows=rows), indent=1))
    if failed:
        print(f"prefilter_gicp_parent: not bit-identical on {failed}", flush=True)
        return 1
    n = sum(1 for r in rows if "bit_identical" in r)
    print(f"prefilter_gicp_parent: all {n} checks bit-identical to the parent tree's routes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
