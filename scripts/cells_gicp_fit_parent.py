#!/usr/bin/env python3
"""Holds every kernel whose cell front end now flushes subnormal
coordinates (`csrc/common.cuh` `lvs::cell_floor`), kernel 19b (GICP's
normal equations, `csrc/gicp.cu` `lvs_gicp_normal`, now one launch) and
kernel 10g (the 5-NN fits' KnnGrid branch, `csrc/lfa_fit.cu`, now a warp a
query below 16384 queries) bit for bit against an earlier tree's kernels on
one NVIDIA GPU, and times each beside its parent in the same call.

    python scripts/cells_gicp_fit_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/cells_gicp_fit_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc`. Where its sources are missing and the checkout
has git, the script writes them there from `git show C:...` (C defaults to
43450ae, the tree before the flush, the one-launch K19b and K10g's warp
route); on a copy without git, unpack them first (`git archive C
lv_slam_tpu_torch/csrc | tar -x -C DIR`). It builds that tree's
voxel_downsample.cu, voxel_dedup.cu, voxel_map.cu, cell_table.cu,
knn_grid.cu, lfa_fit.cu, centroid_grid.cu, ndt_hash.cu, ndt_lut.cu and
gicp.cu with `kernels/_build.py`'s nvcc flags into
`_cache/cells_gicp_fit_parent/` (one nvcc process each, started together)
and binds them in place of the shipped kernels (K19b through its earlier
two-launch C entry). It reads the circle's scans from chip_smoke's cache
(`_cache/chip_smoke/`, simulating them where missing): run it after
`chip_smoke.py` in one command.

Checks, every one bit for bit (masks, keys, float bits), the shipped
kernels against the earlier tree's:
- every entry of chip_smoke's case lists of the touched kernels:
  `sort_cases` (K1, K1b), `map_cases` (K3), `grid_cases` (K14, its
  probes K17 and K18), `lut_cases` (K6L, K6G), `knn_cases` (K9g, K9k),
  `table_cases` (K9c), `hash_cases` (K5), `probe_cases` (K6, K13),
  `window_cases` (K2), `raw_window_cases` (K2r), `fit_cases` (K10),
  `crop_cases` (K9b) and `gicp_cases` (K19b); the cases that hold a
  coordinate the reference flushes (the subnormal ones, and `lut_cases`'
  face case, whose points one ulp below the face through 0 are negative
  denormals), where the earlier kernels' cells differ by design, are
  reported, not demanded;
- every touched kernel's timed call at the main path's shapes (phases 2,
  2c, 2e-2h and 2j of chip_smoke, whose calls are collected by running
  those phases' checks), K19b's at phase 2h's shape (46175 matched of
  131072 lanes) and K10g's at phase 2j's (768 + 1536 queries, a warp a
  query) and past 16384 queries (a thread a query);
- end to end: 8 scans of the dlo -> LFA chain (phases 4-5), 8 scans of the
  host DLO (8a) and phase 10a's GICP align (its 20 iterations).

Times (device-only medians over the whole calls among 20 in a
torch.profiler trace, `chip_smoke.device_ms`), in the same call: each
collected call with the earlier kernels, the shipped ones twice (their own
launches and the call's whole device work), the earlier ones again, each
tree's two timings averaged; K19b's split between the earlier `gicp_normal` and `gicp_finish`;
phase 10a's GICP align traced with either K19b (its 20 launches' total).
Prints one line per check and timing and writes them as JSON to FILE
(default `chiprun_out/cells_gicp_fit_parent.json`), beside the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from _parent import build, differ, fetch_parent  # noqa: E402  (scripts/_parent.py)

COMMIT = "43450ae"  # the tree before the redesign
LIBRARIES = ("voxel_downsample.cu", "voxel_dedup.cu", "voxel_map.cu", "cell_table.cu", "knn_grid.cu", "lfa_fit.cu",
             "centroid_grid.cu", "ndt_hash.cu", "ndt_lut.cu", "gicp.cu")
SOURCES = LIBRARIES + ("cluster_sort.cuh", "common.cuh", "key_sort.cuh", "knn_search.cuh", "linalg3.cuh",
                       "ndt_terms.cuh", "voxel_keys.cuh")
CACHE = ROOT / "_cache" / "cells_gicp_fit_parent"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(lib, entries) -> dict:
    """A `Kernel`'s C entry points (`entries`: name -> argument types) from
    another build of its source, as `Kernel.call` binds them."""
    fns = {}
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
        fns[name] = fn
    return fns


class Parent:
    """The earlier tree's kernels bound in place of the shipped ones: every
    touched kernel's entries through `Kernel._fns`, and K19b's earlier
    two-launch entry in place of `gicp.gicp_normal_equations`."""

    def __init__(self, torch, libs):
        from lv_slam_tpu_torch.kernels import KERNELS
        from lv_slam_tpu_torch.ops import gicp

        self.torch, self.gicp = torch, gicp
        self.kernels = [k for k in KERNELS.values() if Path(k.source).name in LIBRARIES and k is not gicp.NORMAL_KERNEL]
        self.fns = {k.name: bind(libs[Path(k.source).name], k._argtypes) for k in self.kernels}
        self.normal = libs["gicp.cu"].lvs_gicp_normal
        self.normal.argtypes = [P] * 8 + [I, F, P, I, P, P]
        self.normal.restype = ctypes.c_int
        self.shipped_normal = gicp.gicp_normal_equations

    def normal_equations(self, src, src_ok, cov_a, transform, nn, nn_dist, nn_valid, cov_b, max_dist):
        from lv_slam_tpu_torch.kernels._build import ptr

        torch = self.torch
        n = src.shape[0]
        n_blocks = max(1, -(-n // 256))
        partials = torch.empty((n_blocks, 42), dtype=torch.float32, device=src.device)
        out = torch.empty((42,), dtype=torch.float32, device=src.device)
        args = [t.contiguous() for t in (src, src_ok, cov_a, transform, nn, nn_dist, nn_valid, cov_b)]
        err = self.normal(*(ptr(t) for t in args), n, float(np.float32(max_dist)), ptr(partials), n_blocks, ptr(out),
                          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the earlier lvs_gicp_normal failed with CUDA error {err}")
        return out[:36].view(6, 6), out[36:]

    def run(self, fn):
        """`fn()` with the earlier kernels bound."""
        saved = {k.name: k._fns for k in self.kernels}
        try:
            for k in self.kernels:
                k._fns = self.fns[k.name]
            self.gicp.gicp_normal_equations = self.normal_equations
            return fn()
        finally:
            for k in self.kernels:
                k._fns = saved[k.name]
            self.gicp.gicp_normal_equations = self.shipped_normal


def tensors(torch, out) -> list:
    """The tensors of a (nested) output, in order; other fields left out."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensors(torch, o)]
    if hasattr(out, "_fields"):
        return [t for o in out for t in tensors(torch, o)]
    return []


def case_calls(torch, cs, dev):
    """[(kernel, case name, subnormal, call)] over the touched kernels' case
    lists, each call returning the kernel's outputs on fresh inputs."""
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.lfa import registration
    from lv_slam_tpu_torch.ops import gicp, knn, ndt, ndt_hash, ndt_soa, nn, prefilter, voxel_map
    from lv_slam_tpu_torch.ops.knn import CellTable
    from lv_slam_tpu_torch.pipeline import window

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = []

    def add(kernel, name, call, *arrays):
        """A case is the earlier cell rule's where it is named so or holds a subnormal coordinate."""
        flushed = any(a.dtype == np.float32 and bool(((a != 0) & (np.abs(a) < np.finfo(np.float32).tiny)).any())
                      for a in arrays)
        out.append((kernel, name, "subnormal" in name or flushed, call))

    for name, pts, mask, res, out_cap, method in cs.sort_cases():
        cloud = PointCloud(t(pts[:, :3]), t(pts[:, 3]), t(mask))
        add("voxel_downsample", name, lambda c=cloud, r=res, o=out_cap, m=method: prefilter.voxel_downsample(c, r, o, m))
        add("voxel_dedup_first", name, lambda c=cloud, r=res, o=out_cap: prefilter.voxel_dedup_first(c, r, o))
    for name, pts, mask, res, leaf_cap, e, weighted in cs.map_cases():
        cloud = PointCloud(t(pts), torch.zeros(len(pts), device=dev), t(mask))
        add("build_voxel_map", name, lambda c=cloud, r=res, kw=dict(leaf_cap=leaf_cap, lut_extent=e, weighted=weighted):
            voxel_map.build_voxel_map(c, r, **kw))
    for name, pts, mask, leaf_cap, queries, qmask in cs.grid_cases():
        cloud = PointCloud(t(pts), torch.zeros(len(pts), device=dev), t(mask))
        q = PointCloud(t(queries), torch.zeros(len(queries), device=dev), t(qmask))

        def grid_call(c=cloud, q=q, cap=leaf_cap):
            g = nn.build_centroid_grid(c, cs.GRID_RES, cap)
            y, m = q.masked_xyz(), q.mask
            return (g, nn.nn_sq_dists(g, y, m), nn.nn_points(g, y, m),
                    nn.radius_outlier_removal(c, cs.GRID_RES, 3).mask)
        add("build_centroid_grid", name, grid_call)
    for case in cs.lut_cases():
        vm, lut, soa, xs, xyz, mask, trans, gauss, offsets, weighted, _ = cs.lut_case_inputs(torch, case, dev)
        add("ndt_derivatives_soa", case["name"], lambda a=(soa, xs, mask, trans, gauss, offsets, weighted):
            ndt_soa.ndt_derivatives_soa(*a), case["xs"])
        add("ndt_derivatives", case["name"], lambda a=(vm, lut, xyz, mask, trans, gauss, offsets, weighted):
            ndt.ndt_derivatives(*a), case["xs"])
    for name, *arrays in cs.knn_cases():
        inputs = cs.knn_case_inputs(torch, *arrays, dev)
        add("knn", name, lambda i=inputs: cs.knn_case_outputs(torch, i, False))
    for name, pts, mask, n_buckets, slots in cs.table_cases():
        add("build_cell_table", name, lambda x=t(pts), m=t(mask), b=n_buckets, s=slots:
            knn.build_cell_table(x, m, cs.KNN_CELL, b, s))
    for name, *case in cs.hash_cases():
        add("to_hash", name, lambda m=cs.hash_case_map(torch, case, dev), bpl=case[-1]: ndt_hash.to_hash(m, bpl))
    for case in cs.probe_cases():
        hm, xs, mask, trans, gauss, offsets, weighted, done = cs.probe_case_inputs(torch, case, dev)
        active = (~done).tolist()
        add("_fused_verify_fn", case["name"], lambda a=(hm, xs, mask, trans, gauss, offsets, weighted), act=active:
            ndt_hash.ndt_derivatives_hash_batched(*a, act))
        add("ndt_derivatives_hash", case["name"], lambda a=(hm, xs[0], mask[0], trans[0], gauss, offsets, weighted):
            ndt_hash.ndt_derivatives_hash(*a))
    for name, xyz, inten, mask, start, rels, valid, res, out_cap in cs.window_cases():
        add("window_group_filtered_fn", name, lambda a=(t(xyz), t(inten), t(mask)), s=start, e=(t(rels), t(valid)),
            r=res, o=out_cap: window.window_group_filtered(*a, s, *e, r, o))
    for name, xyz, inten, mask, start, rels, valid, near, far, res, out_cap in cs.raw_window_cases():
        add("window_group_fn", name, lambda a=(t(xyz), t(inten), t(mask)), s=start, e=(t(rels), t(valid)),
            b=(near, far), r=res, o=out_cap: window.window_group(*a, s, *e, *b, r, o))
    for name, table, y, mask, k in cs.fit_cases():
        grid = CellTable(t(table), cs.FIT_CELL)
        add("lines_from_fit", name, lambda g=grid, y=t(y), m=t(mask), k=k: (registration.lines_from_fit(y, m, g, k=k),
                                                                          registration.planes_from_fit(y, m, g, k=k)))
    for name, center, last, interval, radius in cs.crop_cases():
        def crop(c=t(center), lc=None if last is None else t(last), i=interval, r=radius):
            edge, surf = cs.crop_tables(torch, dev)
            return knn.crop_cell_tables_(edge, surf, c, r, lc, i), edge.table, surf.table
        add("crop_cell_table", name, crop)
    for name, *arrays in cs.gicp_cases():
        a = [t(x) for x in arrays]
        add("gicp_align", name, lambda a=a: gicp.gicp_normal_equations(*a[:3], a[7], *a[3:7], 2.0))
    return out


def main_path_calls(cs, torch, scans, gt, dev, on_call):
    """Runs chip_smoke's phases 2, 2c, 2e-2h and 2j with their timing
    stubbed, and calls `on_call(kernel, what, call)` where a phase would
    time `call`, while its inputs are the ones it times (a phase may rebind
    them later). Returns the kernels seen."""
    seen = set()
    saved = cs.timed, cs.device_ms

    def collect(torch_, name, kernel_fn, plain_fn, err, n_bytes, n_ops, what=""):
        seen.add(name)
        on_call(name, what.strip() or "main path", kernel_fn)
        return dict(max_abs_err=float(err), ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="bytes", library_ms=None,
                    wrapper_device_ms=0.0)

    cs.timed, cs.device_ms = collect, lambda *a, **k: (0.0, 0.0, 0)
    try:
        n = cs.N_SCANS
        cs.check_kernels(torch, scans[:n], gt[:n], dev)
        cs.check_lfa_kernels(torch, scans[:n], gt[:n], dev)
        cs.check_backend_kernels(torch, scans, gt, dev)
        cs.check_standalone_kernels(torch, scans, dev)
        cs.check_lut_kernels(torch, scans, gt, dev)
        cs.check_graph_input_kernels(torch, scans, gt, dev)
        cs.check_registration_kernels(torch, scans, gt, dev)
        cs.check_cell_knn_kernels(torch, scans, gt, dev)
    finally:
        cs.timed, cs.device_ms = saved
    return seen


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "cells_gicp_fit_parent.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cells_gicp_fit_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.lfa import features, registration
    from lv_slam_tpu_torch.lfa.fused import _GRID_CELL
    from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry
    from lv_slam_tpu_torch.ops import knn
    from lv_slam_tpu_torch.ops.registrations import RegistrationParams, select_registration_method
    from lv_slam_tpu_torch.pipeline.fused_chain import run_sequence_chain
    import lv_slam_tpu_torch.pipeline.async_backend  # noqa: F401  (registers every kernel)
    import lv_slam_tpu_torch.pipeline.slam  # noqa: F401
    import lv_slam_tpu_torch.ops.ndt_ground  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    csrc = fetch_parent(args.parent or CACHE / args.commit, args.commit, SOURCES)
    parent = Parent(torch, build(csrc, LIBRARIES, CACHE))
    cfg = kitti_flagship_config()
    pf = cfg.prefilter
    scans, gt = cs.load_scans(cs.N_FULL)
    rows, failed = [], []

    def record(row, bad):
        rows.append(row)
        if bad:
            failed.append(row["check"])

    def compare(what, call, expect_same=True):
        got = tensors(torch, call())
        want = tensors(torch, parent.run(call))
        torch.cuda.synchronize()
        bad = differ(torch, got, want)
        row = dict(check=what, bit_identical=not bad, differ=bad, demanded=expect_same)
        record(row, bad and expect_same)
        verdict = "bit-identical" if not bad else f"differs in outputs {bad}"
        print(f"{what}: {verdict}{'' if expect_same else ' (the earlier cell rule: not demanded)'}", flush=True)
        return row

    device_ms = cs.device_ms  # the main-path phases stub chip_smoke's own while they run

    def timing(kernel, what, call):
        """Parent, shipped, shipped, parent: each the mean of its two timings."""
        row = dict(check=f"{kernel}, {what}", timed=True)
        parents = [parent.run(lambda: device_ms(torch, call))[1]]
        shipped = [device_ms(torch, call, cs.DEVICE_FUNCTIONS[kernel]) for _ in range(2)]
        parents.append(parent.run(lambda: device_ms(torch, call))[1])
        row["ms"] = float(np.mean([s[0] for s in shipped]))
        row["wrapper_ms"] = float(np.mean([s[1] for s in shipped]))
        row["parent_ms"] = float(np.mean(parents))
        row["slower_pct"] = 100.0 * (row["wrapper_ms"] / row["parent_ms"] - 1.0) if row["parent_ms"] else None
        rows.append(row)
        print(f"{row['check']}: shipped {row['ms']:.4f} ms (the call's device work {row['wrapper_ms']:.4f}), parent "
              f"{row['parent_ms']:.4f} ms ({row['slower_pct']:+.1f} %)", flush=True)
        return row

    # the case lists: existing cases demanded bit for bit, subnormal ones reported
    for kernel, name, subnormal, call in case_calls(torch, cs, dev):
        compare(f"{kernel} on case '{name}'", call, expect_same=not subnormal)

    # every touched kernel's timed call at the main path's shapes; K19b's
    # split in the earlier tree (gicp_normal, gicp_finish) traced over 20 calls
    touched = {k.name for k in parent.kernels} | {"gicp_align"}

    def on_call(kernel, what, call):
        if kernel not in touched:
            return
        compare(f"{kernel} at the main path's shape ({what})", call)
        timing(kernel, what, call)
        if kernel == "gicp_align":
            trace = parent.run(lambda: cs.trace_rows(torch, lambda: [call() for _ in range(20)]))
            split = {fn: sum(t for t, k, _ in trace if cs._is_function(k, fn)) / 1e3 / 20
                     for fn in ("gicp_normal", "gicp_finish")}
            rows.append(dict(check=f"the earlier K19b's split ({what})", split_ms=split))
            print(f"the earlier K19b's split ({what}): gicp_normal {split['gicp_normal']:.4f} ms, gicp_finish "
                  f"{split['gicp_finish']:.4f} ms a call (traced over 20 calls)", flush=True)

    seen = main_path_calls(cs, torch, scans, gt, dev, on_call)
    print(f"touched kernels without a main-path call in phases 2-2j: {sorted(touched - seen)}", flush=True)

    # K10g past 16384 queries (a thread a query): standalone LFA's surf grid, scan 4's flat features repeated
    lfa = cfg.lfa

    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    f3, f4 = (features.extract_features(PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev), lfa)
              for i in (3, 4))
    p3, p4 = (torch.from_numpy(gt_rel[i]).to(dev) for i in (3, 4))
    surf = knn.build_grid(se3.transform_points(p3, f3.less_flat), f3.less_flat_mask, _GRID_CELL)
    ys = se3.transform_points(p4, f4.flat)
    reps = -(-(cs.KNN_THREAD_QUERIES + 1) // ys.shape[0])
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    yb = (ys.repeat(reps, 1) + 0.03 * torch.randn((reps * ys.shape[0], 3), generator=gen, device=dev)).contiguous()
    mb = f4.flat_mask.repeat(reps).contiguous()
    call = lambda: registration.planes_from_fit(yb, mb, surf, lfa.knn_k)  # noqa: E731
    compare(f"grid_fits past the warp route ({yb.shape[0]} queries, a thread a query)", call)
    timing("grid_fits", f"planes, {yb.shape[0]} queries (a thread a query)", call)

    # end to end: 8 scans of the chain and of the host DLO, phase 10a's GICP align
    xyz8, m8, stamps8, inten8 = cs.stack_scans(torch, scans[:8], pf.raw_cap, dev)
    compare("8 scans of the dlo -> LFA chain (phases 4-5), every output",
            lambda: run_sequence_chain(xyz8, m8, stamps8, cfg.odometry, pf, lfa, inten=inten8, device=dev,
                                       return_filtered=True))
    raws = [PointCloud.from_numpy(s, cap=pf.raw_cap, device=dev) for s in scans[:8]]

    def dlo_poses():
        odo = DirectLidarOdometry(cfg.odometry, pf, device=dev)
        for i, raw in enumerate(raws):
            odo.process(raw, i * 0.1)
        return [torch.from_numpy(np.stack(odo.poses))]

    compare("8 scans of the host DLO (8a), its poses", dlo_poses)
    target, source, _, guess = cs.registration_pair(torch, scans, gt, dev)
    reg = select_registration_method(
        RegistrationParams(registration_method="GICP", max_iterations=40, ndt_nn_search_method="DIRECT7"))
    row = compare("phase 10a's GICP align (20 iterations): transform, fitness, matches",
                  lambda: tuple(reg(target, source, guess)))
    traced = {}
    for key, run in (("shipped", lambda f: f()), ("parent", parent.run)):
        trace = run(lambda: cs.trace_rows(torch, lambda: reg(target, source, guess)))
        k19b = [(t, c) for t, k, c in trace if cs._is_function(k, "gicp_normal") or cs._is_function(k, "gicp_finish")]
        traced[key] = dict(ms=sum(t for t, _ in k19b) / 1e3, launches=sum(c for _, c in k19b),
                           align_ms=sum(t for t, k, _ in trace if cs.MARKER not in k) / 1e3)
    row["traced"] = traced
    print(f"  K19b traced over the align: {traced['shipped']['ms']:.4f} ms over {traced['shipped']['launches']} "
          f"launches (parent {traced['parent']['ms']:.4f} over {traced['parent']['launches']}); the align's device "
          f"work {traced['shipped']['align_ms']:.4f} ms (parent {traced['parent']['align_ms']:.4f})", flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, commit=args.commit, rows=rows), indent=1))
    if failed:
        print(f"cells_gicp_fit_parent: not bit-identical on {failed}", flush=True)
        return 1
    n = sum(1 for r in rows if r.get("demanded"))
    print(f"cells_gicp_fit_parent: all {n} demanded checks bit-identical to the parent tree's kernels", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
