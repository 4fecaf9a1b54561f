#!/usr/bin/env python3
"""Holds K7's `newton_step` (`lv_slam_tpu_torch/csrc/newton.cu`) and the NDT
hash pass `ndt_partials` (K6 / K13's pass, `csrc/ndt_hash.cu`) bit for bit
against an earlier tree's kernels on one NVIDIA GPU, and times both side by
side.

    python scripts/newton_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/newton_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc`. Where it is missing and the checkout has git, the
script writes `newton.cu`, `ndt_hash.cu`, `ndt_lut.cu` and the headers they
include there from `git show C:...` (C defaults to 81e5d8c, the tree before
the redesign); on a copy without git, unpack it first (`git archive C
lv_slam_tpu_torch/csrc | tar -x -C DIR`). It builds those three files with
`kernels/_build.py`'s nvcc flags into `_cache/newton_parent/` (ptxas's
registers and spills printed for each kernel, the parent's and the shipped
library's).

Checks, every one bit for bit (float bits, NaN's too):
- step by step to done, from identical states: each iteration the shipped
  pass and the parent's pass write their partial rows from the same state,
  then the shipped `newton_step` and the parent's step the same rows, and
  every state row `f` and `s` must agree: the fused odometry's fine phase
  (scan 1's 65536 lanes on scan 0's flagship map, DIRECT1 weighted: 256
  rows a lane) and coarse phase (every other lane: 128 rows), K13's batch of
  8 x 131072 lanes at the 1 m rung (DIRECT7: 512 rows), and that batch's
  sharded form (`newton_sums`, then the step on one row a lane);
- `ndt_partials`' partial rows at K13's 1 m and 4 m rungs (chip_smoke phase
  2c's shapes) with candidates 1 and 5 already done, where neither kernel
  may write; the whole passes (the rows and `ndt_finish`) at K6's and
  K13's shapes, and the shipped ones again in a second run;
- chip_smoke's `newton_cases` (canned derivative rows: a zero pivot, row
  swaps, a NaN start, the ground NDT's `dof` masks, steps clamped to
  step_min and to the cap, max_iterations reached, 1 and 2049 rows a lane,
  a batch with a finished lane) and `probe_cases` (slot-1 keys, keys in
  neither slot, sentinel and masked lanes, cells past the extent, lanes the
  gate rejects, 1000 lanes, candidates done);
- the LUT passes K6L and K6G (`csrc/ndt_lut.cu`, over the block reduction
  `lvs::block_partials` that they share with `ndt_partials`; one launch
  each since their redesign, against the earlier partial rows and
  `ndt_finish`) at the flagship pair, DIRECT1 and DIRECT7.

Each kernel is timed as chip_smoke.py times a kernel (the median over the
whole calls among 20 in a torch.profiler trace, its own device functions):
`newton_step` from the state after the first step at 256 rows (phase 2i's
shape) and on K13's batch, the pass at K6's shape (phase 2) and K13's 1 m
rung (phase 2c); and K13's 1 m rung's Newton loop (its 18 gated passes and
steps from the guesses, as `ndt_align_hash_table_batched` launches them) by
`chip_smoke.loop_ms`. Prints one line per check and timing and writes them as
JSON to FILE (default `chiprun_out/newton_parent.json`), beside the card's
name and power limit.
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

COMMIT = "81e5d8c"  # the tree before the redesign
SOURCES = ("newton.cu", "ndt_hash.cu", "ndt_lut.cu", "common.cuh", "ndt_terms.cuh", "se3.cuh")
N_SCANS = 18  # scans 0-17: the flagship pair and K13's window and candidates
STEP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the earlier tree's standalone LUT passes (partial rows, then `ndt_finish`: no counter), the stream last
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LUT_DERIVATIVES_ARGS = [P_, P_, P_, F_, I_, P_, I_, P_, P_, F_, F_, P_, I_, I_, P_, I_, P_, P_]
GENERIC_DERIVATIVES_ARGS = [P_, P_, P_, P_, P_, F_, I_, P_, I_, P_, P_, F_, F_, P_, I_, I_, P_, I_, P_, P_]
PASS_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


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


def build(sources, include: Path, out: Path):
    """(the library, ptxas's usage lines) of `sources` built into `out`."""
    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(include), "-o", str(out), *map(str, sources)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    import chip_smoke as cs

    return ctypes.CDLL(str(out)), cs.ptxas_usage(done.stdout + done.stderr)


def bind(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def stream(torch):
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def same(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


class Parent:
    """The earlier tree's `newton_step` and `lvs_ndt_hash_partials` over its library."""

    def __init__(self, torch, lib):
        self.torch = torch
        self.lut_fn = bind(lib, "lvs_ndt_lut_derivatives", LUT_DERIVATIVES_ARGS)
        self.generic_fn = bind(lib, "lvs_ndt_generic_derivatives", GENERIC_DERIVATIVES_ARGS)
        self.step_fn = bind(lib, "lvs_newton_step", STEP_ARGS)
        self.pass_fn = bind(lib, "lvs_ndt_hash_partials", PASS_ARGS)
        head = PASS_ARGS[:8]
        tail = [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        out = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        self.derivs_fn = bind(lib, "lvs_ndt_hash_derivatives", head + [ctypes.c_void_p] + tail + out)
        self.batched_fn = bind(lib, "lvs_ndt_hash_derivatives_batched",
                               head + [ctypes.c_void_p, ctypes.c_int] + tail + out)

    def derivatives(self, hm, xs, mask, transforms, gauss, offsets, weighted):
        """The earlier tree's whole pass (the partial rows and `ndt_finish`):
        (k, 43) sums for transforms (k, 4, 4), or (43,) for one (4, 4)."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops import ndt

        head, tail, n_blocks = pass_args(hm, xs, mask, gauss, offsets, weighted)
        k = transforms.shape[0] if transforms.dim() == 3 else None
        partials = self.torch.empty(((k or 1) * n_blocks * ndt.N_TERMS,), dtype=self.torch.float32, device=xs.device)
        out = self.torch.empty(((k or 1) * ndt.N_TERMS,), dtype=self.torch.float32, device=xs.device)
        if k is None:
            err = self.derivs_fn(*head, ptr(transforms), *tail, ptr(partials), n_blocks, ptr(out), stream(self.torch))
        else:
            err = self.batched_fn(*head, ptr(transforms), k, *tail, ptr(partials), n_blocks, ptr(out),
                                  stream(self.torch))
        if err:
            raise RuntimeError(f"the parent's derivative pass failed with CUDA error {err}")
        return out if k is None else out.view(k, ndt.N_TERMS)

    def lut_derivatives(self, fn, head, tail, n_blocks, transform):
        """The earlier tree's K6L or K6G (`fn`) over the shipped wrapper's
        arguments: its (43,) sums."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops import ndt

        partials = self.torch.empty((n_blocks * ndt.N_TERMS,), dtype=self.torch.float32, device=transform.device)
        out = self.torch.empty((ndt.N_TERMS,), dtype=self.torch.float32, device=transform.device)
        err = fn(*head, ptr(transform), *tail, ptr(partials), n_blocks, ptr(out), stream(self.torch))
        if err:
            raise RuntimeError(f"the parent's LUT pass failed with CUDA error {err}")
        return out

    def step(self, state, n_blocks, p, rows):
        from lv_slam_tpu_torch.kernels._build import ptr

        err = self.step_fn(ptr(rows), n_blocks, ptr(state.f), ptr(state.s), state.k, p.eps, p.step_min, p.step_max,
                           p.max_iterations, p.dof_bits, stream(self.torch))
        if err:
            raise RuntimeError(f"the parent's newton_step failed with CUDA error {err}")


def pass_args(hm, xs, mask, gauss, offsets, weighted):
    """`lvs_ndt_hash_partials`' arguments around the transform and the gate, and the block count."""
    from lv_slam_tpu_torch.ops import ndt_hash

    head, tail, n_blocks = ndt_hash._hash_args("newton_parent", hm, xs, mask, gauss, offsets, weighted)
    return head, tail, n_blocks


def run_pass(torch, fn, args, state, out, n_cand, variant=None):
    """One gated pass at the state's candidates into `out`."""
    from lv_slam_tpu_torch.kernels._build import ptr
    from lv_slam_tpu_torch.ops import ndt

    head, tail, n_blocks = args
    call = (*head, state.cand_ptr(), ndt.F_WIDTH, state.done_ptr(), ndt.S_WIDTH, n_cand, *tail, ptr(out), n_blocks,
            stream(torch))
    err = fn(*call) if variant is None else fn(variant, *call)
    if err:
        raise RuntimeError(f"a pass failed with CUDA error {err}")


def step_to_done(torch, ndt, name, state, pass_, p, parent, parent_pass=None, sharded=False, limit=200):
    """Steps two copies of `state` to done with the shipped and the parent's
    kernels from identical rows; returns (steps, rows compared, first
    difference or None)."""
    twin = state.clone()
    rows_checked, steps = 0, 0
    n_cand = state.k
    while not state.all_done() and steps < limit:
        other = state.partials.clone()  # a finished lane's rows stay as the last pass left them
        pass_.launch(state)
        if parent_pass is not None:
            parent_pass(state, other, n_cand)
            if not same(torch, other, state.partials):
                return steps, rows_checked, f"{name}: the pass's partial rows differ at step {steps}"
            rows_checked += 1
        if sharded:
            rows = ndt.newton_sums(state, pass_.n_blocks).clone()
            ndt.newton_step(state, 1, p, rows)
            parent.step(twin, 1, p, rows)
        else:
            ndt.newton_step(state, pass_.n_blocks, p)
            parent.step(twin, pass_.n_blocks, p, state.partials)
        steps += 1
        if not (same(torch, state.f, twin.f) and same(torch, state.s, twin.s)):
            return steps, rows_checked, f"{name}: the state differs from the parent's after step {steps}"
    return steps, rows_checked, None


def load_data(torch, cs, dev):
    """The flagship pair (phase 2's K6 shape) and K13's batch (phase 2c's)."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.ops import prefilter, voxel_map

    cfg = kitti_flagship_config()
    pf, ndt_cfg = cfg.prefilter, cfg.odometry.ndt
    if (cs.CACHE / f"scans_v1_{cs.N_FULL}.npz").exists():
        scans = cs.load_scans(cs.N_FULL)[0][:N_SCANS]
    else:
        with multiprocessing.get_context("spawn").Pool(8) as pool:
            scans = pool.starmap(cs._simulate, [(i, cs.N_FULL) for i in range(N_SCANS)])
    gt = synthetic.circle_trajectory(cs.N_FULL, step=1.0)

    def filtered(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        band = prefilter.distance_filter(raw, pf.distance_near_thresh, pf.distance_far_thresh)
        return prefilter.voxel_downsample(band, pf.downsample_resolution, pf.out_cap)

    target = prefilter.stride_subsample(filtered(0), cfg.odometry.scan_matching_cap)
    vm = voxel_map.build_voxel_map(
        target, ndt_cfg.resolution, leaf_cap=ndt_cfg.leaf_cap, lut_extent=ndt_cfg.lut_extent,
        min_points_per_voxel=ndt_cfg.min_points_per_voxel, min_covar_eigvalue_mult=ndt_cfg.min_covar_eigvalue_mult,
        weighted=ndt_cfg.weighted)
    src = prefilter.stride_subsample(filtered(1), cfg.odometry.scan_matching_cap)
    rel = torch.from_numpy((np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)).to(dev)
    return scans, gt, cfg, vm, src, rel


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT, help="the earlier tree's commit, where DIR is written from git")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "newton_parent.json")
    args = parser.parse_args()
    parent_dir = args.parent or ROOT / "_cache" / "newton_parent" / args.commit
    csrc = fetch_parent(parent_dir, args.commit)
    if not torch.cuda.is_available():
        raise SystemExit("newton_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs

    from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.kernels import _build
    from lv_slam_tpu_torch.ops import ndt, ndt_hash, ndt_soa, voxel_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    record = dict(card=smi, commit=args.commit, checks=[], times=[])
    build_dir = ROOT / "_cache" / "newton_parent"
    lib, before = build([csrc / name for name in SOURCES if name.endswith(".cu")], csrc, build_dir / "libparent.so")
    _build.LIBRARY.load()
    after = cs.ptxas_usage((_build.BUILD_DIR / "build.log").read_text())
    record["ptxas"] = dict(parent=before, shipped=after)
    for what, usage in (("parent", before), ("shipped", after)):
        for fn, u in sorted(usage.items()):
            print(f"ptxas {what}: {fn}: {u}", flush=True)
    parent = Parent(torch, lib)
    failed = []

    def check(name, ok, detail=""):
        record["checks"].append(dict(name=name, bit_identical=ok, detail=detail))
        print(f"{name}: {'bit-identical' if ok else 'DIFFERS'}{', ' + detail if detail else ''}", flush=True)
        if not ok:
            failed.append(name)

    scans, gt, cfg, vm, src, rel = load_data(torch, cs, dev)
    ndt_cfg = cfg.odometry.ndt
    hm = ndt_hash.to_hash(vm, ndt_cfg.hash_buckets_per_leaf)
    gauss = ndt.make_gauss_params(ndt_cfg.resolution, ndt_cfg.outlier_ratio)
    d1 = voxel_map.neighborhood_offsets(ndt_cfg.neighborhood, dev)
    xs, mask = src.masked_xyz().T.contiguous(), src.mask.contiguous()
    guess = (se3.exp_se3(torch.tensor([0.3, -0.1, 0.0, 0.0, 0.0, 0.02], device=dev)) @ rel).contiguous()

    def parent_pass_of(pargs):
        return lambda state, out, n_cand: run_pass(torch, parent.pass_fn, pargs, state, out, n_cand)

    # the fused odometry's phases: fine (256 rows a lane), coarse (128)
    shapes = {}
    for phase, stride, eps in (("fine phase, 256 rows", 1, 0.01), ("coarse phase, 128 rows", 2, 0.02)):
        pxs, pmask = xs[:, ::stride].contiguous(), mask[::stride].contiguous()
        pass_ = ndt_hash.hash_pass(hm, pxs, pmask, gauss, d1, ndt_cfg.weighted)
        pargs = pass_args(hm, pxs, pmask, gauss, d1, ndt_cfg.weighted)
        p = ndt.loop_params(np.float32(eps), ndt_cfg.step_size, ndt_cfg.max_iterations)
        state = ndt.NewtonState(guess[None])
        state.partials = torch.empty((pass_.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
        steps, passes, err = step_to_done(torch, ndt, phase, state, pass_, p, parent, parent_pass_of(pargs))
        check(f"newton_step and ndt_partials, the odometry's {phase}", err is None,
              err or f"{steps} steps, {passes} passes")
        shapes[phase] = (pass_, pargs, p, pxs, pmask)

    # K13's batch at the 1 m rung (8 x 131072 lanes, DIRECT7: 512 rows), and its sharded form
    keyframe, cands, guesses = cs.loop_batch(torch, scans, gt, dev)
    batch = PointCloud(torch.stack([c.xyz for c in cands]), torch.stack([c.intensity for c in cands]),
                       torch.stack([c.mask for c in cands]))
    bmask = batch.mask.contiguous()
    bxs = torch.where(bmask[..., None], batch.xyz, SENTINEL).transpose(1, 2).contiguous()
    d7 = voxel_map.neighborhood_offsets("DIRECT7", dev)
    iters = cfg.loop.verify_max_iterations
    bp = ndt.loop_params(0.01, 0.1, iters)
    rungs = {}
    for r, stride in ((4.0, 4), (1.0, 1)):
        hmr = ndt_hash.to_hash(voxel_map.build_voxel_map(keyframe, r, leaf_cap=16384, lut_extent=256))
        rxs, rmask = bxs[:, :, ::stride].contiguous(), bmask[:, ::stride].contiguous()
        g = ndt.make_gauss_params(r)
        rungs[r] = (hmr, rxs, rmask, g, ndt_hash.hash_pass(hmr, rxs, rmask, g, d7, False),
                    pass_args(hmr, rxs, rmask, g, d7, False))
    hm1, rxs1, rmask1, g1, bpass, bargs = rungs[1.0]
    for name, sharded in (("K13's batch at the 1 m rung, 512 rows", False),
                          ("K13's batch, sharded: newton_sums, then 1 row a lane", True)):
        state = ndt.NewtonState(guesses, batched=True)
        state.partials = torch.empty((8 * bpass.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
        steps, passes, err = step_to_done(torch, ndt, name, state, bpass, bp, parent,
                                          None if sharded else parent_pass_of(bargs), sharded=sharded)
        check(f"newton_step{'' if sharded else ' and ndt_partials'}, {name}", err is None,
              err or f"{steps} steps, iterations {state.s[:, ndt.S_IT].tolist()}")

    # the pass with candidates 1 and 5 done, at both rungs: neither kernel writes their rows
    for r, (hmr, rxs, rmask, g, rpass, rargs) in rungs.items():
        state = ndt.NewtonState(guesses, batched=True)
        state.s[[1, 5], ndt.S_DONE] = 1
        state.partials = torch.full((8 * rpass.n_blocks * ndt.N_TERMS,), float("nan"), dtype=torch.float32,
                                    device=dev)
        other = state.partials.clone()
        rpass.launch(state)
        run_pass(torch, parent.pass_fn, rargs, state, other, 8)
        rows = state.partials.view(8, -1)
        untouched = bool(torch.isnan(rows[[1, 5]]).all())
        check(f"ndt_partials, K13's {r:g} m rung (8 x {rxs.shape[2]} lanes), candidates 1 and 5 done",
              same(torch, state.partials, other) and untouched, "" if untouched else "a done candidate's rows written")

    # chip_smoke's edge cases
    for name, state, pass_, p, _ in cs.newton_cases(torch, ndt, dev):
        steps, _, err = step_to_done(torch, ndt, name, state, pass_, p, parent)
        check(f"newton_cases: {name}", err is None, err or f"{steps} steps")
    for case in cs.probe_cases():
        hmc, cxs, cmask, ctrans, cg, coff, weighted, done = cs.probe_case_inputs(torch, case, dev)
        state = ndt.NewtonState(ctrans, batched=True)
        state.s[:, ndt.S_DONE] = done.to(torch.int32)
        cpass = ndt_hash.hash_pass(hmc, cxs, cmask, cg, coff, weighted)
        state.partials = torch.full((cxs.shape[0] * cpass.n_blocks * ndt.N_TERMS,), float("nan"),
                                    dtype=torch.float32, device=dev)
        other = state.partials.clone()
        cpass.launch(state)
        run_pass(torch, parent.pass_fn, pass_args(hmc, cxs, cmask, cg, coff, weighted), state, other, cxs.shape[0])
        check(f"probe_cases: {case['name']}", same(torch, state.partials, other))

    # the whole passes (the rows, then ndt_finish), as phase 2 and 2c time them: the sums bit for bit
    def sums_of(score, grad, hess):
        k = score.numel()
        return torch.cat([score.reshape(k, 1), grad.reshape(k, 6), hess.reshape(k, 36)], dim=1).reshape(-1)

    fxs = xs.contiguous()
    whole = {
        "K6: 65536 lanes, DIRECT1 weighted (phase 2)": (
            lambda: ndt_hash.ndt_derivatives_hash(hm, fxs, mask, rel, gauss, d1, ndt_cfg.weighted),
            lambda: parent.derivatives(hm, fxs, mask, rel, gauss, d1, ndt_cfg.weighted)),
        "K13: 8 x 131072 lanes, 1 m, DIRECT7 (phase 2c)": (
            lambda: ndt_hash.ndt_derivatives_hash_batched(hm1, rxs1, rmask1, guesses, g1, d7, False),
            lambda: parent.derivatives(hm1, rxs1, rmask1, guesses, g1, d7, False)),
    }
    for name, (shipped, earlier) in whole.items():
        got, want = sums_of(*shipped()), earlier().reshape(-1)
        again = sums_of(*shipped())
        check(f"ndt_partials and ndt_finish, {name}", same(torch, got, want) and same(torch, got, again),
              "the parent's sums, and the shipped kernels' again in a second run")

    # K6L and K6G share the block reduction: their sums bit for bit the parent's
    lut = voxel_map.build_lut(vm)
    soa = ndt_soa.to_soa(vm, lut)
    xyz = src.masked_xyz().contiguous()
    for hood in ("DIRECT1", "DIRECT7"):
        off = voxel_map.neighborhood_offsets(hood, dev)
        for name, shipped, fn, lut_args in (
                ("K6L", lambda: ndt_soa.ndt_derivatives_soa(soa, fxs, mask, rel, gauss, off, ndt_cfg.weighted),
                 parent.lut_fn, ndt_soa._soa_args(soa, fxs, mask, gauss, off, ndt_cfg.weighted)),
                ("K6G", lambda: ndt.ndt_derivatives(vm, lut, xyz, mask, rel, gauss, off, ndt_cfg.weighted),
                 parent.generic_fn, ndt._generic_args(vm, lut, xyz, mask, gauss, off, ndt_cfg.weighted))):
            got, want = sums_of(*shipped()), parent.lut_derivatives(fn, *lut_args, rel)
            check(f"{name} ({hood}, the flagship pair): block_partials and ndt_finish", same(torch, got, want),
                  "the parent's sums")

    # times, the parent's and the shipped kernels' in the same call
    def timed_step(state, n_blocks, run):
        f0, s0 = state.f.clone(), state.s.clone()

        def call():
            state.f.copy_(f0)
            state.s.copy_(s0)
            run()

        return cs.device_ms(torch, call, cs.DEVICE_FUNCTIONS["newton_step"])[0]

    fine_pass, fine_args, fine_p, fxs, fmask = shapes["fine phase, 256 rows"]
    state = ndt.NewtonState(guess[None])
    state.partials = torch.empty((fine_pass.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
    fine_pass.launch(state)
    ndt.newton_step(state, fine_pass.n_blocks, fine_p)
    fine_pass.launch(state)
    bstate = ndt.NewtonState(guesses, batched=True)
    bstate.partials = torch.empty((8 * bpass.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
    bpass.launch(bstate)
    ndt.newton_step(bstate, bpass.n_blocks, bp)
    bpass.launch(bstate)
    step_shapes = {"newton_step, 1 lane x 256 rows (phase 2i)": (state, fine_pass.n_blocks, fine_p),
                   "newton_step, K13's 8 lanes x 512 rows": (bstate, bpass.n_blocks, bp)}
    for name, (st, nb, p) in step_shapes.items():
        shipped = timed_step(st, nb, lambda st=st, nb=nb, p=p: ndt.newton_step(st, nb, p))
        earlier = timed_step(st, nb, lambda st=st, nb=nb, p=p: parent.step(st, nb, p, st.partials))
        record["times"].append(dict(name=name, ms=shipped, parent_ms=earlier))
        print(f"{name}: shipped {shipped:.4f} ms, parent {earlier:.4f} ms (device-only, median of 20)", flush=True)
    pass_shapes = {"ndt_partials, K6: 65536 lanes, DIRECT1 weighted (phase 2)": (fine_pass, fine_args, state, 1),
                   "ndt_partials, K13: 8 x 131072 lanes, 1 m, DIRECT7 (phase 2c)": (bpass, bargs, bstate, 8)}
    for name, (pass_, pargs, st, n_cand) in pass_shapes.items():
        out = torch.empty_like(st.partials)
        shipped = cs.device_ms(torch, lambda pass_=pass_, st=st: pass_.launch(st),
                               ("ndt_partials",))[0]
        earlier = cs.device_ms(torch, lambda pargs=pargs, st=st, out=out, n_cand=n_cand: run_pass(
            torch, parent.pass_fn, pargs, st, out, n_cand), ("ndt_partials",))[0]
        record["times"].append(dict(name=name, ms=shipped, parent_ms=earlier))
        print(f"{name}: shipped {shipped:.4f} ms, parent {earlier:.4f} ms (device-only, median of 20)", flush=True)

    for name, (shipped, earlier) in whole.items():
        ms = cs.device_ms(torch, shipped, ("ndt_partials", "ndt_finish"))[0]
        parent_ms = cs.device_ms(torch, earlier, ("ndt_partials", "ndt_finish"))[0]
        finish_ms = cs.device_ms(torch, shipped, ("ndt_finish",))[0]
        parent_finish_ms = cs.device_ms(torch, earlier, ("ndt_finish",))[0]
        record["times"].append(dict(name=f"ndt_partials + ndt_finish, {name}", ms=ms, parent_ms=parent_ms,
                                    finish_ms=finish_ms, parent_finish_ms=parent_finish_ms))
        print(f"ndt_partials + ndt_finish, {name}: shipped {ms:.4f} ms (ndt_finish {finish_ms:.4f}), parent "
              f"{parent_ms:.4f} ms (ndt_finish {parent_finish_ms:.4f}) (device-only, median of 20)", flush=True)

    # K13's 1 m rung's Newton loop: iters + 2 gated passes and steps from
    # the guesses, as ndt_align_hash_table_batched launches them
    def rung(parent_kernels: bool):
        def run():
            st = ndt.NewtonState(guesses, batched=True)
            st.partials = torch.empty((8 * bpass.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=dev)
            for _ in range(iters + 2):
                if parent_kernels:
                    run_pass(torch, parent.pass_fn, bargs, st, st.partials, 8)
                    parent.step(st, bpass.n_blocks, bp, st.partials)
                else:
                    bpass.launch(st)
                    ndt.newton_step(st, bpass.n_blocks, bp)

        return run

    shipped, earlier = cs.loop_ms(torch, rung(False))[0], cs.loop_ms(torch, rung(True))[0]
    name = f"K13's 1 m rung's Newton loop ({iters + 2} gated passes and steps, 8 x 131072 lanes)"
    record["times"].append(dict(name=name, ms=shipped, parent_ms=earlier))
    print(f"{name}: shipped {shipped:.4f} ms, parent {earlier:.4f} ms (device ms, chip_smoke.loop_ms)", flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    if failed:
        print(f"newton_parent: not bit-identical on {failed}", flush=True)
        return 1
    print(f"newton_parent: all {len(record['checks'])} checks bit-identical to the parent tree's kernels", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
