#!/usr/bin/env python3
"""Holds the LUT passes K6L and K6G (`lv_slam_tpu_torch/csrc/ndt_lut.cu`,
`lut_pass`) bit for bit against an earlier tree's kernels on one NVIDIA GPU,
times both side by side, and times K6L's design variants.

    python scripts/ndt_lut_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/ndt_lut_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc`. Where it is missing and the checkout has git, the
script writes `ndt_lut.cu`, `ndt_terms.cuh` and `common.cuh` there from
`git show C:...` (C defaults to 3929914, the tree before the redesign, whose
passes probed one offset after another behind their dependent loads and
summed the rows in a second launch, `ndt_finish`); on a copy without git,
unpack them first (`git archive C lv_slam_tpu_torch/csrc | tar -x -C DIR`).
It builds that `ndt_lut.cu` with `kernels/_build.py`'s nvcc flags into
`_cache/ndt_lut_parent/`, and `scripts/ndt_lut_variants.cu` (it includes the
shipped `ndt_lut.cu` and carries its own copy of the pass with the variants'
knobs) beside it, two nvcc processes started together.

Checks, every one bit for bit (float bits; the standalone sums and the gated
pass's partial rows):
- K6L at chip_smoke.py phase 2f's shape (scan 1's 65536-lane subsample on
  scan 0's 32768-leaf keyframe map), DIRECT1 and DIRECT7, at the true pose
  and 0.3 m and 0.02 rad off; K6G there as the retry's arbiter scores
  (DIRECT1, weighted, the default outlier ratio) and as phase 8d's align
  (DIRECT7, unweighted);
- K6L on phase 11b's batch (K13's 1 m rung: the 8 candidates' 131072 lanes,
  DIRECT7, at their guesses);
- K6L and K6G on every `chip_smoke.lut_cases` entry (a finished candidate's
  gated rows untouched by both);
- the shipped standalone call's sums equal to its gated rows summed in row
  order, and to a second run;
- phase 8a's aligns (a fresh host-DLO pass over the 170 scans, recorded and
  replayed with each tree's gated pass): every transform, score and
  iteration count.
The route-B variants change the sums' order: their replayed transforms are
compared with the shipped ones, and the largest difference printed.

Times, in the same call: device-only medians over the whole calls among 20
in a torch.profiler trace (`chip_smoke.device_ms`) of the shipped kernel and
the earlier kernels (`ndt_lut_partials` / `ndt_generic_partials`, and
`ndt_finish` for a standalone call) at 2f's DIRECT1 (standalone and gated),
DIRECT7, K6G's arbiter and 11b's batch (its 8 gated passes); the traced
totals (`chip_smoke.align_replay`) of phase 8a's replayed aligns, the pass
and `newton_step`, with each tree (earlier, shipped, shipped, earlier) and
each route-B variant; and every variant's gated pass as a device span
(first kernel's start to last kernel's end, `_parent.span_ms`) at 2f's
DIRECT1 and DIRECT7, and the device time of its kernels (`device_ms`) for
the pass with `newton_step` over the variant's rows there and for 11b's 8
gated passes (a span there would hold the host's launch gaps). Prints one line per check and timing and writes them as
JSON to FILE (default `chiprun_out/ndt_lut_parent.json`), beside the card's
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

from _parent import build, fetch_parent, span_ms  # noqa: E402  (scripts/_parent.py)

COMMIT = "3929914"  # the tree before the redesign
SOURCES = ("ndt_lut.cu", "ndt_terms.cuh", "common.cuh")
CACHE = ROOT / "_cache" / "ndt_lut_parent"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier tree's C entries, the stream last
EARLIER = {
    "lvs_ndt_lut_derivatives": [P, P, P, F, I, P, I, P, P, F, F, P, I, I, P, I, P, P],
    "lvs_ndt_lut_partials": [P, P, P, F, I, P, I, P, P, P, F, F, P, I, I, P, I, P],
    "lvs_ndt_generic_derivatives": [P, P, P, P, P, F, I, P, I, P, P, F, F, P, I, I, P, I, P, P],
    "lvs_ndt_generic_partials": [P, P, P, P, P, F, I, P, I, P, P, P, F, F, P, I, I, P, I, P],
}
VARIANTS = ("route A, shipped (a block a row, DIRECT7's hits compacted, 2 blocks an SM)",
            "route A, one round an offset", "route A, a persistent grid", "route A, 3 blocks an SM (80 registers)",
            "route A, 1 block an SM (255 registers)", "route B, 2 points a thread (512-lane rows)",
            "route B, 4 points a thread (1024-lane rows)", "route A, DIRECT1's uniforms staged in shared memory")
ROUTE_B = (5, 6)


def stream(torch):
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def bits(torch, t):
    return t.view(torch.int32)


def same(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(bits(torch, a), bits(torch, b))


class Earlier:
    """The earlier tree's K6L and K6G over its library, on the shipped
    wrappers' argument lists (`_soa_args`, `_generic_args`)."""

    def __init__(self, torch, lib):
        self.torch = torch
        self.fns = {}
        for name, args in EARLIER.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            self.fns[name] = fn

    def _run(self, entry, *args):
        err = self.fns[entry](*args, stream(self.torch))
        if err:
            raise RuntimeError(f"the earlier {entry} failed with CUDA error {err}")

    def standalone(self, generic: bool, head, tail, n_blocks, transform):
        """(43,) sums: the partial rows, then `ndt_finish`."""
        from lv_slam_tpu_torch.kernels._build import ptr
        from lv_slam_tpu_torch.ops import ndt

        partials = self.torch.empty((n_blocks * ndt.N_TERMS,), dtype=self.torch.float32, device=transform.device)
        out = self.torch.empty((ndt.N_TERMS,), dtype=self.torch.float32, device=transform.device)
        entry = "lvs_ndt_generic_derivatives" if generic else "lvs_ndt_lut_derivatives"
        self._run(entry, *head, ptr(transform), *tail, ptr(partials), n_blocks, ptr(out))
        return out

    def gated(self, generic: bool, head, tail, n_blocks, state, partials):
        from lv_slam_tpu_torch.kernels._build import ptr

        entry = "lvs_ndt_generic_partials" if generic else "lvs_ndt_lut_partials"
        self._run(entry, *head, state.cand_ptr(), state.done_ptr(), *tail, ptr(partials), n_blocks)

    def soa_pass(self, soa, xs, mask, gauss, offsets, weighted):
        """`ndt_soa.soa_pass` with the earlier gated K6L."""
        from lv_slam_tpu_torch.ops import ndt, ndt_soa

        head, tail, n_blocks = ndt_soa._soa_args(soa, xs, mask, gauss, offsets, weighted)
        return ndt.DerivativePass(None, lambda state: self.gated(False, head, tail, n_blocks, state, state.partials),
                                  n_blocks)


class Variants:
    """K6L's design variants (`scripts/ndt_lut_variants.cu`, gated passes)."""

    def __init__(self, torch, lib):
        self.torch = torch
        self.lib = lib
        lib.lvs_variant_rows.argtypes, lib.lvs_variant_rows.restype = [I, I], ctypes.c_int
        lib.lvs_variant_lut_partials.argtypes = [I] + EARLIER["lvs_ndt_lut_partials"]
        lib.lvs_variant_lut_partials.restype = ctypes.c_int

    def rows(self, variant: int, n: int) -> int:
        return int(self.lib.lvs_variant_rows(variant, n))

    def gated(self, variant, head, tail, n_rows, state, partials):
        from lv_slam_tpu_torch.kernels._build import ptr

        err = self.lib.lvs_variant_lut_partials(variant, *head, state.cand_ptr(), state.done_ptr(), *tail,
                                                ptr(partials), n_rows, stream(self.torch))
        if err:
            raise RuntimeError(f"variant {variant} failed with CUDA error {err}")

    def soa_pass(self, variant, soa, xs, mask, gauss, offsets, weighted):
        from lv_slam_tpu_torch.ops import ndt, ndt_soa

        head, tail, _ = ndt_soa._soa_args(soa, xs, mask, gauss, offsets, weighted)
        n_rows = self.rows(variant, xs.shape[1])
        return ndt.DerivativePass(None, lambda state: self.gated(variant, head, tail, n_rows, state, state.partials),
                                  n_rows)


@contextlib.contextmanager
def soa_pass_of(make):
    """Within the block, the LUT aligns run their Newton loop over the
    gated pass that `make(soa, xs, mask, gauss, offsets, weighted)` builds."""
    from lv_slam_tpu_torch.ops import ndt_soa

    saved = ndt_soa.soa_pass
    ndt_soa.soa_pass = make
    try:
        yield
    finally:
        ndt_soa.soa_pass = saved


def build_variants(torch) -> ctypes.CDLL:
    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

    out = CACHE / "libndt_lut_variants.so"
    return subprocess.Popen([_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(ROOT / "lv_slam_tpu_torch" / "csrc"),
                             "-o", str(out), str(ROOT / "scripts" / "ndt_lut_variants.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def flagship(torch, scans, gt, dev):
    """Phase 2f's inputs: the keyframe map of scan 0's subsample, its LUT
    and packed rows, scan 1's subsample (xs, xyz, mask), the true pose and
    the config."""
    from lv_slam_tpu_torch import kitti_flagship_config
    from lv_slam_tpu_torch.core.cloud import PointCloud
    from lv_slam_tpu_torch.ops import ndt_soa, prefilter, voxel_map

    cfg = kitti_flagship_config()
    pf, ndt_cfg = cfg.prefilter, cfg.odometry.ndt

    def subsample(i):
        raw = PointCloud.from_numpy(scans[i], cap=pf.raw_cap, device=dev)
        return prefilter.uniform_subsample(prefilter.prefilter(raw, pf), cfg.odometry.scan_matching_cap)

    sub0, sub1 = subsample(0), subsample(1)
    vm = voxel_map.build_voxel_map(
        sub0, ndt_cfg.resolution, leaf_cap=ndt_cfg.leaf_cap, lut_extent=ndt_cfg.lut_extent,
        min_points_per_voxel=ndt_cfg.min_points_per_voxel, min_covar_eigvalue_mult=ndt_cfg.min_covar_eigvalue_mult,
        weighted=ndt_cfg.weighted)
    lut = voxel_map.build_lut(vm)
    rel = torch.from_numpy((np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)).to(dev)
    return (cfg, vm, lut, ndt_soa.to_soa(vm, lut), sub1.masked_xyz().T.contiguous(), sub1.masked_xyz().contiguous(),
            sub1.mask.contiguous(), rel)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT, help="the earlier tree's commit, where DIR is written from git")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "ndt_lut_parent.json")
    args = parser.parse_args()
    csrc = fetch_parent(args.parent or CACHE / args.commit, args.commit, SOURCES)
    if not torch.cuda.is_available():
        raise SystemExit("ndt_lut_parent: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs

    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.kernels import _build
    from lv_slam_tpu_torch.ops import ndt, ndt_soa, voxel_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    record = dict(card=smi, commit=args.commit, checks=[], times=[], replays=[], variants=[])
    CACHE.mkdir(parents=True, exist_ok=True)
    proc, variants_so = build_variants(torch)  # in flight with the earlier library's build
    earlier = Earlier(torch, build(csrc, ("ndt_lut.cu",), CACHE)["ndt_lut.cu"])
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on scripts/ndt_lut_variants.cu:\n{log}")
    variants = Variants(torch, ctypes.CDLL(str(variants_so)))
    _build.LIBRARY.load()
    usage = cs.ptxas_usage(log, names=("lut_pass",))
    record["ptxas_variants"] = usage
    for fn, u in sorted(usage.items()):
        print(f"ptxas (variants library): {fn}: {u}", flush=True)
    failed = []

    def check(name, ok, detail=""):
        record["checks"].append(dict(name=name, bit_identical=bool(ok), detail=detail))
        print(f"{name}: {'bit-identical' if ok else 'DIFFERS'}{', ' + detail if detail else ''}", flush=True)
        if not ok:
            failed.append(name)

    def sums_of(out):
        s, g, h = out
        return torch.cat([s.reshape(1), g.reshape(6), h.reshape(36)])

    def gated_rows(launch, n_blocks, transform, done=False):
        state = ndt.NewtonState(transform[None])
        state.s[0, ndt.S_DONE] = int(done)
        rows = torch.full((n_blocks * ndt.N_TERMS,), float("nan"), dtype=torch.float32, device=dev)
        state.partials = rows
        launch(state, rows)
        return rows

    def hold(name, generic, shipped_call, pass_, head, tail, n_blocks, transform, done=False):
        """The shipped standalone call and gated pass against the earlier kernels' at `transform`."""
        got = sums_of(shipped_call())
        again = sums_of(shipped_call())
        want = earlier.standalone(generic, head, tail, n_blocks, transform)
        check(f"{name}: the standalone sums", same(torch, got, want) and same(torch, got, again),
              "the earlier partial rows and ndt_finish, and a second run")
        mine = gated_rows(lambda st, rows: pass_.launch(st), n_blocks, transform, done)
        theirs = gated_rows(lambda st, rows: earlier.gated(generic, head, tail, n_blocks, st, rows), n_blocks,
                            transform, done)
        untouched = bool(torch.isnan(mine).all()) if done else True
        summed = True if done else same(torch, cs.probe_sums(torch, mine.view(1, n_blocks, ndt.N_TERMS))[0], got)
        check(f"{name}: the gated pass's partial rows", same(torch, mine, theirs) and untouched and summed,
              "a finished candidate's rows untouched" if done else "and the standalone sums their sum in row order")

    scans, gt = cs.load_scans(cs.N_FULL)
    cfg, vm, lut, soa, xs, xyz, mask, rel = flagship(torch, scans, gt, dev)
    ndt_cfg = cfg.odometry.ndt
    gauss = ndt.make_gauss_params(ndt_cfg.resolution, ndt_cfg.outlier_ratio)
    score_gauss = ndt.make_gauss_params(ndt_cfg.resolution)
    off = se3.exp_se3(torch.tensor([0.3, 0.0, 0.0, 0.0, 0.0, 0.02], device=dev))
    hoods = {h: voxel_map.neighborhood_offsets(h, dev) for h in ("DIRECT1", "DIRECT7")}
    poses = {"true pose": rel, "0.3 m and 0.02 rad off": (off @ rel).contiguous()}
    w = ndt_cfg.weighted
    for pose, t in poses.items():
        for hood, o in hoods.items():
            head, tail, nb = ndt_soa._soa_args(soa, xs, mask, gauss, o, w)
            hold(f"K6L, 2f {hood} at the {pose}", False,
                 lambda o=o, t=t: ndt_soa.ndt_derivatives_soa(soa, xs, mask, t, gauss, o, w),
                 ndt_soa.soa_pass(soa, xs, mask, gauss, o, w), head, tail, nb, t)
        for hood, g, wk in (("DIRECT1", score_gauss, w), ("DIRECT7", gauss, False)):
            o = hoods[hood]
            head, tail, nb = ndt._generic_args(vm, lut, xyz, mask, g, o, wk)
            hold(f"K6G, 2f {hood} {'weighted (the arbiter)' if wk else 'unweighted (8d)'} at the {pose}", True,
                 lambda o=o, t=t, g=g, wk=wk: ndt.ndt_derivatives(vm, lut, xyz, mask, t, g, o, wk),
                 ndt.generic_pass(vm, lut, xyz, mask, g, o, wk), head, tail, nb, t)

    # 11b's batch: K13's 1 m rung, each candidate's 131072 lanes at its guess
    keyframe, cands, guesses = cs.loop_batch(torch, scans, gt, dev)
    vm1 = voxel_map.build_voxel_map(keyframe, 1.0, leaf_cap=16384, lut_extent=256)
    soa1 = ndt_soa.to_soa(vm1, voxel_map.build_lut(vm1))
    g1 = ndt.make_gauss_params(1.0)
    batch = []
    for j, c in enumerate(cands):
        bxs, bmask = c.masked_xyz().T.contiguous(), c.mask.contiguous()
        head, tail, nb = ndt_soa._soa_args(soa1, bxs, bmask, g1, hoods["DIRECT7"], False)
        pass_ = ndt_soa.soa_pass(soa1, bxs, bmask, g1, hoods["DIRECT7"], False)
        hold(f"K6L, 11b's pair {j} ({bxs.shape[1]} lanes, DIRECT7)", False,
             lambda bxs=bxs, bmask=bmask, j=j: ndt_soa.ndt_derivatives_soa(soa1, bxs, bmask, guesses[j], g1,
                                                                           hoods["DIRECT7"], False),
             pass_, head, tail, nb, guesses[j].contiguous())
        batch.append((bxs, bmask, head, tail, nb, pass_, guesses[j].contiguous()))

    # lut_cases
    for case in cs.lut_cases():
        cvm, clut, csoa, cxs, cxyz, cmask, ctrans, cg, coff, cw, done = cs.lut_case_inputs(torch, case, dev)
        head, tail, nb = ndt_soa._soa_args(csoa, cxs, cmask, cg, coff, cw)
        hold(f"K6L, lut_cases: {case['name']}", False,
             lambda: ndt_soa.ndt_derivatives_soa(csoa, cxs, cmask, ctrans, cg, coff, cw),
             ndt_soa.soa_pass(csoa, cxs, cmask, cg, coff, cw), head, tail, nb, ctrans, done)
        head, tail, nb = ndt._generic_args(cvm, clut, cxyz, cmask, cg, coff, cw)
        hold(f"K6G, lut_cases: {case['name']}", True,
             lambda: ndt.ndt_derivatives(cvm, clut, cxyz, cmask, ctrans, cg, coff, cw),
             ndt.generic_pass(cvm, clut, cxyz, cmask, cg, coff, cw), head, tail, nb, ctrans, done)

    # phase 8a's aligns, replayed with each tree's gated pass: results, then traced totals
    def process(odo, i):
        from lv_slam_tpu_torch.core.cloud import PointCloud

        odo.process(PointCloud.from_numpy(scans[i], cap=cfg.prefilter.raw_cap, device=dev), i * 0.1)

    _, aligns = cs.host_dlo_pass(process, cfg, dev, len(scans))
    routes = {"earlier": lambda *a: earlier.soa_pass(*a), "shipped": ndt_soa.soa_pass}
    routes.update({VARIANTS[v]: (lambda *a, v=v: variants.soa_pass(v, *a)) for v in ROUTE_B})
    results = {}
    for name in ("earlier", "shipped", *(VARIANTS[v] for v in ROUTE_B), "shipped", "earlier"):
        out = []
        with soa_pass_of(routes[name]):
            traced = cs.align_replay(torch, aligns, f"{name} K6L",
                                     "ndt_lut_partials" if name == "earlier" else "lut_pass", out)
        record["replays"].append(dict(route=name, **traced))
        results.setdefault(name, out)
    want = results["earlier"]
    got = results["shipped"]
    ok = all(same(torch, a.transform, b.transform) and same(torch, a.score, b.score)
             and int(a.iterations) == int(b.iterations) for a, b in zip(got, want))
    check(f"8a's {len(aligns)} aligns replayed: transforms, scores and iterations", ok and len(got) == len(want))
    for v in ROUTE_B:
        diff = max(float((a.transform - b.transform).abs().max()) for a, b in zip(results[VARIANTS[v]], got))
        iters = sum(int(a.iterations) != int(b.iterations) for a, b in zip(results[VARIANTS[v]], got))
        record["variants"].append(dict(variant=VARIANTS[v], replay_max_transform_diff=diff, replay_iteration_diffs=iters))
        print(f"{VARIANTS[v]}: 8a's replayed transforms within {diff:.3g} of the shipped route's, {iters} aligns of "
              f"{len(got)} with another iteration count", flush=True)

    # times: the shipped kernel against the earlier kernels in the same call
    def timed(name, shipped_fn, earlier_fn, shipped_fns=("lut_pass",), earlier_fns=()):
        ms = cs.device_ms(torch, shipped_fn, shipped_fns)[0]
        parent_ms = cs.device_ms(torch, earlier_fn, earlier_fns)[0]
        record["times"].append(dict(name=name, ms=ms, parent_ms=parent_ms))
        print(f"{name}: shipped {ms:.4f} ms, earlier {parent_ms:.4f} ms (device-only, median of 20)", flush=True)

    standalone_fns = ("ndt_lut_partials", "ndt_finish")
    for hood, o in hoods.items():
        head, tail, nb = ndt_soa._soa_args(soa, xs, mask, gauss, o, w)
        timed(f"K6L standalone, 2f {hood}", lambda o=o: ndt_soa.ndt_derivatives_soa(soa, xs, mask, rel, gauss, o, w),
              lambda head=head, tail=tail, nb=nb: earlier.standalone(False, head, tail, nb, rel), earlier_fns=standalone_fns)
        pass_ = ndt_soa.soa_pass(soa, xs, mask, gauss, o, w)
        state = ndt.NewtonState(rel[None])
        state.partials = torch.empty((nb * ndt.N_TERMS,), dtype=torch.float32, device=dev)
        timed(f"K6L gated pass, 2f {hood}", lambda pass_=pass_, state=state: pass_.launch(state),
              lambda head=head, tail=tail, nb=nb, state=state: earlier.gated(False, head, tail, nb, state,
                                                                             state.partials),
              earlier_fns=("ndt_lut_partials",))
    head, tail, nb = ndt._generic_args(vm, lut, xyz, mask, score_gauss, hoods["DIRECT1"], w)
    timed("K6G standalone, 2f DIRECT1 (the arbiter)",
          lambda: ndt.ndt_derivatives(vm, lut, xyz, mask, rel, score_gauss, hoods["DIRECT1"], w),
          lambda: earlier.standalone(True, head, tail, nb, rel), earlier_fns=("ndt_generic_partials", "ndt_finish"))
    states = []
    for bxs, bmask, head, tail, nb, pass_, guess in batch:
        st = ndt.NewtonState(guess[None])
        st.partials = torch.empty((nb * ndt.N_TERMS,), dtype=torch.float32, device=dev)
        states.append(st)
    timed("K6L gated passes, 11b's batch (8 x 131072 lanes, DIRECT7)",
          lambda: [b[5].launch(st) for b, st in zip(batch, states)],
          lambda: [earlier.gated(False, b[2], b[3], b[4], st, st.partials) for b, st in zip(batch, states)],
          earlier_fns=("ndt_lut_partials",))

    # the variants as device spans: the gated pass, and the pass with newton_step over its rows
    p = ndt.loop_params(np.float32(ndt_cfg.transformation_epsilon), ndt_cfg.step_size, ndt_cfg.max_iterations)
    for v, vname in enumerate(VARIANTS):
        row = dict(variant=vname)
        for hood, o in hoods.items():
            head, tail, _ = ndt_soa._soa_args(soa, xs, mask, gauss, o, w)
            nr = variants.rows(v, xs.shape[1])
            state = ndt.NewtonState(rel[None])
            state.partials = torch.empty((nr * ndt.N_TERMS,), dtype=torch.float32, device=dev)
            f0, s0 = state.f.clone(), state.s.clone()

            def with_step(v=v, head=head, tail=tail, nr=nr, state=state, f0=f0, s0=s0):
                state.f.copy_(f0)
                state.s.copy_(s0)
                variants.gated(v, head, tail, nr, state, state.partials)
                ndt.newton_step(state, nr, p)

            row[f"2f_{hood}_rows"] = nr
            row[f"2f_{hood}_pass_span_ms"] = span_ms(torch, cs, lambda v=v, head=head, tail=tail, nr=nr, state=state:
                                                     variants.gated(v, head, tail, nr, state, state.partials))
            row[f"2f_{hood}_pass_and_step_ms"] = cs.device_ms(torch, with_step, ("lut_pass", "newton_step"))[0]
        vstates = []
        for bxs, bmask, head, tail, nb, pass_, guess in batch:
            nr = variants.rows(v, bxs.shape[1])
            st = ndt.NewtonState(guess[None])
            st.partials = torch.empty((nr * ndt.N_TERMS,), dtype=torch.float32, device=dev)
            vstates.append((head, tail, nr, st))
        row["11b_passes_ms"] = cs.device_ms(torch, lambda v=v, vstates=vstates: [
            variants.gated(v, h, t, nr, st, st.partials) for h, t, nr, st in vstates], ("lut_pass",))[0]
        record["variants"].append(row)
        print(f"variant {v}, {vname}: " + ", ".join(f"{k} {x:.4f}" if isinstance(x, float) else f"{k} {x}"
                                                  for k, x in row.items() if k != "variant"), flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    if failed:
        print(f"ndt_lut_parent: not bit-identical on {failed}", flush=True)
        return 1
    print(f"ndt_lut_parent: all {len(record['checks'])} checks bit-identical to the earlier tree's kernels", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
