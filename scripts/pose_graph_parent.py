#!/usr/bin/env python3
"""Holds kernel 15 (`lv_slam_tpu_torch/csrc/pose_graph.cu`, the pose graph's
normal equations) and the LM loop's kernels (`csrc/lm.cu`) bit for bit
against an earlier tree's on one NVIDIA GPU, and times both side by side.

    python scripts/pose_graph_parent.py [--parent DIR] [--commit C] [--out FILE]

DIR (default `_cache/pose_graph_parent/<C>`) holds the earlier tree's
`lv_slam_tpu_torch/csrc`. Where it is missing and the checkout has git, the
script writes `pose_graph.cu`, `lm.cu` and the headers they include there
from `git show C:...` (C defaults to 0ecec9e, the tree whose K15 was six
launches and whose LM iteration was 13); on a copy without git, unpack it
first (`git archive C lv_slam_tpu_torch/csrc | tar -x -C DIR`). It builds
those two files with `kernels/_build.py`'s nvcc flags into
`_cache/pose_graph_parent/` (ptxas's registers and spills printed for each
kernel, the parent's and the shipped library's), and drives them as that
tree's `graph/pose_graph.py` did (`Parent`).

Checks, every one bit for bit (float bits, NaN's too):
- raw H, b and chi2 (and the chi2-only pass) on chip_smoke phase 2c's and
  2g's graphs, a 512-node bucket (a KITTI sequence's size: 500 keyframes on
  a 1 km circle, 499 odometry and 24 loop edges in 1024 slots) and every
  `lm_cases` graph;
- the damped system and its right-hand side against the parent's
  `assemble` + `lm_damp`, at lambda 1e-4 and 3.0;
- iterations from identical states, the poses, planes, `lmf` and `lmi`
  after each, to done (at most 40);
- whole optimizes: poses, planes, chi2_after and iterations, on those
  graphs and on phase 5's recorded solves (`_cache/chip_smoke/
  phase5_solves.npz`, written by chip_smoke.py's phase 5; without it the
  script runs the full pure-lidar path once to record them);
- the sharded LM (`parallel/mesh.optimize_pose_graph_sharded`) on an NCCL
  world of one against the parent's LM with the same all-reduce, and
  against the shipped unsharded LM.

Times, the parent's and the shipped kernels' in the same call (device-only
medians as chip_smoke.py takes them, `device_ms`; whole optimizes by
`loop_ms`): K15 raw on each graph; one LM iteration's hand kernels and the
whole iteration; whole optimizes; phase 5's recorded solves in a row (the
hand kernels' device time from one trace); the library solve at phase 5's
last system; the hand launches an iteration takes. Prints one line per
check and timing and writes them as JSON to FILE (default
`chiprun_out/pose_graph_parent.json`), beside the card's name and power
limit.
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

COMMIT = "0ecec9e"  # the tree before the redesign
SOURCES = ("pose_graph.cu", "lm.cu", "common.cuh", "se3.cuh")
P, I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {  # the parent's C entries, each with the stream last
    "lvs_pose_graph_edges": [P] * 7 + [I, I, P, P, P],
    "lvs_pose_graph_priors": [P] * 7 + [I, I, P, P, P],
    "lvs_pose_graph_se3_planes": [P] * 8 + [I, I, P, P, P],
    "lvs_pose_graph_plane_edges": [P] * 8 + [I, I, P, P, P],
    "lvs_pose_graph_assemble": [P, P, P, P, I, P, P, P, I, P, P, P, P, I, P, P, P, P, I, I, I, I, P, P, P],
    "lvs_pose_graph_chi2": [P, I, P, P],
    "lvs_lm_damp": [P] * 6 + [I, I, P, P, P, P],
    "lvs_lm_update": [P] * 6 + [I, I, I, P],
    "lvs_lm_accept": [P] * 4 + [I, I, P, P, I],
}
# the parent's device functions (K15's six, the LM's three)
PARENT_FUNCTIONS = ("se3_edges", "priors", "se3_planes", "plane_edges", "assemble", "chi2_sum", "lm_damp",
                    "lm_update", "lm_accept")
SHIPPED_FUNCTIONS = ("normal_cluster", "lm_damp", "lm_step", "lm_accept")


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

    return ctypes.CDLL(str(out)), cs.ptxas_usage(done.stdout + done.stderr, PARENT_FUNCTIONS + SHIPPED_FUNCTIONS)


def same(torch, a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


class Parent:
    """The earlier tree's K15 and LM kernels, driven as its
    `graph/pose_graph.py` drove them."""

    def __init__(self, torch, lib):
        self.torch = torch
        self.fns = {}
        for name, argtypes in ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
            self.fns[name] = fn

    def call(self, name, *args):
        err = self.fns[name](*args, ctypes.c_void_p(self.torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the parent's {name} failed with CUDA error {err}")

    def k15(self, g, poses, planes, build, rho, blk, h, b, chi2, done):
        from lv_slam_tpu_torch.graph import pose_graph as pg
        from lv_slam_tpu_torch.kernels._build import ptr

        n_e, n_p, n_s, n_r = pg._family_sizes(g)
        rho_p, rho_s, rho_r = rho[n_e:], rho[n_e + n_p:], rho[n_e + n_p + n_s:]
        blk_e, blk_p, blk_s, blk_r = ([ctypes.c_void_p(blk.data_ptr() + 4 * o) for o in pg._block_offsets(g)[:4]]
                                      if build else [None] * 4)
        self.call("lvs_pose_graph_edges", ptr(poses), ptr(g.e_i), ptr(g.e_j), ptr(g.e_meas), ptr(g.e_info),
                  ptr(g.e_huber), ptr(g.e_valid), n_e, int(build), ptr(rho), blk_e, done)
        self.call("lvs_pose_graph_priors", ptr(poses), ptr(g.p_node), ptr(g.p_type), ptr(g.p_meas), ptr(g.p_info),
                  ptr(g.p_huber), ptr(g.p_valid), n_p, int(build), ptr(rho_p), blk_p, done)
        self.call("lvs_pose_graph_se3_planes", ptr(poses), ptr(planes), ptr(g.sp_i), ptr(g.sp_plane),
                  ptr(g.sp_meas), ptr(g.sp_info), ptr(g.sp_huber), ptr(g.sp_valid), n_s, int(build), ptr(rho_s),
                  blk_s, done)
        self.call("lvs_pose_graph_plane_edges", ptr(planes), ptr(g.q_i), ptr(g.q_j), ptr(g.q_type), ptr(g.q_meas),
                  ptr(g.q_info), ptr(g.q_huber), ptr(g.q_valid), n_r, int(build), ptr(rho_r), blk_r, done)
        if build:
            self.call("lvs_pose_graph_assemble", ptr(g.e_i), ptr(g.e_j), ptr(g.e_valid), blk_e, n_e, ptr(g.p_node),
                      ptr(g.p_valid), blk_p, n_p, ptr(g.sp_i), ptr(g.sp_plane), ptr(g.sp_valid), blk_s, n_s,
                      ptr(g.q_i), ptr(g.q_j), ptr(g.q_valid), blk_r, n_r, g.node_cap, g.plane_cap, pg._n_dofs(g),
                      ptr(h), ptr(b), done)
        if chi2 is not None:
            self.call("lvs_pose_graph_chi2", ptr(rho), rho.shape[0], chi2, done)

    def chi2_and_normal(self, g, poses, build, planes):
        from lv_slam_tpu_torch.graph import pose_graph as pg
        from lv_slam_tpu_torch.kernels._build import ptr

        torch, dev, n = self.torch, poses.device, pg._n_dofs(g)
        rho = torch.empty((pg._n_terms(g),), dtype=torch.float32, device=dev)
        chi2 = torch.empty((), dtype=torch.float32, device=dev)
        h = torch.zeros((n, n) if build else (1, 1), dtype=torch.float32, device=dev)
        b = torch.zeros((n,) if build else (1,), dtype=torch.float32, device=dev)
        self.k15(g, poses, planes, build, rho, pg._block_scratch(g, dev) if build else None, h, b, ptr(chi2), None)
        return (chi2, h, b) if build else (chi2, None, None)

    def damped(self, g, poses, planes, lam):
        """The parent's damped system: the raw build into zeros, then `lm_damp`."""
        from lv_slam_tpu_torch.graph import pose_graph as pg
        from lv_slam_tpu_torch.kernels._build import ptr

        torch, dev, n = self.torch, poses.device, pg._n_dofs(g)
        _, h, b = self.chi2_and_normal(g, poses, True, planes)
        lmf = torch.full((4,), lam, dtype=torch.float32, device=dev)
        lmi = torch.zeros((4,), dtype=torch.int32, device=dev)
        damped = torch.empty((n, n), dtype=torch.float32, device=dev)
        rhs = torch.empty((n,), dtype=torch.float32, device=dev)
        self.call("lvs_lm_damp", ptr(h), ptr(b), ptr(g.node_valid), ptr(g.node_fixed), ptr(g.plane_valid),
                  ptr(g.plane_fixed), g.node_cap, n, ptr(lmf), ptr(lmi), ptr(damped), ptr(rhs))
        return damped, rhs

    def state(self, g, chi2_0):
        """An LM state the parent's iteration takes: H and b zeros."""
        from lv_slam_tpu_torch.graph import pose_graph as pg

        st = pg.LMState(g, chi2_0, sharded=True)
        st.h.zero_()
        st.b.zero_()
        return st

    def iteration(self, g, st, num_iterations, reduce=None):
        """The parent's `_lm_iteration`."""
        from lv_slam_tpu_torch.graph import pose_graph as pg
        from lv_slam_tpu_torch.kernels._build import ptr

        torch = self.torch
        k, q, n = g.node_cap, g.plane_cap, pg._n_dofs(g)
        done = st.done_ptr()
        self.k15(g, st.poses, st.planes, True, st.rho, st.blk, st.h, st.b, None, done)
        if reduce is not None:
            reduce(st.h)
            reduce(st.b)
        self.call("lvs_lm_damp", ptr(st.h), ptr(st.b), ptr(g.node_valid), ptr(g.node_fixed), ptr(g.plane_valid),
                  ptr(g.plane_fixed), k, n, ptr(st.lmf), ptr(st.lmi), ptr(st.damped), ptr(st.rhs))
        chol, info = torch.linalg.cholesky_ex(st.damped)
        delta = torch.cholesky_solve(st.rhs, chol)
        self.call("lvs_lm_update", ptr(delta), ptr(info), ptr(st.poses), ptr(st.planes), ptr(st.cand_poses),
                  ptr(st.cand_planes), k, q, n, ptr(st.lmi))
        self.k15(g, st.cand_poses, st.cand_planes, False, st.rho, st.blk, st.h, st.b,
                 ctypes.c_void_p(st.lmf.data_ptr() + 4 * pg.L_NEW_CHI2), done)
        if reduce is not None:
            reduce(st.lmf[pg.L_NEW_CHI2:pg.L_NEW_CHI2 + 1])
        self.call("lvs_lm_accept", ptr(st.poses), ptr(st.planes), ptr(st.cand_poses), ptr(st.cand_planes), k, q,
                  ptr(st.lmf), ptr(st.lmi), num_iterations)

    def optimize(self, graph, num_iterations, dev, reduce=None):
        """The parent's `optimize_pose_graph` (its loop is the shipped one)."""
        from lv_slam_tpu_torch.core import se3
        from lv_slam_tpu_torch.graph import pose_graph as pg

        g = pg.to_device(graph, dev)
        chi2_0, _, _ = self.chi2_and_normal(g, g.poses, False, g.planes)
        if reduce is not None:
            reduce(chi2_0.view(1))
        st = self.state(g, chi2_0)
        bound, launched = max(num_iterations, 1), 0
        while launched < bound:
            for _ in range(min(pg.LM_GROUP, bound - launched)):
                self.iteration(g, st, num_iterations, reduce)
                launched += 1
            if launched < bound and bool(st.lmi[pg.M_DONE]):
                break
        anchor = g.poses[0] @ se3.inverse(st.poses[0])
        poses = self.torch.einsum("ij,njk->nik", anchor, st.poses)
        return pg.OptimizeResult(poses=poses, chi2_before=chi2_0, chi2_after=st.lmf[pg.L_CHI2],
                                 iterations=st.lmi[pg.M_IT], planes=st.planes)


def kitti_bucket_graph(torch, n_keyframes: int = 500, node_cap: int = 512, edge_cap: int = 1024):
    """A KITTI sequence's bucket: `n_keyframes` keyframes every 2 m on a
    1 km circle (0.05 m / 0.01 rad of noise), odometry edges and a loop
    from every 4th of the last 96 keyframes to the first ones, in
    chip_smoke phase 5's family caps (8 prior, 8 SE3-plane, 16 plane-plane
    slots, all invalid, 8 planes)."""
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.graph import pose_graph as pg
    from lv_slam_tpu_torch.io import synthetic

    rng = np.random.default_rng(5)
    gt = synthetic.circle_trajectory(2 * n_keyframes, step=1.0)
    kf = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)[::2][:n_keyframes]

    def noise(scale_t, scale_r):
        d = np.r_[rng.normal(0, scale_t, 3), rng.normal(0, scale_r, 3)].astype(np.float32)
        return se3.exp_se3(torch.from_numpy(d)).double().numpy()

    g = pg.empty_graph(node_cap, edge_cap, 8, 8, 8, 16)
    info = np.diag([2.0] * 3 + [10.0] * 3)
    for i in range(n_keyframes):
        pg.add_node(g, i, kf[i] @ noise(0.05, 0.01))
    e = 0
    for i in range(1, n_keyframes):
        pg.add_se3_edge(g, e, i, i - 1, np.linalg.inv(kf[i]) @ kf[i - 1] @ noise(0.01, 0.002), info, huber=1.0)
        e += 1
    for i in range(n_keyframes - 96, n_keyframes, 4):
        j = i - (n_keyframes - 96)
        pg.add_se3_edge(g, e, i, j, np.linalg.inv(kf[i]) @ kf[j], info, huber=1.0)
        e += 1
    return g


def phase5_solves(torch, cs, dev):
    """Phase 5's recorded solves [(graph, num_iterations)]: chip_smoke.py's
    record, or one run of the full pure-lidar path recorded here."""
    path = cs.CACHE / "phase5_solves.npz"
    if not path.exists():
        from lv_slam_tpu_torch import kitti_flagship_config

        cfg = kitti_flagship_config()
        if (cs.CACHE / f"scans_v1_{cs.N_FULL}.npz").exists():
            scans, gt = cs.load_scans(cs.N_FULL)
        else:
            with multiprocessing.get_context("spawn").Pool(8) as pool:
                scans = pool.starmap(cs._simulate, [(i, cs.N_FULL) for i in range(cs.N_FULL)])
        xyz, mask, stamps, inten = cs.stack_scans(torch, scans, cfg.prefilter.raw_cap, dev)
        _, solves = cs.recorded_solves(lambda: cs.run_full(torch, xyz, mask, stamps, inten, cfg,
                                                        cs.make_backend(dev, asynchronous=True)))
        cs.save_solves(solves)
    return cs.load_solves()


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="an earlier tree holding lv_slam_tpu_torch/csrc")
    parser.add_argument("--commit", default=COMMIT, help="the earlier tree's commit, where DIR is written from git")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "pose_graph_parent.json")
    args = parser.parse_args()
    parent_dir = args.parent or ROOT / "_cache" / "pose_graph_parent" / args.commit
    csrc = fetch_parent(parent_dir, args.commit)
    if not torch.cuda.is_available():
        raise SystemExit("pose_graph_parent: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    import chip_smoke as cs

    from lv_slam_tpu_torch.graph import pose_graph as pg
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    record = dict(card=smi, commit=args.commit, checks=[], times=[])
    lib, before = build([csrc / name for name in SOURCES if name.endswith(".cu")], csrc,
                        ROOT / "_cache" / "pose_graph_parent" / "libparent.so")
    _build.LIBRARY.load()
    after = cs.ptxas_usage((_build.BUILD_DIR / "build.log").read_text(), SHIPPED_FUNCTIONS)
    record["ptxas"] = dict(parent=before, shipped=after)
    for what, usage in (("parent", before), ("shipped", after)):
        for fn, u in sorted(usage.items()):
            print(f"ptxas {what}: {fn}: {u}", flush=True)
    parent = Parent(torch, lib)
    failed = []

    def check(name, ok, detail=""):
        record["checks"].append(dict(name=name, bit_identical=bool(ok), detail=detail))
        print(f"{name}: {'bit-identical' if ok else 'DIFFERS'}{', ' + detail if detail else ''}", flush=True)
        if not ok:
            failed.append(name)

    gt = synthetic.circle_trajectory(cs.N_FULL, step=1.0)
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    graphs = {"2c": (cs.backend_graph(torch, rel, False)[0], 1024), "2g": (cs.backend_graph(torch, rel, True)[0], 1024),
              "512-node bucket": (kitti_bucket_graph(torch), 1024)}
    graphs.update({f"lm_cases: {name}": (graph, it) for name, graph, it in cs.lm_cases(torch)})
    solves = phase5_solves(torch, cs, dev)
    print(f"phase 5's recorded solves: {len(solves)} (iterations asked {[it for _, it in solves]})", flush=True)

    for name, (graph, num_iterations) in graphs.items():
        g = pg.to_device(graph, dev)
        got, want = pg._chi2_and_normal(g, g.poses, True), parent.chi2_and_normal(g, g.poses, True, g.planes)
        chi2_only, want_chi2 = pg._chi2_and_normal(g, g.poses, False)[0], parent.chi2_and_normal(g, g.poses, False,
                                                                                                  g.planes)[0]
        check(f"K15 raw (chi2, H, b) and the chi2 pass, {name}",
              all(same(torch, x, y) for x, y in zip(got, want)) and same(torch, chi2_only, want_chi2))
        ok = True
        for lam in (1e-4, 3.0):
            d, r = pg._damped_system(g, g.poses, g.planes, lam)
            wd, wr = parent.damped(g, g.poses, g.planes, lam)
            ok = ok and same(torch, d, wd) and same(torch, r, wr)
        check(f"K15 damped (the system and rhs) against assemble + lm_damp, lambda 1e-4 and 3, {name}", ok)
        # iterations from identical states
        chi2_0, _, _ = pg._chi2_and_normal(g, g.poses, False, g.planes)
        a, b = pg.LMState(g, chi2_0), parent.state(g, chi2_0)
        steps, ok = 0, True
        while steps < 40:
            pg._lm_iteration(g, a, num_iterations)
            parent.iteration(g, b, num_iterations)
            steps += 1
            ok = all(same(torch, getattr(a, f), getattr(b, f)) for f in ("poses", "planes", "lmf", "lmi"))
            if not ok or bool(a.lmi[pg.M_DONE]):
                break
        check(f"LM iterations from identical states (poses, planes, lmf, lmi), {name}", ok,
              f"{steps} iterations compared")
        want_opt = parent.optimize(graph, num_iterations, dev)
        got_opt = pg.optimize_pose_graph(graph, num_iterations, device=dev)
        check(f"whole optimize (poses, planes, chi2_after, iterations), {name}",
              all(same(torch, getattr(got_opt, f), getattr(want_opt, f))
                  for f in ("poses", "planes", "chi2_after", "iterations")),
              f"{int(got_opt.iterations)} iterations")

    ok, its = True, []
    for i, (graph, num_iterations) in enumerate(solves):
        got_opt = pg.optimize_pose_graph(graph, num_iterations, device=dev)
        want_opt = parent.optimize(graph, num_iterations, dev)
        its.append(int(got_opt.iterations))
        ok = ok and all(same(torch, getattr(got_opt, f), getattr(want_opt, f))
                        for f in ("poses", "planes", "chi2_after", "iterations"))
    check(f"phase 5's {len(solves)} recorded solves, whole optimizes", ok, f"iterations {its}")

    # the sharded LM on an NCCL world of one
    import torch.distributed as dist

    from lv_slam_tpu_torch.parallel import mesh as pmesh

    store = ROOT / "_cache" / "pose_graph_parent" / "nccl_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        m = pmesh.make_mesh(1, 1)
        graph = graphs["2c"][0]
        got = pmesh.optimize_pose_graph_sharded(m, graph, 64)
        reduce = lambda t: dist.all_reduce(t, op=dist.ReduceOp.SUM)  # noqa: E731
        want = parent.optimize(graph, 64, dev, reduce=reduce)
        unsharded = pg.optimize_pose_graph(graph, 64, device=dev)
        check("the sharded LM on an NCCL world of one, 2c: against the parent's with the same all-reduce, and the "
              "shipped unsharded LM", all(same(torch, getattr(got, f), getattr(want, f)) and
                                          same(torch, getattr(got, f), getattr(unsharded, f)) for f in got._fields))
    finally:
        dist.destroy_process_group()

    # times, the parent's and the shipped kernels' in the same call
    def timed(name, shipped, earlier, functions=(SHIPPED_FUNCTIONS, PARENT_FUNCTIONS), **extra):
        ms, ms_all, _ = cs.device_ms(torch, shipped, functions[0])
        pms, pms_all, _ = cs.device_ms(torch, earlier, functions[1])
        record["times"].append(dict(name=name, ms=ms, parent_ms=pms, all_device_ms=ms_all,
                                    parent_all_device_ms=pms_all, **extra))
        print(f"{name}: shipped {ms:.4f} ms, parent {pms:.4f} ms (hand kernels; all device work {ms_all:.4f} / "
              f"{pms_all:.4f}) (device-only, median of {cs.REPS})", flush=True)

    for name in ("2c", "2g", "512-node bucket"):
        graph, _ = graphs[name]
        g = pg.to_device(graph, dev)
        timed(f"K15 raw, {name}", lambda g=g: pg._chi2_and_normal(g, g.poses, True),
              lambda g=g: parent.chi2_and_normal(g, g.poses, True, g.planes))
        chi2_0, _, _ = pg._chi2_and_normal(g, g.poses, False, g.planes)
        st0 = pg.LMState(g, chi2_0)
        pst0 = parent.state(g, chi2_0)
        st, pst = st0.clone(), parent.state(g, chi2_0)

        def restore(dst, src):
            for key, v in src.__dict__.items():
                if key != "args":
                    getattr(dst, key).copy_(v)

        def shipped_it(g=g, st=st, st0=st0):
            restore(st, st0)
            pg._lm_iteration(g, st, 1024)

        def parent_it(g=g, st=pst, st0=pst0):
            restore(st, st0)
            parent.iteration(g, st, 1024)

        launches = (len(cs.hand_launches(torch, shipped_it, SHIPPED_FUNCTIONS)),
                    len(cs.hand_launches(torch, parent_it, PARENT_FUNCTIONS)))
        timed(f"one LM iteration, {name}", shipped_it, parent_it, hand_launches=launches)
        print(f"  hand launches per iteration, {name}: shipped {launches[0]}, parent {launches[1]}", flush=True)
        dev_ms, wall_ms = cs.loop_ms(torch, lambda graph=graph: pg.optimize_pose_graph(graph, 1024, device=dev),
                                     reps=3)
        pdev_ms, pwall_ms = cs.loop_ms(torch, lambda graph=graph: parent.optimize(graph, 1024, dev), reps=3)
        it = int(pg.optimize_pose_graph(graph, 1024, device=dev).iterations)
        record["times"].append(dict(name=f"whole optimize, {name}", iterations=it, device_ms=dev_ms, wall_ms=wall_ms,
                                    parent_device_ms=pdev_ms, parent_wall_ms=pwall_ms))
        print(f"whole optimize, {name} ({it} iterations): shipped device {dev_ms:.3f} ms, wall {wall_ms:.3f} ms; "
              f"parent device {pdev_ms:.3f} ms, wall {pwall_ms:.3f} ms (chip_smoke.loop_ms)", flush=True)

    # phase 5's recorded solves in a row: the hand kernels' device time from one trace
    def all_solves(run):
        def go():
            for graph, num_iterations in solves:
                run(graph, num_iterations)
        return go

    shipped_run = all_solves(lambda graph, it: pg.optimize_pose_graph(graph, it, device=dev))
    parent_run = all_solves(lambda graph, it: parent.optimize(graph, it, dev))
    for what, run, functions in (("shipped", shipped_run, SHIPPED_FUNCTIONS), ("parent", parent_run,
                                                                                 PARENT_FUNCTIONS)):
        ms, ms_all, _ = cs.device_ms(torch, run, functions, reps=3)
        record["times"].append(dict(name=f"phase 5's {len(solves)} solves, K15 + LM hand kernels, {what}", ms=ms,
                                    all_device_ms=ms_all))
        print(f"phase 5's {len(solves)} solves in a row, {what}: K15 + LM hand kernels {ms:.4f} ms, all device work "
              f"{ms_all:.4f} ms", flush=True)

    # the library solve at phase 5's last system
    graph, _ = solves[-1]
    g = pg.to_device(graph, dev)
    damped, rhs = pg._damped_system(g, g.poses, g.planes, 1e-4)

    def solve():
        chol, _ = torch.linalg.cholesky_ex(damped)
        return torch.cholesky_solve(rhs[:, None], chol)

    _, chol_ms, _ = cs.device_ms(torch, solve)
    n = damped.shape[0]
    record["times"].append(dict(name=f"cholesky_ex + cholesky_solve, phase 5's last system ({n} x {n})", ms=chol_ms))
    print(f"the library solve (cholesky_ex + cholesky_solve) on phase 5's last system, {n} x {n}: {chol_ms:.4f} ms "
          f"device-only", flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    if failed:
        print(f"pose_graph_parent: not bit-identical on {failed}", flush=True)
        return 1
    print(f"pose_graph_parent: all {len(record['checks'])} checks bit-identical to the parent tree's kernels",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
