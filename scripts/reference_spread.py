#!/usr/bin/env python3
"""The JAX reference's own rounding spread, where the port's parity tests
hold the port to it (CPU; needs JAX):

    JAX_PLATFORMS=cpu python scripts/reference_spread.py eigh      # ~10 s
    JAX_PLATFORMS=cpu python scripts/reference_spread.py backend   # ~2 min
    JAX_PLATFORMS=cpu python scripts/reference_spread.py lfa       # ~1 min
    JAX_PLATFORMS=cpu python scripts/reference_spread.py lfa_host  # ~2 min
    JAX_PLATFORMS=cpu python scripts/reference_spread.py slam      # ~2 min
    JAX_PLATFORMS=cpu python scripts/reference_spread.py dlo       # ~2 min
    JAX_PLATFORMS=cpu python scripts/reference_spread.py slam_dlo  # ~3 min
    JAX_PLATFORMS=cpu python scripts/reference_spread.py fused_lut # ~1 min

`eigh`: JAX's and the port's `eigh3x3` on matrices with an exactly repeated
eigenvalue pair (seeds 13-44, `tests/test_torch_voxel_map.py`'s generator):
the largest difference of a paired eigenvalue over lambda_max, and of the
isolated one over the test's 1e-5 tolerance.

`backend`: the reference's `GlobalGraph` with no images on
`tests/test_torch_backend.py`'s circle, per chunk and per scan, against the
same run with every filtered coordinate moved by at most one ulp (4
perturbations each): keyframes and loop pairs of each perturbed run, and,
where those stay, the largest move of a keyframe estimate.

`lfa`: standalone `run_sequence_lfa` (no odometry) on the conftest
`small_sequence`, in `tests/test_torch_lfa_fused.py`'s default and
`crop_every_scan` variants, against the same run with every valid input
coordinate moved by at most one ulp (8 perturbations): per scan, the
largest move of the refined translation, and of a rotation entry.

`lfa_host`: the host `LfaPipeline` on `tests/test_lfa.py`'s 8-scan figure-8
(32 rings x 900), the same 8 perturbations of the raw scans: per scan, the
largest move of the odometry and of the refined pose.

`slam`: `LvSlam(use_dlo=False)` on `small_sequence` with
`tests/test_slam_pipeline.py`'s small configuration, 8 perturbations: per
scan, the largest move of the LFA pose; keyframes and loops of each run.

`dlo`: the host `DirectLidarOdometry` on `small_sequence` in
`tests/test_torch_dlo.py`'s configurations (`NDTConfig(leaf_cap=16384)`
without and with the prefilter, and with a 1 mm retry threshold), 8
perturbations: per scan, the largest move of the pose; the keyframes and
the scans whose retry was kept, of each run.

`fused_lut`: `run_sequence_fused` with `NDTConfig(table="lut")` on
`small_sequence` in `tests/test_torch_odometry.py`'s configuration, 16
perturbations (as that file's hash-table spread): per scan, the largest
move of the pose.

`slam_dlo`: `LvSlam()` at its default (`use_dlo=True`) with the small
configuration, 8 perturbations: per scan, the largest move of the DLO and
of the LFA pose; keyframes and loops of each run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "tests")]


def eigh() -> None:
    import jax.numpy as jnp
    import torch

    from lv_slam_tpu.ops.linalg3 import eigh3x3 as j_eigh
    from lv_slam_tpu_torch.ops.linalg3 import eigh3x3 as t_eigh

    pair_worst = iso_worst = 0.0
    for seed in range(13, 45):
        rng = np.random.default_rng(seed)
        q, _ = np.linalg.qr(rng.normal(size=(256, 3, 3)))
        lam = rng.uniform(1e-3, 2.0, (256, 3))
        lam[:128, 1] = lam[:128, 0]
        lam[128:, 2] = lam[128:, 1]
        a = np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)
        ej = np.asarray(j_eigh(jnp.asarray(a))[0])
        et = t_eigh(torch.from_numpy(a))[0].numpy()
        s = np.sort(lam, 1)
        low = np.isclose(s[:, 0], s[:, 1])
        n = np.arange(256)
        pair = np.where(low[:, None], [0, 1], [1, 2])
        iso = np.where(low, 2, 0)
        lmax = np.abs(ej).max(1)
        pair_worst = max(pair_worst, float((np.abs(et[n[:, None], pair] - ej[n[:, None], pair]).max(1) / lmax).max()))
        tol = 1e-5 * np.abs(ej[n, iso]) + 1e-6 * lmax
        iso_worst = max(iso_worst, float((np.abs(et[n, iso] - ej[n, iso]) / tol).max()))
    print(f"paired eigenvalues: largest |port - jax| / lambda_max {pair_worst:.3g} "
          f"(sqrt(eps_f32) = {np.sqrt(np.finfo(np.float32).eps):.3g}); isolated: {iso_worst:.3g} of the 1e-5 tolerance")


def backend() -> None:
    import test_torch_backend as t

    filt, odoms = t.circle.__wrapped__()

    def perturbed(seed):
        rng = np.random.default_rng(seed)
        out = []
        for xyz, inten, mask in filt:
            step = rng.integers(-1, 2, xyz.shape)
            moved = np.where(step > 0, np.nextafter(xyz, np.float32(np.inf)),
                             np.where(step < 0, np.nextafter(xyz, np.float32(-np.inf)), xyz))
            out.append((np.where(mask[:, None], moved, xyz).astype(np.float32), inten, mask))
        return out

    for per_scan in (False, True):
        base = t._jax(filt, odoms, per_scan)
        mode = "per scan" if per_scan else "per chunk"
        print(f"{mode}: keyframes {base['seqs']}, loops {base['loops']}")
        for seed in range(4):
            run = t._jax(perturbed(seed), odoms, per_scan)
            if run["seqs"] != base["seqs"] or run["loops"] != base["loops"]:
                print(f"  perturbation {seed}: keyframes {run['seqs']}, loops {run['loops']}")
                continue
            dt = np.linalg.norm(run["estimates"][:, :3, 3] - base["estimates"][:, :3, 3], axis=1).max()
            rot = np.abs(run["estimates"][:, :3, :3] - base["estimates"][:, :3, :3]).max()
            print(f"  perturbation {seed}: same keyframes and loops; estimates move by up to {dt:.4g} m, "
                  f"a rotation entry by {rot:.3g}")


def _nudge(xyz: np.ndarray, valid: np.ndarray, seed: int) -> np.ndarray:
    """Every valid float32 coordinate moved by -1, 0 or +1 ulp."""
    rng = np.random.default_rng(seed)
    step = rng.integers(-1, 2, xyz.shape)
    moved = np.where(step > 0, np.nextafter(xyz, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(xyz, np.float32(-np.inf)), xyz))
    return np.where(valid[..., None], moved, xyz).astype(np.float32)


def _spread(runs):
    """(per-scan largest translation move, largest rotation-entry move) of
    runs[1:] against runs[0], each (N, 4, 4)."""
    base = runs[0]
    dt = np.max([np.abs(r[:, :3, 3] - base[:, :3, 3]).max(axis=1) for r in runs[1:]], axis=0)
    rot = max(float(np.abs(r[:, :3, :3] - base[:, :3, :3]).max()) for r in runs[1:])
    return np.array2string(dt, formatter={"float_kind": lambda x: f"{x:.3g}"}), f"{rot:.3g}"


def lfa() -> None:
    import jax.numpy as jnp

    import conftest
    import test_torch_lfa_fused as t
    from lv_slam_tpu.config import LfaConfig
    from lv_slam_tpu.core.cloud import PointCloud
    from lv_slam_tpu.lfa.fused import run_sequence_lfa

    scans, _, _ = conftest.small_sequence.__wrapped__()
    clouds = [PointCloud.from_numpy(s, cap=t.CAP) for s in scans]
    xyz = np.stack([np.asarray(c.xyz) for c in clouds])
    mask = np.stack([np.asarray(c.mask) for c in clouds])
    for variant in ("default", "crop_every_scan"):
        cfg = LfaConfig(**t.KW, **t.VARIANTS[variant])
        runs = [np.asarray(run_sequence_lfa(jnp.asarray(x), jnp.asarray(mask), cfg))
                for x in [xyz] + [_nudge(xyz, mask, seed) for seed in range(8)]]
        dt, rot = _spread(runs)
        print(f"{variant}: refined translation moves per scan {dt} m, rotation entries up to {rot}")


def lfa_host() -> None:
    import test_lfa as t
    from lv_slam_tpu.lfa.pipeline import LfaPipeline

    scans, _ = t.lfa_sequence.__wrapped__()
    odom_runs, refined_runs = [], []
    for seed in [None] + list(range(8)):
        pipe = LfaPipeline(t._CFG)
        odoms, refined = [], []
        for s in scans:
            s = np.asarray(s, np.float32)
            if seed is not None:
                s = np.concatenate([_nudge(s[:, :3], np.ones(len(s), bool), seed), s[:, 3:]], axis=1)
            refined.append(pipe.process_numpy(s, cap=32768))
            odoms.append(pipe.odometry._pose.copy())
        odom_runs.append(np.stack(odoms))
        refined_runs.append(np.stack(refined))
    for name, runs in (("odometry", odom_runs), ("refined", refined_runs)):
        dt, rot = _spread(runs)
        print(f"{name}: translation moves per scan {dt} m, rotation entries up to {rot}")


def slam() -> None:
    import conftest
    import test_slam_pipeline as t
    from lv_slam_tpu.pipeline.slam import LvSlam

    scans, _, _ = conftest.small_sequence.__wrapped__()
    runs = []
    for seed in [None] + list(range(8)):
        slam_ = LvSlam(t._small_cfg(), use_dlo=False, optimize_every=4, scan_cap=32768)
        for i, s in enumerate(scans):
            s = np.asarray(s, np.float32)
            if seed is not None:
                s = np.concatenate([_nudge(s[:, :3], np.ones(len(s), bool), seed), s[:, 3:]], axis=1)
            slam_.process(s, i * 0.1)
        slam_.finalize()
        runs.append(np.stack(slam_.lfa_poses))
        print(f"run {seed}: keyframes {[k.seq for k in slam_.backend.keyframes]}, loops "
              f"{[(lp.key1.seq, lp.key2.seq) for lp in slam_.backend.loops]}")
    dt, rot = _spread(runs)
    print(f"LFA poses: translation moves per scan {dt} m, rotation entries up to {rot}")


def _nudged_scans(scans, seed):
    if seed is None:
        return [np.asarray(s, np.float32) for s in scans]
    return [np.concatenate([_nudge(np.asarray(s, np.float32)[:, :3], np.ones(len(s), bool), seed),
                            np.asarray(s, np.float32)[:, 3:]], axis=1) for s in scans]


def dlo() -> None:
    import conftest
    import test_torch_dlo as t
    from lv_slam_tpu.odometry.dlo import DirectLidarOdometry

    scans, _, _ = conftest.small_sequence.__wrapped__()
    for variant, (cfg, pf) in t.reference_configs().items():
        runs = []
        for seed in [None] + list(range(8)):
            odo = DirectLidarOdometry(cfg, pf)
            poses, retried = [], []
            for i, s in enumerate(_nudged_scans(scans, seed)):
                before = odo.stats.retries
                poses.append(odo.process_numpy(s, 0.1 * i, cap=t.CAP))
                if odo.stats.retries > before:
                    retried.append(i)
            runs.append(np.stack(poses))
            print(f"{variant} run {seed}: keyframes {odo.keyframe_indices}, retries kept at scans {retried}")
        dt, rot = _spread(runs)
        print(f"{variant}: translation moves per scan {dt} m, rotation entries up to {rot}")


def fused_lut() -> None:
    import dataclasses

    import jax.numpy as jnp

    import conftest
    import test_torch_odometry as t
    from lv_slam_tpu.core.cloud import PointCloud
    from lv_slam_tpu.odometry.fused import run_sequence_fused

    scans, _, _ = conftest.small_sequence.__wrapped__()
    cfg = dataclasses.replace(t.CFG, ndt=dataclasses.replace(t.CFG.ndt, table="lut"))
    clouds = [PointCloud.from_numpy(s, cap=t.CAP) for s in scans]
    xyz = np.stack([np.asarray(c.xyz) for c in clouds])
    mask = np.stack([np.asarray(c.mask) for c in clouds])
    stamps = jnp.arange(len(scans), dtype=jnp.float32) * 0.1
    runs = [np.asarray(run_sequence_fused(jnp.asarray(x), jnp.asarray(mask), stamps, cfg, t.PF))
            for x in [xyz] + [_nudge(xyz, mask, seed) for seed in range(16)]]
    dt, rot = _spread(runs)
    print(f"fused LUT odometry: translation moves per scan {dt} m, rotation entries up to {rot}")


def slam_dlo() -> None:
    import conftest
    import test_slam_pipeline as t
    from lv_slam_tpu.pipeline.slam import LvSlam

    scans, _, _ = conftest.small_sequence.__wrapped__()
    dlo_runs, lfa_runs = [], []
    for seed in [None] + list(range(8)):
        slam_ = LvSlam(t._small_cfg(), optimize_every=4, scan_cap=32768)
        for i, s in enumerate(_nudged_scans(scans, seed)):
            slam_.process(s, i * 0.1)
        slam_.finalize()
        dlo_runs.append(np.stack(slam_.dlo_poses))
        lfa_runs.append(np.stack(slam_.lfa_poses))
        print(f"run {seed}: DLO keyframes {slam_.dlo.keyframe_indices}, backend keyframes "
              f"{[k.seq for k in slam_.backend.keyframes]}, loops "
              f"{[(lp.key1.seq, lp.key2.seq) for lp in slam_.backend.loops]}")
    for name, runs in (("DLO", dlo_runs), ("LFA", lfa_runs)):
        dt, rot = _spread(runs)
        print(f"{name} poses: translation moves per scan {dt} m, rotation entries up to {rot}")


if __name__ == "__main__":
    {"eigh": eigh, "backend": backend, "lfa": lfa, "lfa_host": lfa_host, "slam": slam, "dlo": dlo,
     "slam_dlo": slam_dlo, "fused_lut": fused_lut}[sys.argv[1]]()
