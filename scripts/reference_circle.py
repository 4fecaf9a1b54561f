#!/usr/bin/env python3
"""The JAX reference's records on the benchmark circle, which
`chip_smoke.py` phases 7 and 8 print beside the port's results (CPU; needs
JAX):

    JAX_PLATFORMS=cpu python scripts/reference_circle.py fused
    JAX_PLATFORMS=cpu python scripts/reference_circle.py host
    JAX_PLATFORMS=cpu python scripts/reference_circle.py slam
    JAX_PLATFORMS=cpu python scripts/reference_circle.py dlo
    JAX_PLATFORMS=cpu python scripts/reference_circle.py slam_dlo

The workload is the reference benchmark's circle (`bench.py:156-194`: world
seed 5, `circle_trajectory(170, step=1.0)`, `hdl64_rays(64, 2000)`,
`simulate_scan(seed=5 + i)`), 131072-lane clouds, `LfaConfig()` defaults:

- `fused`: `run_sequence_lfa(xyz, mask, LfaConfig())` without odometry:
  devkit_t_err, final drift, the worst and the median relative-step error.
- `host`: the host `LfaPipeline`: devkit_t_err and final drift.
- `slam`: `LvSlam(PipelineConfig(), use_dlo=False, vocabulary=<the shipped
  512 words>)`, each scan with `render_camera_image(world, gt[i], seed=5)`:
  the LFA poses' devkit_t_err, keyframes, loops, the optimized keyframes'
  largest and last position errors.
- `dlo`: the host `DirectLidarOdometry(PipelineConfig().odometry,
  .prefilter)` per scan, as `bench.py`'s host cell drives it:
  devkit_t_err, final drift, keyframes, retries, Newton iterations.
- `slam_dlo`: `LvSlam(PipelineConfig(), vocabulary=<the shipped 512
  words>)` at its defaults (the host DLO seeding the LFA mapping), each scan
  with its camera image: both pose sets' devkit_t_err, the DLO's and the
  backend's keyframes, loops, the optimized keyframes' errors.

These are full-size runs: they need a machine with tens of GB of memory to
spare and take tens of minutes of CPU each.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

N_SCANS, SEED, CAP = 170, 5, 131072


def _workload():
    from lv_slam_tpu.io import synthetic

    world = synthetic.make_world(seed=SEED)
    gt = synthetic.circle_trajectory(N_SCANS, step=1.0)
    rays = synthetic.hdl64_rays(64, 2000)
    scans = [synthetic.simulate_scan(world, gt[i], rays, seed=SEED + i) for i in range(N_SCANS)]
    return world, scans, gt


def _accuracy(est: np.ndarray, gt: np.ndarray, what: str) -> None:
    """devkit_t_err (the benchmark's scaled segment lengths) and final drift."""
    from lv_slam_tpu.io import kitti

    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    total = float(np.linalg.norm(gt_rel[1:, :3, 3] - gt_rel[:-1, :3, 3], axis=1).sum())
    lengths = tuple(f * total for f in (0.25, 0.5, 0.75)) if total < 850.0 else None
    t_err, _ = kitti.kitti_seq_error(gt_rel, est, step=5, lengths=lengths)
    drift = float(np.linalg.norm(est[-1, :3, 3] - gt_rel[-1, :3, 3]))
    rel_est = np.linalg.inv(est[:-1]) @ est[1:]
    rel_gt = np.linalg.inv(gt_rel[:-1]) @ gt_rel[1:]
    steps = np.linalg.norm((np.linalg.inv(rel_est) @ rel_gt)[:, :3, 3], axis=1)
    print(f"{what}: devkit_t_err {float(t_err):.5f}, final drift {drift:.3f} m of {total:.0f} m; relative-step "
          f"error worst {steps.max():.3f} m at step {int(steps.argmax()) + 1}, median {np.median(steps):.3f} m")


def fused() -> None:
    import jax.numpy as jnp

    from lv_slam_tpu.config import LfaConfig
    from lv_slam_tpu.core.cloud import PointCloud
    from lv_slam_tpu.lfa.fused import run_sequence_lfa

    _, scans, gt = _workload()
    clouds = [PointCloud.from_numpy(s, cap=CAP) for s in scans]
    xyz = jnp.stack([c.xyz for c in clouds])
    mask = jnp.stack([c.mask for c in clouds])
    _accuracy(np.asarray(run_sequence_lfa(xyz, mask, LfaConfig()), np.float64), gt, "fused standalone LFA")


def host() -> None:
    from lv_slam_tpu.lfa.pipeline import LfaPipeline

    _, scans, gt = _workload()
    pipe = LfaPipeline()
    est = np.stack([pipe.process_numpy(s, cap=CAP) for s in scans])
    _accuracy(est, gt, "host LfaPipeline")


def slam() -> None:
    from lv_slam_tpu.config import PipelineConfig
    from lv_slam_tpu.graph.bow import Vocabulary
    from lv_slam_tpu.io import synthetic
    from lv_slam_tpu.pipeline.slam import LvSlam

    world, scans, gt = _workload()
    vocab = Vocabulary.load(str(_ROOT / "lv_slam_tpu" / "assets" / "vocab_synthetic_512.npz"))
    run = LvSlam(PipelineConfig(), use_dlo=False, scan_cap=CAP, vocabulary=vocab)
    for i, s in enumerate(scans):
        run.process(s, 0.1 * i, image=synthetic.render_camera_image(world, gt[i], seed=SEED))
    run.finalize()
    _accuracy(np.stack(run.lfa_poses), gt, "LvSlam(use_dlo=False) LFA poses")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    seqs = [k.seq for k in run.backend.keyframes]
    err = [float(np.linalg.norm(p[:3, 3] - gt_rel[s][:3, 3])) for p, s in zip(run.trajectory(), seqs)]
    loops = [(lp.key1.seq, lp.key2.seq) for lp in run.backend.loops]
    print(f"keyframes {seqs} ({len(seqs)}), loops {loops}; optimized keyframe error largest {max(err):.3f} m, "
          f"last {err[-1]:.3f} m")


def dlo() -> None:
    from lv_slam_tpu.config import PipelineConfig
    from lv_slam_tpu.core.cloud import PointCloud
    from lv_slam_tpu.odometry.dlo import DirectLidarOdometry

    _, scans, gt = _workload()
    cfg = PipelineConfig()
    odo = DirectLidarOdometry(cfg.odometry, cfg.prefilter)
    for i, s in enumerate(scans):
        odo.process(PointCloud.from_numpy(s, cap=CAP), 0.1 * i)
    _accuracy(np.stack(odo.poses), gt, "host DirectLidarOdometry")
    st = odo.stats
    print(f"keyframes {odo.keyframe_indices} ({st.keyframe_count}), retries {st.retries}, Newton iterations "
          f"{st.total_iterations}")


def slam_dlo() -> None:
    from lv_slam_tpu.config import PipelineConfig
    from lv_slam_tpu.graph.bow import Vocabulary
    from lv_slam_tpu.io import synthetic
    from lv_slam_tpu.pipeline.slam import LvSlam

    world, scans, gt = _workload()
    vocab = Vocabulary.load(str(_ROOT / "lv_slam_tpu" / "assets" / "vocab_synthetic_512.npz"))
    run = LvSlam(PipelineConfig(), scan_cap=CAP, vocabulary=vocab)
    for i, s in enumerate(scans):
        run.process(s, 0.1 * i, image=synthetic.render_camera_image(world, gt[i], seed=SEED))
    run.finalize()
    _accuracy(np.stack(run.dlo_poses), gt, "LvSlam() DLO poses")
    _accuracy(np.stack(run.lfa_poses), gt, "LvSlam() LFA poses")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    seqs = [k.seq for k in run.backend.keyframes]
    err = [float(np.linalg.norm(p[:3, 3] - gt_rel[s][:3, 3])) for p, s in zip(run.trajectory(), seqs)]
    loops = [(lp.key1.seq, lp.key2.seq) for lp in run.backend.loops]
    print(f"DLO keyframes {run.dlo.keyframe_indices}, retries {run.dlo.stats.retries}; backend keyframes {seqs} "
          f"({len(seqs)}), loops {loops}; optimized keyframe error largest {max(err):.3f} m, last {err[-1]:.3f} m")


if __name__ == "__main__":
    {"fused": fused, "host": host, "slam": slam, "dlo": dlo, "slam_dlo": slam_dlo}[sys.argv[1]]()
