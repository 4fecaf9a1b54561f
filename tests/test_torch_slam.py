"""The port's per-scan orchestrator `LvSlam` (kernels through their plain
twins on the CPU) against lv_slam_tpu.pipeline.slam on the conftest
`small_sequence` with `tests/test_slam_pipeline.py`'s small configuration:
at its default (the host DLO seeding the LFA mapping, the prefiltered cloud
to `GlobalGraph.add_scan`), with `use_lfa=False`, and as the pure LFA stack
(`use_dlo=False`: host feature odometry and mapping, the raw cloud to the
backend).

The default's tolerances are the reference's own one-ulp spread
(`scripts/reference_spread.py slam_dlo`, 8 perturbations): per scan, the
DLO pose within the larger of 2e-3 m and DLO_SPREAD, the LFA pose within
the larger of 2e-3 m and LFA_SPREAD, rotation entries within 1e-3; the
DLO's and the backend's keyframes and the loops equal (the perturbed
reference runs keep them all).

`use_dlo=False`:

Tolerance: each LFA pose within 1e-4 m and 1e-4 of the reference's (moving
every raw coordinate by one ulp moves the reference's LFA poses by up to
0.21 mm and a rotation entry by 2.0e-5, `scripts/reference_spread.py
slam`, 8 perturbations; the tolerance stays at 1e-4 where that is smaller,
so it is the larger of the two, per scan), the keyframe seqs and loop pairs
equal (the perturbed reference runs keep keyframes (0, 3) and no loop).
Measured port errors: LFA poses 2.9e-6 m, rotation 3.5e-7; optimized
keyframe poses 4.8e-7.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

from lv_slam_tpu.pipeline.slam import LvSlam as JSlam  # noqa: E402
from lv_slam_tpu_torch import config as tc  # noqa: E402
from lv_slam_tpu_torch.pipeline.slam import LvSlam  # noqa: E402
from test_slam_pipeline import _small_cfg  # noqa: E402

LFA_SPREAD = np.array([0.0, 1.5e-6, 1e-6, 1.7e-4, 1.8e-4, 2.2e-4])  # per scan, m
DEFAULT_ATOL, DEFAULT_ROT_ATOL = 2e-3, 1e-3
DLO_SPREAD = np.array([0.0, 6.0e-3, 2.9e-3, 2.8e-3, 1.6e-3, 7.8e-3])  # per scan, m (rotation <= 8.0e-4)
DEFAULT_LFA_SPREAD = np.array([0.0, 2.3e-4, 2.0e-3, 1.7e-3, 6.8e-3, 1.15e-2])  # (rotation <= 7.0e-4)
TRANS_ATOL = 1e-4  # m
ROT_ATOL = 1e-4


def _port_config(ref) -> tc.PipelineConfig:
    """The port's copy of a reference PipelineConfig (the fields it has)."""

    def copy(cls, obj, **kw):
        names = [f.name for f in dataclasses.fields(cls)]
        return cls(**{name: kw[name] if name in kw else getattr(obj, name) for name in names})

    return copy(
        tc.PipelineConfig, ref,
        prefilter=copy(tc.PrefilterConfig, ref.prefilter),
        odometry=copy(tc.OdometryConfig, ref.odometry, ndt=copy(tc.NDTConfig, ref.odometry.ndt)),
        lfa=copy(tc.LfaConfig, ref.lfa), loop=copy(tc.LoopDetectorConfig, ref.loop),
        graph=copy(tc.GraphConfig, ref.graph),
    )


def _run(slam, scans):
    for i, s in enumerate(scans):
        slam.process(s, i * 0.1)
    slam.finalize()
    return slam


@pytest.fixture(scope="module")
def runs(small_sequence):
    scans, gt, _ = small_sequence
    want = _run(JSlam(_small_cfg(), use_dlo=False, optimize_every=4, scan_cap=32768), scans)
    got = _run(LvSlam(_port_config(_small_cfg()), use_dlo=False, optimize_every=4, scan_cap=32768,
                      device="cpu"), scans)
    return got, want, gt


def test_lvslam_lfa_matches_jax(runs):
    got, want, gt = runs
    a, b = np.stack(got.lfa_poses), np.stack(want.lfa_poses)
    err_t = np.abs(a[:, :3, 3] - b[:, :3, 3]).max(axis=1)
    err_r = float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max())
    tol_t = np.maximum(TRANS_ATOL, LFA_SPREAD)
    print(f"LFA poses: translation error {np.array2string(err_t, precision=7)} m (tolerance {tol_t}), "
          f"rotation error {err_r:.3g} (tolerance {ROT_ATOL})")
    assert (err_t <= tol_t).all() and err_r <= ROT_ATOL
    assert got.dlo_poses == [] and len(got.lfa_poses) == len(want.lfa_poses)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.linalg.norm(a[-1, :3, 3] - gt_rel[len(a) - 1, :3, 3]) < 0.3  # test_slam_pipeline's bound


def test_lvslam_backend_matches_jax(runs):
    """The backend fed the LFA poses and raw clouds: the same keyframes and
    loops, and the optimized keyframe trajectory within the LFA tolerance."""
    got, want, _ = runs
    assert [k.seq for k in got.backend.keyframes] == [k.seq for k in want.backend.keyframes]
    assert [(lp.key1.seq, lp.key2.seq) for lp in got.backend.loops] == [
        (lp.key1.seq, lp.key2.seq) for lp in want.backend.loops]
    traj, ref = got.trajectory(), want.trajectory()
    assert traj.shape == ref.shape and len(traj) >= 2
    np.testing.assert_allclose(traj, ref, rtol=0, atol=TRANS_ATOL)
    # the raw cloud reached the backend: keyframe clouds hold raw-scan points
    assert int(got.backend.keyframes[0].cloud.mask.sum()) > 1000


def test_lvslam_without_lfa_feeds_identity_odometry(small_sequence):
    """use_lfa=False with use_dlo=False: the backend sees identity odometry,
    so only scan 0 opens a keyframe, as in the reference."""
    scans, _, _ = small_sequence
    slam = _run(LvSlam(_port_config(_small_cfg()), use_dlo=False, use_lfa=False, optimize_every=4,
                       scan_cap=32768, device="cpu"), scans[:3])
    assert slam.lfa_poses == [] and [k.seq for k in slam.backend.keyframes] == [0]
    assert all((slam.backend.odoms[i] == np.eye(4)).all() for i in range(3))


def test_lvslam_unported_options_raise(small_sequence):
    """The host DLO frontend (the reference's default) now constructs; the
    sensor priors are not ported: they raise instead of running something
    else. The calibration reaches the backend."""
    cfg = _port_config(_small_cfg())
    default = LvSlam(cfg, device="cpu")
    assert default.dlo is not None and default.feature_odometry is None
    assert default.dlo.prefilter_cfg == cfg.prefilter and default.dlo.device == torch.device("cpu")
    slam = LvSlam(dataclasses.replace(cfg, calib_tr=tuple(float(v) for v in range(12))), use_dlo=False,
                  scan_cap=32768, device="cpu")
    np.testing.assert_array_equal(slam.backend.tr[:3, :4], np.arange(12.0).reshape(3, 4))
    scan = small_sequence[0][0]
    with pytest.raises(NotImplementedError):
        slam.process(scan, 0.0, detect_floor=True)
    with pytest.raises(NotImplementedError):
        slam.process(scan, 0.0, gps_xyz=np.zeros(3))


def _assert_close(got, want, spread, what):
    err_t = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    err_r = float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max())
    tol = np.maximum(DEFAULT_ATOL, spread)
    print(f"{what}: translation error {np.array2string(err_t, precision=6)} m (tolerance {tol}), rotation "
          f"{err_r:.3g} (tolerance {DEFAULT_ROT_ATOL})")
    assert (err_t <= tol).all() and err_r <= DEFAULT_ROT_ATOL


@pytest.fixture(scope="module")
def default_runs(small_sequence):
    scans, gt, _ = small_sequence
    want = _run(JSlam(_small_cfg(), optimize_every=4, scan_cap=32768), scans)
    got = _run(LvSlam(_port_config(_small_cfg()), optimize_every=4, scan_cap=32768, device="cpu"), scans)
    return got, want, gt


def test_lvslam_default_matches_jax(default_runs):
    """`LvSlam()` at its default (`tests/test_slam_pipeline.py:30`): DLO and
    LFA poses within the reference's spread, the DLO's and the backend's
    keyframes and the loops equal, the prefiltered cloud in the backend."""
    got, want, gt = default_runs
    assert len(got.dlo_poses) == len(got.lfa_poses) == len(want.dlo_poses)
    _assert_close(np.stack(got.dlo_poses), np.stack(want.dlo_poses), DLO_SPREAD, "DLO poses")
    _assert_close(np.stack(got.lfa_poses), np.stack(want.lfa_poses), DEFAULT_LFA_SPREAD, "LFA poses")
    assert got.dlo.keyframe_indices == want.dlo.keyframe_indices
    assert [k.seq for k in got.backend.keyframes] == [k.seq for k in want.backend.keyframes]
    assert [(lp.key1.seq, lp.key2.seq) for lp in got.backend.loops] == [
        (lp.key1.seq, lp.key2.seq) for lp in want.backend.loops]
    np.testing.assert_allclose(got.trajectory(), want.trajectory(), rtol=0, atol=DEFAULT_LFA_SPREAD.max())
    # the backend got the prefiltered cloud: the keyframe window's voxel cloud
    assert got.backend.keyframes[0].cloud.cap == want.backend.keyframes[0].cloud.xyz.shape[0]
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    final = got.lfa_poses[-1]
    assert np.linalg.norm(final[:3, 3] - gt_rel[len(got.lfa_poses) - 1][:3, 3]) < 0.3


def test_lvslam_dlo_only_matches_jax(small_sequence):
    """`use_lfa=False` (`tests/test_slam_pipeline.py:50`): the backend gets
    the DLO poses; they match JAX's within the spread, the keyframes equal,
    and the last pose is within the reference test's 0.2 m."""
    scans, gt, _ = small_sequence
    want = _run(JSlam(_small_cfg(), use_lfa=False, optimize_every=4, scan_cap=32768), scans)
    got = _run(LvSlam(_port_config(_small_cfg()), use_lfa=False, optimize_every=4, scan_cap=32768,
                      device="cpu"), scans)
    assert got.lfa_poses == []
    _assert_close(np.stack(got.dlo_poses), np.stack(want.dlo_poses), DLO_SPREAD, "DLO poses")
    assert [k.seq for k in got.backend.keyframes] == [k.seq for k in want.backend.keyframes]
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.linalg.norm(got.dlo_poses[-1][:3, 3] - gt_rel[len(scans) - 1][:3, 3]) < 0.2
