"""The port's host LFA drivers (`lfa/odometry.FeatureOdometry`,
`lfa/mapping.FeatureMapping`, `lfa/pipeline.LfaPipeline`; kernels 1b, 8,
9c, 9g, 9k, 10 and 11 through their plain twins on the CPU) against
lv_slam_tpu.lfa on `tests/test_lfa.py`'s 8-scan figure-8 (32 rings x 900).

The host drivers are the reference's own algorithm, not the fused step's:
a fixed 2 x 4 scan-to-scan solve without re-orthonormalization, and maps
rebuilt as cell tables from dedup-merged buffers every scan. The odometry
and the mapping are each fed the reference's inputs (its features, and for
the mapping its odometry poses); the pipeline runs from the raw scans.

Tolerance, per scan: 1e-4 m and 1e-4, or the reference's own spread where
that is larger: moving every raw coordinate by one ulp moves the
reference's odometry by up to `ODOM_SPREAD` (the scan-to-scan solve stops
after 8 iterations from the identity, 1 m from the truth) and its refined
pose by up to `REFINED_SPREAD`, rotation entries by up to 8.0e-5 and
8.8e-4 (8 perturbations, `scripts/reference_spread.py lfa_host`, rounded
up). Measured port errors: the pipeline's odometry at most 7.7e-5 m and
refined poses 2.2e-5 m; the mapping fed the reference's odometry 1.25 mm
(a correspondence flips at scan 3, as under the reference's own
perturbations), rotation 7.4e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.lfa.features import extract_features  # noqa: E402
from lv_slam_tpu.lfa.pipeline import LfaPipeline as JPipeline  # noqa: E402
from lv_slam_tpu_torch import lfa as port_lfa  # noqa: E402
from lv_slam_tpu_torch.config import LfaConfig as TLfa  # noqa: E402
from lv_slam_tpu_torch.lfa.features import FeatureClouds  # noqa: E402
from lv_slam_tpu_torch.lfa.mapping import FeatureMapping  # noqa: E402
from lv_slam_tpu_torch.lfa.odometry import FeatureOdometry  # noqa: E402
from test_lfa import _CFG  # noqa: E402

CAP = 32768
TRANS_ATOL = 1e-4  # m
ROT_ATOL = 1e-4
ODOM_SPREAD = np.array([0.0, 1.7e-3, 1.7e-3, 1.7e-3, 2.2e-3, 2.2e-3, 2.2e-3, 2.2e-3])
REFINED_SPREAD = np.array([0.0, 1.9e-5, 2.5e-5, 6e-4, 1.9e-3, 1.1e-3, 1.3e-3, 2.5e-3])
ODOM_ROT_SPREAD = 8.0e-5
REFINED_ROT_SPREAD = 8.8e-4
TCFG = TLfa(**dataclasses.asdict(_CFG))


@pytest.fixture(scope="module")
def reference():
    """The reference pipeline over test_lfa's figure-8: (scans, per-scan
    features as tensors, odometry poses, refined poses, gt, the map
    buffers' final point counts)."""
    scans, gt, _ = synthetic.make_sequence(
        8, seed=21, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=900, noise_std=0.005,
    )
    pipe = JPipeline(_CFG)
    feats, odoms, refined = [], [], []
    for s in scans:
        refined.append(pipe.process_numpy(s, cap=CAP))
        odoms.append(pipe.odometry._pose.copy())
        f = extract_features(JCloud.from_numpy(s, cap=CAP), _CFG)
        feats.append(FeatureClouds(*(torch.from_numpy(np.array(a)) for a in f)))
    counts = (int(pipe.mapping._edge_mask.sum()), int(pipe.mapping._surf_mask.sum()))
    return scans, feats, np.stack(odoms), np.stack(refined), gt, counts


def _check(what, got, want, spread, rot_spread):
    err_t = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    err_r = float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max())
    tol_t, tol_r = np.maximum(TRANS_ATOL, spread), max(ROT_ATOL, rot_spread)
    print(f"{what}: translation error {np.array2string(err_t, precision=7)} m (tolerance {tol_t}), "
          f"rotation error {err_r:.3g} (tolerance {tol_r})")
    assert (err_t <= tol_t).all() and err_r <= tol_r


def test_feature_odometry_matches_jax(reference):
    _, feats, odoms, _, _, _ = reference
    odo = FeatureOdometry(TCFG, device="cpu")
    got = np.stack([odo.process(f) for f in feats])
    _check("odometry", got, odoms, ODOM_SPREAD, ODOM_ROT_SPREAD)
    odo.reset()
    assert odo._prev_edge_grid is None and (odo.process(feats[0]) == np.eye(4)).all()


def test_feature_mapping_matches_jax(reference):
    """Fed the reference's odometry; after the last merge and crop the map
    buffers hold the reference's point counts within 2 %: the refined poses
    differ by up to ~1 mm (within the reference's spread), which moves a
    point across a 0.4 m voxel face about once in 130 (measured: edge 1238
    against 1228, surf 3493 against 3492)."""
    _, feats, odoms, refined, _, counts = reference
    mapping = FeatureMapping(TCFG, device="cpu")
    got = np.stack([mapping.process(f, o) for f, o in zip(feats, odoms)])
    _check("refined", got, refined, REFINED_SPREAD, REFINED_ROT_SPREAD)
    np.testing.assert_array_equal(mapping.pose, got[-1])
    for mask, want in zip((mapping._edge_mask, mapping._surf_mask), counts):
        assert abs(int(mask.sum()) - want) <= max(4, want // 50), (int(mask.sum()), want)
    assert min(counts) > 1000


def test_lfa_pipeline_matches_jax(reference):
    scans, _, odoms, refined, gt, _ = reference
    pipe = port_lfa.LfaPipeline(TCFG, device="cpu")
    odo = []
    for s in scans:
        pipe.process_numpy(s, cap=CAP)
        odo.append(pipe.odometry._pose.copy())
    got = np.stack(pipe.poses)
    _check("pipeline odometry", np.stack(odo), odoms, ODOM_SPREAD, ODOM_ROT_SPREAD)
    _check("pipeline refined", got, refined, REFINED_SPREAD, REFINED_ROT_SPREAD)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.linalg.norm(got[-1, :3, 3] - gt_rel[-1, :3, 3]) < 0.25  # test_lfa's tracking bound


def test_mapping_skip_frame_takes_the_odometry_increment(reference):
    """mapping_skip_frame=2: odd scans skip the scan-to-map solve and output
    the odometry increment on the last refined pose (the maps still merge)."""
    _, feats, odoms, _, _, _ = reference
    mapping = FeatureMapping(dataclasses.replace(TCFG, mapping_skip_frame=2), device="cpu")
    got = [mapping.process(f, o) for f, o in zip(feats[:4], odoms[:4])]
    np.testing.assert_allclose(got[1], got[0] @ np.linalg.inv(odoms[0]) @ odoms[1], atol=1e-12)
    assert not np.allclose(got[2], got[1] @ np.linalg.inv(odoms[1]) @ odoms[2], atol=1e-9)
