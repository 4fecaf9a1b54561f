"""The port's own configuration, synthetic scans and devkit metric against
the reference's (`lv_slam_tpu.config`, `lv_slam_tpu.io`): the port keeps
copies so that it imports nothing of the JAX package."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from lv_slam_tpu import config as ref_config  # noqa: E402
from lv_slam_tpu.io import kitti as ref_kitti, synthetic as ref_synthetic  # noqa: E402
from lv_slam_tpu_torch import config  # noqa: E402
from lv_slam_tpu_torch.io import kitti, synthetic  # noqa: E402


@pytest.mark.parametrize(
    "name",
    ["PrefilterConfig", "NDTConfig", "OdometryConfig", "LfaConfig", "LoopDetectorConfig", "GraphConfig",
     "PipelineConfig"],
)
def test_config_matches_reference(name):
    """Each of the port's fields has the reference's default, in the stage
    config and in the flagship configuration; the LFA, loop-detector, graph
    and pipeline configs copy every field, field by field (the pipeline's
    stages as the stage configs, its calibration as it is)."""

    def same(port, ref):
        port, ref = dataclasses.asdict(port), dataclasses.asdict(ref)
        assert port == {k: ref[k] for k in port}

    if name == "PipelineConfig":
        port, ref = config.PipelineConfig(), ref_config.PipelineConfig()
        assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
        assert port.calib_tr == ref.calib_tr
        for stage in ("prefilter", "odometry", "lfa", "loop", "graph"):
            same(getattr(port, stage), getattr(ref, stage))
    else:
        same(getattr(config, name)(), getattr(ref_config, name)())
    if name in ("LfaConfig", "LoopDetectorConfig", "GraphConfig"):
        fields = [f.name for f in dataclasses.fields(getattr(config, name))]
        assert fields == [f.name for f in dataclasses.fields(getattr(ref_config, name))]
    port, ref = config.kitti_flagship_config(), ref_config.kitti_flagship_config()
    same(port.prefilter, ref.prefilter)
    same(port.odometry, ref.odometry)
    same(port.lfa, ref.lfa)
    same(port.loop, ref.loop)
    same(port.graph, ref.graph)


@pytest.mark.parametrize("seed", [5, 41])
def test_synthetic_scan_matches_reference(seed):
    """World, rays, trajectory and scan are bit-identical."""
    world, ref_world = synthetic.make_world(seed=seed), ref_synthetic.make_world(seed=seed)
    np.testing.assert_array_equal(world.boxes, ref_world.boxes)
    rays = synthetic.hdl64_rays(16, 300)
    np.testing.assert_array_equal(rays, ref_synthetic.hdl64_rays(16, 300))
    gt = synthetic.circle_trajectory(12, step=1.0)
    np.testing.assert_array_equal(gt, ref_synthetic.circle_trajectory(12, step=1.0))
    for i in (0, 11):
        np.testing.assert_array_equal(
            synthetic.simulate_scan(world, gt[i], rays, seed=seed + i),
            ref_synthetic.simulate_scan(ref_world, gt[i], rays, seed=seed + i),
        )


@pytest.mark.parametrize("lengths", [None, (5.0, 10.0, 15.0)])
def test_kitti_seq_error_matches_reference(lengths):
    rng = np.random.default_rng(7)
    gt = ref_synthetic.circle_trajectory(40, step=1.0).astype(np.float64)
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(0.0, 0.01, (40, 3)), axis=0)
    if lengths is None:  # the devkit's 100-800 m segments need a longer drive
        gt[:, :3, 3] *= 20.0
        est[:, :3, 3] *= 20.0
    got = kitti.kitti_seq_error(gt, est, step=5, lengths=lengths)
    want = ref_kitti.kitti_seq_error(gt, est, step=5, lengths=lengths)
    assert np.isfinite(got).all()
    assert got == want


@pytest.mark.parametrize("seed,world_seed", [(5, 5), (9, 9), (13, 13)])
def test_camera_image_matches_reference(seed, world_seed):
    """The camera renderer is bit-identical, at the circle's poses and a
    yawed one off it."""
    world, ref_world = synthetic.make_world(seed=world_seed), ref_synthetic.make_world(seed=world_seed)
    poses = list(synthetic.circle_trajectory(170, step=1.0)[::40])
    yawed = np.eye(4)
    yawed[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    yawed[:3, 3] = [12.0, -3.0, 1.6]
    for pose in poses + [yawed]:
        got = synthetic.render_camera_image(world, pose, seed=seed)
        want = ref_synthetic.render_camera_image(ref_world, pose, seed=seed)
        assert got.dtype == np.uint8 and got.shape == (128, 256)
        np.testing.assert_array_equal(got, want)
