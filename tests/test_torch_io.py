"""The port's own configuration, synthetic scans, devkit metric, PCD and
KITTI pose files, g2o graph files and SE(3) logarithms against the
reference's (`lv_slam_tpu.config`, `lv_slam_tpu.io`, `lv_slam_tpu.graph.
g2o_io`, `lv_slam_tpu.core.se3`): the port keeps copies so that it imports
nothing of the JAX package."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from lv_slam_tpu import config as ref_config  # noqa: E402
from lv_slam_tpu.io import kitti as ref_kitti, synthetic as ref_synthetic  # noqa: E402
from lv_slam_tpu_torch import config  # noqa: E402
from lv_slam_tpu_torch.io import kitti, pcd, synthetic  # noqa: E402


@pytest.mark.parametrize(
    "name",
    ["PrefilterConfig", "NDTConfig", "OdometryConfig", "LfaConfig", "LoopDetectorConfig", "GraphConfig",
     "PipelineConfig"],
)
def test_config_matches_reference(name):
    """Each of the port's fields has the reference's default, in the stage
    config and in the flagship configuration; every stage config copies
    every field, field by field, and the pipeline config its stages and its
    calibration."""

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
    if name != "PipelineConfig":
        fields = [f.name for f in dataclasses.fields(getattr(config, name))]
        assert fields == [f.name for f in dataclasses.fields(getattr(ref_config, name))]
    port, ref = config.kitti_flagship_config(), ref_config.kitti_flagship_config()
    same(port.prefilter, ref.prefilter)
    same(port.odometry, ref.odometry)
    same(port.lfa, ref.lfa)
    same(port.loop, ref.loop)
    same(port.graph, ref.graph)


def test_registration_params_match_reference():
    """The factory's frozen `RegistrationParams` copy: the reference's fields,
    in its order, with its defaults."""
    from lv_slam_tpu.ops.registrations import RegistrationParams as Ref
    from lv_slam_tpu_torch.ops.registrations import RegistrationParams

    assert [f.name for f in dataclasses.fields(RegistrationParams)] == [f.name for f in dataclasses.fields(Ref)]
    assert dataclasses.asdict(RegistrationParams()) == dataclasses.asdict(Ref())
    assert RegistrationParams.__dataclass_params__.frozen


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


@pytest.mark.parametrize("trajectory", ["figure8", "straight", "circle"])
def test_make_sequence_matches_reference(trajectory):
    """The fleet's and the entry's sequences: scans and poses bit-identical."""
    kw = dict(seed=11, trajectory=trajectory, step=1.0, n_rings=16, n_azimuth=225)
    scans, poses, world = synthetic.make_sequence(3, **kw)
    ref_scans, ref_poses, ref_world = ref_synthetic.make_sequence(3, **kw)
    np.testing.assert_array_equal(poses, ref_poses)
    np.testing.assert_array_equal(world.boxes, ref_world.boxes)
    for a, b in zip(scans, ref_scans):
        np.testing.assert_array_equal(a, b)


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


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("width", [3, 4])
def test_pcd_copy_matches_reference(tmp_path, binary, width):
    """The same bytes written, the same points read back."""
    from lv_slam_tpu.io import pcd as ref_pcd

    pts = np.random.default_rng(width).normal(0, 20, (1000, width)).astype(np.float32)
    pcd.write_pcd(str(tmp_path / "port.pcd"), pts, binary=binary)
    ref_pcd.write_pcd(str(tmp_path / "ref.pcd"), pts, binary=binary)
    assert (tmp_path / "port.pcd").read_bytes() == (tmp_path / "ref.pcd").read_bytes()
    np.testing.assert_array_equal(pcd.read_pcd(str(tmp_path / "ref.pcd")),
                                  ref_pcd.read_pcd(str(tmp_path / "ref.pcd")))


def test_kitti_pose_writers_match_reference(tmp_path):
    rng = np.random.default_rng(2)
    poses = np.tile(np.eye(4), (7, 1, 1))
    poses[:, :3, :4] = rng.normal(0, 3, (7, 3, 4))
    tr = ref_kitti.tr_to_matrix(rng.normal(0, 1, (3, 4)))
    np.testing.assert_array_equal(kitti.velo_to_cam_poses(poses, tr), ref_kitti.velo_to_cam_poses(poses, tr))
    kitti.write_pose_file(str(tmp_path / "port.txt"), poses)
    ref_kitti.write_pose_file(str(tmp_path / "ref.txt"), poses)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    np.testing.assert_array_equal(kitti.read_pose_file(str(tmp_path / "ref.txt")),
                                  ref_kitti.read_pose_file(str(tmp_path / "ref.txt")))


def test_g2o_io_copy_matches_reference(tmp_path):
    """A graph with every factor family: the port's save_graph writes the
    reference's text and sidecar, and load_graph rebuilds the same arrays
    from it."""
    from lv_slam_tpu.graph import g2o_io as ref_g2o, pose_graph as ref_pg
    from lv_slam_tpu_torch.graph import g2o_io, pose_graph

    rng = np.random.default_rng(3)
    g = ref_pg.empty_graph(16, 32, 16, 4, 8, 8)
    for i in range(6):
        pose = np.eye(4)
        pose[:3, 3] = rng.normal(0, 5, 3)
        ref_pg.add_node(g, i, pose)
    ref_pg.set_node_fixed(g, 5)
    for e in range(5):
        ref_pg.add_se3_edge(g, e, e + 1, e, np.eye(4), np.eye(6) * (e + 1), huber=1.0 if e % 2 else 0.0)
    for slot, kind in enumerate(range(5)):
        ref_pg.add_prior(g, slot, slot, kind, rng.normal(0, 1, 6), np.eye(4) * 2, huber=0.5 * (slot % 2))
    ref_pg.add_plane_node(g, 0, [0, 0, 1, 0], fixed=True)
    ref_pg.add_plane_node(g, 1, [0.1, 0, 1, 0.3])
    ref_pg.add_se3_plane_edge(g, 0, 2, 0, [0, 0, 1, 0.1], np.eye(3) * 8.0, huber=1.0)
    for kind in range(5):
        ref_pg.add_plane_edge(g, kind, 1, 0 if kind < 3 else 1, kind, rng.normal(0, 0.1, 4), np.eye(4) * 5.0)
    port_graph = pose_graph.PoseGraph(*(np.array(a) for a in g))
    g2o_io.save_graph(str(tmp_path / "port.g2o"), port_graph)
    ref_g2o.save_graph(str(tmp_path / "ref.g2o"), g)
    for suffix in ("", ".kernels"):
        assert (tmp_path / f"port.g2o{suffix}").read_text() == (tmp_path / f"ref.g2o{suffix}").read_text()
    got = g2o_io.load_graph(str(tmp_path / "ref.g2o"), 16, 32, 16, 4, 8, 8)
    want = ref_g2o.load_graph(str(tmp_path / "ref.g2o"), 16, 32, 16, 4, 8, 8)
    for name in pose_graph.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)


def test_se3_logs_match_reference():
    """log_so3, log_se3 (Taylor branch, generic angles, angles near pi),
    quat_log and identity."""
    import jax.numpy as jnp
    import torch

    from lv_slam_tpu.core import se3 as ref_se3
    from lv_slam_tpu_torch.core import se3

    rng = np.random.default_rng(4)
    v = rng.normal(0, 1, (60, 6)).astype(np.float32)
    v[:10, 3:] *= 1e-6
    v[10:20, 3:] *= 3.1 / np.linalg.norm(v[10:20, 3:], axis=1, keepdims=True)
    m = np.array(ref_se3.exp_se3(jnp.asarray(v)))
    np.testing.assert_allclose(se3.log_se3(torch.from_numpy(m)).numpy(), np.asarray(ref_se3.log_se3(jnp.asarray(m))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(se3.log_so3(torch.from_numpy(m[:, :3, :3])).numpy(),
                               np.asarray(ref_se3.log_so3(jnp.asarray(m[:, :3, :3]))), rtol=0, atol=1e-6)
    q = np.array(ref_se3.quat_from_matrix(jnp.asarray(m[:, :3, :3])))
    np.testing.assert_allclose(se3.quat_log(torch.from_numpy(q)).numpy(), np.asarray(ref_se3.quat_log(jnp.asarray(q))),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(se3.identity().numpy(), np.asarray(ref_se3.identity()))
