"""The port's sensor priors and backend services against the JAX
reference's (CPU), on a 32-scan VLP-16 circle with ground-truth odometry:
GPS (truth + [500, 300, 0] + 0.2 m noise), the IMU orientation and
acceleration from the truth, and measured floor coefficients, fed with the
raw chunk to `add_scan_batch(sensors=...)` and per scan to `add_scan`.

Each keyframe gets the reference's priors (types, nodes, measurements and
information), `zero_utm` is the first fix, the shared floor plane is fixed
and the estimates and planes agree within the reference's rounding. Then the
services: the port's dump holds the reference's files (graph.g2o and its
.kernels parsed as numbers, the keyframe `data` files, special_nodes.csv,
zero_utm, the pose files within tolerance); each package's `load_dump` reads
the other's dump; `save_map`'s points equal the reference's
`generate_map_cloud` of the same clouds and poses, bit for bit."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import GraphConfig as JGraphCfg  # noqa: E402
from lv_slam_tpu.config import LoopDetectorConfig as JLoopCfg  # noqa: E402
from lv_slam_tpu.config import PrefilterConfig as JPrefilterCfg  # noqa: E402
from lv_slam_tpu.core import se3 as jse3  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.graph.map_cloud import generate_map_cloud as jmap  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.pipeline import backend as jbackend  # noqa: E402
from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.graph import pose_graph as tpg  # noqa: E402
from lv_slam_tpu_torch.graph.map_cloud import generate_map_cloud  # noqa: E402
from lv_slam_tpu_torch.pipeline import backend as tbackend  # noqa: E402

N, CAP, CHUNK = 32, 8192, 8
GRAPH = dict(keyframe_cap=32, edge_cap=64, prior_cap=64, keyframe_delta_trans=3.0, solver_num_iterations=32,
             enable_gps=True, enable_imu_orientation=True, enable_imu_acceleration=True)
LOOP = dict(auto_train_vocab=False)
TR = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.05], [1, 0, 0, -0.3], [0, 0, 0, 1]], np.float64)
EST_ATOL = 1e-3  # m: ground-truth odometry, so only the LM's float32 noise separates the two


@pytest.fixture(scope="module")
def feed():
    world = synthetic.make_world(seed=11)
    gt = synthetic.circle_trajectory(N, step=1.0, radius=N / (2 * np.pi))
    rays = synthetic.vlp16_rays(16, 300)
    scans = [synthetic.simulate_scan(world, gt[i], rays, seed=11 + i) for i in range(N)]
    odom = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float64)
    rng = np.random.default_rng(7)
    sensors = []
    for i in range(N):
        rot = odom[i][:3, :3]
        sensors.append(dict(
            gps=odom[i][:3, 3] + [500.0, 300.0, 0.0] + rng.normal(0, 0.2, 3),
            imu_quat=np.asarray(jse3.quat_from_matrix(jnp.asarray(rot, jnp.float32)), np.float64),
            imu_acc=rot.T @ [0.0, 0.0, 9.81],
            floor=np.r_[rng.normal(0, 0.01, 2), 1.0, 1.73 + rng.normal(0, 0.01)],
        ))
    return scans, odom, sensors


def _jax_backend():
    return jbackend.GlobalGraph(JGraphCfg(**GRAPH), JLoopCfg(**LOOP), calib_tr=TR, keyframe_cloud_cap=16384,
                                prefilter_cfg=JPrefilterCfg(raw_cap=CAP, out_cap=CAP))


def _port_backend():
    return tbackend.GlobalGraph(GraphConfig(**GRAPH), LoopDetectorConfig(**LOOP), keyframe_cloud_cap=16384,
                                prefilter_cfg=PrefilterConfig(raw_cap=CAP, out_cap=CAP), calib_tr=TR, device="cpu")


def _feed(backend, scans, odom, sensors, per_scan, cloud, stack):
    if per_scan:
        for i in range(N):
            s = sensors[i]
            backend.add_scan(i, i * 0.1, odom[i], cloud(scans[i]), gps_xyz=s["gps"], imu_quat_wxyz=s["imu_quat"],
                             imu_acceleration=s["imu_acc"], floor_coeffs=s["floor"])
            if i % 8 == 7:
                backend.optimize()
    else:
        for s in range(0, N, CHUNK):
            backend.add_scan_batch(s, np.arange(s, s + CHUNK) * 0.1, odom[s:s + CHUNK],
                                   stack([cloud(x) for x in scans[s:s + CHUNK]]), sensors=sensors[s:s + CHUNK])
            backend.optimize()
    backend.finish()
    backend.drain()
    return backend


def _jax(feed, per_scan):
    return _feed(_jax_backend(), *feed, per_scan, lambda s: JCloud.from_numpy(s, cap=CAP),
                 lambda cs: JCloud(*(jnp.stack([getattr(c, f) for c in cs]) for f in ("xyz", "intensity", "mask"))))


def _port(feed, per_scan):
    return _feed(_port_backend(), *feed, per_scan, lambda s: TCloud.from_numpy(s, cap=CAP, device="cpu"),
                 lambda cs: TCloud(*(torch.stack([getattr(c, f) for c in cs]) for f in ("xyz", "intensity", "mask"))))


@pytest.fixture(scope="module")
def batch_runs(feed):
    return _port(feed, per_scan=False), _jax(feed, per_scan=False)


def _assert_same_priors(got, want):
    assert [k.seq for k in got.keyframes] == [k.seq for k in want.keyframes]
    counts = ("_n_nodes", "_n_edges", "_n_priors", "_n_planes", "_n_sp_edges", "_n_plane_edges")
    assert [getattr(got, c) for c in counts] == [getattr(want, c) for c in counts]
    assert got._n_priors == 3 * len(got.keyframes) and got._n_sp_edges == len(got.keyframes)
    np.testing.assert_array_equal(got.zero_utm, want.zero_utm)
    assert got.floor_plane_node_id == want.floor_plane_node_id == 0
    g, w = got.graph, want.graph
    for name in ("p_node", "p_type", "p_valid", "sp_i", "sp_plane", "sp_valid", "plane_valid", "plane_fixed"):
        np.testing.assert_array_equal(getattr(g, name), np.asarray(getattr(w, name)), err_msg=name)
    for name in ("p_meas", "p_info", "p_huber", "sp_meas", "sp_info", "sp_huber"):
        np.testing.assert_allclose(getattr(g, name), np.asarray(getattr(w, name)), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    for a, b in zip(got.keyframes, want.keyframes):
        for name in ("utm_coord", "orientation", "acceleration", "floor_coeffs"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    est = np.stack([k.estimate for k in got.keyframes])
    ref = np.stack([k.estimate for k in want.keyframes])
    print(f"keyframes {[k.seq for k in got.keyframes]}, priors {got._n_priors}, estimates differ by at most "
          f"{np.abs(est - ref).max():.3g}")
    np.testing.assert_allclose(est, ref, rtol=0, atol=EST_ATOL)
    np.testing.assert_allclose(g.planes, np.asarray(w.planes), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(g.planes[0], [0.0, 0.0, 1.0, 0.0])  # the fixed floor


def test_sensor_priors_per_chunk(batch_runs):
    _assert_same_priors(*batch_runs)


def test_sensor_priors_per_scan(feed):
    _assert_same_priors(_port(feed, per_scan=True), _jax(feed, per_scan=True))


def test_last_solve_keeps_the_last_lm(batch_runs):
    """`GlobalGraph.last_solve` holds a copy of the last LM's input graph
    (the solve's write-back leaves it as it was), its iteration cap and its
    result: re-solved by the plain path it gives the result's poses, and the
    keyframes' estimates are those poses."""
    got, _ = batch_runs
    frozen, iters, result = got.last_solve
    assert int(frozen.sp_valid.sum()) == got._n_sp_edges and int(frozen.p_valid.sum()) == got._n_priors
    assert not np.shares_memory(frozen.poses, got.graph.poses)
    poses = result.poses.numpy()
    assert not np.array_equal(frozen.poses, poses)
    again = tpg.optimize_pose_graph(frozen, iters, device="cpu")
    np.testing.assert_allclose(again.poses.numpy(), poses, rtol=0, atol=1e-6)
    for kf in got.keyframes:
        np.testing.assert_array_equal(kf.estimate, poses[kf.node_id].astype(np.float64))


def _numbers(path):
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


def _assert_same_text(got_path, want_path, atol):
    """Same lines, same words; numbers equal within `atol`."""
    got, want = _numbers(got_path), _numbers(want_path)
    assert len(got) == len(want), got_path
    for g, w in zip(got, want):
        assert len(g) == len(w), (got_path, g, w)
        for a, b in zip(g, w):
            try:
                np.testing.assert_allclose(float(a), float(b), rtol=0, atol=atol, err_msg=got_path)
            except ValueError:
                assert a == b, (got_path, a, b)


def test_dump_matches_reference(batch_runs, tmp_path):
    got, want = batch_runs
    assert got.dump(str(tmp_path / "port")) and want.dump(str(tmp_path / "jax"))
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for name in ("graph.g2o", "graph.g2o.kernels", "special_nodes.csv", "zero_utm"):
        _assert_same_text(port / name, ref / name, EST_ATOL)
    for name in ("ggo_kf_odom.txt", "ggo_wf_odom.txt"):
        _assert_same_text(port / name, ref / name, 2 * EST_ATOL)
    for i in range(len(got.keyframes)):
        _assert_same_text(port / f"{i:06d}" / "data", ref / f"{i:06d}" / "data", EST_ATOL)
    assert (port / "000000" / "cloud.pcd").read_bytes() == (ref / "000000" / "cloud.pcd").read_bytes()


def test_load_dump_reads_both_ways(batch_runs, tmp_path):
    """The port reads the reference's dump and the reference reads the
    port's: keyframes, their clouds and sensor fields, the graph's factors
    and counters."""
    got, want = batch_runs
    got.dump(str(tmp_path / "port"))
    want.dump(str(tmp_path / "jax"))
    cfg, jcfg = GraphConfig(**GRAPH), JGraphCfg(**GRAPH)
    port_of_jax = tbackend.load_dump(str(tmp_path / "jax"), cfg, keyframe_cloud_cap=16384, device="cpu")
    jax_of_port = jbackend.load_dump(str(tmp_path / "port"), jcfg, keyframe_cloud_cap=16384)
    for loaded, source in ((port_of_jax, want), (jax_of_port, got)):
        assert [k.seq for k in loaded.keyframes] == [k.seq for k in source.keyframes]
        assert loaded.floor_plane_node_id == 0 and loaded._n_priors == source._n_priors
        np.testing.assert_allclose(loaded.zero_utm, source.zero_utm, rtol=0, atol=1e-6)
        for a, b in zip(loaded.keyframes, source.keyframes):
            np.testing.assert_allclose(a.estimate, b.estimate, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(a.cloud.mask).sum(), np.asarray(b.cloud.mask).sum())
            np.testing.assert_allclose(a.floor_coeffs, b.floor_coeffs, rtol=1e-7)
        for name in ("p_node", "p_type", "sp_i", "e_i", "e_j", "plane_fixed"):
            np.testing.assert_array_equal(np.asarray(getattr(loaded.graph, name)),
                                          np.asarray(getattr(source.graph, name)), err_msg=name)
    # the port re-optimizes what it loaded
    port_of_jax._graph_dirty = True
    assert port_of_jax.optimize() is not None


def test_save_map_matches_generate_map_cloud(batch_runs, tmp_path):
    """`save_map`'s PCD holds `generate_map_cloud` of the keyframe clouds at
    their estimates; over the reference's clouds and estimates the port's
    map equals the reference's, point for point (the fma-chain transform and
    kernel 1's twin at 0.05 m over the 2^k-padded union)."""
    got, want = batch_runs
    clouds = [TCloud(*(torch.from_numpy(np.array(a)) for a in (k.cloud.xyz, k.cloud.intensity, k.cloud.mask)))
              for k in want.keyframes]
    poses = [k.estimate for k in want.keyframes]
    ref = jmap([k.cloud for k in want.keyframes], poses, 0.05)
    mine = generate_map_cloud(clouds, poses, 0.05)
    assert ref.shape[0] > 1000
    np.testing.assert_array_equal(mine, ref)
    assert got.save_map(str(tmp_path / "map.pcd"), utm=True)
    from lv_slam_tpu_torch.io import pcd

    saved = pcd.read_pcd(str(tmp_path / "map.pcd"))
    own = generate_map_cloud([k.cloud for k in got.keyframes], [k.estimate for k in got.keyframes], 0.05)
    np.testing.assert_array_equal(saved[:, 3], own[:, 3])
    np.testing.assert_allclose(saved[:, :3], own[:, :3] + got.zero_utm, rtol=1e-7)
    assert (tmp_path / "map.pcd.utm").exists()
