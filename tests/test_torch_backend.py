"""The port's GlobalGraph backend against `lv_slam_tpu.pipeline.backend.
GlobalGraph` (CPU), on `tests/test_backend.py`'s closed circle (56 scans of
32 x 450 rays, odometry drifting with a yaw bias), fed per scan (`add_scan`)
and per chunk of 16 filtered scans (`add_scan_batch`): in the pure-lidar
configuration (no camera images: every loop candidate scores 1.0), and with
the circle's camera images (ORB descriptors per keyframe, candidates ranked
by a vocabulary each package trains on its own keyframes), per scan from
host images and per chunk from a uint8 image stack.

The keyframe sequence numbers, the loop pairs, the rejection counters and
the loops' visual scores are equal, and so are the keypoints; descriptor
bits may differ only where the reference's float32 rounding of a rotated
BRIEF sample differs from the port's exact one (under 0.1 %, as in
`tests/test_torch_orb.py`). The estimates agree within the reference's own
rounding spread (EST_ATOL); the port behind `AsyncBackend` gives exactly
what it gives without it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import GraphConfig as JGraphCfg  # noqa: E402
from lv_slam_tpu.config import LoopDetectorConfig as JLoopCfg  # noqa: E402
from lv_slam_tpu.config import PrefilterConfig  # noqa: E402
from lv_slam_tpu.core import se3  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops.prefilter import prefilter  # noqa: E402
from lv_slam_tpu.pipeline.backend import GlobalGraph as JGraph  # noqa: E402
from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.pipeline.async_backend import AsyncBackend  # noqa: E402
from lv_slam_tpu_torch.pipeline.backend import GlobalGraph  # noqa: E402

N = 56
CHUNK = 16
GRAPH = dict(keyframe_delta_trans=5.0, keyframe_cap=64, edge_cap=256, solver_num_iterations=64)
LOOP = dict(distance_thresh=10.0, accum_distance_thresh=60.0, min_edge_interval=5.0, fitness_score_thresh=2.0)
PF = PrefilterConfig(raw_cap=16384, out_cap=16384)
# The reference's own spread (`scripts/reference_spread.py backend`): one-ulp
# noise on every filtered coordinate moves its keyframe estimates by up to
# 0.62 m (per chunk) and 0.59 m (per scan) in one of four perturbations and
# by at most 3.8 mm in the others, and in one per-scan perturbation the
# second loop closes to keyframe 3 instead of 0; the port is held to 5 cm,
# and its rotations to 5e-3.
EST_ATOL = 0.05  # m


def _world_and_gt():
    world = synthetic.make_world(seed=9, n_buildings=140, n_poles=240)
    angles = np.linspace(0, 2 * np.pi, N, endpoint=False)
    gt = []
    for a in angles:
        c, s = np.cos(a + np.pi / 2), np.sin(a + np.pi / 2)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        pose[:3, 3] = [20.0 * np.cos(a), 20.0 * np.sin(a), 1.73]
        gt.append(pose)
    return world, np.stack(gt)


@pytest.fixture(scope="module")
def raw_scans():
    """`test_backend.circle_run`'s raw scans."""
    world, gt = _world_and_gt()
    rays = synthetic.hdl64_rays(32, 450)
    return [synthetic.simulate_scan(world, gt[i], rays, seed=100 + i) for i in range(N)]


@pytest.fixture(scope="module")
def circle(raw_scans):
    """`test_backend.circle_run`'s scans and drifting odometry (no images),
    prefiltered by the reference: (filtered clouds as numpy, odometry)."""
    _, gt = _world_and_gt()
    pf = jax.jit(lambda cl: prefilter(cl, PF))
    filt = []
    for scan in raw_scans:
        c = pf(JCloud.from_numpy(scan, cap=16384))
        filt.append(tuple(np.asarray(a) for a in (c.xyz, c.intensity, c.mask)))
    bias = np.asarray(se3.exp_se3(jnp.asarray([0.01, 0.0, 0.0, 0.0, 0.0, 0.0015], jnp.float32)))
    odoms = [np.eye(4)]
    for i in range(1, N):
        odoms.append(odoms[-1] @ (np.linalg.inv(gt[i - 1]) @ gt[i] @ bias))
    return filt, np.stack(odoms)


@pytest.fixture(scope="module")
def images():
    """`test_backend.circle_run`'s camera images: uint8 (N, 128, 256)."""
    world, gt = _world_and_gt()
    return np.stack([synthetic.render_camera_image(world, gt[i], seed=9) for i in range(N)])


def _feed(backend, filt, odoms, per_scan: bool, cloud, stack, images=None, image_stack=None):
    """The reference test's feeding: per scan with an optimize every 10
    scans (each scan's host image when `images` is given), or per chunk of
    16 with an optimize after each (the chunk's images as `image_stack`
    makes them); then finish and drain."""
    if per_scan:
        for i in range(N):
            backend.add_scan(i, i * 0.1, odoms[i], cloud(filt[i]), image=None if images is None else images[i])
            if i % 10 == 9:
                backend.optimize()
    else:
        for s in range(0, N, CHUNK):
            e = min(s + CHUNK, N)
            imgs = None if images is None else image_stack(images[s:e])
            backend.add_scan_batch(s, np.arange(s, e) * 0.1, odoms[s:e], stack(filt[s:e]), images=imgs,
                                   filtered=True)
            backend.optimize()
    backend.finish()
    backend.drain()
    return backend


def _summary(backend):
    return dict(
        seqs=[k.seq for k in backend.keyframes],
        loops=[(lp.key1.seq, lp.key2.seq) for lp in backend.loops],
        visual=[lp.visual_score for lp in backend.loops],
        estimates=np.stack([k.estimate for k in backend.keyframes]),
        odom_xyz=[tuple(k.odom[:3, 3]) for k in backend.keyframes],
        points=[int(np.asarray(k.cloud.mask).sum()) for k in backend.keyframes],
        stats=dict(backend.loop_detector.stats),
        descriptors=[None if k.descriptor is None else np.asarray(k.descriptor) for k in backend.keyframes],
        keypoints=[None if k.keypoints is None else np.asarray(k.keypoints) for k in backend.keyframes],
        bow=backend.loop_detector.vocabulary is not None,
    )


def _jax(filt, odoms, per_scan, images=None):
    backend = JGraph(JGraphCfg(**GRAPH), JLoopCfg(**LOOP), keyframe_cloud_cap=65536, prefilter_cfg=PF)
    return _summary(_feed(
        backend, filt, odoms, per_scan,
        lambda f: JCloud(*(jnp.asarray(a) for a in f)),
        lambda fs: JCloud(jnp.stack([jnp.asarray(f[0].T) for f in fs]), jnp.stack([jnp.asarray(f[1]) for f in fs]),
                          jnp.stack([jnp.asarray(f[2]) for f in fs])),
        images, jnp.asarray,
    ))


def _port_backend():
    return GlobalGraph(GraphConfig(**GRAPH), LoopDetectorConfig(**LOOP), keyframe_cloud_cap=65536, device="cpu")


def _port(backend, filt, odoms, per_scan, images=None):
    return _summary(_feed(
        backend, filt, odoms, per_scan,
        lambda f: TCloud(*(torch.from_numpy(a) for a in f)),
        lambda fs: TCloud(torch.stack([torch.from_numpy(f[0].T.copy()) for f in fs]),
                          torch.stack([torch.from_numpy(f[1]) for f in fs]),
                          torch.stack([torch.from_numpy(f[2]) for f in fs])),
        images, lambda ims: torch.from_numpy(np.ascontiguousarray(ims)),
    ))


def _assert_same_run(got, want):
    assert got["seqs"] == want["seqs"]
    assert got["loops"] == want["loops"] and len(got["loops"]) >= 1
    assert got["stats"] == want["stats"]
    assert got["visual"] == want["visual"]
    assert got["bow"] == want["bow"]
    assert got["points"] == want["points"]
    flips = bits = 0
    for (dg, kg), (dw, kw) in zip(zip(got["descriptors"], got["keypoints"]),
                                  zip(want["descriptors"], want["keypoints"])):
        assert (dg is None) == (dw is None)
        if dw is not None:
            np.testing.assert_array_equal(kg, kw)
            assert dg.shape == dw.shape and dg.dtype == np.uint8
            flips += int(np.unpackbits(dg ^ dw).sum())
            bits += dw.size * 8
    assert flips <= 1e-3 * bits, (flips, bits)
    dt = np.linalg.norm(got["estimates"][:, :3, 3] - want["estimates"][:, :3, 3], axis=1)
    print(f"keyframes {got['seqs']}, loops {got['loops']} (visual {got['visual']}), stats {got['stats']}, "
          f"descriptor bits differing {flips} of {bits}, estimates differ by at most {dt.max():.3g} m")
    assert dt.max() <= EST_ATOL
    np.testing.assert_allclose(got["estimates"][:, :3, :3], want["estimates"][:, :3, :3], rtol=0, atol=5e-3)


@pytest.fixture(scope="module")
def port_batch(circle):
    return _port(_port_backend(), *circle, per_scan=False)


def test_per_scan_matches_reference(circle):
    _assert_same_run(_port(_port_backend(), *circle, per_scan=True), _jax(*circle, per_scan=True))


def test_batch_matches_reference(circle, port_batch):
    _assert_same_run(port_batch, _jax(*circle, per_scan=False))


def test_async_backend_equals_sync(circle, port_batch):
    """The worker thread changes nothing: the same keyframes, loops, clouds
    and estimates to the bit; a worker exception surfaces at join()."""
    got = _port(AsyncBackend(_port_backend()), *circle, per_scan=False)
    assert {k: v for k, v in got.items() if k != "estimates"} == {
        k: v for k, v in port_batch.items() if k != "estimates"
    }
    np.testing.assert_array_equal(got["estimates"], port_batch["estimates"])

    backend = AsyncBackend(_port_backend())
    backend.add_scan_batch(0, np.zeros(1), np.eye(4)[None], None, filtered=False)  # a malformed feed raises on the worker
    with pytest.raises(AttributeError):
        backend.join()


@pytest.fixture(scope="module")
def port_scan_images(circle, images):
    return _port(_port_backend(), *circle, per_scan=True, images=images)


def test_per_scan_images_match_reference(circle, images, port_scan_images):
    """Host images per scan; both packages train their vocabulary once 10
    keyframes carry descriptors."""
    want = _jax(*circle, per_scan=True, images=images)
    assert want["bow"]
    _assert_same_run(port_scan_images, want)


def test_batch_image_stack_matches_reference(circle, images):
    """A uint8 image stack per chunk: ORB for each chunk's keyframes in one call."""
    _assert_same_run(_port(_port_backend(), *circle, per_scan=False, images=images),
                     _jax(*circle, per_scan=False, images=images))


# `tests/test_backend.py::test_backend_loop_closure` as the JAX reference
# runs it on the CPU: the largest keyframe position error of the drifted
# odometry and of the optimized graph. The reference's own gate (after < 0.6 before) fails:
# its second loop, (54, 0), aligns 2.2 m off the true relative pose with a
# fitness of 0.027, inside the guess and fitness gates, and holds keyframe
# 54 where the odometry left it; its first loop, (51, 0), is true to 1 cm.
REF_LOOP_CLOSURE_ERR = (1.6444213000038428, 1.5842882477667262)  # m: odometry, graph


def test_backend_loop_closure(circle, raw_scans, images):
    """The port's counterpart of `tests/test_backend.py::test_backend_loop_closure`,
    on its inputs (raw clouds and host images per scan): every keyframe is
    described, the first loop passed the visual gate and is true, and the
    largest keyframe errors before and after the graph are the reference's."""
    _, odoms = circle
    backend = _port_backend()
    for i, scan in enumerate(raw_scans):
        backend.add_scan(i, i * 0.1, odoms[i], TCloud.from_numpy(scan, cap=16384, device="cpu"), image=images[i])
        if i % 10 == 9:
            backend.optimize()
    backend.finish()
    backend.drain()
    assert len(backend.keyframes) >= 8 and len(backend.loops) >= 1
    assert all(k.descriptor is not None and k.descriptor.shape[0] > 0 for k in backend.keyframes)
    first = backend.loops[0]
    assert first.visual_score >= 0.04
    _, gt = _world_and_gt()
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    true_rel = np.linalg.inv(gt_rel[first.key1.seq]) @ gt_rel[first.key2.seq]
    assert np.linalg.norm(first.relative_pose[:3, 3] - true_rel[:3, 3]) < 0.05
    before = max(np.linalg.norm(k.odom[:3, 3] - gt_rel[k.seq][:3, 3]) for k in backend.keyframes)
    after = max(np.linalg.norm(k.estimate[:3, 3] - gt_rel[k.seq][:3, 3]) for k in backend.keyframes)
    print(f"loops {[(lp.key1.seq, lp.key2.seq) for lp in backend.loops]}, largest error odometry {before:.4f} m, "
          f"graph {after:.4f} m (reference {REF_LOOP_CLOSURE_ERR})")
    np.testing.assert_allclose((before, after), REF_LOOP_CLOSURE_ERR, rtol=0, atol=EST_ATOL)


def test_unported_inputs_raise(circle, tmp_path):
    """The two calls that were refused before this backend's sensors and
    services were ported, made in both packages: a one-scan filtered chunk
    with an empty sensor reading, then the dump. The dumps hold the same
    keyframe, graph and files."""
    filt, odoms = circle
    backend = _port_backend()
    cloud = TCloud(torch.stack([torch.from_numpy(filt[0][0].T.copy())]), torch.from_numpy(filt[0][1])[None],
                   torch.from_numpy(filt[0][2])[None])
    backend.add_scan_batch(0, np.zeros(1), odoms[:1], cloud, sensors=[{}], filtered=True)
    backend.finish()
    backend.drain()
    assert backend.dump(str(tmp_path / "port"))
    ref = JGraph(JGraphCfg(**GRAPH), JLoopCfg(**LOOP), keyframe_cloud_cap=65536, prefilter_cfg=PF)
    ref.add_scan_batch(0, np.zeros(1), odoms[:1], JCloud(*(jnp.asarray(a)[None] for a in (filt[0][0].T, *filt[0][1:]))),
                       sensors=[{}], filtered=True)
    ref.finish()
    ref.drain()
    ref.dump(str(tmp_path / "jax"))
    assert backend._n_priors == ref._n_priors == 0 and len(backend.keyframes) == len(ref.keyframes) == 1
    for name in ("graph.g2o", "special_nodes.csv", "ggo_kf_odom.txt", "ggo_wf_odom.txt", "000000/data",
                 "000000/cloud.pcd"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
