"""The port's raw-chunk backend feed, `GlobalGraph.add_scan_batch(...,
filtered=False)` (kernel 2r's twin per window group), against the JAX
reference's on the feed of `tests/test_async_backend.py` (a 96-scan VLP-16
circle, ground-truth odometry, chunks of 16), each package run once per
module (`tests/test_torch_multi_loop.py` takes `tests/test_multi_loop.py`'s
double circle).

Keyframes, loop pairs and the loop detector's counters are equal; the
keyframe estimates agree within EST_ATOL; the port behind `AsyncBackend`
gives what it gives without it, bit for bit. EST_ATOL is grounded in the
reference's own spread (`scripts/reference_spread.py raw_backend`: moving
every raw coordinate by one ulp keeps the keyframes, loops and counters and
moves the estimates by up to 0.447 m on the circle, in three of four
perturbations, and by up to 11.3 mm on the double circle)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import GraphConfig as JGraphCfg  # noqa: E402
from lv_slam_tpu.config import LoopDetectorConfig as JLoopCfg  # noqa: E402
from lv_slam_tpu.config import PrefilterConfig as JPrefilterCfg  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.pipeline.backend import GlobalGraph as JGraph  # noqa: E402
from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.pipeline.async_backend import AsyncBackend  # noqa: E402
from lv_slam_tpu_torch.pipeline.backend import GlobalGraph  # noqa: E402

CAP = 8192
EST_ATOL = 0.05  # m (rotation entries: 5e-3; the circle's spread reaches 0.0176)


def _scans(n, seed, gt, rays):
    world = synthetic.make_world(seed=seed)
    return [synthetic.simulate_scan(world, gt[i], rays, seed=seed + i) for i in range(n)]


def _run(backend, scans, odom, chunk, optimize_every_chunk: bool, stack):
    n = len(scans)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        backend.add_scan_batch(s, np.arange(s, e) * 0.1, odom[s:e], stack(scans[s:e]))
        if optimize_every_chunk or e % 48 == 0:
            backend.optimize()
    backend.finish()
    backend.drain()
    return backend


def _jax_stack(scans):
    clouds = [JCloud.from_numpy(s, cap=CAP) for s in scans]
    return JCloud(*(jnp.stack([getattr(c, f) for c in clouds]) for f in ("xyz", "intensity", "mask")))


def _port_stack(scans):
    clouds = [TCloud.from_numpy(s, cap=CAP, device="cpu") for s in scans]
    return TCloud(*(torch.stack([getattr(c, f) for c in clouds]) for f in ("xyz", "intensity", "mask")))


def _summary(backend):
    return dict(
        seqs=[k.seq for k in backend.keyframes],
        loops=[(lp.key1.seq, lp.key2.seq) for lp in backend.loops],
        accums=[lp.key1.accum_distance for lp in backend.loops],
        stats=dict(backend.loop_detector.stats),
        points=[int(np.asarray(k.cloud.mask).sum()) for k in backend.keyframes],
        estimates=np.stack([k.estimate for k in backend.keyframes]),
        odoms=np.stack([k.odom for k in backend.keyframes]),
    )


def _assert_same_run(got, want):
    assert got["seqs"] == want["seqs"]
    assert got["loops"] == want["loops"] and len(got["loops"]) >= 1
    assert got["stats"] == want["stats"]
    assert got["points"] == want["points"]
    dt = np.linalg.norm(got["estimates"][:, :3, 3] - want["estimates"][:, :3, 3], axis=1)
    print(f"keyframes {got['seqs']}, loops {got['loops']}, stats {got['stats']}, estimates differ by at most "
          f"{dt.max():.3g} m")
    assert dt.max() <= EST_ATOL
    np.testing.assert_allclose(got["estimates"][:, :3, :3], want["estimates"][:, :3, :3], rtol=0, atol=5e-3)


# ------------------------------------------------ tests/test_async_backend.py's circle

CIRCLE_N = 96
CIRCLE_GRAPH = dict(keyframe_cap=32, edge_cap=128, prior_cap=8, keyframe_delta_trans=3.0, solver_num_iterations=32)
CIRCLE_LOOP = dict(distance_thresh=15.0, accum_distance_thresh=60.0, min_edge_interval=20.0, auto_train_vocab=False)


@pytest.fixture(scope="module")
def circle():
    gt = synthetic.circle_trajectory(CIRCLE_N, step=1.0, radius=CIRCLE_N / (2 * np.pi))
    scans = _scans(CIRCLE_N, 11, gt, synthetic.vlp16_rays(16, 500))
    odom = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float64)
    want = _summary(_run(
        JGraph(JGraphCfg(**CIRCLE_GRAPH), JLoopCfg(**CIRCLE_LOOP), keyframe_cloud_cap=16384,
               prefilter_cfg=JPrefilterCfg(raw_cap=CAP, out_cap=CAP)),
        scans, odom, 16, False, _jax_stack))
    return scans, odom, want


def _port_circle_backend():
    return GlobalGraph(GraphConfig(**CIRCLE_GRAPH), LoopDetectorConfig(**CIRCLE_LOOP), keyframe_cloud_cap=16384,
                       prefilter_cfg=PrefilterConfig(raw_cap=CAP, out_cap=CAP), device="cpu")


@pytest.fixture(scope="module")
def circle_port(circle):
    scans, odom, _ = circle
    return _summary(_run(_port_circle_backend(), scans, odom, 16, False, _port_stack))


def test_raw_chunk_feed_matches_reference(circle, circle_port):
    _assert_same_run(circle_port, circle[2])


def test_raw_chunk_feed_async_equals_sync(circle, circle_port):
    """`tests/test_async_backend.py::test_async_matches_sync` on the port:
    the worker thread changes nothing, to the bit."""
    scans, odom, _ = circle
    got = _summary(_run(AsyncBackend(_port_circle_backend()), scans, odom, 16, False, _port_stack))
    for key in ("seqs", "loops", "stats", "points"):
        assert got[key] == circle_port[key], key
    np.testing.assert_array_equal(got["estimates"], circle_port["estimates"])
