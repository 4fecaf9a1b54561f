"""The port's prefilter (kernel 1's and 1b's plain twins on CPU) against
lv_slam_tpu.ops.prefilter. The mask and the lane order must be identical:
`stride_subsample` slices lanes, so the order decides which points the NDT
sees."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402

from lv_slam_tpu.config import PrefilterConfig  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.ops import prefilter as jpf  # noqa: E402
from lv_slam_tpu_torch import config as tc  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import prefilter as tpf  # noqa: E402


def _scan_points(seed: int = 7, n: int = 20000) -> np.ndarray:
    """Lidar-like points with negative coordinates, many duplicate-voxel runs
    (clusters well inside one 0.1 m cell) and points on cell faces."""
    rng = np.random.default_rng(seed)
    far = rng.uniform(-60.0, 60.0, (n // 2, 3))
    centers = rng.uniform(-20.0, 20.0, (n // 8, 3))
    near = np.repeat(centers, 4, axis=0) + rng.normal(0.0, 0.01, (n // 2, 3))
    faces = np.round(rng.uniform(-30.0, 30.0, (512, 3)), 1)  # multiples of 0.1
    pts = np.concatenate([far, near, faces]).astype(np.float32)
    inten = rng.uniform(0.0, 1.0, (pts.shape[0], 1)).astype(np.float32)
    return np.concatenate([pts, inten], axis=1)[rng.permutation(pts.shape[0])]


def _assert_same_cloud(t: TCloud, j: JCloud):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.intensity.numpy(), np.asarray(j.intensity), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "method,cap,out_cap",
    [
        ("VOXELGRID", 32768, 32768),
        ("APPROX_VOXELGRID", 32768, 16384),
        ("VOXELGRID", 16384, 32768),  # cap < out_cap pads
    ],
)
def test_voxel_downsample(method, cap, out_cap):
    pts = _scan_points()
    j_in = jpf.distance_filter(JCloud.from_numpy(pts, cap=cap), 0.5, 100.0)
    t_in = tpf.distance_filter(TCloud.from_numpy(pts, cap=cap, device="cpu"), 0.5, 100.0)
    want = jax.jit(
        functools.partial(jpf.voxel_downsample, resolution=0.1, out_cap=out_cap, method=method)
    )(j_in)
    got = tpf.voxel_downsample(t_in, 0.1, out_cap, method)
    assert got.cap == out_cap
    _assert_same_cloud(got, want)
    n_valid = int(np.asarray(want.mask).sum())
    # duplicate-voxel runs really merged, and the output is front-compacted
    assert n_valid < int(np.asarray(j_in.mask).sum())
    assert np.asarray(want.mask)[:n_valid].all()


def test_distance_filter_and_stride_subsample():
    pts = _scan_points(seed=8)
    j = jpf.distance_filter(JCloud.from_numpy(pts, cap=32768), 0.5, 40.0)
    t = tpf.distance_filter(TCloud.from_numpy(pts, cap=32768, device="cpu"), 0.5, 40.0)
    for a, b in ((t.xyz, j.xyz), (t.intensity, j.intensity), (t.mask, j.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for out_cap in (16384, 8192, 32768):
        js, ts = jpf.stride_subsample(j, out_cap), tpf.stride_subsample(t, out_cap)
        for a, b in ((ts.xyz, js.xyz), (ts.mask, js.mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tpf.stride_subsample(t, 10000)


def test_uniform_subsample():
    pts = _scan_points(seed=9)
    j = JCloud.from_numpy(pts, cap=32768).compact()
    t = TCloud.from_numpy(pts, cap=32768, device="cpu").compact()
    js, ts = jpf.uniform_subsample(j, 8192), tpf.uniform_subsample(t, 8192)
    for a, b in ((ts.xyz, js.xyz), (ts.intensity, js.intensity), (ts.mask, js.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _band_edge_points(radius: float, n: int, seed: int) -> np.ndarray:
    """Random directions at `radius`, each coordinate then moved by -4 to +4
    ulps: |p| lies within a few ulps of the band edge."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    p = (d / np.linalg.norm(d, axis=1, keepdims=True) * radius).astype(np.float32)
    steps = rng.integers(-4, 5, p.shape)
    for k in range(4):
        p = np.where(steps > k, np.nextafter(p, np.float32(np.inf)), p)
        p = np.where(steps < -k, np.nextafter(p, np.float32(-np.inf)), p)
    return p.astype(np.float32)


@pytest.mark.parametrize("which", ["near", "far", "scans"])
def test_distance_filter_band_edges(which, small_sequence):
    """The band's mask equals JAX's lane for lane where |p| is within ulps
    of the near (0.5 m) and far (100 m) edges, and on small_sequence's raw
    scans. |p| rounds as XLA's fma chain under a correctly rounded root; a
    separately rounded sum with torch's CPU float32 sqrt differed on 811 of
    50000 lanes at 0.5 m and on 865 at 100 m (0 on the scans)."""
    if which == "scans":
        clouds = [np.asarray(s, np.float32)[:, :3] for s in small_sequence[0]]
    else:
        clouds = [_band_edge_points(0.5 if which == "near" else 100.0, 50000, 1 if which == "near" else 2)]
    f = jax.jit(lambda c: jpf.distance_filter(c, 0.5, 100.0))
    for pts in clouds:
        want = np.asarray(f(JCloud.from_numpy(pts, cap=len(pts))).mask)
        got = tpf.distance_filter(TCloud.from_numpy(pts, cap=len(pts), device="cpu"), 0.5, 100.0).mask.numpy()
        assert 0 < want.sum() < len(pts) or which == "scans"
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["VOXELGRID", "DEDUP", "NONE"])
def test_prefilter_chain(method):
    """`prefilter(cloud, cfg)` (the reference's chain, ops/prefilter.py:310)
    for VOXELGRID (kernel 1), DEDUP (kernel 1b) and NONE (a compaction):
    mask, lane order and points equal to JAX's."""
    pts = _scan_points(seed=10)
    cfg = PrefilterConfig(downsample_method=method, raw_cap=32768, out_cap=16384)
    want = jax.jit(functools.partial(jpf.prefilter, cfg=cfg))(JCloud.from_numpy(pts, cap=32768))
    got = tpf.prefilter(TCloud.from_numpy(pts, cap=32768, device="cpu"),
                        tc.PrefilterConfig(**dataclasses.asdict(cfg)))
    assert got.cap == np.asarray(want.mask).shape[0]
    _assert_same_cloud(got, want)
    n = int(got.mask.sum())
    assert 1000 < n and bool(got.mask[:n].all())  # front-compacted


def test_host_chain_compacts_before_the_subsample():
    """The host counterpart of `tests/test_dlo.py:165`: with NONE the
    distance band only clears mask bits; `prefilter` front-compacts, so the
    host DLO's uniform subsample keeps `out_cap` lanes spread over the whole
    band (the reference's survivors, lane for lane)."""
    n, out_cap = 4096, 512
    rng = np.random.default_rng(1)
    pts = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    pts[::2] *= 0.001  # even lanes fall below distance_near_thresh
    cfg = PrefilterConfig(raw_cap=n, out_cap=n, downsample_method="NONE")
    want = jpf.uniform_subsample(jax.jit(functools.partial(jpf.prefilter, cfg=cfg))(JCloud.from_numpy(pts, cap=n)),
                                 out_cap)
    got = tpf.uniform_subsample(
        tpf.prefilter(TCloud.from_numpy(pts, cap=n, device="cpu"), tc.PrefilterConfig(**dataclasses.asdict(cfg))),
        out_cap)
    assert int(got.mask.sum()) == out_cap
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    kept = got.xyz.numpy()
    hist, _ = np.histogram(np.arctan2(kept[:, 1], kept[:, 0]), bins=8, range=(-np.pi, np.pi))
    assert (hist > 0).all()


def test_prefilter_unported_branches_raise():
    """The outlier removals and the angle calibration (ROADMAP item 6) raise
    instead of running something else; `voxel_reduce` takes the reference's
    two values, both served by kernel 1."""
    cloud = TCloud.from_numpy(_scan_points(seed=11)[:1000], cap=1024, device="cpu")
    for kw in (dict(outlier_removal_method="RADIUS"), dict(outlier_removal_method="STATISTICAL"),
               dict(use_angle_calibration=True)):
        with pytest.raises(NotImplementedError):
            tpf.prefilter(cloud, tc.PrefilterConfig(raw_cap=1024, out_cap=1024, **kw))
    scan = tpf.prefilter(cloud, tc.PrefilterConfig(raw_cap=1024, out_cap=1024, voxel_reduce="scan"))
    scatter = tpf.prefilter(cloud, tc.PrefilterConfig(raw_cap=1024, out_cap=1024))
    assert torch.equal(scan.xyz, scatter.xyz)
