"""The port's prefilter (kernel 1's plain twin on CPU) against
lv_slam_tpu.ops.prefilter. The mask and the lane order must be identical:
`stride_subsample` slices lanes, so the order decides which points the NDT
sees."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.ops import prefilter as jpf  # noqa: E402
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
