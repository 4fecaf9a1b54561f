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
from lv_slam_tpu.ops import nn as _jnn  # noqa: E402,F401  (imported outside any trace: ROADMAP queue 3)
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


def _calibration_points(seed: int, n: int = 60000) -> np.ndarray:
    """Lidar-range points, points on the z axis (no rotation axis), points
    within a millimetre of it, flat far returns and a NaN row (masked)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        rng.uniform(-60.0, 60.0, (n, 3)),
        rng.normal(0.0, 1.0, (500, 3)) * [0.0, 0.0, 1.0],
        rng.uniform(-1.0, 1.0, (500, 3)) * 1e-3,
        rng.uniform(-80.0, 80.0, (n // 2, 3)) * [1.0, 1.0, 0.05],
        [[np.nan, 1.0, 2.0]],
    ]).astype(np.float32)
    return pts[rng.permutation(len(pts))]


@pytest.mark.parametrize("angle", [0.11, 1.7, 45.0])
def test_vertical_angle_calibration(angle):
    """Kernel 0a's twin equals JAX bit for bit at the reference's 0.11
    degrees and at 1.7 and 45 (measured: 0 of 3 x 270k coordinates differ),
    on the z axis, near it and on masked lanes (padding and a NaN row): the
    cross product, norm, `exp_so3` and einsum round as XLA's CPU fma chains,
    and torch's float32 `sin` / `cos` equal XLA's on these angles."""
    pts = _calibration_points(seed=12)
    cap = len(pts) + 100
    want = jax.jit(functools.partial(jpf.vertical_angle_calibration, angle_base_deg=angle))(
        JCloud.from_numpy(pts, cap=cap))
    got = tpf.vertical_angle_calibration(TCloud.from_numpy(pts, cap=cap, device="cpu"), angle)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert int((~got.mask).sum()) == 101


@pytest.mark.parametrize("angle", [0.11, 1.7])
def test_calibrated_band(angle):
    """The prefilter's front with both stages on (`calibrated_band`: on the
    card one launch of kernel 0a, here the twins composed) against JAX's
    `distance_filter(vertical_angle_calibration(c, a), 0.5, 100)`, bit for
    bit in xyz and mask, where the calibrated |p| lies within ulps of either
    band edge, on and near the z axis, on padding and on a NaN row."""
    pts = np.concatenate([_calibration_points(seed=12, n=20000), _band_edge_points(0.5, 20000, 3),
                          _band_edge_points(100.0, 20000, 4)])
    cap = len(pts) + 100
    want = jax.jit(lambda c: jpf.distance_filter(jpf.vertical_angle_calibration(c, angle), 0.5, 100.0))(
        JCloud.from_numpy(pts, cap=cap))
    got = tpf.calibrated_band(TCloud.from_numpy(pts, cap=cap, device="cpu"), angle, 0.5, 100.0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    np.testing.assert_array_equal(got.intensity.numpy(), np.asarray(want.intensity))
    for edge in (slice(-40000, -20000), slice(-20000, None)):  # both edges split their clouds
        assert 0 < int(got.mask[:len(pts)][edge].sum()) < 20000
    cfg = tc.PrefilterConfig(use_angle_calibration=True, angle_base=angle, downsample_method="NONE", raw_cap=cap,
                             out_cap=cap)
    chain = tpf.prefilter(TCloud.from_numpy(pts, cap=cap, device="cpu"), cfg)
    np.testing.assert_array_equal(chain.mask.numpy(), got.compact(cap).mask.numpy())


def test_angle_calibration_rotates_up():
    """`tests/test_io.py:69` on the port: range kept, elevation up 0.11 degrees."""
    pts = np.array([[10.0, 0.0, 0.0], [0.0, 10.0, -1.0]], np.float32)
    moved = tpf.vertical_angle_calibration(TCloud.from_numpy(pts, cap=4, device="cpu"), 0.11).xyz.numpy()[:2]
    np.testing.assert_allclose(np.linalg.norm(moved, axis=1), np.linalg.norm(pts, axis=1), rtol=1e-5)
    elev_before = np.arcsin(pts[:, 2] / np.linalg.norm(pts, axis=1))
    elev_after = np.arcsin(moved[:, 2] / np.linalg.norm(moved, axis=1))
    np.testing.assert_allclose(np.rad2deg(elev_after - elev_before), [0.11, 0.11], atol=1e-3)


@pytest.mark.parametrize("branches", [
    dict(outlier_removal_method="STATISTICAL"),
    dict(outlier_removal_method="RADIUS"),
    dict(use_angle_calibration=True),
    dict(use_angle_calibration=True, outlier_removal_method="STATISTICAL", downsample_method="DEDUP"),
    dict(outlier_removal_method="RADIUS", downsample_method="NONE", radius_radius=0.3, radius_min_neighbors=2),
])
def test_prefilter_chain_branches(branches, small_sequence):
    """The chain's last branches in the reference's order (calibration, band,
    downsample, removal) on a small_sequence scan: mask, lane order and
    points equal to JAX's; a removal drops lanes without compacting."""
    pts = np.asarray(small_sequence[0][1], np.float32)
    cfg = PrefilterConfig(raw_cap=16384, out_cap=16384, **branches)
    want = jax.jit(functools.partial(jpf.prefilter, cfg=cfg))(JCloud.from_numpy(pts, cap=16384))
    got = tpf.prefilter(TCloud.from_numpy(pts, cap=16384, device="cpu"), tc.PrefilterConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    np.testing.assert_array_equal(got.intensity.numpy(), np.asarray(want.intensity))
    if "outlier_removal_method" in branches:
        base = tpf.prefilter(TCloud.from_numpy(pts, cap=16384, device="cpu"), tc.PrefilterConfig(**dataclasses.asdict(
            dataclasses.replace(cfg, outlier_removal_method="NONE"))))
        n = int(got.mask.sum())
        assert 1000 < n < int(base.mask.sum()) and not bool(got.mask[:n].all())


def test_prefilter_unported_branches_raise():
    """The branches that raised before they were ported (the outlier
    removals, the angle calibration) now run and give JAX's cloud; what the
    port does not take still raises (a `voxel_reduce` other than the
    reference's two values, both served by kernel 1: scan == scatter)."""
    pts = _scan_points(seed=11)[:1000]
    cloud = TCloud.from_numpy(pts, cap=1024, device="cpu")
    for kw in (dict(outlier_removal_method="RADIUS"), dict(outlier_removal_method="STATISTICAL"),
               dict(use_angle_calibration=True)):
        cfg = PrefilterConfig(raw_cap=1024, out_cap=1024, **kw)
        want = jax.jit(functools.partial(jpf.prefilter, cfg=cfg))(JCloud.from_numpy(pts, cap=1024))
        got = tpf.prefilter(cloud, tc.PrefilterConfig(**dataclasses.asdict(cfg)))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    with pytest.raises(ValueError):
        tpf.prefilter(cloud, tc.PrefilterConfig(raw_cap=1024, out_cap=1024, voxel_reduce="sort"))
    scan = tpf.prefilter(cloud, tc.PrefilterConfig(raw_cap=1024, out_cap=1024, voxel_reduce="scan"))
    scatter = tpf.prefilter(cloud, tc.PrefilterConfig(raw_cap=1024, out_cap=1024))
    assert torch.equal(scan.xyz, scatter.xyz)


def _chip_smoke():
    """chip_smoke.py as a module (it imports numpy only at the top): the
    edge cases that the card's checks run."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()


@pytest.fixture(scope="module")
def sort_cases():
    return {name: case for name, *case in CHIP_SMOKE.sort_cases()}


@pytest.fixture(scope="module")
def subsample_cases():
    return {name: case for name, *case in CHIP_SMOKE.subsample_cases()}


@pytest.mark.parametrize("name", CHIP_SMOKE.SORT_CASE_NAMES)
def test_voxel_downsample_edge_cases(sort_cases, name):
    """Kernel 1's edge cases (`chip_smoke.sort_cases`, which the card holds
    the kernel to bit for bit against this twin): the twin equals JAX bit
    for bit (measured on every case), masked lanes holding NaN and
    unmasked lanes at kx >= 2^30 included."""
    pts, mask, res, out_cap, method = sort_cases[name]
    t_in = TCloud(torch.from_numpy(pts[:, :3].copy()), torch.from_numpy(pts[:, 3].copy()), torch.from_numpy(mask))
    want = jax.jit(functools.partial(jpf.voxel_downsample, resolution=res, out_cap=out_cap, method=method))(
        JCloud(pts[:, :3], pts[:, 3], mask))
    got = tpf.voxel_downsample(t_in, res, out_cap, method)
    assert got.cap == out_cap
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy().view(np.int32), np.asarray(want.xyz).view(np.int32))
    np.testing.assert_array_equal(got.intensity.numpy().view(np.int32), np.asarray(want.intensity).view(np.int32))
    n_voxels = int(got.mask.sum())
    assert got.mask[:n_voxels].all()  # front-compacted
    expected = {"every lane masked": 0, "one voxel holding every point": 1, "out_cap below the runs": out_cap}
    if name in expected:
        assert n_voxels == expected[name]


@pytest.mark.parametrize("name", CHIP_SMOKE.SUBSAMPLE_CASE_NAMES)
def test_uniform_subsample(subsample_cases, name):
    """Kernel 21's twin on `chip_smoke.subsample_cases` (which the card holds
    the kernel to bit for bit against this twin): equal to JAX bit for bit
    with no point set, fewer points than out_cap, exactly out_cap, KITTI
    density (100000 of 131072 lanes into 65536, where i * count overflows
    int32), a holey mask, out_cap at the lanes (the cloud itself) and a
    ragged tail."""
    pts, mask, out_cap = subsample_cases[name]
    j = JCloud(pts[:, :3], pts[:, 3], mask)
    t = TCloud(torch.from_numpy(pts[:, :3].copy()), torch.from_numpy(pts[:, 3].copy()), torch.from_numpy(mask))
    js, ts = jpf.uniform_subsample(j, out_cap), tpf.uniform_subsample(t, out_cap)
    assert ts.cap == min(out_cap, len(pts))
    for a, b in ((ts.xyz, js.xyz), (ts.intensity, js.intensity), (ts.mask, js.mask)):
        np.testing.assert_array_equal(a.numpy().view(np.uint8), np.ascontiguousarray(b).view(np.uint8))
    expected = {"count 0": 0, "count below out_cap": 5000, "count equal to out_cap": out_cap,
                "KITTI density": out_cap}
    if name in expected:
        assert int(ts.mask.sum()) == expected[name]
