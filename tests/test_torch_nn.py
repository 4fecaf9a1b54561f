"""The port's centroid grid and nearest-centroid queries (kernel 14's plain
twins) against `lv_slam_tpu.ops.nn` (CPU), and the edge information matrix
that the fitness feeds against `lv_slam_tpu.graph.information_matrix`.

Cell keys, counts, origin and the set of hits (which query lanes find a
centroid) are identical; centroids and squared distances agree to 1e-6
relative (the sums run in the same order, the distance's three squares may
be contracted differently by XLA); the fitness to 1e-5 relative (a mean
over ~20k lanes summed in another order). `nn_points` (kernel 17's twin)
takes the distance as XLA's fma chain, so its distances, matches and
validity equal JAX's bit for bit; the outlier removals (kernel 18's twins)
count integers, so their masks are identical."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops import nn as jnn  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import nn as tnn  # noqa: E402

CAP = 32768


@pytest.fixture(scope="module")
def scans():
    s, poses, _ = synthetic.make_sequence(2, seed=41, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=450)
    return s, (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)


@pytest.mark.parametrize("leaf_cap", [65536, 2048])
def test_build_centroid_grid(scans, leaf_cap):
    """Keys ascending, the same leaves (`leaf_cap` 2048 truncates by key
    order, as the reference does), counts equal, centroids to 1e-6 relative."""
    (s0, _), _ = scans
    build = jax.jit(functools.partial(jnn.build_centroid_grid, resolution=0.25, leaf_cap=leaf_cap))
    want = build(JCloud.from_numpy(s0, cap=CAP))
    got = tnn.build_centroid_grid(TCloud.from_numpy(s0, cap=CAP, device="cpu"), 0.25, leaf_cap)
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.origin_cell.numpy(), np.asarray(want.origin_cell))
    valid = got.counts.numpy() > 0
    assert valid.sum() > 1000
    if leaf_cap == 2048:
        assert valid.all()  # more occupied cells than leaves: the first 2048 by key
    c_j = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy()[valid], c_j[valid], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.centroids.numpy()[~valid], c_j[~valid])


@pytest.fixture(scope="module")
def grids(scans):
    (s0, _), _ = scans
    want = jax.jit(functools.partial(jnn.build_centroid_grid, resolution=0.25))(JCloud.from_numpy(s0, cap=CAP))
    got = tnn.build_centroid_grid(TCloud.from_numpy(s0, cap=CAP, device="cpu"), 0.25)
    return want, got


def test_nn_sq_dists(scans, grids):
    """Scan 1 at the true pose: the same lanes hit, d2 to 1e-6 relative."""
    (_, s1), rel = scans
    want_grid, got_grid = grids
    src = JCloud.from_numpy(s1, cap=CAP).transformed(jnp.asarray(rel))
    want = np.asarray(jax.jit(jnn.nn_sq_dists)(want_grid, src.masked_xyz(), src.mask))
    tsrc = TCloud.from_numpy(s1, cap=CAP, device="cpu").transformed(torch.from_numpy(rel))
    got = tnn.nn_sq_dists(got_grid, tsrc.masked_xyz(), tsrc.mask).numpy()
    hit = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), hit)
    assert 0.5 * hit.size > hit.sum() > 5000
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("offset", [0.0, 0.7])
def test_fitness_score(scans, offset):
    """`fitness_score` at the true pose and 0.7 m off it."""
    (s0, s1), rel = scans
    t = rel.copy()
    t[0, 3] += offset
    want = float(jax.jit(jnn.fitness_score)(JCloud.from_numpy(s0, cap=CAP), JCloud.from_numpy(s1, cap=CAP),
                                           jnp.asarray(t)))
    got = float(tnn.fitness_score(TCloud.from_numpy(s0, cap=CAP, device="cpu"),
                                  TCloud.from_numpy(s1, cap=CAP, device="cpu"), torch.from_numpy(t)))
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("const", [True, False])
def test_calc_information_matrix(scans, const):
    """`graph/information_matrix` against the reference's: the constant
    matrix exactly, the fitness-adaptive one (kernel 14's fitness through
    the saturating weights) to 1e-5 relative, 0.3 m off the true pose."""
    from lv_slam_tpu.config import GraphConfig as JGraphCfg
    from lv_slam_tpu.graph.information_matrix import calc_information_matrix as j_info
    from lv_slam_tpu_torch.config import GraphConfig
    from lv_slam_tpu_torch.graph.information_matrix import calc_information_matrix as t_info

    (s0, s1), rel = scans
    t = rel.copy()
    t[1, 3] += 0.3
    want = j_info(JCloud.from_numpy(s0, cap=CAP), JCloud.from_numpy(s1, cap=CAP), t,
                  JGraphCfg(use_const_inf_matrix=const))
    got = t_info(TCloud.from_numpy(s0, cap=CAP, device="cpu"), TCloud.from_numpy(s1, cap=CAP, device="cpu"), t,
                 GraphConfig(use_const_inf_matrix=const))
    assert got.dtype == want.dtype == np.float32
    if const:
        np.testing.assert_array_equal(got, want)
    else:
        assert not np.allclose(want, j_info(None, None, t, JGraphCfg()))  # the fitness moved the weights
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _with_faces(pts: np.ndarray, cell: float, seed: int, n: int = 3000) -> np.ndarray:
    """`pts` with points on cell faces appended: n of its points with every
    coordinate moved to the nearest multiple of `cell`, and the same points
    one ulp either side (at 0 a subnormal, which XLA's CPU code flushes to
    0, and so does the port's cell rule)."""
    rng = np.random.default_rng(seed)
    base = pts[rng.choice(len(pts), n, replace=False), :3]
    faces = (np.round(base / cell) * cell).astype(np.float32)
    up, down = (np.nextafter(faces, np.float32(d)) for d in (np.inf, -np.inf))
    extra = np.concatenate([faces, up, down])
    extra = np.concatenate([extra, np.zeros((len(extra), pts.shape[1] - 3), np.float32)], axis=1)
    return np.concatenate([pts, extra]).astype(np.float32)


def test_nn_points(scans, grids):
    """Scan 1 0.1 m off the true pose, with points on the 0.25 m cell faces:
    valid identical, and on every lane the squared distance and the matched
    centroid bit for bit (a miss matches leaf 0, as the reference's gather)."""
    (_, s1), rel = scans
    want_grid, got_grid = grids
    t = rel.copy()
    t[0, 3] += 0.1
    pts = _with_faces(s1, 0.25, seed=3)
    src = JCloud.from_numpy(pts, cap=CAP).transformed(jnp.asarray(t))
    want = [np.asarray(x) for x in jax.jit(jnn.nn_points)(want_grid, src.masked_xyz(), src.mask)]
    tsrc = TCloud.from_numpy(pts, cap=CAP, device="cpu").transformed(torch.from_numpy(t))
    got = [x.numpy() for x in tnn.nn_points(got_grid, tsrc.masked_xyz(), tsrc.mask)]
    assert want[2].sum() > 5000 and (~want[2]).sum() > 1000  # hits, and misses or masked lanes
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# masks that differ from JAX's at the statistical threshold: measured 0 on
# every case below (the twin's float64-rounded cube root is off JAX's float32
# `cbrt` by up to 1.5 ulp, and its sums run in another order, but the
# isolation distances take one value per integer density, none of them
# within those ulps of the threshold)
STATISTICAL_FLIPS = 0


@pytest.mark.parametrize("method,kw", [
    ("radius", dict(radius=0.5, min_neighbors=5)),
    ("radius", dict(radius=0.3, min_neighbors=2)),
    ("statistical", dict(mean_k=30, stddev_mult=1.2)),
    ("statistical", dict(mean_k=10, stddev_mult=0.5)),
])
def test_outlier_removal(scans, method, kw):
    """Both scans through the reference's band and 0.1 m voxels (JAX's
    prefilter), with points on the removal's cell faces: the kept lanes
    equal JAX's (STATISTICAL within the measured threshold flips), dropped
    lanes at the sentinel, nothing compacted."""
    from lv_slam_tpu.config import PrefilterConfig
    from lv_slam_tpu.ops import prefilter as jpf

    cell = kw.get("radius", 0.5)
    jfn, tfn = getattr(jnn, f"{method}_outlier_removal"), getattr(tnn, f"{method}_outlier_removal")
    for i, s in enumerate(scans[0]):
        cfg = PrefilterConfig(raw_cap=CAP, out_cap=CAP)
        cloud = jax.jit(functools.partial(jpf.prefilter, cfg=cfg))(JCloud.from_numpy(s, cap=CAP))
        pts = _with_faces(np.asarray(cloud.xyz)[np.asarray(cloud.mask)], cell, seed=i, n=1000)
        want = jax.jit(functools.partial(jfn, **kw))(JCloud.from_numpy(pts, cap=CAP))
        got = tfn(TCloud.from_numpy(pts, cap=CAP, device="cpu"), **kw)
        keep = np.asarray(want.mask)
        flips = int((got.mask.numpy() != keep).sum())
        assert flips <= (STATISTICAL_FLIPS if method == "statistical" else 0), flips
        same = got.mask.numpy() == keep
        np.testing.assert_array_equal(got.xyz.numpy()[same], np.asarray(want.xyz)[same])
        assert 1000 < keep.sum() < len(pts) - 500  # the removal dropped lanes


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
def grid_cases():
    return {name: case for name, *case in CHIP_SMOKE.grid_cases()}


@pytest.mark.parametrize("name", CHIP_SMOKE.GRID_CASE_NAMES)
def test_grid_edge_cases(grid_cases, name):
    """Kernel 14's twins on `chip_smoke.grid_cases` (which the card holds the
    kernels to against these twins) against JAX's `build_centroid_grid` and
    `nn_sq_dists`: keys, counts and origin identical, centroids to 1e-6
    relative; the hit set identical, d2 to 1e-6 relative."""
    pts, mask, leaf_cap, queries, qmask = grid_cases[name]
    res = CHIP_SMOKE.GRID_RES
    want = jax.jit(functools.partial(jnn.build_centroid_grid, resolution=res, leaf_cap=leaf_cap))(
        JCloud(pts, np.zeros(len(pts), np.float32), mask))
    got = tnn.build_centroid_grid(TCloud(torch.from_numpy(pts), torch.zeros(len(pts)), torch.from_numpy(mask)),
                                  res, leaf_cap)
    for field in ("keys", "counts", "origin_cell"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    valid = got.counts.numpy() > 0
    c_j = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy()[valid], c_j[valid], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.centroids.numpy()[~valid], c_j[~valid])
    jq = JCloud(queries, np.zeros(len(queries), np.float32), qmask)
    d2_j = np.asarray(jax.jit(jnn.nn_sq_dists)(want, jq.masked_xyz(), jq.mask))
    tq = TCloud(torch.from_numpy(queries), torch.zeros(len(queries)), torch.from_numpy(qmask))
    d2_t = tnn.nn_sq_dists(got, tq.masked_xyz(), tq.mask).numpy()
    hit = np.isfinite(d2_j)
    np.testing.assert_array_equal(np.isfinite(d2_t), hit)
    np.testing.assert_allclose(d2_t[hit], d2_j[hit], rtol=1e-6, atol=1e-12)
    n_leaves = int(valid.sum())
    if name in ("empty cloud (every lane the sentinel)", "every lane masked"):
        assert n_leaves == 0 and got.origin_cell.tolist() == [0, 0, 0] and not hit.any()
    elif name == "leaf_cap below the runs":
        assert n_leaves == leaf_cap
    elif name == "one cell holding every point":
        assert n_leaves == 1 and int(got.counts[0]) == len(pts) and hit.sum() > len(pts) // 2
    elif name == "cells at the 1024 extent's edges":
        rel = np.floor(pts * np.float32(1.0 / res)).astype(np.int64) - got.origin_cell.numpy()
        assert rel.min() == 0 and rel.max() == 1024  # lanes past the extent, dropped
        keys = got.keys.numpy()[valid]
        assert (keys % 1024 == 0).any() and (keys % 1024 == 1023).any()
        assert n_leaves == int((np.unique(rel[(rel < 1024).all(1)], axis=0)).shape[0])
        assert len(queries) > hit.sum() > 0.3 * len(queries)
    else:
        assert hit.sum() > len(queries) // 3
