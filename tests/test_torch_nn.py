"""The port's centroid grid and nearest-centroid queries (kernel 14's plain
twins) against `lv_slam_tpu.ops.nn` (CPU), and the edge information matrix
that the fitness feeds against `lv_slam_tpu.graph.information_matrix`.

Cell keys, counts, origin and the set of hits (which query lanes find a
centroid) are identical; centroids and squared distances agree to 1e-6
relative (the sums run in the same order, the distance's three squares may
be contracted differently by XLA); the fitness to 1e-5 relative (a mean
over ~20k lanes summed in another order)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
