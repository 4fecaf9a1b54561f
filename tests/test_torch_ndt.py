"""The port's NDT derivative pass (kernel 4's plain twin) and hash-table
align against lv_slam_tpu.ops.ndt_hash, on the same hash table (CPU)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops import ndt_hash as jh  # noqa: E402
from lv_slam_tpu.ops.ndt import make_gauss_params as j_gauss  # noqa: E402
from lv_slam_tpu.ops.voxel_map import build_voxel_map, neighborhood_offsets as j_offsets  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import ndt_hash as th  # noqa: E402
from lv_slam_tpu_torch.ops.ndt import make_gauss_params as t_gauss  # noqa: E402
from lv_slam_tpu_torch.ops.voxel_map import neighborhood_offsets as t_offsets  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    """A weighted keyframe hash map (built by the reference, then handed to
    both sides as the same table) and the next scan as the source."""
    scans, poses, _ = synthetic.make_sequence(
        2, seed=41, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=450
    )
    target = JCloud.from_numpy(scans[0], cap=16384)
    vm = jax.jit(
        functools.partial(build_voxel_map, resolution=1.0, leaf_cap=16384, lut_extent=256, weighted=True)
    )(target)
    jmap = jax.jit(jh.to_hash)(vm)
    tmap = th.HashVoxelMap(
        table=torch.from_numpy(np.array(jmap.table)),
        origin_cell=torch.from_numpy(np.array(jmap.origin_cell)),
        resolution=float(jmap.resolution),
        extent=int(jmap.extent),
        n_dropped=torch.tensor(int(jmap.n_dropped), dtype=torch.int32),
    )
    return jmap, tmap, scans[1], np.linalg.inv(poses[0]) @ poses[1]


def test_gauss_params():
    np.testing.assert_allclose(t_gauss(1.0), [float(x) for x in j_gauss(1.0)], rtol=1e-6)


@pytest.mark.parametrize("neighborhood,weighted", [("DIRECT1", True), ("DIRECT7", False)])
def test_derivatives(setup, neighborhood, weighted):
    """Score rtol 1e-4; gradient and Hessian atol 2e-5 of their max entry
    (the tolerances of tests/test_ndt_hash.py)."""
    jmap, tmap, src, _ = setup
    transform = np.eye(4, dtype=np.float32)
    transform[0, 3], transform[1, 3] = 1.2, -0.1
    jsrc = JCloud.from_numpy(src, cap=16384)
    s1, g1, h1 = jax.jit(
        lambda T: jh.ndt_derivatives_hash(
            jmap, jsrc.masked_xyz().T, jsrc.mask, T, j_gauss(1.0), j_offsets(neighborhood), weighted
        )
    )(jnp.asarray(transform))
    tsrc = TCloud.from_numpy(src, cap=16384, device="cpu")
    s2, g2, h2 = th.ndt_derivatives_hash(
        tmap, tsrc.masked_xyz().T.contiguous(), tsrc.mask, torch.from_numpy(transform),
        t_gauss(1.0), t_offsets(neighborhood, "cpu"), weighted,
    )
    assert float(s1) > 0.0  # real hits: the mixture score is positive
    np.testing.assert_allclose(float(s2), float(s1), rtol=1e-4)
    g1, h1 = np.asarray(g1), np.asarray(h1)
    np.testing.assert_allclose(g2.numpy(), g1, rtol=0, atol=2e-5 * np.abs(g1).max())
    np.testing.assert_allclose(h2.numpy(), h1, rtol=0, atol=2e-5 * np.abs(h1).max())


@pytest.mark.parametrize("coarse_subsample", [1, 2])
def test_align(setup, coarse_subsample):
    """Transform atol 1e-4 and the same Newton iteration count."""
    jmap, tmap, src, gt = setup
    kw = dict(
        resolution=1.0, transformation_epsilon=0.01, max_iterations=64,
        neighborhood="DIRECT1", weighted=True, coarse_subsample=coarse_subsample,
    )
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 1.4
    want = jax.jit(functools.partial(jh.ndt_align_hash_table, **kw))(
        jmap, JCloud.from_numpy(src, cap=16384), jnp.asarray(guess)
    )
    got = th.ndt_align_hash_table(tmap, TCloud.from_numpy(src, cap=16384, device="cpu"), torch.from_numpy(guess), **kw)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert np.linalg.norm(got.transform.numpy()[:3, 3] - gt[:3, 3]) < 0.05
