"""The port's floor detection (kernel 16's plain twin) against
`lv_slam_tpu.ops.floor.detect_floor` (CPU).

The hypotheses are the reference's: `randint_triples` replays
`jax.random.randint(PRNGKey(seed), (H, 3), 0, n)` (threefry2x32,
partitionable, randint's two-word reduction) bit for bit. The inlier test
rounds as XLA's CPU dot does (an fma chain, the offset added after it), so
the counts, the best hypothesis and the inlier count are equal; the refit's
float32 sums run in another order, so the coefficients agree to 1e-5. The
best index is read from the reference's own expressions (its function
returns only the count)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.ops.floor import detect_floor as jdetect  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import floor  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_randint_triples_match_jax(seed):
    for n in (1, 3, 1000, 65536, 100003, 131072):
        for h in (1, 5, 256):
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (h, 3), 0, n))
            np.testing.assert_array_equal(floor.randint_triples(seed, n, h), want, err_msg=f"n={n} H={h}")


def _reference_best(cloud: JCloud, seed: int = 0) -> int:
    """The reference's hypothesis counts and argmax (`ops/floor.py:40-64`,
    its default parameters), as its own expressions compute them."""
    xyz = cloud.masked_xyz()
    band = cloud.mask & (jnp.abs(xyz[:, 2] + 1.73) < 1.0)
    idx = jax.random.randint(jax.random.PRNGKey(seed), (256, 3), 0, xyz.shape[0])
    p = xyz[idx]
    norm_vec = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nn = jnp.linalg.norm(norm_vec, axis=1)
    unit = norm_vec / jnp.maximum(nn, 1e-9)[:, None]
    unit = unit * jnp.where(unit[:, 2:3] < 0, -1.0, 1.0)
    ok = band[idx].all(axis=1) & (nn > 1e-6) & (unit[:, 2] > jnp.cos(jnp.deg2rad(10.0)))
    d = -jnp.sum(unit * p[:, 0], axis=1)
    inlier = (jnp.abs(xyz @ unit.T + d[None, :]) < 0.1) & band[:, None]
    return int(jnp.argmax(jnp.where(ok, jnp.sum(inlier.astype(jnp.int32), axis=0), -1)))


def _near_threshold_cloud() -> np.ndarray:
    """A tilted floor 1.73 m below the sensor with every point 0.095-0.105 m
    off it (half inside the 0.1 m threshold), plus clutter."""
    rng = np.random.default_rng(4)
    n = 20000
    xy = rng.uniform(-20, 20, (n, 2))
    nrm = np.array([0.02, -0.01, 1.0]) / np.linalg.norm([0.02, -0.01, 1.0])
    z = (-1.73 - (nrm[0] * xy[:, 0] + nrm[1] * xy[:, 1])) / nrm[2]
    z += rng.choice([-1, 1], n) * rng.uniform(0.095, 0.105, n)
    return np.r_[np.c_[xy, z], rng.uniform(-20, 20, (4000, 3))].astype(np.float32)


@pytest.mark.parametrize("which", ["scan0", "scan3", "near_threshold"])
def test_detect_floor_matches_jax(small_sequence, which):
    scans = small_sequence[0]
    pts = _near_threshold_cloud() if which == "near_threshold" else scans[int(which[-1])]
    jc = JCloud.from_numpy(pts, cap=32768)
    want = jax.jit(jdetect)(jc)
    got = floor.detect_floor(TCloud.from_numpy(pts, cap=32768, device="cpu"))
    print(f"{which}: best {int(got.best)}, inliers {int(got.n_inliers)}, coeffs {got.coeffs.numpy()}, JAX "
          f"{np.asarray(want.coeffs)}")
    assert bool(got.found) == bool(want.found) is True
    assert int(got.n_inliers) == int(want.n_inliers) > 0
    assert int(got.best) == _reference_best(jc)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=0, atol=1e-5)
