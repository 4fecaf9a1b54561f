"""The port's SE(3) math and point cloud against lv_slam_tpu.core (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core import se3 as jse3  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu_torch.core import se3 as tse3  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402

ATOL = 1e-5


def _tangents(kind: str) -> np.ndarray:
    """(64,6) se(3) tangents: generic, below the 1e-4 small-angle branch, or
    with the rotation angle within 1e-3 of pi."""
    rng = np.random.default_rng({"generic": 1, "small": 2, "near_pi": 3}[kind])
    rho = rng.normal(0.0, 2.0, (64, 3))
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if kind == "generic":
        theta = rng.uniform(1e-3, 3.0, (64, 1))
    elif kind == "small":
        theta = rng.uniform(0.0, 9e-5, (64, 1))
    else:
        theta = np.pi - rng.uniform(0.0, 1e-3, (64, 1))
    return np.concatenate([rho, axis * theta], axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", ["generic", "small", "near_pi"])
def test_exp_inverse_orthonormalize_angle(kind):
    tan = _tangents(kind)
    want = np.array(jse3.exp_se3(jnp.asarray(tan)))
    got = tse3.exp_se3(torch.from_numpy(tan))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    t_in = torch.from_numpy(want)
    np.testing.assert_allclose(
        tse3.inverse(t_in).numpy(), np.asarray(jse3.inverse(jnp.asarray(want))), atol=ATOL
    )
    # a perturbed rotation block, as the odometry feedback produces
    noisy = want + np.random.default_rng(4).normal(0.0, 1e-4, want.shape).astype(np.float32)
    noisy[:, 3] = [0.0, 0.0, 0.0, 1.0]
    np.testing.assert_allclose(
        tse3.orthonormalize(torch.from_numpy(noisy)).numpy(),
        np.asarray(jse3.orthonormalize(jnp.asarray(noisy))),
        atol=ATOL,
    )
    rot = want[:, :3, :3]
    np.testing.assert_allclose(
        tse3.rotation_angle(torch.from_numpy(rot)).numpy(),
        np.asarray(jse3.rotation_angle(jnp.asarray(rot))),
        atol=ATOL,
    )


@pytest.mark.parametrize("kind", ["generic", "near_pi"])
def test_quaternions(kind):
    rot = np.array(jse3.exp_so3(jnp.asarray(_tangents(kind)[:, 3:])))
    q_want = np.array(jse3.quat_from_matrix(jnp.asarray(rot)))
    q_got = tse3.quat_from_matrix(torch.from_numpy(rot)).numpy()
    np.testing.assert_allclose(q_got, q_want, atol=ATOL)
    assert (q_got[:, 0] >= 0).all()
    np.testing.assert_allclose(
        tse3.quat_to_matrix(torch.from_numpy(q_want)).numpy(),
        np.asarray(jse3.quat_to_matrix(jnp.asarray(q_want))),
        atol=ATOL,
    )


def test_cloud_from_numpy_and_compact():
    rng = np.random.default_rng(5)
    pts = rng.normal(0.0, 10.0, (300, 4)).astype(np.float32)
    pts[::7, 1] = np.nan  # non-finite returns are masked out
    for cap in (256, 512):
        j = JCloud.from_numpy(pts, cap=cap)
        t = TCloud.from_numpy(pts, cap=cap, device="cpu")
        for a, b in ((t.xyz, j.xyz), (t.intensity, j.intensity), (t.mask, j.mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for out_cap in (None, 128, cap):
            jc, tc = j.compact(out_cap), t.compact(out_cap)
            for a, b in ((tc.xyz, jc.xyz), (tc.intensity, jc.intensity), (tc.mask, jc.mask)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        t.masked_xyz().numpy(), np.asarray(j.masked_xyz())
    )
