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
from test_torch_kernels import load_chip_smoke  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_randint_triples_match_jax(seed):
    for n in (1, 3, 1000, 65536, 100003, 131072):
        for h in (1, 5, 256):
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (h, 3), 0, n))
            np.testing.assert_array_equal(floor.randint_triples(seed, n, h), want, err_msg=f"n={n} H={h}")


def _reference_best(cloud: JCloud, seed: int = 0, n_hypotheses: int = 256) -> int:
    """The reference's hypothesis counts and argmax (`ops/floor.py:40-64`,
    its default parameters), as its own expressions compute them."""
    xyz = cloud.masked_xyz()
    band = cloud.mask & (jnp.abs(xyz[:, 2] + 1.73) < 1.0)
    idx = jax.random.randint(jax.random.PRNGKey(seed), (n_hypotheses, 3), 0, xyz.shape[0])
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


CS = load_chip_smoke()  # the case lists that chip_smoke.py also runs on the card


@pytest.mark.parametrize("case", CS.FLOOR_CASE_NAMES)
def test_floor_cases_against_jax(case):
    """Kernel 16's edge cases (chip_smoke.floor_cases, which the card runs
    against this twin): found, the inlier count and the best index equal to
    the reference's, the coefficients within 1e-5. A floor flat to the bit
    ties every floor hypothesis's count (the first wins), walls fail every
    hypothesis and a band with no point leaves none (found false), and 1 and
    1024 hypotheses, 5000 lanes with masked lanes among them and 140000
    lanes (two stages of the card's finish) run as the default does."""
    name, pts, mask, n_hyp = next(c for c in CS.floor_cases() if c[0] == case)
    jc = JCloud(jnp.asarray(pts), jnp.zeros(len(pts), jnp.float32), jnp.asarray(mask))
    want = jax.jit(jdetect, static_argnames="n_hypotheses")(jc, n_hypotheses=n_hyp)
    got = floor.detect_floor(TCloud(torch.from_numpy(pts), torch.zeros(len(pts)), torch.from_numpy(mask)),
                             n_hypotheses=n_hyp)
    print(f"{case}: found {bool(got.found)}, best {int(got.best)}, inliers {int(got.n_inliers)}, coeffs "
          f"{got.coeffs.numpy()}, JAX {np.asarray(want.coeffs)}")
    assert bool(got.found) == bool(want.found)
    assert int(got.n_inliers) == int(want.n_inliers)
    assert int(got.best) == _reference_best(jc, n_hypotheses=n_hyp)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=0, atol=1e-5)
    expect_found = {"two identical best hypotheses": True, "no valid hypothesis": False, "an empty band": False,
                    "140000 lanes, the finish in two stages": True}
    if case in expect_found:
        assert bool(got.found) == expect_found[case]
    if case == "two identical best hypotheses":  # many hypotheses count every floor point: the first of them wins
        assert int(got.n_inliers) == int((np.abs(pts[:, 2] + 1.73) < 0.1).sum())


def test_empty_cloud_raises():
    """An empty cloud has no triple to draw: the reference's gather fails on
    it, and the port refuses it (on the card as on the CPU) before drawing."""
    with pytest.raises(TypeError):
        jdetect(JCloud(jnp.zeros((0, 3), jnp.float32), jnp.zeros(0, jnp.float32), jnp.zeros(0, bool)))
    with pytest.raises(ValueError, match="empty cloud"):
        floor.detect_floor(TCloud(torch.zeros((0, 3)), torch.zeros(0), torch.zeros(0, dtype=torch.bool)))
