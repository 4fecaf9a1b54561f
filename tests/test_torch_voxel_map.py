"""The port's eigh3x3, voxel-map build (kernel 2's plain twin) and hash
re-index (kernel 3's plain twin) against lv_slam_tpu.ops (CPU)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops.linalg3 import eigh3x3 as j_eigh  # noqa: E402
from lv_slam_tpu.ops.ndt_hash import to_hash as j_to_hash  # noqa: E402
from lv_slam_tpu.ops.voxel_map import build_voxel_map as j_build  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops.linalg3 import eigh3x3 as t_eigh  # noqa: E402
from lv_slam_tpu_torch.ops.ndt_hash import to_hash as t_to_hash  # noqa: E402
from lv_slam_tpu_torch.ops.voxel_map import VoxelMap, leaf_eigen_ratio  # noqa: E402
from lv_slam_tpu_torch.ops.voxel_map import build_voxel_map as t_build  # noqa: E402

LEAF_CAP = 16384
# Leaves whose validity may differ between the reference's float32 eigh and
# the port's: float64 lambda0 / lambda2 below NOISY_RATIO (the differing
# leaves measured up to 7.5e-6 here and 3.0e-6 at the odometry's full scan
# size), and at most MAX_FLIP_SHARE of the valid leaves (measured 9.3 % here,
# 8.7-9.6 % at full size). A wrong pos_def test flips far more.
NOISY_RATIO = 1e-5
MAX_FLIP_SHARE = 0.12


def _spectra_and_frames(kind: str):
    rng = np.random.default_rng({"spd": 11, "isotropic": 12, "repeated": 13}[kind])
    q, _ = np.linalg.qr(rng.normal(size=(256, 3, 3)))
    if kind == "spd":
        lam = rng.uniform(1e-3, 2.0, (256, 3))
    elif kind == "isotropic":
        lam = np.repeat(rng.uniform(1e-3, 2.0, (256, 1)), 3, axis=1)
    else:  # a repeated pair, as planar and linear voxels give
        lam = rng.uniform(1e-3, 2.0, (256, 3))
        lam[:128, 1] = lam[:128, 0]
        lam[128:, 2] = lam[128:, 1]
    return lam, q


def _spectra(kind: str) -> np.ndarray:
    return _spectra_and_frames(kind)[0]


def _matrices(kind: str) -> np.ndarray:
    lam, q = _spectra_and_frames(kind)
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


# A float32 Cardano eigenvalue of an exactly repeated pair is sqrt(eps)-
# conditioned: the JAX and port pair values differ by up to 1.55e-4 * lambda_max
# over seeds 13-44 on one CPU and by 0 on another (the host's XLA codegen
# moves it; `scripts/reference_spread.py eigh`), so each paired eigenvalue is
# held to 2 sqrt(eps_f32) lambda_max = 6.9e-4 lambda_max.
PAIR_TOL = 2.0 * float(np.sqrt(np.finfo(np.float32).eps))


@pytest.mark.parametrize("kind", ["spd", "isotropic", "repeated"])
def test_eigh3x3(kind):
    """Eigenvalues to rtol 1e-5 (atol 1e-6 * lambda_max); V diag(lambda) V^T
    reconstructs A to 1e-5 * |A| beyond the reference's own reconstruction
    error. That error is large for an exactly repeated pair in float32: the
    double-cross-product column of the pair is rounding noise, and the port
    reproduces the reference's noise (ROADMAP, faults in the reference).

    For a repeated pair the pair's mean and the isolated eigenvalue keep the
    1e-5 tolerance and each paired eigenvalue is held to PAIR_TOL; the
    isolated eigenvector agrees to |v_port . v_jax| >= 1 - 1e-4 where the
    reference forms it from its own product (the pair above it, column 0).
    Under a low pair the reference re-orthogonalizes column 2 against the
    noise column 0, so neither package's column 2 is an eigenvector there."""
    a = _matrices(kind)
    ev_j, vec_j = (np.asarray(x) for x in j_eigh(jnp.asarray(a)))
    ev_t, vec_t = (x.numpy() for x in t_eigh(torch.from_numpy(a)))
    lam_max = np.abs(ev_j).max(axis=1, keepdims=True)
    tol = 1e-5 * np.abs(ev_j) + 1e-6 * lam_max
    if kind == "repeated":
        lam = np.sort(_spectra(kind), axis=1)
        low = np.isclose(lam[:, 0], lam[:, 1])  # the pair is (0, 1), else (1, 2)
        n = np.arange(a.shape[0])
        pair = np.where(low[:, None], [0, 1], [1, 2])
        iso = np.where(low, 2, 0)
        mean_j, mean_t = ev_j[n[:, None], pair].mean(1), ev_t[n[:, None], pair].mean(1)
        assert (np.abs(mean_t - mean_j) <= tol[n, pair[:, 0]]).all()
        assert (np.abs(ev_t[n, iso] - ev_j[n, iso]) <= tol[n, iso]).all()
        assert (np.abs(ev_t[n[:, None], pair] - ev_j[n[:, None], pair]) <= PAIR_TOL * lam_max).all()
        dots = np.abs(np.einsum("ni,ni->n", vec_t[~low, :, 0], vec_j[~low, :, 0]))
        assert (~low).sum() > 100 and (dots >= 1 - 1e-4).all()
    else:
        low = np.zeros(a.shape[0], bool)
        assert (np.abs(ev_t - ev_j) <= tol).all()

    def recon_err(ev, vec):
        return np.abs(np.einsum("nij,nj,nkj->nik", vec, ev, vec) - a).max(axis=(1, 2))

    # Under a low pair both packages' reconstructions are rounding noise (up
    # to 0.9 |A| here) that the pair's eigenvalue spread reshuffles; there the
    # port's frame is held to be orthonormal. Elsewhere the reconstruction
    # may exceed the reference's by what the paired eigenvalues may differ.
    norm = np.linalg.norm(a, axis=(1, 2))
    slack = 1e-5 * norm + (PAIR_TOL * lam_max[:, 0] if kind == "repeated" else 0.0)
    assert (recon_err(ev_t, vec_t) <= recon_err(ev_j, vec_j) + slack)[~low].all()
    gram = np.einsum("nki,nkj->nij", vec_t[low], vec_t[low])
    assert np.abs(gram - np.eye(3)).max(initial=0.0) <= 1e-5


@pytest.fixture(scope="module")
def target_scan():
    scans, _, _ = synthetic.make_sequence(
        2, seed=41, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=450
    )
    return scans[0]


def _jax_map(points, weighted):
    cloud = JCloud.from_numpy(points, cap=16384)
    build = functools.partial(
        j_build, resolution=1.0, leaf_cap=LEAF_CAP, lut_extent=256, weighted=weighted
    )
    return jax.jit(build)(cloud)


@pytest.mark.parametrize("weighted", [True, False])
def test_build_voxel_map(target_scan, weighted):
    """`valid` is identical except on a few leaves whose validity is
    rounding noise (NOISY_RATIO, MAX_FLIP_SHARE); means to 1e-5, icovs and
    weights to 1e-4 of the max entry on the leaves valid in both."""
    want = _jax_map(target_scan, weighted)
    cloud = TCloud.from_numpy(target_scan, cap=16384, device="cpu")
    got = t_build(cloud, 1.0, leaf_cap=LEAF_CAP, lut_extent=256, weighted=weighted)
    vj, vt = np.asarray(want.valid), got.valid.numpy()
    assert vj.sum() > 100
    np.testing.assert_array_equal(got.origin_cell.numpy(), np.asarray(want.origin_cell))
    means_j, means_t = np.asarray(want.means), got.means.numpy()
    differ = vj != vt
    ratio = leaf_eigen_ratio(cloud, 1.0, LEAF_CAP, 256).numpy()
    print(f"validity differs on {differ.sum()} of {vj.sum()} valid leaves, "
          f"float64 lambda0/lambda2 there <= {ratio[differ].max(initial=0.0):.3g}")
    assert (ratio[differ] < NOISY_RATIO).all(), np.sort(ratio[differ])[-5:]
    assert differ.sum() <= MAX_FLIP_SHARE * vj.sum()
    both = vj & vt
    np.testing.assert_allclose(means_t[both], means_j[both], atol=1e-5, rtol=0)
    icov = np.asarray(want.icovs)[both]
    np.testing.assert_allclose(
        got.icovs.numpy()[both], icov, rtol=0, atol=1e-4 * np.abs(icov).max()
    )
    w = np.asarray(want.weights)[both]
    np.testing.assert_allclose(got.weights.numpy()[both], w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_to_hash_bit_exact(target_scan):
    """Fed the same VoxelMap arrays, the port's table is bit-identical."""
    vm = _jax_map(target_scan, weighted=True)
    want = jax.jit(j_to_hash)(vm)
    tvm = VoxelMap(
        means=torch.from_numpy(np.array(vm.means)),
        icovs=torch.from_numpy(np.array(vm.icovs)),
        weights=torch.from_numpy(np.array(vm.weights)),
        normals=torch.from_numpy(np.array(vm.normals)),
        valid=torch.from_numpy(np.array(vm.valid)),
        origin_cell=torch.from_numpy(np.array(vm.origin_cell)),
        resolution=float(vm.resolution),
        n_leaves=torch.tensor(int(vm.n_leaves)),
        extent=256,
    )
    got = t_to_hash(tvm)
    np.testing.assert_array_equal(
        got.table.numpy().view(np.int32), np.asarray(want.table).view(np.int32)
    )
    assert int(got.n_dropped) == int(want.n_dropped)
    assert got.extent == int(want.extent)
