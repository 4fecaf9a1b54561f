"""The port's registration factory (`ops/registrations.py` over ICP, GICP and
the generic NDT) and the ground-constrained NDT against
`lv_slam_tpu.ops.registrations` / `ndt_ground` (CPU): the counterpart of
each case of `tests/test_registrations.py` on its figure-8 pair, and the
pieces that hold kernels 17, 19a, 19b and 20 (their plain twins here).

Tolerances. Each method's transform is held to JAX's within the
reference's own one-ulp spread on this pair (`scripts/reference_spread.py
registrations`, 8 perturbations of every coordinate of both clouds by at
most one ulp, 32 perturbations), rounded up, with a floor: ICP's fixed 40 and GICP's 20
iterations carry the last bits of sums over ~12k lanes, and the NDT methods
the validity flips of near-planar leaves (ROADMAP queue 3). One ICP
iteration and one GICP normal-equation pass at a fixed transform are held
to 1e-5 of their scale; the plane covariances to the reference's one-ulp
envelope per lane (`scripts/reference_spread.py gicp`); the ground filter's
LUT and flags are identical.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core import se3 as jse3  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops import gicp as jgicp, icp as jicp, knn as jknn, ndt_ground as jground  # noqa: E402
from lv_slam_tpu.ops import voxel_map as jvm  # noqa: E402
from lv_slam_tpu.ops.linalg3 import eigh3x3 as jeigh  # noqa: E402
from lv_slam_tpu.ops.registrations import RegistrationParams as JParams  # noqa: E402
from lv_slam_tpu.ops.registrations import select_registration_method as jselect  # noqa: E402
from lv_slam_tpu_torch.core import se3  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import gicp, icp, knn, ndt_ground, nn, voxel_map  # noqa: E402
from lv_slam_tpu_torch.ops.registrations import RegistrationParams, select_registration_method  # noqa: E402

CAP = 16384
# (method, neighbourhood, tests/test_registrations.py's translation bound)
METHODS = [("NDT_OMP", "DIRECT7", 0.06), ("NDT_PCA", "DIRECT1", 0.06), ("ICP", "DIRECT7", 0.25),
           ("GICP", "DIRECT7", 0.10)]
# the reference's one-ulp spread of each method's transform on this pair
# (the largest move of a translation entry (m) and of a rotation entry over
# 32 perturbations), rounded up; floor 1e-4
REF_SPREAD = {"NDT_OMP": (1.5e-2, 1.5e-2), "NDT_PCA": (1.6e-2, 3.1e-3), "ICP": (3.4e-4, 2.1e-5),
              "GICP": (2.5e-3, 1.6e-4), "ground": (5.0e-3, 6.9e-4)}
GROUND_GUESS = np.eye(4, dtype=np.float32)
GROUND_GUESS[2, 3] = 0.5  # tests/test_registrations.py's 0.5 m z error


@pytest.fixture(scope="module")
def reg_pair():
    """tests/test_registrations.py's pair: (target, source) numpy scans, the
    true relative pose, and the perturbed float32 guess."""
    scans, poses, _ = synthetic.make_sequence(2, seed=31, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=450)
    gt = np.linalg.inv(poses[0]) @ poses[1]
    pert = np.asarray(jse3.exp_se3(jnp.array([0.12, -0.08, 0.03, 0.01, -0.01, 0.02])))
    guess = np.asarray(jnp.asarray(pert) @ jnp.asarray(gt.astype(np.float32)))
    return np.asarray(scans[0], np.float32), np.asarray(scans[1], np.float32), gt, guess


def _clouds(reg_pair):
    target, source, _, _ = reg_pair
    return ((JCloud.from_numpy(target, cap=CAP), JCloud.from_numpy(source, cap=CAP)),
            (TCloud.from_numpy(target, cap=CAP, device="cpu"), TCloud.from_numpy(source, cap=CAP, device="cpu")))


@pytest.fixture(scope="module")
def jax_results(reg_pair):
    (jt, js), _ = _clouds(reg_pair)
    guess = jnp.asarray(reg_pair[3])
    out = {}
    for method, search, _ in METHODS:
        reg = jselect(JParams(registration_method=method, max_iterations=40, ndt_nn_search_method=search))
        r = reg(jt, js, guess)
        out[method] = (np.asarray(r.transform), float(r.fitness))
    return out


def _assert_within_spread(got, want, spread):
    dt, dr = spread
    err_t = float(np.abs(got[:3, 3] - want[:3, 3]).max())
    err_r = float(np.abs(got[:3, :3] - want[:3, :3]).max())
    assert err_t <= max(dt, 1e-4) and err_r <= max(dr, 1e-4), (err_t, err_r)


@pytest.mark.parametrize("method,search,tol", METHODS)
def test_factory_methods_recover_pose(reg_pair, jax_results, method, search, tol):
    """tests/test_registrations.py's gates on the port, and the transform
    within the reference's one-ulp spread of JAX's."""
    _, (tt, ts) = _clouds(reg_pair)
    gt = reg_pair[2]
    reg = select_registration_method(
        RegistrationParams(registration_method=method, max_iterations=40, ndt_nn_search_method=search))
    result = reg(tt, ts, torch.from_numpy(reg_pair[3]))
    got = result.transform.numpy()
    assert np.linalg.norm(got[:3, 3] - gt[:3, 3]) < tol
    assert float(result.fitness) < 0.5
    want, want_fit = jax_results[method]
    _assert_within_spread(got, want, REF_SPREAD[method])
    np.testing.assert_allclose(float(result.fitness), want_fit, rtol=0.05)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        select_registration_method(RegistrationParams(registration_method="FOO"))
    for name in ("ICP", "GICP", "GICP_OMP", "NDT", "NDT_OMP", "NDT_PCA", "ndt_omp"):
        assert callable(select_registration_method(RegistrationParams(registration_method=name)))


@pytest.fixture(scope="module")
def ground_maps(reg_pair):
    """The target's 10 m map (JAX's build), as the reference's VoxelMap and
    as the port's (keys recovered from the LUT)."""
    (jt, _), _ = _clouds(reg_pair)
    jmap = jax.jit(lambda c: jvm.build_voxel_map(c, 10.0, leaf_cap=4096, lut_extent=64))(jt)
    lut = np.asarray(jmap.lut)
    keys = np.full(4096, -1, np.int32)
    keys[lut[lut >= 0]] = np.nonzero(lut >= 0)[0]
    tmap = voxel_map.VoxelMap(
        means=torch.from_numpy(np.asarray(jmap.means)), icovs=torch.from_numpy(np.asarray(jmap.icovs)),
        weights=torch.from_numpy(np.asarray(jmap.weights)), normals=torch.from_numpy(np.asarray(jmap.normals)),
        valid=torch.from_numpy(np.asarray(jmap.valid)), keys=torch.from_numpy(keys),
        origin_cell=torch.from_numpy(np.asarray(jmap.origin_cell)), resolution=10.0,
        n_leaves=torch.tensor(int(np.asarray(jmap.valid).sum()), dtype=torch.int32), extent=64,
    )
    return jmap, tmap, torch.from_numpy(lut)


@pytest.mark.parametrize("angle,flip", [(10.0, False), (5.0, False), (30.0, False), (10.0, True)])
def test_filter_ground_leaves(ground_maps, angle, flip):
    """Kernel 20's twin on the same map as JAX: the LUT and the valid flags
    identical (the float32 cosine rounds as the reference's), also with
    every other leaf's normal flipped (a normal's sign is arbitrary)."""
    jmap, tmap, lut = ground_maps
    if flip:
        sign = np.where(np.arange(tmap.leaf_cap) % 2 == 1, -1.0, 1.0).astype(np.float32)[:, None]
        jmap = jmap._replace(normals=jmap.normals * sign)
        tmap = tmap._replace(normals=tmap.normals * torch.from_numpy(sign))
    want = jax.jit(functools.partial(jground.filter_ground_leaves, max_angle_deg=angle))(jmap)
    got_map, got_lut = ndt_ground.filter_ground_leaves(tmap, lut, angle)
    np.testing.assert_array_equal(got_lut.numpy(), np.asarray(want.lut))
    np.testing.assert_array_equal(got_map.valid.numpy(), np.asarray(want.valid))
    assert float(np.float32(ndt_ground._cos_thresh(angle))) == float(
        jax.jit(lambda: jnp.cos(jnp.deg2rad(jnp.float32(angle))))())
    n_ground = int(got_map.valid.sum())
    assert 0 < n_ground < int(tmap.valid.sum()) or angle == 30.0


def test_ndt_ground_dof_mask(reg_pair):
    """tests/test_registrations.py's ground case on the port (only z, roll
    and pitch move), and the transform within the reference's spread of JAX's."""
    (jt, js), (tt, ts) = _clouds(reg_pair)
    vm = voxel_map.build_voxel_map(tt, 10.0, leaf_cap=4096, lut_extent=64)
    res = ndt_ground.ndt_ground_align(vm, voxel_map.build_lut(vm), ts, torch.from_numpy(GROUND_GUESS),
                                      resolution=10.0, max_iterations=16)
    got = res.transform.numpy()
    assert abs(got[0, 3]) < 5e-3 and abs(got[1, 3]) < 5e-3, got[:3, 3]
    assert abs(got[2, 3]) < 0.4, got[2, 3]
    want = np.asarray(jax.jit(lambda t, s: jground.ndt_ground_align(
        jvm.build_voxel_map(t, 10.0, leaf_cap=4096, lut_extent=64), s, jnp.asarray(GROUND_GUESS), resolution=10.0,
        max_iterations=16))(jt, js).transform)
    _assert_within_spread(got, want, REF_SPREAD["ground"])


def test_icp_iteration_matches_jax(reg_pair):
    """One ICP iteration from the guess (kernel 17's twin: the match, the
    sums, the Kabsch update) against JAX's `icp_align` with one iteration,
    to 1e-5 of scale; the fitness and the match count at the guess against
    JAX's with none."""
    (jt, js), (tt, ts) = _clouds(reg_pair)
    guess = reg_pair[3]
    want = np.asarray(jax.jit(lambda t, s, g: jicp.icp_align(t, s, g, max_iterations=1).transform)(
        jt, js, jnp.asarray(guess)))
    grid = nn.build_centroid_grid(tt, 0.25)
    args = (grid, ts.masked_xyz(), ts.mask, torch.from_numpy(guess), 4.0)
    got = icp.icp_step(*args).numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * scale).all(), np.abs(got - want).max()
    j0 = jax.jit(lambda t, s, g: jicp.icp_align(t, s, g, max_iterations=0))(jt, js, jnp.asarray(guess))
    fit, n = icp.icp_fitness(*args)
    assert int(n) == int(j0.n_matches) > 5000
    np.testing.assert_allclose(float(fit), float(j0.fitness), rtol=1e-5)


def _jax_normal_equations(target, source, transform):
    """JAX's H and g of one GICP iteration at `transform`: the lines of
    `lv_slam_tpu/ops/gicp.py:65-91` (the reference computes them inside its
    loop body and does not return them)."""
    tgt_xyz, tgt_mask = target.masked_xyz(), target.mask
    src_xyz, src_mask = source.masked_xyz(), source.mask
    tgt_grid = jknn.build_grid(tgt_xyz, tgt_mask, 1.0)
    cov_src, src_ok = jgicp._plane_covariances(src_xyz, src_mask, jknn.build_grid(src_xyz, src_mask, 1.0), 8)
    y = jse3.transform_points(transform, src_xyz)
    dists, pts, valid = jknn.knn(tgt_grid, y, k=1)
    nn_ = pts[:, 0]
    ok = src_mask & src_ok & valid[:, 0] & (dists[:, 0] < 2.0)
    _, nn_nbrs, nn_valid = jknn.knn(tgt_grid, nn_, k=8)
    wn = nn_valid.astype(jnp.float32)
    cntn = jnp.maximum(jnp.sum(wn, 1), 1.0)
    mun = jnp.sum(nn_nbrs * wn[..., None], 1) / cntn[:, None]
    cn = (nn_nbrs - mun[:, None, :]) * wn[..., None]
    covn = jnp.einsum("nki,nkj->nij", cn, cn) / cntn[:, None, None]
    _, evecs = jeigh(covn + 1e-9 * jnp.eye(3))
    cov_b = jnp.einsum("nij,j,nkj->nik", evecs, jnp.array([1e-3, 1.0, 1.0], jnp.float32), evecs)
    rot = transform[:3, :3]
    m = cov_b + jnp.einsum("ij,njk,lk->nil", rot, cov_src, rot)
    w3 = jnp.where(ok[:, None, None], jnp.linalg.inv(m + 1e-6 * jnp.eye(3)), 0.0)

    def res(delta):
        return jse3.transform_points(jse3.exp_se3(delta) @ transform, src_xyz) - nn_

    zero = jnp.zeros(6, jnp.float32)
    jac = jax.jacfwd(res)(zero)
    inputs = (src_xyz, src_mask & src_ok, cov_src, transform, nn_, dists[:, 0], valid[:, 0], cov_b)
    return (jnp.einsum("nia,nij,njb->ab", jac, w3, jac), jnp.einsum("nia,nij,nj->a", jac, w3, res(zero))), inputs


def test_gicp_normal_equations_match_jax(reg_pair):
    """One normal-equation pass at the guess (kernel 19b's twin) against the
    reference's body, fed the reference's own matches and covariances: H
    and g to 1e-5 of their scale. (Fed the port's covariances, the lanes
    whose normal is rounding noise in both packages move H by ~1 %: kernel
    19a's parity is `test_plane_covariances_match_jax`'s.)"""
    (jt, js), _ = _clouds(reg_pair)
    (want_h, want_g), inputs = jax.jit(_jax_normal_equations)(jt, js, jnp.asarray(reg_pair[3]))
    h, g = gicp.gicp_normal_equations(*(torch.from_numpy(np.array(x)) for x in inputs), 2.0)
    want_h, want_g = np.asarray(want_h), np.asarray(want_g)
    assert int(np.asarray(inputs[1]).sum()) > 10000
    np.testing.assert_allclose(h.numpy(), want_h, rtol=0, atol=1e-5 * np.abs(want_h).max())
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())


def test_plane_covariances_match_jax(reg_pair):
    """Kernel 19a's twin on the source's 8 grid neighbours against the
    reference's `_plane_covariances`: ok identical; on lanes whose relative
    eigen-gap g = (lambda1 - lambda0) / lambda2 exceeds sqrt(eps), within
    gicp.PLANE_ENVELOPE / g (the reference's own one-ulp envelope: its
    float32 Cardano eigenvector moves as 1 / g); on the others, whose normal
    is rounding noise in both packages (a repeated low pair, ROADMAP queue
    3), the plane shape (1e-3, 1, 1); the not-ok lanes the identity."""
    (_, js), (_, ts) = _clouds(reg_pair)
    want, want_ok = (np.asarray(x) for x in jax.jit(lambda x, m: jgicp._plane_covariances(
        x, m, jknn.build_grid(x, m, 1.0), 8))(js.masked_xyz(), js.mask))
    src, mask = ts.masked_xyz(), ts.mask
    grid = knn.build_grid(src, mask, 1.0)
    got, ok = gicp._plane_covariances(src, mask, grid, 8)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    _, pts, valid = knn.knn(grid, src, 8)
    e = gicp.plane_covariance_error(got, torch.from_numpy(want), pts, valid, ok)
    assert e.ok and e.n_gap > 10000, e
    np.testing.assert_array_equal(got.numpy()[~want_ok], np.broadcast_to(np.eye(3, dtype=np.float32),
                                                                          ((~want_ok).sum(), 3, 3)))


def _jax_target_covariances(nn_nbrs, nn_valid):
    """The reference's target covariances from the matches' neighbourhoods:
    the lines of `lv_slam_tpu/ops/gicp.py:71-83`, which it computes inside its
    loop body on every lane."""
    wn = nn_valid.astype(jnp.float32)
    cntn = jnp.maximum(jnp.sum(wn, 1), 1.0)
    mun = jnp.sum(nn_nbrs * wn[..., None], 1) / cntn[:, None]
    cn = (nn_nbrs - mun[:, None, :]) * wn[..., None]
    covn = jnp.einsum("nki,nkj->nij", cn, cn) / cntn[:, None, None]
    _, evecs = jeigh(covn + 1e-9 * jnp.eye(3))
    return jnp.einsum("nij,j,nkj->nik", evecs, jnp.array([1e-3, 1.0, 1.0], jnp.float32), evecs)


@pytest.mark.parametrize("max_dist", [2.0, 0.3])
def test_target_covariances_on_the_needed_lanes(reg_pair, max_dist):
    """Kernel 19a's lane-test call (`need`, as `gicp_align` makes it for the
    target's covariances at the matches of the moved source) against the
    reference's target formulas on the same neighbourhoods: on the lanes
    that pass K19b's test, within the reference's one-ulp envelope as
    `test_plane_covariances_match_jax` holds them; the identity elsewhere."""
    _, (tt, ts) = _clouds(reg_pair)
    src, mask = ts.masked_xyz(), ts.mask
    _, src_ok = gicp._plane_covariances(src, mask, knn.build_grid(src, mask, 1.0), 8)
    tgt_grid = knn.build_grid(tt.masked_xyz(), tt.mask, 1.0)
    y = se3.transform_points_fma(torch.from_numpy(reg_pair[3]), src)
    dists, pts, valid = knn.knn(tgt_grid, y, 1)
    _, nbrs, nbr_valid = knn.knn(tgt_grid, pts[:, 0].contiguous(), 8)
    need = gicp.LaneTest(mask & src_ok, valid[:, 0], dists[:, 0], max_dist)
    got, ok = gicp.regularized_covariances(nbrs, nbr_valid, need=need)
    assert ok is None
    want = torch.from_numpy(np.asarray(jax.jit(_jax_target_covariances)(jnp.asarray(nbrs.numpy()),
                                                                          jnp.asarray(nbr_valid.numpy()))))
    lanes = need.lanes()
    assert 1000 < int(lanes.sum()) < int((mask & src_ok).sum())
    e = gicp.plane_covariance_error(got, want, nbrs, nbr_valid, lanes)
    assert e.ok and e.n_gap > 1000, e
    np.testing.assert_array_equal(got[~lanes].numpy(), np.broadcast_to(np.eye(3, dtype=np.float32),
                                                                       (int((~lanes).sum()), 3, 3)))
    # the needed lanes are the unmasked call's, bit for bit
    every, _ = gicp.regularized_covariances(nbrs, nbr_valid)
    np.testing.assert_array_equal(got[lanes].numpy(), every[lanes].numpy())
    with pytest.raises(ValueError):
        gicp.regularized_covariances(nbrs, nbr_valid, mask, need)
