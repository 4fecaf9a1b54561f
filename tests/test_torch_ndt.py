"""The port's NDT derivative passes and aligns against lv_slam_tpu.ops on
the same maps (CPU): over the hash table (kernel 4's plain twin,
`ndt_hash`), over the dense LUT with packed rows (K6L's twin, `ndt_soa`)
and by the generic formulas over the LUT (K6G's twin, `ndt`)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops import ndt as jn, ndt_hash as jh, ndt_soa as js  # noqa: E402
from lv_slam_tpu.ops.ndt import make_gauss_params as j_gauss  # noqa: E402
from lv_slam_tpu.ops.voxel_map import VoxelMap as JVoxelMap, build_voxel_map  # noqa: E402
from lv_slam_tpu.ops.voxel_map import neighborhood_offsets as j_offsets  # noqa: E402
from lv_slam_tpu_torch.convert import voxel_map_from_numpy  # noqa: E402
from lv_slam_tpu_torch.core import se3 as tse3  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import ndt as tn, ndt_hash as th, ndt_soa as ts  # noqa: E402
from lv_slam_tpu_torch.ops.ndt import make_gauss_params as t_gauss  # noqa: E402
from lv_slam_tpu_torch.ops.voxel_map import build_lut, build_voxel_map as t_build, lookup_leaves  # noqa: E402
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
    return jmap, tmap, scans[1], np.linalg.inv(poses[0]) @ poses[1], vm


def test_gauss_params():
    np.testing.assert_allclose(t_gauss(1.0), [float(x) for x in j_gauss(1.0)], rtol=1e-6)


@pytest.mark.parametrize("neighborhood,weighted", [("DIRECT1", True), ("DIRECT7", False)])
def test_derivatives(setup, neighborhood, weighted):
    """Score rtol 1e-4; gradient and Hessian atol 2e-5 of their max entry
    (the tolerances of tests/test_ndt_hash.py)."""
    jmap, tmap, src, _, _ = setup
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
    jmap, tmap, src, gt, _ = setup
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


def _lut_pass_args(vm, src, neighborhood):
    """The same LUT map (the reference's, carried across) and source cloud."""
    key = voxel_map_from_numpy({k: np.asarray(v) for k, v in vm._asdict().items()}, "cpu")
    return key, TCloud.from_numpy(src, cap=16384, device="cpu"), t_offsets(neighborhood, "cpu")


@pytest.mark.parametrize("which", ["soa", "generic"])
@pytest.mark.parametrize("neighborhood,weighted", [("DIRECT1", True), ("DIRECT7", False)])
def test_lut_derivatives(setup, which, neighborhood, weighted):
    """`ndt_derivatives_soa` (K6L's twin) and `ndt_derivatives` (K6G's)
    against JAX on the same map, as tests/test_ndt_soa.py:31 sets them up:
    score rtol 1e-4, gradient and Hessian atol 2e-5 of their max entry (K6's
    tolerances; measured 2.4e-7, 9.7e-7 and 2.9e-6)."""
    _, _, src, _, vm = setup
    transform = np.eye(4, dtype=np.float32)
    transform[0, 3], transform[1, 3] = 1.2, -0.1
    jsrc = JCloud.from_numpy(src, cap=16384)
    key, tsrc, offsets = _lut_pass_args(vm, src, neighborhood)
    if which == "soa":
        soa = js.to_soa(vm)
        want = jax.jit(lambda T: js.ndt_derivatives_soa(
            soa, jsrc.masked_xyz().T, jsrc.mask, T, j_gauss(1.0), j_offsets(neighborhood), weighted))(
            jnp.asarray(transform))
        got = ts.ndt_derivatives_soa(ts.to_soa(key.vmap, key.lut), tsrc.masked_xyz().T.contiguous(), tsrc.mask,
                                     torch.from_numpy(transform), t_gauss(1.0), offsets, weighted)
    else:
        want = jax.jit(lambda T: jn.ndt_derivatives(
            vm, jsrc.masked_xyz(), jsrc.mask, T, j_gauss(1.0), j_offsets(neighborhood), weighted))(
            jnp.asarray(transform))
        got = tn.ndt_derivatives(key.vmap, key.lut, tsrc.masked_xyz(), tsrc.mask, torch.from_numpy(transform),
                                 t_gauss(1.0), offsets, weighted)
    (s1, g1, h1), (s2, g2, h2) = [np.asarray(x) for x in want], [x.numpy() for x in got]
    assert float(s1) > 0.0
    np.testing.assert_allclose(float(s2), float(s1), rtol=1e-4)
    np.testing.assert_allclose(g2, g1, rtol=0, atol=2e-5 * np.abs(g1).max())
    np.testing.assert_allclose(h2, h1, rtol=0, atol=2e-5 * np.abs(h1).max())


def _port_map(scan, cap=32768, weighted=False):
    cloud = TCloud.from_numpy(scan, cap=cap, device="cpu")
    vm = t_build(cloud, 1.0, leaf_cap=16384, lut_extent=256, weighted=weighted)
    return cloud, vm, build_lut(vm)


def test_derivatives_match_autodiff(small_sequence):
    """`tests/test_ndt.py::test_derivatives_match_autodiff` on the port: the
    generic pass's gradient equals autodiff (torch.autograd, float64) of the
    frozen-gather score, and its Hessian's symmetric part the autodiff
    Hessian, at the reference test's tolerances."""
    scans, _, _ = small_sequence
    cloud, vm, lut = _port_map(scans[0], cap=16384)
    gauss = t_gauss(1.0)
    offsets = t_offsets("DIRECT7", "cpu")
    t0 = tse3.exp_se3(torch.tensor([0.3, -0.2, 0.05, 0.02, -0.01, 0.04]))
    xyz = cloud.masked_xyz()
    score, grad, hess = tn.ndt_derivatives(vm, lut, xyz, cloud.mask, t0, gauss, offsets, False)

    y0 = tse3.transform_points(t0, xyz).double()
    means, icovs, _, hit = lookup_leaves(vm, lut, y0.float(), offsets)
    hit = hit & cloud.mask[:, None]
    means, icovs = means.double(), icovs.double()

    def frozen_score(delta):
        rot = tse3.exp_so3(delta[3:])
        y = y0 @ rot.T + delta[:3]
        d = y[:, None, :] - means
        q = torch.einsum("nkij,nkj->nki", icovs, d)
        e = torch.exp(-0.5 * gauss.d2 * torch.sum(d * q, dim=-1))
        gate_val = gauss.d2 * e
        w = torch.where(hit & (gate_val <= 1.0) & (gate_val >= 0.0), 1.0, 0.0).double()
        return torch.sum(w * (-gauss.d1 * e))

    zero = torch.zeros(6, dtype=torch.float64, requires_grad=True)
    np.testing.assert_allclose(float(score), float(frozen_score(zero).detach()), rtol=1e-5)
    grad_ad = torch.autograd.grad(frozen_score(zero), zero)[0].numpy()
    hess_ad = torch.autograd.functional.hessian(frozen_score, torch.zeros(6, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(grad.numpy(), grad_ad, rtol=2e-3, atol=2e-2)
    hsym = 0.5 * (hess.numpy() + hess.numpy().T)
    np.testing.assert_allclose(hsym, hess_ad, atol=5e-3 * np.abs(hess_ad).max())


ALIGN = dict(resolution=1.0, transformation_epsilon=0.01, max_iterations=64)


def test_two_frame_recovery(small_sequence):
    """`tests/test_ndt.py::test_two_frame_recovery`: the generic align of
    scan 1 onto scan 0 from the reference's first-scan guess (x = +1.5 m)
    recovers the true relative pose within 0.05 m and 0.02 rad, converged."""
    scans, poses, _ = small_sequence
    _, vm, lut = _port_map(scans[0])
    source = TCloud.from_numpy(scans[1], cap=32768, device="cpu")
    gt_rel = np.linalg.inv(poses[0]) @ poses[1]
    guess = torch.eye(4)
    guess[0, 3] = 1.5
    for neighborhood, weighted in [("DIRECT1", True), ("DIRECT7", False)]:
        res = tn.ndt_align(vm, lut, source, guess, neighborhood=neighborhood, weighted=weighted, **ALIGN)
        got = res.transform.numpy()
        r_err = float(tse3.rotation_angle(torch.from_numpy((np.linalg.inv(gt_rel) @ got)[:3, :3])))
        assert np.linalg.norm(got[:3, 3] - gt_rel[:3, 3]) < 0.05, (neighborhood, got[:3, 3])
        assert r_err < 0.02 and res.converged


def test_identity_alignment(small_sequence):
    """`tests/test_ndt.py::test_identity_alignment`: a scan aligned onto its
    own map from a perturbed guess returns to the identity."""
    scans, _, _ = small_sequence
    cloud, vm, lut = _port_map(scans[0])
    guess = tse3.exp_se3(torch.tensor([0.4, -0.3, 0.1, 0.01, 0.02, -0.03]))
    got = tn.ndt_align(vm, lut, cloud, guess, neighborhood="DIRECT7", weighted=False, **ALIGN).transform
    assert float(torch.linalg.vector_norm(got[:3, 3])) < 0.05
    assert float(tse3.rotation_angle(got[:3, :3])) < 0.02


def test_soa_align_matches_aos_and_jax(setup):
    """`tests/test_ndt_soa.py::test_soa_align_matches_aos`: the packed align
    and the generic align land within 5e-3, the packed one within 0.05 m of
    the truth; both within 1e-3 of JAX's on the same map."""
    _, _, src, gt, vm = setup
    key, tsrc, _ = _lut_pass_args(vm, src, "DIRECT1")
    jsrc = JCloud.from_numpy(src, cap=16384)
    kw = dict(ALIGN, neighborhood="DIRECT1", weighted=True)
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 1.4
    aos = tn.ndt_align(key.vmap, key.lut, tsrc, torch.from_numpy(guess), **kw).transform.numpy()
    soa = ts.ndt_align_soa(key.vmap, key.lut, tsrc, torch.from_numpy(guess), **kw).transform.numpy()
    np.testing.assert_allclose(aos, soa, atol=5e-3)
    assert np.linalg.norm(soa[:3, 3] - gt[:3, 3]) < 0.05
    j_aos = jax.jit(functools.partial(jn.ndt_align, **kw))(vm, jsrc, jnp.asarray(guess)).transform
    j_soa = jax.jit(functools.partial(js.ndt_align_soa, **kw))(vm, jsrc, jnp.asarray(guess)).transform
    np.testing.assert_allclose(aos, np.asarray(j_aos), rtol=0, atol=1e-3)
    np.testing.assert_allclose(soa, np.asarray(j_soa), rtol=0, atol=1e-3)


def test_two_phase_matches_single_phase(setup):
    """`tests/test_ndt_soa.py::test_two_phase_matches_single_phase`, and the
    two-phase align against JAX's (1e-3) on the same map."""
    _, _, src, _, vm = setup
    key, tsrc, _ = _lut_pass_args(vm, src, "DIRECT1")
    kw = dict(ALIGN, neighborhood="DIRECT1", weighted=True)
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 1.4
    t1 = ts.ndt_align_soa(key.vmap, key.lut, tsrc, torch.from_numpy(guess), **kw).transform.numpy()
    r2 = ts.ndt_align_soa(key.vmap, key.lut, tsrc, torch.from_numpy(guess), coarse_subsample=2, **kw)
    assert np.linalg.norm(t1[:3, 3] - r2.transform.numpy()[:3, 3]) < 0.02
    want = jax.jit(functools.partial(js.ndt_align_soa, coarse_subsample=2, **kw))(
        vm, JCloud.from_numpy(src, cap=16384), jnp.asarray(guess))
    np.testing.assert_allclose(r2.transform.numpy(), np.asarray(want.transform), rtol=0, atol=1e-3)


def test_align_dof_mask(setup):
    """`ndt_align(dof_mask=...)` freezes the masked tangent dims as the
    reference does (the ground-constrained NDT's x, y, yaw): z, roll and
    pitch stay at the guess's, and the transform matches JAX's (1e-3)."""
    _, _, src, _, vm = setup
    key, tsrc, _ = _lut_pass_args(vm, src, "DIRECT7")
    dof = (True, True, False, False, False, True)
    kw = dict(ALIGN, neighborhood="DIRECT7", weighted=False, dof_mask=dof)
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 1.4
    got = tn.ndt_align(key.vmap, key.lut, tsrc, torch.from_numpy(guess), **kw)
    want = jax.jit(functools.partial(jn.ndt_align, **kw))(vm, JCloud.from_numpy(src, cap=16384), jnp.asarray(guess))
    t = got.transform.numpy()
    assert got.iterations > 1
    assert abs(t[2, 3]) < 1e-6 and abs(t[2, 2] - 1.0) < 1e-6 and np.abs(t[2, :2]).max() < 1e-6
    np.testing.assert_allclose(t, np.asarray(want.transform), rtol=0, atol=1e-3)


def _chip_smoke():
    """chip_smoke.py as a module (it imports numpy only at the top)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


@pytest.mark.parametrize("name", CS.PROBE_CASE_NAMES)
def test_probe_cases_against_jax(name):
    """chip_smoke's `probe_cases` (the hash pass's edge cases on the card:
    slot-1 keys and keys in neither slot, cells past the extent, masked,
    sentinel and gate-rejected lanes, 1000 lanes, a finished candidate)
    through the port's plain pass and JAX's `ndt_derivatives_hash` on the
    same table, candidate by candidate (the finished one skipped, as the
    kernel skips it): score rtol 1e-4, gradient and Hessian atol 2e-5 of
    their max entry (test_derivatives' tolerances)."""
    case = {c["name"]: c for c in CS.probe_cases()}[name]
    hm, xs, mask, trans, gauss, offsets, weighted, done = CS.probe_case_inputs(torch, case, "cpu")
    jmap = jh.HashVoxelMap(table=jnp.asarray(hm.table.numpy()), origin_cell=jnp.asarray(hm.origin_cell.numpy()),
                           resolution=jnp.float32(hm.resolution), extent=hm.extent,
                           n_dropped=jnp.asarray(hm.n_dropped.numpy()))
    jgauss = j_gauss(hm.resolution) if case["gauss"] is None else type(j_gauss(1.0))(
        *(jnp.float32(v) for v in (*case["gauss"], 0.0)))
    derivs = jax.jit(lambda xs_, mask_, t: jh.ndt_derivatives_hash(
        jmap, xs_, mask_, t, jgauss, j_offsets(case["neighborhood"]), weighted))
    for c in range(xs.shape[0]):
        if bool(done[c]):
            continue
        s1, g1, h1 = derivs(jnp.asarray(case["xs"][c]), jnp.asarray(case["mask"][c]), jnp.asarray(case["transforms"][c]))
        s2, g2, h2 = th.ndt_derivatives_hash_ref(hm, xs[c], mask[c], trans[c], gauss, offsets, weighted)
        assert float(s1) > 0.0  # real hits
        np.testing.assert_allclose(float(s2), float(s1), rtol=1e-4)
        g1, h1 = np.asarray(g1), np.asarray(h1)
        np.testing.assert_allclose(g2.numpy(), g1, rtol=0, atol=2e-5 * np.abs(g1).max())
        np.testing.assert_allclose(h2.numpy(), h1, rtol=0, atol=2e-5 * np.abs(h1).max())


def _negative_denormal(x):
    return (x < 0) & (x > -np.finfo(np.float32).tiny)


def test_lut_face_through_zero_diverges_from_jax():
    """The LUT passes' cells through the face through 0: a point one ulp
    below it is a negative denormal, which XLA's CPU code flushes to 0
    (cell 0; the TPU flushes too), and so does the port's cell rule
    (`ops/cells.py`; the kernels' `lvs::cell_floor`). On `lut_cases`' face
    case, under the identity, the port's cells (`probe_cells`) equal the
    reference's (`floor(points / resolution)`, as `lookup_leaves` takes
    them) on every lane, the negative denormals' too."""
    from lv_slam_tpu_torch.ops.voxel_map import probe_cells

    case = CS.lut_cases()[0]
    assert case["name"] == CS.LUT_CASE_NAMES[0]
    np.testing.assert_array_equal(case["transform"], np.eye(4, dtype=np.float32))
    xyz = np.ascontiguousarray(case["xs"].T)
    _, _, _, _, origin, res, _ = case["leaves"]
    assert _negative_denormal(xyz).sum() > 0
    got = probe_cells(torch.from_numpy(xyz), torch.from_numpy(origin), res).numpy() + origin
    # the resolution an argument, as the map's array is (a constant divisor becomes a reciprocal's product)
    want = np.asarray(jax.jit(lambda p, r: jnp.floor(p / r).astype(jnp.int32))(jnp.asarray(xyz), jnp.float32(res)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["soa", "generic"])
@pytest.mark.parametrize("name", CS.LUT_CASE_NAMES)
def test_lut_cases_against_jax(name, which):
    """chip_smoke's `lut_cases` (the LUT passes' edge cases on the card:
    points within an ulp of a cell face, cells at and past the extent for
    each DIRECT7 offset, an all-masked cloud, 1001 lanes, valid lanes ending
    mid-row, masked, sentinel and gate-rejected lanes, a finished candidate,
    DIRECT26, 131073 lanes) through the port's twins (`ndt_derivatives_soa`,
    K6L's; `ndt_derivatives`, K6G's) and JAX's on the same map and LUT:
    score rtol 1e-4, gradient and Hessian atol 2e-5 of their max entry
    (test_probe_cases_against_jax's tolerances); an all-masked cloud's sums
    are 0 on both sides."""
    case = {c["name"]: c for c in CS.lut_cases()}[name]
    vm, lut, soa, xs, xyz, mask, trans, gauss, offsets, weighted, _ = CS.lut_case_inputs(torch, case, "cpu")
    means, icovs, weights, valid, origin, res, _ = case["leaves"]
    jvm = JVoxelMap(means=jnp.asarray(means), icovs=jnp.asarray(icovs), weights=jnp.asarray(weights),
                    normals=jnp.zeros_like(jnp.asarray(means)), valid=jnp.asarray(valid),
                    lut=jnp.asarray(case["lut"]), origin_cell=jnp.asarray(origin), resolution=jnp.float32(res),
                    n_leaves=jnp.int32(valid.sum()))
    jgauss = j_gauss(res) if case["gauss"] is None else type(j_gauss(1.0))(
        *(jnp.float32(v) for v in (*case["gauss"], 0.0)))
    joff = j_offsets(case["neighborhood"])
    # the map goes into the trace as an argument, as the reference's aligns take it
    if which == "soa":
        jsoa = js.to_soa(jvm)
        want = jax.jit(lambda packed, jlut, org, r, x, m, t: js.ndt_derivatives_soa(
            js.VoxelMapSOA(packed, jlut, org, r, jsoa.extent), x, m, t, jgauss, joff, weighted))(
            jsoa.packed, jsoa.lut, jsoa.origin_cell, jsoa.resolution, jnp.asarray(case["xs"]),
            jnp.asarray(case["mask"]), jnp.asarray(case["transform"]))
        got = ts.ndt_derivatives_soa(soa, xs, mask, trans, gauss, offsets, weighted)
    else:
        want = jax.jit(lambda vm_, x, m, t: jn.ndt_derivatives(vm_, x, m, t, jgauss, joff, weighted))(
            jvm, jnp.asarray(case["xs"].T), jnp.asarray(case["mask"]), jnp.asarray(case["transform"]))
        got = tn.ndt_derivatives(vm, lut, xyz, mask, trans, gauss, offsets, weighted)
    (s1, g1, h1), (s2, g2, h2) = [np.asarray(x) for x in want], [x.numpy() for x in got]
    if case["mask"].any():
        assert float(s1) != 0.0  # real hits
    np.testing.assert_allclose(float(s2), float(s1), rtol=1e-4)
    np.testing.assert_allclose(g2, g1, rtol=0, atol=2e-5 * np.abs(g1).max())
    np.testing.assert_allclose(h2, h1, rtol=0, atol=2e-5 * np.abs(h1).max())
