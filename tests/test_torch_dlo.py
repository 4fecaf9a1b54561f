"""The port's host DLO frontend (`odometry/dlo.py`: the prefilter chain,
the LUT map build with kernel K3L's plain twin, the LUT align over K6L's
and the retry scored by K6G's) against lv_slam_tpu.odometry.dlo on the
conftest `small_sequence` (CPU).

Tolerances are the reference's own one-ulp spread
(`scripts/reference_spread.py dlo`, 8 perturbations of every raw
coordinate by at most one ulp): each pose within the larger of TRANS_ATOL
and the spread measured for its scan, rotation entries within the larger
of ROT_ATOL and the spread; keyframe indices equal. The map builds differ
in the validity of a few near-planar leaves (rounding noise, see
test_torch_voxel_map), and the Newton loop's iteration count near
convergence is rounding noise too (on the same map, JAX 17 and the port 12
iterations on scan 1, 2.8e-5 apart).

Whether the retry is kept is rounding noise as well: it compares two scores
of nearly the same pose, and with a 1 mm threshold the one-ulp runs of the
reference kept it on 0 to 5 of the 5 scans ([2, 3, 4, 5] unperturbed; [],
[3, 4, 5], [1, 3], [1, 3, 4, 5], [1, 4, 5], [1, 2, 3, 4, 5] perturbed). So
the whole run logs the retried scans beside JAX's, and
`test_retry_arbitration_matches_jax` checks the arbitration itself (K6G's
score against K6L's) on the same map and inputs as JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

from lv_slam_tpu.config import NDTConfig, OdometryConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu.odometry.dlo import DirectLidarOdometry as JDlo  # noqa: E402
from lv_slam_tpu_torch import config as tc  # noqa: E402
from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry, run_sequence  # noqa: E402

CAP = 32768
TRANS_ATOL = 2e-3  # m
ROT_ATOL = 1e-3
# the reference's own spread, rounded up (see the module docstring): per
# scan the largest translation move (m), and the largest rotation-entry move
REF_SPREAD = {
    "default": np.array([0.0, 8.7e-3, 2.8e-3, 5.3e-3, 4.1e-3, 3.1e-3]),
    "prefilter": np.array([0.0, 4.7e-3, 4.1e-3, 5.7e-3, 5.5e-3, 1.1e-3]),
    "retry": np.array([0.0, 7.3e-3, 3.8e-3, 2.9e-3, 2.8e-3, 4.7e-3]),
}
REF_ROT_SPREAD = {"default": 1.3e-3, "prefilter": 5.4e-4, "retry": 4.6e-4}


def reference_configs():
    """The reference's configurations of these tests: `tests/test_dlo.py`'s
    NDTConfig, without a prefilter, with the prefilter chain (and a
    scan-matching cap below the cloud's, so the uniform subsample runs), and
    with a 1 mm retry threshold, so that the retry fires on most scans."""
    ndt = NDTConfig(leaf_cap=16384, lut_extent=256)
    return {
        "default": (OdometryConfig(ndt=ndt), None),
        "prefilter": (OdometryConfig(ndt=ndt, scan_matching_cap=8192), PrefilterConfig(raw_cap=CAP, out_cap=CAP)),
        "retry": (OdometryConfig(ndt=dataclasses.replace(ndt, retry_deviation_thresh=0.001)), None),
    }


def _port(cfg: OdometryConfig, pf):
    odo = tc.OdometryConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "ndt"},
        ndt=tc.NDTConfig(**dataclasses.asdict(cfg.ndt)),
    )
    return odo, (None if pf is None else tc.PrefilterConfig(**dataclasses.asdict(pf)))


def _track(odo, scans):
    """(poses, keyframe indices, scans whose retry was kept, stats)."""
    poses, retried = [], []
    for i, s in enumerate(scans):
        before = odo.stats.retries
        poses.append(odo.process_numpy(s, 0.1 * i, cap=CAP))
        if odo.stats.retries > before:
            retried.append(i)
    return np.stack(poses), list(odo.keyframe_indices), retried, odo.stats


@pytest.fixture(scope="module", params=list(reference_configs()))
def runs(request, small_sequence):
    scans = small_sequence[0]
    cfg, pf = reference_configs()[request.param]
    want = _track(JDlo(cfg, pf), scans)
    got = _track(DirectLidarOdometry(*_port(cfg, pf), device="cpu"), scans)
    return request.param, got, want


def test_dlo_matches_jax(runs):
    """Poses within the reference's spread and keyframes equal; the scans
    whose retry was kept are logged beside JAX's (see the module docstring)."""
    variant, (poses, kf, retried, stats), (j_poses, j_kf, j_retried, j_stats) = runs
    err_t = np.abs(poses[:, :3, 3] - j_poses[:, :3, 3]).max(axis=1)
    err_r = float(np.abs(poses[:, :3, :3] - j_poses[:, :3, :3]).max())
    tol, tol_r = np.maximum(TRANS_ATOL, REF_SPREAD[variant]), max(ROT_ATOL, REF_ROT_SPREAD[variant])
    print(f"{variant}: translation error {np.array2string(err_t, precision=6)} m (tolerance {tol}), rotation "
          f"{err_r:.3g} (tolerance {tol_r}); keyframes {kf} (JAX {j_kf}); retries kept at {retried} (JAX "
          f"{j_retried}); Newton iterations {stats.total_iterations} (JAX {j_stats.total_iterations})")
    assert (err_t <= tol).all() and err_r <= tol_r
    assert kf == j_kf
    assert stats.scan_count == j_stats.scan_count and stats.keyframe_count == j_stats.keyframe_count
    if variant == "retry":
        assert stats.retries > 0 and j_stats.retries > 0  # the retry and its arbiter really ran
    else:
        assert retried == j_retried == []


def _relative_errors(gt, est):
    rel_gt = np.linalg.inv(gt[:-1]) @ gt[1:]
    rel_est = np.linalg.inv(est[:-1]) @ est[1:]
    return np.linalg.norm((np.linalg.inv(rel_est) @ rel_gt)[:, :3, 3], axis=1)


def test_dlo_tracks_synthetic_sequence(small_sequence):
    """`tests/test_dlo.py::test_dlo_tracks_synthetic_sequence`'s gates on
    the port's `run_sequence`."""
    scans, gt_poses, _ = small_sequence
    est, stats = run_sequence(scans, cfg=_port(*reference_configs()["default"])[0], cap=CAP, device="cpu")
    assert stats.scan_count == len(scans)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_poses[0]), gt_poses)
    assert _relative_errors(gt_rel, est).max() < 0.12
    assert np.linalg.norm(est[-1][:3, 3] - gt_rel[-1][:3, 3]) < 0.25


def test_dlo_keyframe_switching(small_sequence):
    """A keyframe every ~2 m of travel (`tests/test_dlo.py:37`): the same
    keyframes as JAX's, and a trajectory smooth across the switches."""
    scans = small_sequence[0]
    cfg = OdometryConfig(keyframe_delta_trans=2.0, keyframe_delta_time=1e9,
                         ndt=NDTConfig(leaf_cap=16384, lut_extent=256))
    poses, kf, _, stats = _track(DirectLidarOdometry(*_port(cfg, None), device="cpu"), scans)
    _, j_kf, _, _ = _track(JDlo(cfg), scans)
    assert stats.keyframe_count >= 2 and kf == j_kf
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    assert np.all(steps < 1.6) and np.all(steps > 0.4), steps


def test_dlo_with_prefilter(small_sequence):
    """`tests/test_dlo.py:48`: the prefilter chain on the first three scans."""
    scans, gt_poses, _ = small_sequence
    cfg, pf = _port(OdometryConfig(ndt=NDTConfig(leaf_cap=16384, lut_extent=256)),
                    PrefilterConfig(raw_cap=CAP, out_cap=CAP))
    est, _ = run_sequence(scans[:3], cfg=cfg, prefilter_cfg=pf, cap=CAP, device="cpu")
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_poses[0]), gt_poses[:3])
    assert _relative_errors(gt_rel, est).max() < 0.12


@pytest.mark.parametrize("offset", [0.5, 0.8])
def test_retry_arbitration_matches_jax(small_sequence, offset):
    """The retry's pieces on the same keyframe map (the reference's, carried
    across) and the same inputs as JAX, scans 1-5 against scan 0 from a
    guess `offset` m and 0.03 rad off the true pose, where the DIRECT1 align
    may fall into another basin: the DIRECT1 align and the DIRECT7 retry
    land where JAX's do (within half the transformation epsilon, the loop's
    stop criterion), the packed pass's align score matches JAX's (rtol
    1e-4), the generic pass (K6G's twin) scores a transform as JAX's
    `ndt_score_fn` does (rtol 1e-5), and the kept / discarded decision
    `s_retry > score` is JAX's wherever the two scores are not a near tie
    (closer than 1e-4 of the score). Measured: transforms within 1.5e-3,
    scores within 5e-6, the arbiter within 1.5e-7; the retry is kept on two
    scans of each case and discarded on three."""
    import jax.numpy as jnp

    from lv_slam_tpu.core.cloud import PointCloud as JCloud
    from lv_slam_tpu.utils.jit_cache import build_map_fn, ndt_align_fn, ndt_score_fn
    from lv_slam_tpu_torch.convert import voxel_map_from_numpy
    from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud
    from lv_slam_tpu_torch.ops.ndt import make_gauss_params, ndt_derivatives
    from lv_slam_tpu_torch.ops.ndt_soa import ndt_align_soa
    from lv_slam_tpu_torch.ops.voxel_map import neighborhood_offsets

    scans, gt, _ = small_sequence
    ndt = NDTConfig(leaf_cap=16384, lut_extent=256)
    vm = build_map_fn(ndt.resolution, ndt.leaf_cap, ndt.lut_extent, ndt.min_points_per_voxel,
                      ndt.min_covar_eigvalue_mult, ndt.weighted)(JCloud.from_numpy(scans[0], cap=CAP))
    key = voxel_map_from_numpy({k: np.asarray(v) for k, v in vm._asdict().items()}, "cpu")
    common = (ndt.resolution, ndt.outlier_ratio, ndt.step_size, ndt.transformation_epsilon, ndt.max_iterations)
    j_align, j_retry = (ndt_align_fn(*common, hood, ndt.weighted) for hood in (ndt.neighborhood, ndt.retry_neighborhood))
    j_score = ndt_score_fn(ndt.resolution, ndt.neighborhood, ndt.weighted)
    kw = dict(resolution=ndt.resolution, outlier_ratio=ndt.outlier_ratio, step_size=ndt.step_size,
              transformation_epsilon=ndt.transformation_epsilon, max_iterations=ndt.max_iterations,
              weighted=ndt.weighted)
    off = np.eye(4)
    off[:2, :2] = [[np.cos(0.03), -np.sin(0.03)], [np.sin(0.03), np.cos(0.03)]]
    off[0, 3] = offset
    decisions = []
    for i in range(1, 6):
        guess = (np.linalg.inv(gt[0]) @ gt[i] @ off).astype(np.float32)
        jsrc, tsrc = JCloud.from_numpy(scans[i], cap=CAP), TCloud.from_numpy(scans[i], cap=CAP, device="cpu")
        r, rr = j_align(vm, jsrc, jnp.asarray(guess)), j_retry(vm, jsrc, jnp.asarray(guess))
        s = float(j_score(vm, jsrc, rr.transform))
        tr = ndt_align_soa(key.vmap, key.lut, tsrc, torch.from_numpy(guess), neighborhood=ndt.neighborhood, **kw)
        trr = ndt_align_soa(key.vmap, key.lut, tsrc, torch.from_numpy(guess), neighborhood=ndt.retry_neighborhood,
                            **kw)

        def score_at(transform):
            return float(ndt_derivatives(key.vmap, key.lut, tsrc.masked_xyz(), tsrc.mask, transform,
                                         make_gauss_params(ndt.resolution),
                                         neighborhood_offsets(ndt.neighborhood, "cpu"), ndt.weighted)[0])

        ts = score_at(trr.transform)
        margin = abs(s - float(r.score)) / abs(float(r.score))
        print(f"scan {i}: JAX score {float(r.score):.3f} retry {s:.3f} (keep {s > float(r.score)}); port "
              f"{float(tr.score):.3f} retry {ts:.3f} (keep {ts > float(tr.score)}); margin {margin:.2e}; "
              f"align diff {np.abs(tr.transform.numpy() - np.asarray(r.transform)).max():.2e} retry diff "
              f"{np.abs(trr.transform.numpy() - np.asarray(rr.transform)).max():.2e} score diff "
              f"{abs(float(tr.score) - float(r.score)) / abs(float(r.score)):.2e} arbiter diff "
              f"{abs(score_at(torch.from_numpy(np.array(rr.transform))) - s) / abs(s):.2e}")
        half_eps = 0.5 * ndt.transformation_epsilon
        np.testing.assert_allclose(tr.transform.numpy(), np.asarray(r.transform), rtol=0, atol=half_eps)
        np.testing.assert_allclose(trr.transform.numpy(), np.asarray(rr.transform), rtol=0, atol=half_eps)
        np.testing.assert_allclose(float(tr.score), float(r.score), rtol=1e-4)
        np.testing.assert_allclose(score_at(torch.from_numpy(np.array(rr.transform))), s, rtol=1e-5)
        if margin > 1e-4:
            assert (ts > float(tr.score)) == (s > float(r.score)), i
            decisions.append(s > float(r.score))
    assert True in decisions and False in decisions
