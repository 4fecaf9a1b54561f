"""The port's fleet (`lv_slam_tpu_torch.parallel.fleet`) against its own
single-sequence runs and against lv_slam_tpu.parallel.fleet (CPU).

tests/test_fleet.py's configuration: `_CFG` (a 4096-leaf map, the 64-cell
LUT, no coarse phase, no retry), clouds at cap 8192, four figure-8
sequences of 4 scans at 32 x 225 rays, seeds 50 + s. A lane runs the port's
`run_sequence_fused` (and `run_sequence_lfa` fed its poses) unchanged, so
the fleet without a mesh equals the single runs bit for bit. Against JAX's
fleet on a 4-device CPU mesh the poses are held to the odometry's one-ulp
spread that tests/test_torch_odometry.py holds the fused odometry to
(max(TRANS_ATOL, REF_SPREAD) per scan, ROT_ATOL), not the reference test's
5e-3.

That configuration aligns nothing: every lane's NDT stops at its guess (one
iteration, the first step rejected) in both packages. So the fleet is also
held to JAX's with the fused LFA on a sequence where NDT iterates (5 to 13
iterations a scan): two lanes of the conftest `small_sequence` (6 scans at
32 x 450 rays, cap 32768) at tests/test_torch_odometry.py's odometry and
prefilter configuration and tests/test_torch_lfa_fused.py's LFA, against
JAX's fleet on a 2-device mesh. The refined poses are held to the
odometry's one-ulp spread measured on that sequence (max(TRANS_ATOL,
REF_SPREAD) per scan, ROT_ATOL): the refinement is fed odometry poses that
the reference itself moves by that much.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import LfaConfig as JLfaConfig, NDTConfig as JNDTConfig  # noqa: E402
from lv_slam_tpu.config import OdometryConfig as JOdometryConfig, PrefilterConfig as JPrefilterConfig  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.parallel import fleet as jfleet, mesh as jmesh  # noqa: E402
from lv_slam_tpu_torch.config import LfaConfig, NDTConfig, OdometryConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu_torch.lfa.fused import run_sequence_lfa  # noqa: E402
from lv_slam_tpu_torch.odometry.fused import run_sequence_fused  # noqa: E402
from lv_slam_tpu_torch.parallel import fleet  # noqa: E402
from test_torch_lfa_fused import KW as LFA_KW  # noqa: E402
from test_torch_odometry import CAP as SEQ_CAP, REF_SPREAD, ROT_ATOL, TRANS_ATOL  # noqa: E402

CAP, N_SCANS, N_SEQ = 8192, 4, 4
NDT = dict(leaf_cap=4096, lut_extent=64, coarse_subsample=1, retry_deviation_thresh=0.0)  # test_fleet.py's _CFG
CFG = OdometryConfig(ndt=NDTConfig(**NDT))
LFA = LfaConfig(scan_line=32, edge_cap=1024, planar_cap=2048, map_edge_cap=8192, map_planar_cap=16384)


@pytest.fixture(scope="module")
def sequences():
    xyz, mask = [], []
    for s in range(N_SEQ):
        scans, _, _ = synthetic.make_sequence(
            N_SCANS, seed=50 + s, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=225
        )
        clouds = [JCloud.from_numpy(sc, cap=CAP) for sc in scans]
        xyz.append(np.stack([np.asarray(c.xyz) for c in clouds]))
        mask.append(np.stack([np.asarray(c.mask) for c in clouds]))
    stamps = np.tile(np.arange(N_SCANS, dtype=np.float32) * 0.1, (N_SEQ, 1))
    return np.stack(xyz), np.stack(mask), stamps


@pytest.fixture(scope="module")
def port_fleet(sequences):
    x, m, t = (torch.from_numpy(a) for a in sequences)
    return fleet.run_fleet_odometry(None, x, m, t, CFG, device="cpu")


def test_fleet_equals_single_sequences(sequences, port_fleet):
    """Every lane equals `run_sequence_fused` of its sequence, and with LFA
    `run_sequence_lfa` fed those poses, bit for bit."""
    x, m, t = (torch.from_numpy(a) for a in sequences)
    assert port_fleet.shape == (N_SEQ, N_SCANS, 4, 4) and bool(torch.isfinite(port_fleet).all())
    refined = fleet.run_fleet_odometry(None, x, m, t, CFG, lfa_cfg=LFA, device="cpu")
    for s in range(N_SEQ):
        single = run_sequence_fused(x[s], m[s], t[s], CFG, device="cpu")
        assert torch.equal(port_fleet[s], single), s
        if s in (0, 3):
            want = run_sequence_lfa(x[s], m[s], LFA, odom_poses=single, device="cpu")
            assert torch.equal(refined[s], want), s
            assert torch.equal(refined[s, 0], single[0])  # scan 0 keeps its odometry pose
    assert torch.equal(fleet.shard_sequences(None, x), x)


def test_fleet_matches_jax(sequences, port_fleet):
    """JAX's fleet on a 4-device CPU mesh ("batch" 4): the poses within the
    odometry's one-ulp spread."""
    jcfg = JOdometryConfig(ndt=JNDTConfig(**NDT))
    mesh = jmesh.make_mesh(n_batch=4, n_point=1)
    want = np.asarray(jfleet.run_fleet_odometry(mesh, *(jnp.asarray(a) for a in sequences), jcfg))
    got = port_fleet.numpy()
    err_t = np.abs(got[..., :3, 3] - want[..., :3, 3]).max(axis=(0, 2))
    err_r = np.abs(got[..., :3, :3] - want[..., :3, :3]).max(axis=(0, 2, 3))
    tol_t = np.maximum(TRANS_ATOL, REF_SPREAD[:N_SCANS])
    print(f"per scan over the lanes: translation error {err_t} m (tolerance {tol_t}), rotation error {err_r} "
          f"(tolerance {ROT_ATOL})")
    assert (err_t <= tol_t).all() and (err_r <= ROT_ATOL).all()


def test_fleet_with_lfa_matches_jax_where_ndt_iterates(small_sequence):
    """Two lanes of `small_sequence` through the odometry (NDT iterating)
    and the fused LFA: the port's fleet without a mesh against JAX's on a
    2-device mesh ("batch" 2), within the odometry's one-ulp spread; the
    odometry took more than one iteration on every scan after the first."""
    scans, _, _ = small_sequence
    clouds = [JCloud.from_numpy(s, cap=SEQ_CAP) for s in scans]
    seq = [np.stack([np.asarray(getattr(c, f)) for c in clouds]) for f in ("xyz", "mask")]
    n = len(scans)
    xyz, mask = (np.stack([a, a]) for a in seq)
    stamps = np.tile(np.arange(n, dtype=np.float32) * 0.1, (2, 1))
    ndt = dict(leaf_cap=16384, lut_extent=256)  # test_torch_odometry.py's CFG
    cfg, pf = OdometryConfig(ndt=NDTConfig(**ndt)), PrefilterConfig(raw_cap=SEQ_CAP, out_cap=SEQ_CAP)
    _, iterations, _ = run_sequence_fused(*(torch.from_numpy(a) for a in (seq[0], seq[1], stamps[0])), cfg, pf,
                                          with_stats=True, device="cpu")
    assert (iterations[1:] > 1).all(), iterations
    got = fleet.run_fleet_odometry(None, *(torch.from_numpy(a) for a in (xyz, mask, stamps)), cfg, LfaConfig(**LFA_KW),
                                   pf, device="cpu").numpy()
    mesh = jmesh.make_mesh(n_batch=2, n_point=1)
    want = np.asarray(jfleet.run_fleet_odometry(
        mesh, *(jnp.asarray(a) for a in (xyz, mask, stamps)), JOdometryConfig(ndt=JNDTConfig(**ndt)),
        lfa_cfg=JLfaConfig(**LFA_KW), prefilter_cfg=JPrefilterConfig(raw_cap=SEQ_CAP, out_cap=SEQ_CAP)))
    err_t = np.abs(got[..., :3, 3] - want[..., :3, 3]).max(axis=(0, 2))
    err_r = np.abs(got[..., :3, :3] - want[..., :3, :3]).max(axis=(0, 2, 3))
    tol_t = np.maximum(TRANS_ATOL, REF_SPREAD[:n])
    print(f"iterations {iterations.tolist()}; per scan over the lanes: translation error {err_t} m (tolerance "
          f"{tol_t}), rotation error {err_r} (tolerance {ROT_ATOL})")
    assert (err_t <= tol_t).all() and (err_r <= ROT_ATOL).all()
    assert np.array_equal(got[0], got[1])
