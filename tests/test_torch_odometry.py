"""The port's fused odometry, the slice as a whole, against
lv_slam_tpu.odometry.fused on the conftest `small_sequence` (CPU)."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import NDTConfig, OdometryConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.odometry.fused import run_sequence_fused as j_run  # noqa: E402
from lv_slam_tpu_torch.convert import fused_state_from_numpy, fused_state_to_numpy  # noqa: E402
from lv_slam_tpu_torch.odometry.fused import run_sequence_fused as t_run  # noqa: E402

CAP = 32768
CFG = OdometryConfig(ndt=NDTConfig(leaf_cap=16384, lut_extent=256))
PF = PrefilterConfig(raw_cap=CAP, out_cap=CAP)
TRANS_ATOL = 2e-3  # m
# The full run's per-scan translation tolerance is TRANS_ATOL or the
# reference's own rounding spread, where that is larger. The reference is
# sensitive at the rounding level: the validity of near-planar leaves hangs
# on float32 noise in lambda0 (see test_torch_voxel_map), so moving every
# input coordinate by one ulp moves its own poses. REF_SPREAD is the largest
# such move over 16 random one-ulp perturbations (seeds 0-15, each
# coordinate up, down or kept), measured on these six scans and rounded up
# from 0, 3.98, 1.78, 2.66, 4.88 and 6.72 mm. The rotation spread stays
# below 6.6e-4, under ROT_ATOL.
REF_SPREAD = np.array([0.0, 4.0e-3, 1.8e-3, 2.7e-3, 4.9e-3, 6.8e-3])
ROT_ATOL = 1e-3
# NDTConfig(table="lut"): the dense LUT and packed rows (kernels K3L, K6L).
# The reference's spread on it over the same 16 perturbations
# (`scripts/reference_spread.py fused_lut`) equals REF_SPREAD to the
# micrometre, rotation 6.5e-4.
CFG_LUT = dataclasses.replace(CFG, ndt=dataclasses.replace(CFG.ndt, table="lut"))


@pytest.fixture(scope="module")
def inputs(small_sequence):
    scans, gt, _ = small_sequence
    clouds = [JCloud.from_numpy(s, cap=CAP) for s in scans]
    xyz = np.stack([np.asarray(c.xyz) for c in clouds])
    mask = np.stack([np.asarray(c.mask) for c in clouds])
    stamps = np.arange(len(scans), dtype=np.float32) * 0.1
    inten = np.full(xyz.shape[:2], 0.5, np.float32)
    return xyz, mask, stamps, inten, gt


@pytest.fixture(scope="module")
def jax_run(inputs):
    xyz, mask, stamps, inten, _ = inputs
    (poses, iters, switches, filt) = j_run(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(stamps), CFG, PF,
        with_stats=True, inten=jnp.asarray(inten), return_filtered=True,
    )
    return np.asarray(poses), np.asarray(switches), tuple(np.asarray(f) for f in filt)


def _assert_poses_close(got, want, tol_t):
    err_t = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    err_r = np.abs(got[:, :3, :3] - want[:, :3, :3]).max(axis=(1, 2))
    print(f"translation error {np.array2string(err_t, precision=6)} m "
          f"(tolerance {tol_t}), rotation error {np.array2string(err_r, precision=6)} (tolerance {ROT_ATOL})")
    assert (err_t <= tol_t).all(), (err_t, tol_t)
    assert (err_r <= ROT_ATOL).all(), (err_r, ROT_ATOL)


def test_run_sequence_fused_matches_jax(inputs, jax_run):
    """Poses within max(TRANS_ATOL, REF_SPREAD) / ROT_ATOL, keyframe switches identical, and the
    `/filtered_points` product equal as in tests/test_fused.py."""
    xyz, mask, stamps, inten, gt = inputs
    want_poses, want_switches, want_filt = jax_run
    (poses, iters, switches, filt) = t_run(
        torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(stamps), CFG, PF,
        with_stats=True, inten=torch.from_numpy(inten), return_filtered=True, device="cpu",
    )
    _assert_poses_close(poses.numpy(), want_poses, np.maximum(TRANS_ATOL, REF_SPREAD))
    np.testing.assert_array_equal(switches.numpy(), want_switches)
    assert iters.dtype == torch.int32 and iters.shape == (xyz.shape[0],)
    fxyz, finten, fmask = filt
    assert fxyz.shape == (xyz.shape[0], 3, CAP)
    np.testing.assert_array_equal(fmask.numpy(), want_filt[2])
    np.testing.assert_allclose(fxyz.numpy(), want_filt[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(finten.numpy(), want_filt[1], rtol=0, atol=1e-5)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.linalg.norm(poses.numpy()[-1, :3, 3] - gt_rel[-1, :3, 3]) < 0.25


def test_state_carried_from_jax(inputs, jax_run):
    """JAX runs the first half and returns its state; the port takes that
    state over and runs the second half, matching JAX's unchunked run
    within TRANS_ATOL / ROT_ATOL (measured: 3.8e-6 m, 2.1e-7)."""
    xyz, mask, stamps, inten, _ = inputs
    want_poses = jax_run[0]
    k = xyz.shape[0] // 2
    _, jstate = j_run(
        jnp.asarray(xyz[:k]), jnp.asarray(mask[:k]), jnp.asarray(stamps[:k]), CFG, PF,
        return_state=True, inten=jnp.asarray(inten[:k]),
    )
    leaves = {f"key_map.{f}": np.asarray(v) for f, v in jstate.key_map._asdict().items()}
    leaves.update({f: np.asarray(v) for f, v in jstate._asdict().items() if f != "key_map"})
    state = fused_state_from_numpy(leaves, "cpu")
    back = fused_state_to_numpy(state)
    for name, value in leaves.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    poses, state2 = t_run(
        torch.from_numpy(xyz[k:]), torch.from_numpy(mask[k:]), torch.from_numpy(stamps[k:]),
        CFG, PF, init_state=state, return_state=True, inten=torch.from_numpy(inten[k:]),
        device="cpu",
    )
    _assert_poses_close(poses.numpy(), want_poses[k:], TRANS_ATOL)
    assert state2.scan_idx == state.scan_idx + xyz.shape[0] - k


def _port_cfg(cfg):
    from lv_slam_tpu_torch import config as tc

    return tc.OdometryConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "ndt"},
        ndt=tc.NDTConfig(**dataclasses.asdict(cfg.ndt)),
    )


def test_run_sequence_fused_lut_matches_jax(inputs):
    """`table="lut"` against JAX's LUT run: poses within
    max(TRANS_ATOL, REF_SPREAD) / ROT_ATOL, keyframe switches identical."""
    xyz, mask, stamps, inten, gt = inputs
    want_poses, _, want_switches = (np.asarray(a) for a in j_run(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(stamps), CFG_LUT, PF, with_stats=True,
        inten=jnp.asarray(inten)))
    poses, _, switches = t_run(
        torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(stamps), _port_cfg(CFG_LUT), PF,
        with_stats=True, inten=torch.from_numpy(inten), device="cpu",
    )
    _assert_poses_close(poses.numpy(), want_poses, np.maximum(TRANS_ATOL, REF_SPREAD))
    np.testing.assert_array_equal(switches.numpy(), want_switches)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.linalg.norm(poses.numpy()[-1, :3, 3] - gt_rel[-1, :3, 3]) < 0.25


def test_lut_state_carried_from_jax(inputs):
    """JAX's LUT-mode state (its VoxelMap with the LUT) crosses into the
    port and back unchanged, and the port continues from it on the second
    half within TRANS_ATOL of JAX's unchunked run."""
    xyz, mask, stamps, inten, _ = inputs
    k = xyz.shape[0] // 2
    want_poses = np.asarray(j_run(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(stamps), CFG_LUT, PF,
                                  inten=jnp.asarray(inten)))
    _, jstate = j_run(
        jnp.asarray(xyz[:k]), jnp.asarray(mask[:k]), jnp.asarray(stamps[:k]), CFG_LUT, PF,
        return_state=True, inten=jnp.asarray(inten[:k]),
    )
    leaves = {f"key_map.{f}": np.asarray(v) for f, v in jstate.key_map._asdict().items()}
    leaves.update({f: np.asarray(v) for f, v in jstate._asdict().items() if f != "key_map"})
    state = fused_state_from_numpy(leaves, "cpu")
    back = fused_state_to_numpy(state)
    for name, value in leaves.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    poses = t_run(
        torch.from_numpy(xyz[k:]), torch.from_numpy(mask[k:]), torch.from_numpy(stamps[k:]),
        _port_cfg(CFG_LUT), PF, init_state=state, inten=torch.from_numpy(inten[k:]), device="cpu",
    )
    _assert_poses_close(poses.numpy(), want_poses[k:], TRANS_ATOL)


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _is_reference(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "lv_slam_tpu")


def test_port_never_imports_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX package:
    no import statement names them (chip_smoke's phases import inside their
    functions, which the walk covers), and importing the port's modules,
    the LFA and the chain included, loads none of them."""
    root = Path(__file__).resolve().parents[1]
    paths = [root / "chip_smoke.py", *sorted((root / "lv_slam_tpu_torch").rglob("*.py"))]
    assert {"lfa", "pipeline", "odometry", "ops", "graph", "parallel"} <= {p.parent.name for p in paths}
    for path in paths:
        bad = sorted(m for m in _imported_modules(path) if _is_reference(m))
        assert not bad, (path, bad)
    smoke = _imported_modules(root / "chip_smoke.py")
    assert "lv_slam_tpu_torch.pipeline.fused_chain" in smoke  # phase 4's imports are scanned
    assert "lv_slam_tpu_torch.pipeline.async_backend" in smoke  # and phase 5's
    code = (
        "import sys, chip_smoke, lv_slam_tpu_torch.odometry.fused, lv_slam_tpu_torch.convert, "
        "lv_slam_tpu_torch.lfa.fused, lv_slam_tpu_torch.pipeline.fused_chain, "
        "lv_slam_tpu_torch.io.synthetic, lv_slam_tpu_torch.io.kitti, lv_slam_tpu_torch.pipeline.backend, "
        "lv_slam_tpu_torch.pipeline.async_backend, lv_slam_tpu_torch.pipeline.window, "
        "lv_slam_tpu_torch.graph.loop_detector, lv_slam_tpu_torch.graph.pose_graph, "
        "lv_slam_tpu_torch.graph.information_matrix, lv_slam_tpu_torch.ops.nn, lv_slam_tpu_torch.lfa, "
        "lv_slam_tpu_torch.pipeline.slam, lv_slam_tpu_torch.odometry.dlo, lv_slam_tpu_torch.parallel.fleet, "
        "lv_slam_tpu_torch.parallel.mesh, lv_slam_tpu_torch.entry; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lv_slam_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_entry_points_default_to_the_card(inputs):
    """Without `device="cpu"` the entry points put their work on the card:
    with no CUDA device they raise instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from lv_slam_tpu_torch.config import LfaConfig
    from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud
    from lv_slam_tpu_torch.lfa import LfaPipeline
    from lv_slam_tpu_torch.lfa.fused import run_sequence_lfa
    from lv_slam_tpu_torch.pipeline.fused_chain import run_sequence_chain
    from lv_slam_tpu_torch.pipeline.slam import LvSlam

    xyz, mask, stamps, inten, _ = inputs
    assert TCloud.from_numpy(xyz[0], cap=CAP, device="cpu").xyz.device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        TCloud.from_numpy(xyz[0], cap=CAP)
    x, m, t = torch.from_numpy(xyz[:2]), torch.from_numpy(mask[:2]), torch.from_numpy(stamps[:2])
    with pytest.raises((RuntimeError, AssertionError)):
        t_run(x, m, t, CFG, PF)
    with pytest.raises((RuntimeError, AssertionError)):
        run_sequence_lfa(x, m, LfaConfig(), odom_poses=torch.eye(4).expand(2, 4, 4))
    with pytest.raises((RuntimeError, AssertionError)):
        run_sequence_chain(x, m, t, CFG, PF, LfaConfig())
    with pytest.raises((RuntimeError, AssertionError)):
        run_sequence_lfa(x, m, LfaConfig())
    with pytest.raises((RuntimeError, AssertionError)):
        LfaPipeline(LfaConfig()).process_numpy(xyz[0][mask[0]], cap=CAP)
    with pytest.raises((RuntimeError, AssertionError)):
        LvSlam(use_dlo=False).process(xyz[0][mask[0]], 0.0)
    with pytest.raises((RuntimeError, AssertionError)):
        LvSlam().process(xyz[0][mask[0]], 0.0)
    from lv_slam_tpu_torch.odometry.dlo import DirectLidarOdometry, run_sequence

    with pytest.raises((RuntimeError, AssertionError)):
        DirectLidarOdometry().process_numpy(xyz[0][mask[0]], 0.0, cap=CAP)
    with pytest.raises((RuntimeError, AssertionError)):
        run_sequence([xyz[0][mask[0]]], cap=CAP)
    from lv_slam_tpu_torch import entry
    from lv_slam_tpu_torch.parallel.fleet import run_fleet_odometry

    with pytest.raises((RuntimeError, AssertionError)):
        run_fleet_odometry(None, x[None], m[None], t[None], CFG, prefilter_cfg=PF)
    with pytest.raises((RuntimeError, AssertionError)):
        entry.entry()
