"""The port's dlo -> LFA chain (`run_sequence_chain`, the slice as a whole)
against lv_slam_tpu.pipeline.fused_chain on the conftest `small_sequence`,
and a run carried over from the reference's `ChainState` by `convert.py`.

Tolerances, per scan: TRANS_ATOL / ROT_ATOL (the odometry test's), or the
reference's own spread where that is larger. The odometry is rounding
sensitive at the millimetre level (see test_torch_odometry), and the refined
pose inherits it: moving every input coordinate by one ulp moves the
reference's odometry by up to ODOM_SPREAD and its refined pose by up to
REFINED_SPREAD (48 perturbations, seeds 0-47, rounded up), its refined
rotation by up to 5.0e-4. Measured port errors: odometry 1.07 / 1.06 /
2.02 / 2.25 / 5.23 mm, refined 0.15 / 0.81 / 1.67 / 3.00 / 0.84 mm and
5.0e-4 on scans 1-5; the carried run 4.3e-6 m.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import LfaConfig as JLfa, NDTConfig, OdometryConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.pipeline.fused_chain import run_sequence_chain as j_chain  # noqa: E402
from lv_slam_tpu_torch.config import LfaConfig as TLfa  # noqa: E402
from lv_slam_tpu_torch.convert import chain_state_from_numpy, chain_state_to_numpy  # noqa: E402
from lv_slam_tpu_torch.pipeline.fused_chain import run_sequence_chain as t_chain  # noqa: E402

CAP = 32768
ODO = OdometryConfig(ndt=NDTConfig(leaf_cap=16384, lut_extent=256))
PF = PrefilterConfig(raw_cap=CAP, out_cap=CAP)
KW = dict(scan_line=32, edge_cap=2048, planar_cap=4096, map_edge_cap=8192, map_planar_cap=16384)
TRANS_ATOL = 2e-3  # m
ROT_ATOL = 1e-3
ODOM_SPREAD = np.array([0.0, 4.2e-3, 2.3e-3, 3.2e-3, 4.9e-3, 9.6e-3])
REFINED_SPREAD = np.array([0.0, 1.6e-4, 8.2e-4, 1.9e-3, 3.1e-3, 9.4e-4])


@pytest.fixture(scope="module")
def inputs(small_sequence):
    scans, gt, _ = small_sequence
    clouds = [JCloud.from_numpy(s, cap=CAP) for s in scans]
    xyz = np.stack([np.asarray(c.xyz) for c in clouds])
    mask = np.stack([np.asarray(c.mask) for c in clouds])
    stamps = np.arange(len(scans), dtype=np.float32) * 0.1
    inten = np.full(xyz.shape[:2], 0.5, np.float32)
    return xyz, mask, stamps, inten, gt


def _jax(inputs, sl=slice(None), **kw):
    xyz, mask, stamps, inten, _ = inputs
    return j_chain(
        jnp.asarray(xyz[sl]), jnp.asarray(mask[sl]), jnp.asarray(stamps[sl]), ODO, PF, JLfa(**KW),
        inten=jnp.asarray(inten[sl]), **kw,
    )


def _port(inputs, sl=slice(None), **kw):
    xyz, mask, stamps, inten, _ = inputs
    return t_chain(
        torch.from_numpy(xyz[sl]), torch.from_numpy(mask[sl]), torch.from_numpy(stamps[sl]), ODO, PF,
        TLfa(**KW), inten=torch.from_numpy(inten[sl]), device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def jax_run(inputs):
    odom, refined, filt = _jax(inputs, return_filtered=True)
    return np.asarray(odom), np.asarray(refined), tuple(np.asarray(f) for f in filt)


def _check(what, got, want, spread=None):
    err_t = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    err_r = float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max())
    tol_t = TRANS_ATOL if spread is None else np.maximum(TRANS_ATOL, spread)
    print(f"{what}: translation error {np.array2string(err_t, precision=6)} m (tolerance {tol_t}), "
          f"rotation error {err_r:.3g} (tolerance {ROT_ATOL})")
    assert (err_t <= tol_t).all() and err_r <= ROT_ATOL


def test_run_sequence_chain_matches_jax(inputs, jax_run):
    """Odometry, refined poses and the `/filtered_points` product."""
    want_odom, want_refined, want_filt = jax_run
    odom, refined, filt = _port(inputs, return_filtered=True)
    _check("odometry", odom.numpy(), want_odom, ODOM_SPREAD)
    _check("refined", refined.numpy(), want_refined, REFINED_SPREAD)
    fxyz, finten, fmask = filt
    assert fxyz.shape == (inputs[0].shape[0], 3, CAP)
    np.testing.assert_array_equal(fmask.numpy(), want_filt[2])
    np.testing.assert_allclose(fxyz.numpy(), want_filt[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(finten.numpy(), want_filt[1], rtol=0, atol=1e-5)
    gt = inputs[4]
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert np.linalg.norm(refined.numpy()[-1, :3, 3] - gt_rel[-1, :3, 3]) < 0.25


def _leaves(state) -> dict:
    """The reference's ChainState as the flat numpy leaves `convert.py` reads."""
    out = {f"odo.key_map.{k}": np.asarray(v) for k, v in state.odo.key_map._asdict().items()}
    out.update({f"odo.{k}": np.asarray(v) for k, v in state.odo._asdict().items() if k != "key_map"})
    for k, v in state.lfa._asdict().items():
        if k in ("edge_table", "surf_table"):
            out[f"lfa.{k}.table"] = np.asarray(v.table)
            out[f"lfa.{k}.cell_size"] = np.asarray(v.cell_size)
        elif k not in ("prev_edge_grid", "prev_surf_grid"):  # never read on this path
            out[f"lfa.{k}"] = np.asarray(v)
    return out


def test_state_carried_from_jax(inputs, jax_run):
    """JAX runs the first half; the port takes its state over and runs the
    second half, matching JAX's unchunked run."""
    k = inputs[0].shape[0] // 2
    _, jstate = _jax(inputs, slice(None, k), return_state=True)
    leaves = _leaves(jstate)
    state = chain_state_from_numpy(leaves, "cpu")
    back = chain_state_to_numpy(state)
    assert set(back) == set(leaves)
    for name, value in leaves.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    (odom, refined), state2 = _port(inputs, slice(k, None), init_state=state, return_state=True)
    _check("carried odometry", odom.numpy(), jax_run[0][k:])
    _check("carried refined", refined.numpy(), jax_run[1][k:])
    assert state2.odo.scan_idx == state.odo.scan_idx + inputs[0].shape[0] - k
    assert state2.lfa.scan_idx == state.lfa.scan_idx + inputs[0].shape[0] - k


def test_chunked_equals_unchunked(inputs):
    odom, refined = _port(inputs)
    k = inputs[0].shape[0] // 2
    (o1, r1), state = _port(inputs, slice(None, k), return_state=True)
    o2, r2 = _port(inputs, slice(k, None), init_state=state)
    np.testing.assert_array_equal(torch.cat([o1, o2]).numpy(), odom.numpy())
    np.testing.assert_array_equal(torch.cat([r1, r2]).numpy(), refined.numpy())
