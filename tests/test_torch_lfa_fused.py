"""The port's device-resident LFA stage (`run_sequence_lfa`, kernels 8-11
and, standalone, 9g/9k through their plain twins on the CPU) against
lv_slam_tpu.lfa.fused on the conftest `small_sequence`: on external
odometry (both fed the reference's odometry poses) and standalone (the
scan-to-scan feature odometry drives the mapping).

Tolerance: each refined pose within 1e-4 m and 1e-4 of the reference's,
or within the reference's own spread where that is larger: moving every
input coordinate by one ulp moves the reference's refined translation by
up to 0.23 mm (default), 0.77 mm (mapping_skip_frame=2), 0.76 mm (crop
every scan at 20 m) and 0.25 mm (crop gated at 1e6 m), and its rotation
by up to 3.0e-4 (8 perturbations each; `REF_SPREAD` below, rounded up).
Measured port errors: at most 3.4e-5 m and 7.3e-6. Standalone, the same
measurement (`scripts/reference_spread.py lfa`) gives up to 0.63 mm
(default) and 0.38 mm (crop every scan), rotation 3.8e-5 and 5.2e-5
(`STANDALONE_SPREAD`); measured port errors: at most 7.0e-6 m and 1.0e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import LfaConfig as JLfa, NDTConfig, OdometryConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.lfa.fused import run_sequence_lfa as j_lfa  # noqa: E402
from lv_slam_tpu.odometry.fused import run_sequence_fused as j_odo  # noqa: E402
from lv_slam_tpu_torch.config import LfaConfig as TLfa  # noqa: E402
from lv_slam_tpu_torch.convert import lfa_state_from_numpy, lfa_state_to_numpy  # noqa: E402
from lv_slam_tpu_torch.lfa.fused import run_sequence_lfa as t_lfa  # noqa: E402

CAP = 32768
KW = dict(scan_line=32, edge_cap=2048, planar_cap=4096, map_edge_cap=8192, map_planar_cap=16384)
VARIANTS = {
    "default": {},
    "skip2": dict(mapping_skip_frame=2),
    "crop_every_scan": dict(crop_radius=20.0, crop_interval=0.0),
    "crop_gated": dict(crop_radius=20.0, crop_interval=1e6),
}
TRANS_ATOL = 1e-4  # m
ROT_ATOL = 1e-4
REF_SPREAD = {  # per scan, m
    "default": [0.0, 1e-6, 1e-6, 1.3e-4, 7e-5, 2.4e-4],
    "skip2": [0.0, 0.0, 1e-6, 1e-6, 6.3e-4, 7.8e-4],
    "crop_every_scan": [0.0, 1.3e-6, 2e-6, 4.6e-4, 7.7e-4, 1.9e-4],
    "crop_gated": [0.0, 1.3e-6, 1.1e-6, 1.4e-4, 1.8e-4, 2.6e-4],
}
ROT_SPREAD = {"default": 6.7e-6, "skip2": 3.1e-4, "crop_every_scan": 8.7e-5, "crop_gated": 4.9e-6}
STANDALONE_SPREAD = {  # per scan, m
    "default": [0.0, 9e-7, 1.2e-6, 1.6e-4, 3.9e-4, 6.3e-4],
    "crop_every_scan": [0.0, 1e-6, 1.3e-6, 3.6e-4, 2.7e-4, 3.8e-4],
}


@pytest.fixture(scope="module")
def inputs(small_sequence):
    scans, gt, _ = small_sequence
    clouds = [JCloud.from_numpy(s, cap=CAP) for s in scans]
    xyz = np.stack([np.asarray(c.xyz) for c in clouds])
    mask = np.stack([np.asarray(c.mask) for c in clouds])
    stamps = np.arange(len(scans), dtype=np.float32) * 0.1
    odom = np.array(j_odo(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(stamps),
        OdometryConfig(ndt=NDTConfig(leaf_cap=16384, lut_extent=256)),
        PrefilterConfig(raw_cap=CAP, out_cap=CAP),
    ))
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    return xyz, mask, odom, gt_rel


def _n_valid(table) -> int:
    t = np.asarray(table).reshape(-1, 4)
    return int((t[:, 3] > 0.5).sum())


def _port(inputs, extra, **kw):
    xyz, mask, odom, _ = inputs
    return t_lfa(
        torch.from_numpy(xyz), torch.from_numpy(mask), TLfa(**KW, **extra),
        odom_poses=torch.from_numpy(odom), device="cpu", **kw,
    )


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_run_sequence_lfa_matches_jax(inputs, variant):
    xyz, mask, odom, gt_rel = inputs
    extra = VARIANTS[variant]
    want, jstate = j_lfa(
        jnp.asarray(xyz), jnp.asarray(mask), JLfa(**KW, **extra), odom_poses=jnp.asarray(odom),
        return_state=True,
    )
    want = np.asarray(want)
    got, state = _port(inputs, extra, return_state=True)
    got = got.numpy()
    err_t = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    err_r = float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max())
    tol_t = np.maximum(TRANS_ATOL, REF_SPREAD[variant])
    tol_r = max(ROT_ATOL, ROT_SPREAD[variant])
    print(f"{variant}: translation error {np.array2string(err_t, precision=7)} m (tolerance "
          f"{tol_t}), rotation error {err_r:.3g} (tolerance {tol_r})")
    assert (err_t <= tol_t).all() and err_r <= tol_r
    assert state.scan_idx == int(jstate.scan_idx)
    # the maps hold as many points as the reference's (features agree but
    # for a few lanes, see test_torch_lfa_features)
    for name in ("edge_table", "surf_table"):
        n_got, n_want = _n_valid(getattr(state, name).table), _n_valid(getattr(jstate, name).table)
        assert abs(n_got - n_want) <= max(4, n_want // 200), (name, n_got, n_want)
    assert np.linalg.norm(got[-1, :3, 3] - gt_rel[-1, :3, 3]) < 0.25


def test_skipped_scans_compose_odometry_onto_the_last_map_pose(inputs):
    """mapping_skip_frame=2: scan 1 is skipped and outputs
    map_pose @ inv(last_odom) @ odom of the initial state."""
    _, _, odom, _ = inputs
    got = _port(inputs, VARIANTS["skip2"]).numpy()
    want1 = odom[0] @ np.linalg.inv(odom[0]) @ odom[1]
    np.testing.assert_allclose(got[1], want1, atol=1e-5)


def test_crop_interval_gates_the_sweep(inputs):
    """The every-scan crop removes points the gated run keeps
    (test_lfa.py's crop_interval case), in the port as in the reference."""
    counts = {}
    for variant in ("crop_every_scan", "crop_gated"):
        _, state = _port(inputs, VARIANTS[variant], return_state=True)
        counts[variant] = _n_valid(state.surf_table.table)
    assert counts["crop_gated"] > counts["crop_every_scan"], counts


def test_chunked_equals_unchunked(inputs):
    xyz, mask, odom, _ = inputs
    whole = _port(inputs, {})
    k = xyz.shape[0] // 2
    cfg = TLfa(**KW)
    first, state = t_lfa(
        torch.from_numpy(xyz[:k]), torch.from_numpy(mask[:k]), cfg, odom_poses=torch.from_numpy(odom[:k]),
        return_state=True, device="cpu",
    )
    second = t_lfa(
        torch.from_numpy(xyz[k:]), torch.from_numpy(mask[k:]), cfg, odom_poses=torch.from_numpy(odom[k:]),
        init_state=state, device="cpu",
    )
    np.testing.assert_array_equal(torch.cat([first, second]).numpy(), whole.numpy())


def _standalone(inputs, variant, sl=slice(None), **kw):
    xyz, mask, _, _ = inputs
    return t_lfa(torch.from_numpy(xyz[sl]), torch.from_numpy(mask[sl]), TLfa(**KW, **VARIANTS[variant]),
                 device="cpu", **kw)


def _check_standalone(got, want, variant, first=0):
    err_t = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(axis=1)
    err_r = float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max())
    tol_t = np.maximum(TRANS_ATOL, STANDALONE_SPREAD[variant][first:first + len(got)])
    print(f"standalone {variant}: translation error {np.array2string(err_t, precision=7)} m (tolerance "
          f"{tol_t}), rotation error {err_r:.3g} (tolerance {ROT_ATOL})")
    assert (err_t <= tol_t).all() and err_r <= ROT_ATOL


@pytest.mark.parametrize("variant", ["default", "crop_every_scan"])
def test_standalone_run_sequence_lfa_matches_jax(inputs, variant):
    """No odometry given: the scan-to-scan feature odometry (2-point lines,
    3-point planes on the previous scan's grids) seeds the mapping."""
    xyz, mask, _, gt_rel = inputs
    want, jstate = j_lfa(jnp.asarray(xyz), jnp.asarray(mask), JLfa(**KW, **VARIANTS[variant]), return_state=True)
    got, state = _standalone(inputs, variant, return_state=True)
    _check_standalone(got.numpy(), np.asarray(want), variant)
    assert state.scan_idx == int(jstate.scan_idx)
    for name in ("prev_edge_grid", "prev_surf_grid"):  # the last scan's grids, identical
        for field in ("keys", "xyz", "origin_cell"):
            np.testing.assert_array_equal(getattr(getattr(state, name), field).numpy(),
                                          np.asarray(getattr(getattr(jstate, name), field)))
    assert np.linalg.norm(got.numpy()[-1, :3, 3] - gt_rel[-1, :3, 3]) < 0.25


def test_standalone_lfa_not_ported(inputs):
    """(Named when standalone LFA raised NotImplementedError.) A chunked
    standalone run, its grids carried in the state, equals the unchunked run."""
    whole = _standalone(inputs, "default")
    k = inputs[0].shape[0] // 2
    first, state = _standalone(inputs, "default", slice(None, k), return_state=True)
    assert state.prev_edge_grid is not None and state.prev_surf_grid is not None
    second = _standalone(inputs, "default", slice(k, None), init_state=state)
    np.testing.assert_array_equal(torch.cat([first, second]).numpy(), whole.numpy())


def _lfa_leaves(state) -> dict:
    """The reference's LfaFusedState as the flat numpy leaves `convert.py` reads."""
    out = {}
    for k, v in state._asdict().items():
        if k in ("edge_table", "surf_table"):
            out[f"{k}.table"], out[f"{k}.cell_size"] = np.asarray(v.table), np.asarray(v.cell_size)
        elif k in ("prev_edge_grid", "prev_surf_grid"):
            out.update({f"{k}.{f}": np.asarray(a) for f, a in v._asdict().items()})
        else:
            out[k] = np.asarray(v)
    return out


def test_standalone_state_carried_from_jax(inputs):
    """JAX runs the first half standalone; its state (maps and the last
    scan's grids) crosses into the port and back unchanged, and the port's
    second half matches JAX's unchunked run."""
    xyz, mask, _, _ = inputs
    k = xyz.shape[0] // 2
    cfg = JLfa(**KW)
    want = np.asarray(j_lfa(jnp.asarray(xyz), jnp.asarray(mask), cfg))
    _, jstate = j_lfa(jnp.asarray(xyz[:k]), jnp.asarray(mask[:k]), cfg, return_state=True)
    leaves = _lfa_leaves(jstate)
    state = lfa_state_from_numpy(leaves, "cpu")
    back = lfa_state_to_numpy(state)
    assert set(back) == set(leaves)
    for name, value in leaves.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    assert state.prev_edge_grid.keys.dtype == torch.int32 and state.prev_surf_grid.xyz.dtype == torch.float32
    got = _standalone(inputs, "default", slice(k, None), init_state=state)
    _check_standalone(got.numpy(), want[k:], "default", first=k)
