"""Device-resident LFA: feature odometry + mapping, one scan step at a time
(port of `lv_slam_tpu.lfa.fused`).

One scan step = feature extraction (kernel 8) -> the odometry pose -> the
scan-to-map correspondences against the persistent edge/surf cell tables
(kernel 10) -> Gauss-Newton (kernel 11) -> incremental map insert (kernel
9a) and radius crop (kernel 9b). The odometry pose is either supplied
(`external_odom=True`: the dlo_lfa coupling, where the PCA-NDT odometry
seeds the mapping stage) or the standalone scan-to-scan feature odometry
(`external_odom=False`, A-LOAM's alaserOdometry): 2-point lines and 3-point
planes against the previous scan's sorted grids (kernel 9k), Gauss-Newton,
then this scan's grids (kernel 9g) for the next step.

The reference traces this once under `lax.scan` with `lax.cond` branches; the
port runs a Python loop over the scans, and the step reads nothing back from
the device: the `mapping_skip_frame` branch (external coupling only, as in
the reference) is decided on the host's own scan counter, and the
`crop_interval` gate inside the crop kernel. The state and every tensor stay
on the run's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lv_slam_tpu_torch.config import LfaConfig
from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.lfa import registration as reg
from lv_slam_tpu_torch.lfa.features import FeatureClouds, extract_features
from lv_slam_tpu_torch.lfa.odometry import _GRID_CELL, feature_grids, odom_step
from lv_slam_tpu_torch.ops.knn import (
    CellTable,
    KnnGrid,
    crop_cell_tables_,
    empty_cell_table,
    insert_cell_table_,
)


class LfaFusedState(NamedTuple):
    """The reference's state. A step updates its tables in place. The
    previous scan's grids are None on the external-odometry path, which
    never reads them (the reference builds them at init all the same)."""

    odom_pose: torch.Tensor    # (4,4) odometry pose of the latest scan
    last_rel: torch.Tensor     # (4,4) constant-velocity warm start (standalone only)
    edge_table: CellTable      # persistent world edge-feature map
    surf_table: CellTable      # persistent world surf-feature map
    map_pose: torch.Tensor     # (4,4) refined world pose (aft_mapped)
    last_odom: torch.Tensor    # (4,4) odometry pose of the last mapped scan
    scan_idx: int
    crop_center: torch.Tensor  # (3,) pose of the last table crop
    prev_edge_grid: Optional[KnnGrid] = None  # the previous scan's less-sharp features
    prev_surf_grid: Optional[KnnGrid] = None  # its less-flat features


def _extract(xyz: torch.Tensor, mask: torch.Tensor, cfg: LfaConfig) -> FeatureClouds:
    return extract_features(PointCloud(xyz, torch.zeros_like(xyz[:, 0]), mask), cfg)


def _n_buckets(cfg: LfaConfig, cap: int) -> int:
    """Hash-table size from capacity x density, a power of two in [2^12, 2^18]."""
    target = max(1, int(cfg.knn_table_density * cap))
    return 1 << max(12, min(18, (target - 1).bit_length()))


def make_lfa_fused(cfg: LfaConfig, external_odom: bool = True, crop_radius: Optional[float] = None):
    """-> (init_state, step). `external_odom=True`: the caller supplies each
    scan's world odometry pose and the scan-to-scan solve is skipped;
    `False`: standalone LFA, the feature odometry feeds the mapping."""
    if crop_radius is None:
        crop_radius = cfg.crop_radius
    stride = max(1, int(cfg.mapping_skip_frame))

    def _insert_and_crop(edge: CellTable, surf: CellTable, feats: FeatureClouds, pose, crop_center):
        """Insert this scan's world-frame features into both tables, then
        crop them once the pose has moved `cfg.crop_interval` from the last
        crop (the gate is decided on the device), in place. Returns the
        center of the last crop."""
        insert_cell_table_(
            edge, se3.transform_points(pose, feats.less_sharp), feats.less_sharp_mask,
            cfg.mapping_line_resolution,
        )
        insert_cell_table_(
            surf, se3.transform_points(pose, feats.less_flat), feats.less_flat_mask,
            cfg.mapping_plane_resolution,
        )
        center = pose[:3, 3].contiguous()
        if cfg.crop_interval <= 0.0:
            crop_cell_tables_(edge, surf, center, crop_radius)
            return center
        return crop_cell_tables_(edge, surf, center, crop_radius, crop_center, cfg.crop_interval)

    def _refine(state: LfaFusedState, feats: FeatureClouds, guess: torch.Tensor) -> torch.Tensor:
        t = guess
        for _ in range(cfg.mapping_corr_rounds):
            lines = reg.lines_from_fit(
                se3.transform_points(t, feats.less_sharp), feats.less_sharp_mask,
                state.edge_table, k=cfg.knn_k,
            )
            planes = reg.planes_from_fit(
                se3.transform_points(t, feats.less_flat), feats.less_flat_mask,
                state.surf_table, k=cfg.knn_k,
            )
            t = reg.gn_solve(
                t, feats.less_sharp, lines, feats.less_flat, planes, cfg.mapping_max_iterations
            )
        return se3.orthonormalize(t)

    def init_state(xyz: torch.Tensor, mask: torch.Tensor, odom0: torch.Tensor) -> LfaFusedState:
        dev = xyz.device
        feats = _extract(xyz, mask, cfg)
        pose0 = odom0.to(device=dev, dtype=torch.float32)
        edge = empty_cell_table(_n_buckets(cfg, cfg.map_edge_cap), cfg.knn_slots, _GRID_CELL, dev)
        surf = empty_cell_table(_n_buckets(cfg, cfg.map_planar_cap), cfg.knn_slots, _GRID_CELL, dev)
        crop_center = _insert_and_crop(edge, surf, feats, pose0, pose0[:3, 3] + 1e6)
        edge_grid, surf_grid = (None, None) if external_odom else feature_grids(feats)
        return LfaFusedState(
            odom_pose=pose0,
            last_rel=torch.eye(4, dtype=torch.float32, device=dev),
            edge_table=edge,
            surf_table=surf,
            map_pose=pose0,
            last_odom=pose0,
            scan_idx=1,
            crop_center=crop_center,
            prev_edge_grid=edge_grid,
            prev_surf_grid=surf_grid,
        )

    def step(state: LfaFusedState, xyz: torch.Tensor, mask: torch.Tensor, ext_odom: torch.Tensor):
        """-> (new state, this scan's refined world pose). `ext_odom` is read
        only on the external-odometry path."""
        if external_odom:
            odom, odometry_state = ext_odom.to(torch.float32), {}
        else:
            feats = _extract(xyz, mask, cfg)
            # A-LOAM re-associates `odom_corr_rounds` times, warm-started by the last motion
            rel = se3.orthonormalize(odom_step(
                state.last_rel, feats, state.prev_edge_grid, state.prev_surf_grid, cfg.odom_corr_rounds,
                cfg.odom_max_iterations // 2,
            ))
            odom = state.odom_pose @ rel
            edge_grid, surf_grid = feature_grids(feats)
            odometry_state = dict(last_rel=rel, prev_edge_grid=edge_grid, prev_surf_grid=surf_grid)
        # seed: the previous refined pose composed with the odometry increment
        # (A-LOAM's transformAssociateToMap)
        guess = state.map_pose @ (se3.inverse(state.last_odom) @ odom)
        if external_odom:
            # the mapping stride throttles only the external coupling: a
            # skipped scan outputs the odometry composed onto the last map
            # correction and leaves the maps untouched
            if stride > 1 and state.scan_idx % stride != 0:
                return state._replace(odom_pose=odom, scan_idx=state.scan_idx + 1), guess
            feats = _extract(xyz, mask, cfg)
        refined = _refine(state, feats, guess)
        crop_center = _insert_and_crop(
            state.edge_table, state.surf_table, feats, refined, state.crop_center
        )
        new_state = state._replace(
            odom_pose=odom, map_pose=refined, last_odom=odom, scan_idx=state.scan_idx + 1,
            crop_center=crop_center, **odometry_state,
        )
        return new_state, refined

    return init_state, step


def own_tables(state: LfaFusedState) -> LfaFusedState:
    """`state` with its own copy of the maps, which a run then updates in
    place: the caller's `init_state` stays as it was."""
    return state._replace(
        edge_table=CellTable(state.edge_table.table.clone(), state.edge_table.cell_size),
        surf_table=CellTable(state.surf_table.table.clone(), state.surf_table.cell_size),
    )


def run_sequence_lfa(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    cfg: LfaConfig,
    odom_poses: Optional[torch.Tensor] = None,
    crop_radius: Optional[float] = None,
    init_state: Optional[LfaFusedState] = None,
    return_state: bool = False,
    device="cuda",
):
    """(N,cap,3), (N,cap)[, (N,4,4) odometry] -> (N,4,4) refined poses on `device`.

    With `odom_poses` the stage runs in dlo_lfa mode (the mapping seeded by
    the given odometry); without, standalone feature odometry drives it and
    scan 0 sits at the identity. The inputs move to `device` (the card
    unless the caller asks for the CPU); `init_state` must already lie there.
    Without `init_state`, scan 0 builds the maps at its odometry pose and
    outputs that pose; with it, every scan is a refinement step, so chunked
    runs equal the unchunked run."""
    external = odom_poses is not None
    dev = torch.device(device)
    xyz, mask = xyz.to(dev), mask.to(dev)
    if external:
        odom_poses = odom_poses.to(dev, torch.float32)
    else:
        odom_poses = torch.eye(4, dtype=torch.float32, device=dev).expand(xyz.shape[0], 4, 4)
    init, step = make_lfa_fused(cfg, external, crop_radius)
    poses = []
    state = None if init_state is None else own_tables(init_state)
    start = 0
    if state is None:
        state = init(xyz[0], mask[0], odom_poses[0])
        poses.append(odom_poses[0])
        start = 1
    for i in range(start, xyz.shape[0]):
        state, refined = step(state, xyz[i], mask[i], odom_poses[i])
        poses.append(refined)
    out = torch.stack(poses)
    return (out, state) if return_state else out
