"""Scan-in/pose-out DLO odometry (port of `lv_slam_tpu.odometry.fused`).

One scan step = prefilter -> NDT align (+ the reference's double align of
scan 1) -> deviation-triggered wide-basin retry -> keyframe gate -> map
rebuild. The reference traces this once and runs it under `lax.scan` with
`lax.cond` branches; the port runs a Python loop over the scans and takes
each branch on a bool read back from the device. Per scan that costs the
Newton loops' reads (K7 runs on the device and reads `done` once per
`ops/ndt.NEWTON_GROUP` iterations: one read per phase at the usual one or
two iterations), one for the retry gate and one for the keyframe gate. The
state and every tensor stay on the run's device: the card unless the caller
passes `device="cpu"`; the per-scan iteration counts stay there too.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from lv_slam_tpu_torch.config import OdometryConfig, PrefilterConfig
from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.ops.ndt import make_gauss_params
from lv_slam_tpu_torch.ops.ndt_hash import (
    HashVoxelMap,
    ndt_align_hash_table,
    ndt_derivatives_hash,
    to_hash,
)
from lv_slam_tpu_torch.ops.ndt_soa import ndt_align_soa, ndt_derivatives_soa, to_soa
from lv_slam_tpu_torch.ops.prefilter import (
    distance_filter,
    stride_subsample,
    uniform_subsample,
    voxel_dedup_first,
    voxel_downsample,
)
from lv_slam_tpu_torch.ops.voxel_map import LutMap, build_lut, build_voxel_map, neighborhood_offsets


class FusedState(NamedTuple):
    key_map: Union[HashVoxelMap, LutMap]  # by NDTConfig.table
    key_pose: torch.Tensor        # (4,4)
    tf_s2k: torch.Tensor          # (4,4)
    pre_tf_s2k: torch.Tensor      # (4,4)
    guess: torch.Tensor           # (4,4)
    keyframe_stamp: torch.Tensor  # () float32
    scan_idx: int


def _prefilter_mid(
    cloud: PointCloud, cfg: PrefilterConfig, stride_consumer: bool = False
) -> PointCloud:
    """The `/filtered_points` product: distance band + voxel centroid.
    `stride_consumer=True` skips the NONE branch's compact when the
    capacity already fits (the stride subsample needs no compaction)."""
    out = cloud
    if cfg.use_distance_filter:
        out = distance_filter(out, cfg.distance_near_thresh, cfg.distance_far_thresh)
    method = cfg.downsample_method.upper()
    if method in ("VOXELGRID", "APPROX_VOXELGRID"):
        out = voxel_downsample(out, cfg.downsample_resolution, cfg.out_cap, method)
    elif method == "DEDUP":
        out = voxel_dedup_first(out, cfg.downsample_resolution, cfg.out_cap)
    elif stride_consumer and cfg.out_cap >= out.cap:
        pass  # holes tolerated: stride_subsample slices lanes, mask and all
    else:
        out = out.compact(cfg.out_cap)
    return out


def _stride_active(subsample_method: str, scan_matching_cap: int, cloud_cap: int) -> bool:
    """True only when the stride subsample will actually apply, so the
    NONE+stride compact skip never feeds the NDT map an undownsampled cloud."""
    return (
        subsample_method == "stride"
        and scan_matching_cap > 0
        and scan_matching_cap < cloud_cap
    )


def _subsample(cloud: PointCloud, scan_matching_cap: int, subsample_method: str) -> PointCloud:
    """Bounded-lane scan matching (`OdometryConfig.scan_matching_cap`)."""
    if scan_matching_cap and scan_matching_cap < cloud.cap:
        sub = stride_subsample if subsample_method == "stride" else uniform_subsample
        return sub(cloud, scan_matching_cap)
    return cloud


def _prefilter(
    cloud: PointCloud,
    cfg: PrefilterConfig,
    scan_matching_cap: int = 0,
    subsample_method: str = "gather",
) -> PointCloud:
    out = _prefilter_mid(
        cloud, cfg,
        stride_consumer=_stride_active(subsample_method, scan_matching_cap, cloud.cap),
    )
    return _subsample(out, scan_matching_cap, subsample_method)


def _make_ops(cfg: OdometryConfig, prefilter_cfg: Optional[PrefilterConfig]):
    """Map build, align, retry align and score closures of one configuration:
    over the bucket-pair hash table (`table="hash"`) or the dense LUT with
    packed rows (`table="lut"`, the reference's `ndt_align_soa` path)."""
    ndt = cfg.ndt
    table = ndt.table.lower()
    if table not in ("hash", "lut"):
        raise ValueError(f"NDTConfig.table must be 'hash' or 'lut', got {ndt.table!r}")

    def build(cloud: PointCloud):
        vmap_ = build_voxel_map(
            cloud,
            ndt.resolution,
            leaf_cap=ndt.leaf_cap,
            lut_extent=ndt.lut_extent,
            min_points_per_voxel=ndt.min_points_per_voxel,
            min_covar_eigvalue_mult=ndt.min_covar_eigvalue_mult,
            weighted=ndt.weighted,
        )
        if table == "lut":
            return LutMap(vmap_, build_lut(vmap_))
        return to_hash(vmap_, ndt.hash_buckets_per_leaf)

    common = dict(
        resolution=ndt.resolution,
        outlier_ratio=ndt.outlier_ratio,
        step_size=ndt.step_size,
        transformation_epsilon=ndt.transformation_epsilon,
        max_iterations=ndt.max_iterations,
        weighted=ndt.weighted,
    )
    if table == "lut":
        def align_fn(key_map: LutMap, source, guess, **kw):
            return ndt_align_soa(key_map.vmap, key_map.lut, source, guess, **kw)
    else:
        align_fn = ndt_align_hash_table
    align = functools.partial(
        align_fn, neighborhood=ndt.neighborhood, coarse_subsample=ndt.coarse_subsample, **common,
    )
    align_retry = functools.partial(align_fn, neighborhood=ndt.retry_neighborhood, **common)
    gauss = make_gauss_params(ndt.resolution, ndt.outlier_ratio)

    def score_at(key_map, cloud: PointCloud, transform: torch.Tensor):
        args = (cloud.masked_xyz().T.contiguous(), cloud.mask.contiguous(), transform, gauss,
                neighborhood_offsets(ndt.neighborhood, transform.device), ndt.weighted)
        if table == "lut":
            s, _, _ = ndt_derivatives_soa(to_soa(key_map.vmap, key_map.lut), *args)
        else:
            s, _, _ = ndt_derivatives_hash(key_map, *args)
        return s

    return build, align, align_retry, score_at


def make_fused_step(
    cfg: OdometryConfig,
    prefilter_cfg: Optional[PrefilterConfig],
    emit_filtered: bool = False,
):
    """Returns `(init_state, step)`. `emit_filtered=True` adds each scan's
    prefiltered cloud (before the scan-matching subsample) to the step output
    as `(xyz (3,out_cap), intensity (out_cap,), mask (out_cap,))`, the
    reference's transposed `/filtered_points` layout."""
    ndt = cfg.ndt
    build, align, align_retry, score_at = _make_ops(cfg, prefilter_cfg)

    def init_state(cloud: PointCloud, stamp: torch.Tensor) -> FusedState:
        filtered = (
            _prefilter(cloud, prefilter_cfg, cfg.scan_matching_cap, cfg.subsample_method)
            if prefilter_cfg else cloud
        )
        eye = torch.eye(4, dtype=torch.float32, device=cloud.xyz.device)
        guess = eye.clone()
        guess[0, 3] = cfg.initial_guess_x
        return FusedState(
            key_map=build(filtered),
            key_pose=eye,
            tf_s2k=eye,
            pre_tf_s2k=eye,
            guess=guess,
            keyframe_stamp=stamp.to(torch.float32),
            scan_idx=1,
        )

    def step(state: FusedState, cloud: PointCloud, stamp: torch.Tensor):
        if prefilter_cfg is not None:
            mid = _prefilter_mid(
                cloud, prefilter_cfg,
                stride_consumer=_stride_active(
                    cfg.subsample_method, cfg.scan_matching_cap, cloud.cap
                ),
            )
            filtered = _subsample(mid, cfg.scan_matching_cap, cfg.subsample_method)
        else:
            mid = filtered = cloud
        result = align(state.key_map, filtered, state.guess)
        tf_s2k = result.transform
        if state.scan_idx == 1:
            # the reference aligns scan 1 twice, re-seeded
            tf_s2k = align(state.key_map, filtered, result.transform).transform
        if ndt.retry_deviation_thresh > 0:
            dev = torch.linalg.vector_norm(tf_s2k[:3, 3] - state.guess[:3, 3])
            if bool(dev > ndt.retry_deviation_thresh):
                r = align_retry(state.key_map, filtered, state.guess)
                s_retry = score_at(state.key_map, filtered, r.transform)
                tf_s2k = torch.where(s_retry > result.score, r.transform, tf_s2k)
        tf_s2k = se3.orthonormalize(tf_s2k)

        tf_s2s = se3.inverse(state.pre_tf_s2k) @ tf_s2k
        odom = state.key_pose @ tf_s2k

        dx = torch.linalg.vector_norm(tf_s2k[:3, 3])
        da = se3.rotation_angle(tf_s2k[:3, :3])
        stamp = stamp.to(torch.float32)
        dt = stamp - state.keyframe_stamp
        switch = bool(
            (dx > cfg.keyframe_delta_trans)
            | (da > cfg.keyframe_delta_angle)
            | (dt > cfg.keyframe_delta_time)
        )
        if switch:
            eye = torch.eye(4, dtype=torch.float32, device=tf_s2k.device)
            new_state = FusedState(
                key_map=build(filtered), key_pose=odom, tf_s2k=eye, pre_tf_s2k=eye,
                guess=tf_s2s, keyframe_stamp=stamp, scan_idx=state.scan_idx + 1,
            )
        else:
            new_state = FusedState(
                key_map=state.key_map, key_pose=state.key_pose, tf_s2k=tf_s2k,
                pre_tf_s2k=tf_s2k, guess=tf_s2k @ tf_s2s,
                keyframe_stamp=state.keyframe_stamp, scan_idx=state.scan_idx + 1,
            )
        out = (odom, result.iterations, switch)
        if emit_filtered:
            out = out + ((mid.xyz.T, mid.intensity, mid.mask),)
        return new_state, out

    return init_state, step


def run_sequence_fused(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    stamps: torch.Tensor,
    cfg: OdometryConfig,
    prefilter_cfg: Optional[PrefilterConfig] = None,
    with_stats: bool = False,
    use_scan: bool = True,
    init_state: Optional[FusedState] = None,
    return_state: bool = False,
    inten: Optional[torch.Tensor] = None,
    return_filtered: bool = False,
    device="cuda",
):
    """(N,cap,3), (N,cap), (N,) -> (N,4,4) poses, on `device`.

    The inputs move to `device` (the card unless the caller asks for the
    CPU); `init_state` must already lie there. Otherwise the same arguments
    and outputs as the reference. `use_scan` selects between
    the reference's two compiled forms; the port has one Python loop, so it
    only keeps the reference's rule that `return_filtered` needs the scan
    form. Without `init_state`, scan 0 builds the first keyframe map and gets
    the identity pose (and, with `return_filtered`, its `/filtered_points`
    product prepended); with `init_state` every scan is an odometry step, so
    chunked runs equal the unchunked run. `with_stats` adds per-scan Newton
    iterations (int32) and keyframe switches (bool); `return_state` adds the
    final `FusedState`.
    """
    if return_filtered and not use_scan:
        raise ValueError("return_filtered requires the lax.scan path")
    if return_filtered and prefilter_cfg is None:
        raise ValueError("return_filtered requires a prefilter_cfg")
    dev = torch.device(device)
    xyz, mask, stamps = xyz.to(dev), mask.to(dev), stamps.to(dev)
    n = xyz.shape[0]
    if inten is None:
        inten = torch.zeros(xyz.shape[:2], dtype=torch.float32, device=dev)
    inten = inten.to(dev)
    init, step = make_fused_step(cfg, prefilter_cfg, return_filtered)

    poses, iters, switches, filt = [], [], [], []
    start = 0
    state = init_state
    if state is None:
        cloud0 = PointCloud(xyz[0], inten[0], mask[0])
        state = init(cloud0, stamps[0])
        poses.append(torch.eye(4, dtype=torch.float32, device=dev))
        iters.append(torch.zeros((), dtype=torch.int32, device=dev))
        switches.append(False)
        if return_filtered:
            mid0 = _prefilter_mid(
                cloud0, prefilter_cfg,
                stride_consumer=_stride_active(
                    cfg.subsample_method, cfg.scan_matching_cap, cloud0.cap
                ),
            )
            filt.append((mid0.xyz.T, mid0.intensity, mid0.mask))
        start = 1
    for i in range(start, n):
        state, out = step(state, PointCloud(xyz[i], inten[i], mask[i]), stamps[i])
        poses.append(out[0])
        iters.append(out[1])
        switches.append(out[2])
        if return_filtered:
            filt.append(out[3])

    out_poses = torch.stack(poses)
    if with_stats:
        result: Tuple = (
            out_poses,
            torch.stack(iters).to(torch.int32),  # device counts: no read
            torch.tensor(switches, dtype=torch.bool).to(dev),
        )
    else:
        result = out_poses
    if return_filtered:
        filtered = tuple(torch.stack(col) for col in zip(*filt))
        result = (result, filtered) if not isinstance(result, tuple) else result + (filtered,)
    return (result, state) if return_state else result
