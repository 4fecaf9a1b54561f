"""Synthetic Velodyne-style LiDAR scans (numpy): the port's copy of the
parts of `lv_slam_tpu.io.synthetic` that drive the odometry workload.

A procedural urban world (ground plane, building boxes, poles) is ray-cast
with an HDL-64-like pattern along a circular drive with known ground truth.
At 64 rings x 2000 azimuths a scan holds about 125k returns, the density of a
KITTI Velodyne scan. `tests/test_torch_io.py` holds the scans equal to the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class World:
    boxes: np.ndarray  # (B, 6): xmin ymin zmin xmax ymax zmax
    ground_z: float = 0.0


def make_world(seed: int = 0, extent: float = 160.0, n_buildings: int = 60, n_poles: int = 80) -> World:
    rng = np.random.default_rng(seed)
    boxes = []
    # buildings: axis-aligned boxes, a central corridor kept clear
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-extent, extent, size=2)
        if abs(cy) < 8.0:
            cy = np.sign(cy or 1.0) * (8.0 + rng.uniform(0, 4))
        w, d = rng.uniform(6, 24, size=2)
        h = rng.uniform(4, 20)
        boxes.append(np.array([cx - w / 2, cy - d / 2, 0.0, cx + w / 2, cy + d / 2, h]))
    # poles: thin tall boxes
    for _ in range(n_poles):
        cx, cy = rng.uniform(-extent, extent, size=2)
        if abs(cy) < 2.5:
            cy = np.sign(cy or 1.0) * (2.5 + rng.uniform(0, 2))
        r = rng.uniform(0.08, 0.25)
        h = rng.uniform(2, 8)
        boxes.append(np.array([cx - r, cy - r, 0.0, cx + r, cy + r, h]))
    return World(boxes=np.stack(boxes).astype(np.float32))


def lidar_rays(n_rings: int, n_azimuth: int, max_elev_deg: float, min_elev_deg: float) -> np.ndarray:
    """(n_rings*n_azimuth, 3) unit directions in the sensor frame."""
    elev = np.deg2rad(np.linspace(max_elev_deg, min_elev_deg, n_rings))
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    dirs = np.empty((n_rings, n_azimuth, 3), np.float32)
    dirs[..., 0] = ce[:, None] * ca[None, :]
    dirs[..., 1] = ce[:, None] * sa[None, :]
    dirs[..., 2] = se[:, None]
    return dirs.reshape(-1, 3)


def hdl64_rays(n_rings: int = 64, n_azimuth: int = 900) -> np.ndarray:
    """HDL-64E vertical field: +2 .. -24.8 degrees."""
    return lidar_rays(n_rings, n_azimuth, 2.0, -24.8)


def _raycast(origins: np.ndarray, dirs: np.ndarray, world: World, max_range: float) -> np.ndarray:
    """Hit distance of each ray (inf where it hits nothing)."""
    n = dirs.shape[0]
    t_best = np.full(n, np.inf, np.float32)
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = (world.ground_z - origins[:, 2]) / dz
    hit = (dz < -1e-6) & (t_ground > 0.1)
    t_best = np.where(hit, np.minimum(t_best, t_ground), t_best)
    # boxes: slab test over (rays, boxes), in chunks to bound memory
    boxes = world.boxes
    chunk = 16384
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(dirs) > 1e-9, 1.0 / dirs, np.inf).astype(np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        o = origins[s:e, None, :]
        iv = inv[s:e, None, :]
        t0 = (boxes[None, :, 0:3] - o) * iv
        t1 = (boxes[None, :, 3:6] - o) * iv
        tmin = np.minimum(t0, t1).max(axis=2)
        tmax = np.maximum(t0, t1).min(axis=2)
        ok = (tmax >= tmin) & (tmax > 0.1) & (tmin < max_range)
        tmin = np.where(tmin > 0.1, tmin, np.inf)
        tmin = np.where(ok, tmin, np.inf)
        t_best[s:e] = np.minimum(t_best[s:e], tmin.min(axis=1))
    return np.where(t_best <= max_range, t_best, np.inf)


def simulate_scan(
    world: World,
    pose: np.ndarray,
    rays: Optional[np.ndarray] = None,
    max_range: float = 120.0,
    noise_std: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """One scan from the world-frame sensor pose (4,4): (M,4) xyz + intensity
    in the sensor frame, as a KITTI velodyne .bin holds it."""
    if rays is None:
        rays = hdl64_rays()
    rot, t = pose[:3, :3].astype(np.float32), pose[:3, 3].astype(np.float32)
    world_dirs = rays @ rot.T
    origins = np.broadcast_to(t, world_dirs.shape)
    dist = _raycast(origins, world_dirs, world, max_range)
    hit = np.isfinite(dist)
    rng = np.random.default_rng(seed)
    dist_noisy = dist[hit] + rng.normal(0.0, noise_std, size=hit.sum()).astype(np.float32)
    pts_sensor = rays[hit] * dist_noisy[:, None]
    inten = np.full((hit.sum(), 1), 0.5, np.float32)
    return np.concatenate([pts_sensor.astype(np.float32), inten], axis=1)


def circle_trajectory(n_poses: int, step: float = 1.0, z: float = 1.73, radius: float = 24.5) -> np.ndarray:
    """(n,4,4) circular drive, yaw along the tangent, `step` m between poses."""
    ang = np.arange(n_poses) * step / radius
    poses = np.zeros((n_poses, 4, 4), np.float32)
    for i, a in enumerate(ang):
        yaw = a + np.pi / 2
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.array(
            [[c, -s, 0, radius * np.cos(a)], [s, c, 0, radius * np.sin(a)], [0, 0, 1, z], [0, 0, 0, 1]],
            np.float32,
        )
    return poses
