"""Synthetic Velodyne-style LiDAR scans (numpy): the port's copy of the
parts of `lv_slam_tpu.io.synthetic` that drive the odometry workload.

A procedural urban world (ground plane, building boxes, poles) is ray-cast
with an HDL-64-like pattern along a circular, figure-8 or straight drive
with known ground truth (`make_sequence`: the fleet's and the entry's
sequences).
At 64 rings x 2000 azimuths a scan holds about 125k returns, the density of a
KITTI Velodyne scan. `render_camera_image` splats the same world into the
forward camera's 8-bit image, the input of the loop detector's ORB.
`tests/test_torch_io.py` holds the scans and the images equal to the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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


def vlp16_rays(n_rings: int = 16, n_azimuth: int = 900) -> np.ndarray:
    """VLP-16 vertical field: +-15 degrees."""
    return lidar_rays(n_rings, n_azimuth, 15.0, -15.0)


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


def circle_trajectory(n_poses: int, step: float = 1.0, z: float = 1.73, radius: float = 24.5,
                      laps: int = 1) -> np.ndarray:
    """(n,4,4) circular drive, yaw along the tangent, `step` m between poses;
    `laps > 1` shrinks the radius so the same travel goes round `laps` times
    (the multi-loop workload)."""
    if laps > 1:
        radius = n_poses * step / (2.0 * np.pi * laps)
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


def figure8_trajectory(n_poses: int, step: float = 1.0, z: float = 1.73,
                       radius: Optional[float] = None) -> np.ndarray:
    """(n,4,4) smooth figure-8-ish drive, yaw along the tangent, ~`step` m
    between poses; the default radius keeps the peak yaw rate near 0.05 rad
    per scan."""
    if radius is None:
        radius = max(n_poses * step / (4.0 * np.pi), 25.0)
    s = np.arange(n_poses) * step / radius
    x = radius * np.sin(s)
    y = radius * np.sin(s) * np.cos(s)
    yaw = np.arctan2(np.gradient(y), np.gradient(x))
    poses = np.zeros((n_poses, 4, 4), np.float32)
    for i in range(n_poses):
        c, si = np.cos(yaw[i]), np.sin(yaw[i])
        poses[i] = np.array([[c, -si, 0, x[i]], [si, c, 0, y[i]], [0, 0, 1, z], [0, 0, 0, 1]], np.float32)
    return poses


def straight_trajectory(n_poses: int, step: float = 1.0, z: float = 1.73) -> np.ndarray:
    """(n,4,4) straight drive along +x, `step` m between poses."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n_poses, 1, 1))
    poses[:, 0, 3] = np.arange(n_poses) * step
    poses[:, 2, 3] = z
    return poses


def make_sequence(
    n_scans: int,
    seed: int = 0,
    trajectory: str = "figure8",
    step: float = 1.0,
    n_rings: int = 64,
    n_azimuth: int = 900,
    noise_std: float = 0.01,
    max_elev_deg: float = 2.0,
    min_elev_deg: float = -24.8,
) -> Tuple[List[np.ndarray], np.ndarray, World]:
    """(scans [list of (M,4) sensor-frame], gt_poses (n,4,4), world)."""
    world = make_world(seed)
    trajectories = {"figure8": figure8_trajectory, "straight": straight_trajectory, "circle": circle_trajectory}
    if trajectory not in trajectories:
        raise ValueError(trajectory)
    poses = trajectories[trajectory](n_scans, step)
    rays = lidar_rays(n_rings, n_azimuth, max_elev_deg, min_elev_deg)
    scans = [simulate_scan(world, poses[i], rays, noise_std=noise_std, seed=seed + i) for i in range(n_scans)]
    return scans, poses, world


def render_camera_image(
    world: World,
    pose: np.ndarray,
    width: int = 256,
    height: int = 128,
    fov_deg: float = 90.0,
    seed: int = 0,
    points_per_box: int = 400,
) -> np.ndarray:
    """Crude textured splat renderer: a forward-facing pinhole camera sees
    points sampled on world surfaces (fixed per world seed, so the same place
    renders the same texture), z-buffered into an (H,W) uint8 image."""
    rng = np.random.default_rng(seed)
    pts = []
    intens = []
    for box in world.boxes:
        lo, hi = box[:3], box[3:]
        p = rng.uniform(lo, hi, size=(points_per_box, 3)).astype(np.float32)
        # push samples to the box surface on a random axis
        axis = rng.integers(0, 3, points_per_box)
        side = rng.integers(0, 2, points_per_box)
        p[np.arange(points_per_box), axis] = np.where(side == 0, lo[axis], hi[axis])
        pts.append(p)
        intens.append(rng.uniform(60, 255, size=points_per_box).astype(np.float32))
    pts = np.concatenate(pts)
    intens = np.concatenate(intens)

    rot, t = pose[:3, :3], pose[:3, 3]
    local = (pts - t) @ rot  # world -> sensor frame (x forward)
    # camera looks along +x; image x right (-y), image y down (-z)
    z = local[:, 0]
    vis = z > 0.5
    f = (width / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0)
    # a safe denominator for points at or behind the camera plane (masked
    # out below), whose projection would be inf / NaN before the int cast
    zs = np.where(vis, z, 1.0)
    u = (-local[:, 1] / zs * f + width / 2.0).astype(np.int32)
    v = (-local[:, 2] / zs * f + height / 2.0).astype(np.int32)
    vis &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
    img = np.full((height, width), 30.0, np.float32)
    ui, vi, zi, ii = u[vis], v[vis], z[vis], intens[vis]
    order = np.argsort(-zi)  # far first, near overwrites
    img[vi[order], ui[order]] = ii[order]
    return img.astype(np.uint8)
