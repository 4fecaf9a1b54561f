"""Pose-graph factor residuals (port of `lv_slam_tpu.graph.factors`).

The SE3 edge follows `g2o::EdgeSE3` (`graph_slam.cpp:136-147`): error =
[t, 2 q_xyz] of delta = Z^-1 (Ti^-1 Tj), with the unit quaternion's w >= 0.
The factor 2 makes the rotation block approximate the rotation vector, so
the reference's sigma_q keeps its published meaning. The unary priors are
g2o's `EdgeSE3PriorXYZ` / `PriorXY` / `PriorQuat` / `PriorVec` and the
reference's legacy floor prior; the plane vertex is [n, d] with |n| = 1,
updated in a smooth tangent basis at n (`plane_oplus`), and the plane
factors are `EdgeSE3Plane`, `EdgePlaneIdentity` / `Parallel` /
`Perpendicular` / `PriorNormal` / `PriorDistance`, each as the reference
writes it. Every function is batched over leading dimensions and
differentiable by `torch.func.jvp` (the sign choices are constants, as
under `jax.jacfwd`).
"""

from __future__ import annotations

import torch

from lv_slam_tpu_torch.core import se3


def se3_edge_residual(t_i: torch.Tensor, t_j: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """(..., 6) EdgeSE3 error of poses (..., 4, 4) under measurement (..., 4, 4)."""
    delta = se3.inverse(meas) @ se3.inverse(t_i) @ t_j
    q = se3.quat_from_matrix(delta[..., :3, :3])
    return torch.cat([delta[..., :3, 3], 2.0 * q[..., 1:]], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _sign(x: torch.Tensor) -> torch.Tensor:
    """-1 where x < 0, else 1 (a constant under differentiation)."""
    return torch.where(x.detach() < 0, -1.0, 1.0).to(x.dtype)


def prior_xyz_residual(t_i: torch.Tensor, meas_xyz: torch.Tensor) -> torch.Tensor:
    return t_i[..., :3, 3] - meas_xyz


def prior_xy_residual(t_i: torch.Tensor, meas_xy: torch.Tensor) -> torch.Tensor:
    return t_i[..., :2, 3] - meas_xy


def prior_quat_residual(t_i: torch.Tensor, meas_quat_wxyz: torch.Tensor) -> torch.Tensor:
    """2 (q_i^-1 q_meas).xyz, sign-fixed to the hemisphere of its w."""
    q_i = se3.quat_from_matrix(t_i[..., :3, :3])
    w1, v1 = q_i[..., 0], -q_i[..., 1:]
    w2, v2 = meas_quat_wxyz[..., 0], meas_quat_wxyz[..., 1:]
    w = w1 * w2 - _dot(v1, v2)
    v = w1[..., None] * v2 + w2[..., None] * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return 2.0 * (v * _sign(w)[..., None])


def prior_vec_residual(t_i: torch.Tensor, meas_world: torch.Tensor, meas_local: torch.Tensor) -> torch.Tensor:
    """R_i^T v_world - v_local (the gravity direction prior)."""
    return torch.einsum("...ji,...j->...i", t_i[..., :3, :3], meas_world) - meas_local


def se3_plane_residual(t_i: torch.Tensor, meas_coeffs: torch.Tensor) -> torch.Tensor:
    """(4,) legacy floor prior: the global plane z = 0 in the sensor frame
    (normal R^T e_z, distance t_z) against the measured [n, d], the
    measurement's sign aligned to the prediction."""
    n_local = t_i[..., 2, :3]
    d_local = t_i[..., 2, 3]
    n_meas = meas_coeffs[..., :3]
    n_meas = n_meas / torch.clamp(_norm(n_meas), min=1e-9)[..., None]
    sign = _sign(_dot(n_local, n_meas))
    return torch.cat([n_local - sign[..., None] * n_meas, (d_local - sign * meas_coeffs[..., 3])[..., None]], dim=-1)


def plane_normalize(p: torch.Tensor) -> torch.Tensor:
    """Scale (..., 4) coefficients so the normal has unit length."""
    return p / torch.clamp(_norm(p[..., :3]), min=1e-9)[..., None]


def plane_tangent_basis(n: torch.Tensor):
    """Two unit vectors spanning the tangent space at the unit normal n
    (smooth except at n ~ +-x; floor normals live near +z)."""
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    b1 = e_x - n * n[..., 0:1]
    b1 = b1 / torch.clamp(_norm(b1), min=1e-9)[..., None]
    return b1, torch.linalg.cross(n, b1, dim=-1)


def plane_oplus(p: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """3-dof tangent update: two normal-rotation components, then the
    distance increment."""
    p = plane_normalize(p)
    n = p[..., :3]
    b1, b2 = plane_tangent_basis(n)
    n_new = n + delta[..., 0:1] * b1 + delta[..., 1:2] * b2
    n_new = n_new / torch.clamp(_norm(n_new), min=1e-9)[..., None]
    return torch.cat([n_new, (p[..., 3] + delta[..., 2])[..., None]], dim=-1)


def plane_ominus(p_a: torch.Tensor, p_b: torch.Tensor) -> torch.Tensor:
    """(..., 3) minimal difference a (-) b: b's normal in a's tangent basis,
    and a's distance minus b's."""
    a = plane_normalize(p_a)
    b = plane_normalize(p_b)
    b1, b2 = plane_tangent_basis(a[..., :3])
    return torch.stack([_dot(b[..., :3], b1), _dot(b[..., :3], b2), a[..., 3] - b[..., 3]], dim=-1)


def plane_transform(t_inv_of: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plane p in the frame of pose T: n_local = R^T n, d_local = d + n . t."""
    n = p[..., :3]
    n_local = torch.einsum("...ji,...j->...i", t_inv_of[..., :3, :3], n)
    return torch.cat([n_local, (p[..., 3] + _dot(n, t_inv_of[..., :3, 3]))[..., None]], dim=-1)


def se3_plane_shared_residual(t_i: torch.Tensor, plane: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """(..., 3) `EdgeSE3Plane` error: the shared plane in the keyframe's
    frame, ominus the locally measured coefficients."""
    return plane_ominus(plane_transform(t_i, plane), meas)


def plane_identity_residual(p1: torch.Tensor, p2: torch.Tensor, meas4: torch.Tensor) -> torch.Tensor:
    a = plane_normalize(p1)
    b = plane_normalize(p2)
    b = b * _sign(_dot(a, b))[..., None]
    return (b - a) - meas4


def plane_parallel_residual(p1: torch.Tensor, p2: torch.Tensor, meas3: torch.Tensor) -> torch.Tensor:
    n1 = plane_normalize(p1)[..., :3]
    n2 = plane_normalize(p2)[..., :3]
    n2 = n2 * _sign(_dot(n1, n2))[..., None]
    return (n2 - n1) - meas3


def plane_perpendicular_residual(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """The normals' dot product (the reference ignores its measurement)."""
    return _dot(plane_normalize(p1)[..., :3], plane_normalize(p2)[..., :3])[..., None]


def plane_prior_normal_residual(p: torch.Tensor, meas3: torch.Tensor) -> torch.Tensor:
    n = plane_normalize(p)[..., :3]
    n = n * _sign(_dot(n, meas3))[..., None]
    return n - meas3


def plane_prior_distance_residual(p: torch.Tensor, meas_d: torch.Tensor) -> torch.Tensor:
    return (meas_d - plane_normalize(p)[..., 3])[..., None]


def huber_weight(chi: torch.Tensor, delta) -> torch.Tensor:
    """Huber IRLS weight on chi = sqrt(r^T Omega r): 1 inside, delta/chi
    outside (g2o RobustKernelHuber)."""
    return torch.where(chi <= delta, 1.0, delta / torch.clamp(chi, min=1e-12))


def robust_weight(kind: str, chi: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights of the robust kernels the reference exposes
    (`launch/dlo_lfa_ggo_kitti.launch:129`; only Huber is used)."""
    kind = (kind or "NONE").upper()
    d = torch.tensor(delta, dtype=torch.float32, device=chi.device)
    safe = torch.clamp(chi, min=1e-12)
    if kind == "NONE":
        return torch.ones_like(chi)
    if kind == "HUBER":
        return huber_weight(chi, d)
    if kind == "CAUCHY":
        return 1.0 / (1.0 + (safe / d) ** 2)
    if kind in ("PSEUDOHUBER", "PSEUDO_HUBER"):
        return 1.0 / torch.sqrt(1.0 + (safe / d) ** 2)
    if kind == "FAIR":
        return 1.0 / (1.0 + safe / d)
    if kind in ("GEMANMCCLURE", "GM"):
        return 1.0 / (1.0 + (safe / d) ** 2) ** 2
    if kind == "WELSCH":
        return torch.exp(-((safe / d) ** 2))
    if kind == "TUKEY":
        return torch.where(safe <= d, (1.0 - (safe / d) ** 2) ** 2, 0.0)
    if kind == "SATURATED":
        return torch.clamp((d / safe) ** 2, max=1.0)
    if kind == "DCS":
        return torch.clamp(2.0 * d / (d + safe**2), max=1.0)
    raise ValueError(f"unknown robust kernel {kind!r}")
