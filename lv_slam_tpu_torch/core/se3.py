"""SE(3)/SO(3) Lie-group operations in PyTorch (port of `lv_slam_tpu.core.se3`).

Sophus semantics: the se(3) tangent is ``[rho, phi]`` (translation first,
rotation last); ``exp([rho, phi]) = (exp(phi), V(phi) rho)``. Everything is
float32 and batched over leading dimensions, with the reference's Taylor
guard near the identity.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_SMALL_ANGLE = 1e-4


def skew(v: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,3,3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_factors(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with the
    small-angle Taylor branch below theta = 1e-4."""
    small = theta_sq < _SMALL_ANGLE * _SMALL_ANGLE
    safe_tsq = torch.where(small, 1.0, theta_sq)
    safe_t = torch.sqrt(safe_tsq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_tsq)
    c = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (safe_t - torch.sin(safe_t)) / (safe_tsq * safe_t)
    )
    return a, b, c


def _eye3_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Angle-axis [...,3] -> rotation matrix [...,3,3] (Rodrigues)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_factors(theta_sq)
    k = skew(phi)
    return _eye3_like(k) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def log_so3(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [...,3,3] -> angle-axis [...,3], through the
    quaternion (stable near pi)."""
    return quat_log(quat_from_matrix(rot))


def exp_se3(tangent: torch.Tensor) -> torch.Tensor:
    """se(3) tangent [...,6] = [rho, phi] -> homogeneous transform [...,4,4]."""
    rho, phi = tangent[..., :3], tangent[..., 3:]
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, c = _sinc_factors(theta_sq)
    k = skew(phi)
    k2 = k @ k
    eye = _eye3_like(k)
    rot = eye + a[..., None, None] * k + b[..., None, None] * k2
    v = eye + b[..., None, None] * k + c[..., None, None] * k2
    t = torch.einsum("...ij,...j->...i", v, rho)
    return make_transform(rot, t)


def log_se3(transform: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform [...,4,4] -> se(3) tangent [...,6] = [rho, phi],
    with V^-1 = I - k/2 + (1/theta^2)(1 - A/(2B)) k^2 (Taylor-guarded)."""
    t = transform[..., :3, 3]
    phi = log_so3(transform[..., :3, :3])
    theta_sq = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_factors(theta_sq)
    k = skew(phi)
    small = theta_sq < _SMALL_ANGLE * _SMALL_ANGLE
    safe_tsq = torch.where(small, 1.0, theta_sq)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - a / (2.0 * b)) / safe_tsq)
    v_inv = _eye3_like(k) - 0.5 * k + coef[..., None, None] * (k @ k)
    rho = torch.einsum("...ij,...j->...i", v_inv, t)
    return torch.cat([rho, phi], dim=-1)


def identity(dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def make_transform(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """([...,3,3], [...,3]) -> [...,4,4]."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    # built on the device: a tensor made from a Python list is a blocking
    # host-to-device copy, one host sync per transform on a card
    bottom = torch.eye(4, dtype=rot.dtype, device=rot.device)[3]
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def inverse(transform: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse [...,4,4]."""
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    rot_t = rot.transpose(-1, -2)
    return make_transform(rot_t, -torch.einsum("...ij,...j->...i", rot_t, t))


def transform_points(transform: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply [...,4,4] to points [...,N,3]: ((x R[:,0] + y R[:,1]) + z R[:,2]) + t,
    one rounding per product and per sum, so the CPU, the card and the
    kernels that transform points themselves agree bit for bit (a matrix
    product's summation order and FMA use are the library's)."""
    rot = transform[..., None, :3, :3]
    t = transform[..., None, :3, 3]
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return ((x * rot[..., 0] + y * rot[..., 1]) + z * rot[..., 2]) + t


def transform_points_fma(transform: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply [...,4,4] to points [...,N,3] as the reference's compiled
    programs do on the CPU: XLA contracts `points @ R^T + t` (and the window
    einsum) into `fma(z, R2, fma(y, R1, x * R0)) + t`. Each fused step is
    taken in float64, where the product is exact, and rounded once to
    float32; the kernels that transform points use `fmaf`."""
    rot = transform[..., None, :3, :3].double()
    t = transform[..., None, :3, 3]
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    acc = x * transform[..., None, :3, 0]
    acc = (y.double() * rot[..., 1] + acc.double()).to(points.dtype)
    acc = (z.double() * rot[..., 2] + acc.double()).to(points.dtype)
    return acc + t


def orthonormalize(transform: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) via the quaternion: float32
    feedback loops that compose their own outputs (the odometry warm start)
    otherwise grow the orthonormality defect geometrically."""
    rot = quat_to_matrix(quat_from_matrix(transform[..., :3, :3]))
    return make_transform(rot, transform[..., :3, 3])


def quat_from_matrix(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [...,3,3] -> unit quaternion [...,4] (w,x,y,z), w >= 0.

    Shepperd's branch-free form: the candidate with the largest leading
    magnitude is picked (first one on ties, as `jnp.argmax`)."""
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [...,4 cand,4 comp]
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [...,4] (w,x,y,z) -> rotation matrix [...,3,3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [...,4] (w,x,y,z) -> angle-axis [...,3]."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vec = q[..., 1:]
    vec_norm = torch.linalg.norm(vec, dim=-1)
    angle = 2.0 * torch.atan2(vec_norm, w)
    small = vec_norm < _EPS
    scale = torch.where(small, 2.0 / torch.where(torch.abs(w) < _EPS, 1.0, w),
                        angle / torch.where(small, 1.0, vec_norm))
    return vec * scale[..., None]


def rotation_angle(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [...,3,3] -> rotation angle in [0, pi] (``2*acos(q.w)``,
    the reference's keyframe-gate quantity)."""
    q = quat_from_matrix(rot)
    return 2.0 * torch.arccos(torch.clamp(q[..., 0], -1.0, 1.0))
