"""Closed-form batched 3x3 symmetric eigendecomposition (port of
`lv_slam_tpu.ops.linalg3`).

Eigenvalues come from the trigonometric (Cardano) formula, eigenvectors from
the double-cross-product method, in ascending order like `torch.linalg.eigh`.
This is the plain version; `csrc/linalg3.cuh` holds the same algorithm as a
`__device__` function that the voxel-map kernel calls per leaf. Keep the two
in step: the thresholds (`near_iso`, the `arccos` clip, the 1e-20/1e-12
degenerate fallbacks, `_orthogonal_to`'s 0.9 pick) are the reference's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true float32 division on every device, as XLA divides in
    the reference's eigh. (Torch's CUDA division by a Python scalar
    multiplies by its reciprocal instead, which rounds differently.)"""
    return x / x.new_full((), c)


def eigh3x3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (..., 3, 3) symmetric -> (evals (..., 3) ascending, evecs (..., 3, 3)),
    evecs columns matching evals."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]

    tr = a00 + a11 + a22
    q = _div(tr, 3.0)
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p_sq = _div(b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12), 6.0)
    p = torch.sqrt(torch.clamp(p_sq, min=0.0))
    near_iso = p < 1e-12 * (1.0 + torch.abs(q))
    p_safe = torch.where(near_iso, 1.0, p)

    c00, c01, c02 = b00 / p_safe, a01 / p_safe, a02 / p_safe
    c11, c12, c22 = b11 / p_safe, a12 / p_safe, b22 / p_safe
    det = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    phi = _div(torch.arccos(torch.clamp(det * 0.5, -1.0, 1.0)), 3.0)

    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = tr - lam0 - lam2
    evals = torch.stack([lam0, lam1, lam2], dim=-1)
    evals = torch.where(near_iso[..., None], torch.stack([q, q, q], dim=-1), evals)

    def prod_cols(lj, lk):
        # columns of M = (A - lj I)(A - lk I), each (..., 3)
        d0j, d1j, d2j = a00 - lj, a11 - lj, a22 - lj
        d0k, d1k, d2k = a00 - lk, a11 - lk, a22 - lk
        m00 = d0j * d0k + a01 * a01 + a02 * a02
        m10 = a01 * d0k + d1j * a01 + a12 * a02
        m20 = a02 * d0k + a12 * a01 + d2j * a02
        m01 = d0j * a01 + a01 * d1k + a02 * a12
        m11 = a01 * a01 + d1j * d1k + a12 * a12
        m21 = a02 * a01 + a12 * d1k + d2j * a12
        m02 = d0j * a02 + a01 * a12 + a02 * d2k
        m12 = a01 * a02 + d1j * a12 + a12 * d2k
        m22 = a02 * a02 + a12 * a12 + d2j * d2k
        return torch.stack(
            [
                torch.stack([m00, m10, m20], dim=-1),
                torch.stack([m01, m11, m21], dim=-1),
                torch.stack([m02, m12, m22], dim=-1),
            ],
            dim=-2,
        )  # (..., 3 cols, 3)

    def best_col(cols):
        norms = torch.sum(cols * cols, dim=-1)
        pick = torch.argmax(norms, dim=-1)
        v = torch.gather(cols, -2, pick[..., None, None].expand(pick.shape + (1, 3)))[..., 0, :]
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        small = n[..., 0] < 1e-20
        return v / torch.clamp(n, min=1e-20), small

    v0, deg0 = best_col(prod_cols(lam1, lam2))
    v2, deg2 = best_col(prod_cols(lam0, lam1))
    ex = torch.zeros_like(v0)
    ex[..., 0] = 1.0
    v0 = torch.where((deg0 | near_iso)[..., None], ex, v0)
    alt2 = _orthogonal_to(v0)
    v2 = torch.where((deg2 | near_iso)[..., None], alt2, v2)
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    n2 = torch.sqrt(torch.sum(v2 * v2, dim=-1, keepdim=True))
    v2 = torch.where(n2 < 1e-12, _orthogonal_to(v0), v2 / torch.clamp(n2, min=1e-12))
    v1 = torch.linalg.cross(v2, v0, dim=-1)

    evecs = torch.stack([v0, v1, v2], dim=-1)  # columns
    return evals, evecs


def _orthogonal_to(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to v (branch-free)."""
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v)
    ey[..., 1] = 1.0
    pick_ey = torch.abs(v[..., 0]) > 0.9
    base = torch.where(pick_ey[..., None], ey, ex)
    w = base - torch.sum(base * v, dim=-1, keepdim=True) * v
    n = torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True))
    return w / torch.clamp(n, min=1e-20)
