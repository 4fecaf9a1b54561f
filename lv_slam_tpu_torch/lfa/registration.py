"""Feature registration: point-to-line / point-to-plane Gauss-Newton (port of
`lv_slam_tpu.lfa.registration`).

- `lines_from_2nn` / `planes_from_3nn` (the scan-to-scan odometry's
  correspondences: the line through the 2 nearest, the plane through the 3
  nearest of the previous scan's features in a `KnnGrid`) are kernel 9k's
  line and plane entries (`csrc/knn_grid.cu`) on CUDA tensors and
  `lines_from_2nn_ref` / `planes_from_3nn_ref` on CPU tensors. Both round
  the norms, the cross product and the plane offset as XLA's CPU fma chains
  round the reference's (`ops.linalg3.fma32`).
- `lines_from_fit` / `planes_from_fit` are radius-gated eigen fits. On a
  `CellTable` (the device-resident mapping's maps) they are kernel 10
  (`csrc/lfa_fit.cu`) on CUDA tensors, over the 8-cell probe; on a sorted
  `KnnGrid` kernel 10g (same file), over the k nearest of K9k's search,
  each gated at a distance below 1 m. `lines_from_fit_ref` /
  `planes_from_fit_ref` are the plain versions of both branches on CPU
  tensors. The twins sum the candidates in candidate order, as the kernels
  do, so the two agree on every accept decision.
- `gn_solve` is kernel 11 (`csrc/lfa_gn.cu`) on CUDA tensors and
  `gn_solve_ref` on CPU tensors: all iterations in one launch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr
from lv_slam_tpu_torch.lfa.features import _sum3
from lv_slam_tpu_torch.ops.knn import MAX_K, KNN_KERNEL, CellTable, KnnGrid, candidates_cell, check_grid, knn_ref
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, eigh3x3, fma32, sqrt32

_DIST_SQ_THRESH = 25.0  # correspondence gate, A-LOAM's 25 m^2

LINES_KERNEL = Kernel(
    "lines_from_fit",
    source="lv_slam_tpu_torch/csrc/lfa_fit.cu",
    replaces="lv_slam_tpu/lfa/registration.py:58",
    entries={"lvs_lines_from_fit": [PTR, PTR, I32, PTR, I32, I32, F32, I32, PTR, PTR, PTR]},
)
PLANES_KERNEL = Kernel(
    "planes_from_fit",
    source="lv_slam_tpu_torch/csrc/lfa_fit.cu",
    replaces="lv_slam_tpu/lfa/registration.py:111",
    entries={"lvs_planes_from_fit": [PTR, PTR, I32, PTR, I32, I32, F32, I32, PTR, PTR, PTR]},
)
GRID_FITS_KERNEL = Kernel(
    "grid_fits",
    source="lv_slam_tpu_torch/csrc/lfa_fit.cu",
    replaces="lv_slam_tpu/lfa/registration.py:73",
    entries={
        # keys, xyz, n, origin, cell, queries, mask, q, k -> (mu, v | n, d), valid
        "lvs_grid_lines_from_fit": [PTR, PTR, I32, PTR, F32, PTR, PTR, I32, I32, PTR, PTR, PTR],
        "lvs_grid_planes_from_fit": [PTR, PTR, I32, PTR, F32, PTR, PTR, I32, I32, PTR, PTR, PTR],
    },
)
GN_KERNEL = Kernel(
    "gn_solve",
    source="lv_slam_tpu_torch/csrc/lfa_gn.cu",
    replaces="lv_slam_tpu/lfa/registration.py:156",
    entries={"lvs_gn_solve": [PTR, PTR, PTR, PTR, PTR, I32, PTR, PTR, PTR, PTR, I32, I32, PTR]},
)


class LineField(NamedTuple):
    """Per-source-feature line correspondence (point mu, direction v)."""

    mu: torch.Tensor     # (N,3)
    v: torch.Tensor      # (N,3) unit
    valid: torch.Tensor  # (N,)


class PlaneField(NamedTuple):
    """Per-source-feature plane correspondence (unit normal n, offset d)."""

    n: torch.Tensor      # (N,3)
    d: torch.Tensor      # (N,)
    valid: torch.Tensor  # (N,)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in index order from +0.0, the kernel's order."""
    acc = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _candidates(y: torch.Tensor, grid, k: int):
    """(points (Q,K,3), use (Q,K)): on a `CellTable` the 8-cell candidates
    within 1 m (squared distance summed as kernel 10 sums it); on a
    `KnnGrid` the k nearest within 1 m (the reference gates the distance)."""
    if isinstance(grid, CellTable):
        pts, cand_ok = candidates_cell(grid, y)
        d = y[:, None, :] - pts
        return pts, cand_ok & (_sum3(d * d) < 1.0)
    dists, pts, valid = knn_ref(grid, y, k)
    return pts, valid & (dists < 1.0)


def _fit(pts: torch.Tensor, use: torch.Tensor):
    """(n_use, pts zeroed outside the gate, mu, cov) over the candidates,
    summed in candidate order."""
    w = use.to(torch.float32)
    n_use = _ordered_sum(w)
    cnt = torch.clamp(n_use, min=1.0)
    pts = torch.where(use[..., None], pts, 0.0)
    mu = _ordered_sum(pts) / cnt[:, None]
    c = (pts - mu[:, None, :]) * w[..., None]
    cov = _ordered_sum(c[..., :, None] * c[..., None, :]) / cnt[:, None, None]
    return n_use, pts, mu, cov


def lines_from_fit_ref(y: torch.Tensor, mask: torch.Tensor, grid, k: int = 5) -> LineField:
    """Plain PyTorch version of `lines_from_fit`."""
    n_use, _, mu, cov = _fit(*_candidates(y, grid, k))
    evals, evecs = eigh3x3(cov)
    ok = mask & (n_use >= k) & (evals[:, 2] > 3.0 * torch.clamp(evals[:, 1], min=1e-12))
    return LineField(mu=mu, v=evecs[:, :, 2], valid=ok)


def planes_from_fit_ref(y: torch.Tensor, mask: torch.Tensor, grid, k: int = 5) -> PlaneField:
    """Plain PyTorch version of `planes_from_fit`."""
    pts, use = _candidates(y, grid, k)
    n_use, pts, mu, cov = _fit(pts, use)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    _, evecs = eigh3x3(cov + 1e-9 * eye)
    n_hat = evecs[:, :, 0]
    d = -_sum3(n_hat * mu)
    resid = torch.abs(_sum3(pts * n_hat[:, None, :]) + d[:, None])
    finite = torch.all(torch.isfinite(n_hat), dim=1) & torch.isfinite(d)
    flat_enough = torch.all(torch.where(use, resid, 0.0) < 0.2, dim=1)
    ok = mask & (n_use >= k) & flat_enough & finite
    n_hat = torch.where(ok[:, None] & torch.isfinite(n_hat), n_hat, 0.0)
    d = torch.where(ok & torch.isfinite(d), d, 0.0)
    return PlaneField(n=n_hat, d=d, valid=ok)


# kernel 10's (CellTable) and 10g's (KnnGrid) entry of each fit
_FIT_ENTRIES = {
    "lines": ((LINES_KERNEL, "lvs_lines_from_fit"), (GRID_FITS_KERNEL, "lvs_grid_lines_from_fit")),
    "planes": ((PLANES_KERNEL, "lvs_planes_from_fit"), (GRID_FITS_KERNEL, "lvs_grid_planes_from_fit")),
}


def _fit_kernel(fit: str, second: tuple, y, mask, grid, k: int):
    """Launches kernel 10 (on a `CellTable`) or 10g (on a `KnnGrid`) for
    `fit`; returns (Q,3) floats, `second`-shaped floats, valid."""
    q = y.shape[0]
    y, mask = y.contiguous(), mask.contiguous()
    table = isinstance(grid, CellTable)
    kernel, entry = _FIT_ENTRIES[fit][0 if table else 1]
    if table:
        check_cuda(kernel.name, y, mask, grid.table)
    else:
        if not 1 <= k <= MAX_K:
            raise ValueError(f"{kernel.name}: k must be in [1, {MAX_K}], got {k}")
        check_grid(kernel.name, grid, y, mask)
    check_dtype(kernel.name, y, torch.float32, (q, 3))
    check_dtype(kernel.name, mask, torch.bool, (q,))
    out3 = torch.empty((q, 3), dtype=torch.float32, device=y.device)
    second = torch.empty((q, *second), dtype=torch.float32, device=y.device)
    valid = torch.empty((q,), dtype=torch.bool, device=y.device)
    if table:
        kernel.call(entry, ptr(y), ptr(mask), q, ptr(grid.table), grid.table.shape[0], grid.slots, grid.cell_size,
                    k, ptr(out3), ptr(second), ptr(valid))
    else:
        kernel.call(entry, ptr(grid.keys), ptr(grid.xyz), grid.keys.shape[0], ptr(grid.origin_cell),
                    grid.cell_size, ptr(y), ptr(mask), q, k, ptr(out3), ptr(second), ptr(valid))
    kernel.launches += 1
    return out3, second, valid


def lines_from_fit(y: torch.Tensor, mask: torch.Tensor, grid, k: int = 5) -> LineField:
    """Mapping-style line fit to the map edge points within 1 m of each query
    (every candidate of a `CellTable`'s probe, the k nearest on a
    `KnnGrid`); accepted with >= k of them and lambda2 > 3 lambda1. Kernel
    10 or 10g on CUDA, the plain version on CPU."""
    if y.device.type == "cpu":
        return lines_from_fit_ref(y, mask, grid, k)
    mu, v, valid = _fit_kernel("lines", (3,), y, mask, grid, k)
    return LineField(mu=mu, v=v, valid=valid)


def planes_from_fit(y: torch.Tensor, mask: torch.Tensor, grid, k: int = 5) -> PlaneField:
    """Mapping-style plane fit (smallest-eigenvalue normal of the map surf
    points within 1 m, as `lines_from_fit` takes them); accepted with >= k
    of them, all within 0.2 m of the plane. Kernel 10 or 10g on CUDA, the
    plain version on CPU."""
    if y.device.type == "cpu":
        return planes_from_fit_ref(y, mask, grid, k)
    n, d, valid = _fit_kernel("planes", (), y, mask, grid, k)
    return PlaneField(n=n, d=d, valid=valid)


def grid_fit_error(got, want, y: torch.Tensor, grid: KnnGrid, k: int = 5) -> Tuple[float, float, int, int]:
    """Kernel 10g's fields `got` against its plain version's `want` (both
    LineFields or both PlaneFields of queries y on `grid`), judged as
    `ops.gicp` judges plane covariances: over the accepted queries whose k
    nearest within 1 m have a relative eigen-gap g = (lambda1 - lambda0) /
    lambda2 above GAP_SPLIT, the largest difference of the fitted floats and
    its largest product with g (a frame moves as 1 / g); the accepted
    queries at or below the split, whose frame is noise in every
    implementation, are only counted. Returns (max difference, max
    difference x g, queries compared, queries at the split)."""
    from lv_slam_tpu_torch.ops.gicp import GAP_SPLIT, eigen_gap

    dists, pts, valid = knn_ref(grid, y, k)
    g = eigen_gap(pts, valid & (dists < 1.0))
    ok = want.valid.cpu()
    sel = ok & (g > GAP_SPLIT)
    d = torch.maximum((got[0] - want[0]).abs().amax(dim=1), (got[1] - want[1]).abs().reshape(y.shape[0], -1)
                      .amax(dim=1)).cpu().double()
    n = int(sel.sum())
    return (float(d[sel].max()) if n else 0.0, float((d * g)[sel].max()) if n else 0.0, n,
            int((ok & ~sel).sum()))


def lines_from_2nn_ref(y: torch.Tensor, mask: torch.Tensor, grid: KnnGrid) -> LineField:
    """Plain PyTorch version of `lines_from_2nn`."""
    dists, pts, valid = knn_ref(grid, y, 2)
    a = pts[:, 0]
    ab = pts[:, 1] - a
    norm = sqrt32(dot3_fma(ab, ab))
    ok = (
        mask & valid[:, 0] & valid[:, 1]
        & (dists[:, 0] * dists[:, 0] < _DIST_SQ_THRESH) & (norm > 1e-3)
    )
    return LineField(mu=a, v=ab / torch.clamp(norm, min=1e-9)[:, None], valid=ok)


def _cross_fma(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u x w as XLA contracts `jnp.cross` on the CPU: fma(u1, w2, -(u2 w1)), ..."""
    return torch.stack(
        [
            fma32(u[:, 1], w[:, 2], -(u[:, 2] * w[:, 1])),
            fma32(u[:, 2], w[:, 0], -(u[:, 0] * w[:, 2])),
            fma32(u[:, 0], w[:, 1], -(u[:, 1] * w[:, 0])),
        ],
        dim=1,
    )


def planes_from_3nn_ref(y: torch.Tensor, mask: torch.Tensor, grid: KnnGrid) -> PlaneField:
    """Plain PyTorch version of `planes_from_3nn`."""
    dists, pts, valid = knn_ref(grid, y, 3)
    a = pts[:, 0]
    n = _cross_fma(pts[:, 1] - a, pts[:, 2] - a)
    norm = sqrt32(dot3_fma(n, n))
    ok = (
        mask & torch.all(valid, dim=1)
        & (dists[:, 0] * dists[:, 0] < _DIST_SQ_THRESH) & (norm > 1e-3)
    )
    n_hat = n / torch.clamp(norm, min=1e-9)[:, None]
    return PlaneField(n=n_hat, d=-dot3_fma(n_hat, a), valid=ok)


def _nn_kernel(entry: str, second: tuple, y: torch.Tensor, mask: torch.Tensor, grid: KnnGrid):
    """Launches a kernel-9k correspondence entry; returns (Q,3) floats,
    `second`-shaped floats, valid."""
    q = y.shape[0]
    y, mask = y.contiguous(), mask.contiguous()
    check_grid(entry, grid, y, mask)
    check_dtype(entry, y, torch.float32, (q, 3))
    check_dtype(entry, mask, torch.bool, (q,))
    out3 = torch.empty((q, 3), dtype=torch.float32, device=y.device)
    second = torch.empty((q, *second), dtype=torch.float32, device=y.device)
    valid = torch.empty((q,), dtype=torch.bool, device=y.device)
    KNN_KERNEL.call(
        entry, ptr(grid.keys), ptr(grid.xyz), grid.keys.shape[0], ptr(grid.origin_cell), grid.cell_size,
        ptr(y), ptr(mask), q, ptr(out3), ptr(second), ptr(valid),
    )
    KNN_KERNEL.launches += 1
    return out3, second, valid


def lines_from_2nn(y: torch.Tensor, mask: torch.Tensor, grid: KnnGrid) -> LineField:
    """Odometry-style: the 2 nearest target edge points span the line;
    accepted when both exist, the nearest within 5 m and the two more than
    1 mm apart. Kernel 9k on CUDA, the plain version on CPU."""
    if y.device.type == "cpu":
        return lines_from_2nn_ref(y, mask, grid)
    mu, v, valid = _nn_kernel("lvs_lines_from_2nn", (3,), y, mask, grid)
    return LineField(mu=mu, v=v, valid=valid)


def planes_from_3nn(y: torch.Tensor, mask: torch.Tensor, grid: KnnGrid) -> PlaneField:
    """Odometry-style: the plane through the 3 nearest target surf points;
    accepted when all three exist, the nearest within 5 m and the normal's
    cross product longer than 1e-3. Kernel 9k on CUDA, the plain version on
    CPU."""
    if y.device.type == "cpu":
        return planes_from_3nn_ref(y, mask, grid)
    n, d, valid = _nn_kernel("lvs_planes_from_3nn", (), y, mask, grid)
    return PlaneField(n=n, d=d, valid=valid)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b with one rounding per product and per difference (the kernel's)."""
    return torch.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        dim=1,
    )


def gn_solve_ref(
    transform: torch.Tensor,
    edges: torch.Tensor,
    lines: LineField,
    surfs: torch.Tensor,
    planes: PlaneField,
    iters: int,
) -> torch.Tensor:
    """Plain PyTorch version of `gn_solve`."""
    # zero invalid lanes before the nonlinear ops: sentinel points (~1e6)
    # overflow float32 when squared, and inf/nan would poison J^T W J
    e_pts = torch.where(lines.valid[:, None], edges, 0.0)
    mu = torch.where(lines.valid[:, None], lines.mu, 0.0)
    w_e = lines.valid.to(torch.float32)
    s_pts = torch.where(planes.valid[:, None], surfs, 0.0)
    d = torch.where(planes.valid, torch.clamp(planes.d, -1e4, 1e4), 0.0)
    w_s = planes.valid.to(torch.float32)
    eye6 = torch.eye(6, dtype=transform.dtype, device=transform.device)
    t = transform
    for _ in range(iters):
        ye = se3.transform_points(t, e_pts)
        c = _cross(ye - mu, lines.v)
        r_e = torch.sqrt(_sum3(c * c) + 1e-12)
        g_e = _cross(lines.v, c / r_e[:, None])
        j_e = torch.cat([g_e, _cross(ye, g_e)], dim=1)
        ys = se3.transform_points(t, s_pts)
        r_s = _sum3(ys * planes.n) + d
        j_s = torch.cat([planes.n, _cross(ys, planes.n)], dim=1)
        r = torch.cat([r_e, r_s])
        jac = torch.cat([j_e, j_s], dim=0)
        ar = torch.abs(r)
        huber = torch.where(ar > 0.1, 0.1 / torch.clamp(ar, min=1e-9), 1.0)
        w = torch.cat([w_e, w_s]) * huber
        h = torch.einsum("na,nb->ab", jac * w[:, None], jac)
        g = torch.einsum("na,n->a", jac, w * r)
        ridge = 1e-4 * torch.trace(h) / 6.0 + 1e-9
        delta, _ = torch.linalg.solve_ex(h + ridge * eye6, -g)
        ok = torch.all(torch.isfinite(delta))
        delta = torch.where(ok, delta, 0.0)
        t = se3.exp_se3(delta) @ t
    return t


def gn_solve(
    transform: torch.Tensor,
    edges: torch.Tensor,
    lines: LineField,
    surfs: torch.Tensor,
    planes: PlaneField,
    iters: int,
) -> torch.Tensor:
    """GN iterations on frozen correspondences; returns the updated (4,4).

    Jacobians are closed-form in the left perturbation `exp(d) T` with
    tangent [rho, phi]: point-to-plane r = n.y + d, J = [n, y x n];
    point-to-line r = |(y - mu) x v|, J = [g, y x g] with g = v x (c / r).
    Kernel 11 on CUDA, the plain version on CPU."""
    if transform.device.type == "cpu":
        return gn_solve_ref(transform, edges, lines, surfs, planes, iters)
    ne, ns = edges.shape[0], surfs.shape[0]
    args = [
        transform, edges, lines.mu, lines.v, lines.valid, surfs, planes.n, planes.d, planes.valid,
    ]
    args = [a.contiguous() for a in args]
    check_cuda("gn_solve", *args)
    for a, shape in zip(args, [(4, 4), (ne, 3), (ne, 3), (ne, 3), (ne,), (ns, 3), (ns, 3), (ns,), (ns,)]):
        check_dtype("gn_solve", a, torch.bool if a.dtype == torch.bool else torch.float32, shape)
    out = torch.empty((4, 4), dtype=torch.float32, device=transform.device)
    t0, e, lmu, lv, lval, s, pn, pd, pval = args
    GN_KERNEL.call(
        "lvs_gn_solve", ptr(t0), ptr(e), ptr(lmu), ptr(lv), ptr(lval), ne, ptr(s), ptr(pn), ptr(pd),
        ptr(pval), ns, iters, ptr(out),
    )
    GN_KERNEL.launches += 1
    return out


def match_counts(lines: LineField, planes: PlaneField) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.sum(lines.valid.to(torch.int32)),
        torch.sum(planes.valid.to(torch.int32)),
    )
