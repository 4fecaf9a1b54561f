"""The NDT pieces the hash-table path shares with the reference's LUT/SoA pass
(port of `lv_slam_tpu.ops.ndt_soa`): the per-offset derivative terms and the
damped Newton loop. The LUT/SoA pass itself exists only for TPU gather
costs and is not ported."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.ops.ndt import GaussParams


def accumulate_ndt_terms(
    y: torch.Tensor,      # (3,N) transformed points
    row: torch.Tensor,    # (N,16) packed leaf attributes
    hit: torch.Tensor,    # (N,) leaf-hit mask
    gauss: GaussParams,
    weighted: bool,
    col0: int = 0,        # column of mu0 within the row (hash rows embed a key)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One neighborhood offset's (score, grad (6,), hess (6,6)) contribution;
    the plain version of kernel 4's per-point body (`csrc/ndt_hash.cu`).

    The Hessian is NOT symmetric (the T2 curvature block `y q^T - (q.y) I`
    is not), so all 36 entries are summed."""
    mu = row[:, col0:col0 + 3].T
    c00, c01, c02 = row[:, col0 + 3], row[:, col0 + 4], row[:, col0 + 5]
    c11, c12, c22 = row[:, col0 + 6], row[:, col0 + 7], row[:, col0 + 8]
    w_leaf = row[:, col0 + 9]

    d0, d1, d2_ = y[0] - mu[0], y[1] - mu[1], y[2] - mu[2]
    q0 = c00 * d0 + c01 * d1 + c02 * d2_
    q1 = c01 * d0 + c11 * d1 + c12 * d2_
    q2 = c02 * d0 + c12 * d1 + c22 * d2_
    md = d0 * q0 + d1 * q1 + d2_ * q2
    eterm = torch.exp(-0.5 * gauss.d2 * md)
    gate_val = gauss.d2 * eterm
    gate = hit & (gate_val <= 1.0) & (gate_val >= 0.0) & torch.isfinite(gate_val)
    w = torch.where(gate, w_leaf if weighted else 1.0, 0.0)

    score = torch.sum(w * (-gauss.d1 * eterm))
    f = w * (gauss.d1 * gauss.d2 * eterm)

    g3 = y[1] * q2 - y[2] * q1
    g4 = y[2] * q0 - y[0] * q2
    g5 = y[0] * q1 - y[1] * q0
    g6 = torch.stack([q0, q1, q2, g3, g4, g5])                # (6,N)

    grad = torch.einsum("n,in->i", f, g6)

    h1 = torch.einsum("n,in,jn->ij", -gauss.d2 * f, g6, g6)
    qy = q0 * y[0] + q1 * y[1] + q2 * y[2]
    q_st = torch.stack([q0, q1, q2])
    eye3 = torch.eye(3, dtype=y.dtype, device=y.device)
    t2 = torch.einsum("n,in,jn->ij", f, y, q_st) - torch.sum(f * qy) * eye3
    h2 = torch.zeros((6, 6), dtype=y.dtype, device=y.device)
    h2[3:, 3:] = t2

    # J^T C J = [[C, -CS], [SC, -SCS]] with S = skew(y), SC = -(CS)^T
    c = torch.stack([
        torch.stack([c00, c01, c02]),
        torch.stack([c01, c11, c12]),
        torch.stack([c02, c12, c22]),
    ])  # (3,3,N)
    cs = torch.stack([
        torch.stack([c[i, 1] * y[2] - c[i, 2] * y[1] for i in range(3)]),
        torch.stack([c[i, 2] * y[0] - c[i, 0] * y[2] for i in range(3)]),
        torch.stack([c[i, 0] * y[1] - c[i, 1] * y[0] for i in range(3)]),
    ], dim=1)   # cs[i,j] = (C S)_{ij}
    sc = -cs.transpose(0, 1)
    scs = torch.stack([
        torch.stack([sc[i, 1] * y[2] - sc[i, 2] * y[1] for i in range(3)]),
        torch.stack([sc[i, 2] * y[0] - sc[i, 0] * y[2] for i in range(3)]),
        torch.stack([sc[i, 0] * y[1] - sc[i, 1] * y[0] for i in range(3)]),
    ], dim=1)

    c_sum = torch.einsum("n,ijn->ij", f, c)
    cs_sum = torch.einsum("n,ijn->ij", f, cs)
    scs_sum = torch.einsum("n,ijn->ij", f, scs)
    h3 = torch.zeros((6, 6), dtype=y.dtype, device=y.device)
    h3[:3, :3] = c_sum
    h3[:3, 3:] = -cs_sum
    h3[3:, :3] = -cs_sum.T
    h3[3:, 3:] = -scs_sum

    return score, grad, h1 + h2 + h3


def _newton_loop(derivs, guess: torch.Tensor, eps: float, step_max: float, max_iterations: int):
    """Monotone-guarded damped-Newton ascent on the NDT score.

    The reference's `lax.while_loop` becomes a Python loop: each iteration
    reads one bool (`converged`) back from the device, and the start reads
    whether the first score is NaN. Everything else stays on the device.
    Returns (transform, score, grad, hess, cap, iterations, converged)."""
    eps32 = np.float32(eps)
    step_min = float(eps32 / np.float32(2.0))
    eps = float(eps32)
    step_max = float(np.float32(step_max))
    score, grad, hess = derivs(guess)
    transform = guess
    eye6 = torch.eye(6, dtype=hess.dtype, device=hess.device)
    cap = torch.full((), step_max, dtype=hess.dtype, device=hess.device)
    it = 0
    converged = bool(torch.isnan(score))
    while not converged:
        ridge = 1e-6 * torch.trace(torch.abs(hess)) / 6.0 + 1e-12
        delta, info = torch.linalg.solve_ex(hess + ridge * eye6, -grad)
        norm = torch.sqrt(torch.sum(delta * delta))
        bad = (norm == 0.0) | ~torch.isfinite(norm) | (info != 0)
        direction = delta / torch.where(bad, 1.0, norm)
        dphi0 = -torch.dot(grad, direction)
        direction = torch.where(dphi0 > 0, -direction, direction)
        alpha = torch.minimum(torch.clamp(norm, min=step_min), cap)
        new_transform = se3.exp_se3(alpha * direction) @ transform
        new_score, new_grad, new_hess = derivs(new_transform)
        accept = ~bad & (new_score >= score)
        transform = torch.where(accept, new_transform, transform)
        score = torch.where(accept, new_score, score)
        grad = torch.where(accept, new_grad, grad)
        hess = torch.where(accept, new_hess, hess)
        cap = torch.where(accept, step_max, torch.clamp(cap * 0.5, min=step_min))
        it += 1
        shrunk_out = ~accept & (alpha <= step_min)
        stop = bad | (accept & (alpha < eps)) | shrunk_out
        converged = it > max_iterations or bool(stop)
    return transform, score, grad, hess, cap, it, converged


def _newton_loop_batched(derivs, guesses: torch.Tensor, eps: float, step_max: float, max_iterations: int):
    """`_newton_loop` over k lanes at once, as the reference's vmapped
    `lax.while_loop` runs it: every lane steps until all are done, and a
    done lane keeps its state, so each lane ends where its own loop would.
    `derivs(transforms, active)` returns the (k,), (k, 6), (k, 6, 6)
    derivatives at (k, 4, 4) transforms; `active` is the host list of lanes
    still running (a lane's result is ignored once it is done). Each
    iteration reads the k done flags back once. Returns (transforms, scores,
    iterations (k,) int64)."""
    eps32 = np.float32(eps)
    step_min = float(eps32 / np.float32(2.0))
    eps = float(eps32)
    step_max = float(np.float32(step_max))
    k = guesses.shape[0]
    score, grad, hess = derivs(guesses, [True] * k)
    transform = guesses
    eye6 = torch.eye(6, dtype=hess.dtype, device=hess.device)
    cap = torch.full((k,), step_max, dtype=hess.dtype, device=hess.device)
    it = torch.zeros((k,), dtype=torch.int64, device=hess.device)
    done = torch.isnan(score)
    active = [not d for d in done.tolist()]
    while any(active):
        run = ~done
        ridge = 1e-6 * torch.abs(hess).diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12
        delta, info = torch.linalg.solve_ex(hess + ridge[:, None, None] * eye6, -grad)
        norm = torch.sqrt(torch.sum(delta * delta, dim=-1))
        bad = (norm == 0.0) | ~torch.isfinite(norm) | (info != 0)
        direction = delta / torch.where(bad, 1.0, norm)[:, None]
        dphi0 = -torch.sum(grad * direction, dim=-1)
        direction = torch.where((dphi0 > 0)[:, None], -direction, direction)
        alpha = torch.minimum(torch.clamp(norm, min=step_min), cap)
        new_transform = se3.exp_se3(alpha[:, None] * direction) @ transform
        new_score, new_grad, new_hess = derivs(new_transform, active)
        accept = ~bad & (new_score >= score)
        take = run & accept
        transform = torch.where(take[:, None, None], new_transform, transform)
        score = torch.where(take, new_score, score)
        grad = torch.where(take[:, None], new_grad, grad)
        hess = torch.where(take[:, None, None], new_hess, hess)
        cap = torch.where(run, torch.where(accept, step_max, torch.clamp(cap * 0.5, min=step_min)), cap)
        it = it + run.to(torch.int64)
        shrunk_out = ~accept & (alpha <= step_min)
        stop = bad | (it > max_iterations) | (accept & (alpha < eps)) | shrunk_out
        done = done | (run & stop)
        active = [not d for d in done.tolist()]
    return transform, score, it
