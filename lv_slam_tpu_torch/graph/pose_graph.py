"""Levenberg-Marquardt SE(3) pose graph (port of `lv_slam_tpu.graph.pose_graph`).

Conventions are the reference's: one (4,4) pose per node, left-multiplicative
se(3) updates `T <- exp(delta) T`, node 0 and fixed nodes held by the gauge,
Huber IRLS weights on chi = sqrt(r^T Omega r) with g2o's robust chi2, a dense
normal system over [6K pose dofs | 3Q plane dofs], and estimates re-anchored
to node 0 after the solve (`global_graph_nodelet.cpp:710-715`).

The graph is built on the host (numpy arrays, one write per factor, as in
the reference); `optimize_pose_graph` moves it to the device. The SE3 edges'
chi2, H and b are kernel 15 (`csrc/pose_graph.cu`) on CUDA and
`_chi2_and_normal_ref` (`torch.func.jacfwd`, as the reference's
`jax.jacfwd`) on CPU. The dense solve is `torch.linalg.cholesky_ex` +
`cholesky_solve`, a library call, as the reference leaves it to
`jax.scipy.linalg.solve`. The LM loop is a host loop with one read per
iteration. Priors, SE3-plane and plane-plane factors (ROADMAP item 9) raise
`NotImplementedError` when a graph holds a valid one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.graph import factors
from lv_slam_tpu_torch.kernels._build import I32, PTR, Kernel, check_cuda, check_dtype, ptr

KERNEL = Kernel(
    "_chi2_and_normal",
    source="lv_slam_tpu_torch/csrc/pose_graph.cu",
    replaces="lv_slam_tpu/graph/pose_graph.py:240",
    entries={
        "lvs_pose_graph_edges": [PTR, PTR, PTR, PTR, PTR, PTR, PTR, I32, I32, I32, PTR, PTR, PTR, PTR],
    },
)


class PoseGraph(NamedTuple):
    """Fixed-capacity factor-graph arrays: numpy on the host while the graph
    is built, tensors on the device in `optimize_pose_graph`. Field by field
    the reference's `PoseGraph`."""

    poses: object        # (K,4,4)
    node_valid: object   # (K,) bool
    e_i: object          # (E,) int32
    e_j: object          # (E,) int32
    e_meas: object       # (E,4,4)
    e_info: object       # (E,6,6)
    e_huber: object      # (E,) huber width, <= 0 disables
    e_valid: object      # (E,) bool
    p_node: object       # (P,) priors (ROADMAP item 9)
    p_type: object
    p_meas: object
    p_info: object
    p_huber: object
    p_valid: object
    node_fixed: object   # (K,) bool
    planes: object       # (Q,4)
    plane_valid: object
    plane_fixed: object
    sp_i: object         # SE3-plane edges (ROADMAP item 9)
    sp_plane: object
    sp_meas: object
    sp_info: object
    sp_huber: object
    sp_valid: object
    q_i: object          # plane-plane edges (ROADMAP item 9)
    q_j: object
    q_type: object
    q_meas: object
    q_info: object
    q_huber: object
    q_valid: object

    @property
    def node_cap(self) -> int:
        return self.poses.shape[0]

    @property
    def edge_cap(self) -> int:
        return self.e_i.shape[0]

    @property
    def plane_cap(self) -> int:
        return self.planes.shape[0]


def empty_graph(node_cap: int = 1024, edge_cap: int = 4096, prior_cap: int = 256, plane_cap: int = 8,
                sp_cap: int = 64, q_cap: int = 16) -> PoseGraph:
    """Host-side (numpy) graph arrays, as the reference's `empty_graph`."""
    default_plane = np.zeros((plane_cap, 4), np.float32)
    default_plane[:, 2] = 1.0
    return PoseGraph(
        poses=np.tile(np.eye(4, dtype=np.float32), (node_cap, 1, 1)),
        node_valid=np.zeros((node_cap,), bool),
        e_i=np.zeros((edge_cap,), np.int32),
        e_j=np.zeros((edge_cap,), np.int32),
        e_meas=np.tile(np.eye(4, dtype=np.float32), (edge_cap, 1, 1)),
        e_info=np.tile(np.eye(6, dtype=np.float32), (edge_cap, 1, 1)),
        e_huber=np.zeros((edge_cap,), np.float32),
        e_valid=np.zeros((edge_cap,), bool),
        p_node=np.zeros((prior_cap,), np.int32),
        p_type=np.zeros((prior_cap,), np.int32),
        p_meas=np.zeros((prior_cap, 8), np.float32),
        p_info=np.tile(np.eye(4, dtype=np.float32), (prior_cap, 1, 1)),
        p_huber=np.zeros((prior_cap,), np.float32),
        p_valid=np.zeros((prior_cap,), bool),
        node_fixed=np.zeros((node_cap,), bool),
        planes=default_plane,
        plane_valid=np.zeros((plane_cap,), bool),
        plane_fixed=np.zeros((plane_cap,), bool),
        sp_i=np.zeros((sp_cap,), np.int32),
        sp_plane=np.zeros((sp_cap,), np.int32),
        sp_meas=default_plane[:1].repeat(sp_cap, axis=0).copy(),
        sp_info=np.tile(np.eye(3, dtype=np.float32), (sp_cap, 1, 1)),
        sp_huber=np.zeros((sp_cap,), np.float32),
        sp_valid=np.zeros((sp_cap,), bool),
        q_i=np.zeros((q_cap,), np.int32),
        q_j=np.zeros((q_cap,), np.int32),
        q_type=np.zeros((q_cap,), np.int32),
        q_meas=np.zeros((q_cap, 4), np.float32),
        q_info=np.tile(np.eye(4, dtype=np.float32), (q_cap, 1, 1)),
        q_huber=np.zeros((q_cap,), np.float32),
        q_valid=np.zeros((q_cap,), bool),
    )


def to_device(graph: PoseGraph, device) -> PoseGraph:
    """The graph's arrays (numpy or tensors) as contiguous tensors on `device`."""
    return PoseGraph(*(torch.as_tensor(a).to(device).contiguous() for a in graph))


def _check_supported(graph: PoseGraph) -> None:
    for name in ("p_valid", "sp_valid", "q_valid"):
        if bool(getattr(graph, name).any()):
            raise NotImplementedError(
                f"pose graph: a valid {name} factor (priors and plane factors are ROADMAP item 9)"
            )


# ---------------------------------------------------------------- normal equations


def _edge_residual(d_i, d_j, t_i, t_j, meas):
    return factors.se3_edge_residual(se3.exp_se3(d_i) @ t_i, se3.exp_se3(d_j) @ t_j, meas)


def _edge_res_jac(t_i, t_j, meas):
    """Residuals (E,6) and Jacobians (E,6,6), (E,6,6) w.r.t. the left
    perturbations, by forward-mode autodiff as the reference's `jax.jacfwd`:
    a `torch.func.jvp` batched over the edges, vmapped over the 12 tangent
    directions."""
    zero = torch.zeros((t_i.shape[0], 12), dtype=t_i.dtype, device=t_i.device)

    def res(d):
        return _edge_residual(d[:, :6], d[:, 6:], t_i, t_j, meas)

    basis = torch.eye(12, dtype=t_i.dtype, device=t_i.device)[:, None, :].expand(12, *zero.shape)
    cols = torch.func.vmap(lambda v: torch.func.jvp(res, (zero,), (v,))[1])(basis)  # (12, E, 6)
    jac = cols.permute(1, 2, 0)  # (E, 6, 12)
    return res(zero), jac[..., :6], jac[..., 6:]


def _robust(chi2_e, huber):
    """(Huber weight, g2o's robustified chi2) per edge."""
    chi = torch.sqrt(torch.clamp(chi2_e, min=0.0))
    w = torch.where(huber > 0, factors.huber_weight(chi, huber), 1.0)
    rho = torch.where(huber > 0, torch.where(chi <= huber, chi2_e, 2.0 * huber * chi - huber**2), chi2_e)
    return w, rho


def _n_dofs(graph: PoseGraph) -> int:
    return 6 * graph.node_cap + 3 * graph.plane_cap


def _chi2_and_normal(graph: PoseGraph, poses: torch.Tensor, build: bool):
    """chi2 (+ the dense H (n, n) and b (n,) when `build`) of the SE3 edges
    at `poses`, over the state [6K se(3) dofs | 3Q plane dofs] (the plane
    dofs carry no factor here). Kernel 15 on CUDA, the plain version on CPU."""
    if poses.device.type == "cpu":
        return _chi2_and_normal_ref(graph, poses, build)
    n = _n_dofs(graph)
    n_edges = graph.edge_cap
    poses = poses.contiguous()
    check_cuda("_chi2_and_normal", poses, graph.e_i, graph.e_j, graph.e_meas, graph.e_info, graph.e_huber,
               graph.e_valid)
    check_dtype("_chi2_and_normal", poses, torch.float32, (graph.node_cap, 4, 4))
    check_dtype("_chi2_and_normal", graph.e_i, torch.int32, (n_edges,))
    check_dtype("_chi2_and_normal", graph.e_j, torch.int32, (n_edges,))
    check_dtype("_chi2_and_normal", graph.e_meas, torch.float32, (n_edges, 4, 4))
    check_dtype("_chi2_and_normal", graph.e_info, torch.float32, (n_edges, 6, 6))
    check_dtype("_chi2_and_normal", graph.e_huber, torch.float32, (n_edges,))
    check_dtype("_chi2_and_normal", graph.e_valid, torch.bool, (n_edges,))
    dev = poses.device
    rho = torch.empty((n_edges,), dtype=torch.float32, device=dev)
    chi2 = torch.empty((), dtype=torch.float32, device=dev)
    h = torch.zeros((n, n) if build else (1, 1), dtype=torch.float32, device=dev)
    b = torch.zeros((n,) if build else (1,), dtype=torch.float32, device=dev)
    KERNEL.call(
        "lvs_pose_graph_edges", ptr(poses), ptr(graph.e_i), ptr(graph.e_j), ptr(graph.e_meas),
        ptr(graph.e_info), ptr(graph.e_huber), ptr(graph.e_valid), n_edges, n, int(build),
        ptr(rho), ptr(h), ptr(b), ptr(chi2),
    )
    KERNEL.launches += 1
    return (chi2, h, b) if build else (chi2, None, None)


def _chi2_and_normal_ref(graph: PoseGraph, poses: torch.Tensor, build: bool):
    """Plain PyTorch version of `_chi2_and_normal`: the reference's batched
    residuals and autodiff Jacobians, scatter-added into H and b."""
    n = _n_dofs(graph)
    e_i, e_j = graph.e_i.long(), graph.e_j.long()
    r, j_i, j_j = _edge_res_jac(poses[e_i], poses[e_j], graph.e_meas)
    omega_r = torch.einsum("eab,eb->ea", graph.e_info, r)
    chi2_e = torch.sum(r * omega_r, dim=1)
    w_rob, rho = _robust(chi2_e, graph.e_huber)
    w = torch.where(graph.e_valid, w_rob, 0.0)
    chi2 = torch.sum(torch.where(graph.e_valid, rho, 0.0))
    if not build:
        return chi2, None, None
    j_stack = torch.cat([j_i, j_j], dim=2)                          # (E,6,12)
    w_info = w[:, None, None] * graph.e_info
    h_blk = torch.einsum("era,erc,ecb->eab", j_stack, w_info, j_stack)
    b_blk = torch.einsum("era,erc,ec->ea", j_stack, w_info, r)
    ar6 = torch.arange(6, device=poses.device)
    idx = torch.cat([e_i[:, None] * 6 + ar6, e_j[:, None] * 6 + ar6], dim=1)  # (E,12)
    v = graph.e_valid
    h = torch.zeros((n, n), dtype=poses.dtype, device=poses.device)
    h.index_put_((idx[v][:, :, None].expand(-1, 12, 12), idx[v][:, None, :].expand(-1, 12, 12)),
                 h_blk[v], accumulate=True)
    b = torch.zeros((n,), dtype=poses.dtype, device=poses.device).index_put_((idx[v],), b_blk[v], accumulate=True)
    return chi2, h, b


def _apply_gauge(h: torch.Tensor, b: torch.Tensor, graph: PoseGraph):
    """Fix node 0, the flagged nodes and planes; regularize invalid dofs."""
    k = graph.node_cap
    free = graph.node_valid & ~graph.node_fixed & (torch.arange(k, device=h.device) > 0)
    free_pl = graph.plane_valid & ~graph.plane_fixed
    freed = torch.cat([free.repeat_interleave(6), free_pl.repeat_interleave(3)])
    h = torch.where(freed[:, None] & freed[None, :], h, 0.0)
    h = h + torch.diag(torch.where(freed, 0.0, 1.0))
    b = torch.where(freed, b, 0.0)
    return h, b


class OptimizeResult(NamedTuple):
    poses: torch.Tensor
    chi2_before: torch.Tensor
    chi2_after: torch.Tensor
    iterations: int
    planes: torch.Tensor


def optimize_pose_graph(graph: PoseGraph, num_iterations: int = 128, device="cuda") -> OptimizeResult:
    """The reference's LM loop (accept/reject, lambda schedule, convergence
    tests) with one host read per iteration; returns re-anchored poses."""
    g = to_device(graph, device)
    _check_supported(g)
    k = g.node_cap
    dev = g.poses.device
    chi2_0, _, _ = _chi2_and_normal(g, g.poses, build=False)
    poses, chi2 = g.poses, chi2_0
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    it = 0
    while True:
        _, h, b = _chi2_and_normal(g, poses, build=True)
        h, b = _apply_gauge(h, b, g)
        damped = h + lam * torch.diag(torch.clamp(torch.diagonal(h), min=1e-6))
        chol, info = torch.linalg.cholesky_ex(damped)
        delta = torch.cholesky_solve(-b[:, None], chol)[:, 0]
        ok = (info == 0) & torch.all(torch.isfinite(delta))
        delta = torch.where(ok, delta, 0.0)
        new_poses = se3.exp_se3(delta[: 6 * k].reshape(k, 6)) @ poses
        new_chi2, _, _ = _chi2_and_normal(g, new_poses, build=False)
        accept = ok & (new_chi2 <= chi2)
        poses = torch.where(accept, new_poses, poses)
        chi2_next = torch.where(accept, new_chi2, chi2)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
        it += 1
        small = torch.max(torch.abs(delta)) < 1e-6
        rel_ok = accept & ((chi2 - chi2_next) < 1e-8 * (chi2 + 1e-12))
        chi2 = chi2_next
        if it >= num_iterations or bool(small | rel_ok):
            break
    anchor = g.poses[0] @ se3.inverse(poses[0])
    poses = torch.einsum("ij,njk->nik", anchor, poses)
    return OptimizeResult(poses=poses, chi2_before=chi2_0, chi2_after=chi2, iterations=it, planes=g.planes)


# ---------------------------------------------------------------- host-side building


def add_node(graph: PoseGraph, idx: int, pose) -> PoseGraph:
    """In-place host write (graph arrays are numpy, see `empty_graph`)."""
    graph.poses[idx] = np.asarray(pose, np.float32)
    graph.node_valid[idx] = True
    return graph


def add_se3_edge(graph: PoseGraph, slot: int, i: int, j: int, meas, info, huber: float = 0.0) -> PoseGraph:
    graph.e_i[slot] = i
    graph.e_j[slot] = j
    graph.e_meas[slot] = np.asarray(meas, np.float32)
    graph.e_info[slot] = np.asarray(info, np.float32)
    graph.e_huber[slot] = huber
    graph.e_valid[slot] = True
    return graph


def set_node_fixed(graph: PoseGraph, idx: int, fixed: bool = True) -> PoseGraph:
    graph.node_fixed[idx] = fixed
    return graph
