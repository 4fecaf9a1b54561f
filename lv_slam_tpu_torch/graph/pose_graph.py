"""Levenberg-Marquardt SE(3) pose graph (port of `lv_slam_tpu.graph.pose_graph`).

Conventions are the reference's: one (4,4) pose per node, left-multiplicative
se(3) updates `T <- exp(delta) T`, plane vertices [n, d] updated in their
tangent basis (`factors.plane_oplus`), node 0, fixed nodes and fixed planes
held by the gauge, Huber IRLS weights on chi = sqrt(r^T Omega r), a dense
normal system over [6K pose dofs | 3Q plane dofs], and estimates re-anchored
to node 0 after the solve (`global_graph_nodelet.cpp:710-715`). Like the
reference, chi2 adds g2o's robustified chi2 for the SE3 edges but the plain
chi2 of the priors, SE3-plane and plane-plane factors (which still take
their Huber weights).

The graph is built on the host (numpy arrays, one write per factor, as in
the reference); `optimize_pose_graph` moves it to the device. chi2, H and b
of every factor family are kernel 15 (`csrc/pose_graph.cu`, one cluster
launch: raw, chi2-only, or the LM's damped system) on CUDA and
`_chi2_and_normal_ref` (`torch.func.jvp`, as the reference's `jax.jacfwd`)
on CPU. The dense solve is `torch.linalg.cholesky_ex` + `cholesky_solve`, a
library call, as the reference leaves it to `jax.scipy.linalg.solve`. The
LM loop keeps its state on the device (`LMState`); on CUDA an iteration is
kernel 15's damped mode, the solve and `lm_step` (`csrc/lm.cu`: the
candidate, its chi2 and the accept decision), every launch gated on the
loop's `done` flag, which the host reads once per `LM_GROUP` iterations.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from lv_slam_tpu_torch.core import se3
from lv_slam_tpu_torch.graph import factors
from lv_slam_tpu_torch.kernels._build import I32, PTR, Kernel, check_cuda, check_dtype, ptr

KERNEL = Kernel(
    "_chi2_and_normal",
    source="lv_slam_tpu_torch/csrc/pose_graph.cu",
    replaces="lv_slam_tpu/graph/pose_graph.py:240",
    entries={"lvs_pose_graph": [PTR, PTR, PTR, I32, PTR, PTR, PTR, PTR, PTR, PTR, PTR]},
)
LM_KERNEL = Kernel(
    "optimize_pose_graph",
    source="lv_slam_tpu_torch/csrc/lm.cu",
    replaces="lv_slam_tpu/graph/pose_graph.py:381",
    entries={
        "lvs_lm_damp": [PTR, PTR, PTR, PTR, PTR, PTR, I32, I32, PTR, PTR, PTR, PTR],
        "lvs_lm_step": [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, I32, I32, I32],
        "lvs_lm_accept": [PTR, PTR, PTR, PTR, I32, I32, PTR, PTR, I32],
    },
)

# kernel 15's modes (csrc/pose_graph.cu)
MODE_RAW, MODE_CHI2, MODE_DAMPED = range(3)


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
    p_node: object       # (P,) int32 unary priors on an SE3 node
    p_type: object       # (P,) int32: PRIOR_XYZ, _XY, _QUAT, _VEC, _PLANE
    p_meas: object       # (P,8) packed measurement
    p_info: object       # (P,4,4) information on the (<= 4-dim) residual
    p_huber: object      # (P,)
    p_valid: object      # (P,) bool
    node_fixed: object   # (K,) bool
    planes: object       # (Q,4) [nx, ny, nz, d], n.x + d = 0, |n| = 1
    plane_valid: object  # (Q,) bool
    plane_fixed: object  # (Q,) bool (the floor node is fixed)
    sp_i: object         # (S,) int32 SE3 node of an SE3-plane edge
    sp_plane: object     # (S,) int32 plane node
    sp_meas: object      # (S,4) measured local plane coefficients
    sp_info: object      # (S,3,3)
    sp_huber: object     # (S,)
    sp_valid: object     # (S,) bool
    q_i: object          # (R,) int32 plane node of a plane-plane / plane-prior edge
    q_j: object          # (R,) int32 second plane (== q_i for the priors)
    q_type: object       # (R,) int32: PLANE_IDENTITY, _PARALLEL, _PERPENDICULAR, _PRIOR_NORMAL, _PRIOR_DISTANCE
    q_meas: object       # (R,4)
    q_info: object       # (R,4,4)
    q_huber: object      # (R,)
    q_valid: object      # (R,) bool

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


# ---------------------------------------------------------------- normal equations

PRIOR_XYZ, PRIOR_XY, PRIOR_QUAT, PRIOR_VEC, PRIOR_PLANE = range(5)
PLANE_IDENTITY, PLANE_PARALLEL, PLANE_PERPENDICULAR, PLANE_PRIOR_NORMAL, PLANE_PRIOR_DISTANCE = range(5)


def _jacfwd(res, zero: torch.Tensor):
    """(residual (F, m), Jacobian (F, m, n)) of the batched `res` at `zero`
    (F, n): a `torch.func.jvp` batched over the factors, vmapped over the n
    tangent directions (forward mode, as the reference's `jax.jacfwd`)."""
    n = zero.shape[1]
    basis = torch.eye(n, dtype=zero.dtype, device=zero.device)[:, None, :].expand(n, *zero.shape)
    cols = torch.func.vmap(lambda v: torch.func.jvp(res, (zero,), (v,))[1])(basis)  # (n, F, m)
    return res(zero), cols.permute(1, 2, 0)


def _edge_residual(d_i, d_j, t_i, t_j, meas):
    return factors.se3_edge_residual(se3.exp_se3(d_i) @ t_i, se3.exp_se3(d_j) @ t_j, meas)


def _edge_res_jac(t_i, t_j, meas):
    """Residuals (E,6) and Jacobians (E,6,6), (E,6,6) w.r.t. the left
    perturbations."""
    zero = torch.zeros((t_i.shape[0], 12), dtype=t_i.dtype, device=t_i.device)
    r, jac = _jacfwd(lambda d: _edge_residual(d[:, :6], d[:, 6:], t_i, t_j, meas), zero)
    return r, jac[..., :6], jac[..., 6:]


def _pad4(r: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(r, (0, 4 - r.shape[-1]))


def _select(kinds: torch.Tensor, stack) -> torch.Tensor:
    """Row f of candidate kinds[f] from the (F, 4) candidates (all five are
    computed, one is kept, as the reference's branchless one-hot select)."""
    r = torch.stack(stack, dim=1)  # (F, 5, 4)
    onehot = kinds.long()[:, None] == torch.arange(5, device=r.device)
    return torch.sum(torch.where(onehot[..., None], r, 0.0), dim=1)


def _prior_residual(t, p_type, p_meas):
    return _select(p_type, [
        _pad4(factors.prior_xyz_residual(t, p_meas[:, :3])),
        _pad4(factors.prior_xy_residual(t, p_meas[:, :2])),
        _pad4(factors.prior_quat_residual(t, p_meas[:, :4])),
        _pad4(factors.prior_vec_residual(t, p_meas[:, :3], p_meas[:, 3:6])),
        factors.se3_plane_residual(t, p_meas[:, :4]),
    ])


def _prior_res_jac(t_i, p_type, p_meas):
    """Unary residuals padded to (P,4) and Jacobians (P,4,6)."""
    zero = torch.zeros((t_i.shape[0], 6), dtype=t_i.dtype, device=t_i.device)
    return _jacfwd(lambda d: _prior_residual(se3.exp_se3(d) @ t_i, p_type, p_meas), zero)


def _sp_res_jac(t_i, plane, meas):
    """EdgeSE3Plane residuals (S,3) and Jacobians (S,3,6) se3, (S,3,3) plane."""
    zero = torch.zeros((t_i.shape[0], 9), dtype=t_i.dtype, device=t_i.device)

    def res(d):
        return factors.se3_plane_shared_residual(se3.exp_se3(d[:, :6]) @ t_i, factors.plane_oplus(plane, d[:, 6:]),
                                                 meas)

    r, jac = _jacfwd(res, zero)
    return r, jac[..., :6], jac[..., 6:]


def _q_res_jac(p1, p2, q_type, meas):
    """Typed plane-plane / plane-prior residuals padded to (R,4) and
    Jacobians (R,4,3), (R,4,3)."""
    zero = torch.zeros((p1.shape[0], 6), dtype=p1.dtype, device=p1.device)

    def res(d):
        a = factors.plane_oplus(p1, d[:, :3])
        b = factors.plane_oplus(p2, d[:, 3:])
        return _select(q_type, [
            factors.plane_identity_residual(a, b, meas),
            _pad4(factors.plane_parallel_residual(a, b, meas[:, :3])),
            _pad4(factors.plane_perpendicular_residual(a, b)),
            _pad4(factors.plane_prior_normal_residual(a, meas[:, :3])),
            _pad4(factors.plane_prior_distance_residual(a, meas[:, 0])),
        ])

    r, jac = _jacfwd(res, zero)
    return r, jac[..., :3], jac[..., 3:]


def _robust(chi2_e, huber):
    """(Huber weight, g2o's robustified chi2) per factor."""
    chi = torch.sqrt(torch.clamp(chi2_e, min=0.0))
    w = torch.where(huber > 0, factors.huber_weight(chi, huber), 1.0)
    rho = torch.where(huber > 0, torch.where(chi <= huber, chi2_e, 2.0 * huber * chi - huber**2), chi2_e)
    return w, rho


def _n_dofs(graph: PoseGraph) -> int:
    return 6 * graph.node_cap + 3 * graph.plane_cap


def _check_graph(g: PoseGraph, poses: torch.Tensor, planes: torch.Tensor) -> None:
    """Kernel 15's arguments: contiguous CUDA tensors of the graph's dtypes
    and shapes (checked once per LM loop: they do not change inside it)."""
    k, q = g.node_cap, g.plane_cap
    n_e, n_p, n_s, n_r = g.edge_cap, g.p_node.shape[0], g.sp_i.shape[0], g.q_i.shape[0]
    name = "_chi2_and_normal"
    check_cuda(name, poses, planes, *g)
    check_dtype(name, poses, torch.float32, (k, 4, 4))
    check_dtype(name, planes, torch.float32, (q, 4))
    for field, dtype, shape in (
        ("e_i", torch.int32, (n_e,)), ("e_j", torch.int32, (n_e,)), ("e_meas", torch.float32, (n_e, 4, 4)),
        ("e_info", torch.float32, (n_e, 6, 6)), ("e_huber", torch.float32, (n_e,)), ("e_valid", torch.bool, (n_e,)),
        ("p_node", torch.int32, (n_p,)), ("p_type", torch.int32, (n_p,)), ("p_meas", torch.float32, (n_p, 8)),
        ("p_info", torch.float32, (n_p, 4, 4)), ("p_huber", torch.float32, (n_p,)), ("p_valid", torch.bool, (n_p,)),
        ("sp_i", torch.int32, (n_s,)), ("sp_plane", torch.int32, (n_s,)), ("sp_meas", torch.float32, (n_s, 4)),
        ("sp_info", torch.float32, (n_s, 3, 3)), ("sp_huber", torch.float32, (n_s,)),
        ("sp_valid", torch.bool, (n_s,)), ("q_i", torch.int32, (n_r,)), ("q_j", torch.int32, (n_r,)),
        ("q_type", torch.int32, (n_r,)), ("q_meas", torch.float32, (n_r, 4)), ("q_info", torch.float32, (n_r, 4, 4)),
        ("q_huber", torch.float32, (n_r,)), ("q_valid", torch.bool, (n_r,)),
        ("node_valid", torch.bool, (k,)), ("node_fixed", torch.bool, (k,)), ("plane_valid", torch.bool, (q,)),
        ("plane_fixed", torch.bool, (q,)),
    ):
        check_dtype(name, getattr(g, field), dtype, shape)


class _GraphArgs(ctypes.Structure):
    """`GraphArgs` of csrc/pose_graph.cuh: the graph's device pointers and
    sizes, passed to kernel 15 and `lm_step` by one host pointer."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "e_i", "e_j", "e_meas", "e_info", "e_huber", "e_valid", "p_node", "p_type", "p_meas", "p_info", "p_huber",
        "p_valid", "sp_i", "sp_plane", "sp_meas", "sp_info", "sp_huber", "sp_valid", "q_i", "q_j", "q_type",
        "q_meas", "q_info", "q_huber", "q_valid", "node_valid", "node_fixed", "plane_valid", "plane_fixed")] + [
        (name, ctypes.c_int) for name in ("n_e", "n_p", "n_s", "n_q", "n_nodes", "n_planes")]


def _graph_args(g: PoseGraph) -> _GraphArgs:
    """The struct of a checked device graph (the graph's tensors must outlive it)."""
    fields = g._asdict()
    ptrs = {name: fields[name].data_ptr() for name, kind in _GraphArgs._fields_ if kind is ctypes.c_void_p}
    return _GraphArgs(**ptrs, n_e=g.edge_cap, n_p=g.p_node.shape[0], n_s=g.sp_i.shape[0], n_q=g.q_i.shape[0],
                      n_nodes=g.node_cap, n_planes=g.plane_cap)


def _k15(args: _GraphArgs, poses, planes, mode: int, rho, blk=None, h=None, b=None, chi2=None, lmf=None,
         done=None) -> None:
    """Kernel 15's one launch on checked arguments (`args`: `_graph_args`):
    every factor's chi2 term into `rho`; raw: the blocks into the scratch
    `blk`, their ordered sums written as H and b into `h` and `b`, and the
    terms' sum into the pointer `chi2` unless it is None; chi2: that sum
    only; damped: the damped system into `h` and rhs = -b into `b` at lambda
    lmf[0]. `done`: the LM loop's gate (None outside it)."""
    KERNEL.call("lvs_pose_graph", ctypes.c_void_p(ctypes.addressof(args)), ptr(poses), ptr(planes), mode, ptr(rho),
                None if blk is None else ptr(blk), None if h is None else ptr(h), None if b is None else ptr(b), chi2,
                None if lmf is None else ptr(lmf), done)
    KERNEL.launches += 1


def _family_sizes(g: PoseGraph) -> tuple:
    """The factor slots of the four families: edges, priors, SE3-plane,
    plane-plane."""
    return g.edge_cap, g.p_node.shape[0], g.sp_i.shape[0], g.q_i.shape[0]


def _n_terms(g: PoseGraph) -> int:
    return sum(_family_sizes(g))


# dofs of one factor of each family (edges, priors, SE3-plane, plane-plane)
_FAMILY_DOFS = (12, 6, 9, 6)


def _block_offsets(g: PoseGraph) -> list:
    """Each family's first float in K15's scratch of factor blocks (a
    factor's J^T W J, nd x nd, then J^T W r, nd), and the total last."""
    offsets = [0]
    for count, nd in zip(_family_sizes(g), _FAMILY_DOFS):
        offsets.append(offsets[-1] + count * (nd * nd + nd))
    return offsets


def _block_scratch(g: PoseGraph, device) -> torch.Tensor:
    return torch.empty((_block_offsets(g)[-1],), dtype=torch.float32, device=device)


def _chi2_and_normal(graph: PoseGraph, poses: torch.Tensor, build: bool, planes: Optional[torch.Tensor] = None):
    """chi2 (+ the dense H (n, n) and b (n,) when `build`) of every factor
    at `poses` and `planes` (default: the graph's), over the state [6K se(3)
    dofs | 3Q plane dofs]. Kernel 15 on CUDA (one launch, raw or chi2-only),
    the plain version on CPU."""
    planes = graph.planes if planes is None else planes
    if poses.device.type == "cpu":
        return _chi2_and_normal_ref(graph, poses, build, planes)
    n = _n_dofs(graph)
    poses, planes = poses.contiguous(), planes.contiguous()
    _check_graph(graph, poses, planes)
    dev = poses.device
    rho = torch.empty((_n_terms(graph),), dtype=torch.float32, device=dev)
    chi2 = torch.empty((), dtype=torch.float32, device=dev)
    if not build:
        _k15(_graph_args(graph), poses, planes, MODE_CHI2, rho, chi2=ptr(chi2))
        return chi2, None, None
    h = torch.empty((n, n), dtype=torch.float32, device=dev)
    b = torch.empty((n,), dtype=torch.float32, device=dev)
    _k15(_graph_args(graph), poses, planes, MODE_RAW, rho, _block_scratch(graph, dev), h, b, ptr(chi2))
    return chi2, h, b


def _damped_system(graph: PoseGraph, poses: torch.Tensor, planes: torch.Tensor, lam: float):
    """The LM's damped system (n, n) and right-hand side (n,) at `poses` and
    `planes`: H and b through `_apply_gauge`, then H + lam diag(max(diag H,
    1e-6)) and -b. Kernel 15's damped mode on CUDA (one launch), the plain
    version on CPU."""
    if poses.device.type == "cpu":
        return _damped_system_ref(graph, poses, planes, lam)
    n = _n_dofs(graph)
    poses, planes = poses.contiguous(), planes.contiguous()
    _check_graph(graph, poses, planes)
    dev = poses.device
    lmf = torch.full((4,), lam, dtype=torch.float32, device=dev)
    rho = torch.empty((_n_terms(graph),), dtype=torch.float32, device=dev)
    damped = torch.empty((n, n), dtype=torch.float32, device=dev)
    rhs = torch.empty((n,), dtype=torch.float32, device=dev)
    _k15(_graph_args(graph), poses, planes, MODE_DAMPED, rho, _block_scratch(graph, dev), damped, rhs, lmf=lmf)
    return damped, rhs


def _weigh(r, info, huber, robust_chi2: bool):
    """(IRLS weights, chi2 sum) of the factors: g2o's robustified chi2 for
    the SE3 edges, the plain chi2 for the rest."""
    chi2_f = torch.sum(r * torch.einsum("fab,fb->fa", info, r), dim=1)
    w, rho = _robust(chi2_f, huber)
    return w, torch.sum(rho if robust_chi2 else chi2_f)


def _scatter(h, b, idx, jac, w, info, r):
    """Adds the factors' J^T (w Omega) J and J^T (w Omega) r at the dofs
    `idx` (F, m)."""
    w_info = w[:, None, None] * info
    h_blk = torch.einsum("fra,frc,fcb->fab", jac, w_info, jac)
    b_blk = torch.einsum("fra,frc,fc->fa", jac, w_info, r)
    m = idx.shape[1]
    h.index_put_((idx[:, :, None].expand(-1, m, m), idx[:, None, :].expand(-1, m, m)), h_blk, accumulate=True)
    b.index_put_((idx,), b_blk, accumulate=True)


def _chi2_and_normal_ref(graph: PoseGraph, poses: torch.Tensor, build: bool, planes: Optional[torch.Tensor] = None):
    """Plain PyTorch version of `_chi2_and_normal`: the reference's batched
    residuals and autodiff Jacobians of the valid factors, scatter-added
    into H and b."""
    g = graph
    planes = g.planes if planes is None else planes
    n, k = _n_dofs(g), g.node_cap
    dev = poses.device
    ar6, ar3 = torch.arange(6, device=dev), torch.arange(3, device=dev)
    chi2 = torch.zeros((), dtype=poses.dtype, device=dev)
    h = torch.zeros((n, n), dtype=poses.dtype, device=dev) if build else None
    b = torch.zeros((n,), dtype=poses.dtype, device=dev) if build else None
    families = (
        (g.e_valid, True, lambda v: (
            *_edge_res_jac(poses[g.e_i[v].long()], poses[g.e_j[v].long()], g.e_meas[v]),
            (g.e_i[v].long()[:, None] * 6 + ar6, g.e_j[v].long()[:, None] * 6 + ar6), g.e_info[v], g.e_huber[v])),
        (g.p_valid, False, lambda v: (
            *_prior_res_jac(poses[g.p_node[v].long()], g.p_type[v], g.p_meas[v]),
            (g.p_node[v].long()[:, None] * 6 + ar6,), g.p_info[v], g.p_huber[v])),
        (g.sp_valid, False, lambda v: (
            *_sp_res_jac(poses[g.sp_i[v].long()], planes[g.sp_plane[v].long()], g.sp_meas[v]),
            (g.sp_i[v].long()[:, None] * 6 + ar6, 6 * k + g.sp_plane[v].long()[:, None] * 3 + ar3),
            g.sp_info[v], g.sp_huber[v])),
        (g.q_valid, False, lambda v: (
            *_q_res_jac(planes[g.q_i[v].long()], planes[g.q_j[v].long()], g.q_type[v], g.q_meas[v]),
            (6 * k + g.q_i[v].long()[:, None] * 3 + ar3, 6 * k + g.q_j[v].long()[:, None] * 3 + ar3),
            g.q_info[v], g.q_huber[v])),
    )
    for valid, robust_chi2, factor in families:
        v = torch.nonzero(valid)[:, 0]
        if v.numel() == 0:
            continue
        r, *jacs, idx, info, huber = factor(v)
        w, chi2_f = _weigh(r, info, huber, robust_chi2)
        chi2 = chi2 + chi2_f
        if build:
            _scatter(h, b, torch.cat(idx, dim=1), torch.cat(jacs, dim=2), w, info, r)
    return (chi2, h, b) if build else (chi2, None, None)


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


def _damp(h: torch.Tensor, b: torch.Tensor, graph: PoseGraph, lam):
    """The LM's damped system and right-hand side from raw H and b: the
    gauge, then h + lam diag(max(diag h, 1e-6)), and -b."""
    h, b = _apply_gauge(h, b, graph)
    return h + lam * torch.diag(torch.clamp(torch.diagonal(h), min=1e-6)), -b


def _damped_system_ref(graph: PoseGraph, poses: torch.Tensor, planes: torch.Tensor, lam):
    """Plain PyTorch version of `_damped_system`: the twin's H and b through
    `_damp`, as `_lm_iteration_ref` forms them."""
    _, h, b = _chi2_and_normal_ref(graph, poses, True, planes)
    return _damp(h, b, graph, lam)


class OptimizeResult(NamedTuple):
    poses: torch.Tensor
    chi2_before: torch.Tensor
    chi2_after: torch.Tensor
    iterations: torch.Tensor  # () int32, on the graph's device
    planes: torch.Tensor


# LM iterations launched between two host reads of the loop's `done` flag:
# the backend's solves take 12 to 22 iterations on the flagship circle
# (`chip_smoke.py` phase 5 on an H100), so 4 reads them in 3 to 6 reads
# with at most 3 iterations launched after done
LM_GROUP = 4

# the loop's scalars (csrc/lm.cu): floats ...
L_LAM, L_CHI2, L_NEW_CHI2 = 0, 1, 2
# ... and ints
M_DONE, M_IT, M_OK, M_SMALL = 0, 1, 2, 3


class LMState:
    """The LM loop's state on the graph's device: the current and candidate
    poses and planes, `lmf` float32 [lam, chi2, candidate chi2, pad] and
    `lmi` int32 [done, it, ok, small]; on CUDA also the kernels' buffers
    (the graph's struct of pointers, K15's factor blocks, the damped system
    and its right-hand side, the factors' chi2 terms) and, for the sharded
    LM (`sharded`), the raw H and b that K15 writes and the ranks sum."""

    def __init__(self, g: PoseGraph, chi2_0: torch.Tensor, sharded: bool = False):
        dev = g.poses.device
        self.poses, self.planes = g.poses.clone(), g.planes.clone()
        self.cand_poses, self.cand_planes = torch.empty_like(self.poses), torch.empty_like(self.planes)
        self.lmf = torch.full((4,), 1e-4, dtype=torch.float32, device=dev)  # a fill: no host-to-device copy
        self.lmf[L_CHI2] = chi2_0
        self.lmi = torch.zeros((4,), dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            n = _n_dofs(g)
            self.args = _graph_args(g)
            self.damped = torch.empty((n, n), dtype=torch.float32, device=dev)
            self.rhs = torch.empty((n, 1), dtype=torch.float32, device=dev)
            self.rho = torch.empty((_n_terms(g),), dtype=torch.float32, device=dev)
            self.blk = _block_scratch(g, dev)
            if sharded:
                self.h = torch.empty((n, n), dtype=torch.float32, device=dev)
                self.b = torch.empty((n,), dtype=torch.float32, device=dev)

    def clone(self) -> "LMState":
        """A copy with its own buffers (the graph's struct is shared: it
        names the graph's tensors, not the state's)."""
        out = LMState.__new__(LMState)
        out.__dict__.update({key: v if key == "args" else v.clone() for key, v in self.__dict__.items()})
        return out

    def done_ptr(self):
        return ctypes.c_void_p(self.lmi.data_ptr() + 4 * M_DONE)


def optimize_pose_graph(graph: PoseGraph, num_iterations: int = 128, device="cuda",
                        reduce: Optional[Callable] = None) -> OptimizeResult:
    """The reference's LM loop (accept/reject, lambda schedule, convergence
    tests); returns re-anchored poses and the planes, left on the device.
    On CUDA an iteration is two hand launches around the library solve:
    kernel 15's damped system, the Cholesky factor and solve, and `lm_step`
    (the candidate, its chi2 and the decision), all but the factorization
    gated on `done`; iterations go in groups of `LM_GROUP` with one host
    read of `done` after each group but the last. On CPU the twin
    (`_lm_iteration_ref`) runs in the same loop.

    `reduce(t)`, when given, sums a tensor in place across the ranks that
    hold the graph's other factors (the sharded LM, `parallel/mesh.py`):
    chi2 at the start, H and b after kernel 15's raw build (before the
    gauge), and the candidate's chi2. Every rank then takes the same step
    and reads the same `done`, so all make the same collectives."""
    g = to_device(graph, device)
    chi2_0, _, _ = _chi2_and_normal(g, g.poses, False, g.planes)  # checks K15's arguments once
    if reduce is not None:
        reduce(chi2_0.view(1))
    st = LMState(g, chi2_0, sharded=reduce is not None)
    step = _lm_iteration if g.poses.device.type == "cuda" else _lm_iteration_ref
    bound = max(num_iterations, 1)  # the reference's loop body runs at least once
    launched = 0
    while launched < bound:
        for _ in range(min(LM_GROUP, bound - launched)):
            step(g, st, num_iterations, reduce)
            launched += 1
        if launched < bound and bool(st.lmi[M_DONE]):
            break
    anchor = g.poses[0] @ se3.inverse(st.poses[0])
    poses = torch.einsum("ij,njk->nik", anchor, st.poses)
    return OptimizeResult(poses=poses, chi2_before=chi2_0, chi2_after=st.lmf[L_CHI2], iterations=st.lmi[M_IT],
                          planes=st.planes)


def _lm_iteration(g: PoseGraph, st: LMState, num_iterations: int, reduce: Optional[Callable] = None) -> None:
    """One gated LM iteration on the card: kernel 15's damped system, the
    library solve, `lm_step` (2 hand launches). Sharded (`reduce`): kernel
    15 raw, H and b reduced, `lm_damp`, the solve, `lm_step` without the
    decision, the candidate's chi2 reduced, `lm_accept`; a finished loop's H
    and b stay cleared, so its collectives reduce zeros."""
    k, q, n = g.node_cap, g.plane_cap, _n_dofs(g)
    done = st.done_ptr()
    args = ctypes.c_void_p(ctypes.addressof(st.args))
    if reduce is None:
        _k15(st.args, st.poses, st.planes, MODE_DAMPED, st.rho, st.blk, st.damped, st.rhs, lmf=st.lmf, done=done)
    else:
        _k15(st.args, st.poses, st.planes, MODE_RAW, st.rho, st.blk, st.h, st.b, done=done)
        reduce(st.h)
        reduce(st.b)
        LM_KERNEL.call("lvs_lm_damp", ptr(st.h), ptr(st.b), ptr(g.node_valid), ptr(g.node_fixed),
                       ptr(g.plane_valid), ptr(g.plane_fixed), k, n, ptr(st.lmf), ptr(st.lmi), ptr(st.damped),
                       ptr(st.rhs))
    chol, info = torch.linalg.cholesky_ex(st.damped)
    delta = torch.cholesky_solve(st.rhs, chol)
    LM_KERNEL.call("lvs_lm_step", args, ptr(delta), ptr(info), ptr(st.poses), ptr(st.planes), ptr(st.cand_poses),
                   ptr(st.cand_planes), ptr(st.rho), ptr(st.lmf), ptr(st.lmi), n, num_iterations,
                   int(reduce is None))
    if reduce is not None:
        reduce(st.lmf[L_NEW_CHI2:L_NEW_CHI2 + 1])
        LM_KERNEL.call("lvs_lm_accept", ptr(st.poses), ptr(st.planes), ptr(st.cand_poses), ptr(st.cand_planes), k,
                       q, ptr(st.lmf), ptr(st.lmi), num_iterations)
    LM_KERNEL.launches += 1


def _lm_iteration_ref(g: PoseGraph, st: LMState, num_iterations: int, reduce: Optional[Callable] = None) -> None:
    """Plain PyTorch version of `_lm_iteration`: the reference's loop body
    with today's operations, on the state read into fresh tensors and
    written back in place; nothing once `done` is set."""
    if bool(st.lmi[M_DONE]):
        return
    k = g.node_cap
    poses, planes = st.poses.clone(), st.planes.clone()
    lam, chi2 = st.lmf[L_LAM].clone(), st.lmf[L_CHI2].clone()
    _, h, b = _chi2_and_normal(g, poses, True, planes)
    if reduce is not None:
        reduce(h)
        reduce(b)
    damped, rhs = _damp(h, b, g, lam)
    chol, info = torch.linalg.cholesky_ex(damped)
    delta = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(delta))
    delta = torch.where(ok, delta, 0.0)
    new_poses = se3.exp_se3(delta[: 6 * k].reshape(k, 6)) @ poses
    new_planes = factors.plane_oplus(planes, delta[6 * k:].reshape(g.plane_cap, 3))
    new_chi2, _, _ = _chi2_and_normal(g, new_poses, False, new_planes)
    if reduce is not None:
        reduce(new_chi2.view(1))
    accept = ok & (new_chi2 <= chi2)
    st.poses.copy_(torch.where(accept, new_poses, poses))
    st.planes.copy_(torch.where(accept, new_planes, planes))
    chi2_next = torch.where(accept, new_chi2, chi2)
    st.lmf[L_LAM] = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
    st.lmf[L_NEW_CHI2] = new_chi2
    st.lmi[M_IT] += 1
    small = torch.max(torch.abs(delta)) < 1e-6
    rel_ok = accept & ((chi2 - chi2_next) < 1e-8 * (chi2 + 1e-12))
    st.lmf[L_CHI2] = chi2_next
    st.lmi[M_OK] = ok.to(torch.int32)
    st.lmi[M_SMALL] = small.to(torch.int32)
    st.lmi[M_DONE] = ((st.lmi[M_IT] >= num_iterations) | small | rel_ok).to(torch.int32)


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


def add_prior(graph: PoseGraph, slot: int, node: int, p_type: int, meas, info, huber: float = 0.0) -> PoseGraph:
    meas = np.asarray(meas, np.float32).reshape(-1)
    info = np.asarray(info, np.float32)
    graph.p_node[slot] = node
    graph.p_type[slot] = p_type
    graph.p_meas[slot] = 0.0
    graph.p_meas[slot, : meas.shape[0]] = meas
    graph.p_info[slot] = np.eye(4, dtype=np.float32)
    graph.p_info[slot, : info.shape[0], : info.shape[1]] = info
    graph.p_huber[slot] = huber
    graph.p_valid[slot] = True
    return graph


def add_plane_node(graph: PoseGraph, idx: int, coeffs, fixed: bool = False) -> PoseGraph:
    """`GraphSLAM::add_plane_node` (`graph_slam.cpp:116-124`); the floor node
    is added fixed (`global_graph_nodelet.cpp:601-604`)."""
    c = np.asarray(coeffs, np.float64)
    c = c / max(float(np.linalg.norm(c[:3])), 1e-9)
    graph.planes[idx] = c.astype(np.float32)
    graph.plane_valid[idx] = True
    graph.plane_fixed[idx] = fixed
    return graph


def add_se3_plane_edge(graph: PoseGraph, slot: int, node: int, plane: int, meas_coeffs, info3,
                       huber: float = 0.0) -> PoseGraph:
    """`GraphSLAM::add_se3_plane_edge` (`graph_slam.cpp:149-160`)."""
    c = np.asarray(meas_coeffs, np.float64)
    c = c / max(float(np.linalg.norm(c[:3])), 1e-9)
    graph.sp_i[slot] = node
    graph.sp_plane[slot] = plane
    graph.sp_meas[slot] = c.astype(np.float32)
    graph.sp_info[slot] = np.asarray(info3, np.float32)
    graph.sp_huber[slot] = huber
    graph.sp_valid[slot] = True
    return graph


def add_plane_edge(graph: PoseGraph, slot: int, i: int, j: int, q_type: int, meas, info,
                   huber: float = 0.0) -> PoseGraph:
    """A typed plane-plane or plane-prior factor (`graph_slam.cpp:162-276`);
    the prior types take j == i."""
    meas = np.asarray(meas, np.float32).reshape(-1)
    info = np.asarray(info, np.float32)
    graph.q_i[slot] = i
    graph.q_j[slot] = j
    graph.q_type[slot] = q_type
    graph.q_meas[slot] = 0.0
    graph.q_meas[slot, : meas.shape[0]] = meas
    graph.q_info[slot] = 0.0
    graph.q_info[slot, : info.shape[0], : info.shape[1]] = info
    graph.q_huber[slot] = huber
    graph.q_valid[slot] = True
    return graph
