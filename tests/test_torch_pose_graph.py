"""The port's pose graph (kernel 15's plain twin and the LM loop) against
`lv_slam_tpu.graph.pose_graph` (CPU), on a seeded 16-node graph with
odometry and loop edges, Huber on, and a fixed anchor node; then every
prior type, the SE3-plane edge and every plane-plane type factor by factor
(residual and forward-mode Jacobian), a graph holding all of them (chi2, H
and b), and the LM on `tests/test_pose_graph.py`'s GPS-prior, shared-floor
and plane-plane graphs (poses, planes and chi2).

chi2, H and b agree to 1e-5 of their scale (the Jacobians come from forward
mode in both, through the same quaternion branch; sums run in other
orders). The LM's poses agree to 1e-4 and its chi2 to 1e-5 relative. Its
iteration count is decided by float32 noise in chi2 near convergence
(a step that changes chi2 by less than its rounding is accepted or rejected
at random, and rejects raise lambda until the step is below 1e-6), so the
port's count is held to the spread of the reference's own counts over
one-ulp perturbations of the measurements."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core import se3 as jse3  # noqa: E402
from lv_slam_tpu.graph import factors as jfactors  # noqa: E402
from lv_slam_tpu.graph import pose_graph as jpg  # noqa: E402
from lv_slam_tpu_torch.convert import pose_graph_from_numpy, pose_graph_to_numpy  # noqa: E402
from lv_slam_tpu_torch.graph import factors, pose_graph as tpg  # noqa: E402

K = 16


def _exp(v) -> np.ndarray:
    return np.asarray(jse3.exp_se3(jnp.asarray(v, jnp.float32)), np.float64)


def _graph(seed: int = 3):
    """16 keyframes on a noisy chain, three loop edges (one an outlier past
    the Huber width), node 16 a fixed anchor tied to node 0."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(1, K):
        gt.append(gt[-1] @ _exp(np.r_[rng.normal(0, 2.0, 3), rng.normal(0, 0.1, 3)]))
    g = jpg.empty_graph(32, 64, 8, 8, 8, 16)
    info = np.diag([2.0] * 3 + [10.0] * 3).astype(np.float32)
    for i in range(K):
        jpg.add_node(g, i, gt[i] @ _exp(rng.normal(0, 0.05, 6)))
    e = 0
    for i in range(1, K):
        meas = np.linalg.inv(gt[i]) @ gt[i - 1] @ _exp(rng.normal(0, 0.02, 6))
        jpg.add_se3_edge(g, e, i, i - 1, meas, info, huber=1.0)
        e += 1
    for (i, j), sd in (((15, 0), 0.05), ((12, 2), 0.05), ((9, 4), 0.8)):
        jpg.add_se3_edge(g, e, i, j, np.linalg.inv(gt[i]) @ gt[j] @ _exp(rng.normal(0, sd, 6)), info, huber=1.0)
        e += 1
    jpg.add_node(g, K, np.eye(4))
    jpg.set_node_fixed(g, K)
    jpg.add_se3_edge(g, e, K, 0, np.eye(4), np.eye(6))
    return g


@pytest.fixture(scope="module")
def graph():
    return _graph()


def test_chi2_and_normal(graph):
    jg = jax.tree_util.tree_map(jnp.asarray, graph)
    chi2, h, b = jax.jit(lambda g: jpg._chi2_and_normal(g, g.poses, g.planes, True))(jg)
    h, b = (np.asarray(x) for x in jpg._apply_gauge(h, b, jg))
    tg = pose_graph_from_numpy(graph, "cpu")
    chi2_t, h_t, b_t = tpg._chi2_and_normal(tg, tg.poses, build=True)
    h_t, b_t = (x.numpy() for x in tpg._apply_gauge(h_t, b_t, tg))
    assert h_t.shape == h.shape == (6 * 32 + 3 * 8,) * 2
    np.testing.assert_allclose(float(chi2_t), float(chi2), rtol=1e-5)
    np.testing.assert_allclose(h_t, h, rtol=1e-5, atol=1e-5 * np.abs(h).max())
    np.testing.assert_allclose(b_t, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    chi2_only, none_h, none_b = tpg._chi2_and_normal(tg, tg.poses, build=False)
    assert none_h is None and none_b is None and float(chi2_only) == float(chi2_t)
    # the round trip keeps every field
    back = pose_graph_to_numpy(tg)
    for name in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(graph, name)), err_msg=name)


def test_edge_jacobian_is_the_reference_jacfwd(graph):
    """The plain twin's forward-mode Jacobian equals the reference's
    `jax.jacfwd` edge by edge, to 1e-5 of its scale."""
    v = np.asarray(graph.e_valid)
    ti, tj = graph.poses[graph.e_i[v]], graph.poses[graph.e_j[v]]
    meas = graph.e_meas[v]
    r, ji, jj = jax.vmap(jpg._edge_res_jac)(jnp.asarray(ti), jnp.asarray(tj), jnp.asarray(meas))
    r_t, ji_t, jj_t = tpg._edge_res_jac(torch.from_numpy(ti), torch.from_numpy(tj), torch.from_numpy(meas))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    for a, b in ((ji_t, ji), (jj_t, jj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5 * np.abs(np.asarray(b)).max())
    chi = torch.tensor([0.5, 1.0, 3.0])
    np.testing.assert_allclose(factors.huber_weight(chi, 1.0).numpy(), [1.0, 1.0, 1.0 / 3.0])


def _perturbed(graph, seed: int):
    """The graph with every measurement entry moved by at most one ulp."""
    rng = np.random.default_rng(seed)
    g = jax.tree_util.tree_map(np.array, graph)
    step = rng.integers(-1, 2, g.e_meas.shape)
    g.e_meas[:] = np.where(step > 0, np.nextafter(g.e_meas, np.float32(np.inf)),
                           np.where(step < 0, np.nextafter(g.e_meas, np.float32(-np.inf)), g.e_meas))
    return g


def test_optimize_pose_graph(graph):
    opt = jax.jit(jpg.optimize_pose_graph, static_argnums=(1,))
    want = opt(jax.tree_util.tree_map(jnp.asarray, graph), 64)
    spread = [int(want.iterations)] + [
        int(opt(jax.tree_util.tree_map(jnp.asarray, _perturbed(graph, s)), 64).iterations) for s in range(8)
    ]
    got = tpg.optimize_pose_graph(tpg.PoseGraph(*graph), 64, device="cpu")
    print(f"iterations: port {got.iterations}, reference {spread[0]}, under one-ulp noise {spread[1:]}")
    assert min(spread) <= got.iterations <= max(spread)
    np.testing.assert_allclose(float(got.chi2_before), float(want.chi2_before), rtol=1e-5)
    np.testing.assert_allclose(float(got.chi2_after), float(want.chi2_after), rtol=1e-5)
    assert float(want.chi2_after) < 0.5 * float(want.chi2_before)
    np.testing.assert_allclose(got.poses.numpy()[: K + 1], np.asarray(want.poses)[: K + 1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.poses.numpy()[0], graph.poses[0], rtol=0, atol=1e-6)  # re-anchored to node 0


@pytest.mark.parametrize("kind", ["NONE", "Huber", "CAUCHY", "PSEUDO_HUBER", "FAIR", "GM", "WELSCH", "TUKEY",
                                  "SATURATED", "DCS"])
def test_robust_weight(kind):
    """Every robust kernel's IRLS weight, to 1e-6."""
    from lv_slam_tpu.graph import factors as jfactors

    chi = np.array([0.0, 0.3, 0.99, 1.0, 1.5, 4.0, 30.0], np.float32)
    want = np.asarray(jfactors.robust_weight(kind, jnp.asarray(chi), 1.0))
    got = factors.robust_weight(kind, torch.from_numpy(chi), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_unported_factors_raise(graph):
    """The call that was refused before the priors were ported: the graph
    with its (zero-measurement XYZ) prior slot 0 switched on, optimized by
    both packages."""
    g = jax.tree_util.tree_map(np.array, graph)
    g.p_valid[0] = True
    want = jax.jit(jpg.optimize_pose_graph, static_argnums=(1,))(jax.tree_util.tree_map(jnp.asarray, g), 4)
    got = tpg.optimize_pose_graph(tpg.PoseGraph(*g), 4, device="cpu")
    assert got.iterations == int(want.iterations) == 4
    np.testing.assert_allclose(float(got.chi2_before), float(want.chi2_before), rtol=1e-5)
    np.testing.assert_allclose(float(got.chi2_after), float(want.chi2_after), rtol=1e-5)
    np.testing.assert_allclose(got.poses.numpy()[: K + 1], np.asarray(want.poses)[: K + 1], rtol=0, atol=1e-4)


# ------------------------------------------------------------ priors and planes

PRIOR_MEAS = {
    jpg.PRIOR_XYZ: lambda rng, t: np.r_[t[:3, 3] + rng.normal(0, 0.3, 3), np.zeros(5)],
    jpg.PRIOR_XY: lambda rng, t: np.r_[t[:2, 3] + rng.normal(0, 0.3, 2), np.zeros(6)],
    jpg.PRIOR_QUAT: lambda rng, t: np.r_[np.asarray(jse3.quat_from_matrix(jnp.asarray(
        t[:3, :3] @ _exp(np.r_[0, 0, 0, rng.normal(0, 0.05, 3)])[:3, :3], jnp.float32))), np.zeros(4)],
    jpg.PRIOR_VEC: lambda rng, t: np.r_[0, 0, 1.0, _unit(t[:3, :3].T @ [0, 0, 1] + rng.normal(0, 0.05, 3)), 0, 0],
    jpg.PRIOR_PLANE: lambda rng, t: np.r_[_unit(rng.normal(0, 0.05, 3) + [0, 0, 1]) * rng.choice([-1, 1]),
                                          rng.normal(1.7, 0.3), np.zeros(4)],
}


def _unit(v):
    return np.asarray(v) / np.linalg.norm(v)


def _poses(rng, n):
    return np.stack([_exp(np.r_[rng.normal(0, 5.0, 3), rng.normal(0, 0.6, 3)]) for _ in range(n)]).astype(np.float32)


def _planes(rng, n):
    p = np.c_[rng.normal(0, 0.3, (n, 3)) + [0, 0, 1], rng.normal(0, 2.0, n)]
    p[::3, :3] = p[::3, [2, 1, 0]]  # some far from +z
    p[1::4] *= -1.0
    return p.astype(np.float32)


@pytest.mark.parametrize("kind", ["xyz", "xy", "quat", "vec", "plane"])
def test_prior_residual_and_jacobian(kind):
    """Each unary prior type: residual and Jacobian (P,4,6) equal to the
    reference's `jacfwd` through its branchless select, to 1e-5 of scale."""
    p_type = ["xyz", "xy", "quat", "vec", "plane"].index(kind)
    rng = np.random.default_rng(10 + p_type)
    t = _poses(rng, 24)
    meas = np.stack([PRIOR_MEAS[p_type](rng, pose) for pose in t]).astype(np.float32)
    types = np.full(24, p_type, np.int32)
    r, jac = jax.vmap(jpg._prior_res_jac)(jnp.asarray(t), jnp.asarray(types), jnp.asarray(meas))
    r_t, jac_t = tpg._prior_res_jac(torch.from_numpy(t), torch.from_numpy(types), torch.from_numpy(meas))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r), rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac), rtol=0, atol=1e-5 * np.abs(jac).max())


def test_se3_plane_residual_and_jacobian():
    """EdgeSE3Plane: residual (S,3) and Jacobians (S,3,6), (S,3,3) w.r.t.
    the pose and the plane, against the reference's `jacfwd`."""
    rng = np.random.default_rng(20)
    t, pl, meas = _poses(rng, 24), _planes(rng, 24), _planes(rng, 24)
    r, jt, jp = jax.vmap(jpg._sp_res_jac)(*(jnp.asarray(a) for a in (t, pl, meas)))
    got = tpg._sp_res_jac(*(torch.from_numpy(a) for a in (t, pl, meas)))
    for a, b in zip(got, (r, jt, jp)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("kind", ["identity", "parallel", "perpendicular", "prior_normal", "prior_distance"])
def test_plane_edge_residual_and_jacobian(kind):
    """Each plane-plane / plane-prior type: residual (R,4) and Jacobians
    (R,4,3) x 2 against the reference's `jacfwd`."""
    q_type = ["identity", "parallel", "perpendicular", "prior_normal", "prior_distance"].index(kind)
    rng = np.random.default_rng(30 + q_type)
    p1, p2 = _planes(rng, 24), _planes(rng, 24)
    meas = rng.normal(0, 0.3, (24, 4)).astype(np.float32)
    if q_type == jpg.PLANE_PRIOR_NORMAL:
        meas[:, :3] = _planes(rng, 24)[:, :3] / np.linalg.norm(_planes(rng, 24)[:, :3], axis=1, keepdims=True)
    types = np.full(24, q_type, np.int32)
    want = jax.vmap(jpg._q_res_jac)(*(jnp.asarray(a) for a in (p1, p2, types, meas)))
    got = tpg._q_res_jac(*(torch.from_numpy(a) for a in (p1, p2, types, meas)))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))


def _every_factor_graph(seed: int = 1):
    """8 keyframes on a noisy chain with odometry edges; GPS, IMU
    orientation and gravity priors on every keyframe, an XY and a legacy
    plane prior; a fixed floor plane and two free planes; SE3-plane edges
    from every keyframe; one plane-plane edge of each type."""
    rng = np.random.default_rng(seed)
    n = 8
    g = jpg.empty_graph(16, 32, 32, 4, 8, 8)
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ _exp(np.r_[rng.normal(0, 2, 3), rng.normal(0, 0.1, 3)]))
    for i in range(n):
        jpg.add_node(g, i, gt[i] @ _exp(rng.normal(0, 0.05, 6)))
    for i in range(1, n):
        meas = np.linalg.inv(gt[i]) @ gt[i - 1] @ _exp(rng.normal(0, 0.02, 6))
        jpg.add_se3_edge(g, i - 1, i, i - 1, meas, np.diag([2.0] * 3 + [10.0] * 3), huber=1.0)
    p = 0
    for i in range(n):
        for kind, info in ((jpg.PRIOR_XYZ, np.diag([0.05, 0.05, 0.2])), (jpg.PRIOR_QUAT, np.eye(3) * 10),
                           (jpg.PRIOR_VEC, np.eye(3) * 5)):
            jpg.add_prior(g, p, i, kind, PRIOR_MEAS[kind](rng, gt[i]), info, huber=1.0)
            p += 1
    jpg.add_prior(g, p, 2, jpg.PRIOR_XY, gt[2][:2, 3], np.eye(2))
    jpg.add_prior(g, p + 1, 3, jpg.PRIOR_PLANE, [0.01, 0.02, 1, -1.7], np.eye(4) * 3)
    jpg.add_plane_node(g, 0, [0, 0, 1, 0], fixed=True)
    jpg.add_plane_node(g, 1, [0.1, 0.05, 1, -2.0])
    jpg.add_plane_node(g, 2, [1, 0.3, 0.02, 5.0])
    for i in range(n):
        jpg.add_se3_plane_edge(g, i, i, 0 if i % 2 else 1, [0.02, -0.01, 1, 1.73 + 0.05 * i], np.eye(3) * 10,
                               huber=1.0)
    for q_type in range(5):
        jpg.add_plane_edge(g, q_type, 1, 2 if q_type < 3 else 1, q_type, [0.05, 0.02, -0.01, 0.1], np.eye(4) * 2,
                           huber=1.0)
    return g


def test_chi2_and_normal_every_factor():
    """chi2 (the edges' robust chi2 plus the other factors' plain chi2), H
    and b of a graph holding every factor family, to 1e-5 of their scale."""
    g = _every_factor_graph()
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    chi2, h, b = jax.jit(lambda g: jpg._chi2_and_normal(g, g.poses, g.planes, True))(jg)
    tg = pose_graph_from_numpy(g, "cpu")
    chi2_t, h_t, b_t = tpg._chi2_and_normal(tg, tg.poses, build=True)
    np.testing.assert_allclose(float(chi2_t), float(chi2), rtol=1e-5)
    h, b = np.asarray(h), np.asarray(b)
    np.testing.assert_allclose(h_t.numpy(), h, rtol=0, atol=1e-5 * np.abs(h).max())
    np.testing.assert_allclose(b_t.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


def _chain(rng, n=12, drift=0.03):
    """`tests/test_pose_graph.py::_chain_graph` without its loop: a circle
    of radius 10 m, odometry edges with drift noise, the integrated estimates."""
    gt = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False):
        c, s = np.cos(a + np.pi / 2), np.sin(a + np.pi / 2)
        pose = np.eye(4)
        pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        pose[:3, 3] = [10.0 * np.cos(a), 10.0 * np.sin(a), 0]
        gt.append(pose)
    graph = jpg.empty_graph(32, 64, 16)
    est = [gt[0]]
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i] @ _exp(rng.normal(0, drift, 6) * [1, 1, 0.2, 0.05, 0.05, 1])
        est.append(est[-1] @ rel)
        jpg.add_se3_edge(graph, i - 1, i, i - 1, np.linalg.inv(rel), np.eye(6) * 10.0)
    for i, pose in enumerate(est):
        jpg.add_node(graph, i, pose)
    return graph, np.stack(gt), np.stack(est)


def _gps_graph(rng):
    graph, gt, _ = _chain(rng)
    for slot, i in enumerate(range(0, 12, 3)):
        jpg.add_prior(graph, slot, i, jpg.PRIOR_XYZ, gt[i][:3, 3], np.eye(3) * 100.0)
    return graph


def _floor_graph(rng):
    graph, gt, est = _chain(rng, drift=0.0)
    for i in range(12):
        bad = est[i].copy()
        bad[2, 3] += 0.15 * i
        jpg.add_node(graph, i, bad)
    jpg.add_plane_node(graph, 0, [0.0, 0.0, 1.0, 0.0], fixed=True)
    floor = jnp.asarray([0.0, 0.0, 1.0, 0.0], jnp.float32)
    for i in range(12):
        meas = np.asarray(jfactors.plane_transform(jnp.asarray(gt[i], jnp.float32), floor))
        jpg.add_se3_plane_edge(graph, i, i, 0, meas, np.eye(3) * 100.0)
    return graph


def _plane_graph(rng, kind):
    graph = jpg.empty_graph(4, 8, 4, plane_cap=4, sp_cap=8, q_cap=8)
    jpg.add_node(graph, 0, np.eye(4))
    tilted = np.array([0.2, -0.1, 0.97, 0.5])
    if kind == "normal":
        jpg.add_plane_node(graph, 0, tilted)
        jpg.add_plane_edge(graph, 0, 0, 0, jpg.PLANE_PRIOR_NORMAL, [1.0, 0.0, 0.0], np.eye(3) * 100.0)
        return graph
    jpg.add_plane_node(graph, 0, [0.0, 0.0, 1.0, 0.0], fixed=True)
    jpg.add_plane_node(graph, 1, tilted)
    if kind == "identity":
        jpg.add_plane_edge(graph, 0, 1, 0, jpg.PLANE_IDENTITY, np.zeros(4), np.eye(4) * 100.0)
    else:
        jpg.add_plane_edge(graph, 0, 1, 0, jpg.PLANE_PARALLEL, np.zeros(3), np.eye(3) * 100.0)
        jpg.add_plane_edge(graph, 1, 1, 1, jpg.PLANE_PRIOR_DISTANCE, [2.0], np.eye(1) * 100.0)
    return graph


@pytest.mark.parametrize("which", ["gps", "floor", "plane_identity", "plane_parallel", "plane_normal"])
def test_optimize_with_priors_and_planes(which):
    """`tests/test_pose_graph.py`'s GPS-prior, shared-floor and plane-plane
    graphs through both LMs: poses, planes and chi2. The iteration counts may
    differ (float32 noise in chi2 near convergence, see above); the results
    agree to 1e-3 (poses, m) and 1e-4 (planes), chi2 to 1e-3 relative."""
    rng = np.random.default_rng(0)
    graph = {"gps": _gps_graph, "floor": _floor_graph}.get(which, lambda r: _plane_graph(r, which[6:]))(rng)
    want = jax.jit(jpg.optimize_pose_graph, static_argnums=(1,))(jax.tree_util.tree_map(jnp.asarray, graph), 64)
    got = tpg.optimize_pose_graph(tpg.PoseGraph(*graph), 64, device="cpu")
    n = int(np.asarray(graph.node_valid).sum())
    print(f"{which}: iterations port {got.iterations}, reference {int(want.iterations)}; chi2 "
          f"{float(got.chi2_before):.6g} -> {float(got.chi2_after):.6g} (reference {float(want.chi2_after):.6g})")
    np.testing.assert_allclose(float(got.chi2_before), float(want.chi2_before), rtol=1e-5)
    np.testing.assert_allclose(float(got.chi2_after), float(want.chi2_after), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.poses.numpy()[:n], np.asarray(want.poses)[:n], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.planes.numpy(), np.asarray(want.planes), rtol=0, atol=1e-4)
    if which == "floor":  # the fixed floor vertex stays where it is
        np.testing.assert_array_equal(got.planes.numpy()[0], [0.0, 0.0, 1.0, 0.0])
