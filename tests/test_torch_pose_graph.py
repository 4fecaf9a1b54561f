"""The port's pose graph (kernel 15's plain twin and the LM loop) against
`lv_slam_tpu.graph.pose_graph` (CPU), on a seeded 16-node graph with
odometry and loop edges, Huber on, and a fixed anchor node.

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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core import se3 as jse3  # noqa: E402
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
    g = jax.tree_util.tree_map(np.array, graph)
    g.p_valid[0] = True
    with pytest.raises(NotImplementedError):
        tpg.optimize_pose_graph(tpg.PoseGraph(*g), 4, device="cpu")
