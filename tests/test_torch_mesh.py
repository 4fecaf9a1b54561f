"""The port's mesh (`lv_slam_tpu_torch.parallel.mesh`, over torch.distributed)
against the unsharded port and against lv_slam_tpu.parallel.mesh (CPU).

Each world is spawned once (`parallel.check.spawn`: gloo ranks on the CPU,
a FileStore under the test's tmp_path, a time limit) and runs the rank
body `parallel.check.sharded_cases` on each of its meshes: a world of 2 the
meshes (1, 2) and (2, 1), a world of 4 the mesh (2, 2); every mesh is held
to the unsharded port (`parallel.check.unsharded_cases`), and (1, 2) and
(2, 2) also to JAX's sharded functions on the same mesh of virtual CPU
devices. The inputs are tests/test_parallel.py's (its straight pair at
32 x 450 rays, cap 32768, the 1 m map built by the reference and
converted, so both packages read one map; the derivatives at x + 1 m,
DIRECT7 unweighted; the align of two copies of the pair from x = 1.2 m)
and tests/test_parallel_graph.py's (the 12-node chain with its loop, Huber
1, 32 LM iterations). The world of 4 aligns with a coarse phase on every
3rd lane (`coarse_subsample=3`): each of its point ranks holds 16384 lanes,
which 3 does not divide, so a rank's local stride picks other points than
a stride over the whole scan would, as JAX's shard does. Tolerances are
`parallel.check.TOLERANCES`, those tests': derivatives score rtol 1e-5,
gradient rtol 1e-4 / atol 1e-2, Hessian rtol 1e-3 / atol 1; aligns 5e-3;
the LM's chi2 before rtol 1e-4 and translations 5e-3. Every rank returns
the same bits (the collectives' sums are replicated), and on each mesh
`replicate_to_mesh`, `shard_sequences` and a two-lane fleet run too.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops.ndt import make_gauss_params as j_gauss  # noqa: E402
from lv_slam_tpu.ops.voxel_map import build_voxel_map as j_build, neighborhood_offsets as j_offsets  # noqa: E402
from lv_slam_tpu.parallel import mesh as jmesh  # noqa: E402
from lv_slam_tpu_torch.convert import voxel_map_from_numpy  # noqa: E402
from lv_slam_tpu_torch.parallel import check  # noqa: E402
from test_pose_graph import _chain_graph  # noqa: E402

WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
JAX_MESH = {2: (1, 2), 4: (2, 2)}  # the mesh of each world also run by JAX (a compile each, ~5-10 s)
ALIGN = dict(resolution=1.0, max_iterations=64, transformation_epsilon=0.01, neighborhood="DIRECT7", weighted=False)
COARSE = {2: 1, 4: 3}  # the aligns' coarse_subsample in each world
LM_ITERATIONS = 32


@pytest.fixture(scope="module")
def inputs():
    scans, poses, _ = synthetic.make_sequence(2, seed=7, trajectory="straight", step=1.0, n_rings=32, n_azimuth=450)
    target = JCloud.from_numpy(scans[0], cap=32768)
    source = JCloud.from_numpy(scans[1], cap=32768)
    vm = jax.jit(functools.partial(j_build, resolution=1.0, leaf_cap=16384, lut_extent=256))(target)
    leaves = {k: np.asarray(v) for k, v in vm._asdict().items()}
    key = voxel_map_from_numpy(leaves, "cpu")
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = 1.0
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 1.2
    graph, _, _ = _chain_graph(np.random.default_rng(0), n=12, with_loop=True, huber=1.0)
    return dict(
        jmap=vm, jsource=source, map={k: v.numpy() if isinstance(v, torch.Tensor) else v
                                      for k, v in key.vmap._asdict().items()},
        lut=key.lut.numpy(), xyz=np.asarray(source.masked_xyz()), mask=np.asarray(source.mask), T=t,
        guesses=np.stack([guess, guess]), graph={k: np.asarray(v) for k, v in graph._asdict().items()},
        jgraph=graph, gt=np.linalg.inv(poses[0]) @ poses[1],
    )


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, inputs, tmp_path_factory):
    """(world size, every rank's results per mesh shape, the unsharded
    port's results on the same inputs)."""
    n = request.param
    shipped = {k: inputs[k] for k in ("map", "lut", "xyz", "mask", "T", "guesses", "graph")}
    shipped["xyz"] = np.stack([inputs["xyz"]] * 2)
    shipped["mask"] = np.stack([inputs["mask"]] * 2)
    shipped.update(meshes=WORLDS[n], align=dict(ALIGN, coarse_subsample=COARSE[n]), lm_iterations=LM_ITERATIONS,
                   device="cpu", fleet=True)
    ranks = check.spawn(n, "sharded_cases", shipped, tmp_path_factory.mktemp(f"world{n}"))
    return n, ranks, check.unsharded_cases(shipped)


def _jax_mesh(shape):
    return jmesh.make_mesh(n_batch=shape[0], n_point=shape[1], devices=jax.devices()[: shape[0] * shape[1]])


def test_every_rank_returns_the_same_bits(world):
    n, ranks, _ = world
    check.check_same_bits(ranks)


def test_replication_and_the_fleet_on_a_mesh(world):
    """`replicate_to_mesh` gives every rank rank 0's tensor; the fleet's
    lanes split over "batch" and gathered back are every lane once, and the
    fleet of two lanes on the mesh (each "batch" row its block) equals the
    fleet without a mesh bit for bit."""
    n, ranks, _ = world
    for shape, res in ranks[0].items():
        np.testing.assert_array_equal(res["replicated"], np.ones(3, np.float32))
        np.testing.assert_array_equal(res["lanes"], np.arange(4))
        np.testing.assert_array_equal(res["fleet"], res["fleet_unsharded"])
        assert np.isfinite(res["fleet"]).all()


def test_sharded_derivatives_match(world, inputs):
    """Against the unsharded port and JAX's sharded pass on the same mesh."""
    n, ranks, unsharded = world
    jfn = jax.jit(lambda m: jmesh.ndt_derivatives_sharded(
        m, inputs["jmap"], jnp.asarray(inputs["xyz"]), jnp.asarray(inputs["mask"]), jnp.asarray(inputs["T"]),
        j_gauss(1.0), j_offsets("DIRECT7"), False), static_argnums=0)
    for shape, res in ranks[0].items():
        check.check_derivatives(res, (unsharded["score"], unsharded["grad"], unsharded["hess"]))
    check.check_derivatives(ranks[0][JAX_MESH[n]], jfn(_jax_mesh(JAX_MESH[n])))


def test_sharded_align_matches(world, inputs):
    """Both pairs of the batch against the unsharded port's align and JAX's
    sharded align on the same mesh (with the world's coarse phase), and
    near the true step."""
    n, ranks, unsharded = world
    jfn = jax.jit(functools.partial(jmesh.ndt_align_sharded, **ALIGN, coarse_subsample=COARSE[n]),
                  static_argnums=0)
    vms = jmesh.stack_maps([inputs["jmap"]] * 2)
    xyz = jnp.stack([jnp.asarray(inputs["xyz"])] * 2)
    mask = jnp.stack([jnp.asarray(inputs["mask"])] * 2)
    for shape, res in ranks[0].items():
        check.check_aligns(res, unsharded["transforms"])
        assert np.linalg.norm(res["transforms"][0][:3, 3] - inputs["gt"][:3, 3]) < 0.2
        assert (res["iterations"] > 0).all()
    want, _, want_it = jfn(_jax_mesh(JAX_MESH[n]), vms, xyz, mask, jnp.asarray(inputs["guesses"]))
    check.check_aligns(ranks[0][JAX_MESH[n]], want)
    print(f"world of {n}, coarse_subsample {COARSE[n]}: iterations {ranks[0][JAX_MESH[n]]['iterations']}, "
          f"JAX's {np.asarray(want_it)}")


def test_sharded_pose_graph_matches(world, inputs):
    """Against the unsharded port and JAX's sharded LM on the same mesh:
    chi2 before rtol 1e-4, the 12 translations 5e-3, chi2 not raised."""
    n, ranks, unsharded = world
    jfn = jax.jit(jmesh.optimize_pose_graph_sharded, static_argnums=(0, 2))
    want = jfn(_jax_mesh(JAX_MESH[n]), inputs["jgraph"], LM_ITERATIONS)
    for shape, res in ranks[0].items():
        check.check_lm(res, unsharded["chi2_before"], unsharded["lm_poses"])
        if shape == JAX_MESH[n]:
            check.check_lm(res, want.chi2_before, np.asarray(want.poses)[:12])
