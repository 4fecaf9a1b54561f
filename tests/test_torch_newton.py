"""The device-form Newton loop (K7) on the CPU: the loop with the plain
twins (`ops/ndt._newton_loop`, `newton_step_ref`) against the loops it
replaced, bit for bit, for several group sizes `NEWTON_GROUP`; and the
aligns built on it, the batched one of the loop verification included,
against JAX on the map of tests/test_torch_ndt.py at that file's
tolerances (tests/test_torch_loop_detector.py holds the whole
verification through `dispatch_one`).

The replaced loops are kept here verbatim (`_old_newton_loop`,
`_old_newton_loop_batched`) as the oracle: a host loop of small torch ops
that read `converged` (or the k done flags) every iteration."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops import ndt as jn, ndt_hash as jh, ndt_soa as js  # noqa: E402
from lv_slam_tpu.ops.voxel_map import build_voxel_map  # noqa: E402
from lv_slam_tpu_torch.convert import voxel_map_from_numpy  # noqa: E402
from lv_slam_tpu_torch.core import se3  # noqa: E402
from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import ndt as tn, ndt_hash as th, ndt_soa as ts  # noqa: E402
from lv_slam_tpu_torch.ops.voxel_map import neighborhood_offsets  # noqa: E402

GROUPS = [1, 3, tn.NEWTON_GROUP]


# ------------------------------------------------------------ the replaced loops


def _old_newton_loop(derivs, guess, eps, step_max, max_iterations, dof=None):
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
        if dof is not None:
            grad = grad * dof
            hess = hess * dof[:, None] * dof[None, :] - (1.0 - dof) * eye6
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


def _old_newton_loop_batched(derivs, guesses, eps, step_max, max_iterations):
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


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int64)


def _same(a, b) -> bool:
    """Bit for bit (a NaN equals the same NaN; -0.0 differs from 0.0)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _run_new(derivs, guess, eps, step_max, max_iterations, dof_mask=None):
    state = tn.NewtonState(guess[None])
    plain = lambda transforms, active: derivs(transforms[0])  # noqa: E731
    tn._newton_loop(tn.DerivativePass(plain, None, 0), state, eps, step_max, max_iterations, dof_mask=dof_mask)
    f, s = state.f[0], state.s[0]
    return (state.transforms[0], f[tn.F_SCORE], f[tn.F_GRAD:tn.F_GRAD + 6], f[tn.F_HESS:tn.F_HESS + 36].view(6, 6),
            f[tn.F_CAP], s[tn.S_IT], s[tn.S_DONE] != 0)


def _assert_single_equal(old, new):
    names = ("transform", "score", "grad", "hess", "cap", "iterations", "converged")
    for name, a, b in zip(names, old, new):
        assert _same(a, b), (name, a, b)


# ------------------------------------------------------------ maps


@pytest.fixture(scope="module")
def setup():
    """tests/test_torch_ndt.py's setup: a weighted 1 m keyframe map of a
    figure-8 scan built by the reference (its hash table handed to both
    sides), the next scan as the source."""
    scans, poses, _ = synthetic.make_sequence(2, seed=41, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=450)
    target = JCloud.from_numpy(scans[0], cap=16384)
    vm = jax.jit(functools.partial(build_voxel_map, resolution=1.0, leaf_cap=16384, lut_extent=256, weighted=True))(
        target)
    jmap = jax.jit(jh.to_hash)(vm)
    tmap = th.HashVoxelMap(
        table=torch.from_numpy(np.array(jmap.table)), origin_cell=torch.from_numpy(np.array(jmap.origin_cell)),
        resolution=float(jmap.resolution), extent=int(jmap.extent),
        n_dropped=torch.tensor(int(jmap.n_dropped), dtype=torch.int32),
    )
    key = voxel_map_from_numpy({k: np.asarray(v) for k, v in vm._asdict().items()}, "cpu")
    return jmap, tmap, vm, key, scans[1], np.linalg.inv(poses[0]) @ poses[1]


def _guess(x=1.4, y=0.0, yaw=0.0, z=0.0):
    g = se3.exp_se3(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, yaw], dtype=torch.float32)).clone()
    g[0, 3], g[1, 3], g[2, 3] = x, y, z
    return g


def _hash_derivs(setup, weighted=True, neighborhood="DIRECT1"):
    _, tmap, _, _, src, _ = setup
    cloud = TCloud.from_numpy(src, cap=16384, device="cpu")
    xs, mask = cloud.masked_xyz().T.contiguous(), cloud.mask
    gauss, offsets = tn.make_gauss_params(1.0), neighborhood_offsets(neighborhood, "cpu")
    return lambda t: th.ndt_derivatives_hash_ref(tmap, xs, mask, t, gauss, offsets, weighted)


def _quadratic(target):
    """A smooth synthetic score with its maximum at translation `target`."""
    def derivs(t):
        d = t[:3, 3] - target
        grad = torch.cat([-2.0 * d, torch.zeros(3)])
        return -torch.sum(d * d), grad, -2.0 * torch.eye(6)
    return derivs


def _rejecting(t0):
    """A score that falls off every step from the guess, while its gradient
    keeps proposing one: every candidate is rejected until the cap shrinks
    below eps / 2."""
    def derivs(t):
        d = t[:3, 3] - t0[:3, 3]
        return -100.0 * torch.sqrt(torch.sum(d * d)), torch.tensor([1.0, 0, 0, 0, 0, 0]), -torch.eye(6)
    return derivs


def _nan_start(t):
    return torch.tensor(float("nan")), torch.zeros(6), torch.zeros(6, 6)


# ------------------------------------------------------------ (a) bit for bit


CASES = {
    # the hash pass converges by eps from a 1.4 m guess
    "eps": lambda s: (_hash_derivs(s), _guess(1.4, 0.1, 0.02), 64, None),
    # the iteration cap: max_iterations 2 from far away
    "cap": lambda s: (_hash_derivs(s), _guess(2.5, -0.5, 0.05), 2, None),
    # a smooth score, several capped steps, then eps
    "quadratic": lambda s: (_quadratic(torch.tensor([0.35, -0.2, 0.05])), _guess(0.0), 64, None),
    # every step rejected until the cap shrinks out
    "shrunk_out": lambda s: (_rejecting(_guess(0.3)), _guess(0.3), 64, None),
    # a NaN first score stops before any step
    "nan_start": lambda s: (_nan_start, _guess(0.3), 64, None),
    # the ground NDT's frozen dims (z, roll, pitch free) on the hash pass
    "dof": lambda s: (_hash_derivs(s, False, "DIRECT7"), _guess(1.3, 0.2, 0.03, z=0.3), 64,
                      (False, False, True, True, True, False)),
}


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_equals_the_host_loop(setup, monkeypatch, case, group):
    """Transform, score, gradient, Hessian, cap, iteration count and the
    converged flag equal the replaced loop's bit for bit, whatever the group."""
    monkeypatch.setattr(tn, "NEWTON_GROUP", group)
    derivs, guess, max_it, dof_mask = CASES[case](setup)
    dof = None if dof_mask is None else torch.tensor(dof_mask, dtype=torch.float32)
    old = _old_newton_loop(derivs, guess, np.float32(0.01), 0.1, max_it, dof=dof)
    new = _run_new(derivs, guess, np.float32(0.01), 0.1, max_it, dof_mask)
    _assert_single_equal(old, new)
    expect_it = {"cap": 3, "shrunk_out": 6, "nan_start": 0}
    if case in expect_it:
        assert int(new[5]) == expect_it[case]
    else:
        assert int(new[5]) >= 2


@pytest.mark.parametrize("group", GROUPS)
def test_batched_device_loop_equals_the_host_loop(setup, monkeypatch, group):
    """K13's batch: four candidates (one with a NaN guess) that stop at
    different iterations keep their states bit for bit while the others run
    on, as the vmapped loop's `take = run & accept`."""
    monkeypatch.setattr(tn, "NEWTON_GROUP", group)
    _, tmap, _, _, src, _ = setup
    cloud = TCloud.from_numpy(src, cap=16384, device="cpu")
    xyz = torch.stack([cloud.xyz] * 4)
    mask = torch.stack([cloud.mask] * 4)
    xs = torch.where(mask[..., None], xyz, SENTINEL).transpose(1, 2).contiguous()
    gauss, offsets = tn.make_gauss_params(1.0), neighborhood_offsets("DIRECT1", "cpu")
    guesses = torch.stack([_guess(1.4), _guess(1.1, 0.3, 0.03), _guess(0.9), _guess(1.2)])
    guesses[3, 0, 0] = float("nan")

    def derivs(transforms, active):
        return th.ndt_derivatives_hash_batched_ref(tmap, xs, mask, transforms, gauss, offsets, True, active)

    old_t, old_s, old_it = _old_newton_loop_batched(derivs, guesses, 0.01, 0.1, 16)
    new_t, new_s, new_it = th.ndt_align_hash_table_batched(
        tmap, TCloud(xyz, torch.zeros(mask.shape), mask), guesses, resolution=1.0, transformation_epsilon=0.01,
        max_iterations=16, neighborhood="DIRECT1", weighted=True)
    assert _same(old_t, new_t) and _same(old_s, new_s) and torch.equal(old_it, new_it.to(torch.int64))
    assert len(set(new_it.tolist())) >= 3, new_it  # the lanes stop at different iterations, one at the start
    assert int(new_it[3]) == 0


# ------------------------------------------------------------ (b) the aligns against JAX


@pytest.mark.parametrize("coarse_subsample", [1, 2])
def test_hash_align_against_jax(setup, monkeypatch, coarse_subsample):
    """`ndt_align_hash_table` equals the replaced loop's result bit for bit
    for every group size, and JAX's to 1e-4 with the same iteration count
    (tests/test_torch_ndt.py's tolerance)."""
    jmap, tmap, _, _, src, gt = setup
    kw = dict(resolution=1.0, transformation_epsilon=0.01, max_iterations=64, neighborhood="DIRECT1", weighted=True,
              coarse_subsample=coarse_subsample)
    guess = _guess(1.4)
    cloud = TCloud.from_numpy(src, cap=16384, device="cpu")
    results = []
    for group in GROUPS:
        monkeypatch.setattr(tn, "NEWTON_GROUP", group)
        results.append(th.ndt_align_hash_table(tmap, cloud, guess, **kw))
    for r in results[1:]:
        assert all(_same(a, b) for a, b in zip(r, results[0]))
    got = results[0]
    want = jax.jit(functools.partial(jh.ndt_align_hash_table, **kw))(
        jmap, JCloud.from_numpy(src, cap=16384), jnp.asarray(guess.numpy()))
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    assert np.linalg.norm(got.transform.numpy()[:3, 3] - gt[:3, 3]) < 0.05


def test_lut_and_generic_aligns_against_jax(setup, monkeypatch):
    """`ndt_align_soa_table` (K6L's pass) and `ndt_align` (K6G's, with and
    without `dof_mask`) for every group size, bit for bit alike, and
    against JAX's `ndt_align_soa` / `ndt_align` to 1e-3
    (tests/test_torch_ndt.py's tolerances)."""
    _, _, vm, key, src, _ = setup
    cloud = TCloud.from_numpy(src, cap=16384, device="cpu")
    jsrc = JCloud.from_numpy(src, cap=16384)
    kw = dict(resolution=1.0, transformation_epsilon=0.01, max_iterations=64)
    guess = _guess(1.4)
    dof = (True, True, False, False, False, True)
    soa = ts.to_soa(key.vmap, key.lut)
    runs = {
        "soa": lambda: ts.ndt_align_soa_table(soa, cloud, guess, neighborhood="DIRECT1", weighted=True, **kw),
        "generic": lambda: tn.ndt_align(key.vmap, key.lut, cloud, guess, neighborhood="DIRECT1", weighted=True, **kw),
        "dof": lambda: tn.ndt_align(key.vmap, key.lut, cloud, guess, neighborhood="DIRECT7", weighted=False,
                                    dof_mask=dof, **kw),
    }
    jax_runs = {
        "soa": functools.partial(js.ndt_align_soa, neighborhood="DIRECT1", weighted=True, **kw),
        "generic": functools.partial(jn.ndt_align, neighborhood="DIRECT1", weighted=True, **kw),
        "dof": functools.partial(jn.ndt_align, neighborhood="DIRECT7", weighted=False, dof_mask=dof, **kw),
    }
    for name, run in runs.items():
        results = []
        for group in GROUPS:
            monkeypatch.setattr(tn, "NEWTON_GROUP", group)
            results.append(run())
        for r in results[1:]:
            assert all(_same(a, b) for a, b in zip(r, results[0])), name
        want = jax.jit(jax_runs[name])(vm, jsrc, jnp.asarray(guess.numpy())).transform
        np.testing.assert_allclose(results[0].transform.numpy(), np.asarray(want), rtol=0, atol=1e-3, err_msg=name)


def test_batched_align_against_jax(setup):
    """The batched align (K13's loop) against JAX's vmapped
    `ndt_align_hash_table` on the same table: transforms to 1e-4 and the same
    iteration count per candidate (1, 3 and 9 steps: the candidates stop at
    different iterations; DIRECT1, where each converges, as
    tests/test_torch_ndt.py's align: DIRECT7 lanes that run to the cap
    cycle, and float32 noise then moves them by centimetres in both
    packages alike)."""
    jmap, tmap, _, _, src, _ = setup
    guesses = torch.stack([_guess(1.4), _guess(1.1, 0.3, 0.03), _guess(0.9)])
    kw = dict(resolution=1.0, transformation_epsilon=0.01, max_iterations=16, neighborhood="DIRECT1", weighted=True)
    cloud = TCloud.from_numpy(src, cap=16384, device="cpu")
    batch = TCloud(*(torch.stack([a] * 3) for a in cloud))
    got_t, _, got_it = th.ndt_align_hash_table_batched(tmap, batch, guesses, **kw)
    jsrc = JCloud.from_numpy(src, cap=16384)
    align = jax.jit(jax.vmap(lambda g: jh.ndt_align_hash_table(jmap, jsrc, g, **kw)))
    want = align(jnp.asarray(guesses.numpy()))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want.transform), rtol=0, atol=1e-4)
    assert got_it.tolist() == np.asarray(want.iterations).tolist()


@pytest.mark.parametrize("n_blocks", [1, 5, 700])
def test_newton_sums_twin_adds_in_block_order(n_blocks):
    """`newton_sums_ref`, the yardstick of K7s on the card, is a float32 sum
    from zero in block order: the last row of numpy's float32 cumulative sum
    over the blocks, bit for bit, and zeros for a finished lane."""
    rng = np.random.default_rng(n_blocks)
    rows = (rng.standard_normal((3, n_blocks, tn.N_TERMS)) * np.logspace(-3, 6, tn.N_TERMS)).astype(np.float32)
    state = tn.NewtonState(torch.eye(4).expand(3, 4, 4).contiguous(), batched=True)
    state.partials = torch.from_numpy(rows.reshape(-1))
    state.s[1, tn.S_DONE] = 1
    want = np.cumsum(rows, axis=1, dtype=np.float32)[:, -1]
    want[1] = 0.0
    got = tn.newton_sums_ref(state, n_blocks).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if n_blocks > 1:  # the order shows: another order of the same adds gives other bits
        assert not np.array_equal(np.sum(rows[:, ::-1], axis=1, dtype=np.float32)[0], want[0])


# ------------------------------------------------------------ (c) chip_smoke's newton_cases against JAX


def _chip_smoke():
    """chip_smoke.py as a module (it imports numpy only at the top)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _jax_derivs(hess, x_star, nan):
    """The case's canned quadratic (chip_smoke.canned_derivatives) in JAX,
    for one lane: (score, grad (6,), hess (6, 6)) at a (4, 4) transform."""
    hess, x_star = jnp.asarray(hess), jnp.asarray(x_star)

    def derivs(t):
        x = jnp.stack([t[0, 3], t[1, 3], t[2, 3], t[2, 1], t[0, 2], t[1, 0]])
        d = x - x_star
        grad = jnp.sum(hess * d[None, :], axis=1)
        score = jnp.where(nan, jnp.float32(jnp.nan), 0.5 * jnp.sum(d * grad))
        return score, grad, hess

    return derivs


def _port_loop(case):
    """The port's twin loop (`ops/ndt._newton_loop` on the CPU) on the case's
    canned derivatives: (transforms, iterations, done) per lane."""
    derivs = CS.canned_derivatives(torch, case, "cpu")
    k = len(case.t0)
    state = tn.NewtonState(torch.from_numpy(case.guesses()), batched=k > 1)

    def plain(transforms, active):
        score, grad, hess = derivs(transforms)
        return (score, grad, hess) if k > 1 else (score[0], grad[0], hess[0])

    tn._newton_loop(tn.DerivativePass(plain, None, 0), state, np.float32(0.01), 0.1, case.max_iterations,
                    dof_mask=case.dof_mask)
    return state.transforms.numpy(), state.iterations.numpy(), (state.s[:, tn.S_DONE] != 0).numpy()


def _jax_loop(case, monkeypatch):
    """JAX's loop on the same derivatives: `ndt_soa._newton_loop` (vmapped
    over the lanes), or with a `dof_mask` `ndt.ndt_align`'s loop, whose
    pass is the canned function in place of `ndt_derivatives`."""
    eps, step_max = jnp.float32(0.01), jnp.float32(0.1)
    guesses = jnp.asarray(case.guesses())
    if case.dof_mask is None:
        def one(guess, x_star, nan):
            return js._newton_loop(_jax_derivs(case.hess, x_star, nan), guess, eps, step_max, case.max_iterations)

        transform, _, _, _, _, it, done = jax.vmap(one)(guesses, jnp.asarray(case.x_star), jnp.asarray(case.nan))
        return np.asarray(transform), np.asarray(it), np.asarray(done)
    derivs = _jax_derivs(case.hess, case.x_star[0], case.nan[0])
    monkeypatch.setattr(jn, "ndt_derivatives", lambda vmap_, xyz, mask, t, *rest: derivs(t))
    cloud = JCloud.from_numpy(np.zeros((8, 4), np.float32), cap=8)
    got = jn.ndt_align(None, cloud, guesses[0], resolution=1.0, transformation_epsilon=0.01, step_size=0.1,
                       max_iterations=case.max_iterations, dof_mask=case.dof_mask)
    return np.asarray(got.transform)[None], np.asarray(got.iterations)[None], np.asarray(got.converged)[None]


@pytest.mark.parametrize("name", CS.NEWTON_CASE_NAMES)
def test_newton_cases_against_jax(name, monkeypatch):
    """chip_smoke's `newton_cases` (the kernel's edge cases on the card: a
    zero pivot, row swaps, a NaN start, the ground NDT's dof masks, steps at
    step_min and at the cap, max_iterations, 1 and 2049 rows, a batch with a
    NaN start) through the port's twin loop and JAX's loop on the same
    canned quadratic: the transforms to 1e-4, iterations and converged flags
    equal (the tolerance of the aligns against JAX above)."""
    case = {c.name: c for c in CS.newton_case_specs()}[name]
    got_t, got_it, got_done = _port_loop(case)
    want_t, want_it, want_done = _jax_loop(case, monkeypatch)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-4)
    assert got_it.tolist() == want_it.tolist()
    assert got_done.tolist() == want_done.tolist()
    if name == "zero pivot":  # the exact zero pivot ends the loop as `bad` after one iteration, at the guess
        assert got_it.tolist() == [1] and np.array_equal(got_t[0], case.guesses()[0])
