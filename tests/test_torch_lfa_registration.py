"""The port's correspondences and Gauss-Newton (the plain twins of kernels
9k, 10 and 11 on the CPU) against lv_slam_tpu.lfa.registration.

Scan-to-scan (`lines_from_2nn`, `planes_from_3nn`): for each pair of
consecutive `small_sequence` scans, the first scan's less-sharp / less-flat
features as the sorted grids, the second's sharp / flat features moved by
the true relative pose as queries. Every field is identical to the
reference's (measured: no query differs, as the port rounds the distances,
norms, cross products and offsets as XLA's CPU fma chains do, so no tie of
near-equal candidates swaps).

Scan-to-map:

The world maps are built by the reference (its features of the conftest
`small_sequence` scans 0-3 inserted at the true poses) and handed to both
sides as the same table; the queries are scan 4's features at its true
pose, and `gn_solve` starts 0.3 m off that pose from the same fields.

Tolerances: accept decisions identical (measured: none differs); fitted
means, directions, normals and offsets of accepted queries to 2e-5 (XLA
sums the 48 candidates and the 3x3 products in its own order, with FMAs;
measured max 7.6e-6); the solved pose to 1e-5 (measured 4.8e-7).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import LfaConfig as JLfa  # noqa: E402
from lv_slam_tpu.core import se3 as jse3  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.lfa import registration as jr  # noqa: E402
from lv_slam_tpu.lfa.features import extract_features  # noqa: E402
from lv_slam_tpu.ops import knn as jk  # noqa: E402
from lv_slam_tpu_torch.lfa import registration as tr  # noqa: E402
from lv_slam_tpu_torch.ops import gicp  # noqa: E402
from lv_slam_tpu_torch.ops.knn import CellTable, build_grid, knn_ref  # noqa: E402

KW = dict(scan_line=32, edge_cap=2048, planar_cap=4096, map_edge_cap=8192, map_planar_cap=16384)
FIT_ATOL = 2e-5
POSE_ATOL = 1e-5


@pytest.fixture(scope="module")
def setup(small_sequence):
    scans, gt, _ = small_sequence
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    cfg = JLfa(**KW)
    feats = [extract_features(JCloud.from_numpy(s, cap=32768), cfg) for s in scans[:5]]
    tables = [jk.empty_cell_table(4096, 6, 2.0), jk.empty_cell_table(8192, 6, 2.0)]
    ins = [jax.jit(lambda t, x, m, r=r: jk.insert_cell_table(t, x, m, r)) for r in (0.4, 0.8)]
    for f, pose in zip(feats[:4], gt_rel):
        t = jnp.asarray(pose)
        tables[0] = ins[0](tables[0], jse3.transform_points(t, f.less_sharp), f.less_sharp_mask)
        tables[1] = ins[1](tables[1], jse3.transform_points(t, f.less_flat), f.less_flat_mask)
    f4, pose4 = feats[4], jnp.asarray(gt_rel[4])
    queries = {
        "edge": (np.array(jse3.transform_points(pose4, f4.less_sharp)), np.array(f4.less_sharp_mask)),
        "surf": (np.array(jse3.transform_points(pose4, f4.less_flat)), np.array(f4.less_flat_mask)),
    }
    pts = {"edge": np.array(f4.less_sharp), "surf": np.array(f4.less_flat)}
    return tables, queries, pts, gt_rel[4]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables(setup):
    return [CellTable(_t(t.table), float(t.cell_size)) for t in setup[0]]


@pytest.mark.parametrize("kind", ["lines", "planes"])
def test_fits_match(setup, kind):
    tables, queries, _, _ = setup
    i, q = (0, "edge") if kind == "lines" else (1, "surf")
    y, m = queries[q]
    j_fn = jr.lines_from_fit if kind == "lines" else jr.planes_from_fit
    t_fn = tr.lines_from_fit if kind == "lines" else tr.planes_from_fit
    want = [np.asarray(a) for a in jax.jit(j_fn)(jnp.asarray(y), jnp.asarray(m), tables[i])]
    got = [a.numpy() for a in t_fn(_t(y), _t(m), _tables(setup)[i])]
    np.testing.assert_array_equal(got[2], want[2])
    v = want[2]
    assert v.sum() > 20, v.sum()
    for a, b in zip(got[:2], want[:2]):
        err = float(np.abs(a[v] - b[v]).max())
        print(f"{kind}: {int(v.sum())} accepted, max abs err {err:.3g} (tolerance {FIT_ATOL})")
        assert err <= FIT_ATOL
    if kind == "planes":  # rejected planes are zeroed
        assert (got[0][~v] == 0).all() and (got[1][~v] == 0).all()


def _chip_smoke():
    """chip_smoke.py as a module (it imports numpy only at the top)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
# kernel 10's edge cases (chip_smoke.fit_cases) but the one on the 1 m gate,
# which is held on the card only
FIT_CASES = [name for name in CS.FIT_CASE_NAMES if name != "d^2 exactly 1"]


@pytest.mark.parametrize("case", FIT_CASES)
def test_fit_edge_cases(case):
    """The CellTable branch's twins against JAX's `lines_from_fit` /
    `planes_from_fit` on kernel 10's edge cases (chip_smoke.fit_cases, run
    on the card against the same twins): accept decisions identical, the
    fitted floats of accepted queries to FIT_ATOL, every float finite."""
    (_, table, y, m, k), = [c for c in CS.fit_cases() if c[0] == case]
    jtable = jk.CellTable(table=jnp.asarray(table), cell_size=jnp.float32(CS.FIT_CELL))
    ttable = CellTable(_t(table), CS.FIT_CELL)
    for j_fn, t_fn in ((jr.lines_from_fit, tr.lines_from_fit), (jr.planes_from_fit, tr.planes_from_fit)):
        want = [np.asarray(a) for a in j_fn(jnp.asarray(y), jnp.asarray(m), jtable, k=k)]
        got = [a.numpy() for a in t_fn(_t(y), _t(m), ttable, k=k)]
        np.testing.assert_array_equal(got[2], want[2])
        v = want[2]
        for a, b in zip(got[:2], want[:2]):
            assert np.isfinite(a).all()
            err = float(np.abs(a[v] - b[v]).max(initial=0.0))
            print(f"{case}, {t_fn.__name__}: {int(v.sum())} of {len(v)} accepted, max abs err {err:.3g}")
            assert err <= FIT_ATOL


def test_gn_solve_matches(setup):
    tables, queries, pts, truth = setup
    lines = jr.lines_from_fit(jnp.asarray(queries["edge"][0]), jnp.asarray(queries["edge"][1]), tables[0])
    planes = jr.planes_from_fit(jnp.asarray(queries["surf"][0]), jnp.asarray(queries["surf"][1]), tables[1])
    seed = truth.copy()
    seed[0, 3] += 0.3
    want = np.asarray(jax.jit(jr.gn_solve, static_argnums=5)(
        jnp.asarray(seed), jnp.asarray(pts["edge"]), lines, jnp.asarray(pts["surf"]), planes, 8))
    got = tr.gn_solve(
        _t(seed), _t(pts["edge"]), tr.LineField(*map(_t, lines)), _t(pts["surf"]),
        tr.PlaneField(*map(_t, planes)), 8,
    ).numpy()
    err = float(np.abs(got - want).max())
    print(f"gn_solve: max abs err {err:.3g} (tolerance {POSE_ATOL})")
    assert err <= POSE_ATOL
    assert np.linalg.norm(got[:3, 3] - truth[:3, 3]) < 0.05  # pulled back from the 0.3 m seed
    nl, npl = tr.match_counts(tr.LineField(*map(_t, lines)), tr.PlaneField(*map(_t, planes)))
    assert (int(nl), int(npl)) == tuple(int(c) for c in jr.match_counts(lines, planes))


def test_gn_solve_ignores_invalid_sentinel_lanes():
    """Invalid sentinel lanes (1e6) cost nothing: their points and line
    means are zeroed before any nonlinear op (their directions are used as
    they are, in the reference too, so they must be finite)."""
    rng = np.random.default_rng(0)
    n = 64
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    normal = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    planes = tr.PlaneField(_t(normal), _t(-pts[:, 2]), torch.ones(n, dtype=torch.bool))
    lines = tr.LineField(torch.full((n, 3), 1e6), torch.full((n, 3), 0.5), torch.zeros(n, dtype=torch.bool))
    edges = torch.full((n, 3), 1e6)
    seed = torch.eye(4)
    seed[2, 3] = 0.05
    out = tr.gn_solve(seed, edges, lines, _t(pts), planes, 8)
    assert torch.isfinite(out).all()
    assert abs(float(out[2, 3])) < 1e-4


def _noise_lanes(y, grid, k=5):
    """Queries whose k nearest within 1 m lie on a line to rounding (eigen
    gap (lambda1 - lambda0) / lambda2 at most gicp.GAP_SPLIT = sqrt(float32
    eps)): their fitted frame is noise in every implementation (eigh3x3's
    near-repeated eigenvalue pair, ROADMAP's parity findings), so only
    their accept decision is compared."""
    dists, pts, valid = knn_ref(grid, _t(y), k)
    return (gicp.eigen_gap(pts, valid & (dists < 1.0)) <= gicp.GAP_SPLIT).numpy()


def _field_moves(a, b):
    """Per query, the largest difference of the fitted floats."""
    return np.maximum(np.abs(a[0] - b[0]).max(axis=1), np.abs(a[1] - b[1]).reshape(len(a[1]), -1).max(axis=1))


def _nudge(x, seed):
    """Every float32 coordinate moved by -1, 0 or +1 ulp."""
    r = np.random.default_rng(seed).integers(-1, 2, x.shape)
    return np.where(r != 0, np.nextafter(x, np.where(r > 0, np.inf, -np.inf).astype(np.float32)), x)


def _grid_fits(kind, x, xm, y, ym):
    """The KnnGrid branch of `kind` ("lines" / "planes") on grid (x, xm) and
    queries (y, ym), k = 5, against JAX's: accept decisions identical (else
    AssertionError). Returns (accepted, planes left out, max abs err of the
    fitted floats, the reference's own spread): the err and spread over the
    accepted queries but the planes whose neighbours lie on a line
    (`_noise_lanes`), the spread the largest move of JAX's fields under
    one-ulp noise on the grid and the queries (8 perturbations)."""
    j_fn = jr.lines_from_fit if kind == "lines" else jr.planes_from_fit
    t_fn = tr.lines_from_fit if kind == "lines" else tr.planes_from_fit
    fit = jax.jit(lambda xx, mm, yy, ymm: j_fn(yy, ymm, jk.build_grid(xx, mm, 2.0)))
    grid = build_grid(_t(x), _t(xm), 2.0)
    want = [np.asarray(a) for a in fit(x, xm, y, ym)]
    got = [a.numpy() for a in t_fn(_t(y), _t(ym), grid)]
    np.testing.assert_array_equal(got[2], want[2])
    noise = _noise_lanes(y, grid) if kind == "planes" else np.zeros_like(want[2])
    v = want[2] & ~noise
    spread = 0.0
    for s in range(8):
        ref = [np.asarray(a) for a in fit(np.where(xm[:, None], _nudge(x, 2 * s), x), xm, _nudge(y, 2 * s + 1), ym)]
        spread = max(spread, float(_field_moves(ref, want)[v & ref[2]].max(initial=0.0)))
    err = float(_field_moves(got, want)[v].max(initial=0.0))
    return int(want[2].sum()), int((want[2] & noise).sum()), err, spread


def test_standalone_branches_not_ported():
    """The fits' sorted-grid branches (5-NN fits on a KnnGrid), which
    raised before kernel 10g, now give JAX's fields on small clouds: lines
    on a noisy line of points, planes on a noisy slab, one query masked
    (tolerance as in `test_grid_fits_match`)."""
    rng = np.random.default_rng(5)
    line = np.float32([0.1, 0.05, 0.02]) * np.arange(60, dtype=np.float32)[:, None] + np.float32([-2.0, -2.0, 4.0])
    line = (line + rng.normal(0.0, 0.01, line.shape)).astype(np.float32)
    slab = np.zeros((96, 3), np.float32)
    slab[:, :2] = rng.uniform(-2.0, 2.0, (96, 2))
    slab[:, 2] = rng.normal(0.0, 0.005, 96)
    m = np.ones(16, bool)
    m[3] = False
    for kind, pts in (("lines", line), ("planes", slab)):
        y = (pts[10:26] + rng.normal(0.0, 0.01, (16, 3))).astype(np.float32)
        accepted, _, err, spread = _grid_fits(kind, pts, np.ones(len(pts), bool), y, m)
        assert accepted > 5 and err <= max(FIT_ATOL, spread), (kind, accepted, err, spread)


@pytest.mark.parametrize("kind", ["lines", "planes"])
def test_grid_fits_match(pairs, kind):
    """The KnnGrid branch on standalone LFA's scan-to-scan data: the first
    scan's less-sharp / less-flat features as the grid, the second's sharp /
    flat features at the true relative pose as queries, k = 5. Accept
    decisions identical. The fitted floats of accepted queries (but planes
    whose neighbours lie on a line: measured 10 of 519) to the CellTable
    branch's FIT_ATOL or, where it is wider, the reference's own spread
    under one-ulp input noise (`_grid_fits`): XLA sums the 5 slots and the
    3x3 products in its own order, and 5 neighbours can leave the low
    eigenvalue pair a relative gap g of a few 1e-4, which moves the fitted
    frame as 1 / g (measured: planes 2.8e-5 from JAX against the
    reference's own 7.2e-5, lines 7.2e-7 against 3.8e-6)."""
    col = 0 if kind == "lines" else 2
    accepted, left_out, err, spread = 0, 0, 0.0, 0.0
    for p in pairs:
        n, lo, e, s = _grid_fits(kind, p[col], p[col + 1], p[4 + col], p[5 + col])
        accepted, left_out, err, spread = accepted + n, left_out + lo, max(err, e), max(spread, s)
    tol = max(FIT_ATOL, spread)
    print(f"grid {kind}: {accepted} accepted over {len(pairs)} scan pairs, {left_out} planes with neighbours on a "
          f"line; max abs err {err:.3g} (tolerance {tol:.3g}: FIT_ATOL {FIT_ATOL}, the reference's own spread "
          f"{spread:.3g})")
    assert err <= tol
    assert accepted > 10 and left_out <= accepted // 20


@pytest.fixture(scope="module")
def pairs(small_sequence):
    """Per consecutive scan pair: (less-sharp, mask, less-flat, mask of the
    first; sharp queries, mask, flat queries, mask of the second at the true
    relative pose)."""
    scans, gt, _ = small_sequence
    cfg = JLfa(**KW)
    feats = [extract_features(JCloud.from_numpy(s, cap=32768), cfg) for s in scans]
    out = []
    for i in range(len(scans) - 1):
        rel = jnp.asarray((np.linalg.inv(gt[i]) @ gt[i + 1]).astype(np.float32))
        f0, f1 = feats[i], feats[i + 1]
        out.append(tuple(np.array(a) for a in (
            f0.less_sharp, f0.less_sharp_mask, f0.less_flat, f0.less_flat_mask,
            jse3.transform_points(rel, f1.sharp), f1.sharp_mask, jse3.transform_points(rel, f1.flat), f1.flat_mask,
        )))
    return out


@pytest.mark.parametrize("kind", ["lines_from_2nn", "planes_from_3nn"])
def test_scan_to_scan_correspondences_match(pairs, kind):
    col = 0 if kind == "lines_from_2nn" else 2
    accepted = 0
    for p in pairs:
        jgrid = jax.jit(lambda x, m: jk.build_grid(x, m, 2.0))(jnp.asarray(p[col]), jnp.asarray(p[col + 1]))
        grid = build_grid(_t(p[col]), _t(p[col + 1]), 2.0)
        y, m = p[4 + col], p[5 + col]
        want = [np.asarray(a) for a in jax.jit(getattr(jr, kind))(jnp.asarray(y), jnp.asarray(m), jgrid)]
        got = [a.numpy() for a in getattr(tr, kind)(_t(y), _t(m), grid)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert np.isfinite(a).all()  # gn_solve reads rejected lanes' floats at weight 0
        accepted += int(got[2].sum())
    print(f"{kind}: {accepted} accepted over {len(pairs)} scan pairs, every field identical")
    assert accepted > 50 * len(pairs)
