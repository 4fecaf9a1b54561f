"""The kernel wrappers: CPU tensors route to the plain versions and launch
nothing; on a card each hand kernel agrees with its plain version.

This file imports no JAX, so the card tests also run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu_torch.config import LfaConfig  # noqa: E402
from lv_slam_tpu_torch.core import se3  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud  # noqa: E402
from lv_slam_tpu_torch.kernels import KERNELS, reset_launches  # noqa: E402
from lv_slam_tpu_torch.graph import pose_graph  # noqa: E402
from lv_slam_tpu_torch.lfa import features, registration  # noqa: E402
from lv_slam_tpu_torch.ops import knn, ndt, ndt_hash, ndt_soa, nn, orb, prefilter, voxel_map  # noqa: E402
from lv_slam_tpu_torch.pipeline import window  # noqa: E402
from lv_slam_tpu_torch.ops.ndt import make_gauss_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LFA = LfaConfig(scan_line=32, edge_cap=2048, planar_cap=4096, map_edge_cap=8192, map_planar_cap=16384)


@pytest.fixture(scope="module")
def scans():
    s, poses, _ = synthetic.make_sequence(
        2, seed=41, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=450
    )
    return s, np.linalg.inv(poses[0]) @ poses[1]


def _calls(device, scans):
    """Every wrapper once, on `device`, at small shapes: (name, wrapper output,
    plain output) for each kernel."""
    return (_odometry_calls(device, scans) + _lfa_calls(device, scans) + _backend_calls(device, scans)
            + _camera_calls(device) + _standalone_calls(device, scans) + _lut_calls(device, scans))


def _odometry_calls(device, scans):
    """K1, K3, K5, K6 once each."""
    (s0, s1), rel = scans
    cloud = prefilter.distance_filter(PointCloud.from_numpy(s0, cap=16384, device=device), 0.5, 100.0)
    out = [(
        "voxel_downsample",
        prefilter.voxel_downsample(cloud, 0.1, 16384),
        prefilter.voxel_downsample_ref(cloud, 0.1, 16384),
    )]
    kw = dict(leaf_cap=8192, lut_extent=256, weighted=True)
    vm = voxel_map.build_voxel_map(cloud, 1.0, **kw)
    out.append(("build_voxel_map", vm, voxel_map.build_voxel_map_ref(cloud, 1.0, **kw)))
    hm = ndt_hash.to_hash(vm)
    out.append(("to_hash", hm, ndt_hash.to_hash_ref(vm)))
    src = PointCloud.from_numpy(s1, cap=16384, device=device)
    args = (
        hm, src.masked_xyz().T.contiguous(), src.mask,
        torch.from_numpy(rel.astype(np.float32)).to(device), make_gauss_params(1.0),
        voxel_map.neighborhood_offsets("DIRECT7", device), True,
    )
    out.append((
        "ndt_derivatives_hash",
        ndt_hash.ndt_derivatives_hash(*args),
        ndt_hash.ndt_derivatives_hash_ref(*args),
    ))
    return out


def _lfa_calls(device, scans):
    """K8-K11 once each: scan 0's features fill the maps at the identity,
    scan 1's features are the queries at the true relative pose."""
    (s0, s1), rel = scans
    c0, c1 = (PointCloud.from_numpy(s, cap=16384, device=device) for s in (s0, s1))
    f0 = features.extract_features(c0, LFA)
    out = [("extract_features", f0, features.extract_features_ref(c0, LFA))]
    f1 = features.extract_features(c1, LFA)
    edge = knn.empty_cell_table(4096, LFA.knn_slots, 2.0, device)
    surf, surf_plain = (knn.empty_cell_table(8192, LFA.knn_slots, 2.0, device) for _ in range(2))
    batch = (f0.less_flat, f0.less_flat_mask, LFA.mapping_plane_resolution)
    knn.insert_cell_table_(surf, *batch)
    knn.insert_cell_table_ref_(surf_plain, *batch)
    out.append(("insert_cell_table", surf, surf_plain))
    knn.insert_cell_table_(edge, f0.less_sharp, f0.less_sharp_mask, LFA.mapping_line_resolution)
    center = torch.tensor([3.0, -2.0, 0.5], device=device)
    last = torch.tensor([-20.0, 1.0, 0.0], device=device)
    cropped = [knn.CellTable(surf.table.clone(), surf.cell_size) for _ in range(2)]
    out.append((
        "crop_cell_table",
        (knn.crop_cell_table_(cropped[0], center, 20.0, last, 10.0), cropped[0].table),
        (knn.crop_cell_table_ref_(cropped[1], center, 20.0, last, 10.0), cropped[1].table),
    ))
    t = torch.from_numpy(rel.astype(np.float32)).to(device)
    ye = se3.transform_points(t, f1.less_sharp)
    ys = se3.transform_points(t, f1.less_flat)
    lines = registration.lines_from_fit(ye, f1.less_sharp_mask, edge)
    out.append(("lines_from_fit", lines, registration.lines_from_fit_ref(ye, f1.less_sharp_mask, edge)))
    planes = registration.planes_from_fit(ys, f1.less_flat_mask, surf)
    out.append(("planes_from_fit", planes, registration.planes_from_fit_ref(ys, f1.less_flat_mask, surf)))
    gn = (t, f1.less_sharp, lines, f1.less_flat, planes, LFA.mapping_max_iterations)
    out.append(("gn_solve", (registration.gn_solve(*gn),), (registration.gn_solve_ref(*gn),)))
    return out


def _backend_calls(device, scans):
    """K1b, K2, K13's batched pass, K14 (build, query) and K15 once each:
    scans 0 and 1 as a window, two loop candidates against scan 0's map, a
    3-node graph."""
    (s0, s1), rel = scans
    c0, c1 = (PointCloud.from_numpy(s, cap=16384, device=device) for s in (s0, s1))
    out = [(
        "voxel_dedup_first",
        prefilter.voxel_dedup_first(c0, 0.1, 8192),
        prefilter.voxel_dedup_first_ref(c0, 0.1, 8192),
    )]
    t = torch.from_numpy(rel.astype(np.float32)).to(device)
    chunk = (torch.stack([c0.xyz.T, c1.xyz.T]).contiguous(), torch.stack([c0.intensity, c1.intensity]),
             torch.stack([c0.mask, c1.mask]))
    group = (*chunk, 0, torch.stack([torch.eye(4, device=device), t]), torch.ones(2, dtype=torch.bool, device=device),
             0.1, 32768)
    out.append((
        "window_group_filtered_fn", window.window_group_filtered(*group), window.window_group_filtered_ref(*group),
    ))
    hm = ndt_hash.to_hash_ref(voxel_map.build_voxel_map_ref(c0, 1.0, leaf_cap=8192))
    t2 = t.clone()
    t2[0, 3] += 0.3
    args = (
        hm, torch.stack([c1.masked_xyz().T, c1.masked_xyz().T]).contiguous(), torch.stack([c1.mask, c1.mask]),
        torch.stack([t, t2]), make_gauss_params(1.0), voxel_map.neighborhood_offsets("DIRECT7", device), False,
    )
    out.append((
        "_fused_verify_fn",
        ndt_hash.ndt_derivatives_hash_batched(*args),
        ndt_hash.ndt_derivatives_hash_batched_ref(*args),
    ))
    grid = nn.build_centroid_grid(c0, 0.25, leaf_cap=16384)
    out.append(("build_centroid_grid", grid, nn.build_centroid_grid_ref(c0, 0.25, leaf_cap=16384)))
    moved = c1.transformed(t)
    out.append((
        "nn_sq_dists",
        (nn.nn_sq_dists(grid, moved.masked_xyz(), moved.mask),),
        (nn.nn_sq_dists_ref(grid, moved.masked_xyz(), moved.mask),),
    ))
    g = pose_graph.empty_graph(8, 8, 8, 8, 8, 8)
    for i in range(3):
        pose_graph.add_node(g, i, np.linalg.matrix_power(rel, i))
    pose_graph.add_se3_edge(g, 0, 1, 0, np.linalg.inv(rel), np.eye(6), huber=1.0)
    pose_graph.add_se3_edge(g, 1, 2, 1, np.linalg.inv(rel) @ np.diag([1.0, 1.0, 1.0, 1.0]), 2 * np.eye(6))
    pose_graph.add_se3_edge(g, 2, 2, 0, np.linalg.inv(rel @ rel) + 0.01, np.eye(6), huber=0.1)
    dg = pose_graph.to_device(g, device)
    out.append((
        "_chi2_and_normal",
        pose_graph._chi2_and_normal(dg, dg.poses, True),
        pose_graph._chi2_and_normal_ref(dg, dg.poses, True),
    ))
    return out


def _camera_calls(device):
    """K12 on two camera images of a small world (a uint8 stack, the main
    path's 128 x 256 and level budgets) and K12b of the first image's
    descriptors against both, padded to 512."""
    world = synthetic.make_world(seed=13, n_buildings=80, n_poles=100)
    gt = synthetic.circle_trajectory(40, step=1.0)
    images = torch.from_numpy(np.stack([synthetic.render_camera_image(world, gt[i], seed=13) for i in (0, 20)]))
    images = images.to(device)
    k_levels = orb.OrbExtractor(512)._k_levels(128, 256)
    rows = orb.detect_pyramid_batch(images, k_levels)
    out = [("_detect_pyramid_batch", (rows,), (orb.detect_pyramid_batch_ref(images, k_levels),))]
    sets = [orb._padded(d, 512) for d, _ in orb.unpack_rows(rows.cpu().numpy(), 512)]
    a, a_mask = (torch.from_numpy(v).to(device) for v in sets[0])
    bs = torch.from_numpy(np.stack([v for v, _ in sets])).to(device)
    b_masks = torch.from_numpy(np.stack([m for _, m in sets])).to(device)
    out.append((
        "match_scores_batch",
        (orb.match_scores_masked(a, a_mask, bs, b_masks),),
        (orb.match_scores_masked_ref(a, a_mask, bs, b_masks),),
    ))
    return out


def _standalone_calls(device, scans):
    """K9g on scan 0's less-sharp and less-flat features, K9k's three
    entries with scan 1's features at the true relative pose as queries,
    and K9c on scan 0's less-flat features, 1024 buckets (some overflow)."""
    (s0, s1), rel = scans
    c0, c1 = (PointCloud.from_numpy(s, cap=16384, device=device) for s in (s0, s1))
    f0, f1 = features.extract_features_ref(c0, LFA), features.extract_features_ref(c1, LFA)
    edge = knn.build_grid(f0.less_sharp, f0.less_sharp_mask, 2.0)
    out = [("build_grid", edge, knn.build_grid_ref(f0.less_sharp, f0.less_sharp_mask, 2.0))]
    surf = knn.build_grid(f0.less_flat, f0.less_flat_mask, 2.0)
    t = torch.from_numpy(rel.astype(np.float32)).to(device)
    ye, ys = se3.transform_points(t, f1.sharp), se3.transform_points(t, f1.flat)
    out.append(("knn", knn.knn(surf, ys, 5), knn.knn_ref(surf, ys, 5)))
    out.append(("lines_from_2nn", registration.lines_from_2nn(ye, f1.sharp_mask, edge),
                registration.lines_from_2nn_ref(ye, f1.sharp_mask, edge)))
    out.append(("planes_from_3nn", registration.planes_from_3nn(ys, f1.flat_mask, surf),
                registration.planes_from_3nn_ref(ys, f1.flat_mask, surf)))
    args = (f0.less_flat, f0.less_flat_mask, 2.0, 1024, LFA.knn_slots)
    out.append(("build_cell_table", knn.build_cell_table(*args), knn.build_cell_table_ref(*args)))
    return out


def _lut_calls(device, scans):
    """K3L on scan 0's map at 0.7 m (a resolution whose probe must divide),
    then K6L (DIRECT1 weighted, DIRECT7) and K6G (DIRECT1 weighted) of scan
    1's points at the true relative pose."""
    (s0, s1), rel = scans
    c0, c1 = (PointCloud.from_numpy(s, cap=16384, device=device) for s in (s0, s1))
    vm = voxel_map.build_voxel_map_ref(c0, 0.7, leaf_cap=8192, lut_extent=256, weighted=True)
    lut = voxel_map.build_lut(vm)
    out = [("build_lut", (lut,), (voxel_map.build_lut_ref(vm),))]
    soa = ndt_soa.to_soa(vm, lut)
    t = torch.from_numpy(rel.astype(np.float32)).to(device)
    gauss = make_gauss_params(0.7)
    xs = c1.masked_xyz().T.contiguous()
    for hood, weighted in (("DIRECT1", True), ("DIRECT7", False)):
        args = (soa, xs, c1.mask, t, gauss, voxel_map.neighborhood_offsets(hood, device), weighted)
        out.append(("ndt_derivatives_soa", ndt_soa.ndt_derivatives_soa(*args), ndt_soa.ndt_derivatives_soa_ref(*args)))
    args = (vm, lut, c1.masked_xyz().contiguous(), c1.mask, t, gauss, voxel_map.neighborhood_offsets("DIRECT1", device),
            True)
    out.append(("ndt_derivatives", ndt.ndt_derivatives(*args), ndt.ndt_derivatives_ref(*args)))
    return out


# kernels that replace a block inside a reference function: the text their
# replaced line must hold
INLINE_BLOCKS = {"build_lut": "# Dense LUT scatter"}


def test_registry_names_sources_and_replaced_functions():
    assert set(KERNELS) == {
        "voxel_downsample", "build_voxel_map", "to_hash", "ndt_derivatives_hash", "extract_features",
        "insert_cell_table", "crop_cell_table", "lines_from_fit", "planes_from_fit", "gn_solve",
        "voxel_dedup_first", "window_group_filtered_fn", "_fused_verify_fn", "build_centroid_grid",
        "nn_sq_dists", "_chi2_and_normal", "_detect_pyramid_batch", "match_scores_batch",
        "build_grid", "knn", "build_cell_table", "build_lut", "ndt_derivatives_soa", "ndt_derivatives",
    }
    for name, k in KERNELS.items():
        assert (REPO / k.source).is_file(), k.source
        path, line = k.replaces.split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        if name in INLINE_BLOCKS:
            assert INLINE_BLOCKS[name] in text, (k.replaces, text)
        else:
            assert re.match(rf"def {name}\(", text), (k.replaces, text)


def test_cpu_tensors_use_the_plain_versions(scans):
    reset_launches()
    for name, got, want in _calls("cpu", scans):
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
            else:
                assert a == b, name
    assert {k: v.launches for k, v in KERNELS.items()} == dict.fromkeys(KERNELS, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the hand kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card(cuda, scans):
    reset_launches()
    results = {name: (got, want) for name, got, want in _odometry_calls(cuda, scans)}
    torch.cuda.synchronize()
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == dict.fromkeys(results, 1)

    got, want = results["voxel_downsample"]
    assert torch.equal(got.mask, want.mask)  # lane order and mask identical
    torch.testing.assert_close(got.xyz, want.xyz, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.intensity, want.intensity, rtol=0, atol=1e-5)

    got, want = results["build_voxel_map"]
    assert torch.equal(got.valid, want.valid)  # both round alike on the card
    v = want.valid
    torch.testing.assert_close(got.means[v], want.means[v], rtol=0, atol=1e-5)
    scale = float(want.icovs[v].abs().max())
    torch.testing.assert_close(got.icovs[v], want.icovs[v], rtol=0, atol=1e-4 * scale)

    got, want = results["to_hash"]
    assert torch.equal(got.table.view(torch.int32), want.table.view(torch.int32))
    assert int(got.n_dropped) == int(want.n_dropped)

    (s1, g1, h1), (s2, g2, h2) = results["ndt_derivatives_hash"]
    torch.testing.assert_close(s1, s2, rtol=1e-4, atol=0)
    torch.testing.assert_close(g1, g2, rtol=0, atol=2e-5 * float(g2.abs().max()))
    torch.testing.assert_close(h1, h2, rtol=0, atol=2e-5 * float(h2.abs().max()))


@pytest.mark.gpu
def test_lfa_kernels_match_plain_versions_on_the_card(cuda, scans):
    reset_launches()
    results = {name: (got, want) for name, got, want in _lfa_calls(cuda, scans)}
    torch.cuda.synchronize()
    want = dict(dict.fromkeys(results, 1), extract_features=2, insert_cell_table=2)
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == want

    # K8, K9: masks, picks and tables identical (both round alike on the card)
    for name in ("extract_features", "insert_cell_table", "crop_cell_table"):
        got, want = results[name]
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), name
    # K10: identical accept decisions; fitted floats finite on every lane
    # (gn_solve reads a rejected lane with weight 0, and 0 * NaN is NaN) and
    # within 1e-5 on accepted lanes (a rejected fit may be a degenerate
    # eigenvector, which the two routes may pick differently)
    for name in ("lines_from_fit", "planes_from_fit"):
        got, want = results[name]
        assert torch.equal(got.valid, want.valid), name
        v = want.valid
        assert int(v.sum()) > 0, name
        for a, b in zip(got[:2], want[:2]):
            assert bool(torch.isfinite(a).all()), name
            torch.testing.assert_close(a[v], b[v], rtol=0, atol=1e-5)
    # K11: the solved pose to 1e-4 (the 6x6 sums run in another order)
    (got,), (want,) = results["gn_solve"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_backend_kernels_match_plain_versions_on_the_card(cuda, scans):
    reset_launches()
    results = {name: (got, want) for name, got, want in _backend_calls(cuda, scans)}
    torch.cuda.synchronize()
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == dict.fromkeys(results, 1)

    # K1b, K2: the kept lanes, their order and their points identical (the
    # window's fma chain rounds as the plain twin's float64 emulation)
    for name in ("voxel_dedup_first", "window_group_filtered_fn"):
        got, want = results[name]
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    # K13: per candidate as K6 (partial sums in another order)
    (s1, g1, h1), (s2, g2, h2) = results["_fused_verify_fn"]
    torch.testing.assert_close(s1, s2, rtol=1e-4, atol=0)
    torch.testing.assert_close(g1, g2, rtol=0, atol=2e-5 * float(g2.abs().max()))
    torch.testing.assert_close(h1, h2, rtol=0, atol=2e-5 * float(h2.abs().max()))
    # K14: keys, counts and hits identical; centroids and distances to 1e-6
    got, want = results["build_centroid_grid"]
    assert torch.equal(got.keys, want.keys) and torch.equal(got.counts, want.counts)
    v = want.counts > 0
    torch.testing.assert_close(got.centroids[v], want.centroids[v], rtol=1e-6, atol=0)
    (got,), (want,) = results["nn_sq_dists"]
    hit = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), hit) and int(hit.sum()) > 0
    torch.testing.assert_close(got[hit], want[hit], rtol=1e-6, atol=1e-12)
    # K15: chi2 to 1e-6, H and b to 1e-5 of their scale (atomicAdd order)
    (c1, hh1, b1), (c2, hh2, b2) = results["_chi2_and_normal"]
    torch.testing.assert_close(c1, c2, rtol=1e-6, atol=0)
    torch.testing.assert_close(hh1, hh2, rtol=0, atol=1e-5 * float(hh2.abs().max()))
    torch.testing.assert_close(b1, b2, rtol=0, atol=1e-5 * float(b2.abs().max()))


@pytest.mark.gpu
def test_camera_kernels_match_plain_versions_on_the_card(cuda):
    reset_launches()
    results = {name: (got, want) for name, got, want in _camera_calls(cuda)}
    torch.cuda.synchronize()
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == dict.fromkeys(results, 1)
    # K12: every row byte (keypoints, flags, descriptor bits) and K12b's
    # scores identical: both round alike (exact sums, float64 sample
    # positions, the same float32 division)
    (got,), (want,) = results["_detect_pyramid_batch"]
    assert torch.equal(got, want) and int(got[:, :, 36].sum()) > 100
    (got,), (want,) = results["match_scores_batch"]
    assert torch.equal(got, want) and float(got[0]) == 1.0


@pytest.mark.gpu
def test_standalone_lfa_kernels_match_plain_versions_on_the_card(cuda, scans):
    reset_launches()
    results = {name: (got, want) for name, got, want in _standalone_calls(cuda, scans)}
    torch.cuda.synchronize()
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == {
        "build_grid": 2, "knn": 3, "build_cell_table": 1,
    }
    # K9g, K9k, K9c: grids, neighbours, lines, planes and tables identical
    # (both round the distances as the same float64 fma chain)
    for name, (got, want) in results.items():
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), name
            else:
                assert a == b, name
    assert int(results["lines_from_2nn"][0].valid.sum()) > 0 and int(results["planes_from_3nn"][0].valid.sum()) > 0


@pytest.mark.gpu
def test_lut_kernels_match_plain_versions_on_the_card(cuda, scans):
    reset_launches()
    results = _lut_calls(cuda, scans)
    torch.cuda.synchronize()
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == {
        "build_lut": 1, "ndt_derivatives_soa": 2, "ndt_derivatives": 1,
    }
    # K3L: identical table (one writer per entry)
    (got,), (want,) = results[0][1:]
    assert torch.equal(got, want) and int((want >= 0).sum()) > 100
    # K6L, K6G: as K6 (partial sums in another order)
    for name, (s1, g1, h1), (s2, g2, h2) in results[1:]:
        assert float(s2) > 0.0, name
        torch.testing.assert_close(s1, s2, rtol=1e-4, atol=0)
        torch.testing.assert_close(g1, g2, rtol=0, atol=2e-5 * float(g2.abs().max()))
        torch.testing.assert_close(h1, h2, rtol=0, atol=2e-5 * float(h2.abs().max()))
