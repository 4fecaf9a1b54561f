"""The kernel wrappers: CPU tensors route to the plain versions and launch
nothing; on a card each hand kernel agrees with its plain version.

This file imports no JAX, so the card tests also run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu
"""

import math
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu_torch.config import LfaConfig  # noqa: E402
from lv_slam_tpu_torch.core import se3  # noqa: E402
from lv_slam_tpu_torch.core.cloud import SENTINEL, PointCloud  # noqa: E402
from lv_slam_tpu_torch.kernels import KERNELS, reset_launches  # noqa: E402
from lv_slam_tpu_torch.graph import pose_graph  # noqa: E402
from lv_slam_tpu_torch.lfa import features, registration  # noqa: E402
from lv_slam_tpu_torch.ops import (  # noqa: E402
    floor, gicp, icp, knn, ndt, ndt_ground, ndt_hash, ndt_soa, nn, orb, prefilter, voxel_map,
)
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
            + _camera_calls(device) + _standalone_calls(device, scans) + _lut_calls(device, scans)
            + _registration_calls(device, scans) + _cell_knn_calls(device, scans)[0] + _loop_calls(device))


def _loop_calls(device):
    """The sharded align's per-lane sums (`newton_sums`): three lanes of 5
    blocks of seeded partial rows, lane 1 finished."""
    rng = np.random.default_rng(5)
    state = ndt.NewtonState(torch.eye(4, device=device).expand(3, 4, 4).contiguous(), batched=True)
    state.partials = torch.from_numpy((rng.standard_normal(3 * 5 * ndt.N_TERMS) * 1e3).astype(np.float32)).to(device)
    state.s[1, ndt.S_DONE] = 1
    return [("newton_sums", (ndt.newton_sums(state, 5).clone(),), (ndt.newton_sums_ref(state, 5),))]


def _odometry_calls(device, scans):
    """K0a's band, K1, K3, K5, K6 once each."""
    (s0, s1), rel = scans
    raw = PointCloud.from_numpy(s0, cap=16384, device=device)
    cloud = prefilter.distance_filter(raw, 0.5, 100.0)
    out = [("distance_filter", cloud, prefilter.distance_filter_ref(raw, 0.5, 100.0)), (
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
    """K1b, K2, K2r, K21 (the subsample), K13's batched pass, K14 (build, query), K15 and K16
    once each: scans 0 and 1 as a window (filtered, and raw with the
    distance band), two loop candidates against scan 0's map, a 3-node graph
    with priors of every type, a floor plane, SE3-plane and plane-plane
    edges, and the floor of scan 0."""
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
    raw = (torch.stack([c0.xyz, c1.xyz]), *chunk[1:], 0, *group[4:6], 0.5, 100.0, 0.1, 32768)
    out.append(("window_group_fn", window.window_group(*raw), window.window_group_ref(*raw)))
    out.append(("uniform_subsample", prefilter.uniform_subsample(c0, 4096), prefilter.uniform_subsample_ref(c0, 4096)))
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
    priors = ((pose_graph.PRIOR_XYZ, [0.1, -0.2, 1.8]), (pose_graph.PRIOR_XY, [0.3, 0.1]),
              (pose_graph.PRIOR_QUAT, [0.999, 0.01, -0.02, 0.03]), (pose_graph.PRIOR_VEC, [0, 0, 1, 0.01, 0.02, 1.0]),
              (pose_graph.PRIOR_PLANE, [0.01, 0.02, 1.0, 1.7]))
    for slot, (kind, meas) in enumerate(priors):
        pose_graph.add_prior(g, slot, slot % 3, kind, meas, np.eye(4)[:len(meas), :len(meas)] * 2, huber=1.0)
    pose_graph.add_plane_node(g, 0, [0.0, 0.0, 1.0, 0.0], fixed=True)
    pose_graph.add_plane_node(g, 1, [0.05, 0.02, 1.0, -2.0])
    for slot in range(3):
        pose_graph.add_se3_plane_edge(g, slot, slot, slot % 2, [0.01, -0.02, 1.0, 1.73 + 0.1 * slot], 10 * np.eye(3),
                                      huber=1.0)
    for kind in range(5):
        pose_graph.add_plane_edge(g, kind, 1, 0 if kind < 3 else 1, kind, [0.05, 0.02, -0.01, 0.1], 2 * np.eye(4),
                                  huber=1.0)
    dg = pose_graph.to_device(g, device)
    out.append((
        "_chi2_and_normal",
        pose_graph._chi2_and_normal(dg, dg.poses, True),
        pose_graph._chi2_and_normal_ref(dg, dg.poses, True),
    ))
    band = prefilter.distance_filter_ref(c0, 0.5, 100.0)
    out.append(("detect_floor", floor.detect_floor(band), floor.detect_floor_ref(band)))
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


def _cell_knn_calls(device, scans):
    """K9n on scan 0's less-flat features in a crowded 1024 x 6 table
    (probes share buckets) with scan 1's flat features at the true pose as
    queries, k = 5 and 48; K10g's lines and planes of scan 1's sharp / flat
    features on scan 0's grids. The tables and grids are the twins'."""
    (s0, s1), rel = scans
    c0, c1 = (PointCloud.from_numpy(s, cap=16384, device=device) for s in (s0, s1))
    f0, f1 = features.extract_features_ref(c0, LFA), features.extract_features_ref(c1, LFA)
    table = knn.build_cell_table_ref(f0.less_flat, f0.less_flat_mask, 2.0, 1024, LFA.knn_slots)
    t = torch.from_numpy(rel.astype(np.float32)).to(device)
    ye, ys = se3.transform_points(t, f1.sharp), se3.transform_points(t, f1.flat)
    out = [("knn_cell", knn.knn_cell(table, ys, k), knn.knn_cell_ref(table, ys, k)) for k in (5, 48)]
    edge = knn.build_grid_ref(f0.less_sharp, f0.less_sharp_mask, 2.0)
    surf = knn.build_grid_ref(f0.less_flat, f0.less_flat_mask, 2.0)
    out.append(("grid_fits", registration.lines_from_fit(ye, f1.sharp_mask, edge),
                registration.lines_from_fit_ref(ye, f1.sharp_mask, edge)))
    out.append(("grid_fits", registration.planes_from_fit(ys, f1.flat_mask, surf),
                registration.planes_from_fit_ref(ys, f1.flat_mask, surf)))
    return out, (ye, edge), (ys, surf)


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


def _registration_calls(device, scans):
    """K17 (a nearest-centroid query and one ICP iteration, scan 1 0.1 m off
    the true relative pose against scan 0's 0.25 m grid), K18 (both removals
    on scan 0's band), K0a (0.11 degrees), K19a (scan 1's 8 grid neighbours,
    with and without the mask), K19b (the normal equations at that pose)
    and K20 (scan 0's map at 10 m, 64^3 LUT)."""
    (s0, s1), rel = scans
    c0, c1 = (PointCloud.from_numpy(s, cap=16384, device=device) for s in (s0, s1))
    t = torch.from_numpy(rel.astype(np.float32)).to(device)
    t[0, 3] += 0.1
    grid = nn.build_centroid_grid_ref(c0, 0.25)
    y = c1.transformed(t).masked_xyz()
    out = [("nn_points", nn.nn_points(grid, y, c1.mask), nn.nn_points_ref(grid, y, c1.mask))]
    args = (grid, c1.masked_xyz(), c1.mask, t, 4.0)
    out.append(("nn_points", (icp.icp_step(*args), *icp.icp_fitness(*args)),
                (icp.icp_step_ref(*args), *icp.icp_fitness_ref(*args))))
    band = prefilter.distance_filter_ref(c0, 0.5, 100.0)
    out.append(("radius_outlier_removal", nn.radius_outlier_removal(band, 0.5, 5),
                nn.radius_outlier_removal_ref(band, 0.5, 5)))
    for mean_k in (30, 300):  # the threshold's variance far from 1 in one of them: std and variance differ
        out.append(("statistical_outlier_removal", nn.statistical_outlier_removal(band, mean_k, 1.2),
                    nn.statistical_outlier_removal_ref(band, mean_k, 1.2)))
    out.append(("vertical_angle_calibration", prefilter.vertical_angle_calibration(c0, 0.11),
                prefilter.vertical_angle_calibration_ref(c0, 0.11)))
    kgrid = knn.build_grid_ref(c1.masked_xyz(), c1.mask, 1.0)
    _, pts, valid = knn.knn_ref(kgrid, c1.masked_xyz(), 8)
    for mask in (c1.mask, None):
        out.append(("_plane_covariances", gicp.regularized_covariances(pts, valid, mask),
                    gicp.regularized_covariances_ref(pts, valid, mask)))
    cov_a, ok = gicp.regularized_covariances_ref(pts, valid, c1.mask)
    tgrid = knn.build_grid_ref(c0.masked_xyz(), c0.mask, 1.0)
    dists, nn_pts, nn_valid = knn.knn_ref(tgrid, c1.transformed(t).masked_xyz(), 1)
    _, nbrs, nbr_valid = knn.knn_ref(tgrid, nn_pts[:, 0], 8)
    cov_b, _ = gicp.regularized_covariances_ref(nbrs, nbr_valid)
    args = (c1.masked_xyz(), c1.mask & ok, cov_a, t, nn_pts[:, 0].contiguous(), dists[:, 0].contiguous(),
            nn_valid[:, 0].contiguous(), cov_b, 2.0)
    out.append(("gicp_align", gicp.gicp_normal_equations(*args), gicp.gicp_normal_equations_ref(*args)))
    vm = voxel_map.build_voxel_map_ref(c0, 10.0, leaf_cap=4096, lut_extent=64)
    lut = voxel_map.build_lut_ref(vm)
    # and with every other leaf's normal flipped (a normal's sign is arbitrary)
    sign = 1.0 - 2.0 * (torch.arange(vm.leaf_cap, device=device) % 2)[:, None].to(torch.float32)
    for m in (vm, vm._replace(normals=vm.normals * sign)):
        got, want = ndt_ground.filter_ground_leaves(m, lut), ndt_ground.filter_ground_leaves_ref(m, lut)
        out.append(("filter_ground_leaves", (got[0].valid, got[1]), (want[0].valid, want[1])))
    return out


# kernels that replace a block inside a reference function: the text their
# replaced line must hold
INLINE_BLOCKS = {"build_lut": "# Dense LUT scatter", "newton_step": "def _newton_loop(",
                 "grid_fits": "knn(grid, y, k=k)", "newton_sums": "def derivs(T):"}


def load_chip_smoke():
    """chip_smoke.py as a module (it imports numpy only at the top); the
    other test modules that run its case lists load it through this too."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_registry_names_sources_and_replaced_functions():
    assert set(KERNELS) == {
        "voxel_downsample", "build_voxel_map", "to_hash", "ndt_derivatives_hash", "extract_features",
        "insert_cell_table", "crop_cell_table", "lines_from_fit", "planes_from_fit", "gn_solve",
        "voxel_dedup_first", "window_group_filtered_fn", "_fused_verify_fn", "build_centroid_grid",
        "nn_sq_dists", "_chi2_and_normal", "_detect_pyramid_batch", "match_scores_batch",
        "build_grid", "knn", "build_cell_table", "build_lut", "ndt_derivatives_soa", "ndt_derivatives",
        "window_group_fn", "detect_floor", "nn_points", "radius_outlier_removal", "statistical_outlier_removal",
        "vertical_angle_calibration", "_plane_covariances", "gicp_align", "filter_ground_leaves",
        "newton_step", "optimize_pose_graph", "knn_cell", "grid_fits", "newton_sums", "uniform_subsample",
        "distance_filter",
    }
    for name, k in KERNELS.items():
        assert (REPO / k.source).is_file(), k.source
        path, line = k.replaces.split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        if name in INLINE_BLOCKS:
            assert INLINE_BLOCKS[name] in text, (k.replaces, text)
        else:
            assert re.match(rf"def {name}\(", text), (k.replaces, text)
    # the device functions chip_smoke.py times for each kernel are kernels of
    # its source (K9a's one-block insert and its over-cap route, K11's cluster)
    functions = load_chip_smoke().DEVICE_FUNCTIONS
    assert set(functions) == set(KERNELS)
    assert functions["insert_cell_table"] == ("insert_cluster", "insert_keys", "insert_keep", "insert_place")
    assert functions["gn_solve"] == ("gn_cluster",)
    assert functions["match_scores_batch"] == ("match_cluster",)
    for name, k in KERNELS.items():
        source = "".join(p.read_text() for p in (REPO / k.source).parent.glob("*.cu*"))
        for fn in functions[name]:
            assert re.search(rf"__global__[^;{{]*\b{fn}\(", source), (name, fn)


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

    got, want = results["distance_filter"]  # the same fma chain and root: every bit
    assert torch.equal(got.mask, want.mask) and torch.equal(got.xyz.view(torch.int32), want.xyz.view(torch.int32))
    assert 0 < int(got.mask.sum()) < int(PointCloud.from_numpy(scans[0][0], cap=16384).mask.sum())

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

    # K9a on both routes (one block up to INSERT_BLOCK_ROWS, the sort glue
    # above), each case's table bit-identical to the twin's after each insert
    for case, n_launches in _check_insert_cases(cuda):
        assert KERNELS["insert_cell_table"].launches == n_launches, case
    # K11 at the main path's and standalone LFA's shapes and the edge cases
    _check_gn_cases(cuda)


def _feature_batch(rng, n, spread=60.0, n_centers=400, masked=0.1, device="cpu"):
    """A seeded batch of n world-frame feature points: clusters of 0.5 m
    around `n_centers` centres within +-`spread` m (so voxels repeat), a
    fraction `masked` masked out at the sentinel."""
    centers = rng.uniform(-spread, spread, (n_centers, 3)) * np.array([1.0, 1.0, 0.05])
    xyz = centers[rng.integers(0, n_centers, n)] + rng.normal(0.0, 0.5, (n, 3))
    mask = rng.random(n) >= masked
    xyz[~mask] = SENTINEL
    return (torch.from_numpy(xyz.astype(np.float32)).to(device), torch.from_numpy(mask).to(device))


def _check_insert_cases(device):
    """Inserts each case's batches into a card table and a plain one; yields
    (case, the launches it made) after checking the tables bit for bit."""
    rng = np.random.default_rng(11)
    flagship = LfaConfig()
    tables = {"edge": (1 << 14, flagship.mapping_line_resolution, 4096),
              "surf": (1 << 15, flagship.mapping_plane_resolution, 8064)}

    def run(case, n_buckets, res, batches, crop=None):
        reset_launches()
        got, want = (knn.empty_cell_table(n_buckets, flagship.knn_slots, 2.0, device) for _ in range(2))
        for i, (xyz, mask) in enumerate(batches):
            if crop is not None and i == len(batches) - 1:  # holes in the bucket rows before the last insert
                center = torch.tensor(crop, device=device)
                knn.crop_cell_table_ref_(got, center, 25.0)
                knn.crop_cell_table_ref_(want, center, 25.0)
            knn.insert_cell_table_(got, xyz, mask, res)
            knn.insert_cell_table_ref_(want, xyz, mask, res)
            torch.cuda.synchronize()
            assert torch.equal(got.table.view(torch.int32), want.table.view(torch.int32)), (case, i)
        return case, len(batches)

    for name, (n_buckets, res, n) in tables.items():  # the flagship's batches into the flagship's maps
        batches = [_feature_batch(rng, n, device=device) for _ in range(4)]
        assert knn.insert_sort_keys(*batches[0], n_buckets, res, 2.0)[2]  # one-word keys
        yield run(f"flagship {name}", n_buckets, res, batches)
    n_buckets, res, n = tables["surf"]
    over = [_feature_batch(rng, 2 * n, device=device) for _ in range(2)]  # 16128 rows: the glue route
    assert over[0][0].shape[0] > knn.INSERT_BLOCK_ROWS
    yield run("over the cap", n_buckets, res, over)
    yield run("all masked", n_buckets, res, [_feature_batch(rng, n, masked=1.0, device=device)])
    again = _feature_batch(rng, n, device=device)
    yield run("every voxel in the map", n_buckets, res, [again, again])
    # S + 3 points in distinct voxels of one 2 m cell: S slots, the rest dropped
    s = flagship.knn_slots
    one_cell = torch.tensor([[0.2 + 0.4 * (i % 5), 0.2 + 0.4 * (i // 5), 1.1] for i in range(s + 3)],
                            dtype=torch.float32, device=device)
    yield run("one bucket overfull", n_buckets, 0.4, [(one_cell, torch.ones(s + 3, dtype=torch.bool, device=device))])
    yield run("crop holes", n_buckets, res, [_feature_batch(rng, n, device=device) for _ in range(3)], crop=(20.0, 0.0, 0.0))
    # far coordinates: the fields' ranges pass 63 bits, the kernel's two-word keys
    far = _feature_batch(rng, 3000, spread=9000.0, device=device)
    assert not knn.insert_sort_keys(*far, n_buckets, 0.4, 2.0)[2]
    yield run("wide keys", n_buckets, 0.4, [far, _feature_batch(rng, 3000, spread=9000.0, device=device)])
    for m in (1, 1023, 1025, 4097, knn.INSERT_BLOCK_ROWS):  # across the blocks' 1024-row slices, and the cap
        yield run(f"{m} rows", n_buckets, res, [_feature_batch(rng, m, device=device) for _ in range(2)])


def _gn_field(rng, ne, ns, true_t, valid=0.9, device="cpu"):
    """Seeded lines and planes that hold at `true_t` (numpy 4x4): edge
    points on their lines, surf points on their planes, a fraction `valid`
    accepted (the rest at the sentinel)."""
    def unit(m):
        v = rng.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    edges = rng.uniform(-30.0, 30.0, (ne, 3))
    ye = edges @ true_t[:3, :3].T + true_t[:3, 3]
    v = unit(ne)
    mu = ye + v * rng.uniform(-1.0, 1.0, (ne, 1))
    surfs = rng.uniform(-30.0, 30.0, (ns, 3))
    ys = surfs @ true_t[:3, :3].T + true_t[:3, 3]
    n = unit(ns)
    d = -np.sum(n * ys, axis=1)
    lval, pval = rng.random(ne) < valid, rng.random(ns) < valid
    edges[~lval], surfs[~pval] = SENTINEL, SENTINEL

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    lines = registration.LineField(mu=t(mu), v=t(v), valid=t(lval, torch.bool))
    planes = registration.PlaneField(n=t(n), d=t(d), valid=t(pval, torch.bool))
    return t(edges), lines, t(surfs), planes


def _check_gn_cases(device):
    """K11 within 1e-4 of its twin on the card at the main path's and
    standalone LFA's shapes, with no edge lane, no valid lane, 1 and 8
    iterations, and a field whose step is not finite."""
    rng = np.random.default_rng(12)
    true_t = se3.exp_se3(torch.tensor([0.5, -0.3, 0.1, 0.02, -0.01, 0.3])).double().numpy()
    seed = true_t.copy()
    seed[:3, 3] += [0.3, -0.2, 0.1]
    t0 = torch.from_numpy(seed.astype(np.float32)).to(device)
    cases = {
        "flagship 4096 + 8064": (4096, 8064, 0.9, 8),
        "standalone 768 + 1536": (768, 1536, 0.9, 8),
        "no edge lane": (0, 1536, 0.9, 8),
        "no valid lane": (768, 1536, 0.0, 8),
        "one iteration": (4096, 8064, 0.9, 1),
        "past the register-held lanes": (8192, 16384, 0.9, 2),
    }
    for case, (ne, ns, valid, iters) in cases.items():
        e, lines, s, planes = _gn_field(rng, ne, ns, true_t, valid, device)
        reset_launches()
        got = registration.gn_solve(t0, e, lines, s, planes, iters)
        want = registration.gn_solve_ref(t0, e, lines, s, planes, iters)
        torch.cuda.synchronize()
        assert KERNELS["gn_solve"].launches == 1, case
        assert bool(torch.isfinite(got).all()), case
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4, msg=case)
        if valid > 0.0 and iters == 8:  # it converges to the field's transform
            assert float((got[:3, 3] - torch.from_numpy(true_t[:3, 3]).float().to(device)).abs().max()) < 1e-3, case
    # a valid plane lane at 3e38 m overflows its residual: J^T W J is not
    # finite, nor is the step, so both keep the seed
    e, lines, s, planes = _gn_field(rng, 768, 1536, true_t, 0.9, device)
    s[0] = 3e38
    planes.valid[0] = True
    got = registration.gn_solve(t0, e, lines, s, planes, 8)
    want = registration.gn_solve_ref(t0, e, lines, s, planes, 8)
    assert torch.equal(want, t0) and torch.equal(got, t0)


@pytest.mark.gpu
def test_backend_kernels_match_plain_versions_on_the_card(cuda, scans):
    reset_launches()
    results = {name: (got, want) for name, got, want in _backend_calls(cuda, scans)}
    torch.cuda.synchronize()
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == dict.fromkeys(results, 1)

    # K1b, K2, K21: the kept lanes, their order and their points identical
    # (the window's fma chain rounds as the plain twin's float64 emulation;
    # K21 rounds its one division and product as the twin)
    for name in ("voxel_dedup_first", "window_group_filtered_fn", "uniform_subsample"):
        got, want = results[name]
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    # K2r: the kept voxels and their order identical (the band's norm and the
    # fma chain round as the twin's emulation); the centroids as K1's, since
    # the plain twin's `index_add_` sums with atomics on the card
    got, want = results["window_group_fn"]
    assert torch.equal(got.mask, want.mask) and int(want.mask.sum()) > 0
    torch.testing.assert_close(got.xyz, want.xyz, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got.intensity, want.intensity, rtol=1e-6, atol=1e-5)
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
    # K15: chi2 to 1e-6, H and b to 1e-5 of their scale (another order of
    # the sums)
    (c1, hh1, b1), (c2, hh2, b2) = results["_chi2_and_normal"]
    torch.testing.assert_close(c1, c2, rtol=1e-6, atol=0)
    torch.testing.assert_close(hh1, hh2, rtol=0, atol=1e-5 * float(hh2.abs().max()))
    torch.testing.assert_close(b1, b2, rtol=0, atol=1e-5 * float(b2.abs().max()))
    # K16: counts are integers, so the best hypothesis, its count and the
    # verdict are identical; the refit's sums run in another order
    got, want = results["detect_floor"]
    assert bool(want.found) and bool(got.found)
    assert int(got.best) == int(want.best) and int(got.n_inliers) == int(want.n_inliers)
    torch.testing.assert_close(got.coeffs, want.coeffs, rtol=0, atol=1e-5)


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
def test_match_scores_edge_cases_on_the_card(cuda):
    """K12b bit for bit against its twin, one launch a call, on chip_smoke's
    edge cases: caps 1, 7, 300, 512 and 1000 by k = 1, 8 and 32 with holes
    in both masks, copied rows (both argmins tie), pairs at exactly
    max_dist and one bit past it, all-masked candidates; an all-masked
    query, prefix masks, four distinct descriptors, max_dist 1e9, cap 4096."""
    cs = load_chip_smoke()
    assert cs.check_match_cases(torch, cuda) == len(cs.MATCH_CAPS) * len(cs.MATCH_KS) + 5


@pytest.mark.gpu
def test_voxel_downsample_edge_cases_on_the_card(cuda):
    """K1 bit for bit against its twin run on a CPU copy (the card's twin
    sums with atomics), one launch a call, on chip_smoke's sort_cases:
    every lane masked, one voxel holding 131072 points, the whole clip range
    with both signs of kx (8 digit passes) and NaN in masked lanes, out_cap
    below the runs and above the lanes, APPROX_VOXELGRID, 1025 lanes."""
    cs = load_chip_smoke()
    assert cs.check_sort_cases(torch, cuda) == len(cs.SORT_CASE_NAMES)


@pytest.mark.gpu
def test_extract_features_edge_cases_on_the_card(cuda):
    """K8 bit for bit against its twin run on a CPU copy, one launch a call,
    on chip_smoke's feature_cases: every cell valid, tied scores, fewer than
    k good picks, an empty scan, VLP-16's less-flat k of 85."""
    cs = load_chip_smoke()
    assert cs.check_feature_cases(torch, cuda) == len(cs.FEATURE_CASE_NAMES)


@pytest.mark.gpu
def test_lfa_fits_edge_cases_on_the_card(cuda):
    """K10 (`lines_from_fit` / `planes_from_fit` on a cell table) against
    its twin run on a CPU copy, one launch a call and no synchronizing call,
    on chip_smoke's fit_cases: every query masked (sentinel and NaN
    queries), one bucket, 48 participants, a candidate at d^2 exactly 1,
    k - 1 and k participants, 1, 1025 and 0 queries, 1 and 32 slots.
    Decisions identical, the lines' means bit-identical, the other floats
    finite and within 1e-5 on accepted queries."""
    cs = load_chip_smoke()
    assert cs.check_fit_cases(torch, cuda) == len(cs.FIT_CASE_NAMES)


@pytest.mark.gpu
def test_voxel_downsample_at_the_map_shape_on_the_card(cuda):
    """K1 at generate_map_cloud's shape (2.49 M points in 2^22 lanes at
    0.05 m into 2^20 rows: 4096 tiles a pass), bit for bit against its twin
    on a CPU copy; the voxels fill part of the rows, the rest is padding."""
    rng = np.random.default_rng(3)
    centers = np.repeat(rng.uniform(-80.0, 80.0, (311250, 3)) * np.array([1.0, 1.0, 0.05]), 8, axis=0)
    pts = np.concatenate([centers + rng.normal(0.0, 0.01, centers.shape), rng.uniform(0.0, 1.0, (len(centers), 1))],
                         axis=1)
    union = PointCloud.from_numpy(pts, cap=1 << 22, device=cuda)
    got = prefilter.voxel_downsample(union, 0.05, 1 << 20)
    want = prefilter.voxel_downsample_ref(PointCloud(union.xyz.cpu(), union.intensity.cpu(), union.mask.cpu()),
                                          0.05, 1 << 20)
    n_voxels = int(want.mask.sum())
    assert 311250 < n_voxels < 1 << 20
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(got.xyz.cpu().view(torch.int32), want.xyz.view(torch.int32))
    assert torch.equal(got.intensity.cpu().view(torch.int32), want.intensity.view(torch.int32))


@pytest.mark.gpu
def test_voxel_downsample_and_features_read_nothing_on_the_card(cuda, scans):
    """K1 and K8 make no synchronizing call: the pass count, the valid
    count and the picks' offsets stay on the card."""
    (s0, _), _ = scans
    raw = PointCloud.from_numpy(s0, cap=16384, device=cuda)
    cloud = prefilter.distance_filter(raw, 0.5, 100.0)
    for fn in (lambda: prefilter.voxel_downsample(cloud, 0.1, 16384), lambda: features.extract_features(raw, LFA)):
        fn()
        torch.cuda.synchronize()
        _, syncs = _count_syncs(fn)
        assert syncs == 0


@pytest.mark.gpu
def test_voxel_map_edge_cases_on_the_card(cuda):
    """K3 on chip_smoke's map_cases, one launch and no synchronizing call a
    call: validity, keys, n_leaves and origin_cell identical to its twin on
    the card (both round alike) and the floats within 1e-5 (means) and 1e-4
    of the largest entry (icovs, weights); against its twin run on a CPU
    copy, keys and origin identical and validity but for leaves flat to
    rounding (every lane masked, one voxel holding every lane, lanes out of
    extent, more runs than leaf_cap, voxels of min_points and one fewer,
    collinear and coplanar voxels, NaN on masked lanes, weighted and
    unweighted, 1025 lanes, e = 64)."""
    cs = load_chip_smoke()
    assert cs.check_map_cases(torch, cuda) == len(cs.MAP_CASE_NAMES)


@pytest.mark.gpu
def test_window_and_dedup_edge_cases_on_the_card(cuda):
    """K2 on chip_smoke's window_cases, K1b on its sort_cases, K2r on its
    raw_window_cases and K21 on its subsample_cases, bit for bit against
    their twins run on a CPU copy (masks, lane order, float bits), one
    launch and no synchronizing call a call."""
    cs = load_chip_smoke()
    assert cs.check_window_cases(torch, cuda) == len(cs.WINDOW_CASE_NAMES)
    assert cs.check_dedup_cases(torch, cuda) == len(cs.SORT_CASE_NAMES)
    assert cs.check_raw_window_cases(torch, cuda) == len(cs.RAW_WINDOW_CASE_NAMES)
    assert cs.check_subsample_cases(torch, cuda) == len(cs.SUBSAMPLE_CASE_NAMES)


@pytest.mark.gpu
def test_voxel_map_and_dedup_read_nothing_on_the_card(cuda, scans):
    """K3, K1b, K2, K2r and K21 are each one C call: no synchronizing call
    and no device work but their own kernels (no torch.sort, no torch
    glue)."""
    cs = load_chip_smoke()
    (s0, s1), rel = scans
    c0, c1 = (PointCloud.from_numpy(s, cap=16384, device=cuda) for s in (s0, s1))
    t = torch.from_numpy(rel.astype(np.float32)).to(cuda)
    group = (torch.stack([c0.xyz.T, c1.xyz.T]).contiguous(), torch.stack([c0.intensity, c1.intensity]),
             torch.stack([c0.mask, c1.mask]), 0, torch.stack([torch.eye(4, device=cuda), t]),
             torch.ones(2, dtype=torch.bool, device=cuda), 0.1, 32768)
    raw = (torch.stack([c0.xyz, c1.xyz]), *group[1:4], *group[4:6], 0.5, 100.0, 0.1, 32768)
    for name, fn in (("build_voxel_map", lambda: voxel_map.build_voxel_map(c0, 1.0, leaf_cap=8192, weighted=True)),
                     ("voxel_dedup_first", lambda: prefilter.voxel_dedup_first(c0, 0.1, 8192)),
                     ("window_group_filtered_fn", lambda: window.window_group_filtered(*group)),
                     ("window_group_fn", lambda: window.window_group(*raw)),
                     ("uniform_subsample", lambda: prefilter.uniform_subsample(c0, 4096))):
        fn()
        torch.cuda.synchronize()
        _, syncs = _count_syncs(fn)
        glue, _ = cs.foreign_functions(torch, fn, cs.DEVICE_FUNCTIONS[name])
        assert syncs == 0 and not glue, (name, syncs, glue)


@pytest.mark.gpu
def test_centroid_grid_cases_on_the_card(cuda):
    """K14's build on chip_smoke's grid_cases, one launch and no
    synchronizing call a call, keys, counts and origin identical to its twin
    on the card and run on a CPU copy (centroids to 1e-6); on its grid the
    column probe of K14's query, K17 and K18 bit for bit against their twins
    (an empty and an all-masked cloud, leaf_cap below the runs, points an
    ulp either side of cell faces, cells at the 1024 extent's edges, one
    cell holding every point, sentinel lanes among real points)."""
    cs = load_chip_smoke()
    assert cs.check_grid_cases(torch, cuda) == len(cs.GRID_CASE_NAMES)


@pytest.mark.gpu
def test_crop_both_tables_on_the_card(cuda):
    """K9b's two-table crop on chip_smoke's crop_cases, one launch and no
    synchronizing call a call, both tables and the crop center bit-identical
    to the twin's two single-table crops (gate open, closed, absent)."""
    cs = load_chip_smoke()
    assert cs.check_crop_cases(torch, cuda) == len(cs.crop_cases())


@pytest.mark.gpu
def test_centroid_grid_and_crop_read_nothing_on_the_card(cuda, scans):
    """K14's build and K9b's two-table crop are each one C call: no
    synchronizing call and no device work but their own kernels (no
    torch.sort, no torch glue)."""
    cs = load_chip_smoke()
    (s0, _), _ = scans
    cloud = PointCloud.from_numpy(s0, cap=16384, device=cuda)
    edge, surf = cs.crop_tables(torch, cuda)
    center = torch.tensor([3.0, -2.0, 0.5], device=cuda)
    last = center + 40.0
    for name, fn in (("build_centroid_grid", lambda: nn.build_centroid_grid(cloud, 0.25)),
                     ("crop_cell_table", lambda: knn.crop_cell_tables_(edge, surf, center, 25.0, last, 10.0))):
        fn()
        torch.cuda.synchronize()
        _, syncs = _count_syncs(fn)
        glue, _ = cs.foreign_functions(torch, fn, cs.DEVICE_FUNCTIONS[name])
        assert syncs == 0 and not glue, (name, syncs, glue)


@pytest.mark.gpu
def test_knn_cases_on_the_card(cuda):
    """K9k's three entries on chip_smoke's knn_cases, one launch and no
    synchronizing call a call, bit for bit against their twins on the card
    and run on a CPU copy (points mirrored about a query, duplicated points,
    a cell holding more than 8 points, the extent's first and last cells,
    masked tail rows, an empty grid, a sampled search past 8192 keys, the
    gates at d0^2 = 25 and norm = 1e-3; knn at k = 1 and 8)."""
    cs = load_chip_smoke()
    assert cs.check_knn_cases(torch, cuda) == len(cs.KNN_CASE_NAMES)


@pytest.mark.gpu
def test_floor_cases_on_the_card(cuda):
    """K16 on chip_smoke's floor_cases, one launch and no synchronizing call
    a call: found, best and the inlier count identical to the CPU twin, the
    coefficients within 1e-5 of it and bit for bit the parent kernel's
    (two identical best hypotheses, no valid one, an empty band, 1 and 1024
    hypotheses, 5000 lanes with masked lanes among them, 140000 lanes: the
    finish in two stages). An empty cloud raises, as on the CPU."""
    cs = load_chip_smoke()
    assert cs.check_floor_cases(torch, cuda) == len(cs.FLOOR_CASE_NAMES)
    empty = PointCloud(torch.zeros((0, 3), device=cuda), torch.zeros(0, device=cuda),
                       torch.zeros(0, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="empty cloud"):
        floor.detect_floor(empty)


@pytest.mark.gpu
def test_knn_and_floor_read_nothing_on_the_card(cuda, scans):
    """K9k's entries and K16 are each one C call: no synchronizing call and
    no device work but their own kernels."""
    cs = load_chip_smoke()
    (s0, s1), _ = scans
    cloud = PointCloud.from_numpy(s0, cap=16384, device=cuda)
    query = PointCloud.from_numpy(s1, cap=16384, device=cuda)
    grid = knn.build_grid(cloud.masked_xyz().contiguous(), cloud.mask, 2.0)
    y = query.masked_xyz().contiguous()
    for name, fn in (("knn", lambda: knn.knn(grid, y, 5)),
                     ("knn", lambda: registration.lines_from_2nn(y, query.mask, grid)),
                     ("knn", lambda: registration.planes_from_3nn(y, query.mask, grid)),
                     ("detect_floor", lambda: floor.detect_floor(cloud))):
        fn()
        torch.cuda.synchronize()
        _, syncs = _count_syncs(fn)
        glue, _ = cs.foreign_functions(torch, fn, cs.DEVICE_FUNCTIONS[name])
        assert syncs == 0 and not glue, (name, syncs, glue)


@pytest.mark.gpu
def test_cell_table_cases_on_the_card(cuda):
    """K9c's build on chip_smoke's table_cases, one launch and no
    synchronizing call a call, the table bit for bit its twin's on the card
    and run on a CPU copy (every row masked, 40 rows in one cell, 256
    buckets shared by many cells, 5001 rows, 2^15 and 2^18 buckets)."""
    cs = load_chip_smoke()
    assert cs.check_table_cases(torch, cuda) == len(cs.TABLE_CASE_NAMES)


@pytest.mark.gpu
def test_grid_and_table_builds_read_nothing_on_the_card(cuda, scans):
    """K9g (its one-launch cluster route up to 8192 lanes and its key sort's
    route past them) and K9c are each one C call: no synchronizing call and
    no device work but their own kernels (no torch.sort)."""
    cs = load_chip_smoke()
    (s0, _), _ = scans
    small = PointCloud.from_numpy(s0, cap=8192, device=cuda)
    large = PointCloud.from_numpy(s0, cap=32768, device=cuda)
    xs, xl = small.masked_xyz().contiguous(), large.masked_xyz().contiguous()
    for name, fn in (("build_grid", lambda: knn.build_grid(xs, small.mask, 2.0)),
                     ("build_grid", lambda: knn.build_grid(xl, large.mask, 2.0)),
                     ("build_cell_table", lambda: knn.build_cell_table(large.xyz, large.mask, 2.0, 1 << 14, 6))):
        fn()
        torch.cuda.synchronize()
        _, syncs = _count_syncs(fn)
        glue, _ = cs.foreign_functions(torch, fn, cs.DEVICE_FUNCTIONS[name])
        assert syncs == 0 and not glue, (name, syncs, glue)


@pytest.mark.gpu
def test_to_hash_edge_cases_on_the_card(cuda):
    """K5 on chip_smoke's hash_cases, one launch and no synchronizing call a
    call, its table and n_dropped bit-identical to its twin on the card and
    run on a CPU copy (no valid leaf, every leaf in one bucket, invalid
    leaves interleaved, leaf_cap 3000, 1 and 8 buckets a leaf, the 4 m
    rung's map, extent 1288)."""
    cs = load_chip_smoke()
    assert cs.check_hash_cases(torch, cuda) == len(cs.HASH_CASE_NAMES)


@pytest.mark.gpu
def test_detect_pyramid_batch_edge_cases_on_the_card(cuda):
    """K12 on chip_smoke's orb_cases, one launch and no synchronizing call a
    call, its packed rows bit-identical to its twin on the card and run on a
    CPU copy (ties at the cut, a blank image, noise, a plateau of equal keys
    past the select's shared memory, batches of 1 and 32, a 33 x 35 image
    whose k nears h x w)."""
    cs = load_chip_smoke()
    assert cs.check_orb_cases(torch, cuda) == len(cs.ORB_CASE_NAMES)


@pytest.mark.gpu
def test_to_hash_and_orb_read_nothing_on_the_card(cuda, scans):
    """K5 and K12 are each one C call: no synchronizing call and no device
    work but their own kernels (no torch.topk, no torch glue)."""
    cs = load_chip_smoke()
    (s0, _), _ = scans
    cloud = PointCloud.from_numpy(s0, cap=16384, device=cuda)
    vm = voxel_map.build_voxel_map(cloud, 1.0, leaf_cap=8192, weighted=True)
    images = torch.from_numpy(cs.orb_cases()[2][1]).to(cuda)
    for name, fn in (("to_hash", lambda: ndt_hash.to_hash(vm)),
                     ("_detect_pyramid_batch", lambda: orb.detect_pyramid_batch(images, cs.ORB_K_LEVELS))):
        fn()
        torch.cuda.synchronize()
        _, syncs = _count_syncs(fn)
        glue, _ = cs.foreign_functions(torch, fn, cs.DEVICE_FUNCTIONS[name])
        assert syncs == 0 and not glue, (name, syncs, glue)


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
def test_cell_knn_and_grid_fits_match_plain_versions_on_the_card(cuda, scans):
    """K9n: distances, points (invalid slots too) and valid flags identical
    (the same fma chain, a correctly rounded root, (d2, index) ranks).
    K10g: accept decisions identical; fitted floats finite on every lane
    and, over accepted queries whose eigen-gap is above the split, within
    `ops.gicp.PLANE_ENVELOPE` once multiplied by the gap
    (`registration.grid_fit_error`)."""
    from lv_slam_tpu_torch.ops.gicp import PLANE_ENVELOPE

    reset_launches()
    results, lines_at, planes_at = _cell_knn_calls(cuda, scans)
    torch.cuda.synchronize()
    assert {name: k.launches for name, k in KERNELS.items() if k.launches} == {"knn_cell": 2, "grid_fits": 2}
    for (name, got, want), at in zip(results, (None, None, lines_at, planes_at)):
        if name == "knn_cell":
            for a, b in zip(got, want):
                assert torch.equal(a, b), name
            assert bool(got[2][:, 0].any()) and (got[2].shape[1] < 48 or not bool(got[2].all()))
            continue
        assert torch.equal(got.valid, want.valid) and int(want.valid.sum()) > 0
        assert all(bool(torch.isfinite(a).all()) for a in got[:2])
        diff, envelope, n, n_split = registration.grid_fit_error(got, want, *at)
        print(f"grid fits: max diff {diff:.3g}, times the gap {envelope:.3g} over {n} queries ({n_split} at the split)")
        assert envelope <= PLANE_ENVELOPE


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


# launches of `_registration_calls` on the card
REGISTRATION_LAUNCHES = {
    "nn_points": 3, "build_centroid_grid": 3, "radius_outlier_removal": 1, "statistical_outlier_removal": 2,
    "vertical_angle_calibration": 1, "_plane_covariances": 2, "gicp_align": 1, "filter_ground_leaves": 2,
}


@pytest.fixture(scope="module")
def registration_results(scans):
    """`_registration_calls` once on the card: ({kernel: [(got, want)]}, launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the hand kernels run only on the card")
    reset_launches()
    results = _registration_calls(torch.device("cuda"), scans)
    torch.cuda.synchronize()
    by_name = {}
    for name, got, want in results:
        by_name.setdefault(name, []).append((got, want))
    return by_name, {name: k.launches for name, k in KERNELS.items() if k.launches}


def _check_nn_points(pairs, scans):
    """K17: hits, argmins and distances identical (the same probe and fma
    chain); the ICP iteration to 1e-5 (the sums run in another order, the
    Kabsch SVD in float64 against the twin's float32), its count exactly."""
    (got, want), (step, step_ref) = pairs
    assert torch.equal(got[2], want[2]) and int(want[2].sum()) > 1000
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(step[0], step_ref[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(step[1], step_ref[1], rtol=1e-5, atol=0)
    assert int(step[2]) == int(step_ref[2]) > 1000


def _check_removal(pairs, scans):
    """K18: integer counts and a float64-summed threshold: masks identical."""
    n_band = int(prefilter.distance_filter(PointCloud.from_numpy(scans[0][0], cap=16384, device="cuda"), 0.5,
                                           100.0).mask.sum())
    for got, want in pairs:
        assert torch.equal(got.mask, want.mask) and torch.equal(got.xyz, want.xyz)
        assert 0 < int(want.mask.sum()) < n_band


def _check_calibration(pairs, scans):
    """K0a: the same fma chain and float32 sin / cos on both sides: every bit."""
    ((got, want),) = pairs
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.xyz.view(torch.int32), want.xyz.view(torch.int32))


def _check_plane_covariances(pairs, scans):
    """K19a: ok identical; the covariances as the CPU test holds them to
    JAX: where the neighbourhood's relative eigen-gap g exceeds sqrt(eps),
    to gicp.PLANE_ENVELOPE / g (the reference's own one-ulp envelope), elsewhere
    (the normal is rounding noise) to the plane shape (1e-3, 1, 1)."""
    c1 = PointCloud.from_numpy(scans[0][1], cap=16384, device="cuda")
    _, nbr_pts, nbr_valid = knn.knn_ref(knn.build_grid_ref(c1.masked_xyz(), c1.mask, 1.0), c1.masked_xyz(), 8)
    for got, want in pairs:
        if want[1] is not None:
            assert torch.equal(got[1], want[1])
        e = gicp.plane_covariance_error(got[0], want[0], nbr_pts, nbr_valid, want[1])
        assert e.ok, e


def _check_normal_equations(pairs, scans):
    """K19b: H and g to 1e-5 of their scale (block sums in another order)."""
    ((got, want),) = pairs
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def _check_ground_filter(pairs, scans):
    """K20: the LUT and the valid flags identical (one writer each), also
    with flipped normals."""
    for got, want in pairs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and int(want[0].sum()) > 0


REGISTRATION_CHECKS = {
    "nn_points": _check_nn_points, "radius_outlier_removal": _check_removal,
    "statistical_outlier_removal": _check_removal, "vertical_angle_calibration": _check_calibration,
    "_plane_covariances": _check_plane_covariances, "gicp_align": _check_normal_equations,
    "filter_ground_leaves": _check_ground_filter,
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(REGISTRATION_CHECKS))
def test_registration_kernels_match_plain_versions_on_the_card(registration_results, scans, name):
    """Each of K17-K20 and K0a against its plain version on the card (the
    calls made once per module)."""
    by_name, launches = registration_results
    assert launches == REGISTRATION_LAUNCHES
    REGISTRATION_CHECKS[name](by_name[name], scans)


@pytest.mark.gpu
def test_prefilter_front_cases_on_the_card(cuda):
    """K0a's three forms (the calibration, the band, both in one pass) bit
    for bit their twins on `front_cases` (the band's edges, the z axis,
    underflow, signed zeros, odd capacities) and on a slice one lane off the
    16-byte boundary."""
    cs = load_chip_smoke()
    assert cs.check_front_cases(torch, cuda) == len(cs.front_cases())


@pytest.mark.gpu
def test_cos_reduced_is_cosf_on_the_card(cuda, tmp_path):
    """Kernel 4's `lvs::cos_reduced` (csrc/linalg3.cuh: `cosf` without its
    large-argument path) is `cosf` bit for bit on every float of |x| <=
    105615 under the port's nvcc flags (`scripts/cos_reduced_check.cu`)."""
    import ctypes
    import subprocess

    from lv_slam_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc_path

    lib = tmp_path / "libcos_reduced_check.so"
    subprocess.run([_nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(REPO / "lv_slam_tpu_torch" / "csrc"), "-o",
                    str(lib), str(REPO / "scripts" / "cos_reduced_check.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).cos_reduced_mismatches
    fn.argtypes, fn.restype = [ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    first = torch.zeros(16, dtype=torch.int32, device=cuda)
    hi = int(np.float32(105615.0).view(np.uint32))
    assert fn(hi, bad.data_ptr(), first.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    n = int(bad.item())
    assert n == 0, f"{n} floats differ, first {first[:min(n, 16)].cpu().numpy().view(np.float32)}"


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 5])
def test_plane_covariances_lane_test_on_the_card(cuda, k):
    """K19a's lane-test call (`need`, K19b's test) bit for bit the every-lane
    call on every needed lane and the identity elsewhere; the mask call's
    ok flags and the lane-test call against their twins, as
    `_check_plane_covariances` holds them."""
    rng = np.random.default_rng(k)
    n = 5000
    centres = rng.uniform(-20.0, 20.0, (n, 1, 3))
    flat = rng.normal(size=(n, k, 3)) * [1.0, 1.0, 0.02]
    pts = torch.from_numpy((centres + flat).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random((n, k)) < 0.6).to(cuda)
    src_ok, nn_valid = (torch.from_numpy(rng.random(n) < 0.7).to(cuda) for _ in range(2))
    nn_dist = torch.from_numpy(rng.uniform(0.0, 3.0, n).astype(np.float32)).to(cuda)
    need = gicp.LaneTest(src_ok, nn_valid, nn_dist, 2.0)
    reset_launches()
    got, ok = gicp.regularized_covariances(pts, valid, need=need)
    every, _ = gicp.regularized_covariances(pts, valid)
    masked, masked_ok = gicp.regularized_covariances(pts, valid, src_ok)
    torch.cuda.synchronize()
    assert ok is None and KERNELS["_plane_covariances"].launches == 3
    lanes = need.lanes()
    assert 0 < int(lanes.sum()) < n
    assert torch.equal(got[lanes].view(torch.int32), every[lanes].view(torch.int32))
    assert bool((got[~lanes] == torch.eye(3, device=cuda)).all())
    want, _ = gicp.regularized_covariances_ref(pts, valid, need=need)
    e = gicp.plane_covariance_error(got, want, pts, valid, lanes)
    assert e.ok and e.n_gap > 0, e
    want_masked, want_ok = gicp.regularized_covariances_ref(pts, valid, src_ok)
    assert torch.equal(masked_ok, want_ok) and 0 < int(want_ok.sum()) < int(src_ok.sum())
    assert gicp.plane_covariance_error(masked, want_masked, pts, valid, want_ok).ok
    assert torch.equal(masked[want_ok].view(torch.int32), every[want_ok].view(torch.int32))


# ------------------------------------------------------------ the device-side loops (K7, the LM)


def _count_syncs(fn):
    """(fn's result, the synchronizing calls it made): torch warns at each."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _lut_align_inputs(device, scans):
    """Scan 0's weighted 1 m map (its LUT and packed rows) and scan 1."""
    (s0, s1), rel = scans
    c0 = PointCloud.from_numpy(s0, cap=16384, device=device)
    c1 = PointCloud.from_numpy(s1, cap=16384, device=device)
    vm = voxel_map.build_voxel_map(c0, 1.0, leaf_cap=8192, lut_extent=256, weighted=True)
    lut = voxel_map.build_lut(vm)
    return vm, lut, ndt_soa.to_soa(vm, lut), c1, torch.from_numpy(rel.astype(np.float32)).to(device)


def _guesses(rel, device):
    """Starts around the true step: 0.4 m and 0.05 rad off, 1.2 m off (the
    first scan's x = +1.5 m guess), on it."""
    out = []
    for xi in ([0.4, -0.2, 0.1, 0.0, 0.0, 0.05], [-1.2, 0.3, 0.0, 0.01, -0.01, 0.0], [0.0] * 6):
        out.append((se3.exp_se3(torch.tensor(xi, dtype=torch.float32, device=device)) @ rel).contiguous())
    return out


def _alpha64(state, p, ridge_h):
    """A lane's next step length from its state after the step, solved in
    float64 on the host, and the system's condition number. `ridge_h`: the
    Hessian the ridge is taken from (before the `dof` projection)."""
    f = state.f[0].double().cpu().numpy()
    g, h = f[ndt.F_GRAD:ndt.F_GRAD + 6], f[ndt.F_HESS:ndt.F_HESS + 36].reshape(6, 6)
    ridge = np.float32(1e-6) * np.float32(np.abs(np.diag(ridge_h)).sum()) / np.float32(6.0) + np.float32(1e-12)
    a = (h + ridge * np.eye(6)).astype(np.float32).astype(np.float64)
    norm = float(np.linalg.norm(np.linalg.solve(a, -g)))
    return min(max(norm, p.step_min), float(f[ndt.F_CAP])), np.linalg.cond(a)


@pytest.mark.gpu
def test_newton_step_matches_its_twin_on_the_card(cuda, scans):
    """K7: from identical states (every step of three aligns of scan 1 onto
    scan 0's LUT map, and of the ground NDT's `dof` form), one `newton_step`
    and one `newton_step_ref` given the same derivative sums: the iteration
    count, the accepted transform, score, gradient, Hessian and cap
    identical; `done` and `bad` identical except where alpha lies within
    the two solves' rounding of eps or eps / 2 (counted and printed); the
    step length alpha within 1e-5 (relative) of the step solved in float64,
    and the proposed candidate within 1e-6 plus the twin's float32 solve
    error (the condition number times 2^-23 times alpha) of the twin's. (A
    float64 candidate is no yardstick: the reference's float32 exp_se3 takes
    (1 - cos t) / t^2, which one ulp of cos moves by 6e-8 / t^2; kernel and
    twin share CUDA's cosf.) A NaN first score stops the lane before any
    step."""
    vm, lut, soa, c1, rel = _lut_align_inputs(cuda, scans)
    xs, xyz, mask = c1.masked_xyz().T.contiguous(), c1.masked_xyz().contiguous(), c1.mask.contiguous()
    gauss = make_gauss_params(1.0)
    d1 = voxel_map.neighborhood_offsets("DIRECT1", cuda)
    runs = [(ndt_soa.soa_pass(soa, xs, mask, gauss, d1, True), None,
             lambda t: ndt_soa.ndt_derivatives_soa(soa, xs, mask, t, gauss, d1, True))]
    runs.append((ndt.generic_pass(vm, lut, xyz, mask, gauss, d1, False), ndt_ground.GROUND_DOF,
                 lambda t: ndt.ndt_derivatives(vm, lut, xyz, mask, t, gauss, d1, False)))
    steps = flips = 0
    worst = 0.0
    for pass_, dof, derivs in runs:
        p = ndt.loop_params(np.float32(0.01), 0.1, 64, dof, cuda)
        for guess in _guesses(rel, cuda):
            state = ndt.NewtonState(guess[None])
            state.partials = torch.empty((pass_.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=cuda)
            while not state.all_done():
                twin = state.clone()
                pre_f, pre_s = state.f[0].clone(), state.s[0].clone()
                sums = derivs(twin.f[0, ndt.F_CAND:ndt.F_CAND + 16].reshape(4, 4).contiguous())
                pass_.launch(state)
                ndt.newton_step(state, pass_.n_blocks, p)
                ndt.newton_step_ref(twin, *sums, p)
                steps += 1
                assert int(state.s[0, ndt.S_IT]) == int(twin.s[0, ndt.S_IT])
                for lo, hi in ((ndt.F_T, ndt.F_T + 16), (ndt.F_SCORE, ndt.F_HESS + 36), (ndt.F_CAP, ndt.F_CAP + 1)):
                    assert torch.equal(state.f[0, lo:hi], twin.f[0, lo:hi]), (lo, hi)
                if not torch.equal(state.s[0], twin.s[0]):
                    alpha = float(state.f[0, ndt.F_ALPHA])
                    near = min(abs(alpha - p.eps) / p.eps, abs(alpha - p.step_min) / p.step_min)
                    assert near < 1e-5, (state.s[0], twin.s[0], alpha)
                    flips += 1
                    continue
                if int(state.s[0, ndt.S_DONE]) or int(state.s[0, ndt.S_BAD]):
                    continue
                accepted = not int(pre_s[ndt.S_STARTED]) or (
                    not int(pre_s[ndt.S_BAD]) and float(sums[0]) >= float(pre_f[ndt.F_SCORE]))
                ridge_h = (sums[2] if accepted else pre_f[ndt.F_HESS:ndt.F_HESS + 36]).reshape(6, 6)
                alpha64, cond = _alpha64(state, p, ridge_h.double().cpu().numpy())
                err = abs(float(state.f[0, ndt.F_ALPHA]) - alpha64) / alpha64
                worst = max(worst, err)
                assert err < 1e-5, err
                cand, twin_cand = state.f[0, ndt.F_CAND:ndt.F_CAND + 16], twin.f[0, ndt.F_CAND:ndt.F_CAND + 16]
                assert float((cand - twin_cand).abs().max()) <= 1e-6 + 2.0**-23 * cond * alpha64
    print(f"newton_step: {steps} steps from identical states, {flips} done / bad flags decided by rounding, "
          f"step lengths within {worst:.3g} of float64's")
    assert steps > 10
    # a NaN first score: done at once, no iteration counted, nothing proposed
    state = ndt.NewtonState(rel[None])
    state.partials = torch.full((3 * ndt.N_TERMS,), float("nan"), dtype=torch.float32, device=cuda)
    ndt.newton_step(state, 3, p)
    assert state.s[0].tolist() == [1, 0, 1, 0]
    assert torch.equal(state.f[0, ndt.F_CAND:ndt.F_CAND + 16], state.f[0, ndt.F_T:ndt.F_T + 16])


@pytest.mark.gpu
def test_newton_sums_matches_its_twin_on_the_card(cuda, scans):
    """The sharded align's per-lane sums, bit for bit against the twin's
    block-by-block float32 adds: seeded rows of three lanes (one finished),
    and K6L's partial rows of one align's pass, running and finished
    (zeros)."""
    reset_launches()
    ((_, (got,), (want,)),) = _loop_calls(cuda)
    assert torch.equal(got, want) and not bool(got[1].any())
    vm, lut, soa, c1, rel = _lut_align_inputs(cuda, scans)
    pass_ = ndt_soa.soa_pass(soa, c1.masked_xyz().T.contiguous(), c1.mask.contiguous(), make_gauss_params(1.0),
                             voxel_map.neighborhood_offsets("DIRECT1", cuda), True)
    state = ndt.NewtonState(rel[None])
    state.partials = torch.empty((pass_.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=cuda)
    pass_.launch(state)
    for done in (0, 1):
        state.s[0, ndt.S_DONE] = done
        got = ndt.newton_sums(state, pass_.n_blocks).clone()
        assert torch.equal(got, ndt.newton_sums_ref(state, pass_.n_blocks)), done
        assert bool(got.any()) != bool(done)
    assert KERNELS["newton_sums"].launches == 3


@pytest.mark.gpu
def test_newton_sums_edge_cases_on_the_card(cuda):
    """K7s bit for bit (NaN's bits too) against its twin, one launch a call:
    8 lanes at n_blocks 1, 5, 256, 512, 700 and 2049 (one row past the
    kernel's round of 2048 in shared memory), lanes 1 and 5 finished, a NaN
    row and an infinite one."""
    cs = load_chip_smoke()
    assert cs.check_sums_cases(torch, cuda) == len(cs.SUMS_BLOCKS)


@pytest.mark.gpu
def test_newton_cases_on_the_card(cuda):
    """K7 on chip_smoke's newton_cases, step by step to done against its twin
    from identical states by chip_smoke.newton_steps' rules, one launch and
    no synchronizing call a step: a zero pivot (done and bad after one
    iteration), row swaps, a NaN start, the ground NDT's dof mask and its
    complement, steps at step_min and at the cap, max_iterations reached,
    1 and 2049 rows a lane, 4 lanes with a NaN start among them."""
    cs = load_chip_smoke()
    assert cs.check_newton_cases(torch, cuda) == len(cs.NEWTON_CASE_NAMES)


@pytest.mark.gpu
def test_probe_cases_on_the_card(cuda):
    """The hash pass (`ndt_partials`) on chip_smoke's probe_cases, one launch
    and no synchronizing call a case: slot-1 keys and keys in neither slot
    (one bucket a leaf), cells past an extent of 16, masked, sentinel and
    gate-rejected lanes, 1000 lanes and three candidates with the second
    finished (its rows untouched); the others' rows summed in block order
    against the plain pass on the card at phase 2's tolerances."""
    cs = load_chip_smoke()
    assert cs.check_probe_cases(torch, cuda) == len(cs.PROBE_CASE_NAMES)


@pytest.mark.gpu
def test_lut_cases_on_the_card(cuda):
    """The LUT passes K6L and K6G (`lut_pass`) on chip_smoke's lut_cases:
    points within an ulp of a cell face, cells at and past the extent for
    each DIRECT7 offset, an all-masked cloud, 1001 lanes, valid lanes ending
    mid-row, masked, sentinel and gate-rejected lanes, a finished candidate,
    DIRECT26, 131073 lanes. Each standalone call one launch with no
    synchronizing call, against its plain twin on the card at phase 2's
    tolerances; each gated pass's rows, summed in row order, the standalone
    sums bit for bit, a finished candidate's rows untouched."""
    cs = load_chip_smoke()
    assert cs.check_lut_cases(torch, cuda) == len(cs.LUT_CASE_NAMES)


@pytest.mark.gpu
def test_batched_newton_step_keeps_finished_lanes(cuda, scans):
    """K13's loop on the card: four candidates that stop at different
    iterations, stepped by the kernels; each lane's state, once done, stays
    bit for bit while the others run on; the whole loop launches its bound
    of iterations without a read, and agrees with the twins' loop on the
    card."""
    (s0, s1), rel = scans
    c0 = PointCloud.from_numpy(s0, cap=16384, device=cuda)
    c1 = PointCloud.from_numpy(s1, cap=16384, device=cuda)
    hm = ndt_hash.to_hash(voxel_map.build_voxel_map(c0, 1.0, leaf_cap=8192, weighted=True))
    t = torch.from_numpy(rel.astype(np.float32)).to(cuda)
    guesses = torch.stack([*_guesses(t, cuda), (se3.exp_se3(torch.tensor([0.1, 0, 0, 0, 0, 0.0], device=cuda)) @ t)])
    batch = PointCloud(*(torch.stack([a] * 4) for a in c1))
    mask = batch.mask.contiguous()
    xs = torch.where(mask[..., None], batch.xyz, SENTINEL).transpose(1, 2).contiguous()
    pass_ = ndt_hash.hash_pass(hm, xs, mask, make_gauss_params(1.0), voxel_map.neighborhood_offsets("DIRECT1", cuda),
                               True)
    p = ndt.loop_params(0.01, 0.1, 16)
    state = ndt.NewtonState(guesses, batched=True)
    state.partials = torch.empty((4 * pass_.n_blocks * ndt.N_TERMS,), dtype=torch.float32, device=cuda)
    frozen = {}
    for _ in range(18):
        pass_.launch(state)
        ndt.newton_step(state, pass_.n_blocks, p)
        for c in range(4):
            if c not in frozen and int(state.s[c, ndt.S_DONE]):
                frozen[c] = (state.f[c].clone(), state.s[c].clone())
    assert sorted(frozen) == [0, 1, 2, 3]
    for c, (f, s) in frozen.items():
        assert torch.equal(state.f[c].view(torch.int32), f.view(torch.int32)) and torch.equal(state.s[c], s), c
    kw = dict(resolution=1.0, transformation_epsilon=0.01, max_iterations=16, neighborhood="DIRECT1", weighted=True)
    reset_launches()
    (got_t, got_s, got_it), syncs = _count_syncs(
        lambda: ndt_hash.ndt_align_hash_table_batched(hm, batch, guesses, **kw))
    assert syncs == 0 and KERNELS["newton_step"].launches == 18 == KERNELS["_fused_verify_fn"].launches
    assert torch.equal(got_it, state.s[:, ndt.S_IT]) and len(set(got_it.tolist())) >= 3
    saved = ndt_hash._newton_loop
    ndt_hash._newton_loop = ndt._newton_loop_plain
    try:
        want_t, want_s, want_it = ndt_hash.ndt_align_hash_table_batched(hm, batch, guesses, **kw)
    finally:
        ndt_hash._newton_loop = saved
    # the whole loops: a tenth of eps where the iterations agree (the twin's
    # float32 solve errs by cond(H) x 2^-23, ~1e-4 of a 0.1 m step), the
    # reference's one-ulp spread (1e-2) where they are one apart (the last
    # step, below eps, taken or not)
    diff = (got_it - want_it).abs()
    assert int(diff.max()) <= 1, (got_it, want_it)
    err = (got_t - want_t).abs().amax(dim=(1, 2))
    assert bool((err <= torch.where(diff == 0, 1e-3, 1e-2)).all()), err


@pytest.mark.gpu
def test_align_reads_once_per_group_on_the_card(cuda, scans):
    """A whole align makes at most ceil((iterations + 1) / NEWTON_GROUP)
    synchronizing calls (the group reads), for the LUT, hash and generic
    passes."""
    vm, lut, soa, c1, rel = _lut_align_inputs(cuda, scans)
    hm = ndt_hash.to_hash(vm)
    kw = dict(resolution=1.0, transformation_epsilon=0.01, max_iterations=64)
    for guess in _guesses(rel, cuda):
        for name, align in (
            ("lut", lambda: ndt_soa.ndt_align_soa_table(soa, c1, guess, weighted=True, **kw)),
            ("hash", lambda: ndt_hash.ndt_align_hash_table(hm, c1, guess, weighted=True, **kw)),
            ("generic", lambda: ndt.ndt_align(vm, lut, c1, guess, neighborhood="DIRECT1", **kw)),
        ):
            align()
            torch.cuda.synchronize()
            res, syncs = _count_syncs(align)
            it = int(res.iterations)
            print(f"{name}: {it} iterations, {syncs} synchronizing calls")
            assert 1 <= syncs <= math.ceil((it + 1) / ndt.NEWTON_GROUP), (name, it, syncs)


@pytest.mark.gpu
def test_dispatch_one_reads_nothing_on_the_card(cuda, scans):
    """The loop verification (three multiscale rungs of K13's batched loop,
    the centroid grid and the fitness) makes no synchronizing call."""
    from lv_slam_tpu_torch.config import LoopDetectorConfig
    from lv_slam_tpu_torch.graph.keyframe import KeyFrame
    from lv_slam_tpu_torch.graph.loop_detector import LoopDetector

    (s0, s1), rel = scans
    kfs = [KeyFrame(stamp=0.1 * i, seq=i, odom=pose, accum_distance=4.0 * i, node_id=i, estimate=pose,
                    cloud=PointCloud.from_numpy(s, cap=16384, device=cuda))
           for i, (s, pose) in enumerate(((s0, np.eye(4)), (s1, rel)))]
    det = LoopDetector(LoopDetectorConfig(distance_thresh=10.0, accum_distance_thresh=3.0, min_edge_interval=1.0))
    det.dispatch_one([kfs[0]], [1.0], kfs[1])
    torch.cuda.synchronize()
    pending, syncs = _count_syncs(lambda: det.dispatch_one([kfs[0]], [1.0], kfs[1]))
    assert syncs == 0
    packed = pending.packed.cpu()
    assert bool(torch.isfinite(packed).all())
    rel_est = packed[0, :16].reshape(4, 4).double().numpy()
    assert np.abs(rel_est[:3, 3] - np.linalg.inv(rel)[:3, 3]).max() < 0.05


def _lm_graph():
    """A noisy 24-node chain with two loops, a fixed floor plane and an
    SE3-plane edge per node (every K15 family but the priors' kinds)."""
    rng = np.random.default_rng(7)
    g = pose_graph.empty_graph(32, 64, 32, 8, 32, 8)
    poses = [np.eye(4)]
    for _ in range(23):
        step = se3.exp_se3(torch.tensor(np.r_[1.0, 0.0, 0.0, 0.0, 0.0, 0.1] + rng.normal(0, 0.01, 6),
                                        dtype=torch.float32)).double().numpy()
        poses.append(poses[-1] @ step)
    noisy = lambda: se3.exp_se3(torch.tensor(rng.normal(0, 0.02, 6), dtype=torch.float32)).double().numpy()  # noqa
    for i, pose in enumerate(poses):
        pose_graph.add_node(g, i, pose @ noisy())
    e = 0
    for i in range(1, 24):
        pose_graph.add_se3_edge(g, e, i, i - 1, np.linalg.inv(poses[i]) @ poses[i - 1], np.eye(6) * 10, huber=1.0)
        e += 1
    for i, j in ((20, 2), (23, 5)):
        pose_graph.add_se3_edge(g, e, i, j, np.linalg.inv(poses[i]) @ poses[j], np.eye(6) * 10, huber=1.0)
        e += 1
    pose_graph.add_plane_node(g, 0, [0.0, 0.0, 1.0, 0.0], fixed=True)
    for i in range(24):
        pose_graph.add_se3_plane_edge(g, i, i, 0, [0.0, 0.0, 1.0, 1.7 + poses[i][2, 3]], np.eye(3) * 10)
    pose_graph.add_prior(g, 0, 3, pose_graph.PRIOR_XYZ, poses[3][:3, 3], np.eye(3))
    return g


@pytest.mark.gpu
def test_lm_kernels_match_their_twin_on_the_card(cuda):
    """The LM on the card (csrc/lm.cu around K15 and the Cholesky) against
    its twin on the card: one iteration from identical states to 1e-5 (the
    twin damps and updates with other roundings); a whole optimize as
    tests/test_torch_pose_graph.py holds LMs whose iteration counts may
    differ: poses to 1e-3, planes to 1e-4, chi2 to 1e-3 relative. A second
    build of K15 and a second optimize give the same bits (K15's sums have a
    fixed order). The launches after done are counted, and the reads are one
    per group."""
    g = pose_graph.to_device(_lm_graph(), cuda)
    # K15's sums have a fixed order: a second build gives the same bits
    first, second = (pose_graph._chi2_and_normal(g, g.poses, True, g.planes) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    chi2_0, _, _ = pose_graph._chi2_and_normal(g, g.poses, False, g.planes)
    a = pose_graph.LMState(g, chi2_0)
    b = a.clone()
    pose_graph._lm_iteration(g, a, 64)
    pose_graph._lm_iteration_ref(g, b, 64)
    torch.testing.assert_close(a.poses, b.poses, rtol=0, atol=1e-5)
    torch.testing.assert_close(a.planes, b.planes, rtol=0, atol=1e-5)
    assert torch.equal(a.lmi, b.lmi)
    torch.testing.assert_close(a.lmf[:2], b.lmf[:2], rtol=1e-5, atol=0)

    reset_launches()
    graph = _lm_graph()
    got, syncs = _count_syncs(lambda: pose_graph.optimize_pose_graph(graph, 64, device=cuda))
    it = int(got.iterations)
    launched = KERNELS["optimize_pose_graph"].launches
    assert launched == min(64, math.ceil(it / pose_graph.LM_GROUP) * pose_graph.LM_GROUP)
    saved = pose_graph._lm_iteration
    pose_graph._lm_iteration = pose_graph._lm_iteration_ref
    try:
        want = pose_graph.optimize_pose_graph(graph, 64, device=cuda)
    finally:
        pose_graph._lm_iteration = saved
    again = pose_graph.optimize_pose_graph(graph, 64, device=cuda)
    assert all(torch.equal(getattr(again, f), getattr(got, f)) for f in got._fields)
    print(f"LM: {it} iterations on the card ({launched} launched), {int(want.iterations)} with the twin; "
          f"{syncs} synchronizing calls (the graph's host-to-device copies included)")
    torch.testing.assert_close(got.poses, want.poses, rtol=0, atol=1e-3)
    torch.testing.assert_close(got.planes, want.planes, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.chi2_after, want.chi2_after, rtol=1e-3, atol=0)
    assert float(got.chi2_after) < 0.5 * float(got.chi2_before)
    copies = len(pose_graph.PoseGraph._fields)  # the graph's arrays, each a pageable copy to the card
    assert syncs - copies <= math.ceil(it / pose_graph.LM_GROUP)


@pytest.mark.gpu
def test_pose_graph_modes_on_the_card(cuda):
    """K15 in each of its modes, one launch each (chip_smoke's
    `k15_mode_checks`: the chi2 mode's sum equal to the raw build's, the
    damped system equal to the raw build through `lm_damp`, bit for bit), on
    this file's LM graph and every `lm_cases` graph; where the graph's terms
    are finite, the raw H and b and the damped system against the twin's on
    the card to 1e-4 of their scale (the sums run in other orders: float32
    rounding alone moves b by ~3e-5 of its scale), chi2 to 1e-4 relative or
    1e-6 (the chain that its measurements fit has chi2 ~1e-13)."""
    cs = load_chip_smoke()
    graphs = [("chain", _lm_graph())] + [(name, graph) for name, graph, _ in cs.lm_cases(torch)]
    for name, graph in graphs:
        g = pose_graph.to_device(graph, cuda)
        chi2, h, b = cs.k15_mode_checks(torch, g)
        if not bool(torch.isfinite(chi2)):
            continue
        c_ref, h_ref, b_ref = pose_graph._chi2_and_normal_ref(g, g.poses, True)
        damped, rhs = pose_graph._damped_system(g, g.poses, g.planes, 1e-4)
        d_ref, r_ref = pose_graph._damped_system_ref(g, g.poses, g.planes, 1e-4)
        for got, want in ((h, h_ref), (b, b_ref), (damped, d_ref), (rhs, r_ref)):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(1.0, float(want.abs().max())), msg=name)
        torch.testing.assert_close(chi2, c_ref, rtol=1e-4, atol=1e-6, msg=name)  # a fitted graph's is rounding


@pytest.mark.gpu
def test_lm_iteration_launches_on_the_card(cuda):
    """An unsharded LM iteration launches two hand kernels around the library
    solve (K15's damped system, then `lm_step`), where the earlier kernels
    launched 13; `_chi2_and_normal` is one launch in each mode."""
    cs = load_chip_smoke()
    g = pose_graph.to_device(_lm_graph(), cuda)
    chi2_0, _, _ = pose_graph._chi2_and_normal(g, g.poses, False, g.planes)
    st = pose_graph.LMState(g, chi2_0)
    assert cs.hand_launches(torch, lambda: pose_graph._lm_iteration(g, st, 64)) == ["normal_cluster", "lm_step"]
    for fn in (lambda: pose_graph._chi2_and_normal(g, g.poses, True),
               lambda: pose_graph._chi2_and_normal(g, g.poses, False),
               lambda: pose_graph._damped_system(g, g.poses, g.planes, 1e-4)):
        assert cs.hand_launches(torch, fn) == ["normal_cluster"]


@pytest.mark.gpu
def test_lm_cases_on_the_card(cuda):
    """chip_smoke's `lm_cases` (a failed Cholesky, a NaN delta, done in the
    middle of a group, node 0 with fixed nodes and a fixed plane, empty and
    invalid families, more variables than the cluster's warps,
    num_iterations 1) against the twin on the card, as phase 2i runs them."""
    cs = load_chip_smoke()
    records = cs.check_lm_cases(torch, cuda)
    assert tuple(records) == cs.LM_CASE_NAMES
    print({name: (r["iterations"], r["twin_iterations"]) for name, r in records.items()})


@pytest.mark.gpu
def test_mesh_of_one_rank_equals_the_unsharded_port_on_the_card(cuda, scans, tmp_path):
    """An NCCL world of one rank, mesh (1, 1): the sharded align of three
    guesses (the coarse phase on, K6L and K7 with the all-reduce between)
    equals `ndt_align_soa` of each bit for bit; the sharded LM equals
    `optimize_pose_graph` bit for bit (the all-reduce of one rank leaves H
    and b as they are, and K15 sums in a fixed order)."""
    import torch.distributed as dist

    from lv_slam_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        m = pmesh.make_mesh(1, 1)
        vm, lut, _, c1, rel = _lut_align_inputs(cuda, scans)
        guesses = torch.stack(_guesses(rel, cuda))
        b = guesses.shape[0]
        kw = dict(resolution=1.0, max_iterations=35, transformation_epsilon=0.01, neighborhood="DIRECT1",
                  weighted=True, coarse_subsample=2)
        t, s, it = pmesh.ndt_align_sharded(m, pmesh.stack_maps([vm] * b), torch.stack([lut] * b),
                                           torch.stack([c1.masked_xyz()] * b), torch.stack([c1.mask] * b), guesses,
                                           **kw)
        for j in range(b):
            want = ndt_soa.ndt_align_soa(vm, lut, c1, guesses[j], **kw)
            assert torch.equal(t[j], want.transform), j
            assert torch.equal(s[j], want.score) and int(it[j]) == int(want.iterations), j
        graph = _lm_graph()
        got = pmesh.optimize_pose_graph_sharded(m, graph, 64)
        want = pose_graph.optimize_pose_graph(graph, 64, device=cuda)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_gicp_normal_equations_cases_on_the_card(cuda):
    """K19b on chip_smoke's `gicp_cases` (one lane, a partial tile, no lane
    matched, 257 and 1172 tiles): one launch a call, the same bits twice,
    within 1e-5 of the twins' scale."""
    cs = load_chip_smoke()
    assert cs.check_gicp_cases(torch, cuda) == len(cs.GICP_CASE_NAMES)


@pytest.mark.gpu
def test_grid_fits_thread_route_on_the_card(cuda, scans):
    """K10g past 16384 queries (a thread a query; the fits' own batch takes
    a warp a query, `test_cell_knn_and_grid_fits_match_plain_versions_on_the_card`):
    copies of scan 1's sharp / flat features moved by a few cm, accept
    decisions identical to the twins', fitted floats finite and within
    `ops.gicp.PLANE_ENVELOPE` once multiplied by the gap
    (`registration.grid_fit_error`)."""
    from lv_slam_tpu_torch.ops.gicp import PLANE_ENVELOPE

    _, (ye, edge), (ys, surf) = _cell_knn_calls(cuda, scans)
    (_, s1), _ = scans
    f1 = features.extract_features_ref(PointCloud.from_numpy(s1, cap=16384, device=cuda), LFA)
    thread_queries = load_chip_smoke().KNN_THREAD_QUERIES
    gen = torch.Generator(device=cuda).manual_seed(26)
    for fn, ref, y, m, grid in ((registration.lines_from_fit, registration.lines_from_fit_ref, ye, f1.sharp_mask, edge),
                                (registration.planes_from_fit, registration.planes_from_fit_ref, ys, f1.flat_mask,
                                 surf)):
        copies = -(-(thread_queries + 1) // y.shape[0])
        y = (y.repeat(copies, 1) + 0.03 * torch.randn((copies * y.shape[0], 3), generator=gen, device=cuda))
        y, m = y.contiguous(), m.repeat(copies).contiguous()
        got, want = fn(y, m, grid), ref(y, m, grid)
        assert torch.equal(got.valid, want.valid) and int(want.valid.sum()) > 0
        assert all(bool(torch.isfinite(a).all()) for a in got[:2])
        assert registration.grid_fit_error(got, want, y, grid, 5)[1] <= PLANE_ENVELOPE
