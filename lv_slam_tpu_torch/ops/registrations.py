"""The registration-method factory (port of `lv_slam_tpu.ops.registrations`,
the reference's `src/global_graph/registrations.cpp`).

`select_registration_method(params)` returns a callable
`(target, source, guess) -> RegistrationResult` for the method names the
reference accepts: ICP, GICP, GICP_OMP, NDT, NDT_OMP, and NDT_PCA (the
weighted odometry matcher); any other name raises `ValueError`. The NDT
methods build the target's voxel map (kernel 2) and its LUT (K3L), align
with the generic `ndt_align` (K6G in the Newton loop: one host read per
iteration) and score with `fitness_score` (K14). ICP runs kernel 17's
iterations and GICP kernels 19a/19b, both fixed-trip loops with no host
read. The callables run on the device of their inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.ops.gicp import gicp_align
from lv_slam_tpu_torch.ops.icp import icp_align
from lv_slam_tpu_torch.ops.ndt import ndt_align
from lv_slam_tpu_torch.ops.nn import fitness_score
from lv_slam_tpu_torch.ops.voxel_map import build_lut, build_voxel_map


class RegistrationResult(NamedTuple):
    transform: torch.Tensor  # (4, 4)
    fitness: torch.Tensor    # ()


@dataclasses.dataclass(frozen=True)
class RegistrationParams:
    """The reference's factory parameters (`ndt_num_threads` has no
    meaning here: lanes replace threads)."""

    registration_method: str = "NDT_OMP"
    ndt_resolution: float = 1.0
    ndt_nn_search_method: str = "DIRECT7"
    transformation_epsilon: float = 0.01
    max_iterations: int = 64
    max_correspondence_distance: float = 2.0
    leaf_cap: int = 16384
    lut_extent: int = 256


def select_registration_method(params: RegistrationParams) -> Callable:
    method = params.registration_method.upper()

    if method in ("NDT", "NDT_OMP", "NDT_PCA"):
        weighted = method == "NDT_PCA"

        def run_ndt(target: PointCloud, source: PointCloud, guess: torch.Tensor) -> RegistrationResult:
            vm = build_voxel_map(
                target, params.ndt_resolution, leaf_cap=params.leaf_cap, lut_extent=params.lut_extent,
                weighted=weighted,
            )
            res = ndt_align(
                vm, build_lut(vm), source, guess, resolution=params.ndt_resolution,
                transformation_epsilon=params.transformation_epsilon, max_iterations=params.max_iterations,
                neighborhood=params.ndt_nn_search_method, weighted=weighted,
            )
            return RegistrationResult(res.transform, fitness_score(target, source, res.transform))

        return run_ndt

    if method == "ICP":

        def run_icp(target: PointCloud, source: PointCloud, guess: torch.Tensor) -> RegistrationResult:
            res = icp_align(
                target, source, guess, max_correspondence_distance=params.max_correspondence_distance,
                max_iterations=params.max_iterations,
            )
            return RegistrationResult(res.transform, res.fitness)

        return run_icp

    if method in ("GICP", "GICP_OMP"):

        def run_gicp(target: PointCloud, source: PointCloud, guess: torch.Tensor) -> RegistrationResult:
            res = gicp_align(
                target, source, guess, max_correspondence_distance=params.max_correspondence_distance,
                max_iterations=min(params.max_iterations, 20),
            )
            return RegistrationResult(res.transform, res.fitness)

        return run_gicp

    raise ValueError(f"unknown registration method {params.registration_method!r}")
