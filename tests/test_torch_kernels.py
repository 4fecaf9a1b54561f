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

from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud  # noqa: E402
from lv_slam_tpu_torch.kernels import KERNELS, reset_launches  # noqa: E402
from lv_slam_tpu_torch.ops import ndt_hash, prefilter, voxel_map  # noqa: E402
from lv_slam_tpu_torch.ops.ndt import make_gauss_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scans():
    s, poses, _ = synthetic.make_sequence(
        2, seed=41, trajectory="figure8", step=1.0, n_rings=32, n_azimuth=450
    )
    return s, np.linalg.inv(poses[0]) @ poses[1]


def _calls(device, scans):
    """Every wrapper once, on `device`, at small shapes: (name, wrapper output,
    plain output) for each kernel."""
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


def test_registry_names_sources_and_replaced_functions():
    assert set(KERNELS) == {"voxel_downsample", "build_voxel_map", "to_hash", "ndt_derivatives_hash"}
    for name, k in KERNELS.items():
        assert (REPO / k.source).is_file(), k.source
        path, line = k.replaces.split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert re.match(rf"def {name}\(", text), (k.replaces, text)


def test_cpu_tensors_use_the_plain_versions(scans):
    reset_launches()
    for name, got, want in _calls("cpu", scans):
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
    results = {name: (got, want) for name, got, want in _calls(cuda, scans)}
    torch.cuda.synchronize()
    assert all(k.launches == 1 for k in KERNELS.values())

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
